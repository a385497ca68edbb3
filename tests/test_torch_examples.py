"""The port's example drivers, run in-process on the CPU at a small size.

``decentralized_ekf_mhe_tpu_torch.examples.{run_go1,run_robot,run_hil}``
through ``main(argv)`` with ``--cpu``: the Go1 driver with either estimator,
and on a recorded RawLog npz (``--raw``), each writing its Data_Logger
channels; the multi-robot driver at PogoX (with a velocity box) and Cassie;
the streaming HIL driver (``PipelineEstimator`` fed by the native
``BlockFeeder``). No driver reads a path outside the repository.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu_torch import native
from decentralized_ekf_mhe_tpu_torch.examples import run_go1, run_hil, run_robot
from decentralized_ekf_mhe_tpu_torch.io import logger as log_io
from decentralized_ekf_mhe_tpu_torch.io import replay, synth

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("est_type", ["0", "1"])
def test_run_go1(tmp_path, capsys, est_type):
    extra = ["--gt-orientation"] if est_type == "1" else []
    assert run_go1.main(["--ticks", "120", "--est-type", est_type, "--cpu",
                         "--log-dir", str(tmp_path), *extra]) == 0
    out = log_io.read_log(str(tmp_path / "exp"))
    assert out["x_MHE"].shape == (120, 9)
    assert np.isfinite(out["v_body"]).all() and np.isfinite(out["filter_euler_"]).all()
    rmse = float(capsys.readouterr().out.split("velocity RMSE vs GT: ")[1].split()[0])
    assert rmse < 0.1


def test_run_go1_raw_flag(tmp_path):
    """``--raw`` on a RawLog npz (the synthetic log rendered as raw streams)
    through the alignment pass with the cartesian model."""
    cfg = synth.SynthConfig(T=120, seed=3)
    path = str(tmp_path / "raw.npz")
    replay.save_rawlog(path, synth.rawlog_from_synth(synth.generate(cfg), cfg))
    assert run_go1.main(["--raw", path, "--raw-model", "cartesian", "--ticks", "100",
                         "--cpu", "--log-dir", str(tmp_path)]) == 0
    out = log_io.read_log(str(tmp_path / "exp"))
    assert out["x_MHE"].shape == (100, 9) and np.isfinite(out["x_MHE"]).all()


# the box case runs a few ticks only: the plain box-ADMM of the standard
# layout is a host loop of small operations, about 0.8 s a tick at 300
# iterations on one CPU thread
@pytest.mark.parametrize("robot,ticks,extra", [
    ("pogox", 80, []), ("cassie", 80, []), ("pogox", 6, ["--v-limit", "0.6"])])
def test_run_robot(capsys, robot, ticks, extra):
    assert run_robot.main(["--robot", robot, "--ticks", str(ticks), "--cpu", *extra]) == 0
    out = capsys.readouterr().out
    assert "velocity RMSE vs GT" in out
    if extra:
        vmax = float(out.split("max |v| estimate: ")[1].split()[0])
        assert vmax <= 0.6 + 1e-3


def test_run_hil(capsys):
    if not native.available():
        subprocess.check_call(["sh", os.path.join(REPO, "native", "build.sh")])
        native._TRIED = False
    assert run_hil.main(["--ticks", "60", "--block", "20", "--cpu"]) == 0
    err = capsys.readouterr().err
    assert "FULL EKF+MHE cycles" in err and "via native BlockFeeder" in err
    assert "sustained per-tick latency" in err and "tick-at-a-time comparison" in err


def test_hil_stream_matches_offline_and_feeders_agree():
    """run_hil's stream (native feeder, use_pallas=True on the CPU) equals the
    numpy feeder's stream bit for bit, and the offline pipeline replay at
    float64, on every tick it streamed."""
    from decentralized_ekf_mhe_tpu_torch.config import EKFParams
    from decentralized_ekf_mhe_tpu_torch.ops import estimator
    from decentralized_ekf_mhe_tpu_torch.tools.roofline import bench_params

    if not native.available():
        subprocess.check_call(["sh", os.path.join(REPO, "native", "build.sh")])
        native._TRIED = False
    p, T, F64 = bench_params(), 47, torch.float64
    p.N = 8
    log = synth.generate(synth.SynthConfig(T=T, seed=0))
    a = run_hil.stream(log, p, EKFParams(), 11, F64, "cpu", use_native=True)
    b = run_hil.stream(log, p, EKFParams(), 11, F64, "cpu", use_native=False)
    assert a["x"].shape[0] == 1 + 4 * 11 and len(a["latency_ms"]) == 3
    for k in ("x", "v", "q"):
        assert torch.equal(a[k], b[k])
    lanes = lambda t: t[:, None].movedim(1, -1)
    data = estimator.TickData(*map(lanes, estimator.tickdata_from_log(log, device="cpu")))
    eb = estimator.ekfblocks_from_log(log, device="cpu")
    x, v, q = estimator.run_pipeline_lanes(
        p, EKFParams(), data, eb._replace(gyro=eb.gyro[..., None], accel=eb.accel[..., None]),
        vo=estimator.vodata_from_log(log, device="cpu"), dtype=F64, device="cpu")
    n = a["x"].shape[0]
    np.testing.assert_allclose(a["x"].numpy(), x[:n, 0].numpy(), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(a["v"].numpy(), v[:n, 0].numpy(), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(a["q"].numpy(), q[:n, :, 0].numpy(), rtol=1e-10, atol=1e-12)
