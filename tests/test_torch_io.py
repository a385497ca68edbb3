"""PyTorch port vs the JAX package: the I/O modules and the native runtime.

The port keeps its own copies of ``io/{logger,rosbag,vo_frontend}.py`` and
``native.py`` (which import no JAX) and ports ``io/replay.py`` (the robot
models' kinematics on float64 CPU tensors) and ``synth.rawlog_from_synth``.
Each is held against the JAX package's module on the same numpy inputs: the
logger's and the rosbag writer's files byte for byte, the rosbag reader on
the JAX tests' hand-written CDR byte fixtures, the alignment pass at 1e-12,
the VO frontend exactly, and the native helpers against numpy.
"""

import os
import subprocess

import numpy as np
import pytest

import test_rosbag as jrosbag_tests
from decentralized_ekf_mhe_tpu import native as jnative
from decentralized_ekf_mhe_tpu.io import logger as jlogger
from decentralized_ekf_mhe_tpu.io import replay as jreplay
from decentralized_ekf_mhe_tpu.io import rosbag as jrosbag
from decentralized_ekf_mhe_tpu.io import synth as jsynth
from decentralized_ekf_mhe_tpu.io import vo_frontend as jvo
from decentralized_ekf_mhe_tpu.models import Go1Model as JGo1Model
from decentralized_ekf_mhe_tpu.models.base import CartesianFeetModel as JCartesian
from decentralized_ekf_mhe_tpu_torch import native
from decentralized_ekf_mhe_tpu_torch.io import logger, replay, rosbag, synth, vo_frontend
from decentralized_ekf_mhe_tpu_torch.models import Go1Model
from decentralized_ekf_mhe_tpu_torch.models.base import CartesianFeetModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = synth.SynthConfig(T=120, seed=3)


@pytest.fixture(scope="module")
def raw():
    log = synth.generate(CFG)
    r = synth.rawlog_from_synth(log, CFG)
    jr = jsynth.rawlog_from_synth(jsynth.generate(jsynth.SynthConfig(T=120, seed=3)), CFG)
    for f in replay.RawLog.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(r, f), getattr(jr, f), err_msg=f)
    return r


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def test_logger_files_byte_identical(tmp_path):
    """Every channel type, per tick and as a sequence: the same files as the
    JAX logger's, and read_log gives the same arrays."""
    rng = np.random.default_rng(0)
    ticks = [{"pose": rng.standard_normal(3), "tick": np.array([k]),
              "quat": rng.standard_normal(4), "flags": np.array([k, k + 1]),
              "f": rng.standard_normal(2), "d": rng.standard_normal(1)} for k in range(5)]
    seq = {"x": np.arange(10.0).reshape(5, 2), "n": np.arange(5)}
    for mod, sub in ((logger, "port"), (jlogger, "jax")):
        lg = mod.DataLogger("unit", str(tmp_path / sub))
        for name, ctype, ln in (("pose", "VectorXd", 3), ("tick", "int", 1),
                                ("quat", "Quaterniond", 4), ("flags", "VectorXi", 2),
                                ("f", "VectorXf", 2), ("d", "double", 1)):
            lg.add_channel(name, ctype, ln)
        for t in ticks:
            lg.log_tick(t)
        lg.close()
        lg = mod.DataLogger("seq", str(tmp_path / sub))
        lg.add_channel("x", "VectorXd", 2)
        lg.add_channel("n", "int")
        lg.log_sequence(seq)
        lg.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for name in ("unit", "seq"):
        a = logger.read_log(str(tmp_path / "port" / name))
        b = jlogger.read_log(str(tmp_path / "jax" / name))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("model", ["cartesian", "go1"])
def test_align_matches_jax(raw, model):
    """The alignment pass on rawlog_from_synth (VO arrivals, discards, EKF
    rewinds, latest-value sampling) equals the JAX pass at 1e-12; with Go1's
    kinematics on the joint channels too."""
    if model == "cartesian":
        m, jm = CartesianFeetModel(num_legs=4), JCartesian(num_legs=4)
    else:
        m, jm = Go1Model(), JGo1Model()
    kw = dict(est_rate=CFG.rate, ekf_rate=CFG.ekf_rate, t_end=CFG.T / CFG.rate)
    a, b = replay.align(raw, m, **kw), jreplay.align(raw, jm, **kw)
    assert a.accel_b.shape[0] == CFG.T
    for f in replay.AlignedLog.__dataclass_fields__:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.shape == y.shape and x.dtype.kind == y.dtype.kind, f
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-12, err_msg=f)


def test_align_discards_and_latest_index(raw):
    """VO pairs predating the history are discarded with the JAX warning;
    latest_index (native and numpy) and upper_bound_sync equal the JAX ones."""
    import dataclasses

    r = dataclasses.replace(raw, vo_t_pre=np.array([-1.0, 0.05]),
                            vo_t_now=np.array([0.03, 0.085]),
                            vo_dp_body=np.array([[0.1, 0, 0], [0.2, 0, 0]]),
                            vo_q_wb=np.zeros((0, 4)), vo_t_recv=np.zeros(0))
    with pytest.warns(UserWarning, match="discarded 1 VO pairs"):
        a = replay.align(r, CartesianFeetModel(num_legs=4))
    with pytest.warns(UserWarning, match="discarded 1 VO pairs"):
        b = jreplay.align(r, JCartesian(num_legs=4))
    np.testing.assert_array_equal(a.vo_tick_pre, b.vo_tick_pre)
    assert a.vo_active.sum() == 1
    rng = np.random.default_rng(4)
    stream, samples = np.sort(rng.uniform(0, 10, 200)), rng.uniform(-1, 11, 100)
    np.testing.assert_array_equal(replay.latest_index(stream, samples),
                                  jreplay.latest_index(stream, samples))
    for stamp in (0.007, 0.005, -0.1, 0.1):
        ticks = np.array([0.0, 0.005, 0.010, 0.015])
        assert replay.upper_bound_sync(ticks, stamp) == jreplay.upper_bound_sync(ticks, stamp)


def test_rawlog_npz_roundtrip(tmp_path, raw):
    p = str(tmp_path / "raw.npz")
    replay.save_rawlog(p, raw)
    a, b = replay.load_rawlog(p), jreplay.load_rawlog(p)
    for f in raw.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(a, f), getattr(raw, f), err_msg=f)
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("split", [None, 97])
def test_rosbag_write_byte_identical_and_read(tmp_path, raw, split):
    """write_rosbag writes the JAX writer's bytes (one file, or split with a
    metadata.yaml); both readers read the same RawLog back."""
    q = rosbag.quantize_rawlog(raw)
    jq = jrosbag.quantize_rawlog(raw)
    for f in raw.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(q, f), getattr(jq, f), err_msg=f)
    rosbag.write_rosbag(str(tmp_path / "port"), q, max_messages_per_file=split)
    jrosbag.write_rosbag(str(tmp_path / "jax"), q, max_messages_per_file=split)
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax") and len(files) >= 1
    a = rosbag.rawlog_from_rosbag(str(tmp_path / "port"))
    b = jrosbag.rawlog_from_rosbag(str(tmp_path / "jax"))
    for f in raw.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(a.imu_t, q.imu_t)
    np.testing.assert_array_equal(a.vo_t_now, q.vo_t_now)


@pytest.mark.parametrize("case", ["imu", "joint_state", "vo_relative_transform",
                                  "pose_stamped", "mocap"])
def test_rosbag_golden_bytes(monkeypatch, case):
    """The JAX tests' hand-written CDR fixtures (``tests/test_rosbag.py``),
    run against the port's reader: each asserts its decoded values."""
    monkeypatch.setattr(jrosbag_tests, "rosbag_io", rosbag)
    getattr(jrosbag_tests, f"test_golden_{case}_bytes")()


def _cams(rng, n):
    from tests.ref_impl.ekf_ref import rot as quat_rot

    def rand_R():
        q = rng.standard_normal(4)
        return quat_rot(q / np.linalg.norm(q))

    R_ic, p_ic = rand_R(), rng.standard_normal(3) * 0.1
    return R_ic, p_ic, [rand_R() for _ in range(n)], [rng.standard_normal(3) for _ in range(n)]


def test_vo_frontend_matches_jax():
    """Stereo, RGBD and monocular frontends, the time sync and the IMU
    batching give the JAX module's outputs exactly."""
    rng = np.random.default_rng(5)
    R_ic, p_ic, R_cams, p_cams = _cams(rng, 8)
    stamps = np.arange(8) * 0.033
    for cls, kw in (("StereoVOFrontend", {}), ("RGBDVOFrontend", {}),
                    ("MonocularVOFrontend", {"scale": 2.0})):
        a = getattr(vo_frontend, cls)(R_ic, p_ic, **kw).process_trajectory(R_cams, p_cams, stamps)
        b = getattr(jvo, cls)(R_ic, p_ic, **kw).process_trajectory(R_cams, p_cams, stamps)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(vo_frontend.quat_from_rot(R_ic), jvo.quat_from_rot(R_ic))
    t_a, t_b = np.array([0.0, 0.1, 0.2, 0.3, 0.4]), np.array([0.004, 0.102, 0.25, 0.399])
    for x, y in zip(vo_frontend.approximate_time_sync(t_a, t_b, max_dt=0.01),
                    jvo.approximate_time_sync(t_a, t_b, max_dt=0.01)):
        np.testing.assert_array_equal(x, y)
    t_imu, t_left = np.arange(0.0, 1.0, 0.002), np.array([0.10, 0.20, 0.30, 1.50])
    for x, y in zip(vo_frontend.sync_stereo_inertial(t_imu, t_left, t_left + 0.003),
                    jvo.sync_stereo_inertial(t_imu, t_left, t_left + 0.003)):
        np.testing.assert_array_equal(x, y)


def test_native_helpers_match_numpy(tmp_path):
    """After native/build.sh the port's bindings load the library and agree
    with numpy and with the JAX package's bindings; the native logger writes
    the Python logger's bytes and read_log decodes them; the BlockFeeder
    serves the rows in blocks, the last one padded."""
    if not native.available():
        subprocess.check_call(["sh", os.path.join(REPO, "native", "build.sh")])
        native._TRIED = False
    assert native.available(), "native library must build on this image"
    rng = np.random.default_rng(0)
    stream, samples = np.sort(rng.uniform(0, 10, 500)), rng.uniform(-1, 11, 300)
    ref = np.clip(np.searchsorted(stream, samples, side="right") - 1, 0, 499)
    np.testing.assert_array_equal(native.latest_index(stream, samples), ref)
    ticks, stamps = np.sort(rng.uniform(0, 5, 100)), rng.uniform(-1, 6, 50)
    np.testing.assert_array_equal(native.upper_bound_sync(ticks, stamps),
                                  np.searchsorted(ticks, stamps, side="right") - 1)
    src, idx = rng.standard_normal((20, 7)), rng.integers(0, 20, 31)
    np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])
    jnative._TRIED = False
    if jnative.available():
        np.testing.assert_array_equal(native.latest_index(stream, samples),
                                      jnative.latest_index(stream, samples))

    seq = {"a": rng.standard_normal((6, 3)), "b": np.arange(6)}
    for mod, sub in ((native.NativeLogger, "native"), (logger.DataLogger, "python")):
        lg = mod("n", str(tmp_path / sub))
        lg.add_channel("a", "VectorXd", 3)
        lg.add_channel("b", "int")
        lg.log_sequence(seq)
        lg.close()
    assert _files(tmp_path / "native") == _files(tmp_path / "python")
    out = native.read_log(str(tmp_path / "native" / "n"))
    np.testing.assert_array_equal(out["a"], seq["a"])

    rows = np.arange(10 * 4, dtype=np.float64).reshape(10, 4)
    feeder = native.BlockFeeder(rows, 4)
    got = []
    for _ in range(3):
        blk, n = feeder.next()
        got.append(np.array(blk[:n]))
    assert [len(g) for g in got] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate(got), rows)
