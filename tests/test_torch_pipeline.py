"""PyTorch port vs the JAX package: the ported slice as a whole.

``make_pipeline_fleet_runner(use_megakernel=True, device="cpu")`` (EKF stage →
to_rot → MHE ticks → lever-arm velocity, each stage through its kernel
wrapper's CPU path) against the JAX staged runner with both Pallas kernels in
interpret mode, at float64. Also: the converters, the device rule of every
entry point, the perturbation helpers, and a source scan that keeps JAX out of
the port.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu.config import EKFParams as JEKFParams
from decentralized_ekf_mhe_tpu.config import EstimatorParams as JParams
from decentralized_ekf_mhe_tpu.io import synth as jsynth
from decentralized_ekf_mhe_tpu.ops import estimator as jest
from decentralized_ekf_mhe_tpu.parallel import batch as jbatch
from decentralized_ekf_mhe_tpu_torch import convert
from decentralized_ekf_mhe_tpu_torch.config import EKFParams, EstimatorParams
from decentralized_ekf_mhe_tpu_torch.io import synth
from decentralized_ekf_mhe_tpu_torch.kernels import _build, _work
from decentralized_ekf_mhe_tpu_torch.kernels import admm_kernel, ekf_kernel, tridiag_kernel
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import admm, bezier, ekf_lanes, estimator, mhe, mhe_lanes
from decentralized_ekf_mhe_tpu_torch.parallel import batch
from decentralized_ekf_mhe_tpu_torch.utils import precision

torch.set_num_threads(1)

DT = jnp.float64
F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "decentralized_ekf_mhe_tpu_torch")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_fleet(T, B, seed, vo_noise=0.0, per_lane_dp=False):
    log = jsynth.generate(jsynth.SynthConfig(T=T, seed=seed))
    data = jest.tickdata_from_log(log, dtype=DT)
    vo = jest.vodata_from_log(log, dtype=DT)
    data_b = jbatch.to_time_leading(
        jbatch.perturb_log_batch(data, B, jax.random.PRNGKey(0), dtype=DT))
    eb = jbatch.perturb_ekf_blocks(
        jest.ekfblocks_from_log(log, dtype=DT), B, jax.random.PRNGKey(1),
        dtype=DT, vo_noise_scale=vo_noise)
    if per_lane_dp:
        vo = jbatch.perturb_vo_batch(vo, B, jax.random.PRNGKey(2), dtype=DT)
    return log, data_b, eb, vo


def _convert(*trees):
    return [convert.from_jax_numpy(_np(t), "cpu", F64) for t in trees]


def test_staged_pipeline_matches_jax_megakernel_runner():
    """The slice end to end at N=6, T=24, B=128: port (kernel wrappers' CPU
    paths) vs the JAX staged runner with the EKF and MHE Pallas kernels in
    interpret mode. q to 1e-10/1e-12, x and v to 1e-8/1e-9."""
    T, B = 24, 128
    _, data_b, eb, vo = _jax_fleet(T, B, 13)
    jrun = jbatch.make_pipeline_fleet_runner(
        JParams(num_legs=4, leg_odom_type=0, rate=200, N=6), JEKFParams(), DT,
        use_pallas=False, ekf_ring_len=16, use_megakernel=True,
        megakernel_chunk=7, megakernel_interpret=True)
    jx, jv, jq = jrun(data_b, eb, vo)
    tdata, teb, tvo = _convert(data_b, eb, vo)
    trun = batch.make_pipeline_fleet_runner(
        EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=6), EKFParams(),
        F64, ekf_ring_len=16, use_megakernel=True, device="cpu")
    tx, tv, tq = trun(tdata, teb, tvo)
    assert tx.shape == (T, B, 9) and tv.shape == (T, B, 3) and tq.shape == (T, 4, B)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("use_megakernel", [False, True])
def test_pipeline_full_perturbation_matches_jax_eager(use_megakernel):
    """Per-lane VO quaternion into the EKF and per-lane VO translation into
    the MHE (the headline fleet's perturbation), both port paths vs the JAX
    interleaved runner."""
    T, B = 24, 8
    _, data_b, eb, vo = _jax_fleet(T, B, 13, vo_noise=1.0, per_lane_dp=True)
    jrun = jbatch.make_pipeline_fleet_runner(
        JParams(num_legs=4, leg_odom_type=0, rate=200, N=6), JEKFParams(), DT,
        use_pallas=False, ekf_ring_len=16)
    jx, jv, jq = jrun(data_b, eb, vo)
    tdata, teb, tvo = _convert(data_b, eb, vo)
    trun = batch.make_pipeline_fleet_runner(
        EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=6), EKFParams(),
        F64, ekf_ring_len=16, use_megakernel=use_megakernel, device="cpu")
    tx, tv, tq = trun(tdata, teb, tvo)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("use_megakernel", [False, True])
def test_lanes_fleet_runner_matches_jax(use_megakernel):
    T, B = 16, 8
    _, data_b, _, vo = _jax_fleet(T, B, 11)
    jx, jv = jbatch.make_lanes_fleet_runner(
        JParams(num_legs=4, leg_odom_type=0, rate=200, N=6), DT,
        use_pallas=False)(data_b, vo)
    tdata, tvo = _convert(data_b, vo)
    tx, tv = batch.make_lanes_fleet_runner(
        EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=6), F64,
        use_megakernel=use_megakernel, device="cpu")(tdata, tvo)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-8, atol=1e-9)


def test_pipeline_f32_tracks_ground_truth():
    """The port's own data path (own synth, own perturbations with a seeded
    torch.Generator) at float32: finite and tracking the true velocity."""
    T, B = 60, 4
    p = EstimatorParams(
        num_legs=4, leg_odom_type=0, rate=200, N=10,
        p_process_std=[0.001] * 3, accel_input_std=[0.025, 0.025, 0.02],
        gyro_input_std=[0.03] * 3, accel_bias_std=[0.07, 0.02, 0.03],
        joint_position_std=[0.04] * 3, joint_velocity_std=[0.22] * 3,
        foot_slide_std=[0.003] * 3, foot_swing_std=[1e7] * 3,
        vo_p_std=[1.5e-5] * 3)
    pe = EKFParams()
    log = synth.generate(synth.SynthConfig(T=T, seed=1))
    g = torch.Generator().manual_seed(0)
    f32 = torch.float32
    data_b = batch.to_time_leading(batch.perturb_log_batch(
        estimator.tickdata_from_log(log, dtype=f32, device="cpu"), B, g, p, dtype=f32))
    eb = batch.perturb_ekf_blocks(
        estimator.ekfblocks_from_log(log, dtype=f32, device="cpu"), B, g, p,
        dtype=f32, vo_noise_scale=1.0, ekf_params=pe)
    vo = batch.perturb_vo_batch(
        estimator.vodata_from_log(log, dtype=f32, device="cpu"), B, g, p, dtype=f32)
    assert eb.vo_q.shape == (T, eb.gyro.shape[1], 4, B) and vo.dp_body.shape == (T, 3, B)
    run = batch.make_pipeline_fleet_runner(p, pe, f32, use_megakernel=True, device="cpu")
    x, v, q = run(data_b, eb, vo)
    assert x.dtype == f32 and x.shape == (T, B, 9) and v.shape == (T, B, 3)
    assert torch.isfinite(x).all() and torch.isfinite(v).all() and torch.isfinite(q).all()
    err = x[T // 2:, :, 3:6].double().numpy() - log.gt_v_s[T // 2:, None]
    assert float(np.sqrt((err ** 2).mean())) < 0.15


def test_perturbations_are_seeded_and_scaled():
    T, B = 30, 64
    p, pe = EstimatorParams(), EKFParams()
    log = synth.generate(synth.SynthConfig(T=T, seed=2))
    data = estimator.tickdata_from_log(log, dtype=F64, device="cpu")
    eb1 = estimator.ekfblocks_from_log(log, dtype=F64, device="cpu")
    vo1 = estimator.vodata_from_log(log, dtype=F64, device="cpu")

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return (batch.perturb_log_batch(data, B, g, p, dtype=F64),
                batch.perturb_ekf_blocks(eb1, B, g, p, dtype=F64,
                                         vo_noise_scale=1.0, ekf_params=pe),
                batch.perturb_vo_batch(vo1, B, g, p, dtype=F64))

    (d1, e1, v1), (d2, e2, v2), (d3, _, _) = draw(5), draw(5), draw(6)
    assert torch.equal(d1.accel_b, d2.accel_b) and torch.equal(e1.vo_q, e2.vo_q)
    assert torch.equal(v1.dp_body, v2.dp_body)
    assert not torch.equal(d1.accel_b, d3.accel_b)
    assert d1.accel_b.shape == (B, T, 3) and d1.J_foot.shape == (B, T, 4, 3, 3)
    # noise magnitudes follow the configured stds; untouched fields are tiled
    res = (d1.accel_b - data.accel_b[None]).reshape(-1, 3).std(0).numpy()
    np.testing.assert_allclose(res, p.accel_input_std, rtol=0.1)
    assert torch.equal(d1.contact[3], data.contact)
    res = (e1.gyro - eb1.gyro[..., None]).permute(0, 1, 3, 2).reshape(-1, 3).std(0).numpy()
    np.testing.assert_allclose(res, p.gyro_input_std, rtol=0.1)
    act = e1.vo_active
    np.testing.assert_allclose(e1.vo_q[act].norm(dim=-2).numpy(), 1.0, atol=1e-12)
    assert torch.equal(e1.vo_q[~act], eb1.vo_q[~act][..., None].expand(-1, -1, B))
    inactive = ~vo1.active
    assert torch.equal(v1.dp_body[inactive], vo1.dp_body[inactive][..., None].expand(-1, -1, B))
    assert torch.equal(v1.tick_pre, vo1.tick_pre)
    # per-instance timing: the shared clock broadcast per lane, same content
    v4 = batch.perturb_vo_batch(vo1, B, torch.Generator().manual_seed(5), p, dtype=F64,
                                per_instance_timing=True)
    v5 = batch.perturb_vo_batch(vo1, B, torch.Generator().manual_seed(5), p, dtype=F64)
    assert v4.active.shape == v4.tick_now.shape == (T, B) and torch.equal(v4.dp_body, v5.dp_body)
    # layout helpers
    tb = batch.to_time_leading(d1)
    ln = batch.tickdata_to_lanes(tb)
    assert tb.p_foot.shape == (T, B, 4, 3) and ln.p_foot.shape == (T, 4, 3, B)
    assert all(a.is_contiguous() for a in ln)
    assert torch.equal(ln.J_foot[5, 2, :, :, 7], d1.J_foot[7, 5, 2])


@pytest.mark.parametrize("name", ["TickData", "VOData", "EKFBlocks", "EKFStateL",
                                  "EKFConstsL", "MHEStateL", "MHEConsts", "BezierCarry",
                                  "MHEStateL-box", "MHEConsts-box", "MHEConsts-lanebox"])
def test_convert_round_trip(name):
    """from_jax_numpy gives the port's NamedTuple with every leaf equal to the
    JAX side's (floats cast to the requested dtype)."""
    from decentralized_ekf_mhe_tpu.ops import bezier as jbez
    from decentralized_ekf_mhe_tpu.ops import ekf_lanes as jekf
    from decentralized_ekf_mhe_tpu.ops import mhe as jmhe
    from decentralized_ekf_mhe_tpu.ops import mhe_lanes as jml

    _, data_b, eb, vo = _jax_fleet(8, 3, 5, vo_noise=1.0)
    data_l = jbatch.tickdata_to_lanes(data_b)
    jc = jmhe.make_consts(JParams(num_legs=4, leg_odom_type=0, rate=200, N=4), DT)
    if name.endswith("box"):
        hi = np.full((9, 3) if name.endswith("lanebox") else 9, np.inf)
        hi[3:6] = 0.3
        jc = jmhe.make_consts(JParams(num_legs=4, leg_odom_type=0, rate=200, N=4), DT,
                              x_lb=-hi, x_ub=hi, admm_iters=20, use_pallas=True)
    box, name = name.endswith("box"), name.split("-")[0]
    d0 = jax.tree.map(lambda a: a[0], data_l)
    objs = {
        "TickData": data_l, "VOData": vo, "EKFBlocks": eb,
        "EKFStateL": jekf.init_state(JEKFParams(), 3, 16, DT),
        "EKFConstsL": jekf.make_consts(JEKFParams(), DT),
        "MHEStateL": jml.init(jc, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot,
                              d0.J_foot, d0.dq, d0.contact, dtype=DT),
        "MHEConsts": jc,
        "BezierCarry": jbez.init(DT, batch=(3,)),
    }
    targets = {"TickData": estimator.TickData, "VOData": estimator.VOData,
               "EKFBlocks": estimator.EKFBlocks, "EKFStateL": ekf_lanes.EKFStateL,
               "EKFConstsL": ekf_lanes.EKFConstsL, "MHEStateL": mhe_lanes.MHEStateL,
               "MHEConsts": mhe.MHEConsts, "BezierCarry": bezier.BezierCarry}
    src = _np(objs[name])
    for dtype in (F64, torch.float32):
        out = convert.from_jax_numpy(src, "cpu", dtype)
        assert type(out) is targets[name]

        def check(t, j, path):
            if isinstance(t, torch.Tensor):
                j = np.asarray(j)
                assert tuple(t.shape) == j.shape, path
                if j.dtype.kind == "f":
                    assert t.dtype == dtype, path
                    np.testing.assert_allclose(
                        t.double().numpy(), j,
                        rtol=0 if dtype == F64 else 1e-6, atol=0 if dtype == F64 else 1e-30)
                else:
                    assert np.array_equal(t.numpy(), j), path
            elif isinstance(t, tuple) and hasattr(t, "_fields"):
                for f in t._fields:
                    if f in ("x_lb", "x_ub", "admm", "z_adm", "y_adm") and not box:
                        assert getattr(t, f) in (None, ()), path + "." + f
                        continue
                    check(getattr(t, f), getattr(j, f), path + "." + f)
            elif isinstance(t, np.ndarray):
                assert np.array_equal(t, np.asarray(j)), path
            else:
                assert t == np.asarray(j).item() if np.ndim(j) == 0 else t == j, path

        check(out, src, name)
        if box and name == "MHEConsts":
            assert type(out.admm) is admm.ADMMSettings and out.admm.iters == 20
            assert out.use_pallas and torch.isinf(out.x_lb[0]).all()
        if box and name == "MHEStateL":
            assert out.z_adm.shape == out.y_adm.shape == (4, 9, 3)
    with pytest.raises(TypeError):
        convert.from_jax_numpy((1, 2), "cpu", F64)


def _entry_points():
    p, pe = EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=4), EKFParams()
    log = synth.generate(synth.SynthConfig(T=5, seed=0))
    z = lambda *s: torch.zeros(*s, dtype=F64)
    c = mhe.make_consts(p, F64, device="cpu")
    data = estimator.tickdata_from_log(log, dtype=F64, device="cpu")
    data_l = batch.tickdata_to_lanes(batch.to_time_leading(
        estimator.TickData(*(a[None] for a in data))))
    vo = estimator.vodata_from_log(log, dtype=F64, device="cpu")
    eb = estimator.ekfblocks_from_log(log, dtype=F64, device="cpu")
    eb_l = eb._replace(gyro=eb.gyro[..., None].contiguous(),
                       accel=eb.accel[..., None].contiguous())
    d0 = estimator.TickData(*(a[0] for a in data_l))
    st0 = mhe_lanes.init(c, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot, d0.J_foot,
                         d0.dq, d0.contact, dtype=F64, device="cpu")
    ks0 = mrk.kernel_state_from_mhe(st0, c)
    ec = ekf_lanes.make_consts(pe, F64)
    est = ekf_lanes.init_state(pe, 1, 16, F64, device="cpu")
    rest = estimator.TickData(*(a[1:].contiguous() for a in data_l))
    vo_rest = estimator.VOData(*(a[1:] for a in vo))
    vo_inc = estimator.vo_world_increments(data_l.R_sb, vo)[1:].contiguous()
    return {
        "make_pipeline_fleet_runner": lambda **k: batch.make_pipeline_fleet_runner(p, pe, F64, **k),
        "make_lanes_fleet_runner": lambda **k: batch.make_lanes_fleet_runner(p, F64, **k),
        "run_pipeline_lanes": lambda **k: estimator.run_pipeline_lanes(
            p, pe, data_l, eb_l, vo=vo, dtype=F64, consts=c, **k),
        "run_mhe_lanes": lambda **k: estimator.run_mhe_lanes(
            p, data_l, vo=vo, dtype=F64, consts=c, **k),
        "tridiag_kernel.solve_lanes": lambda **k: tridiag_kernel.solve_lanes(
            torch.eye(9, dtype=F64)[None, :, :, None].repeat(3, 1, 1, 2),
            z(2, 9, 9, 2), z(3, 9, 2), **k),
        "ekf_kernel.replay": lambda **k: ekf_kernel.replay(ec, est, eb_l, **k),
        "admm_kernel.solve_box_lanes": lambda **k: admm_kernel.solve_box_lanes(
            torch.eye(9, dtype=F64)[None, :, :, None].repeat(3, 1, 1, 2),
            z(2, 9, 9, 2), torch.ones(3, 9, 2, dtype=F64), -0.5 * np.ones(9),
            0.5 * np.ones(9), admm.ADMMSettings(iters=3), **k),
        "mhe_replay_kernel.replay (box)": lambda **k: mrk.replay(
            mhe.make_consts(p, F64, x_ub=np.full(9, 0.3), admm_iters=3,
                            use_pallas=True, device="cpu"), data_l, vo, dtype=F64, **k),
        "mhe_replay_kernel.replay": lambda **k: mrk.replay(c, data_l, vo, dtype=F64, **k),
        "mhe_replay_kernel.replay (per-lane clock)": lambda **k: mrk.replay(
            c, data_l, estimator.VOData(*(a[..., None] for a in vo)), dtype=F64, **k),
        "mhe_replay_kernel.replay_ticks": lambda **k: mrk.replay_ticks(
            c, ks0, rest, vo_rest, vo_inc, **k),
        "mhe_lanes.init": lambda **k: mhe_lanes.init(
            c, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot, d0.J_foot, d0.dq,
            d0.contact, dtype=F64, **k),
        "ekf_lanes.init_state": lambda **k: ekf_lanes.init_state(pe, 2, 16, F64, **k),
        "bezier.init": lambda **k: bezier.init(F64, batch=(2,), **k),
        "mhe.make_consts": lambda **k: mhe.make_consts(p, F64, **k),
        "tickdata_from_log": lambda **k: estimator.tickdata_from_log(log, **k),
        "vodata_from_log": lambda **k: estimator.vodata_from_log(log, **k),
        "ekfblocks_from_log": lambda **k: estimator.ekfblocks_from_log(log, **k),
    }


ENTRY_POINTS = sorted(_entry_points())


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_device_rule(name, monkeypatch):
    """Every entry point defaults to CUDA and raises where there is none; it
    runs on the CPU only when the caller passes device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_points()[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(device="cuda")
    assert call(device="cpu") is not None


def test_cpu_path_never_builds_or_launches(monkeypatch):
    """On CPU tensors the wrappers take the plain versions: nothing is
    compiled or loaded and no launch is counted."""
    def boom(*a, **k):
        raise AssertionError("the CUDA build must not be touched on the CPU path")

    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(_build, "build", boom)
    counts = lambda: (tridiag_kernel.launches, ekf_kernel.launches, mrk.launches,
                      mrk.launches_box, mrk.launches_pi, mrk.launches_pi_box,
                      admm_kernel.launches)
    before = counts()
    eps = _entry_points()
    for name in ("tridiag_kernel.solve_lanes", "ekf_kernel.replay",
                 "mhe_replay_kernel.replay", "mhe_replay_kernel.replay_ticks",
                 "admm_kernel.solve_box_lanes", "mhe_replay_kernel.replay (box)",
                 "mhe_replay_kernel.replay (per-lane clock)"):
        eps[name](device="cpu")
    assert counts() == before


def test_build_is_keyed_by_sources_and_fails_loudly(monkeypatch, tmp_path):
    h1 = _build._source_hash()
    assert h1 == _build._source_hash() and len(h1) == 16
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-DX"])
    assert _build._source_hash() != h1
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast" in f for f in _build.NVCC_FLAGS)
    # a failing compiler raises with its output; nothing is left half-built
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fake nvcc: error: boom'\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="fake nvcc: error: boom"):
        _build.build()
    assert not [f for _, _, fs in os.walk(tmp_path / "build") for f in fs if f.endswith(".so")]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _build.check_launch(-1, "mhe_tick")
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.check_launch(9, "mhe_tick")
    _build.check_launch(0, "mhe_tick")


def test_work_counts():
    """The bound's byte and operation counts follow the shapes and the
    schedule actually executed, and count no work on structural zeros."""
    b1, f1 = _work.tridiag(20, 9, 1024, 4)
    b2, f2 = _work.tridiag(20, 9, 2048, 8)
    assert (b2, f2) == (4 * b1, 2 * f1)
    assert b1 == 4 * 1024 * (20 * 81 + 19 * 81 + 2 * 20 * 9)
    # a warm-up window with one real slot: one inverse, one product
    assert _work.tridiag(20, 9, 1, 4, n_states=1) == (b1 // 1024, 9 * 10 * 17 + 9 * 17)
    valid = [[1, 1, 0], [1, 1, 1]]
    act = [[0, 0, 0], [0, 1, 0]]
    sb = [[0, 0, 0], [0, 3, 0]]
    assert _work.ekf_schedule(valid, act, sb, 16) == (5, 2, 1)
    assert _work.ekf_schedule(valid, act, [[0] * 3, [0, 9, 0]], 16) == (5, 0, 0)
    assert _work.ekf_schedule(valid, act, [[0] * 3, [0, 1, 0]], 16) == (5, 0, 0)
    _, fa = _work.ekf(2, 8, 16, 5, 0, 0, False, 4)
    _, fb = _work.ekf(2, 8, 16, 5, 2, 1, False, 4)
    assert fb > fa > 0
    assert _work.ekf(2, 8, 16, 5, 0, 0, False, 4, quirk_W=False)[1] > fa

    # the counting rule: dense products in full, selectors free, blocks by block
    dense = _work._full(9, 9)
    assert _work._mm(dense, dense)[1] == 81 * (9 + 8)
    pat = _work._Patterns(9, 12, 4)
    assert _work._mm(pat.Pc.T, _work._full(3, 3))[1] == 0      # P^T Qc: a copy
    assert _work._mm(pat.H.T, pat.Qm)[1] == 0                  # H^T R: a copy
    assert _work._mm(_work._mm(pat.H.T, pat.Qm)[0], pat.H)[1] == 9 * 3   # sum of 4 blocks
    assert _work._mm(pat.Qd, pat.Qd)[1] == 36 * 11 + 9 * 5     # 6x6 and 3x3 blocks
    assert _work._gj(_work._eye(9))[1] == 0

    # the MHE schedule: 40 ticks, a VO pair every 4th tick spanning 8 ticks
    ticks = range(1, 41)
    active = [t % 4 == 0 for t in ticks]
    sched = _work.mhe_schedule(active, [max(t - 10, 0) for t in ticks],
                               [t - 2 for t in ticks], 20)
    assert [n for n, _, _, _ in sched[:20]] == list(range(2, 21)) + [20]
    assert sched[18][2] is None and sched[19][2] is False      # marginalizes from t = N
    assert sched[3][3] is None or sched[3][3] == (0, 0)        # t=4: first VO pair, no curve yet
    assert sched[15][3] == (9, 8)     # t=16, 4th pair: ticks 6..13 written
    assert sum(sched[16][1]) == 8 and not sched[16][1][-1]
    assert sched[35][2] is True       # an interval with a camera term leaves the window
    ba, fa = _work.mhe_tick(20, 9, 12, 4, 16, sched[:10], 0, 4)
    bb, fb = _work.mhe_tick(20, 9, 12, 4, 16, sched[30:], 0, 4)
    assert ba == bb and fb > 2 * fa   # full window and marginalization every tick
    _, fc = _work.mhe_tick(20, 9, 12, 4, 16, sched[30:], 7, 4)
    assert fc - fb == 7 * _work._assembly_ops(pat)[1]
    state = sum(int(np.prod(s)) for s in mrk.state_shapes(20, 9, 12, 4))
    assert ba == 4 * 16 * (10 * (82 + 9) + 2 * state)


def test_precision_guard():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    torch.backends.cuda.matmul.allow_tf32 = True
    precision.full_precision()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert precision.resolve_device("cpu") == torch.device("cpu")


def test_port_imports_no_jax():
    """No file of the port, nor chip_smoke.py, imports jax or anything of the
    JAX package (the port keeps its own copies of what it needs)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        if os.path.basename(root) in ("build", "__pycache__"):
            continue
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    assert len(files) > 20
    # the standard-layout modules, the facade, the utilities, the I/O modules
    # and the example drivers are among the files walked
    for name in ("utils/quaternion.py", "ops/smallmat.py", "ops/tridiag.py", "ops/assembly.py",
                 "ops/kf.py", "ops/ekf.py", "ops/mhe.py", "ops/admm.py", "ops/estimator.py",
                 "parallel/batch.py", "kernels/tridiag_kernel.py", "ops/facade.py",
                 "utils/checkpoint.py", "utils/timing.py", "native.py", "io/logger.py",
                 "io/replay.py", "io/rosbag.py", "io/vo_frontend.py", "io/synth.py",
                 "examples/run_go1.py", "examples/run_robot.py", "examples/run_hil.py"):
        assert os.path.join(PORT, *name.split("/")) in files, name
    bad = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+decentralized_ekf_mhe_tpu(\s|\.|$)"
        r"|from\s+decentralized_ekf_mhe_tpu(\s|\.))", re.M)
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not bad.search(src), path
    # every CUDA source the build names exists, and the kernels' C entry
    # points are the ones the wrappers bind
    for name in _build.SOURCES:
        with open(os.path.join(PORT, "csrc", f"{name}.cu")) as f:
            assert _build._ARGTYPES[name][0] in f.read()


def _box(vb, B=None):
    shape = (9,) if B is None else (9, B)
    lb, ub = np.full(shape, -np.inf), np.full(shape, np.inf)
    lb[3:6], ub[3:6] = -vb, vb
    return lb, ub


def _box_params(cls, N=6):
    p = cls(num_legs=4, leg_odom_type=0, rate=200, N=N, foot_swing_std=[1e7] * 3)
    p.osqp.abs_tol = 1e-8
    p.osqp.relative_tol = 1e-8
    return p


@pytest.mark.parametrize("use_megakernel", [False, True])
def test_constrained_pipeline_matches_jax(use_megakernel):
    """The constrained production pipeline (EKF stage -> constrained MHE ticks,
    tick 0 through the admm_solve wrapper) vs the JAX scanned constrained
    pipeline at float64, with the box binding. x and v to 1e-8/1e-9."""
    from decentralized_ekf_mhe_tpu.ops import mhe as jmhe

    T, B, vb = 20, 16, 0.08
    log = jsynth.generate(jsynth.SynthConfig(T=T, seed=17))
    data = jest.tickdata_from_log(log, dtype=DT)
    vo = jest.vodata_from_log(log, dtype=DT)
    jp = _box_params(JParams)
    data_b = jbatch.to_time_leading(
        jbatch.perturb_log_batch(data, B, jax.random.PRNGKey(0), jp, dtype=DT))
    eb = jbatch.perturb_ekf_blocks(
        jest.ekfblocks_from_log(log, dtype=DT), B, jax.random.PRNGKey(1), jp, dtype=DT)
    lb, ub = _box(vb)
    jc = jmhe.make_consts(jp, DT, x_lb=lb, x_ub=ub, admm_iters=30)
    jx, jv, jq = jbatch.make_pipeline_fleet_runner(
        jp, JEKFParams(), DT, use_pallas=False, ekf_ring_len=16, consts=jc)(data_b, eb, vo)
    tdata, teb, tvo = _convert(data_b, eb, vo)
    tp = _box_params(EstimatorParams)
    tc = mhe.make_consts(tp, F64, x_lb=lb, x_ub=ub, admm_iters=30, use_pallas=True,
                         device="cpu")
    tx, tv, tq = batch.make_pipeline_fleet_runner(
        tp, EKFParams(), F64, ekf_ring_len=16, use_megakernel=use_megakernel,
        consts=tc, device="cpu")(tdata, teb, tvo)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-8, atol=1e-9)
    vmax = float(tx[..., 3:6].abs().max())
    assert vb - 1e-6 <= vmax <= vb + 1e-6


def test_constrained_lanes_runner_per_lane_sweep_matches_jax():
    """Per-lane (s,B) bounds through the lanes fleet runner: every lane keeps
    its own box, and the result equals the JAX runner's."""
    from decentralized_ekf_mhe_tpu.ops import mhe as jmhe

    T, B = 16, 8
    _, data_b, _, vo = _jax_fleet(T, B, 13)
    bnds = np.linspace(0.05, 0.12, B)
    lb, ub = _box(bnds, B)
    jp, tp = _box_params(JParams, 5), _box_params(EstimatorParams, 5)
    jc = jmhe.make_consts(jp, DT, x_lb=lb, x_ub=ub, admm_iters=40)
    jx, jv = jbatch.make_lanes_fleet_runner(jp, DT, use_pallas=False, consts=jc)(data_b, vo)
    tdata, tvo = _convert(data_b, vo)
    tc = mhe.make_consts(tp, F64, x_lb=lb, x_ub=ub, admm_iters=40, use_pallas=True,
                         device="cpu")
    for use_megakernel in (False, True):
        tx, tv = batch.make_lanes_fleet_runner(
            tp, F64, use_megakernel=use_megakernel, consts=tc, device="cpu")(tdata, tvo)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-8, atol=1e-9)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-8, atol=1e-9)
    per_lane = tx[..., 3:6].abs().amax(dim=(0, 2)).numpy()
    assert (per_lane <= bnds + 1e-6).all() and (per_lane >= bnds - 1e-6).any()


def test_runner_rejects_bounds_of_another_fleet_or_device():
    """(s,B) bounds with the wrong B, or on another device than the fleet,
    raise a ValueError from both runners before any kernel sees them."""
    T, B = 6, 4
    _, data_b, eb, vo = _jax_fleet(T, B, 3)
    tdata, teb, tvo = _convert(data_b, eb, vo)
    p = _box_params(EstimatorParams, 4)
    good = mhe.make_consts(p, F64, x_ub=np.full((9, B), 0.3), admm_iters=5,
                           use_pallas=True, device="cpu")
    wrong_B = good._replace(x_lb=torch.zeros(9, B + 1, dtype=F64) - 1,
                            x_ub=torch.ones(9, B + 1, dtype=F64))
    wrong_dev = good._replace(x_lb=good.x_lb.to("meta"), x_ub=good.x_ub.to("meta"))
    for use_megakernel in (False, True):
        for bad in (wrong_B, wrong_dev):
            with pytest.raises(ValueError):
                batch.make_lanes_fleet_runner(
                    p, F64, use_megakernel=use_megakernel, consts=bad,
                    device="cpu")(tdata, tvo)
            with pytest.raises(ValueError):
                batch.make_pipeline_fleet_runner(
                    p, EKFParams(), F64, use_megakernel=use_megakernel, consts=bad,
                    device="cpu")(tdata, teb, tvo)
    x, _ = batch.make_lanes_fleet_runner(p, F64, use_megakernel=True, consts=good,
                                         device="cpu")(tdata, tvo)
    assert x.shape == (T, B, 9)


def test_constrained_work_counts():
    """The constrained tick's bound counts the box-ADMM in place of the Thomas
    sweep, by the iterations that were run."""
    ticks = range(1, 31)
    sched = _work.mhe_schedule([t % 4 == 0 for t in ticks], [max(t - 10, 0) for t in ticks],
                               [t - 2 for t in ticks], 20)
    it20 = np.full((30, 16), 20)
    b0, f0 = _work.mhe_tick(20, 9, 12, 4, 16, sched, 0, 4)
    b1, f1 = _work.mhe_tick(20, 9, 12, 4, 16, sched, 0, 4, box=(it20, 10, False, True, True))
    b2, f2 = _work.mhe_tick(20, 9, 12, 4, 16, sched, 0, 4, box=(it20 // 2, 10, False, True, True))
    assert b1 == b2 == b0 + 4 * 16 * (4 * 180 + 18) + 4 * 30 * 16
    assert f1 > f2 > f0
    # the ADMM part alone: per tick, by that tick's number of real slots
    pat = _work._Patterns(9, 12, 4)
    rest = sum(_work._solve_ops(pat, 20, n, cam, sweep=False) - _work._solve_ops(pat, 20, n, cam)
               for n, cam, _, _ in sched) * 16
    box = sum(_work.admm_ops(9, n, it20[i], 10, False, True, True)
              for i, (n, _, _, _) in enumerate(sched))
    assert f1 - f0 == rest + box
    state = sum(int(np.prod(sh)) for sh in mrk.state_shapes(20, 9, 12, 4, constrained=True))
    assert b1 == 4 * 16 * (30 * (82 + 9) + 2 * state + 18) + 4 * 30 * 16
