"""PyTorch port vs the JAX package: the lanes MHE window engine.

Assembly functions, the Bezier carry, ``mhe_lanes.init``/``step`` state by
state, the eager fleet replay, and the plain versions of the ``mhe_tick`` and
``tridiag_solve`` CUDA kernels (what the wrappers run for CPU tensors) are
held against the JAX package at float64 on the CPU, the Pallas kernels in
interpret mode. Inputs are perturbed once on the JAX side, turned into numpy,
and handed to both.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu.config import EstimatorParams as JParams
from decentralized_ekf_mhe_tpu.io import synth as jsynth
from decentralized_ekf_mhe_tpu.ops import assembly_lanes as jasm
from decentralized_ekf_mhe_tpu.ops import bezier as jbez
from decentralized_ekf_mhe_tpu.ops import estimator as jest
from decentralized_ekf_mhe_tpu.ops import mhe as jmhe
from decentralized_ekf_mhe_tpu.ops import mhe_lanes as jml
from decentralized_ekf_mhe_tpu.pallas import mhe_replay_kernel as jmrk
from decentralized_ekf_mhe_tpu.pallas import tridiag_kernel as jtk
from decentralized_ekf_mhe_tpu.parallel import batch as jbatch
from decentralized_ekf_mhe_tpu_torch import convert
from decentralized_ekf_mhe_tpu_torch.config import EstimatorParams
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.kernels import tridiag_kernel
from decentralized_ekf_mhe_tpu_torch.ops import assembly_lanes, bezier, estimator, mhe, mhe_lanes

torch.set_num_threads(1)

DT = jnp.float64
F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-8)
TIGHT = dict(rtol=1e-11, atol=1e-11)
B = 128

STATE_FIELDS = ("y_meas", "Q_meas", "A_dyn", "b_dyn", "Q_dyn", "b_cam", "Q_cam",
                "cam_active", "M_p", "n_p", "prev_R", "prev_accel_s", "prev_contact")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(N, cls):
    return cls(num_legs=4, leg_odom_type=0, rate=200, N=N)


def _fleet(T, B_, seed, N):
    """JAX-perturbed lanes fleet + VO (per-lane content) and converted twins."""
    log = jsynth.generate(jsynth.SynthConfig(T=T, seed=seed))
    data = jest.tickdata_from_log(log, dtype=DT)
    vo = jest.vodata_from_log(log, dtype=DT)
    data_b = jbatch.to_time_leading(
        jbatch.perturb_log_batch(data, B_, jax.random.PRNGKey(seed), dtype=DT))
    data_l = jbatch.tickdata_to_lanes(data_b)
    tdata_l = convert.from_jax_numpy(_np(data_l), "cpu", F64)
    tvo = convert.from_jax_numpy(_np(vo), "cpu", F64)
    jc = jmhe.make_consts(_params(N, JParams), DT)
    tc = mhe.make_consts(_params(N, EstimatorParams), F64, device="cpu")
    return data_l, vo, jc, tdata_l, tvo, tc


@functools.lru_cache(maxsize=None)
def _jax_window_state(N, T, B_, seed):
    """The JAX window state after T-1 jitted ticks (and the fleet it ran on);
    cached so the tests below share one compile."""
    fleet = _fleet(T, B_, seed, N)
    data_l, vo, jc = fleet[:3]
    d = jax.tree.map(lambda a: a[0], data_l)
    jst = jml.init(jc, d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq,
                   d.contact, dtype=DT)
    states = [jst]
    step = jax.jit(lambda st, d, a, dp, tp_, tn, Rp: jml.step(
        jc, st, d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq,
        d.contact, a, dp, tp_, tn, Rp)[0])
    for t in range(1, T):
        d = jax.tree.map(lambda a: a[t], data_l)
        jst = step(jst, d, vo.active[t], vo.dp_body[t], vo.tick_pre[t],
                   vo.tick_now[t], data_l.R_sb[vo.tick_pre[t]])
        states.append(jst)
    return fleet, states


def _assert_state(tst, jst, tol):
    assert tst.T == int(jst.T)
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(tst, f).numpy().astype(np.float64),
                                   np.asarray(getattr(jst, f)).astype(np.float64),
                                   err_msg=f, **tol)
    assert int(tst.bez.count) == int(jst.bez.count)
    for f in ("pts", "times", "p_accum"):
        np.testing.assert_allclose(getattr(tst.bez, f).numpy(),
                                   np.asarray(getattr(jst.bez, f)), err_msg=f, **tol)


def test_make_consts_matches_jax_and_convert():
    jc = jmhe.make_consts(_params(7, JParams), DT)
    tc = mhe.make_consts(_params(7, EstimatorParams), F64, device="cpu")
    cc = convert.from_jax_numpy(_np(jc), "cpu", F64)
    for other in (tc, cc):
        for f in ("N", "dim_state", "dim_meas", "dt", "leg_odom_type", "num_legs"):
            assert getattr(other, f) == getattr(jc, f), f
        for f in ("A_meas", "P_cam", "Q_vo_p"):
            assert np.array_equal(getattr(other, f).numpy(), np.asarray(getattr(jc, f))), f
        for f in jc.nc._fields:
            assert np.array_equal(getattr(other.nc, f).numpy(),
                                  np.asarray(getattr(jc.nc, f))), f
    view = mhe._params_view(tc)
    assert (view.num_legs, view.leg_odom_type, view.rate) == (4, 0, 200)


@pytest.mark.parametrize("fn", ["build_dynamics", "build_measurement",
                                "prior_state", "spatial_accel"])
def test_assembly_lanes_matches_jax(fn):
    rng = np.random.default_rng(5)
    Bs, L = 6, 4
    q = rng.standard_normal((4, Bs))
    from decentralized_ekf_mhe_tpu.ops import ekf_lanes as jekf
    R = np.asarray(jekf.to_rot(jnp.asarray(q)))
    accel = rng.standard_normal((3, Bs)) + np.array([0, 0, 9.8])[:, None]
    omega = 0.3 * rng.standard_normal((3, Bs))
    p_foot = 0.3 * rng.standard_normal((L, 3, Bs))
    J = rng.standard_normal((L, 3, 3, Bs))
    dq = rng.standard_normal((L, 3, Bs))
    contact = (rng.random((L, Bs)) > 0.4).astype(np.float64)
    jp, tp = _params(6, JParams), _params(6, EstimatorParams)
    jc = jmhe.make_consts(jp, DT)
    tc = mhe.make_consts(tp, F64, device="cpu")
    J_ = lambda *a: [jnp.asarray(x) for x in a]
    T_ = lambda *a: [torch.as_tensor(np.array(x)) for x in a]
    if fn == "build_dynamics":
        args = (R, accel, contact)
    elif fn == "build_measurement":
        args = (R, omega, p_foot, J, dq, contact)
    elif fn == "prior_state":
        args = (rng.standard_normal((12, Bs)),)
    else:
        args = (R, accel)
    if fn == "spatial_accel":
        jout = (jasm.spatial_accel(*J_(*args), jc.nc),)
        tout = (assembly_lanes.spatial_accel(*T_(*args), tc.nc),)
    else:
        jout = getattr(jasm, fn)(jp, jc.nc, *J_(*args))
        tout = getattr(assembly_lanes, fn)(tp, tc.nc, *T_(*args))
    assert len(jout) == len(tout)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-11,
                                   atol=1e-11 * max(1.0, float(np.abs(np.asarray(b)).max())))


def test_bezier_carry_matches_jax():
    rng = np.random.default_rng(8)
    Bs = 5
    jc = jbez.init(DT, batch=(Bs,))
    tc = bezier.init(F64, batch=(Bs,), device="cpu")
    for k in range(7):
        p = rng.standard_normal((Bs, 3))
        jc = jbez.add_way_point(jc, jnp.asarray(p), 0.035 * (k + 1))
        tc = bezier.add_way_point(tc, torch.as_tensor(p), 0.035 * (k + 1))
        assert int(tc.count) == int(jc.count) == k + 1
        np.testing.assert_allclose(tc.pts.numpy(), np.asarray(jc.pts), **TIGHT)
        np.testing.assert_allclose(tc.times.numpy(), np.asarray(jc.times), **TIGHT)
    jd, jn, jm = jbez.interpolate_increments(jc, 0.15, 5, 0.005, max_nodes=9)
    td, tn, tm = bezier.interpolate_increments(tc, 0.15, 5, 0.005, max_nodes=9)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TIGHT)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TIGHT)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    cc = convert.from_jax_numpy(_np(jc), "cpu", F64)
    assert int(cc.count) == 7 and torch.equal(cc.pts, tc.pts)


def test_init_and_step_state_by_state():
    """init, then every tick's full window state and estimate vs JAX: VO
    ingestion (per-lane content), warm-up, and marginalization (T > N)."""
    N, T, Bs = 5, 18, 4
    data_l, vo, jc, tdata_l, tvo, tc = _fleet(T, Bs, 7, N)
    vo = jbatch.perturb_vo_batch(vo, Bs, jax.random.PRNGKey(2), dtype=DT)
    tvo = convert.from_jax_numpy(_np(vo), "cpu", F64)
    assert int(vo.active.sum()) > 0
    jd = lambda t: jax.tree.map(lambda a: a[t], data_l)
    td = lambda t: estimator.TickData(*(a[t] for a in tdata_l))
    d, e = jd(0), td(0)
    jst = jml.init(jc, d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq,
                   d.contact, dtype=DT)
    tst = mhe_lanes.init(tc, e.R_sb, e.accel_b, e.omega_b, e.p_foot, e.J_foot,
                         e.dq, e.contact, dtype=F64, device="cpu")
    _assert_state(tst, jst, TIGHT)
    np.testing.assert_allclose(mhe_lanes.solve_window(tc, tst).numpy(),
                               np.asarray(jml.solve_window(jc, jst)), **TOL)
    jstep = jax.jit(lambda st, d, a, dp, tp_, tn, Rp: jml.step(
        jc, st, d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq,
        d.contact, a, dp, tp_, tn, Rp))
    for t in range(1, T):
        d, e = jd(t), td(t)
        jst, (jx, jxw) = jstep(jst, d, vo.active[t], vo.dp_body[t], vo.tick_pre[t],
                               vo.tick_now[t], data_l.R_sb[vo.tick_pre[t]])
        tst, (tx, txw, it) = mhe_lanes.step(
            tc, tst, e.R_sb, e.accel_b, e.omega_b, e.p_foot, e.J_foot, e.dq,
            e.contact, bool(tvo.active[t]), tvo.dp_body[t], int(tvo.tick_pre[t]),
            int(tvo.tick_now[t]), tdata_l.R_sb[int(tvo.tick_pre[t])])
        assert it is None
        _assert_state(tst, jst, TOL)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
        np.testing.assert_allclose(txw.numpy(), np.asarray(jxw), **TOL)


@pytest.mark.parametrize("per_lane_dp", [False, True])
def test_run_mhe_lanes_matches_jax(per_lane_dp):
    N, T, Bs = 6, 20, 8
    data_l, vo, jc, tdata_l, tvo, tc = _fleet(T, Bs, 7, N)
    if per_lane_dp:
        vo = jbatch.perturb_vo_batch(vo, Bs, jax.random.PRNGKey(3), dtype=DT)
        tvo = convert.from_jax_numpy(_np(vo), "cpu", F64)
    jx, jv = jest.run_mhe_lanes(_params(N, JParams), data_l, vo=vo, dtype=DT, consts=jc)
    tx, tv = estimator.run_mhe_lanes(_params(N, EstimatorParams), tdata_l, vo=tvo,
                                     dtype=F64, consts=tc, device="cpu")
    assert tx.shape == (T, Bs, 9) and tv.shape == (T, Bs, 3)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_run_mhe_lanes_no_vo_matches_jax():
    N, T, Bs = 6, 20, 8
    data_l, _, jc, tdata_l, _, tc = _fleet(T, Bs, 3, N)
    jx, jv = jest.run_mhe_lanes(_params(N, JParams), data_l, vo=None, dtype=DT, consts=jc)
    tx, tv = estimator.run_mhe_lanes(_params(N, EstimatorParams), tdata_l, vo=None,
                                     dtype=F64, consts=tc, device="cpu")
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_mhe_kernel_plain_matches_pallas_interpret():
    """The plain version of the mhe_tick kernel (the CPU path of
    kernels.mhe_replay_kernel.replay) == the Pallas mega-kernel in interpret
    mode at float64: VO, marginalization and a chunk boundary on the JAX
    side (chunk=7 < T-1)."""
    N, T = 6, 20
    data_l, vo, jc, tdata_l, tvo, tc = _fleet(T, B, 7, N)
    jx = jmrk.replay(jc, data_l, vo, dtype=DT, chunk=7, interpret=True)
    before = mrk.launches, tridiag_kernel.launches
    tx = mrk.replay(tc._replace(use_pallas=True), tdata_l, tvo, dtype=F64, device="cpu")
    assert (mrk.launches, tridiag_kernel.launches) == before   # CPU: no launch
    assert tx.shape == (T, 9, B)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


def test_state_to_arrays_caches_match_jax():
    N, T = 5, 9
    (data_l, vo, jc, tdata_l, tvo, tc), states = _jax_window_state(N, T, 4, 7)
    jst = states[-1]
    tst = convert.from_jax_numpy(_np(jst), "cpu", F64)
    _assert_state(tst, jst, TIGHT)
    jarr = jmrk._state_to_arrays(jst, jc)
    tarr = mrk._state_to_arrays(tst, tc)
    assert len(jarr) == len(tarr) == 18
    for k, (a, b) in enumerate(zip(tarr, jarr)):
        assert tuple(a.shape) == tuple(b.shape), k
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=str(k), **TIGHT)
    shapes = mrk.state_shapes(N, 9, 12, 4)
    assert [tuple(a.shape[:-1]) for a in tarr] == shapes
    # physical ring order round trip keeps the window and the tick counter
    ks = mrk.kernel_state_from_mhe(tst, tc)
    assert ks.t == T - 1 and ks.t % N != 0
    back = mrk.mhe_state_from_kernel(ks, tc)
    _assert_state(back, jst, TIGHT)


def test_replay_ticks_split_log_equals_one_call():
    """State in, final state out: a log split over two replay_ticks calls
    equals one call (plain path), including the tick counter and the ring."""
    N, T, Bs = 5, 19, 4
    _, _, _, tdata_l, tvo, tc = _fleet(T, Bs, 7, N)
    d0 = estimator.TickData(*(a[0] for a in tdata_l))
    st0 = mhe_lanes.init(tc, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot,
                         d0.J_foot, d0.dq, d0.contact, dtype=F64, device="cpu")
    vo_inc = estimator.vo_world_increments(tdata_l.R_sb, tvo)
    ks0 = mrk.kernel_state_from_mhe(st0, tc)

    def seg(sl):
        return (estimator.TickData(*(a[sl].contiguous() for a in tdata_l)),
                estimator.VOData(*(a[sl] for a in tvo)), vo_inc[sl].contiguous())

    x_all, ks_all = mrk.replay_ticks(tc, ks0, *seg(slice(1, None)), device="cpu")
    xA, ksA = mrk.replay_ticks(tc, ks0, *seg(slice(1, 8)), device="cpu")
    xB, ksB = mrk.replay_ticks(tc, ksA, *seg(slice(8, None)), device="cpu")
    assert ksA.t == 7 and ksB.t == ks_all.t == T - 1
    np.testing.assert_allclose(torch.cat([xA, xB]).numpy(), x_all.numpy(), **TIGHT)
    for a, b in zip(ksB.arrays, ks_all.arrays):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   rtol=1e-9, atol=1e-9 * max(1.0, float(b.abs().max())))
    assert int(ksB.bez_count) == int(ks_all.bez_count) > 0


@pytest.mark.parametrize("full_window", [False, True])
def test_tridiag_plain_matches_pallas_interpret(full_window):
    """The plain version of the tridiag_solve kernel (CPU path of
    kernels.tridiag_kernel.solve_lanes) == the Pallas kernel in interpret
    mode, on a real masked window system (tick 0 and a full window)."""
    (data_l, vo, jc, tdata_l, tvo, tc), states = _jax_window_state(5, 9, 4, 7)
    jst = states[-1] if full_window else states[0]
    jD, jU, jr = jml._masked_system(jc, jst)
    tst = convert.from_jax_numpy(_np(jst), "cpu", F64)
    tD, tU, tr = mhe_lanes._masked_system(tc, tst)
    for a, b in ((tD, jD), (tU, jU), (tr, jr)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-11,
                                   atol=1e-11 * max(1.0, float(np.abs(np.asarray(b)).max())))
    jx = jtk.solve_lanes(jD, jU, jr, interpret=True)
    tx = tridiag_kernel.solve_lanes(tD.contiguous(), tU.contiguous(),
                                    tr.contiguous(), device="cpu")
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


def test_unported_branches_raise():
    # the stage ablation at Cassie's shape (foot positions as states) is
    # ported now: it has its library; a shape outside the build has none
    p1 = EstimatorParams(num_legs=2, leg_odom_type=1, rate=200, N=6)
    assert mrk.kernel_library(p1.dim_state, p1.dim_meas, p1.num_legs, p1.leg_odom_type,
                              per_lane_clock=False, ablate="marg") == "mhe_cassie_abl_f64"
    with pytest.raises(NotImplementedError, match="no CUDA instantiation"):
        mrk.kernel_library(12, 6, 1, 1, per_lane_clock=False, ablate="marg")
    z = torch.zeros
    # per-lane VO timing has no EKF kernel, in this package as in the
    # reference: the kernel wrapper refuses it (the runners take the scan)
    from decentralized_ekf_mhe_tpu_torch.config import EKFParams
    from decentralized_ekf_mhe_tpu_torch.kernels import ekf_kernel
    from decentralized_ekf_mhe_tpu_torch.ops import ekf_lanes
    T, S, B = 3, 3, 2
    eb = estimator.EKFBlocks(
        gyro=z(T, S, 3, B, dtype=F64), accel=z(T, S, 3, B, dtype=F64),
        valid=torch.ones(T, S, dtype=torch.bool), vo_active=torch.zeros(T, S, B, dtype=torch.bool),
        vo_q=z(T, S, 4, B, dtype=F64), vo_steps_back=torch.zeros(T, S, B, dtype=torch.int32))
    st = ekf_lanes.init_state(EKFParams(), B, 16, F64, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ekf_kernel.replay(ekf_lanes.make_consts(EKFParams(), F64), st, eb, device="cpu")


def test_wrappers_reject_bad_operands():
    rng = np.random.default_rng(0)
    D = torch.as_tensor(rng.standard_normal((4, 9, 9, 3)))
    U = torch.as_tensor(rng.standard_normal((3, 9, 9, 3)))
    r = torch.as_tensor(rng.standard_normal((4, 9, 3)))
    with pytest.raises(ValueError):
        tridiag_kernel.solve_lanes(D, U[:2], r, device="cpu")
    with pytest.raises(ValueError):
        tridiag_kernel.solve_lanes(D, U, r.float(), device="cpu")
    with pytest.raises(ValueError):
        tridiag_kernel.solve_lanes(D.transpose(1, 2), U, r, device="cpu")
    with pytest.raises(ValueError):
        tridiag_kernel.solve_lanes(D.to(torch.int32), U, r, device="cpu")


# ---- the state-constrained path (box-ADMM window solve) ---------------------


def _box_params(N, cls, tol=1e-8):
    p = cls(num_legs=4, leg_odom_type=0, rate=200, N=N, foot_swing_std=[1e7] * 3)
    p.osqp.abs_tol = tol
    p.osqp.relative_tol = tol
    return p


def _vel_box(vb, Bn=None):
    """±vb on the velocity states 3:6; vb a float ((s,) bounds) or a (B,)
    array ((s,B) per-lane bounds)."""
    shape = (9,) if Bn is None else (9, Bn)
    lb, ub = np.full(shape, -np.inf), np.full(shape, np.inf)
    lb[3:6], ub[3:6] = -vb, vb
    return lb, ub


def _box_fleet(T, B_, seed, N, vb, iters, Bn=None, use_pallas=False):
    data_l, vo, _, tdata_l, tvo, _ = _fleet(T, B_, seed, N)
    lb, ub = _vel_box(vb, Bn)
    # the JAX side keeps use_pallas off: its ADMM kernel has no CPU path
    # outside interpret mode (the mega-kernel is asked for interpret mode)
    jc = jmhe.make_consts(_box_params(N, JParams), DT, x_lb=lb, x_ub=ub,
                          admm_iters=iters)
    tc = mhe.make_consts(_box_params(N, EstimatorParams), F64, x_lb=lb, x_ub=ub,
                         admm_iters=iters, use_pallas=use_pallas, device="cpu")
    return data_l, vo, jc, tdata_l, tvo, tc


@pytest.mark.parametrize("bounds", ["shared", "per_lane", "upper_only", "tensor"])
def test_make_consts_with_bounds_matches_jax_and_convert(bounds):
    N, Bn = 7, 5
    if bounds == "upper_only":
        kw = dict(x_ub=np.arange(9.0))
    else:
        lb, ub = _vel_box(0.3 if bounds != "per_lane" else np.linspace(0.2, 0.4, Bn),
                          Bn if bounds == "per_lane" else None)
        kw = dict(x_lb=lb, x_ub=ub)
    jc = jmhe.make_consts(_box_params(N, JParams), DT, admm_iters=20, **kw)
    if bounds == "tensor":
        kw = {k: torch.as_tensor(v) for k, v in kw.items()}
    tc = mhe.make_consts(_box_params(N, EstimatorParams), F64, admm_iters=20,
                         device="cpu", **kw)
    cc = convert.from_jax_numpy(_np(jc), "cpu", F64)
    for other in (tc, cc):
        assert other.x_lb.dtype == F64 and other.x_lb.device.type == "cpu"
        assert np.array_equal(other.x_lb.numpy(), np.asarray(jc.x_lb))
        assert np.array_equal(other.x_ub.numpy(), np.asarray(jc.x_ub))
        assert tuple(other.admm) == tuple(jc.admm) and other.admm.iters == 20
        assert type(other.admm.iters) is int and type(other.admm.adaptive_rho) is bool
    free = mhe.make_consts(_box_params(N, EstimatorParams), F64, device="cpu")
    assert free.x_lb is None and free.x_ub is None and free.admm is None
    c32 = mhe.make_consts(_box_params(N, EstimatorParams), torch.float32,
                          device="cpu", **kw)
    assert c32.x_ub.dtype == torch.float32 and c32.admm.iters == 200


def test_constrained_init_and_step_state_by_state():
    """Every tick's window state incl. the z/y warm-start carry, the estimate
    and the whole-window solution vs JAX, with the box binding."""
    N, T, Bs, vb = 5, 16, 4, 0.08
    data_l, vo, jc, tdata_l, tvo, tc = _box_fleet(T, Bs, 9, N, vb, 30)
    jd = lambda t: jax.tree.map(lambda a: a[t], data_l)
    td = lambda t: estimator.TickData(*(a[t] for a in tdata_l))
    d, e = jd(0), td(0)
    jst = jml.init(jc, d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq,
                   d.contact, dtype=DT)
    tst = mhe_lanes.init(tc, e.R_sb, e.accel_b, e.omega_b, e.p_foot, e.J_foot,
                         e.dq, e.contact, dtype=F64, device="cpu")
    assert tst.z_adm.shape == tst.y_adm.shape == (N, 9, Bs) and not tst.z_adm.any()
    np.testing.assert_allclose(mhe_lanes.solve_window(tc, tst).numpy(),
                               np.asarray(jml.solve_window(jc, jst)), **TOL)
    jstep = jax.jit(lambda st, d, a, dp, tp_, tn, Rp: jml.step(
        jc, st, d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq,
        d.contact, a, dp, tp_, tn, Rp))
    vmax, iters = 0.0, []
    for t in range(1, T):
        d, e = jd(t), td(t)
        jst, (jx, jxw) = jstep(jst, d, vo.active[t], vo.dp_body[t], vo.tick_pre[t],
                               vo.tick_now[t], data_l.R_sb[vo.tick_pre[t]])
        tst, (tx, txw, it) = mhe_lanes.step(
            tc, tst, e.R_sb, e.accel_b, e.omega_b, e.p_foot, e.J_foot, e.dq,
            e.contact, bool(tvo.active[t]), tvo.dp_body[t], int(tvo.tick_pre[t]),
            int(tvo.tick_now[t]), tdata_l.R_sb[int(tvo.tick_pre[t])])
        iters.append(it)
        _assert_state(tst, jst, TOL)
        for f in ("z_adm", "y_adm"):
            ref = np.asarray(getattr(jst, f))
            np.testing.assert_allclose(getattr(tst, f).numpy(), ref, rtol=1e-8,
                                       atol=1e-8 * max(1.0, float(np.abs(ref).max())),
                                       err_msg=f)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
        np.testing.assert_allclose(txw.numpy(), np.asarray(jxw), **TOL)
        vmax = max(vmax, float(tx[3:6].abs().max()))
    assert vb - 1e-6 <= vmax <= vb + 1e-6
    assert len(iters) == T - 1 and iters[0].shape == (Bs,) and int(iters[-1].max()) <= 30
    xw, zw, yw = mhe_lanes.solve_window_with_duals(tc, tst)
    jxw, jzw, jyw = jml.solve_window_with_duals(jc, jst)
    np.testing.assert_allclose(xw.numpy(), np.asarray(jxw), **TOL)
    np.testing.assert_allclose(zw.numpy(), np.asarray(jzw), **TOL)


@pytest.mark.parametrize("bounds", ["shared", "per_lane"])
def test_constrained_replay_matches_pallas_interpret_and_lanes(bounds):
    """The constrained replay (plain on the CPU; tick 0 through the
    admm_solve wrapper) == the constrained Pallas mega-kernel in interpret
    mode across a chunk boundary == the eager lanes loop, with the box
    binding."""
    N, T = 6, 24
    vb = 0.08 if bounds == "shared" else np.linspace(0.05, 0.12, B)
    data_l, vo, jc, tdata_l, tvo, tc = _box_fleet(
        T, B, 9, N, vb, 40, Bn=None if bounds == "shared" else B, use_pallas=True)
    jx = jmrk.replay(jc, data_l, vo, dtype=DT, chunk=7, interpret=True)
    before = mrk.launches, mrk.launches_box
    tx = mrk.replay(tc, tdata_l, tvo, dtype=F64, device="cpu")
    assert (mrk.launches, mrk.launches_box) == before          # CPU: no launch
    assert tx.shape == (T, 9, B)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    ex, _ = estimator.run_mhe_lanes(_box_params(N, EstimatorParams), tdata_l, vo=tvo,
                                    dtype=F64, consts=tc._replace(use_pallas=False),
                                    device="cpu")
    np.testing.assert_allclose(torch.movedim(ex, 1, -1).numpy(), tx.numpy(), **TOL)
    v = tx[:, 3:6].abs().amax(dim=(0, 1)).numpy()
    assert (v <= vb + 1e-6).all() and (v >= vb - 1e-6).any()


def test_constrained_replay_ticks_split_log_and_state_round_trip():
    """The constrained KernelState carries z/y in ring order: 20 tensors, a
    round trip keeps them, and a split log equals one call."""
    N, T, Bs = 5, 19, 4
    _, _, _, tdata_l, tvo, tc = _box_fleet(T, Bs, 9, N, 0.08, 20)
    d0 = estimator.TickData(*(a[0] for a in tdata_l))
    st0 = mhe_lanes.init(tc, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot,
                         d0.J_foot, d0.dq, d0.contact, dtype=F64, device="cpu")
    vo_inc = estimator.vo_world_increments(tdata_l.R_sb, tvo)
    ks0 = mrk.kernel_state_from_mhe(st0, tc)
    shapes = mrk.state_shapes(N, 9, 12, 4, constrained=True)
    assert len(ks0.arrays) == len(shapes) == 20
    assert [tuple(a.shape[:-1]) for a in ks0.arrays] == shapes

    def seg(sl):
        return (estimator.TickData(*(a[sl].contiguous() for a in tdata_l)),
                estimator.VOData(*(a[sl] for a in tvo)), vo_inc[sl].contiguous())

    x_all, ks_all = mrk.replay_ticks(tc, ks0, *seg(slice(1, None)), device="cpu")
    xA, ksA = mrk.replay_ticks(tc, ks0, *seg(slice(1, 8)), device="cpu")
    assert ks0.iters is None and ksA.iters.shape == (7, Bs) and ksA.iters.dtype == torch.int32
    assert torch.equal(ksA.iters, ks_all.iters[:7])
    xB, ksB = mrk.replay_ticks(tc, ksA, *seg(slice(8, None)), device="cpu")
    assert ksA.t == 7 and ksB.t == ks_all.t == T - 1 and ksA.t % N != 0
    np.testing.assert_allclose(torch.cat([xA, xB]).numpy(), x_all.numpy(), **TIGHT)
    for a, b in zip(ksB.arrays, ks_all.arrays):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   rtol=1e-9, atol=1e-9 * max(1.0, float(b.abs().max())))
    # ring <-> logical order keeps the warm starts with their window slots
    stA = mrk.mhe_state_from_kernel(ksA, tc)
    assert torch.equal(torch.roll(stA.z_adm, ksA.t % N, dims=0), ksA.arrays[18])
    assert ks_all.arrays[19].abs().max() > 0          # the box was active
    back = mrk.kernel_state_from_mhe(stA, tc)
    assert all(torch.equal(a, b) for a, b in zip(back.arrays[:15] + back.arrays[18:],
                                                 ksA.arrays[:15] + ksA.arrays[18:]))
    # consts and state must agree on whether there is a box
    free = mhe.make_consts(_box_params(N, EstimatorParams), F64, device="cpu")
    with pytest.raises(ValueError, match="20 tensors"):
        mrk.replay_ticks(free, ksA, *seg(slice(8, None)), device="cpu")
    with pytest.raises(ValueError):
        mrk.replay_ticks(tc._replace(x_lb=torch.zeros(9, Bs + 1, dtype=F64)), ksA,
                         *seg(slice(8, None)), device="cpu")


def test_tight_box_is_violated_by_what_the_budget_leaves():
    """At a tight box the default budget leaves the bound violated, and the
    polish pins only the dims whose iterate already sits on the bound: the
    port exceeds the box by exactly what the JAX package exceeds it by."""
    N, T, Bs, vb = 6, 30, 8, 0.05
    data_l, vo, jc, tdata_l, tvo, tc = _box_fleet(T, Bs, 7, N, vb, None)
    default = EstimatorParams().osqp
    jc = jc._replace(admm=jc.admm._replace(abs_tol=default.abs_tol, rel_tol=default.relative_tol))
    tc = tc._replace(admm=tc.admm._replace(abs_tol=default.abs_tol, rel_tol=default.relative_tol))
    assert tc.admm.iters == 200 and tc.admm.abs_tol == 1e-3
    jx, _ = jest.run_mhe_lanes(_box_params(N, JParams), data_l, vo=vo, dtype=DT, consts=jc)
    tx, _ = estimator.run_mhe_lanes(_box_params(N, EstimatorParams), tdata_l, vo=tvo,
                                    dtype=F64, consts=tc, device="cpu")
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    j_excess = float(np.abs(np.asarray(jx)[..., 3:6]).max()) - vb
    t_excess = float(tx[..., 3:6].abs().max()) - vb
    assert abs(t_excess - j_excess) < 1e-8
    assert t_excess > 1e-3, "the tight box was expected to be exceeded"
