"""PyTorch port vs the JAX package: the standard-layout estimator.

The quaternion utilities, the small-matrix algebra, the block-tridiagonal
solver, the standard-layout assembly builders, the KF baseline, the
single-instance orientation EKF, the MHE window engine (state by state and
whole replays, unconstrained and with a box), and the standard-layout route
of the block-tridiagonal kernel (its plain version, which CPU tensors take)
are held against the JAX package at float64 on the CPU, the Pallas kernel in
interpret mode. Inputs are made once with numpy (or on the JAX side) and
handed to both. The fleet runners are in ``test_torch_standard_fleet.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu.config import EKFParams as JEKFParams
from decentralized_ekf_mhe_tpu.config import EstimatorParams as JParams
from decentralized_ekf_mhe_tpu.io import synth as jsynth
from decentralized_ekf_mhe_tpu.ops import assembly as jasm
from decentralized_ekf_mhe_tpu.ops import bezier as jbez
from decentralized_ekf_mhe_tpu.ops import ekf as jekf
from decentralized_ekf_mhe_tpu.ops import estimator as jest
from decentralized_ekf_mhe_tpu.ops import kf as jkf
from decentralized_ekf_mhe_tpu.ops import mhe as jmhe
from decentralized_ekf_mhe_tpu.ops import smallmat as jsm
from decentralized_ekf_mhe_tpu.ops import tridiag as jtri
from decentralized_ekf_mhe_tpu.pallas import tridiag_kernel as jtk
from decentralized_ekf_mhe_tpu.utils import quaternion as jquat
from decentralized_ekf_mhe_tpu_torch import convert
from decentralized_ekf_mhe_tpu_torch.config import EKFParams, EstimatorParams
from decentralized_ekf_mhe_tpu_torch.kernels import _work, tridiag_kernel
from decentralized_ekf_mhe_tpu_torch.ops import (assembly, ekf, estimator, kf, mhe, smallmat,
                                                 tridiag)
from decentralized_ekf_mhe_tpu_torch.utils import quaternion as quat

torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = torch.float64
TIGHT = dict(rtol=1e-10, atol=1e-12)     # EKF, quaternions, small matrices
TOL = dict(rtol=1e-8, atol=1e-8)         # MHE, KF, tridiagonal
T_LOG = 60


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _params(cls, model, N=8):
    """Go1's bench settings (leg_odom_type 0, 4 legs) or Cassie's
    (foot positions as states, 2 legs; tests/test_kf_slice.py)."""
    common = dict(rate=200, N=N, p_process_std=[0.001] * 3,
                  accel_input_std=[0.025, 0.025, 0.02])
    if model == "go1":
        return cls(num_legs=4, leg_odom_type=0, gyro_input_std=[0.03] * 3,
                   accel_bias_std=[0.07, 0.02, 0.03], joint_position_std=[0.04] * 3,
                   joint_velocity_std=[0.22] * 3, foot_slide_std=[0.003] * 3,
                   foot_swing_std=[1e7] * 3, vo_p_std=[1.5e-5] * 3, **common)
    return cls(num_legs=2, leg_odom_type=1, joint_position_std=[0.02] * 3,
               foot_slide_std=[0.003] * 3, foot_swing_std=[1e4] * 3, **common)


def _log(model, T=T_LOG):
    if model == "go1":
        return jsynth.generate(jsynth.SynthConfig(T=T, seed=1))
    return jsynth.generate(jsynth.SynthConfig(T=T, num_legs=2, gait_hz=1.6, seed=2))


def _args(d):
    """A tick's inputs in the order of ``mhe.init``/``mhe.step``."""
    return (d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq, d.contact)


def _data(log):
    """(JAX TickData, port TickData, JAX VOData, port VOData), float64."""
    jd = jest.tickdata_from_log(log, dtype=jnp.float64)
    jv = jest.vodata_from_log(log, dtype=jnp.float64)
    return (jd, convert.from_jax_numpy(_np(jd), CPU, F64),
            jv, convert.from_jax_numpy(_np(jv), CPU, F64))


# ---------------------------------------------------------- small algebra


def test_quaternion_utils_match():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((5, 3, 4))
    q2 = rng.standard_normal((5, 3, 4))
    w = rng.standard_normal((5, 3, 3))
    g = np.array([0.0, 0.0, 9.81])
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    pairs = [
        (jquat.normalize(q), quat.normalize(_t(q))),
        (jquat.mul(q, q2), quat.mul(_t(q), _t(q2))),
        (jquat.inv(q), quat.inv(_t(q))),
        (jquat.to_rot(q), quat.to_rot(_t(q))),
        (jquat.gyro_to_omega(w), quat.gyro_to_omega(_t(w))),
        (jquat.quat_to_H(q, jnp.asarray(g)), quat.quat_to_H(_t(q), _t(g))),
        (jquat.to_euler(qn), quat.to_euler(_t(qn))),
        (jquat.skew(w), quat.skew(_t(w))),
    ]
    for quirk in (True, False):
        pairs.append((jquat.quat_to_W(q, 0.002, quirk_compatible=quirk),
                      quat.quat_to_W(_t(q), 0.002, quirk_compatible=quirk)))
    for j, t in pairs:
        assert tuple(t.shape) == tuple(np.shape(j))
        _close(t, j, **TIGHT)


def test_smallmat_matches():
    rng = np.random.default_rng(1)
    inv, inv3 = jax.jit(jsm.gj_inv), jax.jit(jsm.inv3)
    for n in (3, 9, 15):
        M = rng.standard_normal((4, n, n))
        A = M @ np.swapaxes(M, -1, -2) + n * np.eye(n)
        b = rng.standard_normal((4, n))
        Bm = rng.standard_normal((4, n, 2))
        Ainv = inv(A)
        _close(smallmat.gj_inv(_t(A)), Ainv, **TIGHT)
        _close(smallmat.inv(_t(A)), inv3(A) if n == 3 else Ainv, **TIGHT)
        _close(smallmat.solve(_t(A), _t(b)), np.einsum("...ij,...j->...i", Ainv, b), **TIGHT)
        _close(smallmat.solve_mat(_t(A), _t(Bm)), np.asarray(Ainv) @ Bm, **TIGHT)


def _system(K, B, s, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((K, B, s, s))
    D = M @ np.swapaxes(M, -1, -2) + 5 * np.eye(s)
    U = 0.3 * rng.standard_normal((K - 1, B, s, s))
    r = rng.standard_normal((K, B, s))
    valid = np.ones((K, B), bool)
    valid[:3] = False                  # the warm-up: the first slots are dead
    return D, U, r, valid


def test_tridiag_matches_with_warmup_mask():
    D, U, r, valid = _system(8, 5, 9, seed=2)
    x = tridiag.solve(_t(D), _t(U), _t(r), valid=_t(valid))
    want, want_f = jax.jit(lambda *a: (
        jtri.solve(*a), jtri.solve_factored(jtri.factor(a[0], a[1], valid=a[3]), a[2],
                                            valid=a[3])))(D, U, r, valid)
    _close(x, want, **TIGHT)
    assert float(x[:3].abs().max()) == 0.0
    fac = tridiag.factor(_t(D), _t(U), valid=_t(valid))
    xf = tridiag.solve_factored(fac, _t(r), valid=_t(valid))
    _close(xf, want_f, **TIGHT)
    _close(xf, x, **TIGHT)
    # one instance, against the dense solve of both packages
    x1 = tridiag.solve(_t(D[:, 0]), _t(U[:, 0]), _t(r[:, 0]))
    _close(x1, tridiag.solve_dense_check(_t(D[:, 0]), _t(U[:, 0]), _t(r[:, 0])), **TIGHT)
    _close(x1, jtri.solve_dense_check(D[:, 0], U[:, 0], r[:, 0]), **TIGHT)


@pytest.mark.parametrize("s", [9, 15])
def test_standard_route_plain_matches_pallas_interpret(s):
    """K5's standard-layout route: the plain version (what CPU tensors take)
    against the reference's ``solve_batched`` in interpret mode, on a ragged
    fleet (B not a multiple of 128) with a warm-up mask."""
    K, B = 5, 5
    D, U, r, valid = _system(K, B, s, seed=3 + s)
    want = jtk.solve_batched(*map(jnp.asarray, (D, U, r)), valid=jnp.asarray(valid),
                             interpret=True)
    got = tridiag_kernel.solve_batched(_t(D), _t(U), _t(r), valid=_t(valid), device="cpu")
    _close(got, want, **TOL)
    assert float(got[:3].abs().max()) == 0.0 and float(got[3:].abs().min()) > 0.0
    # the plain version is the exact sweep's arithmetic, bit for bit
    assert torch.equal(got, tridiag.solve(_t(D), _t(U), _t(r), valid=_t(valid)))


def test_standard_route_operand_checks():
    D, U, r, valid = (_t(a) for a in _system(6, 4, 9, seed=7))
    solve = tridiag_kernel.solve_batched
    with pytest.raises(ValueError, match="D: expected"):
        solve(D[0], U, r, device="cpu")
    with pytest.raises(ValueError, match="U: expected"):
        solve(D, U[:-1], r, device="cpu")
    with pytest.raises(ValueError, match="r: expected"):
        solve(D, U, r.float(), device="cpu")
    with pytest.raises(ValueError, match="valid: expected"):
        solve(D, U, r, valid=valid[:, 0], device="cpu")
    with pytest.raises(ValueError, match="valid: expected"):
        solve(D, U, r, valid=valid.double(), device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        solve(D.half(), U.half(), r.half(), device="cpu")
    before = tridiag_kernel.launches_batched
    solve(D, U, r, valid=valid, device="cpu")
    assert tridiag_kernel.launches_batched == before     # the plain version launches nothing


def test_standard_route_work_counts():
    """The standard route's bytes and operations per launch: K5's own at the
    warm-up's live slots, and the masking and the two layout moves apart."""
    N, s, B = 4, 2, 3
    w = _work.tridiag_batched(N, s, B, 8, n_states=2)
    assert w["solve"] == _work.tridiag(N, s, B, 8, n_states=2)
    # masking: D, U, r read and written once each; 2 operations per element
    # of D (the select of the identity), 1 per element of U and r
    assert w["mask"] == (8 * B * 2 * (4 * 4 + 3 * 4 + 4 * 2), B * (2 * 16 + 12 + 8))
    # the layout moves: D, U, r to lanes and x back, read and written once
    assert w["layout"] == (8 * B * 2 * (16 + 12 + 8 + 8), 0)
    assert w["total"] == tuple(sum(w[k][i] for k in ("solve", "mask", "layout"))
                               for i in (0, 1))


# ---------------------------------------------------------- assembly, KF


@pytest.mark.parametrize("model", ["go1", "cassie"])
def test_assembly_builders_match(model):
    jp, p = _params(JParams, model), _params(EstimatorParams, model)
    log = _log(model, T=12)
    jd, td, _, _ = _data(log)
    jnc = jasm.make_noise_consts(jp, jnp.float64)
    nc = assembly.make_noise_consts(p, F64, device="cpu")
    sl = slice(2, 12)                  # ten ticks as a batch
    jR, tR = jd.R_sb[sl], td.R_sb[sl]

    @jax.jit
    def reference(R, accel_b, contact, *meas):
        a = jasm.spatial_accel(R, accel_b, jnc)
        m = jasm.build_measurement(jp, jnc, R, *meas, contact)
        return a, jasm.build_dynamics(jp, jnc, R, a, contact), m, jasm.prior_state(jp, jnc, m[0])

    meas = lambda d: (d.omega_b[sl], d.p_foot[sl], d.J_foot[sl], d.dq[sl])
    ja, jdyn, jm, jprior = reference(jR, jd.accel_b[sl], jd.contact[sl], *meas(jd))
    ta = assembly.spatial_accel(tR, td.accel_b[sl], nc)
    _close(ta, ja, atol=1e-12, rtol=0)
    for got, want, atol in zip(assembly.build_dynamics(p, nc, tR, ta, td.contact[sl]), jdyn,
                               (1e-12, 1e-12, 1e-12, 1e-6)):
        _close(got, want, atol=atol, rtol=1e-12)
    tm = assembly.build_measurement(p, nc, tR, *meas(td), td.contact[sl])
    for got, want, atol in zip(tm, jm, (1e-12, 1e-12, 1e-7)):
        _close(got, want, atol=atol, rtol=1e-12)
    for got, want in zip(assembly.prior_state(p, nc, tm[0]), jprior):
        _close(got, want, atol=1e-12, rtol=0)


@pytest.mark.parametrize("model", ["go1", "cassie"])
def test_run_kf_matches(model):
    jp, p = _params(JParams, model), _params(EstimatorParams, model)
    jd, td, _, _ = _data(_log(model))
    jx, jv = jax.jit(lambda d: jest.run_kf(jp, d))(jd)
    x, v = estimator.run_kf(p, td, device="cpu")
    assert x.shape == (T_LOG, p.dim_state) and v.shape == (T_LOG, 3)
    _close(x, jx, **TOL)
    _close(v, jv, **TOL)
    # the KF pieces on their own, one update
    nc = assembly.make_noise_consts(p, F64, device="cpu")
    st = kf.KFState(x[5], torch.eye(p.dim_state, dtype=F64))
    jst = jkf.KFState(jnp.asarray(x[5].numpy()), jnp.eye(p.dim_state))
    d = estimator.TickData(*(a[6] for a in td))
    A, b, C, _ = assembly.build_dynamics(p, nc, d.R_sb, d.accel_b, d.contact)
    bm, Cm, _ = assembly.build_measurement(p, nc, d.R_sb, d.omega_b, d.p_foot, d.J_foot,
                                           d.dq, d.contact)
    H = assembly.a_meas(p, F64, device="cpu")
    got = kf.update(st, A, b, C, H, bm, Cm)
    want = jkf.update(jst, *(jnp.asarray(a.numpy()) for a in (A, b, C, H, bm, Cm)))
    _close(got.x, want.x, **TOL)
    _close(got.C, want.C, **TOL)


# ---------------------------------------------------------- EKF


def _ekf_log():
    """A Go1 log whose EKF stream has delayed-VO rewinds."""
    log = jsynth.generate(jsynth.SynthConfig(T=T_LOG, seed=3))
    assert np.asarray(log.ekf_vo_active).sum() >= 5
    return log


def test_ekf_tick_state_by_state():
    log = _ekf_log()
    jc = jekf.make_consts(JEKFParams(), jnp.float64)
    c = ekf.make_consts(EKFParams(), F64, device="cpu")
    jst = jekf.init_state(JEKFParams(), ring_len=16, dtype=jnp.float64)
    st = ekf.init_state(EKFParams(), ring_len=16, dtype=F64, device="cpu")
    tick = jax.jit(lambda st, *a: jekf.tick(st, *a, jc))
    n_rewinds = 0
    K = len(log.ekf_gyro) - 1
    for k in range(K):
        args = [np.asarray(a)[k] for a in (log.ekf_gyro, log.ekf_accel, log.ekf_vo_active,
                                           log.ekf_vo_q, log.ekf_vo_steps_back)]
        jst = tick(jst, *args)
        st = ekf.tick(st, _t(args[0]), _t(args[1]), bool(args[2]), _t(args[3]),
                      int(args[4]), c)
        n_rewinds += bool(args[2])
        assert st.t == int(jst.t)
        for f in ("q", "P", "gyro_hist", "accel_hist", "q_hist", "P_hist"):
            _close(getattr(st, f), getattr(jst, f), **TIGHT)
    assert n_rewinds >= 1
    # a state carried across from JAX continues identically
    st2 = convert.from_jax_numpy(_np(jst), CPU, F64)
    assert isinstance(st2, ekf.EKFState) and st2.t == st.t
    c2 = convert.from_jax_numpy(_np(jc), CPU, F64)
    assert isinstance(c2, ekf.EKFConsts) and c2.dt == c.dt and c2.quirk_W == c.quirk_W
    _close(ekf.predict(st2.q, st2.P, _t(log.ekf_gyro[K]), c2)[1],
           jekf.predict(jst.q, jst.P, jnp.asarray(log.ekf_gyro[K]), jc)[1], **TIGHT)


def test_ekf_run_sequence_and_orientation_sequence():
    log = _ekf_log()
    jR, jq = jest.ekf_orientation_sequence(JEKFParams(), log)
    R, q = estimator.ekf_orientation_sequence(EKFParams(), log, device="cpu")
    assert R.shape == (T_LOG, 3, 3) and q.shape == (T_LOG, 4)
    _close(q, jq, **TIGHT)
    _close(R, jR, **TIGHT)
    # run_sequence's final state, with the default ring of 64
    jc = jekf.make_consts(JEKFParams(), jnp.float64)
    c = ekf.make_consts(EKFParams(), F64, device="cpu")
    seqs = [np.asarray(a) for a in (log.ekf_gyro, log.ekf_accel, log.ekf_vo_active,
                                    log.ekf_vo_q, log.ekf_vo_steps_back)]
    jfin, _ = jekf.run_sequence(jekf.init_state(JEKFParams(), dtype=jnp.float64), *seqs, jc)
    fin, _ = ekf.run_sequence(ekf.init_state(EKFParams(), dtype=F64, device="cpu"),
                              *(_t(a) for a in seqs), c)
    assert fin.t == int(jfin.t) == len(seqs[0])
    _close(fin.P_hist, jfin.P_hist, **TIGHT)


# ---------------------------------------------------------- MHE


STATE_FIELDS = ("y_meas", "Q_meas", "A_dyn", "b_dyn", "Q_dyn", "b_cam", "Q_cam",
                "cam_active", "M_p", "n_p", "prev_R", "prev_accel_s", "prev_contact",
                "z_adm", "y_adm")


# weight matrices: each entry is held relative to its row's and column's
# diagonal scale sqrt(|W_ii W_jj|) (rtol 1e-8 on that scale, atol 1e-8):
# Q_dyn's position block is 4e10 per tick, and an entry that is zero but
# for rounding in one package is a few 1e-8 in the other
WEIGHTS = ("Q_meas", "Q_dyn", "Q_cam", "M_p")


def _check_state(st, jst):
    assert st.T == int(jst.T)
    for f in STATE_FIELDS:
        a, b = np.asarray(getattr(st, f)), np.asarray(getattr(jst, f))
        if f in WEIGHTS:
            d = np.abs(np.diagonal(b, axis1=-2, axis2=-1))
            scale = np.sqrt(d[..., :, None] * d[..., None, :])
            assert (np.abs(a - b) <= TOL["atol"] + TOL["rtol"] * np.maximum(scale, np.abs(b))).all(), f
        else:
            _close(a, b, **TOL)
    assert int(st.bez.count) == int(jst.bez.count)
    _close(st.bez.pts, jst.bez.pts, **TOL)
    _close(st.bez.times, jst.bez.times, **TOL)


@pytest.mark.parametrize("model", ["go1", "cassie"])
def test_mhe_init_and_step_state_by_state(model):
    """mhe.init/step tick by tick against the reference, starting from the
    reference's own state after every tick (``convert``), over a log with VO
    events, marginalization (T > N) and, for Go1, a batch axis."""
    jp, p = _params(JParams, model), _params(EstimatorParams, model)
    jd, _, jv, _ = _data(_log(model, T=40))
    if model == "go1":       # a 2-instance fleet, time-leading
        jd = jax.tree.map(lambda a: jnp.stack([a, a * (1 + 1e-3)], axis=1), jd)
    jc = jmhe.make_consts(jp, jnp.float64)
    c = convert.from_jax_numpy(_np(jc), CPU, F64)
    R_pre = jd.R_sb[jv.tick_pre]
    d0 = jax.tree.map(lambda a: a[0], jd)
    jst = jmhe.init(jc, *_args(d0), dtype=jnp.float64)
    st = mhe.init(c, *(_t(a) for a in _args(d0)), dtype=F64, device="cpu")
    _check_state(st, jst)
    _close(mhe.solve_window(c, st), jax.jit(lambda s: jmhe.solve_window(jc, s))(jst), **TOL)
    step = jax.jit(lambda *a: jmhe.step(jc, *a))
    n_vo, n_cam = 0, 0
    for t in range(1, 40):
        d = jax.tree.map(lambda a: a[t], jd)
        vo = [np.asarray(a)[t] for a in jv]
        args = _args(d)
        jst_next, (jx, jw) = step(jst, *args, *vo, R_pre[t])
        st_in = convert.from_jax_numpy(_np(jst), CPU, F64)
        st, (x, w) = mhe.step(c, st_in, *(_t(a) for a in args), bool(vo[0]), _t(vo[1]),
                              int(vo[2]), int(vo[3]), _t(R_pre[t]))
        _check_state(st, jst_next)
        _close(x, jx, **TOL)
        _close(w, jw, **TOL)
        jst = jst_next
        n_vo += bool(vo[0])
        n_cam += int(st.cam_active.sum())
    assert n_vo >= 4 and n_cam > 0


@pytest.mark.parametrize("model,with_vo", [("go1", True), ("go1", False), ("cassie", True)])
def test_run_mhe_matches(model, with_vo):
    jp, p = _params(JParams, model), _params(EstimatorParams, model)
    jd, td, jv, tv = _data(_log(model))
    jx, jvb = jax.jit(lambda d, v: jest.run_mhe(jp, d, vo=v))(jd, jv if with_vo else None)
    x, vb = estimator.run_mhe(p, td, vo=tv if with_vo else None, device="cpu")
    assert x.shape == (T_LOG, p.dim_state) and vb.shape == (T_LOG, 3)
    _close(x, jx, **TOL)
    _close(vb, jvb, **TOL)


def _box(p, adaptive):
    p.osqp.abs_tol = p.osqp.relative_tol = 1e-8
    if not adaptive:
        p.osqp.rho, p.osqp.adapt_rho, p.osqp.polish = 5000.0, False, True
    ub = np.full(p.dim_state, np.inf)
    ub[3:6] = 0.1
    return -ub, ub


@pytest.mark.parametrize("adaptive", [False, True])
def test_constrained_run_mhe_matches(adaptive):
    """|v| <= 0.1 on the Go1 log (it binds), fixed rho with polish or the
    default adaptive rho. x within TOL; with adaptive rho the unconverged
    iterates z, y within 1e-6 of their largest magnitude (fault F4, the
    summation order moves them)."""
    jp, p = _params(JParams, "go1"), _params(EstimatorParams, "go1")
    lb, ub = _box(jp, adaptive)
    _box(p, adaptive)
    iters = 40 if adaptive else 20
    jc = jmhe.make_consts(jp, jnp.float64, x_lb=lb, x_ub=ub, admm_iters=iters)
    c = mhe.make_consts(p, F64, x_lb=lb, x_ub=ub, admm_iters=iters, device="cpu")
    assert c.admm == convert.from_jax_numpy(_np(jc), CPU, F64).admm
    jd, td, jv, tv = _data(_log("go1", T=24))
    jx, _ = jax.jit(lambda d, v: jest.run_mhe(jp, d, vo=v, consts=jc))(jd, jv)
    x, _ = estimator.run_mhe(p, td, vo=tv, consts=c, device="cpu")
    _close(x, jx, **TOL)
    assert 0.1 - 1e-2 <= float(x[:, 3:6].abs().max()) <= 0.1 + 1e-3
    # the ADMM iterates of one window solve, warm-started, on a full window
    st = mhe.init(c, *_args(estimator.TickData(*(a[0] for a in td))), dtype=F64, device="cpu")
    for t in range(1, 12):
        st, _ = mhe.step(c, st, *_args(estimator.TickData(*(a[t] for a in td))),
                         bool(tv.active[t]), tv.dp_body[t], int(tv.tick_pre[t]),
                         int(tv.tick_now[t]), td.R_sb[int(tv.tick_pre[t])])
    got = mhe.solve_window_with_duals(c, st)
    want = jax.jit(lambda s: jmhe.solve_window_with_duals(jc, s))(_to_jax_state(st))
    _close(got[0], want[0], **TOL)
    for g, w in zip(got[1:], want[1:]):
        scale = 1e-6 * float(np.abs(np.asarray(w)).max()) if adaptive else 0.0
        _close(g, w, rtol=TOL["rtol"], atol=TOL["atol"] + scale)


def _to_jax_state(st):
    """A port MHEState -> the reference's, leaf by leaf."""
    j = lambda a: jnp.asarray(a.numpy())
    fields = {f: j(getattr(st, f)) for f in jmhe.MHEState._fields if f not in ("T", "bez")}
    return jmhe.MHEState(T=jnp.asarray(st.T, jnp.int32),
                         bez=jbez.BezierCarry(*(j(a) for a in st.bez[:2]),
                                              jnp.asarray(st.bez.count, jnp.int32),
                                              j(st.bez.p_accum)), **fields)


# ---------------------------------------------------------- device rule


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    p, pe = _params(EstimatorParams, "go1"), EKFParams()
    from decentralized_ekf_mhe_tpu_torch.parallel import batch

    log = _log("go1", T=4)
    _, td, _, _ = _data(log)
    calls = [
        lambda: estimator.run_kf(p, td),
        lambda: estimator.run_mhe(p, td),
        lambda: estimator.ekf_orientation_sequence(pe, log),
        lambda: batch.make_fused_batched_runner(p),
        lambda: batch.make_batched_runner(p),
        lambda: batch.mhe_window_solve_batch(p),
        lambda: mhe.init(mhe.make_consts(p, device="cpu"), *(a[0] for a in td)),
        lambda: ekf.make_consts(pe),
        lambda: ekf.init_state(pe),
        lambda: tridiag_kernel.solve_batched(*(_t(a) for a in _system(4, 2, 3, 0)[:3])),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
