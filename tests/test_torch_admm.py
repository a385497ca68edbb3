"""PyTorch port vs the JAX package: the OSQP-semantics box-ADMM.

``ops.admm.solve_box_tridiag_lanes`` (the plain version of the ``admm_solve``
CUDA kernel and of the box-ADMM inside the constrained ``mhe_tick`` kernel) is
held against the JAX solver and against the Pallas ADMM kernel in interpret
mode at float64: iterates x, z, y to rtol 1e-8/atol 1e-8 and equal iteration
counts, over fixed and adaptive rho, shared and per-lane bounds, the warm-up
mask, warm starts, and budgets that end inside an epoch. The dense
``solve_box_qp`` is held against its JAX twin. Inputs come from a numpy seed.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu.config import OSQPParams as JOSQPParams
from decentralized_ekf_mhe_tpu.ops import admm as jadmm
from decentralized_ekf_mhe_tpu.pallas import admm_kernel as jak
from decentralized_ekf_mhe_tpu_torch.config import OSQPParams
from decentralized_ekf_mhe_tpu_torch.kernels import _build, _work, admm_kernel
from decentralized_ekf_mhe_tpu_torch.ops import admm

torch.set_num_threads(1)

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-8)

BUDGETS = {
    # iterations, tolerance: a budget that ends inside an epoch (E=10), one
    # shorter than an epoch, and the check switched off
    "25of10": dict(iters=25, abs_tol=1e-8, rel_tol=1e-8),
    "7of10": dict(iters=7, abs_tol=1e-8, rel_tol=1e-8),
    "notol30": dict(iters=30, abs_tol=0.0, rel_tol=0.0),
}


def _system(seed, K=6, s=5, B=4):
    """A random SPD block-tridiagonal system in lanes layout (numpy)."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((K, B, s, s))
    D = D @ np.swapaxes(D, -1, -2) + 5 * np.eye(s)
    U = 0.1 * rng.standard_normal((K - 1, B, s, s))
    r = rng.standard_normal((K, B, s))
    z0 = 0.1 * rng.standard_normal((K, B, s))
    y0 = 0.1 * rng.standard_normal((K, B, s))
    mv = lambda a: np.ascontiguousarray(np.moveaxis(a, 1, -1))
    return tuple(mv(a) for a in (D, U, r, z0, y0))


def _bounds(per_lane, s, B):
    if per_lane:
        bnd = np.linspace(0.1, 0.4, B)
        lb = np.broadcast_to(-bnd, (s, B)).copy()
        ub = np.broadcast_to(bnd, (s, B)).copy()
        lb[0, :] = -np.inf
        ub[-1, :] = np.inf
        return lb, ub
    lb = np.full(s, -0.25)
    ub = np.full(s, 0.25)
    lb[0] = -np.inf
    ub[-1] = np.inf
    return lb, ub


def _settings(cls, adaptive, budget):
    return cls(rho=0.5, sigma=1e-6, alpha=1.6, adaptive_rho=adaptive,
               **BUDGETS[budget])


def _assert_result(tres, jres, iters=True):
    for f in ("x", "z", "y"):
        np.testing.assert_allclose(getattr(tres, f).numpy(),
                                   np.asarray(getattr(jres, f)), err_msg=f, **TOL)
    if iters:
        assert np.array_equal(tres.iters.numpy(), np.asarray(jres.iters))


CASES = list(itertools.product([False, True], [False, True], [False, True],
                               [False, True], sorted(BUDGETS)))


@pytest.mark.parametrize("adaptive,per_lane,masked,warm,budget", CASES)
def test_lanes_solver_matches_jax(adaptive, per_lane, masked, warm, budget):
    """Plain version (through the kernel wrapper's CPU path) == the JAX lanes
    solver: same iterate sequence, same per-instance iteration counts, same
    final residuals."""
    D, U, r, z0, y0 = _system(21)
    K, s, B = D.shape[0], D.shape[1], D.shape[-1]
    lb, ub = _bounds(per_lane, s, B)
    valid = np.array([False, False] + [True] * (K - 2)) if masked else None
    J = jnp.asarray
    T = torch.as_tensor
    jkw = dict(valid=None if valid is None else J(valid))
    tkw = dict(valid=None if valid is None else T(valid))
    if warm:
        jkw.update(z0=J(z0), y0=J(y0))
        tkw.update(z0=T(z0), y0=T(y0))
    jres = jadmm.solve_box_tridiag_lanes(
        J(D), J(U), J(r), J(lb), J(ub), _settings(jadmm.ADMMSettings, adaptive, budget), **jkw)
    before = admm_kernel.launches
    tres = admm_kernel.solve_box_lanes(
        T(D), T(U), T(r), lb, ub, _settings(admm.ADMMSettings, adaptive, budget),
        device="cpu", **tkw)
    assert admm_kernel.launches == before        # CPU: the plain version, no launch
    _assert_result(tres, jres)
    np.testing.assert_allclose(tres.prim.numpy(), np.asarray(jres.prim), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tres.dual.numpy(), np.asarray(jres.dual), rtol=1e-6, atol=1e-9)
    assert tres.pinf is None and tres.dinf is None
    if budget != "notol30":
        n = BUDGETS[budget]["iters"]
        assert tres.iters.max() <= n and (budget != "7of10" or bool((tres.iters == n).all()))


@pytest.mark.parametrize("adaptive,per_lane,masked,warm", [
    (True, False, False, True), (False, False, False, True),
    (True, True, False, False), (True, False, True, False),
    (False, True, True, True),
])
def test_lanes_solver_matches_pallas_interpret(adaptive, per_lane, masked, warm):
    """Plain version == the Pallas ADMM kernel in interpret mode (whose
    polish takes the raw diagonal where the plain version takes its absolute
    value: they agree while the diagonal is positive), and the box binds."""
    D, U, r, z0, y0 = _system(22)
    K, s, B = D.shape[0], D.shape[1], D.shape[-1]
    lb, ub = _bounds(per_lane, s, B)
    valid = np.array([False] + [True] * (K - 1)) if masked else None
    J = jnp.asarray
    T = torch.as_tensor
    jkw = dict(valid=None if valid is None else J(valid))
    tkw = dict(valid=None if valid is None else T(valid))
    if warm:
        jkw.update(z0=J(z0), y0=J(y0))
        tkw.update(z0=T(z0), y0=T(y0))
    budget = dict(iters=25, abs_tol=1e-8, rel_tol=1e-8)
    jres = jak.solve_box_lanes(
        J(D), J(U), J(r), lb, ub,
        jadmm.ADMMSettings(rho=0.5, sigma=1e-6, alpha=1.6, adaptive_rho=adaptive, **budget),
        interpret=True, **jkw)
    tres = admm.solve_box_tridiag_lanes(
        T(D), T(U), T(r), lb, ub,
        admm.ADMMSettings(rho=0.5, sigma=1e-6, alpha=1.6, adaptive_rho=adaptive, **budget),
        **tkw)
    _assert_result(tres, jres)
    x = tres.x.numpy()[:, 1:-1, :]
    hi = (ub[1:-1, None] if ub.ndim == 1 else ub[1:-1])[None]
    assert (np.abs(x) <= hi + 1e-6).all() and (np.abs(x) >= hi - 1e-9).any()


def test_per_lane_bounds_equal_separate_shared_solves():
    """Lane b of a per-lane-bounds solve equals a shared-bounds solve with
    that lane's box."""
    D, U, r, _, _ = _system(23)
    s, B = D.shape[1], D.shape[-1]
    lb, ub = _bounds(True, s, B)
    st = admm.ADMMSettings(rho=0.5, sigma=1e-6, alpha=1.6, iters=60,
                           abs_tol=1e-9, rel_tol=1e-9)
    T = torch.as_tensor
    fleet = admm.solve_box_tridiag_lanes(T(D), T(U), T(r), lb, ub, st)
    for b in range(B):
        one = admm.solve_box_tridiag_lanes(
            T(D[..., b:b + 1]), T(U[..., b:b + 1]), T(r[..., b:b + 1]),
            lb[:, b], ub[:, b], st)
        np.testing.assert_allclose(fleet.x[..., b].numpy(), one.x[..., 0].numpy(),
                                   rtol=1e-12, atol=1e-12)
        assert int(fleet.iters[b]) == int(one.iters[0])


def _rand_spd(rng, n):
    M = rng.standard_normal((n, n))
    return M @ M.T + n * np.eye(n)


@pytest.mark.parametrize("case", ["identity", "general", "batched_adaptive"])
def test_solve_box_qp_matches_jax(case):
    """The dense solver on the problems of the reference's QP tests."""
    if case == "identity":
        rng = np.random.default_rng(0)
        n = 12
        P, q, A = _rand_spd(rng, n), rng.standard_normal(n) * 5, np.eye(n)
        l, u = np.full(n, -0.3), np.full(n, 0.4)
        kw = dict(rho=1.0, sigma=1e-6, alpha=1.6, iters=400)
    elif case == "general":
        rng = np.random.default_rng(1)
        n, m = 8, 5
        P, q = _rand_spd(rng, n), rng.standard_normal(n) * 3
        A = rng.standard_normal((m, n))
        l, u = np.full(m, -0.5), np.full(m, 0.5)
        kw = dict(rho=1.0, sigma=1e-6, alpha=1.6, iters=600)
    else:
        rng = np.random.default_rng(4)
        n, Bq = 6, 3
        P = np.stack([_rand_spd(rng, n) for _ in range(Bq)])
        q = rng.standard_normal((Bq, n)) * 4
        A = np.eye(n)
        l, u = np.full(n, -0.3), np.full(n, 0.5)
        kw = dict(rho=0.3, sigma=1e-6, alpha=1.6, iters=120, abs_tol=1e-7, rel_tol=1e-7)
    J, T = jnp.asarray, torch.as_tensor
    jres = jadmm.solve_box_qp(J(P), J(q), J(A), J(l), J(u), jadmm.ADMMSettings(**kw))
    tres = admm.solve_box_qp(T(P), T(q), T(A), T(l), T(u), admm.ADMMSettings(**kw))
    _assert_result(tres, jres)
    np.testing.assert_allclose(tres.prim.numpy(), np.asarray(jres.prim), rtol=1e-5, atol=1e-9)
    assert np.array_equal(tres.pinf.numpy(), np.asarray(jres.pinf))
    assert np.array_equal(tres.dinf.numpy(), np.asarray(jres.dinf))
    Ax = tres.x.numpy() @ A.T
    assert (Ax <= u + 1e-5).all() and (Ax >= l - 1e-5).all()
    if case == "batched_adaptive":
        assert int(tres.iters.max()) < 120       # the freeze ended it early


@pytest.mark.parametrize("case", ["primal", "dual", "feasible"])
def test_solve_box_qp_infeasibility_certificates(case):
    T = torch.as_tensor
    kw = dict(sigma=1e-6, alpha=1.6, iters=300, polish=False)
    if case == "primal":      # x = 0 and x = 2 at once
        res = admm.solve_box_qp(
            T(np.eye(1) * 1e-6), T(np.zeros(1)), T(np.array([[1.0], [1.0]])),
            T(np.array([0.0, 2.0])), T(np.array([0.0, 2.0])),
            admm.ADMMSettings(rho=1.0, adaptive_rho=False, **kw))
        assert bool(res.pinf) and not bool(res.dinf)
    elif case == "dual":      # unbounded below
        res = admm.solve_box_qp(
            T(np.zeros((2, 2))), T(np.array([1.0, -2.0])), T(np.eye(2)),
            T(np.full(2, -np.inf)), T(np.full(2, np.inf)),
            admm.ADMMSettings(rho=0.1, adaptive_rho=False, **kw))
        assert bool(res.dinf)
    else:
        rng = np.random.default_rng(7)
        res = admm.solve_box_qp(
            T(_rand_spd(rng, 4)), T(rng.standard_normal(4)), T(np.eye(4)),
            T(np.full(4, -1.0)), T(np.full(4, 1.0)), admm.ADMMSettings(rho=1.0, **kw))
        assert not bool(res.pinf) and not bool(res.dinf)


@pytest.mark.parametrize("kw", [
    {}, dict(iters=37), dict(per_iter_s=10e-6), dict(per_iter_s=1e-3),
])
def test_settings_from_osqp_match_jax(kw):
    vals = dict(rho=0.3, alpha=1.5, sigma=2e-5, adapt_rho=False, polish=True,
                max_iter=4000, prim_tol=1e-7, dual_tol=1e-8, relative_tol=1e-6,
                abs_tol=1e-6, time_limit=0.0028)
    js = jadmm.ADMMSettings.from_osqp(JOSQPParams(**vals), **kw)
    ts = admm.ADMMSettings.from_osqp(OSQPParams(**vals), **kw)
    assert ts._fields == js._fields and tuple(ts) == tuple(js)
    assert tuple(admm.ADMMSettings()) == tuple(jadmm.ADMMSettings())
    core = admm_kernel.ADMMCoreStatic.from_settings(ts, N=20, s=9)
    jcore = jak.ADMMCoreStatic.from_settings(js, N=20, s=9)
    assert core._fields == jcore._fields and tuple(core) == tuple(jcore)
    ints, reals = core.pack()
    assert ints.tolist() == [ts.iters, 10, 0, 1, 1]
    assert reals.tolist() == [0.3, 2e-5, 1.5, 1 - 1.5, 1e-6, 1e-6, 1e6]


def test_active_targets_and_rho_update_match_jax():
    rng = np.random.default_rng(3)
    z = np.clip(rng.standard_normal((5, 4, 3)), -0.5, 0.5)
    lb = np.array([-0.5, -np.inf, -0.5, -0.5])[None, :, None] * np.ones_like(z)
    ub = np.array([0.5, 0.5, np.inf, 0.5])[None, :, None] * np.ones_like(z)
    ja, jt = jadmm._active_targets(jnp.asarray(z), jnp.asarray(lb), jnp.asarray(ub))
    ta, tt = admm._active_targets(torch.as_tensor(z), torch.as_tensor(lb), torch.as_tensor(ub))
    assert np.array_equal(ta.numpy(), np.asarray(ja)) and ta.sum() > 0
    assert np.array_equal(tt.numpy(), np.asarray(jt)) and np.isfinite(tt.numpy()).all()
    args = [np.abs(rng.standard_normal(6)) * sc for sc in (1.0, 1e-3, 1e-2, 5.0, 0.0)]
    args[3][0] = 0.0
    jr = jadmm._rho_update(*(jnp.asarray(a) for a in args))
    tr = admm._rho_update(*(torch.as_tensor(a) for a in args))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-14)


def test_wrapper_rejects_bad_operands():
    D, U, r, z0, _ = (torch.as_tensor(a) for a in _system(5))
    s, B = D.shape[1], D.shape[-1]
    lb, ub = _bounds(False, s, B)
    st = admm.ADMMSettings(iters=5)
    ok = admm_kernel.solve_box_lanes(D, U, r, lb, ub, st, device="cpu")
    assert ok.x.shape == r.shape and ok.iters.dtype == torch.int32
    with pytest.raises(ValueError):
        admm_kernel.solve_box_lanes(D, U[:2], r, lb, ub, st, device="cpu")
    with pytest.raises(ValueError):
        admm_kernel.solve_box_lanes(D, U, r.float(), lb, ub, st, device="cpu")
    with pytest.raises(ValueError):
        admm_kernel.solve_box_lanes(D.transpose(1, 2), U, r, lb, ub, st, device="cpu")
    with pytest.raises(ValueError):
        admm_kernel.solve_box_lanes(D, U, r, lb, ub, st, z0=z0[:-1], device="cpu")
    with pytest.raises(ValueError):     # per-lane bounds for another fleet size
        admm_kernel.solve_box_lanes(D, U, r, np.zeros((s, B + 1)), ub, st, device="cpu")
    with pytest.raises(ValueError):     # bounds on another device than the system
        admm_kernel.solve_box_lanes(D, U, r, torch.zeros(s, device="meta"), ub, st,
                                    device="cpu")
    with pytest.raises(ValueError):
        admm_kernel.solve_box_lanes(D, U, r, lb, ub, st,
                                    valid=torch.ones(D.shape[0] + 1, dtype=torch.bool),
                                    device="cpu")
    with pytest.raises(ValueError):
        admm.solve_box_tridiag_lanes(D, U, r, np.zeros((s, B - 1)), ub, st)


def test_admm_work_counts():
    """The bound's operation count follows the iterations that were run."""
    full = np.full(16, 20)
    b1, f1 = _work.admm(20, 9, 16, 4, full, 10, False, True, True)
    assert b1 == 4 * 16 * (20 * 81 + 19 * 81 + 6 * 180 + 18) + 4 * 16
    half = np.full(16, 10)
    _, f2 = _work.admm(20, 9, 16, 4, half, 10, False, True, True)
    _, f3 = _work.admm(20, 9, 16, 4, full, 10, True, True, True)
    _, f4 = _work.admm(20, 9, 16, 4, full, 10, False, True, False)
    _, f5 = _work.admm(20, 9, 16, 4, full, 10, False, False, True)
    assert f2 < f1 < f3 and f4 < f1 and f5 < f1
    factor = 20 * (9 + 9 * 10 * 17) + 19 * (2 * 81 * 17 + 81)
    assert f3 - f1 == 16 * factor                 # one more factorization per lane
    # a warm-up window with one real slot, and ragged per-lane counts
    _, g1 = _work.admm(20, 9, 16, 4, full, 10, False, True, True, n_states=1)
    assert 0 < g1 < f1 / 15
    mixed = np.array([10] * 8 + [20] * 8)
    assert _work.admm_ops(9, 20, mixed, 10, False, True, True) == (f1 + f2) // 2
    assert _work.admm_ops(9, 20, np.zeros(4, int), 10, True, True, False) == 0


def test_build_names_the_admm_sources():
    assert "admm" in _build.SOURCES and _build._ARGTYPES["admm"][0] == "dem_admm_solve"
    # the constrained tick is a unit of each shape's mhe library behind its one
    # entry point, which takes (is_double, con, pi, chol, ablate, ...) and the
    # ADMM settings
    go1 = ("-DDEM_MHE_SHAPE=go1", "-DDEM_MHE_S=9", "-DDEM_MHE_M=12", "-DDEM_MHE_L=4",
           "-DDEM_MHE_LOT=0")
    assert ("mhe", go1 + ("-DDEM_MHE_UNIT=dem_mhe_unit_go1_box_f64", "-DDEM_MHE_REAL=double",
                          "-DDEM_MHE_CON=1", "-DDEM_MHE_PI=0")) in _build.UNITS["mhe_go1"]
    assert _build._ARGTYPES["mhe"][0] == "dem_mhe_tick"
    assert len(_build._ARGTYPES["mhe"][1]) == 20
    t = _build.KernelTimer()
    t.record(None)                       # off: records nothing, needs no device
    assert t.ms() == []
