"""PyTorch port vs the JAX package: the Cassie and PogoX shapes.

Cassie carries its foot positions as states (``leg_odom_type=1``, 2 legs:
s=15, m=6); PogoX has one leg with foot-velocity measurements (s=9, m=3).
Their parameters come from ``configs/parameters_{cassie,pogox}.yaml``. At
float64 on the CPU: the lot-1 assembly builders, the plain versions of the
MHE tick kernel (unconstrained and box-constrained) against the Pallas
mega-kernel in interpret mode, the plain block-tridiagonal and box-ADMM
solves at s=15 against their Pallas kernels in interpret mode, both fleet
runners against the JAX runners, the converters at both shapes, the robot
models, and the operation counts of the kernels' bounds. Inputs are
perturbed once on the JAX side and handed to both packages.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu import config as jconfig
from decentralized_ekf_mhe_tpu import models as jmodels
from decentralized_ekf_mhe_tpu.io import synth as jsynth
from decentralized_ekf_mhe_tpu.ops import assembly_lanes as jasm
from decentralized_ekf_mhe_tpu.ops import ekf_lanes as jekf
from decentralized_ekf_mhe_tpu.ops import estimator as jest
from decentralized_ekf_mhe_tpu.ops import mhe as jmhe
from decentralized_ekf_mhe_tpu.ops import mhe_lanes as jml
from decentralized_ekf_mhe_tpu.pallas import admm_kernel as jak
from decentralized_ekf_mhe_tpu.pallas import mhe_replay_kernel as jmrk
from decentralized_ekf_mhe_tpu.pallas import tridiag_kernel as jtk
from decentralized_ekf_mhe_tpu.parallel import batch as jbatch
from decentralized_ekf_mhe_tpu_torch import config, convert, models
from decentralized_ekf_mhe_tpu_torch.kernels import _build, _work
from decentralized_ekf_mhe_tpu_torch.kernels import admm_kernel, tridiag_kernel
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import assembly_lanes, estimator, mhe, mhe_lanes
from decentralized_ekf_mhe_tpu_torch.parallel import batch

torch.set_num_threads(1)

DT = jnp.float64
F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"cassie": (15, 6, 2, 1), "pogox": (9, 3, 1, 0)}   # s, m, L, leg_odom_type
MODELS = ("cassie", "pogox")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _conv(*trees):
    return [convert.from_jax_numpy(_np(t), "cpu", F64) for t in trees]


def _params(model, N, box=False):
    """(JAX params, port params, JAX EKF params, port EKF params) from the
    robot's parameter file, window N; ``box``: fixed rho=5000 with polish and
    OSQP tolerances 1e-8."""
    path = os.path.join(REPO, "configs", f"parameters_{model}.yaml")
    (jp, jpe), (tp, tpe) = jconfig.load_yaml_params(path), config.load_yaml_params(path)
    for p in (jp, tp):
        p.N = N
        if box:
            p.osqp.rho, p.osqp.adapt_rho, p.osqp.polish = 5000.0, False, True
            p.osqp.abs_tol = p.osqp.relative_tol = 1e-8
    return jp, tp, jpe, tpe


def _bounds(s, v=0.05):
    ub = np.full(s, np.inf)
    ub[3:6] = v
    return -ub, ub


@functools.lru_cache(maxsize=None)
def _fleet(model, T, B, seed=2):
    """The robot's synthetic log as a JAX-perturbed fleet (time-leading
    TickData, EKF blocks with per-lane VO quaternions, per-lane VO
    translation); a VO frame every 3 ticks, so that a short log reaches the
    Bezier increments."""
    jp = _params(model, 5)[0]
    log = jsynth.generate(jsynth.SynthConfig(T=T, seed=seed, num_legs=jp.num_legs,
                                             vo_every=3, vo_latency=1))
    data_b = jbatch.to_time_leading(jbatch.perturb_log_batch(
        jest.tickdata_from_log(log, dtype=DT), B, jax.random.PRNGKey(0), jp, dtype=DT))
    eb = jbatch.perturb_ekf_blocks(jest.ekfblocks_from_log(log, dtype=DT), B,
                                   jax.random.PRNGKey(1), jp, dtype=DT, vo_noise_scale=1.0)
    vo = jbatch.perturb_vo_batch(jest.vodata_from_log(log, dtype=DT), B,
                                 jax.random.PRNGKey(2), jp, dtype=DT)
    return data_b, eb, vo


def _consts(model, N, box):
    jp, tp, _, _ = _params(model, N, box)
    if not box:
        return jmhe.make_consts(jp, DT), mhe.make_consts(tp, F64, device="cpu")
    lb, ub = _bounds(tp.dim_state)
    return (jmhe.make_consts(jp, DT, x_lb=lb, x_ub=ub, admm_iters=20),
            mhe.make_consts(tp, F64, x_lb=lb, x_ub=ub, admm_iters=20, use_pallas=True,
                            device="cpu"))


@functools.lru_cache(maxsize=None)
def _window(model, box, T=14):
    """The port's window state at N=5 after T-1 ticks of its plain tick (VO
    ingested, the arrival cost marginalized) and its tick-0 state, with the
    port's consts."""
    tc = _consts(model, 5, box)[1]
    data_b, _, vo = _fleet(model, T, 3)
    tdata_l, tvo = _conv(jbatch.tickdata_to_lanes(data_b), vo)
    d0 = estimator.TickData(*(a[0] for a in tdata_l))
    st0 = mhe_lanes.init(tc, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot, d0.J_foot, d0.dq,
                         d0.contact, dtype=F64, device="cpu")
    vo_inc = estimator.vo_world_increments(tdata_l.R_sb, tvo)
    rest = estimator.TickData(*(a[1:] for a in tdata_l))
    _, ks = mrk.replay_ticks(tc, mrk.kernel_state_from_mhe(st0, tc), rest,
                             estimator.VOData(*(a[1:] for a in tvo)), vo_inc[1:], device="cpu")
    return tc, st0, mrk.mhe_state_from_kernel(ks, tc)


# ---- assembly ----------------------------------------------------------------


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("fn", ["build_dynamics", "build_measurement", "prior_state"])
def test_assembly_lanes_matches_jax(model, fn):
    """The assembly builders at the robot's shape, the foot-position (lot-1)
    branches included: foot blocks of A and Q gated by contact, position rows
    of the measurement, foot states seeded from the first measurement."""
    rng = np.random.default_rng(5)
    Bs = 6
    jp, tp, _, _ = _params(model, 6)
    L = tp.num_legs
    R = np.asarray(jekf.to_rot(jnp.asarray(rng.standard_normal((4, Bs)))))
    accel = rng.standard_normal((3, Bs)) + np.array([0, 0, 9.8])[:, None]
    omega = 0.3 * rng.standard_normal((3, Bs))
    p_foot = 0.3 * rng.standard_normal((L, 3, Bs))
    J = rng.standard_normal((L, 3, 3, Bs)) + 2 * np.eye(3)[None, :, :, None]
    dq = rng.standard_normal((L, 3, Bs))
    contact = (rng.random((L, Bs)) > 0.4).astype(np.float64)
    if fn == "build_dynamics":
        args = (R, accel, contact)
    elif fn == "build_measurement":
        args = (R, omega, p_foot, J, dq, contact)
    else:
        args = (rng.standard_normal((tp.dim_meas, Bs)),)
    jc = jmhe.make_consts(jp, DT)
    tc = mhe.make_consts(tp, F64, device="cpu")
    jout = getattr(jasm, fn)(jp, jc.nc, *[jnp.asarray(a) for a in args])
    tout = getattr(assembly_lanes, fn)(tp, tc.nc, *[torch.as_tensor(a) for a in args])
    assert len(jout) == len(tout)
    for a, b in zip(tout, jout):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-11,
                                   atol=1e-11 * max(1.0, float(np.abs(b).max())))


# ---- the MHE tick kernel's plain version against the Pallas kernel -----------


@pytest.mark.parametrize("box", [False, True])
@pytest.mark.parametrize("model", MODELS)
def test_mhe_kernel_plain_matches_pallas_interpret(model, box):
    """``mhe_replay_kernel.replay`` on the CPU (the plain version of the tick
    kernel at this shape; with box consts the constrained variant) and the
    eager ``run_mhe_lanes`` against the JAX Pallas mega-kernel in interpret
    mode: N=5, T=20, B=3, VO with Bezier increments, marginalization."""
    N, T, Bs = 5, 20, 3
    jc, tc = _consts(model, N, box)
    data_b, _, vo = _fleet(model, T, Bs)
    data_l = jbatch.tickdata_to_lanes(data_b)
    jx = jmrk.replay(jc, data_l, vo, dtype=DT, interpret=True)
    tdata_l, tvo = _conv(data_l, vo)
    tx = mrk.replay(tc, tdata_l, tvo, dtype=F64, device="cpu")
    s = SHAPES[model][0]
    assert tx.shape == (T, s, Bs)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    tp = _params(model, N, box)[1]
    ex, _ = estimator.run_mhe_lanes(tp, tdata_l, vo=tvo, dtype=F64, consts=tc, device="cpu")
    np.testing.assert_allclose(ex.numpy(), np.moveaxis(np.asarray(jx), -1, 1), **TOL)
    if box:
        assert float(tx[:, 3:6].abs().max()) <= 0.05 + 1e-6


# ---- the window solves at the robot's state size ------------------------------


def _system(tc, st):
    """The masked window system (D, U, r) of a port state."""
    return tuple(a.contiguous() for a in mhe_lanes._masked_system(tc, st))


def _lanes_cat(*ts):
    return torch.cat(ts, dim=-1).contiguous()


def test_tridiag_plain_matches_pallas_interpret_s15():
    """K5's plain version at s=15 against the Pallas kernel in interpret mode
    on Cassie's masked window systems at tick 0 and after 13 ticks, side by
    side on the instance axis."""
    tc, st0, st = _window("cassie", False)
    (D0, U0, r0), (D1, U1, r1) = _system(tc, st0), _system(tc, st)
    tD, tU, tr = _lanes_cat(D0, D1), _lanes_cat(U0, U1), _lanes_cat(r0, r1)
    assert tD.shape[1] == 15 and tD.shape[-1] == 6
    jx = jtk.solve_lanes(*(jnp.asarray(a.numpy()) for a in (tD, tU, tr)), interpret=True)
    tx = tridiag_kernel.solve_lanes(tD, tU, tr, device="cpu")
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


def test_admm_plain_matches_pallas_interpret_s15():
    """K4's plain version at s=15 against the Pallas kernel in interpret mode
    on Cassie's assembled window: fixed rho with polish, ±inf bounds on every
    state but the velocity; three instances cold, three warm-started from the
    window's iterates. The ±inf bounds of the foot states pass the clip
    unchanged: their dual iterate stays 0."""
    tc, _, st = _window("cassie", True)
    jc = _consts("cassie", 5, True)[0]
    D, U, r = _system(tc, st)
    tD, tU, tr = _lanes_cat(D, D), _lanes_cat(U, U), _lanes_cat(r, r)
    z0 = _lanes_cat(torch.zeros_like(st.z_adm), st.z_adm)
    y0 = _lanes_cat(torch.zeros_like(st.y_adm), st.y_adm)
    jres = jak.solve_box_lanes(*(jnp.asarray(a.numpy()) for a in (tD, tU, tr)), jc.x_lb,
                               jc.x_ub, jc.admm, z0=jnp.asarray(z0.numpy()),
                               y0=jnp.asarray(y0.numpy()), interpret=True)
    tres = admm_kernel.solve_box_lanes(tD, tU, tr, tc.x_lb, tc.x_ub, tc.admm, z0=z0, y0=y0,
                                       device="cpu")
    assert np.array_equal(tres.iters.numpy(), np.asarray(jres.iters))
    for f in ("x", "z", "y"):
        b = np.asarray(getattr(jres, f))
        np.testing.assert_allclose(getattr(tres, f).numpy(), b, rtol=1e-8,
                                   atol=1e-8 * max(1.0, float(np.abs(b).max())), err_msg=f)
    assert float((tres.x[:, :, 3:] - tres.x[:, :, :3]).abs().max()) > 0   # warm != cold
    assert np.isinf(tc.x_ub[9:].numpy()).all() and np.isinf(tc.x_lb[9:].numpy()).all()
    assert float(tres.y[:, 9:].abs().max()) == 0.0
    assert bool(torch.isfinite(tres.x).all())


# ---- both fleet runners --------------------------------------------------------


@pytest.mark.parametrize("model", MODELS)
def test_fleet_runners_match_jax(model):
    """The pipeline runner (EKF kernel's plain version -> rotation -> MHE
    tick's plain version, ``use_megakernel=True`` on the CPU) and the lanes
    runner (eager and through the tick kernel's plain version) against the
    JAX runners at N=5, T=40, B=2."""
    T, Bs = 40, 2
    data_b, eb, vo = _fleet(model, T, Bs)
    tdata, teb, tvo = _conv(data_b, eb, vo)
    jp, tp, jpe, tpe = _params(model, 5)
    jx, jv, jq = jbatch.make_pipeline_fleet_runner(jp, jpe, DT, use_pallas=False)(data_b, eb, vo)
    tx, tv, tq = batch.make_pipeline_fleet_runner(
        tp, tpe, F64, use_megakernel=True, device="cpu")(tdata, teb, tvo)
    assert tx.shape == (T, Bs, SHAPES[model][0])
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    jx, jv = jbatch.make_lanes_fleet_runner(jp, DT, use_pallas=False)(data_b, vo)
    for use_megakernel in (False, True):
        tx, tv = batch.make_lanes_fleet_runner(tp, F64, use_megakernel=use_megakernel,
                                               device="cpu")(tdata, tvo)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


# ---- converters ---------------------------------------------------------------------


@pytest.mark.parametrize("model", MODELS)
def test_convert_carries_consts_and_state(model):
    """``from_jax_numpy`` carries the robot's constrained consts (the foot
    noise gains, ±inf bounds on the foot states) and an s-sized window state
    with its warm starts (the tick-0 state, foot states seeded); the kernel
    state built from it has the shapes the tick kernel takes."""
    jc, tc = _consts(model, 5, True)
    data_b, _, _ = _fleet(model, 20, 3)
    d = jax.tree.map(lambda a: a[0], jbatch.tickdata_to_lanes(data_b))
    jst = jml.init(jc, d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq, d.contact,
                   dtype=DT)
    s, m, L, lot = SHAPES[model]
    tst = convert.from_jax_numpy(_np(jst), "cpu", F64)
    cc = convert.from_jax_numpy(_np(jc), "cpu", F64)
    assert (cc.dim_state, cc.dim_meas, cc.num_legs, cc.leg_odom_type) == (s, m, L, lot)
    for f in jc.nc._fields:
        assert np.array_equal(getattr(cc.nc, f).numpy(), np.asarray(getattr(jc.nc, f))), f
        assert np.array_equal(getattr(tc.nc, f).numpy(), getattr(cc.nc, f).numpy()), f
    for f in ("A_meas", "P_cam", "x_lb", "x_ub"):
        assert np.array_equal(getattr(cc, f).numpy(), np.asarray(getattr(jc, f))), f
    assert cc.admm == tc.admm
    assert tuple(tst.A_dyn.shape) == (5, s, s, 3) and tuple(tst.z_adm.shape) == (5, s, 3)
    if lot == 1:    # the foot states start at the first foot measurement
        np.testing.assert_allclose(tst.M_p.numpy(), np.asarray(jst.M_p), rtol=1e-12)
        assert float(tst.n_p[9:].abs().max()) > 0
    ks = mrk.kernel_state_from_mhe(tst, tc)
    assert [tuple(a.shape[:-1]) for a in ks.arrays] == mrk.state_shapes(5, s, m, L, True)
    kc = mrk.consts_from_mhe(tc)
    packed = mrk._pack_consts(kc)
    assert packed.size == 1 + m * s + 3 * s + 8 * 9 + 3 + 9
    assert np.array_equal(packed[-9:], kc.Q_foot_slide.ravel())
    assert np.array_equal(kc.Q_foot_slide, np.asarray(jc.nc.Q_foot_slide))


def test_library_map_has_every_variant_group_at_every_shape():
    """Every shape has its shared-clock, per-lane-clock and Cholesky-tail
    library (the tail on either clock), and a stage-ablation library per
    composition, each unit carries its shape's and its variant's defines (the
    entry point its shape's alone), the s=15 units keep their long loops
    rolled, and a shape outside the build still raises."""
    shapes = dict(SHAPES, go1=(9, 12, 4, 0))
    variants = {"": {(0, 0, 0), (0, 1, 0)}, "pi": {(1, 0, 0), (1, 1, 0)},
                "chol": {(0, 0, 1), (1, 0, 1)}}
    for model, (s, m, L, lot) in shapes.items():
        for group, want in variants.items():
            lib = f"mhe_{model}" + (f"_{group}" if group else "")
            assert _build.mhe_library(s, m, L, lot, group) == lib
            assert mrk.kernel_library(s, m, L, lot, per_lane_clock=group == "pi",
                                      chol=group == "chol") == lib
            entry, *units = _build.UNITS[lib]
            shape = (f"-DDEM_MHE_SHAPE={model}", f"-DDEM_MHE_S={s}", f"-DDEM_MHE_M={m}",
                     f"-DDEM_MHE_L={L}", f"-DDEM_MHE_LOT={lot}")
            for _, defs in (entry, *units):
                assert defs[:5] == shape and ("-DDEM_MAX_UNROLL=256" in defs) == (s == 15)
            assert entry[1] == shape + (("-DDEM_MAX_UNROLL=256",) if s == 15 else ())
            got = {(int("-DDEM_MHE_PI=1" in d), int("-DDEM_MHE_CON=1" in d),
                    int("-DDEM_MHE_CHOL=1" in d)) for _, d in units}
            assert got == want and len(units) == 2 * len(want), (lib, units)
            reals = sorted(d for _, defs in units for d in defs if d.startswith("-DDEM_MHE_REAL="))
            assert reals == (["-DDEM_MHE_REAL=double"] * len(want)
                             + ["-DDEM_MHE_REAL=float"] * len(want))
        # the tail on per-lane clocks is a unit of the Cholesky library; the
        # stage ablation exists at every shape, one library per composition
        assert mrk.kernel_library(s, m, L, lot, per_lane_clock=True, chol=True) == (
            f"mhe_{model}_chol")
        for per_lane, chol, con, lib in ((False, False, False, "abl"),
                                         (True, False, False, "abl_pi"),
                                         (True, True, False, "abl_pi_chol"),
                                         (True, False, True, "abl_pi_box")):
            assert mrk.kernel_library(s, m, L, lot, per_lane, chol=chol, ablate="marg",
                                      constrained=con) == f"mhe_{model}_{lib}_f64"
    with pytest.raises(NotImplementedError):
        mrk.kernel_library(12, 6, 1, 1, False)
    assert _build.mhe_library(12, 6, 1, 1) is None
    # each s=15 and s=21 unit keeps its long loops rolled; no s=9 unit does
    for lib, units in _build.UNITS.items():
        for _, defs in units:
            s15 = any(d in (f"-DDEM_MHE_S={s}", f"-DDEM_ADMM_S={s}", f"-DDEM_TRIDIAG_S={s}")
                      for d in defs for s in (15, 21))
            assert ("-DDEM_MAX_UNROLL=256" in defs) == s15, (lib, defs)


# ---- robot models ---------------------------------------------------------------------


def test_go1_model_matches_frost_golden():
    g = np.load(os.path.join(REPO, "tests", "data", "go1_frost_golden.npz"))
    joints = torch.as_tensor(g["joints"])
    np.testing.assert_allclose(models.Go1Model(p_ib=(0.0, 0.0, 0.0)).fk(joints).numpy(),
                               g["fk"], atol=1e-12)
    np.testing.assert_allclose(models.Go1Model().jacobian(joints).numpy(), g["jac"],
                               atol=1e-12)
    p_ib = (0.01592, 0.06659, 0.00617)
    np.testing.assert_allclose(models.Go1Model(p_ib=p_ib).p_imu_2_foot(joints[:3]).numpy(),
                               g["fk"][:3] + np.asarray(p_ib), atol=1e-12)


@pytest.mark.parametrize("name", ["go1", "cassie", "pogox"])
def test_models_match_jax(name):
    """FK, Jacobian, the offset foot position and contact detection of every
    registered model against the JAX model on seeded joints; the registry
    holds the same names."""
    assert sorted(models.REGISTRY) == sorted(jmodels.REGISTRY)
    tm, jm = models.get_model(name), jmodels.get_model(name)
    assert tm.num_legs == jm.num_legs
    q = np.random.default_rng(11).uniform(-0.8, 0.8, (7, tm.num_legs, 3))
    for f in ("fk", "jacobian", "p_imu_2_foot"):
        np.testing.assert_allclose(getattr(tm, f)(torch.as_tensor(q)).numpy(),
                                   np.asarray(getattr(jm, f)(jnp.asarray(q))), rtol=1e-12,
                                   atol=1e-12, err_msg=f)
    force = np.array([0.0, 39.9, 40.0, 120.0, 150.0, 300.0])
    np.testing.assert_array_equal(tm.contact_from_force(torch.as_tensor(force)).numpy(),
                                  np.asarray(jm.contact_from_force(jnp.asarray(force))))
    # the Jacobian is the derivative of the forward kinematics
    qt = torch.as_tensor(q[0])
    Jfd = torch.autograd.functional.jacobian(tm.fk, qt)          # (L,3,L,3)
    for i in range(tm.num_legs):
        np.testing.assert_allclose(Jfd[i, :, i].numpy(), tm.jacobian(qt)[i].numpy(),
                                   atol=1e-12)


def test_cartesian_feet_model():
    m = models.CartesianFeetModel(num_legs=2, p_ib=(0.1, 0.0, 0.0))
    q = torch.arange(12, dtype=F64).reshape(2, 2, 3)
    assert torch.equal(m.fk(q), q)
    assert torch.equal(m.jacobian(q), torch.eye(3, dtype=F64).expand(2, 2, 3, 3))
    assert torch.allclose(m.p_imu_2_foot(q)[..., 0], q[..., 0] + 0.1)


# ---- the bounds' operation and byte counts ------------------------------------------


def test_work_counts_new_shapes_and_go1_unchanged():
    """Operations and bytes of the tick at the new shapes are positive and
    grow with the state; Go1's count is the one its earlier rows printed."""
    ticks = range(1, 200)
    sched = _work.mhe_schedule([t % 7 == 0 for t in ticks], [max(t - 10, 0) for t in ticks],
                               [t - 2 for t in ticks], 20)
    it = np.full((len(sched), 16), 20)
    box = (it, 10, False, True, True)
    assert _work.mhe_tick(20, 9, 12, 4, 16, sched, 777, 4) == (2482624, 266211258)
    assert _work.mhe_tick(20, 9, 12, 4, 16, sched, 777, 4, box=box) == (2542592, 1578671226)
    free, con = {}, {}
    for model, (s, m, L, lot) in SHAPES.items():
        free[model] = _work.mhe_tick(20, s, m, L, 16, sched, 777, 4, lot=lot)
        con[model] = _work.mhe_tick(20, s, m, L, 16, sched, 777, 4, box=box, lot=lot)
        assert free[model][0] > 0 and free[model][1] > 0
        assert con[model][0] > free[model][0] and con[model][1] > free[model][1]
    assert free["cassie"][1] > 2 * free["pogox"][1]
    # with foot positions as states the stance flags cost nothing extra
    assert _work.mhe_tick(20, 15, 6, 2, 16, sched, 0, 4, lot=1) == free["cassie"]
    pat = _work._Patterns(15, 6, 2, 1)
    assert _work._mm(pat.H.T, pat.Qm)[1] == 0                  # H^T R: ±1 selectors
    assert int((pat.A[9:, 9:] == _work.U).sum()) == 6          # identity foot blocks
    b15, f15 = _work.tridiag(20, 15, 1024, 4)
    b9, f9 = _work.tridiag(20, 9, 1024, 4)
    assert b15 > b9 and f15 > f9
    assert _work.admm(20, 15, 8, 4, np.full(8, 20), 10, False, True, True)[1] > \
        _work.admm(20, 9, 8, 4, np.full(8, 20), 10, False, True, True)[1]
