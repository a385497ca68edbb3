"""Go1 with its foot positions as states: s = 9 + 3·4 = 21, m = 12, L = 4.

The JAX package runs this shape through its Pallas tick
(``tests/test_megakernel.py``'s ``leg_odom_type=1``) and its boxed lanes solve
(``tests/test_mhe_lanes.py``); the port runs it on a warp of 32 threads per
instance (``_group.group_size``: lane r owns row r, and the Cholesky tail's
spare lane is lane 21). Without a card:

- the group bodies built for the host at s=21 alone
  (``tests/box_group_host/*harness.cpp`` with ``-DDEM_HARNESS_S=21``, an
  instance's 32 lanes as ``std::thread``s): the unconstrained tick (K2, K2b,
  K2d, K2d-PI: either tail, either clock) against the one-thread body, K5 on
  both layouts and K4's entry against their one-thread bodies, and the
  constrained tick's ADMM case, each bit for bit in float64 and float32; the
  float64 tick also against the plain version;
- the port's plain tick at (21, 12, 4, 1) against JAX's
  ``estimator.run_mhe_lanes`` at float64, unconstrained and with a velocity
  box, on the inputs of JAX's ``test_megakernel_matches_lanes_f64[1]`` (N=6);
- the plain K5 and K4 at s=21 against the Pallas kernels in interpret mode;
- the launch geometry at s=21 in both types, and the refusal of s=32;
- the stage ablation at s=21 refusing by name (still to port), and the
  kernels' bound at this shape.
"""

import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu.config import EstimatorParams as JParams
from decentralized_ekf_mhe_tpu.io import synth as jsynth
from decentralized_ekf_mhe_tpu.ops import estimator as jest
from decentralized_ekf_mhe_tpu.ops import admm as jadmm
from decentralized_ekf_mhe_tpu.ops import mhe as jmhe
from decentralized_ekf_mhe_tpu.pallas import admm_kernel as jak
from decentralized_ekf_mhe_tpu.pallas import tridiag_kernel as jtk
from decentralized_ekf_mhe_tpu.parallel import batch as jbatch
from decentralized_ekf_mhe_tpu_torch import convert
from decentralized_ekf_mhe_tpu_torch.config import EstimatorParams
from decentralized_ekf_mhe_tpu_torch.kernels import _build, _group, _work
from decentralized_ekf_mhe_tpu_torch.kernels import admm_kernel, tridiag_kernel
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import admm, mhe, mhe_lanes
from decentralized_ekf_mhe_tpu_torch.parallel import batch

import test_torch_box_group as tbg
import test_torch_solve_group as tsg
import test_torch_tick_group as ttg

torch.set_num_threads(1)

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-8)
SHAPE = (21, 12, 4, 1)   # s, m, L, leg_odom_type
MODEL = "go1feet"
# the host harness's cases: a barrier of 32 threads per sync, and the syncs
# grow with the window, the ticks and the instances, so the s=21 cases take a
# window of N=8 slots (full from tick 8, then marginalized) over 13 ticks of 3
# instances; the windows of the solves likewise (B=3, N=8, full after 11 ticks)
N_HOST, T_HOST, B_HOST = 8, 14, 3
WINDOW = dict(B=B_HOST, T=12, N=N_HOST)


# ------------------------------------------------------------ the geometry


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_geometry_at_s21_is_a_warp_per_instance(dtype):
    """At s=21 every group kernel runs 32 threads per instance, and each
    layout's bytes are rounded up to 16 (a warp holds one instance: no bank
    offset between groups). The box-ADMM (K2c's solve, K4), U_j from global
    memory: 11,046 scalars an instance; K5's chain: 10,248 scalars; the
    unconstrained tick: 2,688. By default eight instances, as far as they fit
    a block: K4/K2c and K5 5 in float32, 2 in float64; the tick all 8. The
    bytes per block are what the CUDA side's layouts give (held on the card
    by chip_smoke.py's geometry phases)."""
    item = torch.empty((), dtype=dtype).element_size()
    assert _group.group_size(21) == mrk.group_size(21) == 32
    assert [_group.group_size(s) for s in (9, 15, 16, 31)] == [16, 16, 32, 32]
    rnd = lambda scalars: -(-scalars * item // 16) * 16
    assert _group.box_shared_scalars(21, 20, False) == 11046
    assert _group.tridiag_shared_scalars(21, 20) == 10248
    assert mrk.tick_shared_scalars(21, 12) == 2688
    ipb = 5 if dtype == torch.float32 else 2
    for g, scalars in ((mrk.box_geometry(21, dtype), 11046),
                       (admm_kernel.geometry(21, dtype), 11046),
                       (tridiag_kernel.geometry(21, dtype), 10248)):
        assert (g.instances_per_block, g.threads_per_block) == (ipb, 32 * ipb)
        assert g.shared_bytes == ipb * rnd(scalars) <= _group.SHARED_PER_BLOCK
    assert not mrk.box_geometry(21, dtype).u_shared
    t = mrk.tick_geometry(21, 12, dtype)
    assert (t.instances_per_block, t.threads_per_block, t.shared_bytes) == (8, 256, 8 * rnd(2688))
    assert mrk.tick_geometry(21, 12, dtype, mk_solve="chol") == t
    assert mrk.tick_geometry(21, 12, dtype, 32).instances_per_block == 1
    # a block of groups of 16 is no launch at s=21
    for fn in (lambda b: mrk.tick_geometry(21, 12, dtype, b),
               lambda b: mrk.box_geometry(21, dtype, b),
               lambda b: tridiag_kernel.geometry(21, dtype, b),
               lambda b: admm_kernel.geometry(21, dtype, b)):
        with pytest.raises(ValueError, match="multiple of 32"):
            fn(48)


def test_s32_is_refused_by_name():
    """No group runs s >= 32 (lane r owns row r of a warp): each geometry
    raises, naming the state size."""
    for fn in (lambda: _group.group_size(32),
               lambda: mrk.tick_geometry(32, 12, torch.float32),
               lambda: mrk.box_geometry(32, torch.float32),
               lambda: tridiag_kernel.geometry(32, torch.float32),
               lambda: admm_kernel.geometry(40, torch.float64)):
        with pytest.raises(ValueError, match=r"s=(32|40): a group of threads per instance runs"):
            fn()


def test_build_has_the_shape_and_refuses_its_ablation():
    """The build instantiates the shape's three variant groups and K4/K5 at
    s=21, and no stage ablation there: ``check_ablate`` raises
    NotImplementedError naming ROADMAP's row."""
    assert _build.MHE_SHAPES[MODEL] == SHAPE and 21 in _build.SOLVE_SIZES
    for group in _build.MHE_GROUPS:
        assert _build.mhe_library(*SHAPE, group) in _build.UNITS
    assert "tridiag_s21" in _build.UNITS and "admm_s21" in _build.UNITS
    assert not any(n.startswith(f"mhe_{MODEL}_abl") for n in _build.UNITS)
    c = mhe.make_consts(_params(6), F64, device="cpu")
    mrk.check_ablate(c, "", False, "gj")
    with pytest.raises(NotImplementedError, match="K2e at s=21"):
        mrk.check_ablate(c, "marg", False, "gj")


def test_bound_counts_the_shape():
    """``_work``'s counts hold at (21, 12, 4, 1): the foot blocks add to the
    velocity form's work, and K5's and K4's bounds grow with s."""
    sched = _work.mhe_schedule([False] * 30, [0] * 30, [0] * 30, 20)
    feet = _work.mhe_tick(20, *SHAPE[:3], 1024, sched, 0, 4, lot=1)
    vel = _work.mhe_tick(20, 9, 12, 4, 1024, sched, 0, 4, lot=0)
    assert feet[0] > vel[0] > 0 and feet[1] > 2 * vel[1] > 0
    assert _work.tridiag(20, 21, 1024, 4)[1] > _work.tridiag(20, 15, 1024, 4)[1]
    iters = np.full(1024, 20)
    assert (_work.admm(20, 21, 1024, 4, iters, 10, False, True, True)[1]
            > _work.admm(20, 15, 1024, 4, iters, 10, False, True, True)[1])


# ---------------------------------------------- the group bodies on the host


@pytest.fixture(scope="module")
def harnesses(tmp_path_factory):
    """tick_harness.cpp and harness.cpp (K5, K4, the tick's ADMM) built with
    the s=21 instantiations alone, both g++ processes at once."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host harness")
    out = tmp_path_factory.mktemp("host21")
    exes, procs = {}, []
    for name in ("tick_harness", "harness"):
        exes[name] = str(out / name)
        procs.append(subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-DDEM_HARNESS_S=21",
             f"-I{ttg.CSRC}", f"-I{ttg.HOST}", os.path.join(ttg.HOST, f"{name}.cpp"), "-o",
             exes[name]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
    return exes


@pytest.mark.parametrize("tail,per_lane", [
    pytest.param("gj", False, id="shared_clock"),
    pytest.param("gj", True, id="per_lane_clocks"),
    pytest.param("chol", False, id="chol-shared_clock"),
    pytest.param("chol", True, id="chol-per_lane_clocks")])
def test_warp_tick_equals_one_thread_tick_on_the_host(harnesses, tmp_path, tail, per_lane):
    """mhe_body on a warp per instance (GRP at s=21: lane 0 the VO ingestion
    and, foot positions being states, the fresh slots' blocks; the group the
    marginalization, the shift with its cache update and the sweep; lanes
    21-31 in the syncs only but for lane 21, the Cholesky tail's spare lane)
    gives the one-thread body's x, window state and Bezier schedule bit for
    bit over 24 ticks (the window full from tick 20) in float64 and float32,
    on the shared camera clock and on per-lane clocks with a VO-free lane;
    its float64 x and state are the plain version's."""
    c, ks, d, v, i = ttg._fleet(per_lane, B_HOST, T_HOST, MODEL, N_HOST)
    assert (c.dim_state, c.dim_meas, c.num_legs, int(c.leg_odom_type)) == SHAPE
    case, out = str(tmp_path / "case.bin"), str(tmp_path / "out.bin")
    ttg._write_case(case, c, ks, d, v, i, chol=tail == "chol")
    lines = ttg._run_harness(harnesses["tick_harness"], case, out)
    assert lines[-1] == "ALL BIT-IDENTICAL" and len(lines) == 3, lines
    assert all(" s=21 m=12 G=32 " in ln and f" {tail}: x 0 state 0 schedule 0 differ" in ln
               for ln in lines[:2]), lines
    xp, ksp = mrk.replay_ticks_plain(c, ks, d, v, i)
    x, arrays, times = ttg._read_out(out, xp, ksp)
    torch.testing.assert_close(x, xp, **TOL)
    ttg._hold_state(arrays, ksp)
    assert torch.equal(times, ksp.bez_times) and ksp.t == T_HOST - 1 > c.N


def test_warp_solves_equal_one_thread_solves_on_the_host(harnesses, tmp_path):
    """At s=21 (U_j from global memory) the group bodies on a warp give their
    one-thread versions' results bit for bit in float64 and float32: K5 on
    the lanes layout and on the standard layout read in place with a per-lane
    warm-up mask; K4's entry (fixed and adaptive rho, per-lane bounds, a
    budget ending inside an epoch, a warm-up window, a ragged B); and the
    constrained tick's ADMM on the ring (warm starts turned by zbase)."""
    tmp = str(tmp_path)
    k5, k4 = tsg._k5_cases(MODEL, tmp, **WINDOW), tsg._k4_cases(MODEL, tmp, **WINDOW)
    tick = tbg._cases(MODEL, tmp, **WINDOW)
    lines = tsg._run(harnesses["harness"], k5 + k4 + tick)
    assert len(lines) == 2 * (len(k5) + len(k4) + len(tick)), lines
    assert all(ln.endswith("; G=32") for ln in lines), lines
    k5_lines = [ln for ln in lines if " k5 " in ln]
    assert len(k5_lines) == 2 * len(k5) and all(" s=21: x 0 differ" in ln for ln in k5_lines)
    for layout in ("lanes", "standard"):
        assert any(f" k5 {layout} f64 s=21:" in ln for ln in k5_lines)
    for kind, n in ((" k4 ", len(k4)), (" tick ", len(tick))):
        rows = [ln for ln in lines if kind in ln]
        assert len(rows) == 2 * n and all(" s=21 USH=0: x 0 z 0 y 0 iters 0 differ" in ln
                                          for ln in rows), rows


# ------------------------------------------- the plain versions against JAX


def _params(N):
    """Go1's bench estimator with its foot positions as states (the JAX
    test's EstimatorParams(num_legs=4, leg_odom_type=1, rate=200, N=N))."""
    return EstimatorParams(num_legs=4, leg_odom_type=1, rate=200, N=N)


@pytest.mark.parametrize("box", [False, True], ids=["unconstrained", "box"])
def test_plain_tick_matches_jax_run_mhe_lanes(box):
    """``mhe_replay_kernel.replay`` on CPU tensors (the plain tick that the
    card's kernels are held to) at (21, 12, 4, 1) == JAX's
    ``estimator.run_mhe_lanes`` at float64, rtol/atol 1e-8 (the plain
    reference of JAX's ``test_megakernel_matches_lanes_f64[1]``): N=6, the
    JAX test's log (seed 7) perturbed on the JAX side, VO and the
    marginalization within T=12; with a velocity box |v| <= 0.05 (fixed
    rho=5000, 20 iterations + polish) that binds."""
    N, T, B = 6, 12, 4
    jp = JParams(num_legs=4, leg_odom_type=1, rate=200, N=N)
    log = jsynth.generate(jsynth.SynthConfig(T=T, seed=7, vo_every=3, vo_latency=1))
    data_b = jbatch.to_time_leading(jbatch.perturb_log_batch(
        jest.tickdata_from_log(log, dtype=jnp.float64), B, jax.random.PRNGKey(7),
        dtype=jnp.float64))
    vo = jest.vodata_from_log(log, dtype=jnp.float64)
    data_l = jbatch.tickdata_to_lanes(data_b)
    tp = _params(N)
    kw = {}
    if box:
        ub = np.full(21, np.inf)
        ub[3:6] = 0.05
        for p in (jp, tp):
            p.osqp.rho, p.osqp.adapt_rho, p.osqp.polish = 5000.0, False, True
        kw = dict(x_lb=-ub, x_ub=ub, admm_iters=20)
    jc = jmhe.make_consts(jp, jnp.float64, **kw)
    x_ref, _ = jest.run_mhe_lanes(jp, data_l, vo=vo, dtype=jnp.float64, consts=jc)
    tdata_l, tvo = (convert.from_jax_numpy(jax.tree.map(np.asarray, t), "cpu", F64)
                    for t in (data_l, vo))
    tc = mhe.make_consts(tp, F64, use_pallas=True, device="cpu", **kw)
    x = mrk.replay(tc, tdata_l, tvo, dtype=F64, device="cpu")
    assert x.shape == (T, 21, B) and int(tvo.active.sum()) > 0 and T > N
    np.testing.assert_allclose(np.moveaxis(x.numpy(), -1, 1), np.asarray(x_ref), **TOL)
    if box:
        vmax = float(x[:, 3:6].abs().max())
        assert 0.05 - 1e-6 <= vmax <= 0.05 + 1e-6, vmax


def test_plain_solves_match_pallas_interpret_at_s21():
    """The plain K5 and K4 at s=21 (what CPU tensors take and the card is held
    against) == the Pallas kernels in interpret mode (``solve_lanes``,
    ``solve_box_lanes``) on the last two slots of the bench fleet's late
    window with the foot positions as states, two instances, per-lane
    bounds, warm starts, fixed rho: rtol/atol 1e-8, equal ADMM counts. (The
    interpreter runs every iteration of every slot: two slots and six
    iterations keep it within seconds.)"""
    c, ub, _, st = tsg._windows(MODEL, **WINDOW)
    D, U, r = mhe_lanes._masked_system(c, st)
    D, U, r, z0, y0 = (a[-2:, ..., :2].contiguous()
                       for a in (D, U[1:], r, st.z_adm, st.y_adm))
    U = U[1:].contiguous()
    J = lambda a: jnp.asarray(a.numpy())
    want = jtk.solve_lanes(J(D), J(U), J(r), interpret=True)
    np.testing.assert_allclose(tridiag_kernel.solve_lanes(D, U, r, device="cpu").numpy(),
                               np.asarray(want), **TOL)
    lb, ubb = (-ub[:, :2]).numpy(), ub[:, :2].numpy()
    kw = dict(rho=0.1, iters=6, abs_tol=1e-3, rel_tol=1e-3, adaptive_rho=False)
    jres = jak.solve_box_lanes(J(D), J(U), J(r), lb, ubb, jadmm.ADMMSettings(**kw), z0=J(z0),
                               y0=J(y0), interpret=True)
    tres = admm_kernel.solve_box_lanes(D, U, r, lb, ubb, admm.ADMMSettings(**kw), z0=z0, y0=y0,
                                       device="cpu")
    for f in ("x", "z", "y"):
        np.testing.assert_allclose(getattr(tres, f).numpy(), np.asarray(getattr(jres, f)),
                                   err_msg=f, **TOL)
    np.testing.assert_array_equal(tres.iters.numpy(), np.asarray(jres.iters))


def test_fleet_runner_on_the_cpu():
    """The pipeline runner the card drives at this shape takes its plain
    versions on CPU tensors and counts no launch: the bench fleet with its
    foot positions as states, a few ticks, float64, finite."""
    from decentralized_ekf_mhe_tpu_torch.config import EKFParams
    from decentralized_ekf_mhe_tpu_torch.tools import roofline

    p, data_b, eb, vo = roofline.bench_fleet(2, 8, device="cpu", dtype=F64, model=MODEL)
    assert (p.dim_state, p.dim_meas, p.num_legs, p.leg_odom_type) == SHAPE
    before = (mrk.launches, tridiag_kernel.launches)
    run = batch.make_pipeline_fleet_runner(p, EKFParams(), F64, use_megakernel=True,
                                           device="cpu")
    x, v, q = run(data_b, eb, vo)
    assert (mrk.launches, tridiag_kernel.launches) == before
    assert x.shape == (8, 2, 21) and bool(torch.isfinite(x).all() and torch.isfinite(v).all())
