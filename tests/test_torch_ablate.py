"""PyTorch port vs the JAX package: the stage ablation of the MHE tick (K2e)
and the tool that drives it.

The JAX mega-kernel's ``ablate`` skips one stage of every tick — "ingest",
"marg", "build", "assembly" or "solve" — so that the time saved is that
stage's share (``tools/roofline.py --ablate``); its output is wrong by
construction. The port has the same switch on ``mhe_replay_kernel.replay``
(a CUDA unit per shape, composition and stage, and a plain version that
skips the same stages on the logical window). At float64 on the CPU, N=5,
T=18, B=3: each stage at Go1's and PogoX's shapes against the Pallas kernel
with the same ``ablate`` in interpret mode, with equal positions of
non-finite values (the "build" stage zeros the fresh data and makes the
window singular); ``ablate=""`` against the unablated route; the refusals
that remain; the libraries; the launch-size knob; the operation counts of
the ablated ticks; and every mode of the port's
``decentralized_ekf_mhe_tpu_torch.tools.roofline`` at a tiny size with
``device="cpu"``, for its control flow only. Inputs are perturbed once on the
JAX side and handed to both packages.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu import config as jconfig
from decentralized_ekf_mhe_tpu.io import synth as jsynth
from decentralized_ekf_mhe_tpu.ops import estimator as jest
from decentralized_ekf_mhe_tpu.ops import mhe as jmhe
from decentralized_ekf_mhe_tpu.pallas import mhe_replay_kernel as jmrk
from decentralized_ekf_mhe_tpu.parallel import batch as jbatch
from decentralized_ekf_mhe_tpu_torch import config, convert
from decentralized_ekf_mhe_tpu_torch.kernels import _build, _work
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import estimator, mhe, mhe_lanes
from decentralized_ekf_mhe_tpu_torch.parallel import batch
from decentralized_ekf_mhe_tpu_torch.tools import roofline

torch.set_num_threads(1)

DT = jax.numpy.float64
F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_WIN, T_LOG, B_LANES = 5, 18, 3
STAGES = ("ingest", "marg", "build", "assembly", "solve")
LEGS = {"go1": 4, "pogox": 1}   # the velocity form's shapes: s=9, m = 3 legs


def _params(legs=4):
    """(JAX params, port params): Go1 (``legs`` 4) or PogoX's shape (1) at
    window N_WIN, as the JAX package's own mega-kernel tests set it."""
    kw = dict(num_legs=legs, leg_odom_type=0, rate=200, N=N_WIN)
    return jconfig.EstimatorParams(**kw), config.EstimatorParams(**kw)


@functools.lru_cache(maxsize=None)
def _fleet(legs=4):
    """The synthetic log of a robot with ``legs`` legs (seed 2; a VO frame
    every 3 ticks, so the short log reaches the Bezier increments) as a
    JAX-perturbed fleet on the shared camera clock: (JAX lanes TickData, JAX
    VOData, port lanes TickData, port VOData)."""
    jp = _params(legs)[0]
    log = jsynth.generate(jsynth.SynthConfig(T=T_LOG, seed=2, num_legs=legs, vo_every=3,
                                             vo_latency=1))
    data_l = jbatch.tickdata_to_lanes(jbatch.to_time_leading(jbatch.perturb_log_batch(
        jest.tickdata_from_log(log, dtype=DT), B_LANES, jax.random.PRNGKey(0), jp, dtype=DT)))
    vo = jbatch.perturb_vo_batch(jest.vodata_from_log(log, dtype=DT), B_LANES,
                                 jax.random.PRNGKey(2), jp, dtype=DT)
    tdata, tvo = (convert.from_jax_numpy(jax.tree.map(np.asarray, a), "cpu", F64)
                  for a in (data_l, vo))
    return data_l, vo, tdata, tvo


def _tick_inputs(c, tdata, tvo):
    """The consts' tick-0 kernel state and ticks 1.. of the fleet."""
    d0 = estimator.TickData(*(a[0] for a in tdata))
    st0 = mhe_lanes.init(c, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot, d0.J_foot, d0.dq,
                         d0.contact, dtype=F64, per_instance_vo=tvo.active.ndim == 2,
                         device="cpu")
    inc = estimator.vo_world_increments(tdata.R_sb, tvo)
    return (mrk.kernel_state_from_mhe(st0, c), estimator.TickData(*(a[1:] for a in tdata)),
            estimator.VOData(*(a[1:] for a in tvo)), inc[1:])


def _hold(tx, jx):
    """The port's x against the JAX kernel's: the same positions of NaN and of
    infinities, the finite entries to TOL; returns the finite mask."""
    np.testing.assert_array_equal(np.isnan(tx), np.isnan(jx))
    np.testing.assert_array_equal(np.isinf(tx), np.isinf(jx))
    fin = np.isfinite(jx)
    np.testing.assert_allclose(tx[fin], jx[fin], **TOL)
    return fin


@pytest.mark.parametrize("model,stage", [pytest.param("go1", st, id=st) for st in STAGES]
                         + [pytest.param("pogox", st, id=f"pogox-{st}") for st in STAGES])
def test_stage_matches_pallas_interpret(model, stage):
    """``replay(..., ablate=stage)`` on the CPU (the plain version of the K2e
    unit) against the Pallas kernel with the same ``ablate`` in interpret
    mode, at Go1's and PogoX's shapes: the same positions of non-finite
    values, the finite ones to rtol/atol 1e-8; the stage changes the
    estimate."""
    legs = LEGS[model]
    data_l, vo, tdata, tvo = _fleet(legs)
    jx = np.asarray(jmrk.replay(jmhe.make_consts(_params(legs)[0], DT), data_l, vo, dtype=DT,
                                interpret=True, ablate=stage))
    tc = mhe.make_consts(_params(legs)[1], F64, device="cpu")
    tx = mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu", ablate=stage).numpy()
    assert tx.shape == jx.shape == (T_LOG, 9, B_LANES)
    fin = _hold(tx, jx)
    assert fin[0].all()                      # tick 0, the init window, is not ablated
    full = mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu").numpy()
    assert not np.allclose(tx[1:], full[1:], equal_nan=True)
    # the zeroed fresh data leave the window singular from tick 1 on
    assert fin[1:].any() == (stage != "build")


def test_no_ablation_is_the_tick_bit_for_bit():
    """``ablate=""`` (the default) is the unablated route, bit for bit, on
    either tail; the launch-size knob does not change the plain version. The
    tick, ablated or not, runs 16 threads per instance, so a block is a
    multiple of 16 whose shared memory fits (1024 threads of Go1's tick do
    not), on the CPU as on the card."""
    _, _, tdata, tvo = _fleet()
    tc = mhe.make_consts(_params()[1], F64, device="cpu")
    for tail in ("gj", "chol"):
        x = mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu", mk_solve=tail)
        assert torch.equal(mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu", mk_solve=tail,
                                      ablate=""), x)
    ks, d, v, i = _tick_inputs(tc, tdata, tvo)
    x, st = mrk.replay_ticks(tc, ks, d, v, i, device="cpu")
    for block in (None, 32, 64, 256):
        xb, stb = mrk.replay_ticks(tc, ks, d, v, i, device="cpu", ablate="", block=block)
        assert torch.equal(xb, x) and all(torch.equal(a, b) for a, b in zip(stb.arrays,
                                                                             st.arrays))
    for block in (0, 40, 1024, 1025):
        for ablate in ("", "solve"):
            with pytest.raises(ValueError, match="block|shared memory"):
                mrk.replay_ticks(tc, ks, d, v, i, device="cpu", ablate=ablate, block=block)


def test_refusals_name_the_roadmap_row(monkeypatch):
    """The stage ablation runs at every composition the TPU kernel accepts,
    so no refusal names a ROADMAP.md row any more: an unknown stage and the
    "solve" stage with box consts (which the reference does not define) raise
    ``ValueError``, a shape outside the build ``NotImplementedError``, on the
    CPU as on the card (``replay_ticks`` refuses before it takes either route,
    so the kernel route builds and launches nothing); box consts, per-lane
    camera clocks, the Cholesky tail and Cassie's and PogoX's shapes are taken,
    each by its library."""
    _, _, tdata, tvo = _fleet()
    tp = _params()[1]
    tc = mhe.make_consts(tp, F64, device="cpu")
    ks, d, v, i = _tick_inputs(tc, tdata, tvo)
    assert not hasattr(mrk, "ABLATE_ROW")
    for bad in ("gj", "Solve", "assemble"):
        with pytest.raises(ValueError, match="ablate"):
            mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu", ablate=bad)
    ub = np.full(9, np.inf)
    ub[3:6] = 0.3
    cb = mhe.make_consts(tp, F64, x_lb=-ub, x_ub=ub, admm_iters=5, use_pallas=True,
                         device="cpu")
    with pytest.raises(ValueError, match="no such stage"):
        mrk.replay(cb, tdata, tvo, dtype=F64, device="cpu", ablate="solve")
    for stage in STAGES[:4]:
        mrk.check_ablate(cb, stage, True, "chol")
    for stage in STAGES:
        for per_lane in (False, True):
            for tail in mrk.MK_SOLVES:
                mrk.check_ablate(tc, stage, per_lane, tail)
    for model in ("cassie", "pogox"):
        tpm = config.load_yaml_params(os.path.join(REPO, "configs",
                                                   f"parameters_{model}.yaml"))[0]
        tpm.N = N_WIN
        cm = mhe.make_consts(tpm, F64, device="cpu")
        mrk.check_ablate(cm, "build", True, "chol")
        assert mrk.kernel_library(*_build.MHE_SHAPES[model], False,
                                  ablate="build") == f"mhe_{model}_abl_f64"
    with pytest.raises(NotImplementedError, match="no CUDA instantiation"):
        mrk.kernel_library(12, 6, 1, 1, False, ablate="build")

    def route(*a, **k):
        raise AssertionError("a refused ablation reached a route")

    monkeypatch.setattr(mrk, "_launch", route)
    monkeypatch.setattr(mrk, "replay_ticks_plain", route)
    ksb = _tick_inputs(cb, tdata, tvo)[0]
    for tail in mrk.MK_SOLVES:
        with pytest.raises(ValueError, match="no such stage"):
            mrk.replay_ticks(cb, ksb, d, v, i, device="cpu", mk_solve=tail, ablate="solve")
    with pytest.raises(ValueError, match="ablate"):
        mrk.replay_ticks(tc, ks, d, v, i, device="cpu", ablate="Solve")


def test_ablation_library():
    """One library per shape, composition and type, each built at its first
    use: ``mhe_<tag>_abl_<type>`` (the Gauss-Jordan tick on the shared clock),
    ``_abl_pi_<type>`` (on per-lane clocks), ``_abl_chol_<type>`` and
    ``_abl_pi_chol_<type>`` (the Cholesky tick, the stages before the tail),
    ``_abl_box_<type>`` and ``_abl_pi_box_<type>`` (the constrained tick,
    every stage but "solve"), <type> f32 or f64, each unit with its variant's
    defines and the stage's index in ``DEM_MHE_ABL`` (the order of
    ``ABLATE_STAGES``); 144 units in all, at the shapes of
    ``_build.ABL_SHAPES``. The Cholesky tick's tail-free
    stages take the Gauss-Jordan units of their clock. Every unit of the other
    libraries keeps its defines."""
    assert mrk.ABLATE_STAGES == STAGES and _build.TAIL_FREE_STAGES == ("assembly", "solve")
    want = {"": ((0, 0, 0), STAGES), "pi": ((1, 0, 0), STAGES),
            "chol": ((0, 0, 1), STAGES[:3]), "pi_chol": ((1, 0, 1), STAGES[:3]),
            "box": ((0, 1, 0), STAGES[:4]), "pi_box": ((1, 1, 0), STAGES[:4])}
    assert set(want) == set(mrk.ABLATE_VARIANTS)
    n = 0
    assert _build.ABL_SHAPES == ("go1", "cassie", "pogox")   # none at s=21 (go1feet)
    for tag in _build.ABL_SHAPES:
        shape = _build.MHE_SHAPES[tag]
        for variant, ((pi, con, chol), stages) in want.items():
            group = "abl" + ("_" + variant if variant else "")
            sfx = "_" + variant if variant else ""
            for real, sym in (("float", "f32"), ("double", "f64")):
                units = _build.UNITS[f"mhe_{tag}_{group}_{sym}"]
                assert units[0] == ("mhe", _build._mhe_shape_flags(tag))
                got = [tuple(f[len(_build._mhe_shape_flags(tag)):]) for _, f in units[1:]]
                exp = [(f"-DDEM_MHE_UNIT=dem_mhe_unit_{tag}{sfx}_abl{k}_{sym}",
                        f"-DDEM_MHE_REAL={real}", f"-DDEM_MHE_CON={con}", f"-DDEM_MHE_PI={pi}")
                       + (("-DDEM_MHE_CHOL=1",) if chol else ()) + (f"-DDEM_MHE_ABL={k}",)
                       for k in (STAGES.index(st) + 1 for st in stages)]
                assert got == exp, (tag, group, sym)
                n += len(got)
                for stage in stages:
                    assert mrk.kernel_library(*shape, bool(pi), chol=bool(chol), ablate=stage,
                                              constrained=bool(con), double=sym == "f64") == (
                        f"mhe_{tag}_{group}_{sym}")
        for stage in _build.TAIL_FREE_STAGES:
            assert mrk.kernel_library(*shape, True, chol=True, ablate=stage) == (
                f"mhe_{tag}_abl_pi_f64")
    assert n == 144
    assert not any("ABL" in d for lib, us in _build.UNITS.items()
                   if "_abl" not in lib for _, f in us for d in f)


def test_builds_run_at_most_the_jobs_they_are_given():
    """``_build.limit_jobs`` caps the compiler processes that run at once,
    across every build of the process (chip_smoke.py leaves cores to its
    phases so): four commands of 0.3 s take two rounds at two jobs, one at
    four."""
    import time as _time

    cmds = [["sleep", "0.3"]] * 4
    try:
        for jobs, rounds in ((2, 2), (4, 1)):
            _build.limit_jobs(jobs)
            t0 = _time.perf_counter()
            _build._run_all(cmds)
            assert rounds * 0.3 <= _time.perf_counter() - t0 < (rounds + 0.9) * 0.3
    finally:
        _build.limit_jobs(os.cpu_count() or 8)


def test_work_counts_what_each_stage_leaves():
    """``_work.mhe_tick(..., ablate=)`` drops exactly the stage's work: the
    marginalizations, the build (and the inputs only it reads), every window
    operation (assembly), the sweep for a sum (solve), or every VO event and
    the camera terms it would set (ingest: the tick without VO)."""
    N, s, m, L, B = 20, 9, 12, 4, 16
    ticks = range(1, 120)
    act = [t % 7 == 0 for t in ticks]
    sched = _work.mhe_schedule(act, [max(t - 10, 0) for t in ticks], [t - 2 for t in ticks], N)
    full = _work.mhe_tick(N, s, m, L, B, sched, 300, 4)
    w = {st: _work.mhe_tick(N, s, m, L, B, sched, 300, 4, ablate=st) for st in STAGES}
    p = _work._Patterns(s, m, L, 0)
    marg = sum(_work._marg_ops(p, mc) for _, _, mc, _ in sched if mc is not None)
    assert w["marg"] == (full[0], full[1] - B * marg)
    per_tick, stance = _work._assembly_ops(p)
    kept, none = _work._assembly_ops(p, build=False)
    assert none == 0 and 0 < kept < per_tick
    assert w["build"] == (full[0] - 4 * B * len(sched) * (3 + 15 * L),
                          full[1] - B * len(sched) * (per_tick - kept) - 300 * stance)
    sweep = sum(_work._solve_ops(p, N, n, cam) for n, cam, _, _ in sched)
    assembly = sum(_work._solve_ops(p, N, n, cam, sweep=False) for n, cam, _, _ in sched)
    assert w["assembly"] == (full[0], full[1] - B * sweep)
    assert w["solve"] == (full[0], full[1] - B * (sweep - assembly)
                          + B * len(sched) * (N * 2 * s + (N - 1) * s))
    free = _work.mhe_schedule([False] * len(act), [0] * len(act), [0] * len(act), N)
    no_vo = _work.mhe_tick(N, s, m, L, B, free, 300, 4)
    assert w["ingest"] == (no_vo[0] - 4 * B * 3 * len(sched), no_vo[1])
    assert all(w[st][1] < full[1] for st in STAGES)


def test_work_counts_every_composition():
    """``_work`` counts the ablated units of every composition: with the
    Cholesky tail the stages before it count its sweep and the tail-free ones
    the Gauss-Jordan tick's; with box consts "assembly" counts no ADMM (the
    bytes of the warm starts stay); on per-lane clocks "ingest" reads neither
    the per-lane VO metadata nor ``vo_inc``."""
    N, s, m, L, B, Tn = 20, 9, 12, 4, 16, 119
    ticks = range(1, Tn + 1)
    act = [t % 7 == 0 for t in ticks]
    pre, now = [max(t - 10, 0) for t in ticks], [t - 2 for t in ticks]
    sched = _work.mhe_schedule(act, pre, now, N)
    for st in STAGES:
        gj = _work.mhe_tick(N, s, m, L, B, sched, 300, 4, ablate=st)
        chol = _work.mhe_tick(N, s, m, L, B, sched, 300, 4, tail="chol", ablate=st)
        assert chol[0] == gj[0] and (chol[1] == gj[1]) == (st in _build.TAIL_FREE_STAGES)
    box = (np.full((Tn, B), 7), 20, False, True, True)
    full = _work.mhe_tick(N, s, m, L, B, sched, 300, 4, box=box)
    asm = _work.mhe_tick(N, s, m, L, B, sched, 300, 4, box=box, ablate="assembly")
    assert asm == (full[0], _work.mhe_tick(N, s, m, L, B, sched, 300, 4, ablate="assembly")[1])
    marg = _work.mhe_tick(N, s, m, L, B, sched, 300, 4, box=box, ablate="marg")
    assert marg[0] == full[0] and asm[1] < marg[1] < full[1]
    a = np.array(act)[:, None].repeat(B, 1)
    groups = _work.mhe_lane_schedules(a, np.array(pre)[:, None].repeat(B, 1),
                                      np.array(now)[:, None].repeat(B, 1), N)
    lanes_full = _work.mhe_tick_lanes(N, s, m, L, groups, 300, 4)
    lanes_ingest = _work.mhe_tick_lanes(N, s, m, L, groups, 300, 4, ablate="ingest")
    shared_ingest = _work.mhe_tick(N, s, m, L, B, sched, 300, 4, ablate="ingest")
    assert lanes_ingest[1] == shared_ingest[1]
    assert lanes_ingest[0] == lanes_full[0] - 4 * B * 3 * Tn - 4 * B * 3 * Tn


def test_tool_ablation_and_model_on_the_cpu():
    """The tool's ablation, analytic model and report run on the CPU at a
    tiny size (control flow only: the times are the host's, and the result
    says so)."""
    res = roofline.ablation(B=2, T=22, device="cpu", reps=1)
    assert res["device"] == "cpu" and "not a device time" in res["clock"]
    assert list(res["stages"]) == list(STAGES)
    full = res["full"]
    assert all(r["operations"] < full["operations"] and r["bytes"] <= full["bytes"]
               and r["bound_ms"] <= full["bound_ms"] for r in res["stages"].values())
    mdl = roofline.tick_model()
    assert 5e4 < mdl["flops_per_tick"] < 2e5 and mdl["bytes_per_tick"] > 0
    rep = roofline.report(1e9, file=open(os.devnull, "w"))
    assert rep["bound_by"] == "operations" and 0 < rep["flops_share"] < 10


def test_tool_ablation_of_every_composition_on_the_cpu():
    """The tool's ablation takes the clock (the fleet's VOData), the tail and
    the consts as ``replay`` does: per-lane clocks with the Cholesky tail, and
    box consts (four stages, no "solve"), each at a tiny size on the CPU
    (control flow only); every stage's bound stays below the full tick's, and
    the box "assembly" counts no ADMM."""
    p, data_b, eb, vo = roofline.bench_fleet(2, 22, device="cpu")
    T, B = vo.active.shape[0], 2
    wide = lambda a: a[:, None].expand(T, B).contiguous()
    vo_pi = estimator.VOData(wide(vo.active), vo.dp_body, wide(vo.tick_pre), wide(vo.tick_now))
    res = roofline.ablation(device="cpu", fleet=(p, data_b, eb, vo_pi), reps=1, mk_solve="chol")
    assert res["per_lane_clocks"] and res["mk_solve"] == "chol" and not res["constrained"]
    assert list(res["stages"]) == list(STAGES)
    box = roofline.ablation(device="cpu", fleet=(p, data_b, eb, vo), reps=1,
                            consts=roofline.bench_box(p, 3, "cpu"))
    assert box["constrained"] and list(box["stages"]) == list(STAGES[:4])
    for r in (res, box):
        full = r["full"]
        assert all(row["operations"] < full["operations"] and row["bytes"] <= full["bytes"]
                   for row in r["stages"].values())
    assert box["stages"]["assembly"]["operations"] < res["full"]["operations"]


def test_tool_sweeps_and_trace_on_the_cpu():
    """The tool's block/fleet sweep, constrained-budget sweep and trace run on
    the CPU at a tiny size (control flow only), and so does its command
    line."""
    sw = roofline.sweep(Bs=(2,), blocks=(32, 64), T=22, device="cpu", reps=1)
    assert [(r["B"], r["block"]) for r in sw["rows"]] == [(2, 32), (2, 64)]
    cs = roofline.constrained_sweep(B=2, T=22, iters_list=(2, 4), device="cpu", reps=1)
    assert [(r["polish"], r["iters"]) for r in cs["rows"]] == [
        (True, 2), (True, 4), (False, 2), (False, 4)]
    assert "us_per_iteration_per_tick" in cs
    tr = roofline.trace_capture(B=2, T=22, device="cpu")
    assert tr["device"] == "cpu" and tr["busy_share"] is None and tr["host_ms_by_operator"]
    out = roofline.main(["--device", "cpu", "--rate", "1e6"])
    assert set(out) == {"report"}
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            roofline.bench_fleet(2, 22)
        else:
            raise RuntimeError("CUDA present: the default device is taken")
