"""PyTorch port vs the JAX package: the stage ablation of the MHE tick (K2e)
and the tool that drives it.

The JAX mega-kernel's ``ablate`` skips one stage of every tick — "ingest",
"marg", "build", "assembly" or "solve" — so that the time saved is that
stage's share (``tools/roofline.py --ablate``); its output is wrong by
construction. The port has the same switch on ``mhe_replay_kernel.replay``
(a CUDA unit per stage at Go1's and PogoX's shapes, and a plain version that
skips the same stages on the logical window). At float64 on the CPU, N=5,
T=18, B=3: each stage at Go1's and PogoX's shapes against the Pallas kernel
with the same ``ablate`` in interpret mode, with equal positions of
non-finite values (the "build" stage zeros the fresh data and makes the
window singular); ``ablate=""`` against the unablated route; the refusals;
the launch-size knob; the operation counts of the ablated ticks; and every
mode of the port's
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
ROW = "K2e at Cassie; on per-lane clocks, the Cholesky tail and box consts"
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
    np.testing.assert_array_equal(np.isnan(tx), np.isnan(jx))
    np.testing.assert_array_equal(np.isinf(tx), np.isinf(jx))
    fin = np.isfinite(jx)
    assert fin[0].all()                      # tick 0, the init window, is not ablated
    np.testing.assert_allclose(tx[fin], jx[fin], **TOL)
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
    """An unknown stage raises ``ValueError``; the ablation with box consts,
    on per-lane camera clocks, with the Cholesky tail or at Cassie's shape
    raises ``NotImplementedError`` naming its ROADMAP.md row, on the CPU as on
    the card (``replay_ticks`` refuses before it takes either route, so the
    kernel route builds and launches nothing); PogoX's shape is taken."""
    _, _, tdata, tvo = _fleet()
    tp = _params()[1]
    tc = mhe.make_consts(tp, F64, device="cpu")
    ks, d, v, i = _tick_inputs(tc, tdata, tvo)
    for bad in ("gj", "Solve", "assemble"):
        with pytest.raises(ValueError, match="ablate"):
            mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu", ablate=bad)
    with pytest.raises(NotImplementedError, match=ROW):
        mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu", mk_solve="chol", ablate="marg")
    ub = np.full(9, np.inf)
    ub[3:6] = 0.3
    cb = mhe.make_consts(tp, F64, x_lb=-ub, x_ub=ub, admm_iters=5, use_pallas=True,
                         device="cpu")
    with pytest.raises(NotImplementedError, match=ROW):
        mrk.replay(cb, tdata, tvo, dtype=F64, device="cpu", ablate="solve")
    T = tvo.active.shape[0]
    wide = lambda a: a[:, None].expand(T, B_LANES).contiguous()
    tvo_pi = estimator.VOData(wide(tvo.active), tvo.dp_body, wide(tvo.tick_pre),
                              wide(tvo.tick_now))
    with pytest.raises(NotImplementedError, match=ROW):
        mrk.replay(tc, tdata, tvo_pi, dtype=F64, device="cpu", ablate="ingest")
    for model in ("cassie", "pogox"):
        tpm = config.load_yaml_params(os.path.join(REPO, "configs",
                                                   f"parameters_{model}.yaml"))[0]
        tpm.N = N_WIN
        cm = mhe.make_consts(tpm, F64, device="cpu")
        if model == "pogox":
            mrk.check_ablate(cm, "build", False, "gj")
            assert mrk.kernel_library(*_build.MHE_SHAPES[model], False,
                                      ablate="build") == "mhe_pogox_abl"
            continue
        with pytest.raises(NotImplementedError, match=ROW):
            mrk.check_ablate(cm, "build", False, "gj")
        with pytest.raises(NotImplementedError, match=ROW):
            mrk.kernel_library(*_build.MHE_SHAPES[model], False, ablate="build")
    def route(*a, **k):
        raise AssertionError("a refused ablation reached a route")

    monkeypatch.setattr(mrk, "_launch", route)
    monkeypatch.setattr(mrk, "replay_ticks_plain", route)
    with pytest.raises(NotImplementedError, match=ROW):
        mrk.replay_ticks(tc, ks, d, v, i, device="cpu", mk_solve="chol", ablate="solve")


def test_ablation_library():
    """One library per shape, ``mhe_go1_abl`` and ``mhe_pogox_abl``, holds a
    unit per stage and type with the stage's index in ``DEM_MHE_ABL`` (the
    order of ``ABLATE_STAGES``), unconstrained on the shared clock; every unit
    of the other libraries keeps its defines."""
    assert mrk.ABLATE_STAGES == STAGES and _build.MHE_ABL_SHAPES == ("go1", "pogox")
    for tag in _build.MHE_ABL_SHAPES:
        for stage in STAGES:
            assert mrk.kernel_library(*_build.MHE_SHAPES[tag], False,
                                      ablate=stage) == f"mhe_{tag}_abl"
        units = _build.UNITS[f"mhe_{tag}_abl"]
        assert units[0] == ("mhe", _build._mhe_shape_flags(tag))
        got = [(f[5].split("=")[1], f[6:]) for _, f in units[1:]]
        assert got == [(f"dem_mhe_unit_{tag}_abl{k}_{sym}",
                        (f"-DDEM_MHE_REAL={real}", "-DDEM_MHE_CON=0", "-DDEM_MHE_PI=0",
                         f"-DDEM_MHE_ABL={k}"))
                       for k in range(1, 6) for real, sym in (("float", "f32"), ("double", "f64"))]
    assert not any("ABL" in d for lib, us in _build.UNITS.items()
                   if lib not in ("mhe_go1_abl", "mhe_pogox_abl") for _, f in us for d in f)


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
