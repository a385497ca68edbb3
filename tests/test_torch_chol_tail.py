"""PyTorch port vs the JAX package: the Cholesky tail of the MHE tick (K2d).

The JAX mega-kernel solves each tick's window with a Gauss-Jordan chain
(``mk_solve="gj"``, the default) or a Cholesky factor-and-substitute chain
(``"chol"``), read from the environment variable ``DEM_MK_SOLVE`` when the
caller names none, as both fleet runners do. The port does the same. At
float64 on the CPU, for Go1, Cassie (foot positions as states, s=15) and
PogoX: the Pallas kernel with the Cholesky tail in interpret mode against the
port's ``mhe_replay_kernel.replay`` with the same tail (whose plain version is
the tick loop both tails share), the environment variable through both
packages' lanes runners, the port's refusals (an unknown tail; on per-lane
clocks, where the tail runs, the stage ablation), its library map, and the
operation counts of the tail's bound. Inputs are perturbed once on the JAX side and handed to
both packages.
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

torch.set_num_threads(1)

DT = jax.numpy.float64
F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# s, m, L, leg_odom_type
SHAPES = {"go1": (9, 12, 4, 0), "cassie": (15, 6, 2, 1), "pogox": (9, 3, 1, 0)}
MODELS = tuple(SHAPES)
N_WIN, T_LOG, B_LANES = 5, 18, 3


def _params(model):
    """(JAX params, port params) at window N_WIN: Go1's as the JAX package's
    own Cholesky test sets them, Cassie's and PogoX's from their files."""
    if model == "go1":
        kw = dict(num_legs=4, leg_odom_type=0, rate=200, N=N_WIN)
        return jconfig.EstimatorParams(**kw), config.EstimatorParams(**kw)
    path = os.path.join(REPO, "configs", f"parameters_{model}.yaml")
    jp, tp = jconfig.load_yaml_params(path)[0], config.load_yaml_params(path)[0]
    jp.N = tp.N = N_WIN
    return jp, tp


@functools.lru_cache(maxsize=None)
def _fleet(model):
    """The robot's synthetic log (seed 2; a VO frame every 3 ticks, so the
    short log reaches the Bezier increments) as a JAX-perturbed fleet:
    (JAX time-leading TickData, JAX VOData, port TickData, port VOData)."""
    jp = _params(model)[0]
    log = jsynth.generate(jsynth.SynthConfig(T=T_LOG, seed=2, num_legs=jp.num_legs,
                                             vo_every=3, vo_latency=1))
    data_b = jbatch.to_time_leading(jbatch.perturb_log_batch(
        jest.tickdata_from_log(log, dtype=DT), B_LANES, jax.random.PRNGKey(0), jp, dtype=DT))
    vo = jbatch.perturb_vo_batch(jest.vodata_from_log(log, dtype=DT), B_LANES,
                                 jax.random.PRNGKey(2), jp, dtype=DT)
    tdata, tvo = (convert.from_jax_numpy(jax.tree.map(np.asarray, a), "cpu", F64)
                  for a in (data_b, vo))
    return data_b, vo, tdata, tvo


@functools.lru_cache(maxsize=None)
def _jax_chol(model):
    """The JAX Pallas kernel with the Cholesky tail, interpret mode: x (T,s,B)."""
    data_b, vo, _, _ = _fleet(model)
    jc = jmhe.make_consts(_params(model)[0], DT)
    return np.asarray(jmrk.replay(jc, jbatch.tickdata_to_lanes(data_b), vo, dtype=DT,
                                  interpret=True, mk_solve="chol"))


@pytest.mark.parametrize("model", MODELS)
def test_chol_tail_matches_pallas_interpret(model):
    """``replay(..., mk_solve="chol")`` on the CPU against the Pallas kernel
    with ``mk_solve="chol"`` in interpret mode: N=5, T=18, B=3, VO with Bezier
    increments, marginalization."""
    _, _, tdata, tvo = _fleet(model)
    tc = mhe.make_consts(_params(model)[1], F64, device="cpu")
    tx = mrk.replay(tc, batch.tickdata_to_lanes(tdata), tvo, dtype=F64, device="cpu",
                    mk_solve="chol")
    assert tx.shape == (T_LOG, SHAPES[model][0], B_LANES)
    np.testing.assert_allclose(tx.numpy(), _jax_chol(model), **TOL)


class _Reached(Exception):
    """Stops the JAX runner once its kernel call has shown which tail it got."""


@pytest.mark.parametrize("model", MODELS)
def test_env_picks_the_tail_in_both_lanes_runners(model, monkeypatch):
    """``DEM_MK_SOLVE=chol`` reaches the tick of both packages' lanes runners,
    which never name the tail. The JAX runner's kernel call is recorded and
    stopped there (its result would be the Pallas kernel's with the Cholesky
    tail, which the test above computes once); the port's runner gives the
    (x, v) of its replay asked for the tail by name, and that x is the JAX
    kernel's."""
    data_b, vo, tdata, tvo = _fleet(model)
    jp, tp = _params(model)
    seen = {"jax": [], "port": []}
    ticks = mrk.replay_ticks

    def jax_chunk(*a, **kw):
        seen["jax"].append(kw["mk_solve"])
        raise _Reached

    def port_ticks(*a, **kw):
        seen["port"].append(kw["mk_solve"])
        return ticks(*a, **kw)

    monkeypatch.setattr(jmrk, "_replay_chunk", jax_chunk)
    monkeypatch.setattr(mrk, "replay_ticks", port_ticks)
    monkeypatch.setenv("DEM_MK_SOLVE", "chol")
    with pytest.raises(_Reached):
        jbatch.make_lanes_fleet_runner(jp, DT, use_pallas=False, use_megakernel=True)(data_b, vo)
    tx, tv = batch.make_lanes_fleet_runner(tp, F64, use_megakernel=True, device="cpu")(tdata, tvo)
    assert seen == {"jax": ["chol"], "port": ["chol"]}
    monkeypatch.delenv("DEM_MK_SOLVE")
    ex, ev = batch.make_lanes_fleet_runner(tp, F64, use_megakernel=False, device="cpu")(tdata, tvo)
    x_named = mrk.replay(mhe.make_consts(tp, F64, device="cpu"), batch.tickdata_to_lanes(tdata),
                         tvo, dtype=F64, device="cpu", mk_solve="chol")
    assert seen["port"] == ["chol", "chol"]
    np.testing.assert_allclose(tx.numpy(), np.moveaxis(x_named.numpy(), -1, 1), **TOL)
    np.testing.assert_allclose(tx.numpy(), ex.numpy(), **TOL)
    np.testing.assert_allclose(tv.numpy(), ev.numpy(), **TOL)
    np.testing.assert_allclose(tx.numpy(), np.moveaxis(_jax_chol(model), -1, 1), **TOL)


def _tick_inputs(model, per_lane_clock=False):
    """The port's consts, tick-0 kernel state and ticks 1.. of the fleet, on
    the shared camera clock or with that clock broadcast to every lane."""
    _, _, tdata, tvo = _fleet(model)
    tc = mhe.make_consts(_params(model)[1], F64, device="cpu")
    d = batch.tickdata_to_lanes(tdata)
    if per_lane_clock:
        T = tvo.active.shape[0]
        wide = lambda a: a[:, None].expand(T, B_LANES).contiguous()
        tvo = estimator.VOData(wide(tvo.active), tvo.dp_body, wide(tvo.tick_pre),
                               wide(tvo.tick_now))
    d0 = estimator.TickData(*(a[0] for a in d))
    st0 = mhe_lanes.init(tc, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot, d0.J_foot, d0.dq,
                         d0.contact, dtype=F64, per_instance_vo=per_lane_clock, device="cpu")
    vo_inc = estimator.vo_world_increments(d.R_sb, tvo)
    rest = estimator.TickData(*(a[1:].contiguous() for a in d))
    return (tc, mrk.kernel_state_from_mhe(st0, tc), rest,
            estimator.VOData(*(a[1:] for a in tvo)), vo_inc[1:].contiguous())


def test_unknown_tail_raises(monkeypatch):
    """A tail other than "gj" or "chol" raises, named or from the environment
    (the JAX package runs Gauss-Jordan there without a word)."""
    _, _, tdata, tvo = _fleet("pogox")
    tc = mhe.make_consts(_params("pogox")[1], F64, device="cpu")
    d = batch.tickdata_to_lanes(tdata)
    with pytest.raises(ValueError, match="cholesky"):
        mrk.replay(tc, d, tvo, dtype=F64, device="cpu", mk_solve="cholesky")
    monkeypatch.setenv("DEM_MK_SOLVE", "lu")
    with pytest.raises(ValueError, match="DEM_MK_SOLVE"):
        mrk.replay(tc, d, tvo, dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="'GJ'"):
        mrk.replay_ticks(*_tick_inputs("pogox"), device="cpu", mk_solve="GJ")
    # named explicitly, the tail wins over the environment
    x = mrk.replay(tc, d, tvo, dtype=F64, device="cpu", mk_solve="gj")
    assert bool(torch.isfinite(x).all())


@pytest.mark.parametrize("model", MODELS)
def test_chol_library_and_per_lane_clock_refusal(model, monkeypatch):
    """``kernel_library`` names the shape's Cholesky library on either camera
    clock, whose units are the shared-clock and the per-lane-clock
    instantiations of the tail (K2d, K2d-PI); on per-lane clocks no ablation
    is refused any more: with the Cholesky tail the stages before the tail
    take the shape's ``_abl_pi_chol`` libraries and the tail-free ones the
    Gauss-Jordan tick's ``_abl_pi``, and on the CPU the plain version runs
    them (equal to the Gauss-Jordan tick's where the tail is not reached)
    without a launch, while the unablated plain version runs the Cholesky
    tail there (the tail does not change what the tick returns)."""
    s, m, L, lot = SHAPES[model]
    assert mrk.kernel_library(s, m, L, lot, False, chol=True) == f"mhe_{model}_chol"
    assert mrk.kernel_library(s, m, L, lot, True, chol=True) == f"mhe_{model}_chol"
    assert mrk.kernel_library(s, m, L, lot, False) == f"mhe_{model}"
    assert mrk.kernel_library(s, m, L, lot, True) == f"mhe_{model}_pi"
    assert mrk.kernel_library(s, m, L, lot, True, chol=True, ablate="marg") == (
        f"mhe_{model}_abl_pi_chol_f64")
    assert mrk.kernel_library(s, m, L, lot, True, chol=True, ablate="solve") == (
        f"mhe_{model}_abl_pi_f64")
    units = [[d for d in flags if d.startswith(("-DDEM_MHE_UNIT=", "-DDEM_MHE_PI=",
                                                  "-DDEM_MHE_CHOL="))]
             for _, flags in _build.UNITS[f"mhe_{model}_chol"][1:]]
    assert units == [[f"-DDEM_MHE_UNIT=dem_mhe_unit_{model}{pi}_chol_{t}", f"-DDEM_MHE_PI={k}",
                      "-DDEM_MHE_CHOL=1"] for k, pi in ((0, ""), (1, "_pi")) for t in ("f32", "f64")]
    tc, ks, d, v, i = _tick_inputs(model, per_lane_clock=True)
    before = (mrk.launches, mrk.launches_pi, mrk.launches_chol, mrk.launches_pi_chol,
              repr(mrk.launches_abl))

    def route(*a, **k):
        raise AssertionError("the CPU took the kernel route")

    with monkeypatch.context() as mp:
        mp.setattr(mrk, "_launch", route)
        x_abl, _ = mrk.replay_ticks(tc, ks, d, v, i, device="cpu", mk_solve="chol",
                                    ablate="solve")
    x_abl_gj, _ = mrk.replay_ticks(tc, ks, d, v, i, device="cpu", ablate="solve")
    assert torch.equal(x_abl, x_abl_gj)
    x_chol, _ = mrk.replay_ticks(tc, ks, d, v, i, device="cpu", mk_solve="chol")
    x_gj, _ = mrk.replay_ticks(tc, ks, d, v, i, device="cpu")
    assert torch.equal(x_chol, x_gj)
    assert (mrk.launches, mrk.launches_pi, mrk.launches_chol, mrk.launches_pi_chol,
            repr(mrk.launches_abl)) == before


def test_work_counts_the_cholesky_tail():
    """The Cholesky tail's operations: fewer than Gauss-Jordan's at s=9 and
    s=15, everything else of the tick alike, and the helpers' counts by hand
    at s=3."""
    ticks = range(1, 120)
    sched = _work.mhe_schedule([t % 7 == 0 for t in ticks], [max(t - 10, 0) for t in ticks],
                               [t - 2 for t in ticks], 20)
    for s, m, L, lot in SHAPES.values():
        gj = _work.mhe_tick(20, s, m, L, 16, sched, 300, 4, lot=lot)
        chol = _work.mhe_tick(20, s, m, L, 16, sched, 300, 4, lot=lot, tail="chol")
        assert chol[0] == gj[0] and 0 < chol[1] < gj[1] / 2
        p = _work._Patterns(s, m, L, lot)
        cam = (False,) * 20
        assert _work._solve_ops(p, 20, 20, cam, tail="chol") < _work._solve_ops(p, 20, 20, cam)
        # without the sweep (the box variant) the tail does not matter
        assert (_work._solve_ops(p, 20, 20, cam, sweep=False, tail="chol")
                == _work._solve_ops(p, 20, 20, cam, sweep=False))
    full, zero = _work._full(3, 3), np.zeros((3, 3), np.int8)
    # chol: per pivot k: k multiply-subtracts (2k), clamp, sqrt, reciprocal;
    # per entry below: 2k + 1 -> 5 + 8 + 7
    assert _work._chol(full)[1] == 20
    # L^-1 B, B dense 3x3: per column 1 + 3 + 5
    assert _work._trsm_l(full)[1] == 27 and _work._trsm_l(full[:, :1])[1] == 9
    assert _work._trsm_l(zero)[1] == 0
    # D - W^T W, lower triangle: 6 entries of 3 multiplies, 2 adds, 1 subtract
    assert _work._syrk_sub(full, full)[1] == 36 and _work._syrk_sub(full, zero)[1] == 0
    # a sparse right-hand side: column 0 starts at row 2 (1 op), column 1 at
    # row 0 (1 + 2 + 5: its row 1 is zero in b), column 2 is empty
    b = np.zeros((3, 3), np.int8)
    b[2, 0] = b[0, 1] = b[2, 1] = _work.G
    assert _work._trsm_l(b)[1] == 1 + 8
