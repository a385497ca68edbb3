"""PyTorch port vs the JAX package: the Cholesky tail of the MHE tick on
per-lane camera clocks (K2d-PI).

Every lane of the fleet follows its own camera clock (its own VO frame rate
and latency; the last lane VO-free) and the window solve ends in the Cholesky
chain (``mk_solve="chol"``, ``DEM_MK_SOLVE=chol``). At float64 on the CPU, at
Go1's shape and PogoX's (Cassie's per-lane plain tick is held against the
JAX package in ``test_torch_legged_clocks.py``): the Pallas kernel with
``per_instance=True, mk_solve="chol"`` in interpret mode against the port's
``mhe_replay_kernel.replay`` with the same tail (whose plain version is the
per-lane tick loop both tails share), the environment variable through the
port's lanes runner, the library that holds the new units, and the operation
counts of their bound. Inputs are perturbed once on the JAX side and handed
to both packages.
"""

import functools
import os

import jax
import jax.numpy as jnp
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
from decentralized_ekf_mhe_tpu_torch.ops import estimator, mhe
from decentralized_ekf_mhe_tpu_torch.parallel import batch

torch.set_num_threads(1)

DT = jnp.float64
F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"go1": (9, 12, 4, 0), "pogox": (9, 3, 1, 0)}   # s, m, L, leg_odom_type
N_WIN, T_LOG, B_LANES = 5, 18, 3


def _params(model):
    """(JAX params, port params) at window N_WIN: Go1's as the JAX package's
    own Cholesky test sets them, PogoX's from its file."""
    if model == "go1":
        kw = dict(num_legs=4, leg_odom_type=0, rate=200, N=N_WIN)
        return jconfig.EstimatorParams(**kw), config.EstimatorParams(**kw)
    path = os.path.join(REPO, "configs", f"parameters_{model}.yaml")
    jp, tp = jconfig.load_yaml_params(path)[0], config.load_yaml_params(path)[0]
    jp.N = tp.N = N_WIN
    return jp, tp


@functools.lru_cache(maxsize=None)
def _fleet(model):
    """The robot's log (seed 2) as a JAX-perturbed lanes-layout fleet with a
    camera clock per lane: lane b takes the VO schedule of a log with a frame
    every 3 ticks, 1 + b ticks late, and its own VO-content draw; the last
    lane is VO-free. Returns (JAX data_l, JAX vo, port data_l, port vo)."""
    jp = _params(model)[0]
    logs = [jsynth.generate(jsynth.SynthConfig(T=T_LOG, seed=2, num_legs=jp.num_legs,
                                               vo_every=3, vo_latency=1 + b))
            for b in range(B_LANES)]
    data_b = jbatch.to_time_leading(jbatch.perturb_log_batch(
        jest.tickdata_from_log(logs[0], dtype=DT), B_LANES, jax.random.PRNGKey(0), jp, dtype=DT))
    vos = [jest.vodata_from_log(lg, dtype=DT) for lg in logs]
    lanes = lambda f: jnp.stack([getattr(v, f) for v in vos], axis=-1)
    active = lanes("active").at[:, -1].set(False)
    noise = 1e-4 * jax.random.normal(jax.random.PRNGKey(1), (T_LOG, 3, B_LANES), DT)
    vo = jest.VOData(active=active, dp_body=lanes("dp_body") + noise * active[:, None, :],
                     tick_pre=lanes("tick_pre"), tick_now=lanes("tick_now"))
    act = np.asarray(active)
    assert not np.array_equal(act[:, 0], act[:, 1]) and not act[:, -1].any()
    assert (act[:, :-1].sum(0) >= 4).all()          # every clocked lane interpolates
    data_l = jbatch.tickdata_to_lanes(data_b)
    tdata_l, tvo = (convert.from_jax_numpy(jax.tree.map(np.asarray, a), "cpu", F64)
                    for a in (data_l, vo))
    return data_l, vo, tdata_l, tvo


@functools.lru_cache(maxsize=None)
def _jax_pi_chol(model):
    """The JAX Pallas kernel on per-lane clocks with the Cholesky tail,
    interpret mode: x (T,s,B)."""
    data_l, vo, _, _ = _fleet(model)
    jc = jmhe.make_consts(_params(model)[0], DT)
    return np.asarray(jmrk.replay(jc, data_l, vo, dtype=DT, interpret=True, mk_solve="chol"))


@pytest.mark.parametrize("model", tuple(SHAPES))
def test_pi_chol_matches_pallas_interpret(model):
    """``replay(..., mk_solve="chol")`` with a per-instance ``VOData`` on the
    CPU against the Pallas kernel with ``per_instance=True, mk_solve="chol"``
    in interpret mode: N=5, T=18, B=3, each lane's own Bezier schedule,
    marginalization; and the port's Gauss-Jordan route on the same clocks,
    which returns the same newest state."""
    _, _, tdata_l, tvo = _fleet(model)
    tc = mhe.make_consts(_params(model)[1], F64, device="cpu")
    tx = mrk.replay(tc, tdata_l, tvo, dtype=F64, device="cpu", mk_solve="chol")
    assert tx.shape == (T_LOG, SHAPES[model][0], B_LANES)
    np.testing.assert_allclose(tx.numpy(), _jax_pi_chol(model), **TOL)
    tg = mrk.replay(tc, tdata_l, tvo, dtype=F64, device="cpu", mk_solve="gj")
    assert torch.equal(tx, tg)


@pytest.mark.parametrize("model", tuple(SHAPES))
def test_env_picks_the_tail_on_per_lane_clocks(model, monkeypatch):
    """``DEM_MK_SOLVE=chol`` reaches the per-lane-clock tick through the port's
    lanes runner, which never names the tail, and what it returns is the JAX
    kernel's on those clocks with that tail."""
    _, _, tdata_l, tvo = _fleet(model)
    tp = _params(model)[1]
    seen, ticks = [], mrk.replay_ticks

    def spy(c, ks, data_l, vo, *a, **kw):
        seen.append((kw["mk_solve"], tuple(vo.active.shape)))
        return ticks(c, ks, data_l, vo, *a, **kw)

    monkeypatch.setattr(mrk, "replay_ticks", spy)
    monkeypatch.setenv("DEM_MK_SOLVE", "chol")
    tdata_tb = estimator.TickData(*(torch.movedim(a, -1, 1) for a in tdata_l))
    tx, _ = batch.make_lanes_fleet_runner(tp, F64, use_megakernel=True, device="cpu")(
        tdata_tb, tvo)
    assert seen == [("chol", (T_LOG - 1, B_LANES))]
    np.testing.assert_allclose(tx.numpy(), np.moveaxis(_jax_pi_chol(model), -1, 1), **TOL)


@pytest.mark.parametrize("model", ("go1", "cassie", "pogox"))
def test_pi_chol_units_in_the_chol_library(model):
    """Each shape's Cholesky library holds the per-lane-clock units beside the
    shared-clock ones, with the symbols and defines of the existing scheme; the
    per-lane-clock library keeps its units unchanged; the counter of the new
    kernel is its own."""
    s, m, L, lot = _build.MHE_SHAPES[model]
    assert mrk.kernel_library(s, m, L, lot, True, chol=True) == f"mhe_{model}_chol"
    assert _build.MHE_GROUPS["chol"] == ((0, 0, 1), (1, 0, 1))
    units = _build.UNITS[f"mhe_{model}_chol"]
    assert len(units) == 5 and units[0] == ("mhe", units[1][1][:len(units[0][1])])
    for real, sym in (("float", "f32"), ("double", "f64")):
        flags = next(f for _, f in units if f"-DDEM_MHE_UNIT=dem_mhe_unit_{model}_pi_chol_{sym}"
                     in f)
        assert {f"-DDEM_MHE_REAL={real}", "-DDEM_MHE_CON=0", "-DDEM_MHE_PI=1",
                "-DDEM_MHE_CHOL=1"} <= set(flags)
    pi_units = [f for _, f in _build.UNITS[f"mhe_{model}_pi"][1:]]
    assert [f[-4:] for f in pi_units] == [
        (f"-DDEM_MHE_UNIT=dem_mhe_unit_{model}_pi{box}_{sym}", f"-DDEM_MHE_REAL={real}",
         f"-DDEM_MHE_CON={con}", "-DDEM_MHE_PI=1")
        for con, box in ((0, ""), (1, "_box")) for real, sym in (("float", "f32"),
                                                                 ("double", "f64"))]
    assert mrk._COUNTER[False, True, True] == "launches_pi_chol"


@pytest.mark.parametrize("model", ("go1", "cassie", "pogox"))
def test_work_counts_the_cholesky_tail_on_per_lane_clocks(model):
    """The bound of K2d-PI: every lane on the same clock counts the
    shared-clock Cholesky tick's operations, plus the bytes of the per-lane
    VO metadata and Bezier schedule; lanes on their own clocks count each
    lane's own camera terms; the tail's operations are fewer than
    Gauss-Jordan's on the same clocks."""
    s, m, L, lot = _build.MHE_SHAPES[model]
    T, B = 150, 6
    ticks = np.arange(1, T)
    act = np.stack([(ticks % (5 + b % 3) == 0) & (b != B - 1) for b in range(B)], axis=1)
    pre = np.where(act, np.maximum(ticks - 7, 0)[:, None], 0)
    now = np.where(act, (ticks - 1)[:, None], 0)
    shared = _work.mhe_schedule(act[:, 0].tolist(), pre[:, 0].tolist(), now[:, 0].tolist(), 20)
    same = _work.mhe_lane_schedules(np.repeat(act[:, :1], B, 1), np.repeat(pre[:, :1], B, 1),
                                    np.repeat(now[:, :1], B, 1), 20)
    one = _work.mhe_tick(20, s, m, L, B, shared, 99, 4, lot=lot, tail="chol")
    lanes = _work.mhe_tick_lanes(20, s, m, L, same, 99, 4, lot=lot, tail="chol")
    assert lanes[1] == one[1] and lanes[0] == one[0] + 4 * B * 3 * (T - 1) + 2 * B * (4 * 4 + 4)
    groups = _work.mhe_lane_schedules(act, pre, now, 20)
    own = _work.mhe_tick_lanes(20, s, m, L, groups, 99, 4, lot=lot, tail="chol")
    gj = _work.mhe_tick_lanes(20, s, m, L, groups, 99, 4, lot=lot)
    assert own[0] == gj[0] and 0 < own[1] < gj[1] / 2
