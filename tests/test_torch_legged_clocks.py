"""PyTorch port vs the JAX package: per-lane camera clocks at the Cassie and
PogoX shapes.

Every lane of the fleet follows its own camera clock (its own VO frame rate
and latency; one lane VO-free), at Cassie's shape (foot positions as states,
s=15, m=6, L=2) and PogoX's (s=9, m=3, L=1), from their parameter files. At
float64 on the CPU, unconstrained and with a velocity box that binds: the
JAX mega-kernel with ``per_instance=True`` in interpret mode (the TPU kernels
K2b and K2c on per-lane clocks) against the port's ``mhe_replay_kernel.replay``
(the plain version of its per-lane-clock tick kernels) and the port's eager
``run_mhe_lanes``; and the operation and byte counts of these kernels' bounds.
Inputs are perturbed once on the JAX side and handed to both packages.
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
from decentralized_ekf_mhe_tpu_torch.kernels import _work
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import estimator, mhe, mhe_lanes

torch.set_num_threads(1)

DT = jnp.float64
F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"cassie": (15, 6, 2, 1), "pogox": (9, 3, 1, 0)}   # s, m, L, leg_odom_type
N_WIN, T_LOG, B_LANES, V_BOX = 5, 20, 3, 0.05


def _params(model, box):
    """(JAX params, port params) from the robot's file at window N_WIN; with
    ``box`` fixed rho=5000, polish, OSQP tolerances 1e-8."""
    path = os.path.join(REPO, "configs", f"parameters_{model}.yaml")
    jp, tp = jconfig.load_yaml_params(path)[0], config.load_yaml_params(path)[0]
    for p in (jp, tp):
        p.N = N_WIN
        if box:
            p.osqp.rho, p.osqp.adapt_rho, p.osqp.polish = 5000.0, False, True
            p.osqp.abs_tol = p.osqp.relative_tol = 1e-8
    return jp, tp


@functools.lru_cache(maxsize=None)
def _fleet(model):
    """The robot's log (seed 2) as a JAX-perturbed lanes-layout fleet with a
    camera clock per lane: lane b takes the VO schedule of a log with a frame
    every 3 ticks, 1 + b ticks late, and its own VO-content draw; the last
    lane is VO-free. Returns (JAX data_l, JAX vo, port data_l, port vo)."""
    jp = _params(model, False)[0]
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


def _consts(model, box):
    jp, tp = _params(model, box)
    if not box:
        return jmhe.make_consts(jp, DT), mhe.make_consts(tp, F64, device="cpu")
    ub = np.full(tp.dim_state, np.inf)
    ub[3:6] = V_BOX
    return (jmhe.make_consts(jp, DT, x_lb=-ub, x_ub=ub, admm_iters=20),
            mhe.make_consts(tp, F64, x_lb=-ub, x_ub=ub, admm_iters=20, use_pallas=True,
                            device="cpu"))


@pytest.mark.parametrize("box", [False, True])
@pytest.mark.parametrize("model", tuple(SHAPES))
def test_per_lane_clock_tick_matches_pallas_interpret(model, box):
    """``replay`` on the CPU with a per-instance ``VOData`` (the plain version
    of K2b, with box consts of K2c on per-lane clocks) and the eager
    ``run_mhe_lanes`` against the Pallas kernel with ``per_instance=True`` in
    interpret mode: N=5, T=20, B=3, each lane's own Bezier schedule,
    marginalization; the lanes' schedules end apart."""
    jc, tc = _consts(model, box)
    data_l, vo, tdata_l, tvo = _fleet(model)
    jx = np.asarray(jmrk.replay(jc, data_l, vo, dtype=DT, interpret=True))
    tx = mrk.replay(tc, tdata_l, tvo, dtype=F64, device="cpu")
    assert tx.shape == (T_LOG, SHAPES[model][0], B_LANES)
    np.testing.assert_allclose(tx.numpy(), jx, **TOL)
    ex, _ = estimator.run_mhe_lanes(_params(model, box)[1], tdata_l, vo=tvo, dtype=F64,
                                    consts=tc, device="cpu")
    np.testing.assert_allclose(ex.numpy(), np.moveaxis(jx, -1, 1), **TOL)
    if box:
        v = tx[:, 3:6].abs()
        assert float(v.max()) <= V_BOX + 1e-6 and float(v.max()) >= V_BOX - 1e-6
    # the per-lane schedule: lanes with different clocks end on different
    # Bezier counts, the VO-free lane on none
    d0 = estimator.TickData(*(a[0] for a in tdata_l))
    st0 = mhe_lanes.init(tc, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot, d0.J_foot, d0.dq,
                         d0.contact, dtype=F64, per_instance_vo=True, device="cpu")
    inc = estimator.vo_world_increments(tdata_l.R_sb, tvo)
    _, ks = mrk.replay_ticks(tc, mrk.kernel_state_from_mhe(st0, tc),
                             estimator.TickData(*(a[1:] for a in tdata_l)),
                             estimator.VOData(*(a[1:] for a in tvo)), inc[1:], device="cpu")
    counts = ks.bez_count[0].tolist()
    assert counts[-1] == 0 and counts[0] != counts[1] and min(counts[:-1]) >= 4


@pytest.mark.parametrize("model", tuple(SHAPES))
def test_work_counts_per_lane_clocks_at_the_new_shapes(model):
    """The bound of K2b/K2c-PI at the robot's shape: every lane on the same
    clock counts the shared-clock tick's operations, plus the bytes of the
    per-lane VO metadata and Bezier schedule; lanes on their own clocks count
    each lane's own camera terms and Bezier work."""
    s, m, L, lot = SHAPES[model]
    T, B = 150, 6
    ticks = np.arange(1, T)
    act = np.stack([(ticks % (5 + b % 3) == 0) & (b != B - 1) for b in range(B)], axis=1)
    pre = np.where(act, np.maximum(ticks - 7, 0)[:, None], 0)
    now = np.where(act, (ticks - 1)[:, None], 0)
    shared = _work.mhe_schedule(act[:, 0].tolist(), pre[:, 0].tolist(), now[:, 0].tolist(), 20)
    same = _work.mhe_lane_schedules(np.repeat(act[:, :1], B, 1), np.repeat(pre[:, :1], B, 1),
                                    np.repeat(now[:, :1], B, 1), 20)
    assert len(same) == 1 and same[0][0] == B
    one = _work.mhe_tick(20, s, m, L, B, shared, 99, 4, lot=lot)
    lanes = _work.mhe_tick_lanes(20, s, m, L, same, 99, 4, lot=lot)
    assert lanes[1] == one[1] and lanes[0] == one[0] + 4 * B * 3 * (T - 1) + 2 * B * (4 * 4 + 4)
    groups = _work.mhe_lane_schedules(act, pre, now, 20)
    assert len(groups) == 4 and sum(n for n, _ in groups) == B     # 3 clocks + VO-free
    own = _work.mhe_tick_lanes(20, s, m, L, groups, 99, 4, lot=lot)
    no_vo = np.zeros_like(act)
    free = _work.mhe_tick_lanes(20, s, m, L, _work.mhe_lane_schedules(no_vo, pre, now, 20), 99,
                                4, lot=lot)
    assert own[0] == lanes[0] and own[1] > free[1]
