"""PyTorch port vs the JAX package: per-instance VO clocks.

Every lane of a Monte-Carlo fleet follows its own camera clock: the VO events'
timing differs per lane, not only their content. The fleet is built as
``tests/test_per_instance_vo.py`` builds it (one synthetic log per lane with
its own ``vo_every``/``vo_latency``, one lane VO-free, per-lane accel noise and
VO content) and handed to both packages as numpy arrays. Held against the JAX
package at float64 on the CPU: the per-instance Bezier schedule, the masked
per-instance MHE tick, the fleet replay, the plain version of the
per-lane-clock ``mhe_tick`` kernels (unconstrained against the Pallas kernel
in interpret mode, constrained against the JAX scan that the JAX tests hold
the Pallas kernel to), the per-lane EKF replay, and the conversions; uniform
per-lane clocks reproduce the shared-clock path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu.config import EKFParams as JEKFParams
from decentralized_ekf_mhe_tpu.config import EstimatorParams as JParams
from decentralized_ekf_mhe_tpu.io import synth as jsynth
from decentralized_ekf_mhe_tpu.ops import bezier as jbez
from decentralized_ekf_mhe_tpu.ops import ekf_lanes as jekf
from decentralized_ekf_mhe_tpu.ops import estimator as jest
from decentralized_ekf_mhe_tpu.ops import kf as jkf
from decentralized_ekf_mhe_tpu.ops import lanes as jlanes
from decentralized_ekf_mhe_tpu.ops import mhe as jmhe
from decentralized_ekf_mhe_tpu.ops import mhe_lanes as jml
from decentralized_ekf_mhe_tpu.pallas import mhe_replay_kernel as jmrk
from decentralized_ekf_mhe_tpu.parallel import batch as jbatch
from decentralized_ekf_mhe_tpu_torch import convert
from decentralized_ekf_mhe_tpu_torch.config import EKFParams, EstimatorParams
from decentralized_ekf_mhe_tpu_torch.kernels import _work
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import bezier, ekf_lanes, estimator, mhe, mhe_lanes
from decentralized_ekf_mhe_tpu_torch.parallel import batch

torch.set_num_threads(1)

DT = jnp.float64
F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-8)
TOL_EKF = dict(rtol=1e-10, atol=1e-12)
N_WIN, T_LOG, B_LANES = 6, 28, 4
V_BOX = 0.12          # binds: the unconstrained fleet reaches |v| = 0.167


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return convert.from_jax_numpy(_np(tree), "cpu", F64)


def _params(cls, N=N_WIN):
    return cls(num_legs=4, leg_odom_type=0, rate=200, N=N)


def _box_params(cls, N=N_WIN):
    p = cls(num_legs=4, leg_odom_type=0, rate=200, N=N, foot_swing_std=[1e7] * 3)
    p.osqp.abs_tol = p.osqp.relative_tol = 1e-8
    return p


def _logs(T, B, seed):
    """One log per lane: the same trajectory and IMU/encoder streams (same
    seed), each lane its own camera clock."""
    return [jsynth.generate(jsynth.SynthConfig(
        T=T, seed=seed, vo_every=3 + b % 3, vo_latency=1 + b % 2)) for b in range(B)]


@functools.lru_cache(maxsize=None)
def _ekf_stage(T=T_LOG, B=B_LANES, seed=11):
    """The EKF half of the fleet: perturbed IMU blocks with each lane's own
    delayed-VO events ((T,S,B) timing, (T,S,4,B) quaternions; the last lane
    VO-free), and the JAX orientation the per-lane EKF scan gives:
    (eb, q (T,4,B), torch eb)."""
    logs = _logs(T, B, seed)
    lane = [jest.ekfblocks_from_log(lg, dtype=DT) for lg in logs]
    act = jnp.stack([e.vo_active for e in lane], axis=-1).at[..., -1].set(False)
    eb = jbatch.perturb_ekf_blocks(lane[0], B, jax.random.PRNGKey(seed), dtype=DT)._replace(
        vo_active=act, vo_q=jnp.stack([e.vo_q for e in lane], axis=-1),
        vo_steps_back=jnp.stack([e.vo_steps_back for e in lane], axis=-1))
    _, q = jest.scan_ekf_blocks(jekf.init_state(JEKFParams(), B, ring_len=16, dtype=DT), eb,
                                jekf.make_consts(JEKFParams(), DT))
    assert bool(act.any()) and not np.array_equal(np.asarray(act[..., 0]), np.asarray(act[..., 1]))
    return eb, q, _t(eb)


@functools.lru_cache(maxsize=None)
def _mixed_fleet(T=T_LOG, B=B_LANES, seed=11):
    """Lanes-layout JAX fleet with a camera clock per lane (the last lane
    VO-free), its orientation from the per-lane EKF stage, and its torch twin:
    (data_l, vo_l, tdata_l, tvo_l)."""
    rng = np.random.default_rng(seed)
    logs = _logs(T, B, seed)
    datas, vos = [], []
    for b, lg in enumerate(logs):
        d = jest.tickdata_from_log(logs[0], dtype=DT)
        datas.append(d._replace(accel_b=d.accel_b + 0.01 * rng.standard_normal((T, 3))))
        v = jest.vodata_from_log(lg, dtype=DT)
        if b == B - 1:
            v = v._replace(active=jnp.zeros(T, bool))
        else:
            v = v._replace(dp_body=v.dp_body + 1e-4 * rng.standard_normal((T, 3)))
        vos.append(v)
    data_b = jax.tree.map(lambda *a: jnp.stack(a), *datas)          # (B,T,...)
    vo_b = jax.tree.map(lambda *a: jnp.stack(a), *vos)
    data_l = jbatch.tickdata_to_lanes(jbatch.to_time_leading(data_b))
    data_l = data_l._replace(R_sb=jekf.to_rot(_ekf_stage(T, B, seed)[1]))
    vo_l = jest.VOData(
        active=jnp.swapaxes(vo_b.active, 0, 1),                      # (T,B)
        dp_body=jnp.moveaxis(vo_b.dp_body, 0, -1),                   # (T,3,B)
        tick_pre=jnp.swapaxes(vo_b.tick_pre, 0, 1),
        tick_now=jnp.swapaxes(vo_b.tick_now, 0, 1))
    # the clocks genuinely differ, and every lane with events interpolates
    act = np.asarray(vo_l.active)
    assert not np.array_equal(act[:, 0], act[:, 1]) and not act[:, -1].any()
    assert (act[:, :-1].sum(0) >= 4).all()
    return data_l, vo_l, _t(data_l), _t(vo_l)


@functools.lru_cache(maxsize=None)
def _jax_replay(box):
    """The JAX fleet replay on the mixed fleet, (x (T,B,s), v (T,B,3)):
    unconstrained through the Pallas kernel with per_instance=True in
    interpret mode (chunk=9: the per-lane Bezier schedule crosses
    pallas_call invocations), with a binding velocity box through
    ``run_mhe_lanes`` (the scan the JAX tests hold that kernel to)."""
    data_l, vo_l, _, _ = _mixed_fleet()
    if box:
        return jest.run_mhe_lanes(_box_params(JParams), data_l, vo=vo_l, dtype=DT,
                                  consts=_consts(True, jax_side=True))
    x = jmrk.replay(_consts(False, jax_side=True), data_l, vo_l, dtype=DT, chunk=9,
                    interpret=True)                               # (T,s,B)
    lever = jnp.asarray(jkf.DEFAULT_LEVER_ARM, DT)[:, None] * jnp.ones((1, B_LANES), DT)
    v = jlanes.mv(data_l.R_sb, x[:, 3:6] + jlanes.cross(data_l.omega_b, lever))
    return jnp.moveaxis(x, -1, 1), jnp.moveaxis(v, -1, 1)


def _consts(box, jax_side=False, use_pallas=False):
    if not box:
        return (jmhe.make_consts(_params(JParams), DT) if jax_side
                else mhe.make_consts(_params(EstimatorParams), F64,
                                     use_pallas=use_pallas, device="cpu"))
    hi = np.full(9, np.inf)
    hi[3:6] = V_BOX
    if jax_side:
        return jmhe.make_consts(_box_params(JParams), DT, x_lb=-hi, x_ub=hi,
                                admm_iters=30)
    return mhe.make_consts(_box_params(EstimatorParams), F64, x_lb=-hi, x_ub=hi,
                           admm_iters=30, use_pallas=use_pallas, device="cpu")


def test_bezier_masked_push_and_eval_match_jax():
    rng = np.random.default_rng(3)
    B = 5
    jc, tc = jbez.init(DT, batch=(B,), per_instance_schedule=True), bezier.init(
        F64, batch=(B,), per_instance_schedule=True, device="cpu")
    assert tuple(tc.times.shape) == (B, 4) and tuple(tc.count.shape) == (B,)
    for k in range(7):
        p = rng.standard_normal((B, 3))
        t_end = rng.random(B) + k
        mask = rng.random(B) > 0.3
        jc = jbez.add_way_point(jc, jnp.asarray(p), jnp.asarray(t_end), mask=jnp.asarray(mask))
        tc = bezier.add_way_point(tc, torch.as_tensor(p), torch.as_tensor(t_end),
                                  mask=torch.as_tensor(mask))
        assert np.array_equal(tc.count.numpy(), np.asarray(jc.count))
        for f in ("pts", "times"):
            np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                       rtol=1e-12, atol=1e-12)
    counts = tc.count.numpy()
    assert counts.min() < counts.max() and counts.max() >= 4   # lanes went apart
    u = rng.random((B, 6))
    np.testing.assert_allclose(bezier.eval_at(tc, torch.as_tensor(u)).numpy(),
                               np.asarray(jbez.eval_at(jc, jnp.asarray(u))),
                               rtol=1e-12, atol=1e-12)


def test_step_per_instance_vo_over_the_log():
    """mhe_lanes.step_per_instance_vo tick by tick over the log (R_pre
    gathered per lane as the JAX runner gathers it): every tick's newest
    state against the JAX kernel; the lanes end on different Bezier
    schedules and camera terms."""
    data_l, vo_l, tdata_l, tvo = _mixed_fleet()
    jx = np.asarray(_jax_replay(False)[0])                       # (T,B,s)
    tc = _consts(False)
    R_pre = jnp.take_along_axis(data_l.R_sb, vo_l.tick_pre[:, None, None, :], axis=0)
    tR_pre = torch.as_tensor(np.array(R_pre))
    t0 = estimator.TickData(*(a[0] for a in tdata_l))
    tst = mhe_lanes.init(tc, t0.R_sb, t0.accel_b, t0.omega_b, t0.p_foot, t0.J_foot,
                         t0.dq, t0.contact, dtype=F64, per_instance_vo=True, device="cpu")
    for t in range(1, T_LOG):
        td = estimator.TickData(*(a[t] for a in tdata_l))
        tst, (tx, _, it) = mhe_lanes.step_per_instance_vo(
            tc, tst, td.R_sb, td.accel_b, td.omega_b, td.p_foot, td.J_foot, td.dq,
            td.contact, tvo.active[t], tvo.dp_body[t], tvo.tick_pre[t],
            tvo.tick_now[t], tR_pre[t])
        assert it is None
        np.testing.assert_allclose(tx.numpy().T, jx[t], err_msg=str(t), **TOL)
    counts = tst.bez.count.numpy()
    assert counts[-1] == 0 and counts[:-1].min() >= 4 and len(set(counts)) > 2
    cam = tst.cam_active.numpy()
    assert cam[:, :-1].any() and not cam[:, -1].any()


@pytest.mark.parametrize("box", [False, True])
def test_run_mhe_lanes_per_instance_matches_jax(box):
    """estimator.run_mhe_lanes with a per-instance VOData (x and v),
    unconstrained and with a velocity box that binds."""
    _, _, tdata_l, tvo = _mixed_fleet()
    jx, jv = _jax_replay(box)
    p = _box_params(EstimatorParams) if box else _params(EstimatorParams)
    tx, tv = estimator.run_mhe_lanes(p, tdata_l, vo=tvo, dtype=F64, consts=_consts(box),
                                     device="cpu")
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    if box:
        v = np.abs(tx.numpy()[..., 3:6])
        assert V_BOX - 1e-6 <= v.max() <= V_BOX + 1e-6


def test_replay_plain_matches_pallas_interpret():
    """The plain version of the per-lane-clock mhe_tick kernel (the CPU path
    of kernels.mhe_replay_kernel.replay, tick 0 through the tridiag_solve
    wrapper) == the Pallas kernel with per_instance=True in interpret mode."""
    _, _, tdata_l, tvo = _mixed_fleet()
    before = (mrk.launches, mrk.launches_pi)
    tx = mrk.replay(_consts(False, use_pallas=True), tdata_l, tvo, dtype=F64, device="cpu")
    assert (mrk.launches, mrk.launches_pi) == before     # CPU: no launch
    np.testing.assert_allclose(torch.movedim(tx, -1, 1).numpy(), np.asarray(_jax_replay(False)[0]),
                               **TOL)


def test_constrained_replay_plain_matches_jax():
    """The plain version of the constrained per-lane-clock kernel (tick 0
    through the admm_solve wrapper) == the JAX constrained per-instance scan,
    which tests/test_megakernel.py holds the Pallas kernel to; the per-tick
    ADMM iterations come back per lane."""
    _, _, tdata_l, tvo = _mixed_fleet()
    jx, _ = _jax_replay(True)
    tc = _consts(True, use_pallas=True)
    tx = mrk.replay(tc, tdata_l, tvo, dtype=F64, device="cpu")
    np.testing.assert_allclose(torch.movedim(tx, -1, 1).numpy(), np.asarray(jx), **TOL)
    st0, vo_inc, ks0 = _tick0(tc, tdata_l, tvo)
    _, ks = mrk.replay_ticks(tc, ks0, *_seg(tdata_l, tvo, vo_inc, slice(1, None)),
                             device="cpu")
    assert tuple(ks.iters.shape) == (T_LOG - 1, B_LANES) and int(ks.iters.min()) >= 1


def _tick0(c, tdata_l, tvo):
    d0 = estimator.TickData(*(a[0] for a in tdata_l))
    st0 = mhe_lanes.init(c, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot, d0.J_foot,
                         d0.dq, d0.contact, dtype=F64,
                         per_instance_vo=tvo.active.ndim == 2, device="cpu")
    vo_inc = estimator.vo_world_increments(tdata_l.R_sb, tvo)
    return st0, vo_inc, mrk.kernel_state_from_mhe(st0, c)


def _seg(tdata_l, tvo, vo_inc, sl):
    return (estimator.TickData(*(a[sl].contiguous() for a in tdata_l)),
            estimator.VOData(*(a[sl] for a in tvo)), vo_inc[sl].contiguous())


@pytest.mark.parametrize("box", [False, True])
def test_split_log_and_state_round_trip(box):
    """A log split over two replay_ticks calls equals one call, and the
    kernel state's per-lane Bezier schedule ((4,B), (1,B)) round-trips
    through kernel_state_from_mhe / mhe_state_from_kernel."""
    _, _, tdata_l, tvo = _mixed_fleet()
    tc = _consts(box)
    st0, vo_inc, ks0 = _tick0(tc, tdata_l, tvo)
    assert tuple(ks0.bez_times.shape) == (4, B_LANES) and tuple(ks0.bez_count.shape) == (1, B_LANES)
    x_all, ks_all = mrk.replay_ticks(tc, ks0, *_seg(tdata_l, tvo, vo_inc, slice(1, None)),
                                     device="cpu")
    xA, ksA = mrk.replay_ticks(tc, ks0, *_seg(tdata_l, tvo, vo_inc, slice(1, 13)), device="cpu")
    xB, ksB = mrk.replay_ticks(tc, ksA, *_seg(tdata_l, tvo, vo_inc, slice(13, None)),
                               device="cpu")
    assert ksA.t == 12 and ksB.t == ks_all.t == T_LOG - 1
    np.testing.assert_allclose(torch.cat([xA, xB]).numpy(), x_all.numpy(), rtol=1e-11, atol=1e-11)
    assert torch.equal(ksB.bez_count, ks_all.bez_count)
    np.testing.assert_allclose(ksB.bez_times.numpy(), ks_all.bez_times.numpy(), rtol=1e-12)
    counts = ks_all.bez_count[0].numpy()
    assert counts[-1] == 0 and counts[:-1].min() >= 4 and len(set(counts)) > 2
    # round trip: the per-lane schedule and the window come back unchanged
    back = mrk.mhe_state_from_kernel(ks_all, tc)
    assert tuple(back.bez.times.shape) == (B_LANES, 4) and tuple(back.bez.count.shape) == (B_LANES,)
    again = mrk.kernel_state_from_mhe(back, tc)
    assert again.t == ks_all.t and torch.equal(again.bez_count, ks_all.bez_count)
    assert torch.equal(again.bez_times, ks_all.bez_times)
    for a, b in zip(again.arrays[:15], ks_all.arrays[:15]):
        assert torch.equal(a, b)
    # a per-lane clock needs a per-lane schedule, and the reverse
    d1 = _seg(tdata_l, tvo, vo_inc, slice(1, 4))
    ks_shared = mrk.kernel_state_from_mhe(
        mhe_lanes.init(tc, *(a[0] for a in (tdata_l.R_sb, tdata_l.accel_b, tdata_l.omega_b,
                                            tdata_l.p_foot, tdata_l.J_foot, tdata_l.dq,
                                            tdata_l.contact)), dtype=F64, device="cpu"), tc)
    with pytest.raises(ValueError, match="per_instance_vo=True"):
        mrk.replay_ticks(tc, ks_shared, *d1, device="cpu")
    shared_vo = estimator.VOData(*(a[:, 0] if a.ndim == 2 else a[..., 0] for a in d1[1]))
    with pytest.raises(ValueError, match="Bezier schedule"):
        mrk.replay_ticks(tc, ks0, d1[0], shared_vo, d1[2], device="cpu")


def test_uniform_per_lane_clocks_reproduce_shared():
    """A per-instance VOData whose lanes all carry the fleet's clock
    (perturb_vo_batch(per_instance_timing=True)) reproduces the shared-clock
    path: the eager replay, the plain kernel replay, and the EKF stage."""
    T, B = 22, 3
    log = jsynth.generate(jsynth.SynthConfig(T=T, seed=2))
    jdata = jest.tickdata_from_log(log, dtype=DT)
    data_b = jbatch.to_time_leading(jbatch.perturb_log_batch(jdata, B, jax.random.PRNGKey(0),
                                                             dtype=DT))
    eb = jbatch.perturb_ekf_blocks(jest.ekfblocks_from_log(log, dtype=DT), B,
                                   jax.random.PRNGKey(1), dtype=DT, vo_noise_scale=1.0)
    tdata_l = _t(jbatch.tickdata_to_lanes(data_b))
    vo = estimator.vodata_from_log(log, dtype=F64, device="cpu")
    vo_shared = batch.perturb_vo_batch(vo, B, torch.Generator().manual_seed(4), dtype=F64)
    vo_pi = batch.perturb_vo_batch(vo, B, torch.Generator().manual_seed(4), dtype=F64,
                                   per_instance_timing=True)
    assert vo_pi.active.shape == (T, B) and torch.equal(vo_pi.dp_body, vo_shared.dp_body)
    p = _params(EstimatorParams, N=5)
    c = mhe.make_consts(p, F64, use_pallas=True, device="cpu")
    tight = dict(rtol=1e-11, atol=1e-11)
    x_s, v_s = estimator.run_mhe_lanes(p, tdata_l, vo=vo_shared, dtype=F64, consts=c, device="cpu")
    x_p, v_p = estimator.run_mhe_lanes(p, tdata_l, vo=vo_pi, dtype=F64, consts=c, device="cpu")
    np.testing.assert_allclose(x_p.numpy(), x_s.numpy(), **tight)
    np.testing.assert_allclose(v_p.numpy(), v_s.numpy(), **tight)
    np.testing.assert_allclose(mrk.replay(c, tdata_l, vo_pi, dtype=F64, device="cpu").numpy(),
                               mrk.replay(c, tdata_l, vo_shared, dtype=F64, device="cpu").numpy(),
                               **tight)
    # the EKF stage with the shared clock broadcast per lane
    teb = _t(eb)
    S = teb.valid.shape[1]
    teb_pi = teb._replace(vo_active=teb.vo_active[..., None].expand(T, S, B),
                          vo_steps_back=teb.vo_steps_back[..., None].expand(T, S, B))
    ec = ekf_lanes.make_consts(EKFParams(), F64)
    st = ekf_lanes.init_state(EKFParams(), B, 16, F64, device="cpu")
    _, q_s = estimator.scan_ekf_blocks(st, teb, ec)
    _, q_p = estimator.scan_ekf_blocks(st, teb_pi, ec)
    np.testing.assert_allclose(q_p.numpy(), q_s.numpy(), rtol=1e-12, atol=1e-14)


def _ekf_lane_streams(B=3, T=24):
    """Per-lane EKF VO event streams (timing, content, steps-back differ per
    lane; the last lane VO-free) on one IMU stream, as numpy: the (T_ekf,...)
    lanes arrays of tests/test_per_instance_vo.py."""
    logs = [jsynth.generate(jsynth.SynthConfig(T=T, seed=20, vo_every=4 + b, vo_latency=1 + b % 2))
            for b in range(B)]
    act = np.stack([lg.ekf_vo_active for lg in logs], -1)
    act[:, -1] = False
    rng = np.random.default_rng(0)
    return dict(
        gyro=np.repeat(logs[0].ekf_gyro[..., None], B, -1),
        accel=logs[0].ekf_accel[..., None] + 1e-3 * rng.standard_normal(logs[0].ekf_accel.shape + (B,)),
        act=act,
        q=np.stack([lg.ekf_vo_q for lg in logs], -1),
        sb=np.stack([lg.ekf_vo_steps_back for lg in logs], -1).astype(np.int32),
        logs=logs)


def test_ekf_tick_per_lane_matches_jax():
    """ekf_lanes.tick with per-lane VO (the masked _replay_per_lane) against
    JAX substep by substep; lanes on different schedules, one VO-free."""
    s = _ekf_lane_streams()
    jc = jekf.make_consts(JEKFParams(), DT)
    tc = ekf_lanes.make_consts(EKFParams(), F64)
    B = s["act"].shape[1]
    jst = jekf.init_state(JEKFParams(), B, ring_len=16, dtype=DT)
    tst = ekf_lanes.init_state(EKFParams(), B, 16, F64, device="cpu")
    tick = jax.jit(lambda st, g, a, va, qv, sb: jekf.tick(st, g, a, va, qv, sb, jc))
    n_replays = 0
    for k in range(s["act"].shape[0]):
        args = [s[f][k] for f in ("gyro", "accel", "act", "q", "sb")]
        jst = tick(jst, *(jnp.asarray(a) for a in args))
        tst = ekf_lanes.tick(tst, *(torch.as_tensor(a) for a in args), tc)
        n_replays += int(s["act"][k].any())
        np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), err_msg=str(k), **TOL_EKF)
        np.testing.assert_allclose(tst.P.numpy(), np.asarray(jst.P), err_msg=str(k), **TOL_EKF)
    assert n_replays > 3
    assert not np.array_equal(s["act"][:, 0], s["act"][:, 1])


def test_pipeline_per_lane_clocks_matches_jax():
    """The slice as a whole on the fleet whose lanes follow their own camera
    clocks in both stages: the pipeline runner (use_megakernel) takes
    estimator.scan_ekf_blocks for the per-lane EKF timing and the plain
    version of the per-lane-clock mhe_tick kernel for the per-instance MHE
    VOData; the JAX side is its per-lane EKF scan and the Pallas kernel in
    interpret mode on that orientation — what the JAX runner composes.
    q to 1e-10/1e-12, x and v to 1e-8."""
    _, jq, teb = _ekf_stage()
    jx, jv = _jax_replay(False)
    _, _, tdata_l, tvo = _mixed_fleet()
    data_tb = estimator.TickData(*(torch.movedim(a, -1, 1) for a in tdata_l))
    run = batch.make_pipeline_fleet_runner(_params(EstimatorParams), EKFParams(), F64,
                                           use_megakernel=True, device="cpu")
    tx, tv, tq = run(data_tb, teb, tvo)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL_EKF)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    # the runner's EKF stage is scan_ekf_blocks
    st = ekf_lanes.init_state(EKFParams(), B_LANES, 16, F64, device="cpu")
    _, q2 = estimator.scan_ekf_blocks(st, teb, ekf_lanes.make_consts(EKFParams(), F64))
    assert torch.equal(q2, tq)


def test_pipeline_shared_ekf_clock_per_lane_mhe_clocks():
    """The fleet the EKF kernel takes (shared EKF clock) with a per-instance
    MHE VOData: the runner's kernel route (EKF stage wrapper, per-lane-clock
    MHE tick wrapper) equals its eager route on the CPU."""
    _, _, tdata_l, tvo = _mixed_fleet()
    log = _logs(T_LOG, 1, 11)[0]
    eb = _t(jbatch.perturb_ekf_blocks(jest.ekfblocks_from_log(log, dtype=DT), B_LANES,
                                      jax.random.PRNGKey(3), dtype=DT, vo_noise_scale=1.0))
    assert eb.vo_active.ndim == 2 and eb.vo_q.ndim == 4
    data_tb = estimator.TickData(*(torch.movedim(a, -1, 1) for a in tdata_l))
    p, pe = _params(EstimatorParams), EKFParams()
    xk, vk, qk = batch.make_pipeline_fleet_runner(p, pe, F64, use_megakernel=True,
                                                  device="cpu")(data_tb, eb, tvo)
    xe, ve, qe = batch.make_pipeline_fleet_runner(p, pe, F64, use_pallas=False,
                                                  device="cpu")(data_tb, eb, tvo)
    np.testing.assert_allclose(qk.numpy(), qe.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(xk.numpy(), xe.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(vk.numpy(), ve.numpy(), rtol=1e-10, atol=1e-10)


def test_perturb_vo_batch_per_instance_timing():
    """per_instance_timing broadcasts the shared clock to every lane and
    draws the same content as the shared form."""
    from decentralized_ekf_mhe_tpu_torch.io import synth

    T, B = 30, 6
    vo = estimator.vodata_from_log(synth.generate(synth.SynthConfig(T=T, seed=1)),
                                   dtype=F64, device="cpu")
    g = lambda: torch.Generator().manual_seed(9)
    shared = batch.perturb_vo_batch(vo, B, g(), dtype=F64)
    pi = batch.perturb_vo_batch(vo, B, g(), dtype=F64, per_instance_timing=True)
    assert pi.active.shape == pi.tick_pre.shape == pi.tick_now.shape == (T, B)
    assert pi.dp_body.shape == (T, 3, B) and torch.equal(pi.dp_body, shared.dp_body)
    for f in ("active", "tick_pre", "tick_now"):
        assert torch.equal(getattr(pi, f), getattr(vo, f)[:, None].expand(T, B)), f
    assert pi.active.dtype == torch.bool and pi.tick_pre.dtype == vo.tick_pre.dtype


def test_convert_per_instance_state_and_vodata():
    """from_jax_numpy on a JAX window state with a per-lane Bezier schedule
    and on a per-lane VOData keeps every leaf."""
    data_l, vo_l, _, tvo = _mixed_fleet()
    d0 = jax.tree.map(lambda a: a[0], data_l)
    jst = jml.init(_consts(False, jax_side=True), d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot,
                   d0.J_foot, d0.dq, d0.contact, dtype=DT, per_instance_vo=True)
    rng = np.random.default_rng(1)
    bez = jst.bez
    for k in range(6):
        bez = jbez.add_way_point(bez, jnp.asarray(rng.standard_normal((B_LANES, 3))),
                                 jnp.asarray(k + rng.random(B_LANES)),
                                 mask=jnp.asarray(rng.random(B_LANES) > 0.4))
    jst = jst._replace(bez=bez, T=jnp.asarray(9, jnp.int32))
    tst = _t(jst)
    assert tst.T == 9 and tuple(tst.bez.count.shape) == (B_LANES,)
    assert tst.bez.count.dtype == torch.int32 and len(set(tst.bez.count.tolist())) > 1
    for f in ("pts", "times", "count", "p_accum"):
        assert np.array_equal(getattr(tst.bez, f).numpy(), np.asarray(getattr(jst.bez, f))), f
    ks = mrk.kernel_state_from_mhe(tst, _consts(False))
    assert tuple(ks.bez_times.shape) == (4, B_LANES)
    assert np.array_equal(ks.bez_count[0].numpy(), np.asarray(jst.bez.count))
    assert tvo.active.dtype == torch.bool and tuple(tvo.tick_pre.shape) == (T_LOG, B_LANES)
    assert np.array_equal(tvo.tick_now.numpy(), np.asarray(vo_l.tick_now))


def test_work_per_lane_schedules():
    """_work counts each lane's own schedule: uniform per-lane clocks give the
    shared count, mixed clocks the sum of each lane's count alone."""
    Tn, N, B = 40, 20, 5
    ticks = np.arange(1, Tn + 1)

    def clock(every, lat):
        act = (ticks % every == 0) & (ticks > lat)
        return act, np.maximum(ticks - lat - every, 0), ticks - lat

    shared = clock(4, 2)
    sched = _work.mhe_schedule(*(a.tolist() for a in shared), N)
    groups = _work.mhe_lane_schedules(*(np.repeat(a[:, None], B, 1) for a in shared), N)
    assert len(groups) == 1 and groups[0][0] == B
    b1, f1 = _work.mhe_tick(N, 9, 12, 4, B, sched, 11, 4)
    b2, f2 = _work.mhe_tick_lanes(N, 9, 12, 4, groups, 11, 4)
    assert f2 == f1 and b2 == b1 + 4 * B * 3 * Tn + 2 * B * (4 * 4 + 4)

    clocks = [clock(4, 2), clock(5, 1), clock(3, 2), clock(4, 2), (np.zeros(Tn, bool),) * 3]
    cols = [np.stack([c[k] for c in clocks], 1) for k in range(3)]
    groups = _work.mhe_lane_schedules(*cols, N)
    assert sorted(n for n, _ in groups) == [1, 1, 1, 2]
    lanes = sum(_work.mhe_tick(N, 9, 12, 4, 1, _work.mhe_schedule(
        *(a.tolist() for a in c), N), 0, 4)[1] for c in clocks)
    assert _work.mhe_tick_lanes(N, 9, 12, 4, groups, 0, 4)[1] == lanes
    # a VO-free lane still counts every tick's assembly and solve
    assert _work.mhe_tick(N, 9, 12, 4, 1, _work.mhe_schedule(*(a.tolist() for a in clocks[-1]),
                                                            N), 0, 4)[1] > 0
    # constrained: the ADMM work follows the iterations, not the clocks
    iters = np.full((Tn, B), 20)
    box = (iters, 10, False, True, True)
    _, fb = _work.mhe_tick_lanes(N, 9, 12, 4, groups, 0, 4, box=box)
    _, fs = _work.mhe_tick_lanes(N, 9, 12, 4, groups, 0, 4)
    assert fb > fs
