"""PyTorch port vs the JAX package: the stateful facade (``ops/facade.py``).

Every case of ``tests/test_facade.py`` on the port with ``device="cpu"`` at
float64, held against the JAX facade driven with the same numpy inputs
(atol 1e-9, the JAX test's tolerance) and against the port's own offline
drivers. ``PipelineEstimator`` runs with ``use_pallas=True``, where the CPU
takes the block-tridiagonal kernel's plain version every tick, and once with
box consts, where it takes the box-ADMM kernel's plain version; the JAX side
runs its plain solves (the Pallas kernels need a TPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu.config import EKFParams as JEKFParams
from decentralized_ekf_mhe_tpu.config import EstimatorParams as JParams
from decentralized_ekf_mhe_tpu.io import synth
from decentralized_ekf_mhe_tpu.ops import facade as jfacade
from decentralized_ekf_mhe_tpu_torch.config import EKFParams, EstimatorParams
from decentralized_ekf_mhe_tpu_torch.kernels import admm_kernel, tridiag_kernel
from decentralized_ekf_mhe_tpu_torch.ops import estimator
from decentralized_ekf_mhe_tpu_torch.ops.facade import DecentralizedEstimator, PipelineEstimator

torch.set_num_threads(1)

F64 = torch.float64
CPU = "cpu"
ATOL = 1e-9


def _params(cls, est_type=0, N=8):
    return cls(num_legs=4, leg_odom_type=0, rate=200, N=N, est_type=est_type,
               foot_swing_std=[1e7] * 3)


def _tick_args(log, k):
    return (log.R_sb_gt[k], log.accel_b[k], log.omega_b[k], log.p_foot[k],
            log.J_foot[k], log.dq[k], log.contact[k])


def _vo(log, k):
    return dict(vo_active=bool(log.vo_active[k]), vo_dp=log.vo_dp_body[k],
                vo_tick_pre=int(log.vo_tick_pre[k]), vo_tick_now=int(log.vo_tick_now[k]))


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _per_tick(est, log, T, vo=True, events=None):
    """initialize at tick 0, then update ticks 1..T-1; x after each."""
    est.initialize(*_tick_args(log, 0))
    xs = [_np(est.x)]
    for k in range(1, T):
        kw = _vo(log, k) if vo else {}
        if events is not None:
            va, vdp, vtp, vtn = events
            kw = dict(vo_active=bool(va[k]), vo_dp=vdp[k], vo_tick_pre=int(vtp[k]),
                      vo_tick_now=int(vtn[k]))
        est.update(*_tick_args(log, k), **kw)
        xs.append(_np(est.x))
    return np.stack(xs)


def _both(est_type=0, N=8, **kw):
    """(port estimator on the CPU, JAX estimator), float64."""
    return (DecentralizedEstimator(_params(EstimatorParams, est_type, N), dtype=F64,
                                   device=CPU, **kw),
            jfacade.DecentralizedEstimator(_params(JParams, est_type, N),
                                           dtype=jnp.float64, **kw))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_facade_mhe_matches_jax_and_scan(use_pallas):
    T = 30
    log = synth.generate(synth.SynthConfig(T=T, seed=1))
    est, jest = _both(0, use_pallas=use_pallas)
    xs = _per_tick(est, log, T)
    np.testing.assert_allclose(xs, _per_tick(jest, log, T), atol=ATOL)
    x_scan, _ = estimator.run_mhe(
        _params(EstimatorParams), estimator.tickdata_from_log(log, device=CPU),
        vo=estimator.vodata_from_log(log, device=CPU), device=CPU)
    np.testing.assert_allclose(xs, x_scan.numpy(), atol=ATOL)
    assert est.v_body.shape == (3,) and est.T == T


def test_facade_kf_matches_jax_and_scan():
    T = 25
    log = synth.generate(synth.SynthConfig(T=T, seed=2))
    est, jest = _both(1)
    xs = _per_tick(est, log, T, vo=False)
    np.testing.assert_allclose(xs, _per_tick(jest, log, T, vo=False), atol=ATOL)
    x_scan, _ = estimator.run_kf(_params(EstimatorParams, 1),
                                 estimator.tickdata_from_log(log, device=CPU), device=CPU)
    np.testing.assert_allclose(xs, x_scan.numpy(), atol=ATOL)
    np.testing.assert_allclose(_np(est.v_body), _np(jest.v_body), atol=ATOL)


def test_facade_vo_past_ring_length():
    """With a tiny orientation ring, VO lookups far past the ring length
    still read the right R_pre: tick counters stay absolute."""
    T = 64
    log = synth.generate(synth.SynthConfig(T=T, seed=6, vo_every=5, vo_latency=2))
    est, jest = _both(0, N=6, history_ticks=16)
    xs = _per_tick(est, log, T)
    np.testing.assert_allclose(xs, _per_tick(jest, log, T), atol=ATOL)
    assert int(np.asarray(log.vo_tick_pre).max()) > 16


def test_facade_vo_predating_ring_raises():
    log = synth.generate(synth.SynthConfig(T=40, seed=6))
    est = DecentralizedEstimator(_params(EstimatorParams, 0, 6), dtype=F64,
                                 history_ticks=8, device=CPU)
    est.initialize(*_tick_args(log, 0))
    for k in range(1, 20):
        est.update(*_tick_args(log, k))
    with pytest.raises(ValueError, match="predates"):
        est.update(*_tick_args(log, 20), vo_active=True, vo_dp=np.zeros(3),
                   vo_tick_pre=2, vo_tick_now=18)


def test_facade_reset_and_device_rule():
    log = synth.generate(synth.SynthConfig(T=10, seed=3))
    est = DecentralizedEstimator(_params(EstimatorParams), dtype=F64, device=CPU)
    est.initialize(*_tick_args(log, 0))
    x_first = _np(est.x).copy()
    for k in range(1, 6):
        est.update(*_tick_args(log, k))
    est.reset()
    assert est.T == 0 and est.x is None
    est.initialize(*_tick_args(log, 0))
    np.testing.assert_array_equal(_np(est.x), x_first)
    with pytest.raises(RuntimeError, match="initialize"):
        DecentralizedEstimator(_params(EstimatorParams), device=CPU).update(
            *_tick_args(log, 1))
    if not torch.cuda.is_available():
        for cls, extra in ((DecentralizedEstimator, ()), (PipelineEstimator, (EKFParams(),))):
            with pytest.raises(RuntimeError, match="CUDA"):
                cls(_params(EstimatorParams), *extra)


def _block_run(est, log, splits, events=None):
    outs = []
    for lo, hi in splits:
        sl = slice(lo, hi)
        va, vdp, vtp, vtn = events if events is not None else (
            log.vo_active, log.vo_dp_body, log.vo_tick_pre, log.vo_tick_now)
        x_blk, v_blk = est.update_block(
            log.R_sb_gt[sl], log.accel_b[sl], log.omega_b[sl], log.p_foot[sl],
            log.J_foot[sl], log.dq[sl], log.contact[sl], vo_active=va[sl],
            vo_dp=vdp[sl], vo_tick_pre=vtp[sl], vo_tick_now=vtn[sl])
        outs.append((_np(x_blk), _np(v_blk)))
    return np.concatenate([o[0] for o in outs]), np.concatenate([o[1] for o in outs])


def test_facade_update_block_matches_per_tick():
    """update_block == K calls of update(), VO events included, and == the
    JAX facade's update_block."""
    T = 25
    log = synth.generate(synth.SynthConfig(T=T, seed=6))
    est1 = DecentralizedEstimator(_params(EstimatorParams), dtype=F64, device=CPU)
    xs = _per_tick(est1, log, T)[1:]
    est2, jest = _both(0)
    est2.initialize(*_tick_args(log, 0))
    jest.initialize(*_tick_args(log, 0))
    splits = [(1, 10), (10, T)]                 # two uneven blocks
    x_blk, v_blk = _block_run(est2, log, splits)
    np.testing.assert_allclose(x_blk, xs, atol=ATOL)
    jx, jv = _block_run(jest, log, splits)
    np.testing.assert_allclose(x_blk, jx, atol=ATOL)
    np.testing.assert_allclose(v_blk, jv, atol=ATOL)
    assert est2.T == est1.T == T


@pytest.mark.parametrize("case", ["slot_clobber", "in_block_reference"])
def test_facade_update_block_vo_references(case):
    """slot_clobber: a VO event at tick 10 refers to tick 5, whose ring slot
    (H=8) a later row of the same block (tick 13) overwrites; the gather
    snapshots the ring first. in_block_reference: the pre-frame tick lies
    inside the block, read from the block's own rows."""
    if case == "slot_clobber":
        T, H, N, seed, at, pre, now, dp = 20, 8, 6, 7, 10, 5, 9, [0.01, -0.02, 0.005]
        splits = ((1, 10), (10, T))
    else:
        T, H, N, seed, at, pre, now, dp = 16, 256, 6, 8, 12, 9, 11, [0.004, 0.002, -0.001]
        splits = ((1, T),)
    log = synth.generate(synth.SynthConfig(T=T, seed=seed))
    va = np.zeros(T, bool)
    va[at] = True
    vtp = np.zeros(T, np.int64)
    vtp[at] = pre
    vtn = np.zeros(T, np.int64)
    vtn[at] = now
    vdp = np.zeros((T, 3))
    vdp[at] = dp
    events = (va, vdp, vtp, vtn)
    est1 = DecentralizedEstimator(_params(EstimatorParams, 0, N), dtype=F64,
                                  history_ticks=H, device=CPU)
    _per_tick(est1, log, T, events=events)
    est2, jest = _both(0, N=N, history_ticks=H)
    est2.initialize(*_tick_args(log, 0))
    jest.initialize(*_tick_args(log, 0))
    _block_run(est2, log, splits, events)
    _block_run(jest, log, splits, events)
    np.testing.assert_allclose(_np(est2.x), _np(est1.x), atol=ATOL)
    np.testing.assert_allclose(_np(est2.x), _np(jest.x), atol=ATOL)


# ------------------------------------------------------- PipelineEstimator


def _box():
    lb, ub = np.full(9, -np.inf), np.full(9, np.inf)
    lb[3:6], ub[3:6] = -0.3, 0.3
    return dict(x_lb=lb, x_ub=ub)


def _box_params(cls, N):
    """The bench's constrained settings: fixed rho=5000, 20 iterations and
    the polish."""
    p = _params(cls, 0, N)
    p.osqp.rho, p.osqp.adapt_rho, p.osqp.polish, p.osqp.max_iter = 5000.0, False, True, 20
    return p


def _stream(est, eb, log, T, splits):
    """initialize at tick 0, then update_block over ``splits``."""
    g, ac, vl = (np.asarray(a) for a in (eb.gyro, eb.accel, eb.valid))
    eva, evq, esb = (np.asarray(a) for a in (eb.vo_active, eb.vo_q, eb.vo_steps_back))
    est.initialize(g[0], ac[0], vl[0], log.accel_b[0], log.omega_b[0], log.p_foot[0],
                   log.J_foot[0], log.dq[0], log.contact[0], ekf_vo_active=eva[0],
                   ekf_vo_q=evq[0], ekf_vo_steps_back=esb[0])
    x0 = _np(est.x)
    outs = []
    for lo, hi in splits:
        sl = slice(lo, hi)
        outs.append(tuple(_np(o) for o in est.update_block(
            g[sl], ac[sl], vl[sl], log.accel_b[sl], log.omega_b[sl], log.p_foot[sl],
            log.J_foot[sl], log.dq[sl], log.contact[sl], ekf_vo_active=eva[sl],
            ekf_vo_q=evq[sl], ekf_vo_steps_back=esb[sl], vo_active=log.vo_active[sl],
            vo_dp=log.vo_dp_body[sl], vo_tick_pre=log.vo_tick_pre[sl],
            vo_tick_now=log.vo_tick_now[sl])))
    return x0, [np.concatenate([o[i] for o in outs]) for i in range(3)]


@pytest.mark.parametrize("box", [False, True], ids=["unconstrained", "box"])
def test_pipeline_estimator_streamed_matches_jax_and_offline(box):
    """PipelineEstimator (EKF in the loop, block-streamed, use_pallas=True:
    the kernels' plain versions on the CPU, one window solve per tick and
    one at initialize) == the JAX PipelineEstimator and the port's offline
    run_pipeline_lanes at B=1, including delayed-VO EKF replays and MHE VO
    events across block boundaries."""
    N, T = 6, 30
    log = synth.generate(synth.SynthConfig(T=T, seed=12))
    kw = _box() if box else {}
    pcls = _box_params if box else lambda cls, N: _params(cls, 0, N)
    p = pcls(EstimatorParams, N)

    eb = estimator.ekfblocks_from_log(log, device=CPU)
    est = PipelineEstimator(p, EKFParams(), dtype=F64, use_pallas=True, ekf_ring_len=16,
                            device=CPU, **kw)
    tridiag_kernel.launches = admm_kernel.launches = 0
    splits = ((1, 11), (11, T))                       # uneven blocks
    x0, (x_str, v_str, q_str) = _stream(est, eb, log, T, splits)
    assert tridiag_kernel.launches == admm_kernel.launches == 0   # the CPU launches nothing
    assert est.T == T

    jest = jfacade.PipelineEstimator(pcls(JParams, N), JEKFParams(), dtype=jnp.float64,
                                     ekf_ring_len=16, **kw)
    # the JAX facade in one block (its own test holds its blocks to its
    # offline replay): one scan compile instead of two
    jx0, (jx, jv, jq) = _stream(jest, eb, log, T, ((1, T),))
    np.testing.assert_allclose(x0, jx0, atol=ATOL)
    np.testing.assert_allclose(x_str, jx, atol=ATOL)
    np.testing.assert_allclose(v_str, jv, atol=ATOL)
    np.testing.assert_allclose(q_str, jq, atol=ATOL)

    lanes = lambda a: a[:, None].movedim(1, -1)        # (T,...) -> (T,...,1)
    data = estimator.TickData(*map(lanes, estimator.tickdata_from_log(log, device=CPU)))
    eb_l = eb._replace(gyro=eb.gyro[..., None], accel=eb.accel[..., None])
    consts = None
    if box:
        from decentralized_ekf_mhe_tpu_torch.ops import mhe

        consts = mhe.make_consts(p, F64, device=CPU, **kw)
    x_ref, v_ref, q_ref = estimator.run_pipeline_lanes(
        p, EKFParams(), data, eb_l, vo=estimator.vodata_from_log(log, device=CPU),
        dtype=F64, consts=consts, ekf_ring_len=16, device=CPU)
    np.testing.assert_allclose(x0, x_ref[0, 0].numpy(), atol=ATOL)
    np.testing.assert_allclose(x_str, x_ref[1:, 0].numpy(), atol=ATOL)
    np.testing.assert_allclose(v_str, v_ref[1:, 0].numpy(), atol=ATOL)
    np.testing.assert_allclose(q_str, q_ref[1:, :, 0].numpy(), atol=ATOL)
    if box:
        assert np.abs(x_str[:, 3:6]).max() <= 0.3 + 1e-6
