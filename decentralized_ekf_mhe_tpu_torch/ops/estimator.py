"""Estimation replays: run the decentralized EKF → MHE pipeline over a log.

Counterpart of the reference ``ops/estimator.py``. The reference scans each
stage with ``lax.scan``; here the replays are Python loops over the eager
functions (thousands of small launches — fine on the CPU and as the kernels'
reference at small sizes), and the lanes fleet path replaces each loop with
one hand-written CUDA kernel (``kernels/ekf_kernel.py``,
``kernels/mhe_replay_kernel.py``). Every loop brings its schedule (VO
events, tick counters) to the host once, so no tick reads a device scalar.

Ported: ``TickData``, ``VOData``, ``EKFBlocks`` and their ``*_from_log``
packers; the standard-layout replays ``run_kf`` (the KF baseline),
``run_mhe`` (single instance (T, …) or a time-leading fleet (T, B, …), whose
window solve takes the block-tridiagonal kernel's standard-layout route with
``use_pallas`` consts) and ``ekf_orientation_sequence`` — together the
reference bench's float64 oracle; and the lanes replays ``scan_ekf_blocks``,
``run_mhe_lanes`` and ``run_pipeline_lanes``, each with the fleet's shared
camera clock or a camera clock per lane.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from decentralized_ekf_mhe_tpu_torch.config import EstimatorParams
from decentralized_ekf_mhe_tpu_torch.ops import assembly, kf
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device


class TickData(NamedTuple):
    """Per-MHE-tick aligned inputs (leading axis = time)."""

    accel_b: torch.Tensor   # (T,3)      | lanes (T,3,B)
    omega_b: torch.Tensor   # (T,3)      | (T,3,B)
    R_sb: torch.Tensor      # (T,3,3)    | (T,3,3,B) orientation input
    p_foot: torch.Tensor    # (T,L,3)    | (T,L,3,B)
    J_foot: torch.Tensor    # (T,L,3,3)  | (T,L,3,3,B)
    dq: torch.Tensor        # (T,L,3)    | (T,L,3,B)
    contact: torch.Tensor   # (T,L)      | (T,L,B)


def _t(a, dtype, device):
    return torch.as_tensor(np.asarray(a)).to(dtype=dtype, device=device)


def tickdata_from_log(log, R_sb=None, dtype=torch.float64,
                      device="cuda") -> TickData:
    """Pack a SynthLog / replay log into TickData (time-leading)."""
    device = resolve_device(device)
    R = log.R_sb_gt if R_sb is None else R_sb
    return TickData(
        accel_b=_t(log.accel_b, dtype, device),
        omega_b=_t(log.omega_b, dtype, device),
        R_sb=_t(R, dtype, device),
        p_foot=_t(log.p_foot, dtype, device),
        J_foot=_t(log.J_foot, dtype, device),
        dq=_t(log.dq, dtype, device),
        contact=_t(log.contact, dtype, device),
    )


class VOData(NamedTuple):
    """Per-tick VO event stream (time-leading), from the alignment pass:
    the fleet's shared camera clock, or a clock per lane (every field
    per-lane: active, tick_pre, tick_now (T,B), dp_body (T,3,B))."""

    active: torch.Tensor    # (T,) bool          | per lane (T,B)
    dp_body: torch.Tensor   # (T,3) shared or (T,3,B) per-lane content
    tick_pre: torch.Tensor  # (T,) int32         | per lane (T,B)
    tick_now: torch.Tensor  # (T,) int32         | per lane (T,B)


def vodata_from_log(log, dtype=torch.float64, device="cuda") -> VOData:
    device = resolve_device(device)
    return VOData(
        active=_t(log.vo_active, torch.bool, device),
        dp_body=_t(log.vo_dp_body, dtype, device),
        tick_pre=_t(log.vo_tick_pre, torch.int32, device),
        tick_now=_t(log.vo_tick_now, torch.int32, device),
    )


def _empty_vo(T_total, dtype, device) -> VOData:
    return VOData(
        active=torch.zeros(T_total, dtype=torch.bool, device=device),
        dp_body=torch.zeros((T_total, 3), dtype=dtype, device=device),
        tick_pre=torch.zeros(T_total, dtype=torch.int32, device=device),
        tick_now=torch.zeros(T_total, dtype=torch.int32, device=device),
    )


def _tick(data: TickData, t: int) -> TickData:
    return TickData(*(a[t] for a in data))


def run_kf(params: EstimatorParams, data: TickData,
           lever_arm=kf.DEFAULT_LEVER_ARM, dtype=torch.float64, device="cuda"):
    """Replay the KF baseline over a log (est_type=1, EstSub.cpp:58-91): tick
    0 runs InitializeKF, ticks 1.. UpdateKF. ``data`` (T, …) or (T, B, …) on
    ``device``. Returns (x_seq (T,[B,]s), v_b_seq (T,[B,]3))."""
    device = resolve_device(device)
    nc = assembly.make_noise_consts(params, dtype, device=device)
    A_meas = assembly.a_meas(params, dtype, device=device)
    lever = torch.tensor(lever_arm, dtype=dtype, device=device)

    d0 = _tick(data, 0)
    b0, C0, _ = assembly.build_measurement(params, nc, d0.R_sb, d0.omega_b,
                                           d0.p_foot, d0.J_foot, d0.dq, d0.contact)
    state = kf.init(params, nc, A_meas, b0, C0)
    xs = [state.x]
    vs = [kf.body_velocity(state.x, d0.R_sb, d0.omega_b, lever)]
    # UpdateKF predicts with the inputs of tick T−1 (the stacks before
    # GetMeasurement pushes tick T, DecentralEst.cpp:707-709, 766) and
    # corrects with tick T
    prev = (d0.R_sb, assembly.spatial_accel(d0.R_sb, d0.accel_b, nc), d0.contact)
    for t in range(1, data.accel_b.shape[0]):
        d = _tick(data, t)
        A_dyn, b_dyn, C_dyn, _ = assembly.build_dynamics(params, nc, *prev)
        b_meas, C_meas, _ = assembly.build_measurement(
            params, nc, d.R_sb, d.omega_b, d.p_foot, d.J_foot, d.dq, d.contact)
        state = kf.update(state, A_dyn, b_dyn, C_dyn, A_meas, b_meas, C_meas)
        xs.append(state.x)
        vs.append(kf.body_velocity(state.x, d.R_sb, d.omega_b, lever))
        prev = (d.R_sb, assembly.spatial_accel(d.R_sb, d.accel_b, nc), d.contact)
    return torch.stack(xs, dim=0), torch.stack(vs, dim=0)


def run_mhe(params: EstimatorParams, data: TickData, vo: Optional[VOData] = None,
            lever_arm=kf.DEFAULT_LEVER_ARM, dtype=torch.float64, consts=None,
            device="cuda"):
    """Replay the MHE (est_type=0) over a log: ``mhe.init`` at tick 0, then
    one ``mhe.step`` per tick (the timerCallback dispatch, EstSub.cpp:58-91).

    ``data`` is single-instance (T, …) or a time-leading fleet (T, B, …) on
    ``device``; ``vo`` is the shared VO schedule (active, tick_pre, tick_now
    (T,); dp_body (T,3), or (T,B,3) per instance) or None. Pass ``consts`` to
    choose the solver: with ``use_pallas`` consts a fleet's window solves take
    the block-tridiagonal kernel's standard-layout route
    (``parallel.batch.make_fused_batched_runner``); with a box, the box-ADMM.

    Returns (x_seq (T,[B,]s), v_b_seq (T,[B,]3)); x_seq[0] is the tick-0
    prior+measurement solve."""
    from decentralized_ekf_mhe_tpu_torch.ops import mhe

    device = resolve_device(device)
    c = consts if consts is not None else mhe.make_consts(params, dtype, device=device)
    lever = torch.tensor(lever_arm, dtype=dtype, device=device)
    T_total = data.accel_b.shape[0]
    if vo is None:
        vo = _empty_vo(T_total, dtype, device)
    if vo.active.ndim != 1:
        raise ValueError(
            "run_mhe takes the fleet's shared camera clock (active (T,)); a clock per "
            "lane runs through run_mhe_lanes (parallel.batch.make_lanes_fleet_runner)")
    active = vo.active.tolist()
    tick_pre = vo.tick_pre.tolist()
    tick_now = vo.tick_now.tolist()
    # the orientation at each VO pair's previous-frame tick (the R_vo_sb_pre
    # lookup of DecentralEst.cpp:915): one gather over the whole log
    R_pre_seq = data.R_sb[vo.tick_pre.long()]

    d0 = _tick(data, 0)
    st = mhe.init(c, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot, d0.J_foot,
                  d0.dq, d0.contact, dtype=dtype, device=device)
    x0 = mhe.solve_window(c, st)[..., c.N - 1, :]
    xs = [x0]
    vs = [kf.body_velocity(x0, d0.R_sb, d0.omega_b, lever)]
    for t in range(1, T_total):
        d = _tick(data, t)
        st, (x_T, _) = mhe.step(
            c, st, d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq,
            d.contact, active[t], vo.dp_body[t], tick_pre[t], tick_now[t],
            R_pre_seq[t])
        xs.append(x_T)
        vs.append(kf.body_velocity(x_T, d.R_sb, d.omega_b, lever))
    return torch.stack(xs, dim=0), torch.stack(vs, dim=0)


def ekf_orientation_sequence(params_ekf, log, dtype=torch.float64, device="cuda"):
    """Run the single-instance orientation EKF over the log's EKF-rate
    stream and sample the fused quaternion at each MHE tick (the imu/filter
    -> est_sub handoff, orien_ekf.cpp:90-105 -> EstSub.cpp:34-43). Returns
    (R (T,3,3), q (T,4))."""
    from decentralized_ekf_mhe_tpu_torch.ops import ekf as ekf_ops
    from decentralized_ekf_mhe_tpu_torch.utils import quaternion as quat

    device = resolve_device(device)
    c = ekf_ops.make_consts(params_ekf, dtype, device=device)
    state = ekf_ops.init_state(params_ekf, ring_len=64, dtype=dtype, device=device)
    _, q_seq = ekf_ops.run_sequence(
        state, _t(log.ekf_gyro, dtype, device), _t(log.ekf_accel, dtype, device),
        np.asarray(log.ekf_vo_active, bool), _t(log.ekf_vo_q, dtype, device),
        np.asarray(log.ekf_vo_steps_back, np.int64), c)
    bounds = np.cumsum(np.asarray(log.ekf_substeps))
    idx = torch.as_tensor(np.maximum(bounds - 1, 0), device=device)
    q_mhe = q_seq[idx]
    return quat.to_rot(q_mhe), q_mhe


def vo_world_increments(R_seq, vo: VOData):
    """World-frame VO increments R_seq[tick_pre] @ dp, zeroed on inactive
    ticks: (T,3,B). ``vo.dp_body`` is shared (T,3) or per-lane (T,3,B). One
    gather over the whole log (the R_vo_sb_pre lookup of
    DecentralEst.cpp:915) instead of a history ring; with a camera clock per
    lane ((T,B) ticks) the gather and the mask are per lane."""
    from decentralized_ekf_mhe_tpu_torch.ops import lanes

    T_total, B = R_seq.shape[0], R_seq.shape[-1]
    dtype = R_seq.dtype
    dp = vo.dp_body.to(dtype)
    if vo.active.ndim == 2:
        # R_seq[tick_pre[t,b], :, :, b]
        idx = vo.tick_pre.long()[:, None, None, :].expand(T_total, 3, 3, B)
        R_pre = torch.gather(R_seq, 0, idx)                 # (T,3,3,B)
        act = vo.active.to(dtype)[:, None, :]
    else:
        R_pre = R_seq[vo.tick_pre.long()]                   # (T,3,3,B)
        act = vo.active.to(dtype)[:, None, None]
    dp_l = (dp[:, :, None] if dp.ndim == 2 else dp).expand(T_total, 3, B)
    return lanes.mv(R_pre, dp_l) * act


def run_mhe_lanes(
    params: EstimatorParams,
    data: TickData,
    vo: Optional[VOData] = None,
    lever_arm=kf.DEFAULT_LEVER_ARM,
    dtype=torch.float32,
    consts=None,
    device="cuda",
):
    """Fleet MHE replay in instance-on-lanes layout: init at tick 0, then one
    ``mhe_lanes.step`` per tick (a Python loop; the plain version of the
    ``mhe_tick`` kernel).

    ``data`` fields are lanes-layout time-leading and on ``device``: accel_b
    (T,3,B), R_sb (T,3,3,B), p_foot (T,L,3,B), ... ``vo`` is the shared fleet
    VO schedule (active (T,), dp_body (T,3) or (T,3,B), ticks (T,)) or a
    PER-INSTANCE schedule (active (T,B), dp_body (T,3,B), ticks (T,B)),
    told apart by active's rank; the latter runs the fully masked
    ``mhe_lanes.step_per_instance_vo``.
    Returns (x_seq (T,B,s), v_b_seq (T,B,3)) in standard layout.
    """
    from decentralized_ekf_mhe_tpu_torch.ops import lanes, mhe, mhe_lanes

    device = resolve_device(device)
    c = consts if consts is not None else mhe.make_consts(
        params, dtype, device=device)
    T_total = data.accel_b.shape[0]
    B = data.accel_b.shape[-1]
    if vo is None:
        vo = _empty_vo(T_total, dtype, device)
    vo_inc = vo_world_increments(data.R_sb, vo)
    per_instance = vo.active.ndim == 2
    if per_instance:
        # per-lane meta stays on the device: the step masks, never branches
        active, tick_pre, tick_now = vo.active, vo.tick_pre, vo.tick_now
        step_fn = mhe_lanes.step_per_instance_vo
    else:
        active = vo.active.tolist()
        tick_pre = vo.tick_pre.tolist()
        tick_now = vo.tick_now.tolist()
        step_fn = mhe_lanes.step
    lever_l = torch.tensor(lever_arm, dtype=dtype, device=device)[:, None].expand(3, B)

    def body_vel(x_T, R_sb, omega_b):
        return lanes.mv(R_sb, x_T[3:6] + lanes.cross(omega_b, lever_l))

    d0 = TickData(*(a[0] for a in data))
    st = mhe_lanes.init(c, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot,
                        d0.J_foot, d0.dq, d0.contact, dtype=dtype,
                        per_instance_vo=per_instance, device=device)
    x0 = mhe_lanes.solve_window(c, st)[c.N - 1]
    xs = [x0]
    vs = [body_vel(x0, d0.R_sb, d0.omega_b)]
    for t in range(1, T_total):
        d = TickData(*(a[t] for a in data))
        st, (x_T, _, _) = step_fn(
            c, st, d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq,
            d.contact, active[t], None, tick_pre[t], tick_now[t], None,
            vo_inc=vo_inc[t],
        )
        xs.append(x_T)
        vs.append(body_vel(x_T, d.R_sb, d.omega_b))
    x_seq = torch.stack(xs, dim=0)   # (T,s,B)
    v_seq = torch.stack(vs, dim=0)
    return torch.movedim(x_seq, -1, 1), torch.movedim(v_seq, -1, 1)


class EKFBlocks(NamedTuple):
    """EKF-rate inputs regrouped per MHE tick (the 500/200 Hz sub-stepping):
    tick k owns EKF substeps bounds[k]..bounds[k+1]-1, padded to S_max slots
    with ``valid`` masking the padding. vo_* carry the delayed VO quaternion
    events at EKF resolution: shared across a fleet (one camera log) or, with
    a camera clock per lane, vo_active/vo_steps_back (T,S,B)."""

    gyro: torch.Tensor           # (T,S,3) or lanes (T,S,3,B)
    accel: torch.Tensor          # (T,S,3) or lanes (T,S,3,B)
    valid: torch.Tensor          # (T,S) bool, shared
    vo_active: torch.Tensor      # (T,S) bool, shared | per lane (T,S,B)
    vo_q: torch.Tensor           # (T,S,4) shared or (T,S,4,B) per-lane
    vo_steps_back: torch.Tensor  # (T,S) int32, shared | per lane (T,S,B)


def ekfblocks_from_log(log, dtype=torch.float64, device="cuda") -> EKFBlocks:
    """Pack a log's EKF-rate streams into per-MHE-tick padded blocks."""
    device = resolve_device(device)
    substeps = np.asarray(log.ekf_substeps, np.int64)
    T = substeps.shape[0]
    S = int(substeps.max()) if T else 0
    bounds = np.concatenate([[0], np.cumsum(substeps)])

    def blk(src, shape_tail, fill=0):
        out = np.full((T, S) + shape_tail, fill, dtype=np.asarray(src).dtype)
        for k in range(T):
            n = substeps[k]
            out[k, :n] = np.asarray(src)[bounds[k]:bounds[k] + n]
        return out

    valid = np.zeros((T, S), bool)
    for k in range(T):
        valid[k, : substeps[k]] = True
    return EKFBlocks(
        gyro=_t(blk(log.ekf_gyro, (3,)), dtype, device),
        accel=_t(blk(log.ekf_accel, (3,)), dtype, device),
        valid=_t(valid, torch.bool, device),
        vo_active=_t(blk(np.asarray(log.ekf_vo_active, bool), ()),
                     torch.bool, device),
        vo_q=_t(blk(log.ekf_vo_q, (4,)), dtype, device),
        vo_steps_back=_t(blk(np.asarray(log.ekf_vo_steps_back, np.int64), ()),
                         torch.int32, device),
    )


def scan_ekf_blocks(ekf_st, ekf_blocks: EKFBlocks, ec):
    """Run the per-tick EKF substep blocks over the whole log (a Python loop;
    the plain version of the ``ekf_stage`` kernel). The metadata is copied to
    the host once, so the loop reads no device scalar: shared (T,S) metadata
    as lists, per-lane (T,S,B) metadata (a camera clock per lane, which the
    ``ekf_stage`` kernel does not take, as the reference's EKF kernel does
    not) as CPU tensors for the masked per-lane replay.
    Returns (final_state, q_seq (T,4,B))."""
    from decentralized_ekf_mhe_tpu_torch.ops import ekf_lanes

    T = ekf_blocks.gyro.shape[0]
    valid = ekf_blocks.valid.tolist()
    if ekf_blocks.vo_active.ndim == 3:
        vo_active = ekf_blocks.vo_active.cpu()
        vo_sb = ekf_blocks.vo_steps_back.cpu()
    else:
        vo_active = ekf_blocks.vo_active.tolist()
        vo_sb = ekf_blocks.vo_steps_back.tolist()
    qs = []
    st = ekf_st
    for k in range(T):
        st = ekf_lanes.substep_block(
            st, ekf_blocks.gyro[k], ekf_blocks.accel[k], valid[k],
            vo_active[k], ekf_blocks.vo_q[k], vo_sb[k], ec)
        qs.append(st.q)
    dtype, dev = ekf_st.q.dtype, ekf_st.q.device
    q_seq = (torch.stack(qs, dim=0) if qs
             else torch.zeros((0,) + tuple(ekf_st.q.shape), dtype=dtype, device=dev))
    return st, q_seq


def run_pipeline_lanes(
    params: EstimatorParams,
    ekf_params,
    data: TickData,
    ekf_blocks: EKFBlocks,
    vo: Optional[VOData] = None,
    lever_arm=kf.DEFAULT_LEVER_ARM,
    dtype=torch.float32,
    consts=None,
    ekf_ring_len: int = 16,
    device="cuda",
):
    """Staged EKF(500 Hz) → MHE(200 Hz) fleet replay in lanes layout, eager:
    stage 1 runs every tick's EKF substeps producing the fused orientation
    sequence; stage 2 is the lanes MHE replay consuming it. The reference
    dataflow is strictly orien_ekf → imu/filter → est_sub with no feedback,
    so staging is an exact reordering. ``data.R_sb`` is IGNORED — orientation
    comes from the EKF.

    ``data`` fields are lanes-layout time-leading (T,...,B); ``ekf_blocks``
    gyro/accel are lanes (T,S,3,B). Returns (x_seq (T,B,s), v_b (T,B,3),
    q_seq (T,4,B) fused quaternions).
    """
    from decentralized_ekf_mhe_tpu_torch.ops import ekf_lanes, mhe

    device = resolve_device(device)
    c = consts if consts is not None else mhe.make_consts(
        params, dtype, device=device)
    ec = ekf_lanes.make_consts(ekf_params, dtype)
    B = data.accel_b.shape[-1]
    ekf_st = ekf_lanes.init_state(ekf_params, B, ring_len=ekf_ring_len,
                                  dtype=dtype, device=device)
    _, q_seq = scan_ekf_blocks(ekf_st, ekf_blocks, ec)      # (T,4,B)
    R_seq = ekf_lanes.to_rot(q_seq)                         # (T,3,3,B)
    x_seq, v_seq = run_mhe_lanes(
        params, data._replace(R_sb=R_seq), vo=vo, lever_arm=lever_arm,
        dtype=dtype, consts=c, device=device)
    return x_seq, v_seq, q_seq
