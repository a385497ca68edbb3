"""Quaternion EKF in instance-on-lanes layout — the fleet orientation stage.

Counterpart of the reference ``ops/ekf_lanes.py`` (reference C++:
src/orien_est/src/orien_ekf.cpp — predict :108-123, accel correct with
(‖a‖/g)² covariance scaling :125-142, VO quaternion correction :144-154,
delayed-VO rewind + trajectory replay :156-212). Every tensor keeps the
instance batch B on the trailing axis: q (4,B), P (4,4,B), history rings
(R,·,B).

The VO schedule (active flags, steps-back) is shared across the fleet — one
camera clock, and the per-substep branches are plain Python ``if``s — or
per lane — a camera clock per lane, and the delayed-VO replay runs masked per
lane (``_replay_per_lane``). The measured VO quaternion is shared (4,) or
per-lane (4,B).

``estimator.scan_ekf_blocks`` loops ``substep_block`` over the log; that loop
is the plain version of the ``ekf_stage`` CUDA kernel
(kernels/ekf_kernel.py). Functions are pure (new tensors out).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from decentralized_ekf_mhe_tpu_torch.config import EKFParams, std_to_cov
from decentralized_ekf_mhe_tpu_torch.ops import lanes
from decentralized_ekf_mhe_tpu_torch.ops.ekf import GRAVITY
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device


class EKFConstsL(NamedTuple):
    """Host-side (numpy/float) constants: handed to the CUDA kernel by value
    and lifted to tensors of the state's dtype/device in the eager path."""

    dt: float
    C_gyro: np.ndarray    # (3,3)
    C_accel: np.ndarray   # (3,3)
    C_vo: np.ndarray      # (4,4)
    gravity: np.ndarray   # (3,)
    quirk_W: bool


def make_consts(params: EKFParams, dtype=torch.float32) -> EKFConstsL:
    f = lambda a: np.asarray(a, np.float64)
    return EKFConstsL(
        dt=float(params.dt),
        C_gyro=f(std_to_cov(params.process_std)),
        C_accel=f(std_to_cov(params.gravity_meas_std)),
        C_vo=f(std_to_cov(params.vo_meas_std)),
        gravity=np.array([0.0, 0.0, GRAVITY]),
        quirk_W=params.quirk_compatible_W,
    )


class EKFStateL(NamedTuple):
    q: torch.Tensor            # (4,B)
    P: torch.Tensor            # (4,4,B)
    t: int                     # EKF substeps consumed so far
    gyro_hist: torch.Tensor    # (R,3,B)
    accel_hist: torch.Tensor   # (R,3,B)
    q_hist: torch.Tensor       # (R,4,B)
    P_hist: torch.Tensor       # (R,4,4,B)


def init_state(params: EKFParams, B: int, ring_len: int = 16,
               dtype=torch.float32, device="cuda") -> EKFStateL:
    device = resolve_device(device)
    q0 = torch.tensor(params.quaternion_init, dtype=dtype,
                      device=device)[:, None].expand(4, B).contiguous()
    P0 = torch.as_tensor(std_to_cov(params.init_std)).to(
        dtype=dtype, device=device)[:, :, None].expand(4, 4, B).contiguous()
    return EKFStateL(
        q=q0,
        P=P0,
        t=0,
        gyro_hist=torch.zeros((ring_len, 3, B), dtype=dtype, device=device),
        accel_hist=torch.zeros((ring_len, 3, B), dtype=dtype, device=device),
        q_hist=q0[None].expand(ring_len, 4, B).contiguous(),
        P_hist=P0[None].expand(ring_len, 4, 4, B).contiguous(),
    )


def _const(a, like):
    return torch.as_tensor(np.asarray(a, np.float64)).to(
        dtype=like.dtype, device=like.device)


# ------------------------------------------------- lanes quaternion algebra


def normalize(q):
    """(...,4,B) -> unit quaternion per lane."""
    return q / torch.sqrt(torch.sum(q * q, dim=-2, keepdim=True))


def gyro_to_omega(w):
    """(...,3,B) gyro -> (...,4,4,B) Ω(ω) (gyro_2_Ohm, orien_ekf.cpp:214-228)."""
    z = torch.zeros_like(w[..., 0, :])
    wx, wy, wz = w[..., 0, :], w[..., 1, :], w[..., 2, :]
    return torch.stack(
        [
            torch.stack([z, -wx, -wy, -wz], dim=-2),
            torch.stack([wx, z, wz, -wy], dim=-2),
            torch.stack([wy, -wz, z, wx], dim=-2),
            torch.stack([wz, wy, -wx, z], dim=-2),
        ],
        dim=-3,
    )


def to_rot(q):
    """(...,4,B) -> (...,3,3,B) rotation of the normalized quaternion."""
    qn = normalize(q)
    w, x, y, z = qn[..., 0, :], qn[..., 1, :], qn[..., 2, :], qn[..., 3, :]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one = torch.ones_like(w)
    return torch.stack(
        [
            torch.stack([one - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-2),
            torch.stack([2 * (xy + wz), one - 2 * (xx + zz), 2 * (yz - wx)], dim=-2),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), one - 2 * (xx + yy)], dim=-2),
        ],
        dim=-3,
    )


def quat_to_W(q, dt, quirk_compatible: bool = True):
    """(...,4,B) -> (...,4,3,B) process-noise Jacobian (quat_2_W,
    orien_ekf.cpp:270-294). ``quirk_compatible`` reproduces the shipped
    binary's matrix (rows 2/3 as the C++ writes them); False is the textbook
    Jacobian."""
    w, x, y, z = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    zero = torch.zeros_like(w)
    if quirk_compatible:
        rows = [
            torch.stack([-x, -y, -z], dim=-2),
            torch.stack([w, -z, y], dim=-2),
            torch.stack([z, x, w], dim=-2),
            torch.stack([-y, zero, zero], dim=-2),
        ]
    else:
        rows = [
            torch.stack([-x, -y, -z], dim=-2),
            torch.stack([w, -z, y], dim=-2),
            torch.stack([z, w, -x], dim=-2),
            torch.stack([-y, x, w], dim=-2),
        ]
    return (0.5 * dt) * torch.stack(rows, dim=-3)


def quat_to_H(q, gravity: np.ndarray):
    """(...,4,B) -> (...,3,4,B) Jacobian of R(q)ᵀg (quat_2_H, :307-329);
    ``gravity`` is the constant (3,) vector."""
    w, x, y, z = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    gx, gy, gz = (float(gravity[0]), float(gravity[1]), float(gravity[2]))
    return 2.0 * torch.stack(
        [
            torch.stack([gx * w + gy * z - gz * y,
                         gx * x + gy * y + gz * z,
                         -gx * y + gy * x - gz * w,
                         -gx * z + gy * w + gz * x], dim=-2),
            torch.stack([-gx * z + gy * w + gz * x,
                         gx * y - gy * x + gz * w,
                         gx * x + gy * y + gz * z,
                         -gx * w - gy * z + gz * y], dim=-2),
            torch.stack([gx * y - gy * x + gz * w,
                         gx * z - gy * w - gz * x,
                         gx * w + gy * z - gz * y,
                         gx * x + gy * y + gz * z], dim=-2),
        ],
        dim=-3,
    )


# ----------------------------------------------------------- filter stages


def predict(q, P, gyro, c: EKFConstsL):
    """q⁺ = norm((I + dt/2 Ω)q), P⁺ = FPFᵀ + W C_gyro Wᵀ (orien_ekf.cpp:108-123)."""
    dt = float(c.dt)
    eye4 = lanes.eye(4, q.dtype, q.device)
    F = eye4 + (dt / 2) * gyro_to_omega(gyro)
    W = quat_to_W(q, dt, quirk_compatible=c.quirk_W)
    q_pred = normalize(lanes.mv(F, q))
    P_pred = lanes.mm_nt(lanes.mm(F, P), F) + lanes.mm_nt(
        lanes.mmc(W, _const(c.C_gyro, q)), W)
    return q_pred, P_pred


def accel_correct(q, P, accel, c: EKFConstsL):
    """Gravity-direction correction, (‖a‖/g)²-scaled covariance (:125-142)."""
    g = np.asarray(c.gravity)
    R = to_rot(q)
    B = q.shape[-1]
    g_l = _const(g, q)[:, None].expand(3, B)
    accel_hat = lanes.mv_t(R, g_l)
    H = quat_to_H(q, g)
    rel2 = torch.sum(accel * accel, dim=-2) / (GRAVITY * GRAVITY)  # (B,)
    S = lanes.mm_nt(lanes.mm(H, P), H) + rel2[None, None, :] * _const(
        c.C_accel, q)[:, :, None]
    K = lanes.mm(lanes.mm_nt(P, H), lanes.inv3(S))
    q_new = normalize(q + lanes.mv(K, accel - accel_hat))
    eye4 = lanes.eye(4, q.dtype, q.device)
    P_new = lanes.mm(eye4 - lanes.mm(K, H), P)
    return q_new, P_new


def vo_correct(q, P, q_vo, c: EKFConstsL):
    """Full-quaternion VO correction, H = I₄ (orien_ekf.cpp:144-154);
    ``q_vo`` is the measured quaternion — shared (4,) or per-lane (4,B)."""
    B = q.shape[-1]
    S = P + _const(c.C_vo, q)[:, :, None]
    K = lanes.mm(P, lanes.gj_inv(S))
    q_vo = torch.as_tensor(q_vo, dtype=q.dtype, device=q.device)
    q_vo_l = (q_vo[:, None] if q_vo.ndim == 1 else q_vo).expand(4, B)
    q_new = normalize(q + lanes.mv(K, q_vo_l - q))
    eye4 = lanes.eye(4, q.dtype, q.device)
    P_new = lanes.mm(eye4 - K, P)
    return q_new, P_new


def _replay(state: EKFStateL, q_vo, steps_back: int, c: EKFConstsL):
    """Rewind + forward replay (orien_ekf.cpp:186-205): rewind to the state
    saved ``steps_back`` substeps ago and replay ``steps_back - 1`` of the
    stored IMU samples, applying the VO correction after the first one."""
    R = state.gyro_hist.shape[0]
    sync_slot = (state.t - steps_back) % R
    q, P = state.q_hist[sync_slot], state.P_hist[sync_slot]
    for i in range(min(R, steps_back - 1)):
        slot = (sync_slot + i) % R
        q, P = predict(q, P, state.gyro_hist[slot], c)
        q, P = accel_correct(q, P, state.accel_hist[slot], c)
        if i == 0:
            q, P = vo_correct(q, P, q_vo, c)
    return q, P


def _gather_ring(hist, slot):
    """hist (R, ..., B) gathered at per-lane ring slots ``slot`` (B,)."""
    tail = hist.shape[1:]
    idx = slot.reshape((1,) * len(tail) + tuple(slot.shape))
    return torch.gather(hist, 0, idx.expand((1,) + tuple(tail)))[0]


def _replay_per_lane(state: EKFStateL, q_vo, steps_back, lane_valid,
                     n_steps: int, c: EKFConstsL):
    """Per-lane delayed-VO replay: ``steps_back`` (B,) int64, ``q_vo`` (4,B)
    or (4,), ``lane_valid`` (B,) bool, all on the state's device. Each lane
    rewinds to its own sync slot and replays its own number of steps
    (orien_ekf.cpp:186-205), masked; lanes with ``lane_valid`` False keep
    their current (q, P). ``n_steps`` — the largest number of replayed steps
    of a valid lane, known on the host — bounds the loop; later steps would
    be masked on every lane."""
    R = state.gyro_hist.shape[0]
    sb = torch.where(lane_valid, steps_back, torch.ones_like(steps_back))
    sync_slot = torch.remainder(state.t - sb, R)      # (B,)
    q = _gather_ring(state.q_hist, sync_slot)
    P = _gather_ring(state.P_hist, sync_slot)
    for i in range(min(R, n_steps)):
        slot = torch.remainder(sync_slot + i, R)
        qc, Pc = predict(q, P, _gather_ring(state.gyro_hist, slot), c)
        qc, Pc = accel_correct(qc, Pc, _gather_ring(state.accel_hist, slot), c)
        if i == 0:
            qc, Pc = vo_correct(qc, Pc, q_vo, c)
        step_on = (i < sb - 1) & lane_valid            # (B,)
        q = torch.where(step_on[None, :], qc, q)
        P = torch.where(step_on[None, None, :], Pc, P)
    q = torch.where(lane_valid[None, :], q, state.q)
    P = torch.where(lane_valid[None, None, :], P, state.P)
    return q, P


def _ring_set(hist, slot, val):
    out = hist.clone()
    out[slot] = val
    return out


def tick(state: EKFStateL, gyro, accel, vo_active, q_vo, vo_steps_back,
         c: EKFConstsL) -> EKFStateL:
    """One EKF tick (orien_ekf.cpp:77-106): push history, delayed-VO replay
    if valid, predict, accel-correct. gyro/accel are (3,B). The VO metadata
    are shared scalars, or per-lane tensors (``vo_active`` (B,) bool,
    ``vo_steps_back`` (B,) int, ``q_vo`` (4,B)) — told apart by
    ``vo_active``'s rank; the latter replays masked per lane, and not at all
    when no lane has a valid event. Per-lane metadata held on the CPU keeps
    that decision on the host."""
    per_lane = getattr(vo_active, "ndim", 0) >= 1
    R = state.gyro_hist.shape[0]
    slot = state.t % R
    state = state._replace(
        gyro_hist=_ring_set(state.gyro_hist, slot, gyro),
        accel_hist=_ring_set(state.accel_hist, slot, accel),
        q_hist=_ring_set(state.q_hist, slot, state.q),
        P_hist=_ring_set(state.P_hist, slot, state.P),
    )
    if per_lane:
        sb = torch.as_tensor(vo_steps_back).to(torch.int64)
        valid = (torch.as_tensor(vo_active).bool() & (sb >= 1)
                 & (sb <= state.t) & (sb < R))
        q, P = state.q, state.P
        if bool(valid.any()):
            n_steps = int(sb[valid].max()) - 1
            dev = state.q.device
            q, P = _replay_per_lane(state, q_vo, sb.to(dev), valid.to(dev),
                                    n_steps, c)
    else:
        sb = int(vo_steps_back)
        valid = bool(vo_active) and sb >= 1 and sb <= state.t and sb < R
        if valid:
            q, P = _replay(state, q_vo, sb, c)
        else:
            q, P = state.q, state.P
    q_pred, P_pred = predict(q, P, gyro, c)
    q_corr, P_corr = accel_correct(q_pred, P_pred, accel, c)
    return state._replace(q=q_corr, P=P_corr, t=state.t + 1)


def substep_block(state: EKFStateL, gyro_blk, accel_blk, valid_blk,
                  vo_active_blk, vo_q_blk, vo_sb_blk, c: EKFConstsL):
    """Run one MHE tick's worth of EKF substeps (the 500/200 Hz rate
    mismatch). gyro/accel (S,3,B); valid (S,) shared bools (False ⇒ padding
    slot, skipped); vo_active (S,), vo_q (S,4) or (S,4,B), vo_sb (S,) — or,
    with a camera clock per lane, vo_active (S,B), vo_sb (S,B) (see
    ``tick``). The metadata blocks are read on the host (lists or CPU
    tensors avoid a device sync per substep)."""
    S = gyro_blk.shape[0]
    for j in range(S):
        if bool(valid_blk[j]):
            state = tick(state, gyro_blk[j], accel_blk[j], vo_active_blk[j],
                         vo_q_blk[j], vo_sb_blk[j], c)
    return state
