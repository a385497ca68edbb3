"""Quaternion EKF for base orientation, single instance, standard layout.

Counterpart of the reference ``ops/ekf.py`` (the 500 Hz orien_est node,
src/orien_est/src/orien_ekf.cpp):

- ``predict``       <- gyro_nonlinear_predict  (orien_ekf.cpp:108-123)
- ``accel_correct`` <- gyro_nonlinear_correct  (orien_ekf.cpp:125-142), with
  the (‖a‖/g)² scaling of the accelerometer covariance (:135-137)
- ``vo_correct``    <- vo_nonlinear_correct    (orien_ekf.cpp:144-154), H = I₄
- ``tick``          <- timerCallback + get_measurement (orien_ekf.cpp:77-106,
  156-212): history ring, delayed-VO rewind and trajectory replay.

The reference replays ``steps_back − 1`` stored steps from the sync slot
under a fixed-trip ``fori_loop`` with ``lax.cond`` guards; here the VO
schedule (``vo_active``, ``vo_steps_back``) is host data, so the rewind is a
Python loop of exactly those steps and no tick reads a device scalar. The
instance-minor fleet filter is ``ops/ekf_lanes.py``; this module is the
float64 oracle's filter (``estimator.ekf_orientation_sequence``). Functions
are pure (new tensors out).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from decentralized_ekf_mhe_tpu_torch.config import EKFParams, std_to_cov
from decentralized_ekf_mhe_tpu_torch.ops import smallmat
from decentralized_ekf_mhe_tpu_torch.utils import quaternion as quat
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device

GRAVITY = 9.81  # orien_ekf.cpp:11 — gravity_ = (0, 0, 9.81)


class EKFConsts(NamedTuple):
    """Per-run constants."""

    dt: float
    C_gyro: torch.Tensor      # (3,3)   process_std²      (orien_ekf.cpp:28)
    C_accel: torch.Tensor     # (3,3)   gravity_meas_std² (:29)
    C_vo: torch.Tensor        # (4,4)   vo_meas_std²      (:30)
    gravity: torch.Tensor     # (3,)    (0,0,9.81)
    quirk_W: bool             # reference-compat process-noise Jacobian


class EKFState(NamedTuple):
    """Filter carry: the estimate and a fixed-length history ring holding,
    per slot, the tick's inputs and the filter state entering it (the stacks
    pushed at the top of get_measurement, orien_ekf.cpp:158-163)."""

    q: torch.Tensor            # (4,)
    P: torch.Tensor            # (4,4)
    t: int                     # discrete time of the next tick
    gyro_hist: torch.Tensor    # (R,3)
    accel_hist: torch.Tensor   # (R,3)
    q_hist: torch.Tensor       # (R,4)
    P_hist: torch.Tensor       # (R,4,4)


def _t(a, dtype, device):
    return torch.as_tensor(a, dtype=torch.float64).to(dtype=dtype, device=device)


def make_consts(params: EKFParams, dtype=torch.float32, device="cuda") -> EKFConsts:
    device = resolve_device(device)
    return EKFConsts(
        dt=float(params.dt),
        C_gyro=_t(std_to_cov(params.process_std), dtype, device),
        C_accel=_t(std_to_cov(params.gravity_meas_std), dtype, device),
        C_vo=_t(std_to_cov(params.vo_meas_std), dtype, device),
        gravity=_t([0.0, 0.0, GRAVITY], dtype, device),
        quirk_W=params.quirk_compatible_W,
    )


def init_state(params: EKFParams, ring_len: int = 64, dtype=torch.float32,
               device="cuda") -> EKFState:
    device = resolve_device(device)
    q0 = _t(params.quaternion_init, dtype, device)
    P0 = _t(std_to_cov(params.init_std), dtype, device)
    return EKFState(
        q=q0,
        P=P0,
        t=0,
        gyro_hist=torch.zeros((ring_len, 3), dtype=dtype, device=device),
        accel_hist=torch.zeros((ring_len, 3), dtype=dtype, device=device),
        q_hist=q0.expand(ring_len, 4).clone(),
        P_hist=P0.expand(ring_len, 4, 4).clone(),
    )


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def predict(q, P, gyro, c: EKFConsts):
    """q⁺ = norm((I + dt/2 Ω)q), P⁺ = FPFᵀ + W C_gyro Wᵀ (orien_ekf.cpp:108-123)."""
    F = torch.eye(4, dtype=q.dtype, device=q.device) + (c.dt / 2) * quat.gyro_to_omega(gyro)
    W = quat.quat_to_W(q, c.dt, quirk_compatible=c.quirk_W)
    q_pred = quat.normalize(_mv(F, q))
    P_pred = F @ P @ F.transpose(-1, -2) + W @ c.C_gyro @ W.transpose(-1, -2)
    return q_pred, P_pred


def accel_correct(q, P, accel, c: EKFConsts):
    """Gravity-direction correction with ‖a‖-scaled covariance
    (orien_ekf.cpp:125-142)."""
    R = quat.to_rot(q)
    accel_hat = _mv(R.transpose(-1, -2), c.gravity)
    H = quat.quat_to_H(q, c.gravity)
    Ht = H.transpose(-1, -2)
    rel = torch.linalg.vector_norm(accel, dim=-1)[..., None, None] / GRAVITY
    S = H @ P @ Ht + (rel * rel) * c.C_accel
    K = P @ Ht @ smallmat.inv3(S)
    q_new = quat.normalize(q + _mv(K, accel - accel_hat))
    P_new = (torch.eye(4, dtype=q.dtype, device=q.device) - K @ H) @ P
    return q_new, P_new


def vo_correct(q, P, q_vo, c: EKFConsts):
    """Full-quaternion VO correction, H = I₄ (orien_ekf.cpp:144-154)."""
    K = P @ smallmat.gj_inv(P + c.C_vo)
    q_new = quat.normalize(q + _mv(K, q_vo - q))
    P_new = (torch.eye(4, dtype=q.dtype, device=q.device) - K) @ P
    return q_new, P_new


def _replay(state: EKFState, q_vo, steps_back: int, c: EKFConsts):
    """Rewind to the sync slot and replay forward (orien_ekf.cpp:186-205):
    ``steps_back − 1`` stored steps from the sync slot, the VO correction
    right after the first replayed accel correction."""
    R = state.gyro_hist.shape[0]
    sync_slot = (state.t - steps_back) % R
    q, P = state.q_hist[sync_slot], state.P_hist[sync_slot]
    for i in range(steps_back - 1):
        slot = (sync_slot + i) % R
        q, P = predict(q, P, state.gyro_hist[slot], c)
        q, P = accel_correct(q, P, state.accel_hist[slot], c)
        if i == 0:
            q, P = vo_correct(q, P, q_vo, c)
    return q, P


def _ring_set(hist, slot, val):
    out = hist.clone()
    out[slot] = val
    return out


def tick(state: EKFState, gyro, accel, vo_active, q_vo, vo_steps_back,
         c: EKFConsts) -> EKFState:
    """One 500 Hz EKF tick (timerCallback, orien_ekf.cpp:77-106), in the
    reference's order: push (gyro, accel, q, P) to the ring; if a VO
    quaternion arrived, rewind and replay; predict from the gyro and correct
    from the accelerometer. ``vo_active``/``vo_steps_back`` are host values
    (bool, int) from the alignment pass."""
    R = state.gyro_hist.shape[0]
    slot = state.t % R
    state = state._replace(
        gyro_hist=_ring_set(state.gyro_hist, slot, gyro),
        accel_hist=_ring_set(state.accel_hist, slot, accel),
        q_hist=_ring_set(state.q_hist, slot, state.q),
        P_hist=_ring_set(state.P_hist, slot, state.P),
    )
    # the sync point must lie in the ring and at least one step back (the
    # reference discards the measurement otherwise, orien_ekf.cpp:178-183)
    steps_back = int(vo_steps_back)
    if bool(vo_active) and 1 <= steps_back <= state.t and steps_back < R:
        q, P = _replay(state, q_vo, steps_back, c)
    else:
        q, P = state.q, state.P
    q, P = predict(q, P, gyro, c)
    q, P = accel_correct(q, P, accel, c)
    return state._replace(q=q, P=P, t=state.t + 1)


def run_sequence(state: EKFState, gyro_seq, accel_seq, vo_active_seq, q_vo_seq,
                 vo_steps_back_seq, c: EKFConsts):
    """``tick`` over a pre-aligned log: gyro/accel (T,3), vo_active (T,)
    bool, q_vo (T,4), vo_steps_back (T,) int. The schedule is copied to the
    host once. Returns (final state, (T,4) quaternions)."""
    active = torch.as_tensor(vo_active_seq).tolist()
    steps = torch.as_tensor(vo_steps_back_seq).tolist()
    qs = []
    for k in range(len(active)):
        state = tick(state, gyro_seq[k], accel_seq[k], active[k], q_vo_seq[k],
                     steps[k], c)
        qs.append(state.q)
    q_seq = (torch.stack(qs, dim=0) if qs else
             torch.zeros((0, 4), dtype=state.q.dtype, device=state.q.device))
    return state, q_seq
