"""Baseline Kalman filter (est_type=1) — the accuracy yardstick.

Counterpart of the reference ``ops/kf.py``, mirroring
DecentralizedEstimation::{InitializeKF,UpdateKF} (DecentralEst.cpp:592-861):
a per-tick filter over the same time-varying linear dynamics and
leg-odometry model the MHE uses. Pure functions over the carry (x, C),
broadcasting over leading batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from decentralized_ekf_mhe_tpu_torch.config import EstimatorParams
from decentralized_ekf_mhe_tpu_torch.ops import assembly, smallmat


class KFState(NamedTuple):
    x: torch.Tensor  # (…, s)
    C: torch.Tensor  # (…, s, s)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _correct(x, C, A_meas, b_meas, C_meas):
    """K = C Hᵀ (H C Hᵀ + R)⁻¹; x += K(b − Hx); C = (I − KH)C
    (DecentralEst.cpp:697-699, 858-860)."""
    s = x.shape[-1]
    Ht = A_meas.transpose(-1, -2)
    S = A_meas @ C @ Ht + C_meas
    K = C @ Ht @ smallmat.gj_inv(S)
    x_new = x + _mv(K, b_meas - _mv(A_meas, x))
    C_new = (torch.eye(s, dtype=x.dtype, device=x.device) - K @ A_meas) @ C
    return x_new, C_new


def init(p: EstimatorParams, nc: assembly.NoiseConsts, A_meas, b_meas0,
         C_meas0) -> KFState:
    """Prior + measurement correction at t=0 (InitializeKF,
    DecentralEst.cpp:592-700)."""
    x0, _, C0 = assembly.prior_state(p, nc, b_meas0)
    x, C = _correct(x0, C0, A_meas, b_meas0, C_meas0)
    return KFState(x=x, C=C)


def update(state: KFState, A_dyn, b_dyn, C_dyn, A_meas, b_meas, C_meas) -> KFState:
    """Predict x = A x − b, C = A C Aᵀ + C_dyn; then correct (UpdateKF,
    DecentralEst.cpp:783-785, 858-860)."""
    x = _mv(A_dyn, state.x) - b_dyn
    C = A_dyn @ state.C @ A_dyn.transpose(-1, -2) + C_dyn
    x, C = _correct(x, C, A_meas, b_meas, C_meas)
    return KFState(x=x, C=C)


def body_velocity(x, R_sb, omega_b, lever_arm):
    """v_b = R_sb·(x_v + ω×r) — the reference's logging transform with the
    hardcoded IMU→mocap lever arm (DecentralEst.cpp:183-185, 192-194)."""
    lever = torch.as_tensor(lever_arm, dtype=x.dtype, device=x.device)
    return _mv(R_sb, x[..., 3:6] + torch.linalg.cross(omega_b, lever.expand(omega_b.shape)))


# DecentralEst.cpp:184/193 — p_imu_2_opti hardcoded in the reference
DEFAULT_LEVER_ARM = (0.016041, 0.089061, 0.0579875)
