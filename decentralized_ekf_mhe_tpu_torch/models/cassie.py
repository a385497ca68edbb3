"""Cassie biped adaptation, 2 legs (counterpart of the reference
``models/cassie.py``).

A 3-DoF serial-chain approximation — hip roll, hip pitch, knee, with shank
and tarsus lumped — for synthetic logs and tests; a deployment with its own
kinematics feeds ``p_foot``/``J_foot`` through the robotSub seam instead.
Cassie's MHE uses ``leg_odom_type=1`` (foot positions as states,
DecentralEst.cpp:101-118), so with 2 legs dim_state = 15.
"""

from __future__ import annotations

import torch

from decentralized_ekf_mhe_tpu_torch.models.base import RobotModel

# approximate Cassie geometry (meters): pelvis->hip offsets, thigh, shank+tarsus
HIP_X = 0.021
HIP_Y = 0.135
L_THIGH = 0.12
L_SHANK = 0.4323  # lumped shank + tarsus effective length

_SY = (-1.0, 1.0)  # leg order: right, left


def _leg_fk(q, sy):
    q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    xp = -L_THIGH * torch.sin(q2) - L_SHANK * torch.sin(q2 + q3)
    zp = -L_THIGH * torch.cos(q2) - L_SHANK * torch.cos(q2 + q3)
    x = HIP_X + xp
    y = sy * HIP_Y * c1 - s1 * zp
    z = sy * HIP_Y * s1 + c1 * zp
    return torch.stack([x, y, z], dim=-1)


def _leg_jacobian(q, sy):
    q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s2, c2 = torch.sin(q2), torch.cos(q2)
    s23, c23 = torch.sin(q2 + q3), torch.cos(q2 + q3)
    zp = -L_THIGH * c2 - L_SHANK * c23
    dxp_dq2 = -L_THIGH * c2 - L_SHANK * c23
    dxp_dq3 = -L_SHANK * c23
    dzp_dq2 = L_THIGH * s2 + L_SHANK * s23
    dzp_dq3 = L_SHANK * s23
    zero = torch.zeros_like(q1)
    J = torch.stack([
        zero, dxp_dq2, dxp_dq3,
        -sy * HIP_Y * s1 - c1 * zp, -s1 * dzp_dq2, -s1 * dzp_dq3,
        sy * HIP_Y * c1 - s1 * zp, c1 * dzp_dq2, c1 * dzp_dq3,
    ], dim=-1)
    return J.reshape(tuple(q.shape[:-1]) + (3, 3))


class CassieModel(RobotModel):
    name = "cassie"
    num_legs = 2

    def __init__(self, p_ib=(0.0, 0.0, 0.0), contact_threshold=150.0):
        super().__init__(p_ib=p_ib, contact_threshold=contact_threshold)

    def fk(self, joints: torch.Tensor) -> torch.Tensor:
        """(..., 2, 3) joints -> (..., 2, 3) foot positions (pelvis frame)."""
        return _leg_fk(joints, torch.tensor(_SY, dtype=joints.dtype, device=joints.device))

    def jacobian(self, joints: torch.Tensor) -> torch.Tensor:
        return _leg_jacobian(joints, torch.tensor(_SY, dtype=joints.dtype, device=joints.device))
