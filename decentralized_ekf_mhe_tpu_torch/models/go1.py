"""Unitree Go1 analytic leg kinematics (counterpart of the reference
``models/go1.py``): the closed-form 3-DoF serial chain that reproduces the
FROST codegen of the original (FR/FL/RR/RL_foot.cc, J_*.cc; go1Sub.cpp:88-126),
vectorized over legs and batch.

Model (body frame): leg signs sx = +1 front / −1 rear, sy = +1 left / −1
right; hip offset (sx·0.1881, sy·0.04675, 0); abad q1 rolls about +x with the
thigh plane offset (0, sy·0.08, 0) after it; thigh q2 and knee q3 pitch about
+y, thigh = calf = 0.213 m. Leg order FR, FL, RR, RL.
"""

from __future__ import annotations

import torch

from decentralized_ekf_mhe_tpu_torch.models.base import RobotModel

HIP_X = 0.1881
HIP_Y = 0.04675
THIGH_Y = 0.08
L_THIGH = 0.213
L_CALF = 0.213

# leg order FR, FL, RR, RL — signs (sx, sy)
_SX = (1.0, 1.0, -1.0, -1.0)
_SY = (-1.0, 1.0, -1.0, 1.0)


def _signs(v, q):
    return torch.tensor(v, dtype=q.dtype, device=q.device)


def _leg_fk(q, sx, sy):
    """(...,3) joints -> (...,3) foot position for legs of signs (sx, sy)."""
    q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    xp = -L_THIGH * torch.sin(q2) - L_CALF * torch.sin(q2 + q3)
    zp = -L_THIGH * torch.cos(q2) - L_CALF * torch.cos(q2 + q3)
    y0 = sy * THIGH_Y
    x = sx * HIP_X + xp
    y = sy * HIP_Y + c1 * y0 - s1 * zp
    z = s1 * y0 + c1 * zp
    return torch.stack([x, y, z], dim=-1)


def _leg_jacobian(q, sx, sy):
    """(...,3) joints -> (...,3,3) ∂p/∂(q1,q2,q3) (rows x, y, z)."""
    q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s2, c2 = torch.sin(q2), torch.cos(q2)
    s23, c23 = torch.sin(q2 + q3), torch.cos(q2 + q3)
    zp = -L_THIGH * c2 - L_CALF * c23
    dxp_dq2 = -L_THIGH * c2 - L_CALF * c23
    dxp_dq3 = -L_CALF * c23
    dzp_dq2 = L_THIGH * s2 + L_CALF * s23
    dzp_dq3 = L_CALF * s23
    y0 = sy * THIGH_Y
    zero = torch.zeros_like(q1)
    J = torch.stack([
        zero, dxp_dq2, dxp_dq3,
        -s1 * y0 - c1 * zp, -s1 * dzp_dq2, -s1 * dzp_dq3,
        c1 * y0 - s1 * zp, c1 * dzp_dq2, c1 * dzp_dq3,
    ], dim=-1)
    return J.reshape(tuple(q.shape[:-1]) + (3, 3))


class Go1Model(RobotModel):
    name = "go1"
    num_legs = 4

    def __init__(self, p_ib=(0.01592, 0.06659, 0.00617), contact_threshold=150.0):
        # defaults from parameters_go1.yaml leg_odom.p_ib / contact_effort_theshold
        super().__init__(p_ib=p_ib, contact_threshold=contact_threshold)

    def fk(self, joints: torch.Tensor) -> torch.Tensor:
        """(..., 4, 3) joints -> (..., 4, 3) foot positions (body frame)."""
        return _leg_fk(joints, _signs(_SX, joints), _signs(_SY, joints))

    def jacobian(self, joints: torch.Tensor) -> torch.Tensor:
        """(..., 4, 3) joints -> (..., 4, 3, 3) per-leg Jacobians."""
        return _leg_jacobian(joints, _signs(_SX, joints), _signs(_SY, joints))
