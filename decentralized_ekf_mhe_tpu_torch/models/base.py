"""Robot adaptation layer (counterpart of the reference ``models/base.py``;
the robotSub seam of go1Sub.hpp:32-50).

A RobotModel turns raw per-tick sensor channels into the estimator's
measurement tensors: IMU-frame foot positions ``p_imu_2_foot`` (..., L, 3),
per-leg 3x3 Jacobians ``J_imu_2_foot`` (..., L, 3, 3) and contact flags
(..., L). Every method broadcasts over leading batch axes and keeps the
dtype and device of its input.
"""

from __future__ import annotations

from typing import Protocol

import torch


class LegKinematics(Protocol):
    num_legs: int

    def fk(self, joints: torch.Tensor) -> torch.Tensor:
        """(..., L, 3) foot positions in the IMU/body frame from (..., L, 3) joints."""

    def jacobian(self, joints: torch.Tensor) -> torch.Tensor:
        """(..., L, 3, 3) ∂p_foot/∂(q1,q2,q3) from (..., L, 3) joints."""


class RobotModel:
    """Base robot adaptation: kinematics + contact detection + frame offsets."""

    name: str = "base"
    num_legs: int = 0

    def __init__(self, p_ib=(0.0, 0.0, 0.0), contact_threshold: float = 150.0):
        self.p_ib = torch.as_tensor(p_ib, dtype=torch.float64)
        self.contact_threshold = contact_threshold

    def fk(self, joints: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def jacobian(self, joints: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def p_imu_2_foot(self, joints: torch.Tensor) -> torch.Tensor:
        """FK + imu-to-body offset, as assembled in go1Sub::lo_callback
        (go1Sub.cpp:88-126): p_imu_2_foot = fk(q) + p_ib."""
        return self.fk(joints) + self.p_ib.to(dtype=joints.dtype, device=joints.device)

    def contact_from_force(self, force: torch.Tensor) -> torch.Tensor:
        """Threshold contact detection (go1Sub.cpp:74): force >= thr -> 1.0."""
        return (force >= self.contact_threshold).to(force.dtype)


class CartesianFeetModel(RobotModel):
    """Adapter for logs whose "joint state" already carries body-frame foot
    positions/velocities (fk = identity, J = I₃) — the J·dq ≡ ṗ_body
    reparameterization the estimator consumes (DecentralEst.cpp:515-516)."""

    name = "cartesian-feet"

    def __init__(self, num_legs: int = 4, p_ib=(0.0, 0.0, 0.0),
                 contact_threshold: float = 150.0):
        super().__init__(p_ib=p_ib, contact_threshold=contact_threshold)
        self.num_legs = num_legs

    def fk(self, joints: torch.Tensor) -> torch.Tensor:
        return joints

    def jacobian(self, joints: torch.Tensor) -> torch.Tensor:
        eye = torch.eye(3, dtype=joints.dtype, device=joints.device)
        return eye.expand(tuple(joints.shape) + (3,))
