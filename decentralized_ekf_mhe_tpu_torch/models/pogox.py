"""PogoX hopping robot adaptation, one pogo leg (counterpart of the
reference ``models/pogox.py``): leg roll q1 about x, leg pitch q2 about y,
and a prismatic extension q3 along the leg axis from the nominal length L0.
"""

from __future__ import annotations

import torch

from decentralized_ekf_mhe_tpu_torch.models.base import RobotModel

L0 = 0.45  # nominal leg length (m)


class PogoXModel(RobotModel):
    name = "pogox"
    num_legs = 1

    def __init__(self, p_ib=(0.0, 0.0, 0.0), contact_threshold=40.0):
        super().__init__(p_ib=p_ib, contact_threshold=contact_threshold)

    def fk(self, joints: torch.Tensor) -> torch.Tensor:
        """(..., 1, 3) joints (roll, pitch, extension) -> (..., 1, 3) foot pos."""
        q1, q2, q3 = joints[..., 0], joints[..., 1], joints[..., 2]
        length = L0 + q3
        # leg axis: -z rotated by pitch about y then roll about x
        ax = -torch.sin(q2) * torch.cos(q1)
        ay = torch.sin(q1)
        az = -torch.cos(q2) * torch.cos(q1)
        return torch.stack([length * ax, length * ay, length * az], dim=-1)

    def jacobian(self, joints: torch.Tensor) -> torch.Tensor:
        q1, q2, q3 = joints[..., 0], joints[..., 1], joints[..., 2]
        s1, c1 = torch.sin(q1), torch.cos(q1)
        s2, c2 = torch.sin(q2), torch.cos(q2)
        length = L0 + q3
        zero = torch.zeros_like(q1)
        J = torch.stack([
            length * s2 * s1, -length * c2 * c1, -s2 * c1,
            length * c1, zero, s1,
            length * c2 * s1, length * s2 * c1, -c2 * c1,
        ], dim=-1)
        return J.reshape(tuple(joints.shape[:-1]) + (3, 3))
