"""Robot models: leg kinematics, contact detection and frame offsets.

Counterpart of the reference ``models/``: the Go1, Cassie and PogoX forward
kinematics and Jacobians as plain functions on tensors, and the registry
that names them. The fleet path does not call them (synthetic and replayed
logs carry ``p_foot``/``J_foot`` already), so nothing here has a kernel.
"""

from decentralized_ekf_mhe_tpu_torch.models.base import (  # noqa: F401
    CartesianFeetModel,
    LegKinematics,
    RobotModel,
)
from decentralized_ekf_mhe_tpu_torch.models.cassie import CassieModel  # noqa: F401
from decentralized_ekf_mhe_tpu_torch.models.go1 import Go1Model  # noqa: F401
from decentralized_ekf_mhe_tpu_torch.models.pogox import PogoXModel  # noqa: F401

REGISTRY = {
    "go1": Go1Model,
    "cassie": CassieModel,
    "pogox": PogoXModel,
}


def get_model(name: str, **kwargs):
    return REGISTRY[name](**kwargs)
