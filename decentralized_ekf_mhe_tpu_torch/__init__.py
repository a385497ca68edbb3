"""decentralized_ekf_mhe_tpu_torch — PyTorch/CUDA port of the decentralized
EKF + MHE legged-robot state estimator.

The package mirrors the module layout of ``decentralized_ekf_mhe_tpu`` (the
JAX reference implementation that lives beside it) so a reader finds each
counterpart by name; the reference's ``pallas/`` directory corresponds to
``kernels/`` here, with the CUDA C++ sources under ``csrc/``. The port imports
``torch``, ``numpy`` and the standard library only.

Ported so far: the fleet cycle — orientation-EKF stage → ``ekf_lanes.to_rot``
→ MHE tick → lever-arm body velocity (``parallel.batch.make_pipeline_fleet_runner``)
— for Go1, Cassie and PogoX, unconstrained or with state box constraints, on
one shared camera clock or a clock per lane; and the standard-layout estimator
(``ops.estimator.run_kf``/``run_mhe``/``ekf_orientation_sequence``, the fleet
runner ``parallel.batch.make_fused_batched_runner``). ROADMAP.md lists the rest.

Device rule: every entry point defaults to ``device="cuda"`` and raises when
CUDA is unavailable; it runs on the CPU only when the caller passes
``device="cpu"``. On a CUDA tensor a kernel wrapper launches its hand-written
kernel or raises; the plain PyTorch version beside each kernel is taken only
for CPU tensors.
"""

__version__ = "0.1.0"

from decentralized_ekf_mhe_tpu_torch.utils import precision as _precision  # noqa: F401  (sets the TF32 guard)
from decentralized_ekf_mhe_tpu_torch.config import (  # noqa: F401
    EKFParams,
    EstimatorParams,
    OSQPParams,
    load_yaml_params,
)
