"""Matmul-precision and device guards.

The estimator's information matrices are SPD only in full float32: a TF32
product keeps about three decimal digits, which is enough to turn a
Gauss-Jordan pivot of the window solve negative. The small-matrix algebra of
this package is written as broadcast-multiply-and-sum and never reaches a
tensor-core GEMM, but plain ``torch.matmul`` calls around it (and anything a
caller composes with it) must not silently drop to TF32 either, so importing
the package turns TF32 off for both cuBLAS and cuDNN.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def full_precision() -> None:
    """Re-assert the TF32 guard (callers that toggled it elsewhere)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The package's device rule: ``"cuda"`` unless the caller asks for the
    CPU, and a request for CUDA on a machine without it raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
