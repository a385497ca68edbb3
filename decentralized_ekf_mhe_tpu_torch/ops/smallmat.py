"""Small-matrix linear algebra in standard layout (…, n, n).

Counterpart of the reference ``ops/smallmat.py``: unrolled, pivot-free
Gauss-Jordan inverses and closed-form 3×3 inverses, broadcasting over leading
batch axes. Every matrix inverted by the estimator is SPD (a covariance or an
information matrix), so elimination without pivoting is safe. The lanes twins
(…, n, n, B) are ``ops/lanes.gj_inv``/``inv3``.
"""

from __future__ import annotations

import torch


def gj_inv(A):
    """Inverse of batched SPD (…, n, n) matrices by pivot-free Gauss-Jordan
    elimination, one step per row."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    aug = torch.cat([A, eye], dim=-1)
    for i in range(n):
        row = aug[..., i, :] / aug[..., i, i:i + 1]
        aug -= aug[..., :, i:i + 1] * row[..., None, :]
        aug[..., i, :] = row
    return aug[..., n:]


def solve(A, b):
    """Solve A x = b for SPD A: (…, n, n) @ (…, n) -> (…, n)."""
    return (gj_inv(A) @ b[..., None])[..., 0]


def solve_mat(A, B):
    """Solve A X = B for SPD A with a matrix right-hand side (…, n, m)."""
    return gj_inv(A) @ B


def inv3(A):
    """Closed-form (adjugate) inverse of batched (…, 3, 3) matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    adj = torch.stack([A11, A12, A13, A21, A22, A23, A31, A32, A33], dim=-1)
    return adj.reshape(A.shape) / det[..., None, None]


def inv(A):
    """Closed form for 3×3, Gauss-Jordan otherwise."""
    return inv3(A) if A.shape[-1] == 3 else gj_inv(A)
