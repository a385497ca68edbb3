"""Instance-on-lanes small-matrix algebra — the fleet-layout math.

Matrices are (..., s, s, B) and vectors (..., s, B) with the instance batch B
on the trailing axis, exactly as in the reference ``ops/lanes.py``: every
scalar matrix entry is a dense (B,) vector, so a warp of CUDA threads (one
thread per instance) reads 32 neighbouring addresses. The hand-written
kernels (``kernels/``) consume this layout directly; these helpers are the
plain PyTorch twins used outside the kernels, on the CPU, and as the kernels'
reference.

All contractions are broadcast-multiply + sum over the small static dim
(≤ 21), which keeps the summation order identical to the reference (element
k = 0 first).
"""

from __future__ import annotations

import torch


def mm(A, B):
    """(..., i, k, b) @ (..., k, j, b) -> (..., i, j, b)."""
    return torch.sum(A[..., :, :, None, :] * B[..., None, :, :, :], dim=-3)


def mm_tn(A, B):
    """Aᵀ @ B: (..., k, i, b), (..., k, j, b) -> (..., i, j, b)."""
    return torch.sum(A[..., :, :, None, :] * B[..., :, None, :, :], dim=-4)


def mm_nt(A, B):
    """A @ Bᵀ: (..., i, k, b), (..., j, k, b) -> (..., i, j, b)."""
    return torch.sum(A[..., :, None, :, :] * B[..., None, :, :, :], dim=-2)


def cmm(C, A):
    """Const @ lanes: (i, k) @ (..., k, j, b) -> (..., i, j, b)."""
    return torch.sum(C[:, :, None, None] * A[..., None, :, :, :], dim=-3)


def cmm_t(C, A):
    """Constᵀ @ lanes: (k, i) @ (..., k, j, b) -> (..., i, j, b)."""
    return torch.sum(C[:, :, None, None] * A[..., :, None, :, :], dim=-4)


def mmc(A, C):
    """Lanes @ const: (..., i, k, b) @ (k, j) -> (..., i, j, b)."""
    return torch.sum(A[..., :, :, None, :] * C[:, :, None], dim=-3)


def mv(A, v):
    """(..., i, k, b) @ (..., k, b) -> (..., i, b)."""
    return torch.sum(A * v[..., None, :, :], dim=-2)


def mv_t(A, v):
    """Aᵀ v: (..., k, i, b), (..., k, b) -> (..., i, b)."""
    return torch.sum(A * v[..., :, None, :], dim=-3)


def cmv(C, v):
    """Const @ lanes vector: (i, k) @ (..., k, b) -> (..., i, b)."""
    return torch.sum(C[:, :, None] * v[..., None, :, :], dim=-2)


def transpose(A):
    """Matrix transpose in lanes layout: swap the two core axes."""
    return A.transpose(-3, -2)


def eye(n, dtype, device=None):
    """(n, n, 1) identity, broadcastable against any (..., n, n, B)."""
    return torch.eye(n, dtype=dtype, device=device)[:, :, None]


def const(M):
    """Lift a constant (..., i, j) matrix into lanes layout (..., i, j, 1)."""
    return M[..., None]


def to_lanes(a):
    """Standard batch-leading (B, ...) -> lanes (..., B)."""
    return torch.movedim(a, 0, -1)


def from_lanes(a):
    """Lanes (..., B) -> standard batch-leading (B, ...)."""
    return torch.movedim(a, -1, 0)


def skew(v):
    """(..., 3, b) -> (..., 3, 3, b) skew-symmetric (EigenUtils.hpp:91-97)."""
    x, y, z = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-2),
            torch.stack([z, o, -x], dim=-2),
            torch.stack([-y, x, o], dim=-2),
        ],
        dim=-3,
    )


def cross(a, b):
    """(..., 3, b) x (..., 3, b) -> (..., 3, b)."""
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-2
    )


def gj_inv(A):
    """Pivot-free Gauss-Jordan inverse of (..., n, n, b) SPD matrices, one
    elimination step per row (the divide is on the pivot row, as in the
    reference and in ``csrc/smallmat.cuh``)."""
    n = A.shape[-2]
    ident = torch.eye(n, dtype=A.dtype, device=A.device)[:, :, None].expand(A.shape)
    aug = torch.cat([A, ident], dim=-2).clone()  # (..., n, 2n, b)
    for i in range(n):
        row = aug[..., i, :, :] / aug[..., i, i, :][..., None, :]
        col = aug[..., :, i, :][..., :, None, :]
        aug = aug - col * row[..., None, :, :]
        aug[..., i, :, :] = row  # row i eliminated against itself: re-insert
    return aug[..., :, n:, :]


def inv3(A):
    """Closed-form adjugate inverse of (..., 3, 3, b) matrices."""
    a, b, c = A[..., 0, 0, :], A[..., 0, 1, :], A[..., 0, 2, :]
    d, e, f = A[..., 1, 0, :], A[..., 1, 1, :], A[..., 1, 2, :]
    g, h, i = A[..., 2, 0, :], A[..., 2, 1, :], A[..., 2, 2, :]
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
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], dim=-2),
            torch.stack([A21, A22, A23], dim=-2),
            torch.stack([A31, A32, A33], dim=-2),
        ],
        dim=-3,
    )
    return adj / det[..., None, None, :]


def inv(A):
    """Dispatch: closed-form for 3x3, Gauss-Jordan otherwise."""
    return inv3(A) if A.shape[-2] == 3 else gj_inv(A)


def thomas_factor(D, U):
    """Block-Thomas factorization in lanes layout: returns
    ``(Sinv (N,s,s,B), U)`` for ``thomas_solve_factored``."""
    N = D.shape[0]
    Sinv = [None] * N
    Sinv[0] = gj_inv(D[0])
    for j in range(1, N):
        W = mm(Sinv[j - 1], U[j - 1])
        Sinv[j] = gj_inv(D[j] - mm_tn(U[j - 1], W))
    return torch.stack(Sinv, dim=0), U


def thomas_solve_factored(fac, r):
    """Solve with a ``thomas_factor`` result — matvec sweeps only.
    r (N, s, B) -> x (N, s, B)."""
    Sinv, U = fac
    N = r.shape[0]
    y = [None] * N
    y[0] = r[0]
    for j in range(1, N):
        y[j] = r[j] - mv_t(U[j - 1], mv(Sinv[j - 1], y[j - 1]))
    x = [None] * N
    x[N - 1] = mv(Sinv[N - 1], y[N - 1])
    for j in range(N - 2, -1, -1):
        x[j] = mv(Sinv[j], y[j] - mv(U[j], x[j + 1]))
    return torch.stack(x, dim=0)


def thomas_solve(D, U, r):
    """Block-Thomas sweep on a lanes-layout SPD block-tridiagonal system —
    the plain version of the ``tridiag_solve`` CUDA kernel.

    Args:
      D: (N, s, s, B) diagonal blocks (warmup-masked by the caller).
      U: (N-1, s, s, B) super-diagonal couplings.
      r: (N, s, B) right-hand side.
    Returns x: (N, s, B).
    """
    N = D.shape[0]
    Sinv = [None] * N
    y = [None] * N
    Sinv[0] = gj_inv(D[0])
    y[0] = r[0]
    for j in range(1, N):
        W = mm(Sinv[j - 1], U[j - 1])
        S_j = D[j] - mm_tn(U[j - 1], W)
        y[j] = r[j] - mv_t(U[j - 1], mv(Sinv[j - 1], y[j - 1]))
        Sinv[j] = gj_inv(S_j)
    x = [None] * N
    x[N - 1] = mv(Sinv[N - 1], y[N - 1])
    for j in range(N - 2, -1, -1):
        x[j] = mv(Sinv[j], y[j] - mv(U[j], x[j + 1]))
    return torch.stack(x, dim=0)
