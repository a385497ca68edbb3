"""Batched symmetric block-tridiagonal solver in standard layout — the MHE's
exact window solve.

Counterpart of the reference ``ops/tridiag.py``. The MHE's slack variables
eliminate analytically (every constraint is an equality in one slack,
DecentralEst.cpp:460-488), leaving the SPD normal equations

    D_0 x_0 + U_0 x_1                        = r_0
    U_{j-1}ᵀ x_{j-1} + D_j x_j + U_j x_{j+1} = r_j
    U_{K-2}ᵀ x_{K-2} + D_{K-1} x_{K-1}       = r_{K-1}

solved exactly by one block-Thomas sweep: S_j = D_j − U_{j-1}ᵀ S_{j-1}⁻¹
U_{j-1} with pivot-free Gauss-Jordan inverses, then back substitution.

Operands are time-leading, (K, …, s, s) / (K, …, s), with any batch axes in
between. The sweep itself is the lanes one (``ops/lanes.thomas_*``): the
batch axes are flattened onto the trailing instance axis and back, so the
standard and the lanes layout run the same arithmetic in the same order, and
a fleet gives the same bits through either.

Warm-up masking: ``valid`` (K, …) marks live slots; a dead slot gets D=I,
r=0, and every coupling with a dead member U=0, so it solves to zero without
touching the live block.
"""

from __future__ import annotations

import torch

from decentralized_ekf_mhe_tpu_torch.ops import lanes


def mask_system(D, U, r, valid):
    """Apply the warm-up mask ``valid`` (K, …) to (D, U, r) (``r`` may be
    None); ``valid`` None: as is."""
    if valid is None:
        return D, U, r
    s = D.shape[-1]
    eye = torch.eye(s, dtype=D.dtype, device=D.device)
    v = valid[..., None, None].to(D.dtype)
    D = D * v + eye * (1.0 - v)
    if r is not None:
        r = r * valid[..., None].to(r.dtype)
    vU = (valid[:-1] & valid[1:])[..., None, None].to(U.dtype)
    return D, U * vU, r


def _mat_lanes(M):
    """(K, …, s, s) -> lanes (K, s, s, B) with the batch axes flattened."""
    K, s = M.shape[0], M.shape[-1]
    return M.reshape(K, -1, s, s).permute(0, 2, 3, 1)


def _vec_lanes(v):
    """(K, …, s) -> lanes (K, s, B)."""
    K, s = v.shape[0], v.shape[-1]
    return v.reshape(K, -1, s).permute(0, 2, 1)


def _vec_std(x, like):
    """Lanes (K, s, B) -> the standard shape of ``like`` (K, …, s)."""
    return x.permute(0, 2, 1).reshape(like.shape)


def solve(D, U, r, valid=None):
    """Solve the block-tridiagonal SPD system.

    Args:
      D: (K, …, s, s) diagonal blocks (symmetric).
      U: (K-1, …, s, s) super-diagonal blocks (coupling j -> j+1).
      r: (K, …, s) right-hand side.
      valid: optional (K, …) mask of live slots (True = live).
    Returns x of shape (K, …, s).
    """
    D, U, r = mask_system(D, U, r, valid)
    x = lanes.thomas_solve(_mat_lanes(D), _mat_lanes(U), _vec_lanes(r))
    return _vec_std(x, r)


def factor(D, U, valid=None):
    """Block-Thomas factorization for ``solve_factored``: returns
    ``(Sinv (K, s, s, B), U_masked (K-1, s, s, B))`` in lanes layout over the
    flattened batch axes. Amortizes the Gauss-Jordan inverses when one matrix
    meets many right-hand sides (the ADMM x-update, ``admm.solve_box_tridiag``,
    whose matrix changes only at ρ updates)."""
    D, U, _ = mask_system(D, U, None, valid)
    return lanes.thomas_factor(_mat_lanes(D), _mat_lanes(U))


def solve_factored(fac, r, valid=None):
    """Solve with a ``factor`` result — matvec sweeps only."""
    if valid is not None:
        r = r * valid[..., None].to(r.dtype)
    return _vec_std(lanes.thomas_solve_factored(fac, _vec_lanes(r)), r)


def solve_dense_check(D, U, r):
    """Reference: assemble the full (K·s, K·s) system of one instance and
    solve it densely (tests only)."""
    K, s = D.shape[0], D.shape[-1]
    assert D.ndim == 3, "solve_dense_check is unbatched (tests only)"
    H = torch.zeros((K * s, K * s), dtype=D.dtype, device=D.device)
    for j in range(K):
        H[j * s:(j + 1) * s, j * s:(j + 1) * s] = D[j]
        if j < K - 1:
            H[j * s:(j + 1) * s, (j + 1) * s:(j + 2) * s] = U[j]
            H[(j + 1) * s:(j + 2) * s, j * s:(j + 1) * s] = U[j].T
    return torch.linalg.solve(H, r.reshape(K * s)).reshape(K, s)
