"""OSQP-semantics ADMM solvers — the inequality-constrained QP path.

Counterpart of the reference ``ops/admm.py`` (same anchors: the solver
surface of MheSrb.cpp:272-349, the settings of parameters_go1.yaml:37-50).
State box constraints are what makes the estimator an MHE; with them the
window solve is no longer one exact block-tridiagonal sweep but an ADMM loop
whose x-update stays a banded solve, (D + (σ+ρ)I) x̃ = rhs, factorized once
per ρ-epoch.

Ported here:
- ``solve_box_tridiag_lanes``: the fleet-layout MHE specialization (A = I box
  on the states, instance batch on the trailing axis). It is the plain
  PyTorch version of the ``admm_solve`` CUDA kernel and of the box-ADMM core
  inside the constrained ``mhe_tick`` kernel (``csrc/admm.cuh``).
- ``solve_box_qp``: the dense batched solver for l ≤ Ax ≤ u, used by tests.

- ``solve_box_tridiag``: the same MHE specialization in standard layout,
  time-leading (K, …, s) with any batch axes — the constrained window solve
  of ``ops/mhe.py``. Its sweeps are ``ops/tridiag.py``'s.

The reference runs a fixed-length scan with masked updates; here a Python
loop walks the same epoch structure, which is known on the host: the
factorization happens at iteration 1 and, with adaptive ρ, at every
iteration kE+1; the residual check and the ρ update happen at the end of an
epoch (in the lanes solver at iterations kE only: the check after a partial
last epoch moves nothing that is returned); converged instances keep x, z, y
and ρ and stop counting iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from decentralized_ekf_mhe_tpu_torch.config import OSQPParams
from decentralized_ekf_mhe_tpu_torch.ops import lanes, tridiag


class ADMMSettings(NamedTuple):
    rho: float = 0.1
    sigma: float = 1e-5
    alpha: float = 1.6
    iters: int = 50
    adaptive_rho: bool = True       # OSQP adaptRho (parameters_go1.yaml:43)
    rho_update_every: int = 10
    # OSQP convergence criterion (§3.4 of the OSQP paper):
    #   prim ≤ abs_tol + rel_tol·max(‖Ax‖∞, ‖z‖∞)
    #   dual ≤ abs_tol + rel_tol·max(‖Px‖∞, ‖Aᵀy‖∞, ‖q‖∞)
    # Once an instance converges its iterates FREEZE; the returned ``iters``
    # counts iterations actually run per instance. abs_tol=rel_tol=0 disables
    # the check (pure fixed-budget behavior).
    abs_tol: float = 0.0
    rel_tol: float = 0.0
    # OSQP infeasibility-certificate tolerances, consumed by solve_box_qp
    prim_inf_tol: float = 1e-6
    dual_inf_tol: float = 1e-6
    # OSQP-style solution polish: after the ADMM loop, re-solve exactly with
    # the detected active bounds pinned (penalty form, scale-aware)
    polish: bool = True
    polish_penalty: float = 1e6

    @classmethod
    def from_osqp(cls, p: OSQPParams, iters=None, per_iter_s=None):
        """Map the reference's osqp.* group (DecentralEst.cpp:204-217).

        The iteration budget is the wall-clock timeLimit analog: with a
        measured ``per_iter_s`` it becomes min(maxQPIter,
        time_limit/per_iter_s); otherwise min(maxQPIter, 200)."""
        if iters is None:
            if per_iter_s is not None and per_iter_s > 0:
                iters = max(1, min(p.max_iter, int(p.time_limit / per_iter_s)))
            else:
                iters = min(p.max_iter, 200)
        return cls(rho=p.rho, sigma=p.sigma, alpha=p.alpha, iters=iters,
                   adaptive_rho=p.adapt_rho, polish=p.polish,
                   abs_tol=p.abs_tol, rel_tol=p.relative_tol,
                   prim_inf_tol=p.prim_tol, dual_inf_tol=p.dual_tol)


class ADMMResult(NamedTuple):
    """Solver output (access by attribute; field count may grow)."""

    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    prim: torch.Tensor    # final primal residual ‖Ax − z‖∞ per instance
    dual: torch.Tensor    # final dual residual per instance
    iters: torch.Tensor   # iterations actually run per instance (int32)
    # OSQP §3.5 infeasibility certificates; None where the problem class is
    # feasible by construction (the tridiagonal path)
    pinf: object = None
    dinf: object = None


def _active_targets(z, lb, ub):
    """Detect bound-active dims of the (clipped, hence exactly-on-bound) z
    iterate; returns (act mask float, pinned target values)."""
    act_lo = z <= lb
    act_hi = z >= ub
    act = (act_lo | act_hi).to(z.dtype)
    zero = torch.zeros_like(z)
    target = torch.where(act_lo, lb, torch.where(act_hi, ub, zero))
    target = torch.where(torch.isfinite(target), target, zero)
    return act, target


def _rho_update(rho, prim, dual, prim_scale, dual_scale):
    """OSQP adaptive-rho rule: ρ ← ρ·sqrt(r_prim_rel / r_dual_rel), clamped."""
    ratio = torch.sqrt(
        (prim / torch.clamp(prim_scale, min=1e-12))
        / torch.clamp(dual / torch.clamp(dual_scale, min=1e-12), min=1e-12)
    )
    return torch.clamp(rho * ratio, min=1e-6, max=1e6)


def _clip(v, lo, hi):
    return torch.minimum(torch.maximum(v, lo), hi)


def _amax(a, dims):
    return torch.amax(torch.abs(a), dim=dims)


def _gj_inv_std(A):
    """Gauss-Jordan inverse of (..., n, n) matrices through the lanes
    routine (the batch goes to the trailing axis and back)."""
    n = A.shape[-1]
    flat = A.reshape(-1, n, n).permute(1, 2, 0)
    return lanes.gj_inv(flat).permute(2, 0, 1).reshape(A.shape)


def _mv(M, v):
    """(..., i, j) @ (..., j) -> (..., i)."""
    return torch.sum(M * v[..., None, :], dim=-1)


def solve_box_qp(P, q, A, l, u, settings: ADMMSettings, x0=None, z0=None, y0=None):
    """Dense batched ADMM for min ½xᵀPx + qᵀx s.t. l ≤ Ax ≤ u.

    OSQP iteration (operator-splitting form, α-relaxed):
        (P + σI + ρAᵀA) x̃ = σx − q + Aᵀ(ρz − y)
        x⁺ = αx̃ + (1−α)x
        z̃ = Ax̃;  z⁺ = clip(αz̃ + (1−α)z + y/ρ, l, u)
        y⁺ = y + ρ(αz̃ + (1−α)z − z⁺)
    Returns ADMMResult(x, z, y, prim_res, dual_res, iters, pinf, dinf).
    """
    n = P.shape[-1]
    sigma, alpha = settings.sigma, settings.alpha
    At = A.transpose(-1, -2)
    AtA = At @ A
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    inf = float("inf")

    x = torch.zeros_like(q) if x0 is None else x0
    z = _mv(A, x) if z0 is None else z0
    y = torch.zeros_like(z) if y0 is None else y0
    batch_shape = torch.broadcast_shapes(x.shape[:-1], z.shape[:-1])
    rho = torch.full(batch_shape, settings.rho, dtype=P.dtype, device=P.device)
    done = torch.zeros(batch_shape, dtype=torch.bool, device=P.device)
    iters = torch.zeros(batch_shape, dtype=torch.int32, device=P.device)
    pinf = done.clone()
    dinf = done.clone()
    check = settings.abs_tol > 0.0 or settings.rel_tol > 0.0
    E = max(1, int(settings.rho_update_every))
    u_fin, l_fin = torch.isfinite(u), torch.isfinite(l)

    def freeze(new_val, old_val, done):
        return torch.where(done[..., None], old_val, new_val)

    def factor(rho):
        return _gj_inv_std(P + sigma * eye + rho[..., None, None] * AtA)

    Kinv = factor(rho)
    for it in range(1, int(settings.iters) + 1):
        if settings.adaptive_rho and it > 1 and (it - 1) % E == 0:
            Kinv = factor(rho)
        rho_v = rho[..., None]
        rhs = sigma * x - q + _mv(At, rho_v * z - y)
        x_t = _mv(Kinv, rhs)
        x_n = freeze(alpha * x_t + (1 - alpha) * x, x, done)
        z_t = _mv(A, x_t)
        z_r = alpha * z_t + (1 - alpha) * z
        z_n = freeze(_clip(z_r + y / rho_v, l, u), z, done)
        y_n = freeze(y + rho_v * (z_r - z_n), y, done)
        iters = iters + (~done).to(torch.int32)

        # OSQP §3.5 infeasibility certificates on the iterate deltas
        dy = y_n - y
        dx = x_n - x
        ndy = torch.amax(torch.abs(dy), dim=-1)
        ndx = torch.amax(torch.abs(dx), dim=-1)
        Atdy = _mv(At, dy)
        pos, neg = torch.clamp(dy, min=0.0), torch.clamp(dy, max=0.0)
        sup = torch.sum(
            torch.where(u_fin, u * pos, torch.where(pos > 0, inf, 0.0).to(P.dtype))
            + torch.where(l_fin, l * neg, torch.where(neg < 0, inf, 0.0).to(P.dtype)),
            dim=-1,
        )
        eps_p = settings.prim_inf_tol
        pcert = (
            (ndy > 0)
            & (torch.amax(torch.abs(Atdy), dim=-1) <= eps_p * ndy)
            & (sup <= -eps_p * ndy)
        )
        Pdx = _mv(P, dx)
        Adx = _mv(A, dx)
        eps_d = settings.dual_inf_tol
        lim = eps_d * ndx[..., None]
        cone_ok = torch.all(
            torch.where(
                u_fin & l_fin, torch.abs(Adx) <= lim,
                torch.where(u_fin, Adx <= lim,
                            torch.where(l_fin, Adx >= -lim,
                                        torch.ones_like(Adx, dtype=torch.bool))),
            ),
            dim=-1,
        )
        dcert = (
            (ndx > 0)
            & (torch.amax(torch.abs(Pdx), dim=-1) <= eps_d * ndx)
            & (torch.sum(q * dx, dim=-1) <= -eps_d * ndx)
            & cone_ok
        )
        pinf = pinf | (pcert & ~done)
        dinf = dinf | (dcert & ~done)
        Ax = _mv(A, x_n)
        Px = _mv(P, x_n)
        Aty = _mv(At, y_n)
        prim = torch.amax(torch.abs(Ax - z_n), dim=-1)
        dual = torch.amax(torch.abs(Px + q + Aty), dim=-1)
        ps = torch.maximum(torch.amax(torch.abs(Ax), dim=-1),
                           torch.amax(torch.abs(z_n), dim=-1))
        ds = torch.maximum(
            torch.maximum(torch.amax(torch.abs(Px), dim=-1),
                          torch.amax(torch.abs(Aty), dim=-1)),
            torch.amax(torch.abs(q), dim=-1),
        )
        if check:
            done = done | (
                (prim <= settings.abs_tol + settings.rel_tol * ps)
                & (dual <= settings.abs_tol + settings.rel_tol * ds)
            )
        if settings.adaptive_rho and it % E == 0:
            rho = torch.where(~done, _rho_update(rho, prim, dual, ps, ds), rho)
        x, z, y = x_n, z_n, y_n

    if settings.polish:
        act, target = _active_targets(z, l.expand_as(z), u.expand_as(z))
        diagP = torch.abs(torch.diagonal(P, dim1=-2, dim2=-1))
        pen = settings.polish_penalty * torch.amax(diagP, dim=-1, keepdim=True)
        P_p = P + At @ (((act * pen)[..., :, None]) * A)
        q_p = q - _mv(At, act * pen * target)
        x = _mv(_gj_inv_std(P_p), -q_p)
    Ax = _mv(A, x)
    prim = torch.amax(torch.abs(Ax - z), dim=-1)
    dual = torch.amax(torch.abs(_mv(P, x) + q + _mv(At, y)), dim=-1)
    return ADMMResult(x, z, y, prim, dual, iters, pinf=pinf, dinf=dinf)


def mask_system(D, U, r, valid):
    """Apply a shared (K,) warm-up mask: dead slots become identity blocks
    with zero coupling and right-hand side."""
    s = D.shape[1]
    eye_l = lanes.eye(s, D.dtype, D.device)
    v = valid[:, None, None, None].to(D.dtype)
    D = D * v + eye_l[None] * (1.0 - v)
    r = r * valid[:, None, None].to(r.dtype)
    vU = (valid[:-1] & valid[1:])[:, None, None, None].to(U.dtype)
    return D, U * vU, r


def t_apply(D, U, xv):
    """Block-tridiagonal operator application in lanes layout (K,s,B)."""
    out = lanes.mv(D, xv)
    out[:-1] += lanes.mv(U, xv[1:])
    out[1:] += lanes.mv_t(U, xv[:-1])
    return out


def final_residuals(D, U, r, x, z, y):
    """prim = ‖x − z‖∞, dual = ‖Tx − r + y‖∞ per instance (B,)."""
    prim = _amax(x - z, (0, 1))
    dual = _amax(t_apply(D, U, x) - r + y, (0, 1))
    return prim, dual


def broadcast_bounds(lb, ub, s, B, dtype, device):
    """Normalize (s,) shared or (s,B) per-lane bounds to contiguous (s,B)
    tensors. A bound that is already a tensor must lie on ``device``."""
    out = []
    for name, a in (("lb", lb), ("ub", ub)):
        if isinstance(a, torch.Tensor) and a.device != device:
            raise ValueError(f"{name}: on {a.device}, expected {device}")
        a = torch.as_tensor(a, dtype=dtype, device=device)
        if a.ndim == 1:
            a = a[:, None].expand(s, B)
        if tuple(a.shape) != (s, B):
            raise ValueError(
                f"{name}: expected ({s},) or ({s},{B}), got {tuple(a.shape)}")
        out.append(a.contiguous())
    return out


def solve_box_tridiag_lanes(D, U, r, lb, ub, settings: ADMMSettings,
                            valid=None, z0=None, y0=None, x0=None):
    """Box-constrained block-tridiagonal QP in lanes layout:
    min ½xᵀTx − rᵀx s.t. lb ≤ x ≤ ub — the fleet-scale constrained MHE path.

    Layout: D (K,s,s,B), U (K-1,s,s,B), r (K,s,B) with the instance batch B
    on the trailing axis; bounds lb/ub are (s,) shared across the fleet or
    (s,B) per lane (±inf ⇒ unconstrained dim); ``valid`` is a shared (K,)
    warm-up mask; z0/y0 warm-start the iterates and x warm-starts from z0.

    Returns ADMMResult with x/z/y (K,s,B) and per-instance (B,) residuals
    and iteration counts.
    """
    K, s, B = D.shape[0], D.shape[1], r.shape[-1]
    sigma, alpha = settings.sigma, settings.alpha
    eye_l = lanes.eye(s, D.dtype, D.device)                 # (s,s,1)

    if valid is not None:
        D, U, r = mask_system(D, U, r, valid)

    lb_l, ub_l = broadcast_bounds(lb, ub, s, B, D.dtype, D.device)

    z = torch.zeros_like(r) if z0 is None else z0
    x = (z if z0 is not None else torch.zeros_like(r)) if x0 is None else x0
    y = torch.zeros_like(r) if y0 is None else y0
    rho = torch.full((B,), settings.rho, dtype=D.dtype, device=D.device)
    done = torch.zeros((B,), dtype=torch.bool, device=D.device)
    iters = torch.zeros((B,), dtype=torch.int32, device=D.device)
    check = settings.abs_tol > 0.0 or settings.rel_tol > 0.0
    E = max(1, int(settings.rho_update_every))

    def freeze(new_val, old_val):
        return torch.where(done[None, None, :], old_val, new_val)

    def factor(rho):
        return lanes.thomas_factor(
            D + (sigma + rho)[None, None, None, :] * eye_l[None], U)

    fac = factor(rho)
    for it in range(1, int(settings.iters) + 1):
        if settings.adaptive_rho and it > 1 and (it - 1) % E == 0:
            fac = factor(rho)
        rho_v = rho[None, None, :]            # broadcast over (K, s)
        rhs = r + sigma * x + rho_v * z - y
        x_t = lanes.thomas_solve_factored(fac, rhs)
        x_n = freeze(alpha * x_t + (1 - alpha) * x, x)
        z_r = alpha * x_t + (1 - alpha) * z
        z_n = freeze(_clip(z_r + y / rho_v, lb_l, ub_l), z)
        y_n = freeze(y + rho_v * (z_r - z_n), y)
        iters = iters + (~done).to(torch.int32)
        x, z, y = x_n, z_n, y_n

        if (check or settings.adaptive_rho) and it % E == 0:
            # epoch-boundary residuals (OSQP §3.4): freeze + ρ update
            prim = _amax(x - z, (0, 1))
            Tx = t_apply(D, U, x)
            dual = _amax(Tx - r + y, (0, 1))
            ps = torch.maximum(_amax(x, (0, 1)), _amax(z, (0, 1)))
            ds = torch.maximum(
                torch.maximum(_amax(Tx, (0, 1)), _amax(y, (0, 1))),
                _amax(r, (0, 1)))
            if check:
                done = done | (
                    (prim <= settings.abs_tol + settings.rel_tol * ps)
                    & (dual <= settings.abs_tol + settings.rel_tol * ds)
                )
            if settings.adaptive_rho:
                rho = torch.where(~done, _rho_update(rho, prim, dual, ps, ds), rho)

    if settings.polish:
        act, target = _active_targets(z, lb_l.expand_as(z), ub_l.expand_as(z))
        diagD = torch.abs(torch.movedim(
            torch.diagonal(D, dim1=1, dim2=2), -1, 1))      # (K,s,B)
        pen = settings.polish_penalty * (
            torch.amax(diagD, dim=-2, keepdim=True) + diagD)
        D_p = D + (act * pen)[:, :, None, :] * eye_l[None]
        r_p = r + act * pen * target
        x = lanes.thomas_solve(D_p, U, r_p)

    prim, dual = final_residuals(D, U, r, x, z, y)
    return ADMMResult(x, z, y, prim, dual, iters)


def _t_apply_std(D, U, xv):
    """Block-tridiagonal operator in standard layout: (K,…,s,s) on (K,…,s)."""
    out = _mv(D, xv)
    out[:-1] += _mv(U, xv[1:])
    out[1:] += _mv(U.transpose(-1, -2), xv[:-1])
    return out


def solve_box_tridiag(D, U, r, lb, ub, settings: ADMMSettings,
                      valid=None, z0=None, y0=None, x0=None):
    """Box-constrained block-tridiagonal QP in standard layout:
    min ½xᵀTx − rᵀx s.t. lb ≤ x ≤ ub, T given by diagonal blocks D
    (K,…,s,s) and couplings U (K-1,…,s,s), r (K,…,s). ``lb``/``ub`` are
    (s,) or broadcastable over the batch ((B,s) per lane); ±inf makes a
    dimension unconstrained. ``valid`` (K,…) is the warm-up mask; z0/y0
    warm-start the iterates and x warm-starts from z0.

    A = I, so the x-update matrix T + (σ+ρ)I stays block tridiagonal: it is
    factorized once per ρ-epoch (``tridiag.factor``, once for the whole run
    with fixed ρ) and the iterations in between are substitution sweeps
    (``tridiag.solve_factored``). At each epoch end the residuals drive the
    converged-freeze and the adaptive-ρ rule. Returns ADMMResult(x, z, y
    (K,…,s), prim, dual, iters (…))."""
    s = D.shape[-1]
    sigma, alpha = settings.sigma, settings.alpha
    eye = torch.eye(s, dtype=D.dtype, device=D.device)

    z = torch.zeros_like(r) if z0 is None else z0
    x = (z if z0 is not None else torch.zeros_like(r)) if x0 is None else x0
    y = torch.zeros_like(r) if y0 is None else y0
    batch_shape = r.shape[1:-1]
    rho = torch.full(batch_shape, settings.rho, dtype=D.dtype, device=D.device)
    done = torch.zeros(batch_shape, dtype=torch.bool, device=D.device)
    iters = torch.zeros(batch_shape, dtype=torch.int32, device=D.device)
    check = settings.abs_tol > 0.0 or settings.rel_tol > 0.0
    lb = torch.as_tensor(lb, dtype=D.dtype, device=D.device)
    ub = torch.as_tensor(ub, dtype=D.dtype, device=D.device)

    def freeze(new_val, old_val):
        return torch.where(done[None, ..., None], old_val, new_val)

    def factor(rho):
        return tridiag.factor(D + (sigma + rho)[..., None, None] * eye, U, valid=valid)

    fac = None if settings.adaptive_rho else factor(rho)
    E = max(1, int(settings.rho_update_every))
    n_full, rem = divmod(int(settings.iters), E)
    for length in [E] * n_full + ([rem] if rem else []):
        if settings.adaptive_rho:
            fac = factor(rho)
        rho_v = rho[..., None]
        for _ in range(length):
            rhs = r + sigma * x + rho_v * z - y
            x_t = tridiag.solve_factored(fac, rhs, valid=valid)
            x_n = freeze(alpha * x_t + (1 - alpha) * x, x)
            z_r = alpha * x_t + (1 - alpha) * z
            z_n = freeze(_clip(z_r + y / rho_v, lb, ub), z)
            y_n = freeze(y + rho_v * (z_r - z_n), y)
            iters = iters + (~done).to(torch.int32)
            x, z, y = x_n, z_n, y_n
        # epoch-end residuals (OSQP §3.4): converged-freeze and ρ update
        prim = _amax(x - z, (0, -1))
        Tx = _t_apply_std(D, U, x)
        dual = _amax(Tx - r + y, (0, -1))
        ps = torch.maximum(_amax(x, (0, -1)), _amax(z, (0, -1)))
        ds = torch.maximum(torch.maximum(_amax(Tx, (0, -1)), _amax(y, (0, -1))),
                           _amax(r, (0, -1)))
        if check:
            done = done | ((prim <= settings.abs_tol + settings.rel_tol * ps)
                           & (dual <= settings.abs_tol + settings.rel_tol * ds))
        if settings.adaptive_rho:
            rho = torch.where(~done, _rho_update(rho, prim, dual, ps, ds), rho)

    if settings.polish:
        act, target = _active_targets(z, lb.expand_as(z), ub.expand_as(z))
        diagD = torch.abs(torch.diagonal(D, dim1=-2, dim2=-1))
        pen = settings.polish_penalty * (torch.amax(diagD, dim=-1, keepdim=True) + diagD)
        x = tridiag.solve(D + (act * pen)[..., :, None] * eye, U, r + act * pen * target,
                          valid=valid)

    prim = _amax(x - z, (0, -1))
    dual = _amax(_t_apply_std(D, U, x) - r + y, (0, -1))
    return ADMMResult(x, z, y, prim, dual, iters)
