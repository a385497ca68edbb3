"""Operation and byte counts of the kernels, from shapes, schedule and the
iterations the box-ADMM actually ran.

Used to state each kernel's bound (the least time the card could take for the
same work): the bytes that must move — every input read once, every output
written once — and the floating-point operations the function needs.

The counting rule for operations. The algorithm is the one of ``csrc/*.cu``
(equally of ``ops/mhe_lanes.py`` and ``ops/ekf_lanes.py``), but only work on
structurally non-trivial operands counts:

* every matrix carries a pattern of structural zeros (``Z``), exact ±1 entries
  (``U``) and general values (``G``). A product counts one multiply per pair
  of ``G`` factors and one add per term of a sum beyond the first; a factor
  that is ``Z`` contributes nothing and a factor that is ``U`` is a copy.
  So the 0/1 selectors ``A_meas`` and ``P_cam`` cost no multiply, and the
  block-diagonal and block-triangular matrices (``A_dyn``, ``Q_dyn``,
  ``Q_meas``, the 6×6 and 9×9 covariance blocks of the assembly) cost only
  their blocks. The 3×3 noise matrices are general (dense) constants;
* with foot positions as states (``leg_odom_type`` 1: Cassie) the foot blocks
  of ``A_dyn`` are identities, those of ``Q_dyn`` dense 3×3 blocks, and the
  measurement rows of ``A_meas`` are ±1 selectors; the position-form weight
  of a leg is computed every tick whatever the contact;
* gravity is ``(0, 0, g)`` by construction, so only its third component
  multiplies;
* a product of constants only (``Q_accel_bias / dt²``, the Bezier polynomial
  coefficients of one VO event) is counted once per tick or event, not per use;
* a window slot that the warm-up masks to identity (tick ``t < N-1``) costs
  nothing, and camera terms count only in slots whose camera flag is set —
  both follow from the schedule, which ``mhe_schedule`` and ``ekf_schedule``
  walk on the host: the fleet's shared camera clock, or with a clock per lane
  each lane's own (``mhe_lane_schedules``), summed over the lanes. The stance
  covariance of a leg counts only for (tick, leg, instance) triples in stance;
* a Gauss-Jordan inverse of a dense n×n matrix is n(n+1)(2n−1) operations
  (n+1 divides and (n−1)(n+1) multiply-subtracts per elimination step), of an
  identity none; the Cholesky tail's factor of a dense n×n block is
  Σ_k (2k + 3 + (n−1−k)(2k+1)) (per pivot its k multiply-subtracts, the
  clamp, the square root and the reciprocal; per entry below it k
  multiply-subtracts and the multiply by the reciprocal), and its triangular
  solves and the symmetric Schur update count their structurally non-zero
  terms like the products;
* the box-ADMM (``admm_solve`` and the constrained ``mhe_tick``) counts what
  each instance ran: its iterations, the factorizations and residual checks
  that go with them (a converged instance stops), and the polish. The
  assembled window blocks are dense. Scratch traffic — the system, the
  factorization chain and the iterates that the kernels keep in global memory
  — is not counted in the bytes: inputs read once, outputs written once.
"""

from __future__ import annotations

import numpy as np

Z, U, G = 0, 1, 2


# ---- structural patterns ---------------------------------------------------

def _full(r, c, v=G):
    return np.full((r, c), v, np.int8)


def _eye(n):
    return np.where(np.eye(n, dtype=bool), U, Z).astype(np.int8)


def _put(dst, i, j, blk):
    dst[i:i + blk.shape[0], j:j + blk.shape[1]] = blk
    return dst


def _mm(a, b):
    """(pattern, operations) of the product a @ b."""
    nz = (a[:, :, None] != Z) & (b[None, :, :] != Z)
    mul = (a[:, :, None] == G) & (b[None, :, :] == G)
    terms = nz.sum(1)
    ops = int(mul.sum() + np.maximum(terms - 1, 0).sum())
    unit = (nz & ~((a[:, :, None] == G) | (b[None, :, :] == G))).sum(1)
    out = np.where(terms == 0, Z, np.where((terms == 1) & (unit == 1), U, G))
    return out.astype(np.int8), ops


def _add(a, b):
    """(pattern, operations) of a ± b: one add where both are non-zero."""
    both = (a != Z) & (b != Z)
    out = np.where(both, G, np.maximum(a, b))
    return out.astype(np.int8), int(both.sum())


def _gj(a):
    n = a.shape[0]
    if np.array_equal(a, _eye(n)):
        return a, 0
    return _full(n, n), n * (n + 1) * (2 * n - 1)


def _chol(a):
    """(pattern of the factor, operations) of ``smallmat.cuh``'s ``chol`` on
    a dense n×n block."""
    n = a.shape[0]
    return _full(n, n), sum(2 * k + 3 + (n - 1 - k) * (2 * k + 1) for k in range(n))


def _trsm_l(b):
    """(pattern, operations) of X = L⁻¹ b for a dense lower factor L, row by
    row as ``trsm_l`` does it: X[i] = (b[i] − Σ_{m<i} L[i][m] X[m]) · rd[i];
    a column of b stays zero down to its first non-zero row."""
    n, c = b.shape
    x = np.zeros((n, c), np.int8)
    ops = 0
    for i in range(n):
        for j in range(c):
            nx, nb = int((x[:i, j] != Z).sum()), int(b[i, j] != Z)
            if nx + nb:
                ops += 2 * nx + nb        # nx multiplies, nx + nb − 1 adds, · rd[i]
                x[i, j] = G
    return x, ops


def _syrk_sub(d, w):
    """(pattern, operations) of the lower triangle of d − wᵀw, the Cholesky
    tail's Schur update (``chol_step``): per entry a ≤ c of wᵀw its product
    terms, then the subtraction."""
    s = d.shape[0]
    out = d.copy()
    ops = 0
    for a in range(s):
        for c in range(a, s):
            nz = (w[:, a] != Z) & (w[:, c] != Z)
            mul = int(((w[:, a] == G) & (w[:, c] == G)).sum())
            terms = int(nz.sum())
            ops += mul + max(terms - 1, 0) + int(terms > 0 and d[c, a] != Z)
            if terms:
                out[c, a] = out[a, c] = G
    return out, ops


_INV3 = 41       # 9 cofactors (2 multiplies, 1 subtract), determinant 5, 9 divides
_NORMALIZE = 12  # 4 multiplies, 3 adds, a square root, 4 divides


# ---- tridiag_solve ----------------------------------------------------------

def tridiag(N, s, B, itemsize, n_states=None):
    """(bytes, operations) of one block-tridiagonal solve whose last
    ``n_states`` slots (default: all N) are real and the others the warm-up's
    identity blocks with zero coupling and right-hand side."""
    n_states = N if n_states is None else n_states
    D, Um, v = _full(s, s), _full(s, s), _full(s, 1)
    ops = _gj(D)[1] + _mm(D, v)[1]                       # first real slot, last x
    fwd = (_mm(D, Um)[1] + _mm(Um.T, D)[1] + s * s + 2 * _mm(D, v)[1] + s
           + _gj(D)[1])
    bwd = 2 * _mm(D, v)[1] + s
    ops += (n_states - 1) * (fwd + bwd)
    nbytes = itemsize * B * (N * s * s + (N - 1) * s * s + 2 * N * s)
    return nbytes, B * ops


def tridiag_batched(N, s, B, itemsize, n_states=None):
    """The standard-layout route (``tridiag_kernel.solve_batched``) per
    launch: {"solve": K5's own (bytes, operations) (``tridiag``), the
    function's own work and so its bound, "mask": the warm-up masking of D, U
    and r (each read and written once; a select of the identity is 2
    operations per element of D, a mask 1 per element of U and r), "layout":
    the moves of D, U and r to the lanes layout and of x back (each read and
    written once), "total"}. The mask and the layout moves are the glue's
    cost: a kernel that read the standard layout and masked in registers
    would not move those bytes."""
    D, Um, v = N * s * s, (N - 1) * s * s, N * s
    parts = {
        "solve": tridiag(N, s, B, itemsize, n_states),
        "mask": (itemsize * B * 2 * (D + Um + v), B * (2 * D + Um + v)),
        "layout": (itemsize * B * 2 * (D + Um + v + v), 0),
    }
    parts["total"] = tuple(sum(w[i] for w in parts.values()) for i in (0, 1))
    return parts


# ---- box-ADMM (admm_solve, and inside the constrained mhe_tick) --------------

_ADMM_RHS, _ADMM_UPDATE, _ADMM_RESID, _ADMM_RHO, _ADMM_ACTIVE = 5, 12, 10, 10, 10
# per element: rhs = r + sigma x + rho z - y; the x/z/y update (two relaxations,
# y/rho, the clip's two compares, the dual step); the epoch end's differences,
# absolute values and seven running maxima; per epoch end the tolerance tests
# and the rho rule; per element of the polish the two compares, the penalty and
# the pinned target


def admm_ops(s, n_states, iters, E, adaptive, check, polish):
    """Operations of box-ADMM solves on windows with ``n_states`` real slots
    (the others are the warm-up's identity blocks and cost nothing), summed
    over the instances whose iteration counts ``iters`` (any shape) lists."""
    iters = np.asarray(iters, np.int64).ravel()
    D, Um, v = _full(s, s), _full(s, s), _full(s, 1)
    mv = _mm(D, v)[1]
    link = n_states - 1
    factor = (n_states * (s + _gj(D)[1])
              + link * (_mm(D, Um)[1] + _mm(Um.T, D)[1] + s * s))
    iterate = (n_states * (s * (_ADMM_RHS + _ADMM_UPDATE) + mv)
               + link * (3 * mv + 2 * s))
    check_ops = (n_states * (mv + s * _ADMM_RESID) + link * 2 * (mv + s)
                 + _ADMM_RHO)
    E = max(1, int(E))
    n_full = iters // E
    n_factor = (-(-iters // E)) if adaptive else np.minimum(iters, 1)
    ops = int((n_factor * factor + iters * iterate).sum())
    if check or adaptive:
        ops += int((n_full * check_ops).sum())
    if polish:
        sweep = tridiag(n_states, s, 1, 1)[1]
        ops += iters.size * (sweep + n_states * (s * _ADMM_ACTIVE + s - 1))
    return ops


def admm(N, s, B, itemsize, iters, E, adaptive, check, polish, n_states=None):
    """(bytes, operations) of one ``admm_solve`` call: D, U, r, the z/y warm
    starts and the per-lane bounds in; x, z, y and the iteration counts out.
    ``iters`` (B,) is what the call returned."""
    n_states = N if n_states is None else n_states
    nbytes = (itemsize * B * (N * s * s + (N - 1) * s * s + 6 * N * s + 2 * s)
              + 4 * B)
    return nbytes, admm_ops(s, n_states, iters, E, adaptive, check, polish)


# ---- ekf_stage --------------------------------------------------------------

def _ekf_ops(quirk_W):
    """Operations of (predict + accel_correct, vo_correct) for one instance."""
    P, q = _full(4, 4), _full(4, 1)
    F = np.where(np.eye(4, dtype=bool), U, G).astype(np.int8)
    W = _full(4, 3)
    if quirk_W:
        W[3, 1:] = Z
    FP, o1 = _mm(F, P)
    _, o2 = _mm(FP, F.T)
    WC, o3 = _mm(W, _full(3, 3))
    WCW, o4 = _mm(WC, W.T)
    predict = (3 + _mm(F, q)[1] + _NORMALIZE + int((W != Z).sum())
               + o1 + o2 + o3 + o4 + _add(_full(4, 4), WCW)[1])
    H = _full(3, 4)
    HP, a1 = _mm(H, P)
    _, a2 = _mm(HP, H.T)
    PHt, a3 = _mm(P, H.T)
    K, a4 = _mm(PHt, _full(3, 3))
    _, a5 = _mm(K, _full(3, 1))
    KH, a6 = _mm(K, H)
    _, a7 = _mm(KH, P)
    # third row of R(q) (13) times g, the four distinct ±2g·q entries of H,
    # (|a|/g)², S += rel²·C_accel, inv3, innovation, q += dq, I − KH
    accel = (_NORMALIZE + 13 + 3 + 4 + 6 + a1 + a2 + 18 + _INV3 + a3 + a4 + 3
             + a5 + 4 + _NORMALIZE + a6 + 4 + a7)
    vo = (16 + _gj(P)[1] + _mm(P, P)[1] + 4 + _mm(P, q)[1] + 4 + _NORMALIZE
          + 4 + _mm(P, P)[1])
    return predict + accel, vo


def ekf_schedule(valid, vo_active, vo_sb, R, t0=0):
    """Walk the shared schedule on the host: returns (number of valid
    substeps, number of replayed substeps, number of VO corrections).
    ``valid``/``vo_active``/``vo_sb`` are nested (T,S) lists."""
    t, n_valid, n_replayed, n_vo = t0, 0, 0, 0
    for vrow, arow, srow in zip(valid, vo_active, vo_sb):
        for v, a, sb in zip(vrow, arow, srow):
            if not v:
                continue
            n_valid += 1
            if a and 1 <= sb <= t and sb < R:
                n_replayed += sb - 1
                n_vo += 1 if sb > 1 else 0
            t += 1
    return n_valid, n_replayed, n_vo


def ekf(T, B, R, n_valid, n_replayed, n_vo, per_lane_vo_q, itemsize,
        quirk_W=True):
    """(bytes, operations) of one EKF-stage call over T ticks."""
    step, vo = _ekf_ops(quirk_W)
    ops = B * ((n_valid + n_replayed) * step + n_vo * vo)
    state = 4 + 16 + R * (3 + 3 + 4 + 16)
    nbytes = itemsize * B * (n_valid * 6 + 2 * state + T * 4
                             + (n_vo * 4 if per_lane_vo_q else 0))
    return nbytes, ops


# ---- mhe_tick ---------------------------------------------------------------

def mhe_schedule(active, tick_pre, tick_now, N, bez_count=0):
    """Walk the shared VO schedule of one ``replay_ticks`` call that starts at
    tick 1 from the init window (no camera terms set). Per tick returns
    ``(n_states, cam, marg_cam, vo)``: the number of real window slots, the
    camera flag of each of the N slots of the solve (oldest first), the flag of
    the slot being marginalized (None when t < N), and for a tick with a VO
    pair ``(nodes, written)`` — Bezier nodes evaluated and slots written —
    else None."""
    cam = set()          # absolute ticks whose interval carries a camera term
    out = []
    for i, (a, pre, now) in enumerate(zip(active, tick_pre, tick_now)):
        t = i + 1
        vo = None
        if a:
            bez_count += 1
            w0 = t - min(N, t)
            start = max(w0, pre)
            nodes = written = 0
            if now > w0 and bez_count >= 4:
                ks = [k for k in range(N)
                      if k <= now - start - 1 and 0 <= start + k - t + N <= N - 2]
                cam.update(start + k for k in ks)
                written = len(ks)
                nodes = (ks[-1] - ks[0] + 2) if ks else 0
            vo = (nodes, written)
        marg_cam = ((t - N) in cam) if t >= N else None
        n_states = min(t + 1, N)
        first = N - n_states
        flags = tuple(first <= j <= N - 2 and (t - N + 1 + j) in cam
                      for j in range(N))
        out.append((n_states, flags, marg_cam, vo))
    return out


def mhe_lane_schedules(active, tick_pre, tick_now, N, bez_count=0):
    """A camera clock per lane: ``active``/``tick_pre``/``tick_now`` are
    (Tn,B) arrays and ``bez_count`` the lanes' (B,) Bezier counts at the start
    (or one count for all). Each lane's schedule is ``mhe_schedule`` of its
    own column; lanes with the same events share one walk. Returns
    ``[(n_lanes, schedule), ...]`` for ``mhe_tick_lanes``."""
    act = np.asarray(active, bool)
    Tn, B = act.shape
    pre = np.where(act, np.asarray(tick_pre, np.int64), 0)
    now = np.where(act, np.asarray(tick_now, np.int64), 0)
    cnt = np.broadcast_to(np.asarray(bez_count, np.int64).ravel(), (B,))
    key = np.concatenate([act.T.astype(np.int64), pre.T, now.T, cnt[:, None]], axis=1)
    rows, n = np.unique(key, axis=0, return_counts=True)
    return [(int(k), mhe_schedule(r[:Tn].astype(bool).tolist(), r[Tn:2 * Tn].tolist(),
                                  r[2 * Tn:3 * Tn].tolist(), N, int(r[-1])))
            for r, k in zip(rows, n)]


class _Patterns:
    """Patterns of the per-slot matrices: leg_odom_type 0 (s=9, m=3L) or 1
    (foot positions as states, s=9+3L, m=3L)."""

    def __init__(self, s, m, L, lot=0):
        assert lot in (0, 1) and s == 9 + 3 * lot * L and m == 3 * L, (s, m, L, lot)
        R3, I3 = _full(3, 3), _eye(3)
        dI = np.where(np.eye(3, dtype=bool), G, Z).astype(np.int8)
        self.A = np.zeros((s, s), np.int8)
        for k in range(3):
            _put(self.A, 3 * k, 3 * k, I3)
        _put(self.A, 0, 3, dI)
        _put(self.A, 0, 6, R3)
        _put(self.A, 3, 6, R3)
        self.Qd = np.zeros((s, s), np.int8)
        _put(self.Qd, 0, 0, _full(6, 6))
        _put(self.Qd, 6, 6, R3)
        self.b = np.zeros((s, 1), np.int8)
        self.b[:6] = G
        self.H = np.zeros((m, s), np.int8)
        for leg in range(L):
            if lot == 0:
                _put(self.H, 3 * leg, 3, I3)
            else:                       # rows [-I 0 0 | I at the leg's foot]
                _put(self.H, 3 * leg, 0, I3)
                _put(self.H, 3 * leg, 9 + 3 * leg, I3)
                _put(self.A, 9 + 3 * leg, 9 + 3 * leg, I3)
                _put(self.Qd, 9 + 3 * leg, 9 + 3 * leg, R3)
        self.Pc = np.zeros((3, s), np.int8)
        _put(self.Pc, 0, 0, I3)
        self.Qm = np.zeros((m, m), np.int8)
        for leg in range(L):
            _put(self.Qm, 3 * leg, 3 * leg, R3)
        self.s, self.m, self.L, self.lot = s, m, L, lot
        # cached per-slot terms: H^T R H, H^T R y, A^T Qd, A^T Qd A, A^T Qd b
        HtR, o1 = _mm(self.H.T, self.Qm)
        self.HtRH, o2 = _mm(HtR, self.H)
        self.HtRy, o3 = _mm(HtR, _full(m, 1))
        self.meas_ops = o1 + o2 + o3
        self.AtQd, o4 = _mm(self.A.T, self.Qd)
        self.AtQdA, o5 = _mm(self.AtQd, self.A)
        self.AtQdb, o6 = _mm(self.AtQd, self.b)
        self.dyn_ops = o4 + o5 + o6
        PtQc, _ = _mm(self.Pc.T, R3)
        self.PtQc = PtQc
        self.PtQcP, _ = _mm(PtQc, self.Pc)
        self.PtQc_c, self.cam_vec_ops = _mm(PtQc, _full(3, 1))


def _assembly_ops(p, build=True):
    """Operations of one tick's assembly for one instance, the stance
    covariances apart: (per tick, per stance leg). The foot-position form
    (lot 1) has no stance-dependent work. Without ``build`` (the stage
    ablation "build") the fresh slot's dynamics, camera weight and
    measurement are zeros that cost nothing; the cache updates still run."""
    R3 = _full(3, 3)
    # build_dynamics: dt·R, dt²/2·R, the two products with accel_s, then
    # C_pv = G C G^T by block and its 6x6 inverse
    Gm = np.zeros((6, 6), np.int8)
    _put(Gm, 0, 0, R3), _put(Gm, 0, 3, R3), _put(Gm, 3, 3, R3)
    Cc = np.zeros((6, 6), np.int8)
    _put(Cc, 0, 0, R3), _put(Cc, 3, 3, R3)
    GC, o1 = _mm(Gm, Cc)
    Cpv, o2 = _mm(GC, Gm.T)
    dyn = 18 + 6 + o1 + o2 + _gj(Cpv)[1]
    qcam = 2 * _mm(R3, R3)[1]                      # R Q_vo_p R^T
    # cache update of the slot that just got its dynamics
    upd = (p.dyn_ops + _add(p.HtRH, p.AtQdA)[1] + _add(p.HtRy, p.AtQdb)[1])
    # build_measurement, per leg: y = -(R J dq) - R (w x p)
    v3 = _full(3, 1)
    y_leg = _mm(R3, R3)[1] + 2 * _mm(R3, v3)[1] + 9 + 3
    skew = np.where(np.eye(3, dtype=bool), Z, G).astype(np.int8)
    wJ, s1 = _mm(skew, R3)
    Gl = np.concatenate([R3, wJ, skew], axis=1)
    Cb = np.zeros((9, 9), np.int8)
    for k in range(3):
        _put(Cb, 3 * k, 3 * k, R3)
    GCl, s2 = _mm(Gl, Cb)
    _, s3 = _mm(GCl, Gl.T)
    stance = s1 + s2 + s3 + 2 * _mm(R3, R3)[1] + _INV3
    fresh = p.meas_ops                               # cache of the newest slot
    prev = _mm(R3, v3)[1] + 3                        # accel_s = R a + g
    if p.lot == 1:
        # per leg: foot noise R Q_foot R^T / dt^2 in the dynamics; y = R p and
        # the weight R (J C J^T)^-1 R^T in the measurement
        foot = 2 * _mm(R3, R3)[1] + 9
        meas = _mm(R3, v3)[1] + 4 * _mm(R3, R3)[1] + _INV3
        built, stance = dyn + qcam + p.L * (foot + meas), 0
    else:
        built = dyn + qcam + p.L * y_leg
    if not build:
        return upd + fresh + prev, 0
    return built + upd + fresh + prev, stance


class _Tally:
    """Pattern arithmetic that adds up its operations in ``ops``."""

    def __init__(self):
        self.ops = 0

    def _take(self, res):
        self.ops += res[1]
        return res[0]

    def mm(self, a, b):
        return self._take(_mm(a, b))

    def add(self, a, b):
        return self._take(_add(a, b))

    def gj(self, a):
        return self._take(_gj(a))

    def chol(self, a):
        return self._take(_chol(a))

    def trsm(self, b):
        return self._take(_trsm_l(b))

    def syrk_sub(self, d, w):
        return self._take(_syrk_sub(d, w))


def _marg_ops(p, cam):
    """Operations of one arrival-cost marginalization for one instance."""
    s = p.s
    k = _Tally()
    k.ops = p.dyn_ops + p.meas_ops + (p.cam_vec_ops if cam else 0)
    app = p.PtQcP if cam else np.zeros_like(p.PtQcP)
    cvec = p.PtQc_c if cam else np.zeros_like(p.PtQc_c)
    Qdb = k.mm(p.Qd, p.b)
    Sm = k.add(k.add(k.add(_full(s, s), p.AtQdA), p.HtRH), app)
    C01 = k.add(p.AtQd, app)
    D1 = k.add(p.Qd, app)
    l0 = k.add(k.add(k.add(_full(s, 1), p.AtQdb), p.HtRy), cvec)
    l1 = k.add(Qdb, cvec)
    Sinv = k.gj(Sm)
    k.add(D1, k.mm(C01.T, k.mm(Sinv, C01)))          # new M_p
    k.add(l1, k.mm(C01.T, k.mm(Sinv, l0)))           # new n_p
    return k.ops


def _solve_ops(p, N, n_states, cam, sweep=True, tail="gj"):
    """Operations of the masked normal equations and (``sweep``) the streaming
    forward block-Thomas sweep of one tick for one instance, with the
    Gauss-Jordan (``tail`` "gj") or the Cholesky tail ("chol")."""
    s = p.s
    first = N - n_states
    zero, zvec = np.zeros((s, s), np.int8), np.zeros((s, 1), np.int8)
    Sinv, yv, U_prev = _eye(s), zvec, zero
    prev_QdPP, prev_rin = zero, zvec
    k = _Tally()
    for j in range(first, N):
        iv = j <= N - 2
        PtQcP = p.PtQcP if cam[j] else zero
        cvec = p.PtQc_c if cam[j] else zvec
        k.ops += p.cam_vec_ops if cam[j] else 0
        Qd = p.Qd if iv else zero
        Qd_b = k.mm(Qd, p.b)
        # the cached slot terms: measurement only for the newest slot
        D = _add(p.HtRH, p.AtQdA)[0] if iv else p.HtRH
        r = _add(p.HtRy, p.AtQdb)[0] if iv else p.HtRy
        D = k.add(k.add(D, PtQcP), prev_QdPP)
        r = k.add(k.add(r, cvec), prev_rin)
        if j == first:                                # arrival cost M_p, n_p
            D = k.add(D, _full(s, s))
            r = k.add(r, _full(s, 1))
        prev_QdPP = k.add(Qd, PtQcP)
        prev_rin = k.add(Qd_b, cvec)
        Uj = k.add(p.AtQd, PtQcP) if iv else zero
        if not sweep:
            continue
        if tail == "chol":
            # W = L⁻¹U_prev, S = D − WᵀW, yv = r − Wᵀ(L⁻¹yv), then L of S
            W = k.trsm(U_prev)
            D = k.syrk_sub(D, W)
            yv = k.add(r, k.mm(W.T, k.trsm(yv)))
            k.chol(D)
        else:
            D = k.add(D, k.mm(U_prev.T, k.mm(Sinv, U_prev)))
            yv = k.add(r, k.mm(U_prev.T, k.mm(Sinv, yv)))
            Sinv = k.gj(D)
        U_prev = Uj
    if sweep and tail == "chol":
        k.trsm(k.trsm(yv))          # x = L⁻ᵀ(L⁻¹yv): two dense triangular solves
    elif sweep:
        k.mm(Sinv, yv)
    return k.ops


# per VO event: p_accum += inc, t_now; with Bezier increments also the
# interval and its reciprocal steps (5) and the cubic's coefficients (13 per
# axis); per node u, u², u³ and a three-term Horner sum per axis; per written
# slot one difference per axis
_VO_EVENT, _VO_SETUP, _VO_NODE, _VO_WRITE = 4, 5 + 39, 4 + 18, 3


def _ablated_solve_ops(p, N, n_states, cam, ablate):
    """The window work of a tick whose stage ``ablate`` is "assembly" (none:
    x is the arrival cost's vector) or "solve" (the masked system, then per
    slot column 0 of D and U added to r and the sum over the slots)."""
    if ablate == "assembly":
        return 0
    s = p.s
    return _solve_ops(p, N, n_states, cam, sweep=False) + N * 2 * s + (N - 1) * s


def _mhe_ops(N, s, m, L, groups, n_stance, box, lot, tail="gj", ablate=""):
    """Operations of one MHE-tick call for ``groups`` of lanes, each
    ``(n_lanes, schedule)`` with its own schedule (see ``mhe_tick``)."""
    p = _Patterns(s, m, L, lot)
    per_tick, stance = _assembly_ops(p, build=ablate != "build")
    marg = {c: _marg_ops(p, c) for c in (False, True)}
    solve = {}
    ops = 0
    for n_lanes, schedule in groups:
        lane = 0
        for n_states, cam, marg_cam, vo in schedule:
            if ablate == "ingest":      # no VO: no camera terms, no Bezier work
                cam, vo = (False,) * N, None
                marg_cam = None if marg_cam is None else False
            if ablate == "marg":
                marg_cam = None
            key = (n_states, cam)
            if key not in solve:
                solve[key] = (_ablated_solve_ops(p, N, n_states, cam, ablate)
                              if ablate in ("assembly", "solve") else
                              _solve_ops(p, N, n_states, cam, sweep=box is None, tail=tail))
            lane += per_tick + solve[key]
            if marg_cam is not None:
                lane += marg[marg_cam]
            if vo is not None:
                nodes, written = vo
                lane += _VO_EVENT + (_VO_SETUP + nodes * _VO_NODE
                                     + written * _VO_WRITE if nodes else 0)
        ops += n_lanes * lane
    if box is not None and ablate != "assembly":   # "assembly" runs no ADMM
        # the window's real slots follow the tick alone, not the clock
        ops += sum(admm_ops(s, n_states, np.asarray(box[0][i]), *box[1:])
                   for i, (n_states, *_) in enumerate(groups[0][1]))
    return ops + n_stance * stance


def _mhe_bytes(N, s, m, L, B, Tn, itemsize, box, ablate=""):
    # per tick R, accel, omega, p_foot, J_foot, dq, contact, vo_inc; without
    # the ingestion vo_inc is not read, without the build omega, p_foot,
    # J_foot and dq are not
    per_tick_in = (9 + 3 + 3 + L * 3 + L * 9 + L * 3 + L + 3
                   - (3 if ablate == "ingest" else 0)
                   - (3 + L * 15 if ablate == "build" else 0))
    state = (N * (m + m * m + 3 * s * s + 2 * s + 3 + 9 + 1 + s * s)
             + s * s + s + 12 + 3 + 9 + 3 + L)
    nbytes = itemsize * B * (Tn * (per_tick_in + s) + 2 * state)
    if box is not None:
        nbytes += itemsize * B * (4 * N * s + 2 * s) + 4 * Tn * B
    return nbytes


def mhe_tick(N, s, m, L, B, schedule, n_stance, itemsize, box=None, lot=0, tail="gj",
             ablate=""):
    """(bytes, operations) of one MHE-tick call over ``len(schedule)`` ticks
    starting at tick 1, on the fleet's shared camera clock, for the model
    shape (s, m, L, ``lot`` = leg_odom_type). ``schedule`` comes from
    ``mhe_schedule``; ``n_stance`` is the number of (tick, leg, instance)
    triples in stance (unused with foot-position states). For the constrained variant ``box`` is
    ``(iters, E, adaptive, check, polish)`` with ``iters`` the (Tn, B) ADMM
    iterations that were run: the Thomas sweep gives way to one box-ADMM per
    tick and instance, and the z/y warm starts, the bounds and the iteration
    counts join the bytes. ``tail`` is the unconstrained sweep's tail, "gj"
    or "chol" (the box variant has none). ``ablate`` (any tick) counts the
    work left once that stage is dropped:
    "ingest" — no VO events, so no Bezier work and no camera terms anywhere,
    and no ``vo_inc`` read; "marg" — no marginalization; "build" — no
    dynamics, camera-weight or measurement build (the caches are still
    updated), and the per-tick inputs only the build reads are not read;
    "assembly" — no window work (with ``box`` no ADMM); "solve" — the masked
    system and the sum that stands in for its solution, no sweep (no such
    stage with ``box``). With ``tail`` "chol" the stages before the tail
    count its sweep; its tail-free stages count as the Gauss-Jordan tick's."""
    return (_mhe_bytes(N, s, m, L, B, len(schedule), itemsize, box, ablate),
            _mhe_ops(N, s, m, L, [(B, schedule)], n_stance, box, lot, tail, ablate))


def mhe_tick_lanes(N, s, m, L, groups, n_stance, itemsize, box=None, lot=0, tail="gj",
                   ablate=""):
    """``mhe_tick`` with a camera clock per lane: ``groups`` from
    ``mhe_lane_schedules``. Each lane's camera terms and Bezier work follow
    its own schedule; the (Tn,B) VO metadata (not read without the
    ingestion) and the per-lane Bezier schedule (read and written) join the
    bytes. ``tail`` and ``ablate`` as in ``mhe_tick``."""
    B = sum(n for n, _ in groups)
    Tn = len(groups[0][1])
    nbytes = (_mhe_bytes(N, s, m, L, B, Tn, itemsize, box, ablate)
              + (0 if ablate == "ingest" else 4 * B * 3 * Tn) + 2 * B * (4 * itemsize + 4))
    return nbytes, _mhe_ops(N, s, m, L, groups, n_stance, box, lot, tail, ablate)
