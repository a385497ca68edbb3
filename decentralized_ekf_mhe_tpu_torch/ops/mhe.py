"""Moving Horizon Estimator — fixed-shape window engine and exact QP solve,
in standard layout (…, N, s, s).

Counterpart of the reference ``ops/mhe.py`` (MheSrb.cpp with the formulation
side of DecentralEst.cpp): static ring tensors over N window slots (after
step T, slot j holds tick T−(N−1−j); interval j couples slots j and j+1);
delayed VO equalities activated per slot; the slack variables eliminated
analytically, so the QP is an SPD block-tridiagonal system in the states,
solved exactly (``ops/tridiag.py``) or, with state box constraints, by the
OSQP-semantics box-ADMM (``ops/admm.solve_box_tridiag``); the arrival cost
updated by one Schur complement per tick (MheSrb.cpp:475-713).

Everything broadcasts over leading batch axes: a single instance (N, …) or a
fleet (B, N, …) — ``estimator.run_mhe`` with time-leading (T, B, …) data, the
fleet runner ``parallel.batch.make_fused_batched_runner``. With ``use_pallas``
consts, no box and one batch axis, the window solve takes the
block-tridiagonal kernel's standard-layout route
(``kernels/tridiag_kernel.solve_batched``), as the reference takes its Pallas
kernel there. The lanes fleet engine (``ops/mhe_lanes.py``) uses the
constants of this module.

The reference's ``lax.cond`` branches (VO this tick; window full) read the
host: the tick counter ``T`` is a Python int and the VO schedule is host data,
so a tick reads no device scalar.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from decentralized_ekf_mhe_tpu_torch.config import EstimatorParams, std_to_gain
from decentralized_ekf_mhe_tpu_torch.ops import assembly, bezier, smallmat, tridiag
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device


class MHEConsts(NamedTuple):
    nc: assembly.NoiseConsts
    A_meas: torch.Tensor   # (m,s)
    P_cam: torch.Tensor    # (3,s) position selector [I 0 …]
    Q_vo_p: torch.Tensor   # (3,3)
    N: int
    dim_state: int
    dim_meas: int
    dt: float
    leg_odom_type: int
    num_legs: int
    # state box constraints. None ⇒ unconstrained (exact tridiagonal solve);
    # set ⇒ the OSQP-semantics ADMM path (ops/admm.py) with the given budget
    x_lb: object = None       # (s,) or (s,B) tensor, or None
    x_ub: object = None
    admm: object = None       # admm.ADMMSettings or None
    # route the window solve through the hand-written kernels
    # (kernels/tridiag_kernel.py, or kernels/admm_kernel.py when constrained)
    # — the field keeps the reference's name so call sites read the same on
    # both sides
    use_pallas: bool = False


def make_consts(p: EstimatorParams, dtype=torch.float32,
                x_lb=None, x_ub=None, admm_iters=None,
                use_pallas: bool = False, device="cuda") -> MHEConsts:
    """Build static MHE constants on ``device``. Passing x_lb/x_ub ((s,)
    shared or (s,B) per-lane arrays; ±inf for unconstrained dims; a missing
    side is filled with ∓inf) switches the window solve to the ADMM path with
    the OSQP settings of ``p.osqp`` and a fixed iteration budget
    ``admm_iters`` (default min(maxQPIter, 200))."""
    from decentralized_ekf_mhe_tpu_torch.ops import admm as admm_lib

    device = resolve_device(device)
    s = p.dim_state
    P = np.zeros((3, s))
    P[:, :3] = np.eye(3)
    constrained = x_lb is not None or x_ub is not None

    def f(a):
        if isinstance(a, torch.Tensor):
            return a.to(dtype=dtype, device=device)
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            dtype=dtype, device=device)

    return MHEConsts(
        nc=assembly.make_noise_consts(p, dtype, device=device),
        A_meas=assembly.a_meas(p, dtype, device=device),
        P_cam=f(P),
        Q_vo_p=f(std_to_gain(p.vo_p_std)),
        N=p.N,
        dim_state=s,
        dim_meas=p.dim_meas,
        dt=p.dt,
        leg_odom_type=p.leg_odom_type,
        num_legs=p.num_legs,
        x_lb=f(x_lb if x_lb is not None else np.full(s, -np.inf))
        if constrained else None,
        x_ub=f(x_ub if x_ub is not None else np.full(s, np.inf))
        if constrained else None,
        admm=admm_lib.ADMMSettings.from_osqp(p.osqp, admm_iters)
        if constrained else None,
        use_pallas=use_pallas,
    )


def _params_view(c: MHEConsts) -> EstimatorParams:
    """Static params needed by the assembly functions."""
    p = EstimatorParams()
    p.num_legs = c.num_legs
    p.leg_odom_type = c.leg_odom_type
    p.rate = int(round(1.0 / c.dt))
    return p


class MHEState(NamedTuple):
    # measurement at slot j
    y_meas: torch.Tensor      # (…,N,m)
    Q_meas: torch.Tensor      # (…,N,m,m)
    # interval j: slot j → j+1 (only j ≤ N−2 meaningful)
    A_dyn: torch.Tensor       # (…,N,s,s)
    b_dyn: torch.Tensor       # (…,N,s)
    Q_dyn: torch.Tensor       # (…,N,s,s)
    b_cam: torch.Tensor       # (…,N,3) the equality bound value (= −Δp)
    Q_cam: torch.Tensor       # (…,N,3,3)
    cam_active: torch.Tensor  # (…,N) bool
    # arrival cost 0.5 xᵀM_p x + n_pᵀx on the oldest live state
    M_p: torch.Tensor         # (…,s,s)
    n_p: torch.Tensor         # (…,s)
    T: int                    # newest tick in the window
    bez: bezier.BezierCarry   # shared schedule, its count a host int
    # previous tick's inputs, consumed by the next interval's dynamics
    # (UpdateMHE reads the stacks before GetMeasurement pushes tick T,
    # DecentralEst.cpp:374-375)
    prev_R: torch.Tensor        # (…,3,3)
    prev_accel_s: torch.Tensor  # (…,3)
    prev_contact: torch.Tensor  # (…,L)
    # ADMM warm-start iterates of the constrained path, shifted with the
    # window (OSQP setWarmStart(true), DecentralEst.cpp:204); zeros and
    # unused on unconstrained consts
    z_adm: torch.Tensor       # (…,N,s)
    y_adm: torch.Tensor       # (…,N,s)


def _mv(M, v):
    """(…, i, j) @ (…, j) -> (…, i)."""
    return (M @ v[..., None])[..., 0]


def init(c: MHEConsts, R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact,
         dtype=torch.float32, device="cuda") -> MHEState:
    """Tick-0 initialization (InitializeMHE, DecentralEst.cpp:200-351): the
    prior seeds the arrival pair (M_p, n_p) = (Q_prior, −Q_prior·x̂) as the
    first marginalization would (MheSrb.cpp:517-522). The inputs must lie on
    ``device``."""
    device = resolve_device(device)
    N, s, m = c.N, c.dim_state, c.dim_meas
    p = _params_view(c)
    y0, _, Q0 = assembly.build_measurement(p, c.nc, R_sb, omega_b, p_foot,
                                           J_foot, dq, contact)
    x_prior, Q_prior, _ = assembly.prior_state(p, c.nc, y0)
    batch = tuple(y0.shape[:-1])
    z = lambda *shape: torch.zeros(batch + shape, dtype=dtype, device=device)
    y_meas, Q_meas = z(N, m), z(N, m, m)
    y_meas[..., N - 1, :] = y0
    Q_meas[..., N - 1, :, :] = Q0
    return MHEState(
        y_meas=y_meas, Q_meas=Q_meas,
        A_dyn=z(N, s, s), b_dyn=z(N, s), Q_dyn=z(N, s, s),
        b_cam=z(N, 3), Q_cam=z(N, 3, 3),
        cam_active=torch.zeros(batch + (N,), dtype=torch.bool, device=device),
        M_p=Q_prior,
        n_p=-_mv(Q_prior, x_prior),
        T=0,
        bez=bezier.init(dtype, batch=batch, device=device)._replace(count=0),
        prev_R=R_sb,
        prev_accel_s=assembly.spatial_accel(R_sb, accel_b, c.nc),
        prev_contact=contact,
        z_adm=z(N, s), y_adm=z(N, s),
    )


def _marginalize(c: MHEConsts, st: MHEState):
    """Fold slot 0 into the arrival pair (marginalizeQP, MheSrb.cpp:475-713).

    With A=A_dyn₀, Qd=Q_dyn₀, H=A_meas, R=Q_meas₀, P=P_cam, Qc=Q_cam₀,
    c₀=b_cam₀, y=y_meas₀ and act the VO flag of interval 0:
        S   = M + AᵀQdA + HᵀRH + act·PᵀQcP
        C01 = −(AᵀQd + act·PᵀQcP),   D1 = Qd + act·PᵀQcP
        l0  = n − AᵀQd·b − HᵀR·y − act·PᵀQc·c₀,   l1 = Qd·b + act·PᵀQc·c₀
        M'  = D1 − C01ᵀ S⁻¹ C01,   n' = l1 − C01ᵀ S⁻¹ l0
    act=0 is the VO-inactive branch (MheSrb.cpp:601-651)."""
    A = st.A_dyn[..., 0, :, :]
    b = st.b_dyn[..., 0, :]
    Qd = st.Q_dyn[..., 0, :, :]
    H, P = c.A_meas, c.P_cam
    R = st.Q_meas[..., 0, :, :]
    y = st.y_meas[..., 0, :]
    Qc = st.Q_cam[..., 0, :, :]
    c0 = st.b_cam[..., 0, :]
    act_v = st.cam_active[..., 0].to(A.dtype)[..., None]
    act = act_v[..., None]

    AtQd = A.transpose(-1, -2) @ Qd
    PtQc = P.transpose(-1, -2) @ Qc                   # (…,s,3)
    PtQcP = PtQc @ P
    HtR = H.transpose(-1, -2) @ R

    S = st.M_p + AtQd @ A + HtR @ H + act * PtQcP
    C01 = -(AtQd + act * PtQcP)
    D1 = Qd + act * PtQcP
    l0 = st.n_p - _mv(AtQd, b) - _mv(HtR, y) - act_v * _mv(PtQc, c0)
    l1 = _mv(Qd, b) + act_v * _mv(PtQc, c0)
    Sinv = smallmat.gj_inv(S)
    C01t = C01.transpose(-1, -2)
    M_new = D1 - C01t @ (Sinv @ C01)
    n_new = l1 - _mv(C01t, _mv(Sinv, l0))
    return M_new, n_new


def _apply_vo(c: MHEConsts, st: MHEState, vo_R_pre, vo_dp, vo_tick_pre: int,
              vo_tick_now: int):
    """VO sync, Bezier waypoint and the activation of the VO equalities
    (GetMeasurement's VO block, DecentralEst.cpp:883-945, and
    UpdateVOConstraints :987-1009), at tick T = st.T+1 against the window
    before this tick's shift.

    ``vo_R_pre`` (…,3,3) is the orientation at tick ``vo_tick_pre`` (the
    R_vo_sb_pre of DecentralEst.cpp:915); ``vo_dp`` (3,) or (…,3). The
    reference scatters the per-slot increments and drops out-of-range
    targets; the schedule is host data here, so the slots written are a
    range decided on the host, and nothing outside it is touched. The
    Bezier count is a host int, so no branch reads the device."""
    N = c.N
    dtype, dev = st.prev_accel_s.dtype, st.prev_accel_s.device
    dt = torch.as_tensor(c.dt, dtype=dtype, device=dev)
    T = st.T + 1

    p_accum = st.bez.p_accum + _mv(vo_R_pre, vo_dp)
    bez_c = st.bez._replace(p_accum=p_accum)
    t_now = torch.as_tensor(vo_tick_now, dtype=dtype, device=dev) * dt
    count = st.bez.count
    bez_c = bezier.add_way_point(bez_c, p_accum, t_now)

    window_start = T - min(N, T)
    start = max(window_start, vo_tick_pre)
    num = vo_tick_now - start + 1
    if not (vo_tick_now > window_start and count + 1 >= 4):
        return st._replace(bez=bez_c)
    # node i (i ≤ num−2) bounds the VO interval of tick start+i, which the
    # current layout holds in slot start + i − T + N (kept if ≤ N−2)
    off = start - T + N
    i_lo, i_hi = max(0, -off), min(num - 2, N - 2 - off, N - 1)
    if i_lo > i_hi:
        return st._replace(bez=bez_c)
    diffs, _, _ = bezier.interpolate_increments(
        bez_c, torch.as_tensor(start, dtype=dtype, device=dev) * dt, num, dt,
        max_nodes=N + 1)
    b_cam = st.b_cam.clone()
    cam_active = st.cam_active.clone()
    b_cam[..., i_lo + off:i_hi + off + 1, :] = -diffs[..., i_lo + 1:i_hi + 2, :]
    cam_active[..., i_lo + off:i_hi + off + 1] = True
    return st._replace(b_cam=b_cam, cam_active=cam_active, bez=bez_c)


def _shift_set(arr, slot_axis: int, new_vals: dict):
    """Roll the slot axis left by one and write new_vals {index: value}."""
    axis = slot_axis % arr.ndim
    rolled = torch.roll(arr, -1, dims=axis)
    for idx, val in new_vals.items():
        sl = [slice(None)] * arr.ndim
        sl[axis] = idx
        rolled[tuple(sl)] = val
    return rolled


def assemble_normal_equations(c: MHEConsts, st: MHEState):
    """Reduce the slack-variable QP to states-only block-tridiagonal normal
    equations with warm-up masking. Returns (D (…,N,s,s), U (…,N,s,s; only
    the first N−1 meaningful), r (…,N,s), state_valid (N,) bool)."""
    N = c.N
    H, P = c.A_meas, c.P_cam
    Ht, Pt = H.transpose(-1, -2), P.transpose(-1, -2)
    dtype, dev = st.A_dyn.dtype, st.A_dyn.device

    first = N - min(st.T + 1, N)
    j = torch.arange(N, device=dev)
    state_valid = j >= first
    int_valid = state_valid & (j <= N - 2)

    actm = (st.cam_active & int_valid).to(dtype)[..., None, None]
    ivm = int_valid.to(dtype)[..., None, None]

    AtQd = (st.A_dyn.transpose(-1, -2) @ st.Q_dyn) * ivm       # (…,N,s,s)
    AtQdA = AtQd @ st.A_dyn
    PtQc = (Pt @ st.Q_cam) * actm                              # (…,N,s,3)
    PtQcP = PtQc @ P
    HtR = Ht @ st.Q_meas                                       # (…,N,s,m)
    HtRH = HtR @ H
    Qd_ivm = st.Q_dyn * ivm
    Qd_b = _mv(Qd_ivm, st.b_dyn)
    AtQd_b = _mv(AtQd, st.b_dyn)
    PtQc_c = _mv(PtQc, st.b_cam)
    HtR_y = _mv(HtR, st.y_meas)

    # interval j−1 contributes Qd+PᵀQcP to D_j and −(Qd·b + PᵀQc·c) to r_j
    Qd_in = torch.cat([torch.zeros_like(st.Q_dyn[..., :1, :, :]),
                       (Qd_ivm + PtQcP)[..., :-1, :, :]], dim=-3)
    r_in = torch.cat([torch.zeros_like(Qd_b[..., :1, :]),
                      (Qd_b + PtQc_c)[..., :-1, :]], dim=-2)

    D = HtRH + AtQdA + PtQcP + Qd_in
    U = -(AtQd + PtQcP)
    r = HtR_y + AtQd_b + PtQc_c - r_in

    first_mask = (j == first).to(dtype)
    D = D + first_mask[..., None, None] * st.M_p[..., None, :, :]
    r = r - first_mask[..., None] * st.n_p[..., None, :]
    return D, U, r, state_valid


def _time_leading(c: MHEConsts, st: MHEState):
    """The window system with the slot axis moved to the front, as the
    solvers take it: (D (N,…,s,s), U (N−1,…,s,s), r (N,…,s), valid (N,…))."""
    D, U, r, valid = assemble_normal_equations(c, st)
    Dl = torch.movedim(D, -3, 0)
    Ul = torch.movedim(U, -3, 0)[:-1]
    rl = torch.movedim(r, -2, 0)
    vl = torch.movedim(valid.expand(r.shape[:-1]), -1, 0)
    return Dl, Ul, rl, vl


def _std_bounds(b):
    """Per-lane (s,B) bounds -> standard-layout (B,s), broadcastable over
    (K,B,s) iterates; shared (s,) bounds pass through."""
    return b.T if b.ndim == 2 else b


def _admm(c: MHEConsts, st: MHEState, Dl, Ul, rl, vl):
    from decentralized_ekf_mhe_tpu_torch.ops import admm as admm_lib

    return admm_lib.solve_box_tridiag(
        Dl, Ul, rl, _std_bounds(c.x_lb), _std_bounds(c.x_ub), c.admm, valid=vl,
        z0=torch.movedim(st.z_adm, -2, 0), y0=torch.movedim(st.y_adm, -2, 0))


def solve_window(c: MHEConsts, st: MHEState):
    """Solve the current window; returns (…, N, s) states (zeros on dead
    slots). Three routes, as in the reference: the block-tridiagonal kernel's
    standard-layout route when ``c.use_pallas``, no box and one batch axis
    (it launches the CUDA kernel on CUDA tensors, its plain version on CPU
    tensors); else the exact sweep ``tridiag.solve``; with a box, the
    box-ADMM warm-started from ``st.z_adm``/``st.y_adm``."""
    Dl, Ul, rl, vl = _time_leading(c, st)
    if c.use_pallas and c.x_lb is None and rl.ndim == 3:
        from decentralized_ekf_mhe_tpu_torch.kernels import tridiag_kernel as tk

        x = tk.solve_batched(Dl, Ul, rl, valid=vl, device=Dl.device)
    elif c.x_lb is None:
        x = tridiag.solve(Dl, Ul, rl, valid=vl)
    else:
        x = _admm(c, st, Dl, Ul, rl, vl).x
    return torch.movedim(x, 0, -2)


def solve_window_with_duals(c: MHEConsts, st: MHEState):
    """Constrained solve that also returns the ADMM iterates for the next
    tick's warm start: (x, z, y), each (…, N, s)."""
    res = _admm(c, st, *_time_leading(c, st))
    return tuple(torch.movedim(a, 0, -2) for a in (res.x, res.z, res.y))


def step(c: MHEConsts, st: MHEState, R_sb, accel_b, omega_b, p_foot, J_foot,
         dq, contact, vo_active, vo_dp, vo_tick_pre, vo_tick_now, vo_R_pre):
    """One estimator tick T = st.T+1 (DecentralEst.cpp:152-198, marginalize
    commuted ahead of the append — they touch disjoint slots): VO ingestion →
    marginalize when the window is full → shift and append the interval built
    from the previous tick's inputs and this tick's measurement → solve.

    ``vo_active``, ``vo_tick_pre`` and ``vo_tick_now`` are host values;
    ``vo_R_pre`` (…,3,3) is the orientation at tick ``vo_tick_pre``, unused
    (may be None) when ``vo_active`` is false. Returns (new_state, (x_T, x_window))."""
    N = c.N
    p = _params_view(c)
    if bool(vo_active):
        vo_dp = torch.as_tensor(vo_dp, dtype=st.prev_accel_s.dtype,
                                device=st.prev_accel_s.device)
        st = _apply_vo(c, st, vo_R_pre, vo_dp, int(vo_tick_pre), int(vo_tick_now))

    T = st.T + 1
    M_new, n_new = _marginalize(c, st) if T >= N else (st.M_p, st.n_p)

    A_d, b_d, _, Q_d = assembly.build_dynamics(p, c.nc, st.prev_R, st.prev_accel_s,
                                               st.prev_contact)
    Q_cam_new = st.prev_R @ c.Q_vo_p @ st.prev_R.transpose(-1, -2)
    y_T, _, Q_T = assembly.build_measurement(p, c.nc, R_sb, omega_b, p_foot, J_foot,
                                             dq, contact)
    zero3 = torch.zeros_like(st.b_cam[..., 0, :])
    ax = st.y_meas.ndim - 2          # the slot axis of (…,N,·) and (…,N,·,·)
    st = MHEState(
        y_meas=_shift_set(st.y_meas, ax, {N - 1: y_T}),
        Q_meas=_shift_set(st.Q_meas, ax, {N - 1: Q_T}),
        A_dyn=_shift_set(st.A_dyn, ax, {N - 2: A_d, N - 1: 0.0}),
        b_dyn=_shift_set(st.b_dyn, ax, {N - 2: b_d, N - 1: 0.0}),
        Q_dyn=_shift_set(st.Q_dyn, ax, {N - 2: Q_d, N - 1: 0.0}),
        b_cam=_shift_set(st.b_cam, ax, {N - 2: zero3, N - 1: zero3}),
        Q_cam=_shift_set(st.Q_cam, ax, {N - 2: Q_cam_new, N - 1: 0.0}),
        cam_active=_shift_set(st.cam_active, ax, {N - 2: False, N - 1: False}),
        M_p=M_new,
        n_p=n_new,
        T=T,
        bez=st.bez,
        prev_R=R_sb,
        prev_accel_s=assembly.spatial_accel(R_sb, accel_b, c.nc),
        prev_contact=contact,
        # the warm-start iterates travel with their slots; the fresh slot N−1
        # reuses the previous newest iterate
        z_adm=_shift_set(st.z_adm, ax, {N - 1: st.z_adm[..., N - 1, :]}),
        y_adm=_shift_set(st.y_adm, ax, {N - 1: st.y_adm[..., N - 1, :]}),
    )
    if c.x_lb is not None:
        x_window, z_w, y_w = solve_window_with_duals(c, st)
        st = st._replace(z_adm=z_w, y_adm=y_w)
    else:
        x_window = solve_window(c, st)
    return st, (x_window[..., N - 1, :], x_window)
