"""MHE window engine in instance-on-lanes layout — the fleet hot path.

Counterpart of the reference ``ops/mhe_lanes.py`` (same anchors: MheSrb.cpp
window registries/marginalization, DecentralEst.cpp formulation). Every
window tensor keeps the instance batch B on the trailing axis. This eager
module is what ``estimator.run_mhe_lanes`` loops over, and is therefore the
plain version of the ``mhe_tick`` CUDA kernel (kernels/mhe_replay_kernel.py).

Ported: the fleet's shared VO schedule (``step``) and per-instance camera
clocks (``step_per_instance_vo`` on a state from ``init(per_instance_vo=True)``),
each with the exact unconstrained window solve or, when the consts carry state
box constraints, the OSQP-semantics box-ADMM warm-started from the
``z_adm``/``y_adm`` carry.

All functions are pure: they return new tensors and leave their inputs
untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from decentralized_ekf_mhe_tpu_torch.ops import assembly_lanes, bezier, lanes
from decentralized_ekf_mhe_tpu_torch.ops.mhe import MHEConsts, _params_view
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device


class MHEStateL(NamedTuple):
    """Window state. After tick T, slot j holds tick T−(N−1−j); interval j
    couples slots j and j+1 (only j ≤ N−2 meaningful)."""

    y_meas: torch.Tensor      # (N,m,B)
    Q_meas: torch.Tensor      # (N,m,m,B)
    A_dyn: torch.Tensor       # (N,s,s,B)
    b_dyn: torch.Tensor       # (N,s,B)
    Q_dyn: torch.Tensor       # (N,s,s,B)
    b_cam: torch.Tensor       # (N,3,B) the equality bound value (= −Δp)
    Q_cam: torch.Tensor       # (N,3,3,B)
    cam_active: torch.Tensor  # (N,B) bool
    M_p: torch.Tensor         # (s,s,B) arrival cost 0.5 xᵀM_p x + n_pᵀx
    n_p: torch.Tensor         # (s,B)
    T: int                    # newest tick in the window
    bez: bezier.BezierCarry   # batch-leading (B,...)
    # previous tick's inputs, consumed by the next interval's dynamics
    prev_R: torch.Tensor        # (3,3,B)
    prev_accel_s: torch.Tensor  # (3,B)
    prev_contact: torch.Tensor  # (L,B)
    # ADMM warm-start carry of the constrained path: last tick's iterates per
    # window slot, shifted with the window (OSQP setWarmStart(true),
    # DecentralEst.cpp:204). Empty tuples on unconstrained configs.
    z_adm: object = ()        # (N,s,B)
    y_adm: object = ()        # (N,s,B)


def to_lanes_state(st) -> MHEStateL:
    """``mhe.MHEState`` with one leading batch axis -> lanes layout (the
    Bezier carry stays batch-leading, as in the lanes state; its host count
    becomes the lanes state's 0-d tensor)."""
    count = torch.tensor(st.bez.count, dtype=torch.int32, device=st.M_p.device)
    return MHEStateL(
        *(lanes.to_lanes(a) for a in (
            st.y_meas, st.Q_meas, st.A_dyn, st.b_dyn, st.Q_dyn,
            st.b_cam, st.Q_cam, st.cam_active, st.M_p, st.n_p)),
        T=st.T,
        bez=st.bez._replace(count=count),
        prev_R=lanes.to_lanes(st.prev_R),
        prev_accel_s=lanes.to_lanes(st.prev_accel_s),
        prev_contact=lanes.to_lanes(st.prev_contact),
        z_adm=lanes.to_lanes(st.z_adm),
        y_adm=lanes.to_lanes(st.y_adm),
    )


def init(
    c: MHEConsts,
    R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact,
    dtype=torch.float32,
    per_instance_vo: bool = False,
    device="cuda",
) -> MHEStateL:
    """Tick-0 initialization (InitializeMHE, DecentralEst.cpp:200-351). The
    inputs must already lie on ``device``. ``per_instance_vo`` allocates a
    per-lane Bezier schedule (times (B,4), count (B,)) for fleets whose VO
    events differ per instance (``step_per_instance_vo``)."""
    device = resolve_device(device)
    N, s, m = c.N, c.dim_state, c.dim_meas
    p = _params_view(c)
    y0, Q0 = assembly_lanes.build_measurement(
        p, c.nc, R_sb, omega_b, p_foot, J_foot, dq, contact
    )
    x_prior, Q_prior = assembly_lanes.prior_state(p, c.nc, y0)
    B = y0.shape[-1]

    def z(shape):
        return torch.zeros(shape + (B,), dtype=dtype, device=device)

    y_meas = z((N, m))
    y_meas[N - 1] = y0
    Q_meas = z((N, m, m))
    Q_meas[N - 1] = Q0
    return MHEStateL(
        y_meas=y_meas,
        Q_meas=Q_meas,
        A_dyn=z((N, s, s)),
        b_dyn=z((N, s)),
        Q_dyn=z((N, s, s)),
        b_cam=z((N, 3)),
        Q_cam=z((N, 3, 3)),
        cam_active=torch.zeros((N, B), dtype=torch.bool, device=device),
        M_p=Q_prior,
        n_p=-lanes.mv(Q_prior, x_prior),
        T=0,
        bez=bezier.init(dtype, batch=(B,), per_instance_schedule=per_instance_vo,
                        device=device),
        prev_R=R_sb,
        prev_accel_s=assembly_lanes.spatial_accel(R_sb, accel_b, c.nc),
        prev_contact=contact,
        z_adm=z((N, s)) if c.x_lb is not None else (),
        y_adm=z((N, s)) if c.x_lb is not None else (),
    )


def _marginalize(c: MHEConsts, st: MHEStateL):
    """Arrival-cost update: one Schur complement on the oldest state
    (MheSrb.cpp:475-713)."""
    A = st.A_dyn[0]
    b = st.b_dyn[0]
    Qd = st.Q_dyn[0]
    H = c.A_meas
    R = st.Q_meas[0]
    y = st.y_meas[0]
    P = c.P_cam
    Qc = st.Q_cam[0]
    c0 = st.b_cam[0]
    act = st.cam_active[0].to(A.dtype)[None, None, :]
    act_v = st.cam_active[0].to(A.dtype)[None, :]

    AtQd = lanes.mm_tn(A, Qd)
    PtQc = lanes.cmm_t(P, Qc)                 # (s,3,B)
    PtQcP = lanes.mmc(PtQc, P)                # (s,s,B)
    HtR = lanes.cmm_t(H, R)                   # (s,m,B)

    S = st.M_p + lanes.mm(AtQd, A) + lanes.mmc(HtR, H) + act * PtQcP
    C01 = -(AtQd + act * PtQcP)
    D1 = Qd + act * PtQcP
    l0 = st.n_p - lanes.mv(AtQd, b) - lanes.mv(HtR, y) - act_v * lanes.mv(PtQc, c0)
    l1 = lanes.mv(Qd, b) + act_v * lanes.mv(PtQc, c0)
    Sinv = lanes.gj_inv(S)
    M_new = D1 - lanes.mm_tn(C01, lanes.mm(Sinv, C01))
    n_new = l1 - lanes.mv_t(C01, lanes.mv(Sinv, l0))
    return M_new, n_new


def _apply_vo(c: MHEConsts, st: MHEStateL, vo_inc, vo_tick_pre: int,
              vo_tick_now: int):
    """VO sync + Bezier + masked activation (DecentralEst.cpp:883-945,
    987-1009). The VO schedule (ticks) is shared across the fleet;
    ``vo_inc`` (3,B) is the world-frame increment R_pre·dp of each instance.

    The reference writes the per-slot increments with a scatter that drops
    out-of-range targets; here each node is a masked write decided on the
    host, since the schedule is shared (the CUDA kernel does the same)."""
    N = c.N
    dtype, dev = st.prev_accel_s.dtype, st.prev_accel_s.device
    dt = torch.as_tensor(c.dt, dtype=dtype, device=dev)
    T = st.T + 1

    p_accum = st.bez.p_accum + vo_inc.T              # carry is (B,3)
    bez_c = st.bez._replace(p_accum=p_accum)
    t_now = torch.as_tensor(vo_tick_now, dtype=dtype, device=dev) * dt
    bez_c = bezier.add_way_point(bez_c, p_accum, t_now)

    window_start = T - min(N, T)
    start = max(window_start, vo_tick_pre)
    num = vo_tick_now - start + 1
    do_interp = vo_tick_now > window_start and int(bez_c.count) >= 4
    if not do_interp:
        return st._replace(bez=bez_c)

    diffs, _, _ = bezier.interpolate_increments(
        bez_c, torch.as_tensor(start, dtype=dtype, device=dev) * dt, num, dt,
        max_nodes=N + 1)
    diffs_l = torch.movedim(diffs, 0, -1)            # (N+1,3,B)
    b_cam = st.b_cam.clone()
    cam_active = st.cam_active.clone()
    for i in range(N):
        slot = start + i - T + N
        if i <= num - 2 and 0 <= slot <= N - 2:
            b_cam[slot] = -diffs_l[i + 1]
            cam_active[slot] = True
    return st._replace(b_cam=b_cam, cam_active=cam_active, bez=bez_c)


def _apply_vo_per_instance(c: MHEConsts, st: MHEStateL, vo_inc, vo_tick_pre,
                           vo_tick_now, vo_active):
    """Per-instance VO ingestion — the fully masked twin of ``_apply_vo`` for
    fleets whose camera clocks differ per lane (timing AND content). All VO
    operands are per lane: ``vo_inc`` (3,B) world-frame increments,
    ``vo_tick_pre``/``vo_tick_now`` (B,) int, ``vo_active`` (B,) bool; the
    state carries a per-instance Bezier schedule. Lanes without an event are
    left untouched; no value is read back to the host."""
    N = c.N
    dtype, dev = st.prev_accel_s.dtype, st.prev_accel_s.device
    dt = torch.as_tensor(c.dt, dtype=dtype, device=dev)
    T = st.T + 1
    act = vo_active.to(device=dev, dtype=torch.bool)
    tick_pre = vo_tick_pre.to(device=dev, dtype=torch.int64)
    tick_now = vo_tick_now.to(device=dev, dtype=torch.int64)

    inc = vo_inc * act.to(dtype)[None, :]
    p_accum = st.bez.p_accum + inc.T                  # carry is (B,3)
    bez_c = st.bez._replace(p_accum=p_accum)
    bez_c = bezier.add_way_point(bez_c, p_accum, tick_now.to(dtype) * dt,
                                 mask=act)

    window_start = T - min(N, T)
    start = torch.clamp(tick_pre, min=window_start)   # (B,)
    num = tick_now - start + 1                        # (B,)
    do_interp = act & (tick_now > window_start) & (bez_c.count >= 4)

    # node index i of window slot j: slot = start + i - T + N, so
    # i = j - start + T - N (per instance)
    j = torch.arange(N, device=dev)
    i_b = j[:, None] - start[None, :] + T - N         # (N,B)
    ok = (do_interp[None, :] & (i_b >= 0) & (i_b <= num[None, :] - 2)
          & (j[:, None] <= N - 2))

    t_int = bez_c.times[:, 3] - bez_c.times[:, 0]     # (B,)
    t_int = torch.where(t_int == 0, torch.ones_like(t_int), t_int)
    u0 = (start.to(dtype) * dt - bez_c.times[:, 0]) / t_int
    du = dt / t_int
    uf = i_b.to(dtype).T                              # (B,N)
    # the increment over [i, i+1] per (slot, instance); pts are (B,4,3), so
    # eval_at gives (B,N,3) -> lanes (N,3,B)
    lo = bezier.eval_at(bez_c, u0[:, None] + uf * du[:, None])
    hi = bezier.eval_at(bez_c, u0[:, None] + (uf + 1) * du[:, None])
    diff = torch.movedim(hi - lo, 0, -1)

    b_cam = torch.where(ok[:, None, :], -diff, st.b_cam)
    cam_active = st.cam_active | ok
    return st._replace(b_cam=b_cam, cam_active=cam_active, bez=bez_c)


def assemble_normal_equations(c: MHEConsts, st: MHEStateL):
    """States-only block-tridiagonal normal equations in lanes layout.
    Returns (D (N,s,s,B), U (N,s,s,B; only :-1 meaningful), r (N,s,B),
    state_valid (N,) bool)."""
    N = c.N
    H = c.A_meas
    P = c.P_cam
    dtype, dev = st.A_dyn.dtype, st.A_dyn.device

    n_states = min(st.T + 1, N)
    first = N - n_states
    j = torch.arange(N, device=dev)
    state_valid = j >= first
    int_valid = (j >= first) & (j <= N - 2)

    act = (st.cam_active & int_valid[:, None]).to(dtype)[:, None, None, :]
    ivm = int_valid.to(dtype)[:, None, None, None]

    AtQd = lanes.mm_tn(st.A_dyn, st.Q_dyn) * ivm     # (N,s,s,B)
    AtQdA = lanes.mm(AtQd, st.A_dyn)
    PtQc = lanes.cmm_t(P, st.Q_cam) * act            # (N,s,3,B)
    PtQcP = lanes.mmc(PtQc, P)
    HtR = lanes.cmm_t(H, st.Q_meas)                  # (N,s,m,B)
    HtRH = lanes.mmc(HtR, H)
    Qd_b = lanes.mv(st.Q_dyn * ivm, st.b_dyn)
    AtQd_b = lanes.mv(AtQd, st.b_dyn)
    PtQc_c = lanes.mv(PtQc, st.b_cam)
    HtR_y = lanes.mv(HtR, st.y_meas)

    Qd_in = torch.cat(
        [torch.zeros_like(st.Q_dyn[:1]), (st.Q_dyn * ivm + PtQcP)[:-1]], dim=0
    )
    r_in = torch.cat(
        [torch.zeros_like(Qd_b[:1]), (Qd_b + PtQc_c)[:-1]], dim=0
    )

    D = HtRH + AtQdA + PtQcP + Qd_in
    U = -(AtQd + PtQcP)
    r = HtR_y + AtQd_b + PtQc_c - r_in

    first_mask = (j == first).to(dtype)
    D = D + first_mask[:, None, None, None] * st.M_p[None]
    r = r - first_mask[:, None, None] * st.n_p[None]
    return D, U, r, state_valid


def _masked_system(c: MHEConsts, st: MHEStateL):
    D, U, r, valid = assemble_normal_equations(c, st)
    s = c.dim_state
    eye = torch.eye(s, dtype=D.dtype, device=D.device)[:, :, None]
    v = valid.to(D.dtype)[:, None, None, None]
    D = D * v + eye[None] * (1.0 - v)
    r = r * valid.to(r.dtype)[:, None, None]
    vU = (valid[:-1] & valid[1:]).to(D.dtype)[:, None, None, None]
    U = U[:-1] * vU
    return D, U, r


def solve_window(c: MHEConsts, st: MHEStateL) -> torch.Tensor:
    """Solve the current window; returns (N, s, B) (zeros on dead slots).

    Unconstrained consts solve exactly: with ``c.use_pallas`` the
    block-tridiagonal kernel wrapper takes the system (it launches the CUDA
    kernel for CUDA tensors and uses the plain sweep for CPU tensors);
    otherwise the plain sweep runs. With state box constraints
    (``c.x_lb``/``c.x_ub``) the box-ADMM runs, warm-started from
    ``st.z_adm``/``st.y_adm``."""
    D, U, r = _masked_system(c, st)
    if c.x_lb is not None:
        return _solve_constrained(c, D, U, r, st.z_adm, st.y_adm).x
    if c.use_pallas:
        from decentralized_ekf_mhe_tpu_torch.kernels import tridiag_kernel as tk

        return tk.solve_lanes(D.contiguous(), U.contiguous(), r.contiguous(),
                              device=D.device)
    return lanes.thomas_solve(D, U, r)


def _solve_constrained(c: MHEConsts, D, U, r, z0, y0):
    """Dispatch the lanes box-ADMM: the ``admm_solve`` kernel wrapper when
    ``c.use_pallas`` (CUDA kernel for CUDA tensors, plain version for CPU
    tensors), the plain solver otherwise. Identical semantics."""
    if c.use_pallas:
        from decentralized_ekf_mhe_tpu_torch.kernels import admm_kernel as ak

        return ak.solve_box_lanes(
            D.contiguous(), U.contiguous(), r.contiguous(), c.x_lb, c.x_ub,
            c.admm, z0=z0.contiguous(), y0=y0.contiguous(), device=D.device)
    from decentralized_ekf_mhe_tpu_torch.ops import admm as admm_lib

    return admm_lib.solve_box_tridiag_lanes(
        D, U, r, c.x_lb, c.x_ub, c.admm, z0=z0, y0=y0)


def _solve_window_admm(c: MHEConsts, st: MHEStateL):
    """Constrained solve of the current window, warm-started from the state:
    the whole ``ops.admm.ADMMResult``."""
    D, U, r = _masked_system(c, st)
    return _solve_constrained(c, D, U, r, st.z_adm, st.y_adm)


def solve_window_with_duals(c: MHEConsts, st: MHEStateL):
    """Constrained solve returning the ADMM iterates for the next tick's warm
    start: (x, z, y), each (N, s, B)."""
    res = _solve_window_admm(c, st)
    return res.x, res.z, res.y


def _shift_set(arr, new_vals: dict):
    """Roll slot axis 0 left by one and write new_vals {slot: value}."""
    rolled = torch.roll(arr, -1, dims=0)
    for idx, val in new_vals.items():
        rolled[idx] = val
    return rolled


def step(
    c: MHEConsts,
    st: MHEStateL,
    R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact,
    vo_active, vo_dp, vo_tick_pre, vo_tick_now,
    vo_R_pre,
    vo_inc=None,
):
    """One estimator tick in lanes layout.

    ``vo_active``/``vo_tick_pre``/``vo_tick_now`` are the shared schedule
    (Python scalars or 0-d tensors); ``vo_dp`` is (3,) or per-lane (3,B);
    ``vo_R_pre`` (3,3,B) is the orientation at tick vo_tick_pre (unused when
    vo_active is false). A caller that already holds the world-frame
    increment R_pre·dp passes it as ``vo_inc`` (3,B) and may leave
    ``vo_dp``/``vo_R_pre`` as None.
    Returns (new_state, (x_T (s,B), x_window (N,s,B), iters)); ``iters`` is
    the (B,) int32 ADMM iterations this tick's solve ran on constrained
    consts, None otherwise."""
    if bool(vo_active):
        if vo_inc is None:
            B = st.prev_accel_s.shape[-1]
            vo_dp = torch.as_tensor(vo_dp, dtype=st.prev_accel_s.dtype,
                                    device=st.prev_accel_s.device)
            dp = (vo_dp[:, None] if vo_dp.ndim == 1 else vo_dp).expand(3, B)
            vo_inc = lanes.mv(vo_R_pre, dp)
        st = _apply_vo(c, st, vo_inc, int(vo_tick_pre), int(vo_tick_now))
    return _tick_tail(c, st, R_sb, accel_b, omega_b, p_foot, J_foot, dq,
                      contact)


def step_per_instance_vo(
    c: MHEConsts,
    st: MHEStateL,
    R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact,
    vo_active, vo_dp, vo_tick_pre, vo_tick_now,
    vo_R_pre,
    vo_inc=None,
):
    """One estimator tick with PER-INSTANCE VO: ``vo_active`` (B,) bool,
    ``vo_dp`` (3,B), ``vo_tick_pre``/``vo_tick_now`` (B,) int, ``vo_R_pre``
    (3,3,B), all tensors. A caller that already holds the world-frame
    increments R_pre·dp passes them as ``vo_inc`` (3,B) and may leave
    ``vo_dp``/``vo_R_pre`` as None. Requires a state built with
    ``init(..., per_instance_vo=True)``. Inactive lanes are masked, not
    branched; otherwise identical to ``step`` (same return value)."""
    if vo_inc is None:
        dp = torch.as_tensor(vo_dp, dtype=st.prev_accel_s.dtype,
                             device=st.prev_accel_s.device)
        vo_inc = lanes.mv(vo_R_pre, dp)
    st = _apply_vo_per_instance(c, st, vo_inc, vo_tick_pre, vo_tick_now,
                                vo_active)
    return _tick_tail(c, st, R_sb, accel_b, omega_b, p_foot, J_foot, dq,
                      contact)


def _tick_tail(c: MHEConsts, st: MHEStateL, R_sb, accel_b, omega_b, p_foot,
               J_foot, dq, contact):
    """Marginalize-if-full → shift/append → solve (the VO-independent tail
    of the tick)."""
    if st.T + 1 >= c.N:
        M_new, n_new = _marginalize(c, st)
    else:
        M_new, n_new = st.M_p, st.n_p
    fresh = _fresh_slot(c, st, R_sb, omega_b, p_foot, J_foot, dq, contact)
    st = _shift_append(c, st, M_new, n_new, fresh, R_sb, accel_b, contact)

    iters = None
    if c.x_lb is not None:
        res = _solve_window_admm(c, st)
        x_window, iters = res.x, res.iters
        st = st._replace(z_adm=res.z, y_adm=res.y)
    else:
        x_window = solve_window(c, st)
    x_T = x_window[c.N - 1]
    return st, (x_T, x_window, iters)


def _fresh_slot(c: MHEConsts, st: MHEStateL, R_sb, omega_b, p_foot, J_foot, dq,
                contact):
    """What the tick appends: the dynamics of the interval that ends now
    (A_d, b_d, Q_d, from the previous tick's inputs), its camera weight
    Q_cam_new, and the newest measurement (y_T, Q_T)."""
    p = _params_view(c)
    A_d, b_d, Q_d = assembly_lanes.build_dynamics(
        p, c.nc, st.prev_R, st.prev_accel_s, st.prev_contact
    )
    Q_cam_new = lanes.mm_nt(lanes.mmc(st.prev_R, c.Q_vo_p), st.prev_R)
    y_T, Q_T = assembly_lanes.build_measurement(
        p, c.nc, R_sb, omega_b, p_foot, J_foot, dq, contact
    )
    return A_d, b_d, Q_d, Q_cam_new, y_T, Q_T


def _shift_append(c: MHEConsts, st: MHEStateL, M_new, n_new, fresh, R_sb, accel_b,
                  contact) -> MHEStateL:
    """The window one tick on: slots shifted by one, ``fresh``
    (``_fresh_slot``) appended, the arrival cost (M_new, n_new) and this
    tick's inputs for the next interval's dynamics set."""
    N = c.N
    A_d, b_d, Q_d, Q_cam_new, y_T, Q_T = fresh
    zero3 = torch.zeros_like(st.b_cam[0])
    return MHEStateL(
        y_meas=_shift_set(st.y_meas, {N - 1: y_T}),
        Q_meas=_shift_set(st.Q_meas, {N - 1: Q_T}),
        A_dyn=_shift_set(st.A_dyn, {N - 2: A_d, N - 1: torch.zeros_like(A_d)}),
        b_dyn=_shift_set(st.b_dyn, {N - 2: b_d, N - 1: torch.zeros_like(b_d)}),
        Q_dyn=_shift_set(st.Q_dyn, {N - 2: Q_d, N - 1: torch.zeros_like(Q_d)}),
        b_cam=_shift_set(st.b_cam, {N - 2: zero3, N - 1: zero3}),
        Q_cam=_shift_set(
            st.Q_cam, {N - 2: Q_cam_new, N - 1: torch.zeros_like(Q_cam_new)}
        ),
        cam_active=_shift_set(st.cam_active, {N - 2: False, N - 1: False}),
        M_p=M_new,
        n_p=n_new,
        T=st.T + 1,
        bez=st.bez,
        prev_R=R_sb,
        prev_accel_s=assembly_lanes.spatial_accel(R_sb, accel_b, c.nc),
        prev_contact=contact,
        # warm-start iterates travel with their window slots; the fresh slot
        # N−1 reuses the previous newest iterate
        z_adm=_shift_set(st.z_adm, {N - 1: st.z_adm[N - 1]})
        if c.x_lb is not None else st.z_adm,
        y_adm=_shift_set(st.y_adm, {N - 1: st.y_adm[N - 1]})
        if c.x_lb is not None else st.y_adm,
    )
