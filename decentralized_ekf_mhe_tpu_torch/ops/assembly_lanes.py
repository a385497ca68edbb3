"""Per-tick model assembly in instance-on-lanes layout.

Counterpart of the reference ``ops/assembly_lanes.py`` (same math, same
anchors: DecentralEst.cpp:353-585): inputs carry the instance batch B on the
trailing axis — R_sb (3,3,B), accel_s (3,B), p_foot (L,3,B), J_foot
(L,3,3,B), dq (L,3,B), contact (L,B) — and outputs are (s,s,B)/(s,B) ready
for the lanes MHE window (ops/mhe_lanes.py). Both leg-odometry forms are
built: ``leg_odom_type == 0`` (foot-velocity measurements: Go1, PogoX) and
``leg_odom_type == 1`` (foot positions as states, s = 9 + 3L: Cassie), whose
contact flags gate the process noise of the foot states instead of the
measurement.
"""

from __future__ import annotations

import torch

from decentralized_ekf_mhe_tpu_torch.config import EstimatorParams
from decentralized_ekf_mhe_tpu_torch.ops import lanes
from decentralized_ekf_mhe_tpu_torch.ops.assembly import NoiseConsts


def build_dynamics(
    p: EstimatorParams,
    nc: NoiseConsts,
    R_sb: torch.Tensor,       # (3,3,B)
    accel_s: torch.Tensor,    # (3,B)
    contact: torch.Tensor,    # (L,B)
):
    """A_dyn (s,s,B), b_dyn (s,B), Q_dyn (s,s,B) for one tick
    (DecentralEst.cpp:387-458)."""
    s = p.dim_state
    dt = nc.dt
    dtype, dev = R_sb.dtype, R_sb.device
    B = R_sb.shape[-1]
    eye3 = lanes.eye(3, dtype, dev)

    A = torch.zeros((s, s, B), dtype=dtype, device=dev)
    A[0:3, 0:3] = eye3
    A[3:6, 3:6] = eye3
    A[6:9, 6:9] = eye3
    A[0:3, 3:6] = dt * eye3
    A[0:3, 6:9] = -(dt * dt / 2) * R_sb
    A[3:6, 6:9] = -dt * R_sb

    b = torch.zeros((s, B), dtype=dtype, device=dev)
    b[0:3] = -(dt * dt / 2) * accel_s
    b[3:6] = -dt * accel_s

    G = torch.zeros((6, 6, B), dtype=dtype, device=dev)
    G[0:3, 0:3] = dt * R_sb
    G[0:3, 3:6] = (0.5 * dt * dt) * R_sb
    G[3:6, 3:6] = dt * R_sb
    C_pv = torch.zeros((6, 6), dtype=dtype, device=dev)
    C_pv[0:3, 0:3] = nc.C_p
    C_pv[3:6, 3:6] = nc.C_accel
    C_pv_full = lanes.mm_nt(lanes.mmc(G, C_pv), G)
    Q_pv = lanes.gj_inv(C_pv_full)

    Q = torch.zeros((s, s, B), dtype=dtype, device=dev)
    Q[0:6, 0:6] = Q_pv
    Q[6:9, 6:9] = (1.0 / (dt * dt)) * lanes.const(nc.Q_accel_bias)

    if p.leg_odom_type == 1:
        # foot positions are random walks: identity dynamics, process noise
        # R·Q_foot·Rᵀ/dt² with the slide gain in stance, the swing gain else
        for i in range(p.num_legs):
            ci = contact[i][None, None, :]
            Q_foot = torch.where(ci > 0, lanes.const(nc.Q_foot_slide),
                                 lanes.const(nc.Q_foot_swing))
            sl = slice(9 + 3 * i, 12 + 3 * i)
            Q[sl, sl] = (1.0 / (dt * dt)) * lanes.mm_nt(lanes.mm(R_sb, Q_foot), R_sb)
            A[sl, sl] = eye3
    return A, b, Q


def build_measurement(
    p: EstimatorParams,
    nc: NoiseConsts,
    R_sb: torch.Tensor,       # (3,3,B)
    omega_b: torch.Tensor,    # (3,B)
    p_foot: torch.Tensor,     # (L,3,B)
    J_foot: torch.Tensor,     # (L,3,3,B)
    dq: torch.Tensor,         # (L,3,B)
    contact: torch.Tensor,    # (L,B)
):
    """y_meas (m,B), Q_meas (m,m,B) for one tick (DecentralEst.cpp:496-572)."""
    L = p.num_legs
    m = p.dim_meas
    dtype, dev = R_sb.dtype, R_sb.device
    B = R_sb.shape[-1]

    y = torch.zeros((m, B), dtype=dtype, device=dev)
    Q = torch.zeros((m, m, B), dtype=dtype, device=dev)

    if p.leg_odom_type == 1:
        # position form: y = R·p, Q = R·(J·C_enc_pos·Jᵀ)⁻¹·Rᵀ
        for i in range(L):
            Ji = J_foot[i]
            sl = slice(3 * i, 3 * i + 3)
            y[sl] = lanes.mv(R_sb, p_foot[i])
            inner = lanes.mm_nt(lanes.mmc(Ji, nc.C_enc_pos), Ji)
            Q[sl, sl] = lanes.mm_nt(lanes.mm(R_sb, lanes.inv3(inner)), R_sb)
        return y, Q
    if p.leg_odom_type != 0:
        raise ValueError(f"{p.leg_odom_type} not a valid leg odom type")

    omega_skew = lanes.skew(omega_b)
    Cblk = torch.zeros((9, 9), dtype=dtype, device=dev)
    Cblk[0:3, 0:3] = nc.C_enc_vel
    Cblk[3:6, 3:6] = nc.C_enc_pos
    Cblk[6:9, 6:9] = nc.C_gyro
    Q_swing = lanes.const(nc.Q_foot_swing)
    for i in range(L):
        Ji = J_foot[i]
        pi = p_foot[i]
        dqi = dq[i]
        sl = slice(3 * i, 3 * i + 3)
        # b = −R·J·dq − R·(ω×p)
        y[sl] = -lanes.mv(lanes.mm(R_sb, Ji), dqi) - lanes.mv(
            R_sb, lanes.cross(omega_b, pi))
        # stance: C = R·G·diag(C_vel,C_pos,C_gyro)·Gᵀ·Rᵀ, G = [−J, −ω^x J, p^x]
        G = torch.cat(
            [-Ji, -lanes.mm(omega_skew, Ji), lanes.skew(pi)], dim=1
        )  # (3,9,B)
        inner = lanes.mm_nt(lanes.mmc(G, Cblk), G)
        C_stance = lanes.mm_nt(lanes.mm(R_sb, inner), R_sb)
        Q_stance = lanes.inv3(C_stance)
        ci = contact[i][None, None, :]
        Q[sl, sl] = torch.where(ci > 0, Q_stance, Q_swing)
    return y, Q


def prior_state(p: EstimatorParams, nc: NoiseConsts, y0: torch.Tensor):
    """x_prior (s,B), Q_prior (s,s,B) at t=0 (DecentralEst.cpp:222-253);
    with foot-position states the feet start at the first measurement y0."""
    s = p.dim_state
    dtype, dev = y0.dtype, y0.device
    B = y0.shape[-1]
    x0 = torch.zeros((s, B), dtype=dtype, device=dev)
    Qp = torch.zeros((s, s), dtype=dtype, device=dev)
    Qp[0:3, 0:3] = nc.Q_p_init
    Qp[3:6, 3:6] = nc.Q_v_init
    Qp[6:9, 6:9] = nc.Q_accel_bias_init
    if p.leg_odom_type == 1:
        for i in range(p.num_legs):
            sl = slice(9 + 3 * i, 12 + 3 * i)
            x0[sl] = y0[3 * i: 3 * i + 3]
            Qp[sl, sl] = nc.Q_foot_init
    return x0, Qp[:, :, None].expand(s, s, B).contiguous()


def spatial_accel(R_sb, accel_b, nc: NoiseConsts):
    """a_s = R_sb·a_b + g in lanes layout (DecentralEst.cpp:871)."""
    return lanes.mv(R_sb, accel_b) + nc.gravity[:, None]
