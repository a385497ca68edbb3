"""Per-tick dynamics/measurement model assembly of the MHE/KF stage, in
standard layout (…, s, s).

Counterpart of the reference ``ops/assembly.py``: with the orientation R_sb
from the EKF stage, the base dynamics and the leg-odometry measurements are
linear in the states, R_sb entering only as coefficients
(DecentralEst.cpp:353-585, 702-861). The lanes twins (…, s, s, B) of the
fleet path are ``ops/assembly_lanes.py``.

State layout (dim_state = 9 + 3·leg_odom_type·L, DecentralEst.cpp:20):
    x = [p_s(3), v_s(3), accel_bias_b(3), (foot positions p_f_s(3L) if type 1)]

Dynamics (DecentralEst.cpp:387-458):
    A_dyn = [[I, dt·I, −dt²/2·R], [0, I, −dt·R], [0,0,I], ([0..I] feet)]
    b_dyn = [−dt²/2·a_s, −dt·a_s, 0, (0)]  with a_s = R·a_b + g
    C_dyn = G·diag(C_p, C_accel, C_bias, C_feet)·Gᵀ,  Q_dyn = C_dyn⁻¹ blockwise
Leg odometry (DecentralEst.cpp:86-120, 492-572):
    type 0 (velocity): rows [0 I 0];  b = −R(J·dq) − R(ω×p)
    type 1 (position): rows [−I 0 0 | I]; b = R·p;  Q = (R·J·C_pos·Jᵀ·Rᵀ)⁻¹

The builders broadcast over leading batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from decentralized_ekf_mhe_tpu_torch.config import (
    EstimatorParams,
    std_to_cov,
    std_to_gain,
)
from decentralized_ekf_mhe_tpu_torch.ops import smallmat
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device
from decentralized_ekf_mhe_tpu_torch.utils.quaternion import skew

GRAVITY_S = np.array([0.0, 0.0, -9.81])  # DecentralEst.cpp:27


class NoiseConsts(NamedTuple):
    """Covariance/gain diagonals derived from stds (DecentralEst.cpp:39-51)."""

    C_p: torch.Tensor
    C_accel: torch.Tensor
    C_accel_bias: torch.Tensor
    C_enc_pos: torch.Tensor
    C_enc_vel: torch.Tensor
    C_gyro: torch.Tensor
    C_foot_slide: torch.Tensor
    C_foot_swing: torch.Tensor
    Q_accel_bias: torch.Tensor
    Q_foot_slide: torch.Tensor
    Q_foot_swing: torch.Tensor
    Q_vo_p: torch.Tensor
    # priors (InitializeMHE/KF, DecentralEst.cpp:236-253, 612-625)
    Q_p_init: torch.Tensor
    Q_v_init: torch.Tensor
    Q_accel_bias_init: torch.Tensor
    Q_foot_init: torch.Tensor
    C_p_init: torch.Tensor
    C_v_init: torch.Tensor
    C_accel_bias_init: torch.Tensor
    C_foot_init: torch.Tensor
    gravity: torch.Tensor
    dt: torch.Tensor


def make_noise_consts(p: EstimatorParams, dtype=torch.float32,
                      device="cuda") -> NoiseConsts:
    device = resolve_device(device)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
        dtype=dtype, device=device)
    return NoiseConsts(
        C_p=f(std_to_cov(p.p_process_std)),
        C_accel=f(std_to_cov(p.accel_input_std)),
        C_accel_bias=f(std_to_cov(p.accel_bias_std)),
        C_enc_pos=f(std_to_cov(p.joint_position_std)),
        C_enc_vel=f(std_to_cov(p.joint_velocity_std)),
        C_gyro=f(std_to_cov(p.gyro_input_std)),
        C_foot_slide=f(std_to_cov(p.foot_slide_std)),
        C_foot_swing=f(std_to_cov(p.foot_swing_std)),
        Q_accel_bias=f(std_to_gain(p.accel_bias_std)),
        Q_foot_slide=f(std_to_gain(p.foot_slide_std)),
        Q_foot_swing=f(std_to_gain(p.foot_swing_std)),
        Q_vo_p=f(std_to_gain(p.vo_p_std)),
        Q_p_init=f(std_to_gain(p.p_init_std)),
        Q_v_init=f(std_to_gain(p.v_init_std)),
        Q_accel_bias_init=f(std_to_gain(p.accel_bias_init_std)),
        Q_foot_init=f(std_to_gain(p.foot_init_std)),
        C_p_init=f(std_to_cov(p.p_init_std)),
        C_v_init=f(std_to_cov(p.v_init_std)),
        C_accel_bias_init=f(std_to_cov(p.accel_bias_init_std)),
        C_foot_init=f(std_to_cov(p.foot_init_std)),
        gravity=f(GRAVITY_S),
        dt=f(p.dt),
    )


def a_meas(p: EstimatorParams, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Constant measurement matrix (dim_meas, dim_state) (DecentralEst.cpp:86-120)."""
    device = resolve_device(device)
    L, s, m = p.num_legs, p.dim_state, p.dim_meas
    A = np.zeros((m, s))
    if p.leg_odom_type == 0:
        for i in range(L):
            A[i * 3: i * 3 + 3, 3:6] = np.eye(3)
    elif p.leg_odom_type == 1:
        for i in range(L):
            A[i * 3: i * 3 + 3, 0:3] = -np.eye(3)
            A[i * 3: i * 3 + 3, 9 + i * 3: 12 + i * 3] = np.eye(3)
    else:
        raise ValueError(f"{p.leg_odom_type} not a valid leg odom type")
    return torch.as_tensor(A).to(dtype=dtype, device=device)


def _mv(M, v):
    """(…, i, j) @ (…, j) -> (…, i)."""
    return (M @ v[..., None])[..., 0]


def spatial_accel(R_sb, accel_b, nc: NoiseConsts):
    """a_s = R_sb·a_b + g (GetMeasurement, DecentralEst.cpp:871)."""
    return _mv(R_sb, accel_b) + nc.gravity


def build_dynamics(p: EstimatorParams, nc: NoiseConsts, R_sb, accel_s, contact):
    """A_dyn, b_dyn, C_dyn, Q_dyn for one tick (DecentralEst.cpp:387-458,
    716-785). R_sb (…,3,3), accel_s (…,3), contact (…,L).

    Q_dyn is the blockwise inverse the reference computes: the (p,v) 6×6
    block inverted jointly, bias and foot blocks separately — the
    cross-covariance between the pv block and the rest is exactly zero."""
    s, L = p.dim_state, p.num_legs
    dt = nc.dt
    batch = torch.broadcast_shapes(R_sb.shape[:-2], accel_s.shape[:-1],
                                   contact.shape[:-1])
    dtype, dev = R_sb.dtype, R_sb.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    zeros = lambda *shape: torch.zeros(batch + shape, dtype=dtype, device=dev)

    A = zeros(s, s)
    A[..., 0:3, 0:3] = eye3
    A[..., 3:6, 3:6] = eye3
    A[..., 6:9, 6:9] = eye3
    A[..., 0:3, 3:6] = dt * eye3
    A[..., 0:3, 6:9] = -(dt * dt / 2) * R_sb
    A[..., 3:6, 6:9] = -dt * R_sb

    b = zeros(s)
    b[..., 0:3] = -(dt * dt / 2) * accel_s
    b[..., 3:6] = -dt * accel_s

    # C_dyn's pv block: G_pv C_pv G_pvᵀ (DecentralEst.cpp:409-418)
    G_pv = zeros(6, 6)
    G_pv[..., 0:3, 0:3] = dt * R_sb
    G_pv[..., 0:3, 3:6] = (0.5 * dt * dt) * R_sb
    G_pv[..., 3:6, 3:6] = dt * R_sb
    C_pv = zeros(6, 6)
    C_pv[..., 0:3, 0:3] = nc.C_p
    C_pv[..., 3:6, 3:6] = nc.C_accel
    C_pv_full = G_pv @ C_pv @ G_pv.transpose(-1, -2)
    Q_pv = smallmat.gj_inv(C_pv_full)

    C = zeros(s, s)
    Q = zeros(s, s)
    C[..., 0:6, 0:6] = C_pv_full
    Q[..., 0:6, 0:6] = Q_pv
    C[..., 6:9, 6:9] = (dt * dt) * nc.C_accel_bias
    Q[..., 6:9, 6:9] = (1.0 / (dt * dt)) * nc.Q_accel_bias

    if p.leg_odom_type == 1:
        RT = R_sb.transpose(-1, -2)
        for i in range(L):
            ci = contact[..., i][..., None, None]
            # foot process: contact -> slide (tight), swing -> loose
            # (DecentralEst.cpp:434-450)
            C_foot = torch.where(ci > 0, nc.C_foot_slide, nc.C_foot_swing)
            Q_foot = torch.where(ci > 0, nc.Q_foot_slide, nc.Q_foot_swing)
            sl = slice(9 + 3 * i, 12 + 3 * i)
            C[..., sl, sl] = (dt * dt) * (R_sb @ C_foot @ RT)
            Q[..., sl, sl] = (1.0 / (dt * dt)) * (R_sb @ Q_foot @ RT)
            A[..., sl, sl] = eye3
    return A, b, C, Q


def build_measurement(p: EstimatorParams, nc: NoiseConsts, R_sb, omega_b,
                      p_foot, J_foot, dq, contact):
    """b_meas, C_meas, Q_meas for one tick (DecentralEst.cpp:496-572,
    789-855). R_sb (…,3,3), omega_b (…,3), p_foot (…,L,3), J_foot
    (…,L,3,3), dq (…,L,3), contact (…,L)."""
    L, m = p.num_legs, p.dim_meas
    dtype, dev = R_sb.dtype, R_sb.device
    batch = torch.broadcast_shapes(R_sb.shape[:-2], omega_b.shape[:-1],
                                   p_foot.shape[:-2], contact.shape[:-1])
    RT = R_sb.transpose(-1, -2)
    b = torch.zeros(batch + (m,), dtype=dtype, device=dev)
    C = torch.zeros(batch + (m, m), dtype=dtype, device=dev)
    Q = torch.zeros(batch + (m, m), dtype=dtype, device=dev)

    if p.leg_odom_type == 0:
        omega_skew = skew(omega_b)
        Cblk = torch.zeros((9, 9), dtype=dtype, device=dev)
        Cblk[0:3, 0:3] = nc.C_enc_vel
        Cblk[3:6, 3:6] = nc.C_enc_pos
        Cblk[6:9, 6:9] = nc.C_gyro
        for i in range(L):
            Ji, pi, dqi = J_foot[..., i, :, :], p_foot[..., i, :], dq[..., i, :]
            sl = slice(3 * i, 3 * i + 3)
            # b = −R·J·dq − R·(ω×p)
            b[..., sl] = -_mv(R_sb @ Ji, dqi) - _mv(
                R_sb, torch.linalg.cross(omega_b, pi))
            # stance: C = R·G·diag(C_vel,C_pos,C_gyro)·Gᵀ·Rᵀ, G = [−J, −ω^x J, p^x]
            G = torch.cat([-Ji, -(omega_skew @ Ji), skew(pi)], dim=-1)
            C_stance = R_sb @ (G @ Cblk @ G.transpose(-1, -2)) @ RT
            Q_stance = smallmat.inv3(C_stance)
            ci = contact[..., i][..., None, None]
            C[..., sl, sl] = torch.where(ci > 0, C_stance, nc.C_foot_swing)
            Q[..., sl, sl] = torch.where(ci > 0, Q_stance, nc.Q_foot_swing)
    elif p.leg_odom_type == 1:
        for i in range(L):
            Ji, pi = J_foot[..., i, :, :], p_foot[..., i, :]
            sl = slice(3 * i, 3 * i + 3)
            b[..., sl] = _mv(R_sb, pi)
            JCJt = Ji @ nc.C_enc_pos @ Ji.transpose(-1, -2)
            C[..., sl, sl] = R_sb @ JCJt @ RT
            # Q through the unrotated inner inverse: R·(J C Jᵀ)⁻¹·Rᵀ
            # (DecentralEst.cpp:556-561)
            Q[..., sl, sl] = R_sb @ smallmat.inv3(JCJt) @ RT
    else:
        raise ValueError(f"{p.leg_odom_type} not a valid leg odom type")
    return b, C, Q


def prior_state(p: EstimatorParams, nc: NoiseConsts, b_meas0):
    """x_prior, Q_prior, C_prior at t=0 (DecentralEst.cpp:222-253, 598-625).
    With foot-position states (leg_odom_type 1) the feet are seeded from the
    first leg-odometry measurement (DecentralEst.cpp:321, 683)."""
    s = p.dim_state
    dtype, dev = b_meas0.dtype, b_meas0.device
    batch = b_meas0.shape[:-1]
    x0 = torch.zeros(batch + (s,), dtype=dtype, device=dev)
    Qp = torch.zeros(batch + (s, s), dtype=dtype, device=dev)
    Cp = torch.zeros(batch + (s, s), dtype=dtype, device=dev)
    for sl, q, c in ((slice(0, 3), nc.Q_p_init, nc.C_p_init),
                     (slice(3, 6), nc.Q_v_init, nc.C_v_init),
                     (slice(6, 9), nc.Q_accel_bias_init, nc.C_accel_bias_init)):
        Qp[..., sl, sl] = q
        Cp[..., sl, sl] = c
    if p.leg_odom_type == 1:
        for i in range(p.num_legs):
            sl = slice(9 + 3 * i, 12 + 3 * i)
            x0[..., sl] = b_meas0[..., 3 * i: 3 * i + 3]
            Qp[..., sl, sl] = nc.Q_foot_init
            Cp[..., sl, sl] = nc.C_foot_init
    return x0, Qp, Cp
