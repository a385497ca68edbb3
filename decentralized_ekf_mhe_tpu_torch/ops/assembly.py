"""Noise constants and the constant measurement matrix of the MHE stage.

Counterpart of the reference ``ops/assembly.py``; only what the lanes fleet
path consumes is here (``NoiseConsts``, ``make_noise_consts``, ``a_meas``).
The standard-layout assembly functions (``build_dynamics``/``build_measurement`` on
(..., s, s) tensors, which feed the KF baseline) are not ported yet — see
ROADMAP.md, "KF baseline and single-instance paths".

State layout (dim_state = 9 + 3·leg_odom_type·L, DecentralEst.cpp:20):
    x = [p_s(3), v_s(3), accel_bias_b(3), (foot positions p_f_s(3L) if type 1)]
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
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device

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
