"""Synthetic legged-robot log generator (host-side, numpy float64).

Replaces the reference's live DDS sensor streams with pre-aligned dense
per-tick tensors, playing the role of the rosbag/hardware data the reference
is validated on (SURVEY.md §4: log-replay is the de-facto test harness).
Produces a ground-truth-consistent trajectory:

- base motion: smooth analytic v_s(t)/a_s(t); orientation integrated at the
  EKF rate with the same discrete propagator the filter uses;
- IMU: accel_b = R_sbᵀ(a_s − g) + bias + noise, gyro = ω_b + noise
  (the estimator reconstructs a_s = R·a_b + g, DecentralEst.cpp:871);
- leg odometry: trot/hop contact schedule; stance feet pinned to world
  footholds (zero world-velocity constraint), swing feet follow a smooth
  swing curve. Per-leg Jacobian is taken as identity with dq := ṗ_body, an
  exact reparameterization of the J·dq product the estimator consumes
  (DecentralEst.cpp:515-516);
- VO: relative body translation between frames ~vo_every ticks apart with
  latency, mirroring the VoRealtiveTransform stream (stereo-pub-node.cpp:182-192),
  plus world-orientation quaternions for the EKF's delayed correction.

Everything is returned time-aligned: per-MHE-tick arrays of length T, EKF-rate
arrays of length sum(ekf_substeps), and per-tick VO event flags — i.e. the
output of the reference's upper_bound timestamp searches
(DecentralEst.cpp:895-913, orien_ekf.cpp:175-186) precomputed on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class SynthConfig:
    T: int = 1000                 # MHE ticks
    rate: int = 200               # MHE rate (Hz)
    ekf_rate: int = 500           # EKF rate (Hz)
    num_legs: int = 4
    gait_hz: float = 2.5
    duty: float = 0.6             # stance fraction of gait period
    vo_every: int = 7             # MHE ticks between VO frames (~30 Hz)
    vo_latency: int = 2           # MHE ticks of VO pipeline latency
    accel_noise_std: float = 0.02
    gyro_noise_std: float = 0.005
    dq_noise_std: float = 0.01
    vo_noise_std: float = 0.001
    accel_bias: tuple = (0.05, -0.03, 0.02)
    seed: int = 0
    # base velocity profile amplitudes
    v_amp: tuple = (0.4, 0.2, 0.05)
    v_freq: tuple = (0.5, 0.3, 1.1)
    omega_amp: tuple = (0.15, 0.1, 0.2)
    omega_freq: tuple = (0.4, 0.6, 0.25)


@dataclass
class SynthLog:
    """Dense, pre-aligned replay tensors (all numpy float64)."""

    # MHE-tick rate (length T)
    accel_b: np.ndarray        # (T,3) IMU specific force, body frame
    omega_b: np.ndarray        # (T,3) gyro, body frame
    R_sb_gt: np.ndarray        # (T,3,3) ground-truth orientation
    q_gt: np.ndarray           # (T,4)
    p_foot: np.ndarray         # (T,L,3) body-frame foot positions
    J_foot: np.ndarray         # (T,L,3,3)
    dq: np.ndarray             # (T,L,3)
    contact: np.ndarray        # (T,L)
    gt_p: np.ndarray           # (T,3) world base position
    gt_v_s: np.ndarray         # (T,3) world base velocity
    # EKF rate
    ekf_gyro: np.ndarray       # (T_ekf,3)
    ekf_accel: np.ndarray      # (T_ekf,3)
    ekf_substeps: np.ndarray   # (T,) EKF ticks consumed per MHE tick
    ekf_q_gt: np.ndarray       # (T_ekf,4)
    # VO events at MHE-tick resolution (arrival time indexed)
    vo_active: np.ndarray      # (T,) bool — a VO pair arrived at this tick
    vo_dp_body: np.ndarray     # (T,3) relative translation in body_pre frame
    vo_tick_pre: np.ndarray    # (T,) tick index of previous image
    vo_tick_now: np.ndarray    # (T,) tick index of current image
    # VO quaternion events at EKF-tick resolution
    ekf_vo_active: np.ndarray  # (T_ekf,) bool
    ekf_vo_q: np.ndarray       # (T_ekf,4)
    ekf_vo_steps_back: np.ndarray  # (T_ekf,) int


def _omega_mat(w):
    wx, wy, wz = w
    return np.array(
        [[0, -wx, -wy, -wz], [wx, 0, wz, -wy], [wy, -wz, 0, wx], [wz, wy, -wx, 0]]
    )


def _rot(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


# trot phase offsets per leg (FR, FL, RR, RL) — diagonal pairs in phase
_TROT_PHASE = np.array([0.0, 0.5, 0.5, 0.0])
G_S = np.array([0.0, 0.0, -9.81])


def rawlog_from_synth(log: SynthLog, cfg: SynthConfig):
    """Render a SynthLog as RAW asynchronous streams (io.replay.RawLog) — the
    shape a rosbag of the reference's topics has. The alignment pass
    (io.replay.align with models.base.CartesianFeetModel) then reproduces the
    dense tensors, including the synthetic VO arrival schedule (receive times
    carry the vo_latency).

    The IMU stream is the EKF-rate stream (one physical sensor, two sampling
    rates — align() derives both), so MHE-rate accel/gyro are its latest-value
    samples rather than SynthLog's independently-drawn per-tick arrays.
    """
    from decentralized_ekf_mhe_tpu_torch.io.replay import RawLog

    T = log.accel_b.shape[0]
    dt = 1.0 / cfg.rate
    dt_e = 1.0 / cfg.ekf_rate
    T_ekf = log.ekf_gyro.shape[0]
    imu_t = np.arange(T_ekf) * dt_e
    tick_t = np.arange(T) * dt

    L = log.p_foot.shape[1]
    joint_pos = log.p_foot.reshape(T, 3 * L)
    joint_vel = log.dq.reshape(T, 3 * L)
    foot_force = np.where(log.contact > 0, 200.0, 0.0)

    active = np.nonzero(log.vo_active)[0]
    vo_t_pre = tick_t[log.vo_tick_pre[active]]
    vo_t_now = tick_t[log.vo_tick_now[active]]
    # receive time strictly inside the arrival tick's interval
    vo_t_recv = tick_t[active] - 0.5 * dt
    vo_q = np.stack([
        log.ekf_q_gt[min(int(e), T_ekf - 1)]
        for e in np.floor((log.vo_tick_now[active] + 1) * cfg.ekf_rate / cfg.rate) - 1
    ]) if len(active) else np.zeros((0, 4))

    return RawLog(
        imu_t=imu_t, accel_b=log.ekf_accel, gyro_b=log.ekf_gyro,
        joint_t=tick_t, joint_pos=joint_pos, joint_vel=joint_vel,
        foot_force=foot_force,
        vo_t_pre=vo_t_pre, vo_t_now=vo_t_now,
        vo_dp_body=log.vo_dp_body[active], vo_q_wb=vo_q,
        vo_t_recv=vo_t_recv,
        mocap_t=tick_t, mocap_p=log.gt_p, mocap_v=log.gt_v_s,
        mocap_q=log.q_gt,
    )


def generate(cfg: SynthConfig, nominal_feet: Optional[np.ndarray] = None) -> SynthLog:
    rng = np.random.default_rng(cfg.seed)
    T, L = cfg.T, cfg.num_legs
    dt = 1.0 / cfg.rate
    dt_e = 1.0 / cfg.ekf_rate

    # EKF substeps per MHE tick (e.g. 500/200 -> 2,3,2,3,...)
    ratio = cfg.ekf_rate / cfg.rate
    bounds = np.floor(np.arange(T + 1) * ratio).astype(int)
    substeps = np.diff(bounds)
    T_ekf = bounds[-1]

    # ---- base trajectory (analytic v, a; orientation integrated at EKF rate)
    va, vf = np.array(cfg.v_amp), np.array(cfg.v_freq)
    oa, of = np.array(cfg.omega_amp), np.array(cfg.omega_freq)

    def v_s(t):
        return va * np.sin(2 * np.pi * vf * t)

    def a_s(t):
        return va * 2 * np.pi * vf * np.cos(2 * np.pi * vf * t)

    def w_b(t):
        return oa * np.sin(2 * np.pi * of * t + np.array([0.0, 1.0, 2.0]))

    t_ekf = np.arange(T_ekf) * dt_e
    q = np.array([1.0, 0, 0, 0])
    ekf_q = np.zeros((T_ekf, 4))
    for k in range(T_ekf):
        F = np.eye(4) + dt_e / 2 * _omega_mat(w_b(t_ekf[k]))
        q = F @ q
        q /= np.linalg.norm(q)
        ekf_q[k] = q

    t_mhe = np.arange(T) * dt
    # orientation at MHE tick k := EKF state after consuming its substeps
    q_gt = ekf_q[np.maximum(bounds[1:] - 1, 0)]
    R_gt = np.stack([_rot(qq) for qq in q_gt])

    gt_v = np.stack([v_s(t) for t in t_mhe])
    gt_p = np.cumsum(gt_v * dt, axis=0)
    accel_s_true = np.stack([a_s(t) for t in t_mhe])
    omega_true = np.stack([w_b(t) for t in t_mhe])

    bias = np.asarray(cfg.accel_bias)
    accel_b = np.einsum(
        "tij,tj->ti", np.transpose(R_gt, (0, 2, 1)), accel_s_true - G_S
    ) + bias + cfg.accel_noise_std * rng.standard_normal((T, 3))
    omega_b = omega_true + cfg.gyro_noise_std * rng.standard_normal((T, 3))

    ekf_gyro = np.stack([w_b(t) for t in t_ekf]) + cfg.gyro_noise_std * rng.standard_normal((T_ekf, 3))
    R_ekf = np.stack([_rot(qq) for qq in ekf_q])
    a_s_ekf = np.stack([a_s(t) for t in t_ekf])
    ekf_accel = np.einsum(
        "tij,tj->ti", np.transpose(R_ekf, (0, 2, 1)), a_s_ekf - G_S
    ) + bias + cfg.accel_noise_std * rng.standard_normal((T_ekf, 3))

    # ---- legs: trot schedule, stance feet pinned in world
    if nominal_feet is None:
        if L == 4:
            nominal_feet = np.array(
                [
                    [0.1881, -0.12675, -0.30],
                    [0.1881, 0.12675, -0.30],
                    [-0.1881, -0.12675, -0.30],
                    [-0.1881, 0.12675, -0.30],
                ]
            )
        elif L == 2:
            nominal_feet = np.array([[0.0, -0.135, -0.55], [0.0, 0.135, -0.55]])
        else:
            nominal_feet = np.array([[0.0, 0.0, -0.45]])
    phases = _TROT_PHASE[:L] if L <= 4 else np.linspace(0, 1, L, endpoint=False)

    contact = np.zeros((T, L))
    p_foot = np.zeros((T, L, 3))
    dq_arr = np.zeros((T, L, 3))
    J = np.tile(np.eye(3), (T, L, 1, 1))

    foothold_w = np.zeros((L, 3))
    in_stance_prev = np.zeros(L, bool)
    for k in range(T):
        tk = t_mhe[k]
        R = R_gt[k]
        for i in range(L):
            ph = (tk * cfg.gait_hz + phases[i]) % 1.0
            stance = ph < cfg.duty
            contact[k, i] = 1.0 if stance else 0.0
            if stance:
                if not in_stance_prev[i]:
                    # touchdown: pin the foothold where the nominal foot is now
                    foothold_w[i] = gt_p[k] + R @ nominal_feet[i]
                pb = R.T @ (foothold_w[i] - gt_p[k])
                # exact rigid-contact body velocity: ṗ_b = −ω×p_b − Rᵀv
                pdot_b = -np.cross(omega_true[k], pb) - R.T @ gt_v[k]
            else:
                # swing: smooth oscillation around nominal
                sw = (ph - cfg.duty) / (1 - cfg.duty)
                lift = 0.06 * np.sin(np.pi * sw)
                pb = nominal_feet[i] + np.array([0.0, 0.0, lift])
                pdot_b = np.array(
                    [0.0, 0.0, 0.06 * np.pi * np.cos(np.pi * sw) / ((1 - cfg.duty) / cfg.gait_hz)]
                )
            in_stance_prev[i] = stance
            p_foot[k, i] = pb
            dq_arr[k, i] = pdot_b + cfg.dq_noise_std * rng.standard_normal(3)

    # ---- VO events
    vo_active = np.zeros(T, bool)
    vo_dp = np.zeros((T, 3))
    vo_pre = np.zeros(T, np.int64)
    vo_now = np.zeros(T, np.int64)
    ekf_vo_active = np.zeros(T_ekf, bool)
    ekf_vo_q = np.zeros((T_ekf, 4))
    ekf_vo_sb = np.zeros(T_ekf, np.int64)

    frame_ticks = np.arange(cfg.vo_every, T - cfg.vo_latency, cfg.vo_every)
    for fi in range(1, len(frame_ticks)):
        k_pre, k_now = frame_ticks[fi - 1], frame_ticks[fi]
        arrive = k_now + cfg.vo_latency
        if arrive >= T:
            break
        dp_w = gt_p[k_now] - gt_p[k_pre]
        dp_b = R_gt[k_pre].T @ dp_w + cfg.vo_noise_std * rng.standard_normal(3)
        vo_active[arrive] = True
        vo_dp[arrive] = dp_b
        vo_pre[arrive] = k_pre
        vo_now[arrive] = k_now
        # EKF-side world-orientation measurement for the same frame
        e_now = bounds[k_now + 1] - 1          # EKF tick of the image frame
        e_arrive = min(bounds[arrive + 1] - 1, T_ekf - 1)
        ekf_vo_active[e_arrive] = True
        ekf_vo_q[e_arrive] = ekf_q[e_now]
        ekf_vo_sb[e_arrive] = e_arrive - e_now

    return SynthLog(
        accel_b=accel_b, omega_b=omega_b, R_sb_gt=R_gt, q_gt=q_gt,
        p_foot=p_foot, J_foot=J, dq=dq_arr, contact=contact,
        gt_p=gt_p, gt_v_s=gt_v,
        ekf_gyro=ekf_gyro, ekf_accel=ekf_accel, ekf_substeps=substeps,
        ekf_q_gt=ekf_q,
        vo_active=vo_active, vo_dp_body=vo_dp, vo_tick_pre=vo_pre,
        vo_tick_now=vo_now,
        ekf_vo_active=ekf_vo_active, ekf_vo_q=ekf_vo_q,
        ekf_vo_steps_back=ekf_vo_sb,
    )
