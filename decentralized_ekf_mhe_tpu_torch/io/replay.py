"""Raw-stream alignment pass: timestamped sensor logs → dense per-tick tensors.

The reference receives sensors as asynchronous DDS messages with latest-value
semantics (callbacks overwrite `robot_store` fields; the 200 Hz timer samples
whatever is current — EstSub.cpp:34-56, go1Sub.cpp:30-126), and resolves
VO↔IMU timing with std::upper_bound searches at runtime
(DecentralEst.cpp:895-913, orien_ekf.cpp:175-186). Here all of that happens
ONCE on the host: this module (counterpart of the reference ``io/replay.py``)
converts raw timestamped streams into the dense `TickData` / `VOData` /
EKF-rate arrays the estimator drivers consume, applying the same
synchronization and discard rules (the robot model's kinematics run on
float64 CPU tensors):

- each estimator tick samples the latest message of each stream at its wall
  time (latest-value semantics);
- a VO pair (t_pre, t_now) maps to tick indices via "first tick time greater
  than stamp, minus one" (upper_bound − 1); pairs whose t_pre precedes the
  recorded history are DISCARDED with a warning (DecentralEst.cpp:898-904);
- the EKF-rate stream gets per-tick VO quaternion events with the
  steps-back rewind distance (orien_ekf.cpp:175-189);
- EKF substep counts per estimator tick are derived from the tick times.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


@dataclass
class RawStream:
    """One timestamped channel: t (n,), value (n, ...)."""

    t: np.ndarray
    v: np.ndarray


@dataclass
class RawLog:
    """Asynchronous sensor record (what a rosbag of the reference's topics
    contains): IMU, joint states (+foot force), VO relative transforms, VO
    world poses, mocap ground truth."""

    imu_t: np.ndarray            # (n_imu,)
    accel_b: np.ndarray          # (n_imu, 3)
    gyro_b: np.ndarray           # (n_imu, 3)

    joint_t: np.ndarray          # (n_j,)
    joint_pos: np.ndarray        # (n_j, 3L) or (n_j, dof)
    joint_vel: np.ndarray        # (n_j, 3L)
    foot_force: np.ndarray       # (n_j, L)

    vo_t_pre: np.ndarray = field(default_factory=lambda: np.zeros(0))
    vo_t_now: np.ndarray = field(default_factory=lambda: np.zeros(0))
    vo_dp_body: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    vo_q_wb: np.ndarray = field(default_factory=lambda: np.zeros((0, 4)))
    # optional RECEIVE times of the VO messages (transport latency); when
    # empty, arrival is approximated as "right after the image stamp"
    vo_t_recv: np.ndarray = field(default_factory=lambda: np.zeros(0))

    mocap_t: np.ndarray = field(default_factory=lambda: np.zeros(0))
    mocap_p: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    mocap_v: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    mocap_q: np.ndarray = field(default_factory=lambda: np.zeros((0, 4)))


@dataclass
class AlignedLog:
    """Dense pre-aligned tensors, consumable by ops/estimator drivers (field
    names mirror io/synth.SynthLog so the runners accept either)."""

    accel_b: np.ndarray
    omega_b: np.ndarray
    R_sb_gt: np.ndarray
    q_gt: np.ndarray
    p_foot: np.ndarray
    J_foot: np.ndarray
    dq: np.ndarray
    contact: np.ndarray
    gt_p: np.ndarray
    gt_v_s: np.ndarray
    ekf_gyro: np.ndarray
    ekf_accel: np.ndarray
    ekf_substeps: np.ndarray
    ekf_q_gt: np.ndarray
    vo_active: np.ndarray
    vo_dp_body: np.ndarray
    vo_tick_pre: np.ndarray
    vo_tick_now: np.ndarray
    ekf_vo_active: np.ndarray
    ekf_vo_q: np.ndarray
    ekf_vo_steps_back: np.ndarray


def latest_index(stream_t: np.ndarray, sample_t: np.ndarray) -> np.ndarray:
    """Index of the latest message at or before each sample time (latest-value
    DDS semantics); clamps to 0 before the first message.

    Routes through the native runtime library (native/dem_native.cpp) when
    built; numpy otherwise — results are identical.
    """
    from decentralized_ekf_mhe_tpu_torch import native

    if native.available():
        return native.latest_index(stream_t, sample_t)
    idx = np.searchsorted(stream_t, sample_t, side="right") - 1
    return np.clip(idx, 0, max(len(stream_t) - 1, 0))


def upper_bound_sync(tick_times: np.ndarray, stamp: float) -> int:
    """The reference's sync rule: std::upper_bound(times, stamp) − 1
    (DecentralEst.cpp:895-913). Returns −1 if the stamp precedes all ticks
    (⇒ caller must discard)."""
    return int(np.searchsorted(tick_times, stamp, side="right")) - 1


def quat_to_rot(q):
    w, x, y, z = (q / np.linalg.norm(q, axis=-1, keepdims=True)).T
    R = np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def align(
    raw: RawLog,
    model,
    est_rate: int = 200,
    ekf_rate: int = 500,
    t_start: Optional[float] = None,
    t_end: Optional[float] = None,
) -> AlignedLog:
    """Run the full alignment pass.

    ``model`` is a RobotModel (kinematics + contact threshold) used to turn
    joint states into p_imu_2_foot / J_imu_2_foot / contact exactly as the
    go1Sub adapter does per message (go1Sub.cpp:53-126).
    """
    t0 = raw.imu_t[0] if t_start is None else t_start
    t1 = raw.imu_t[-1] if t_end is None else t_end
    dt = 1.0 / est_rate
    dt_e = 1.0 / ekf_rate
    T = int(np.floor((t1 - t0) / dt))
    tick_t = t0 + np.arange(T) * dt
    bounds = np.floor((tick_t + dt - t0) / dt_e).astype(int)
    bounds = np.concatenate([[0], bounds])
    substeps = np.diff(bounds)
    T_ekf = bounds[-1]
    ekf_t = t0 + np.arange(T_ekf) * dt_e

    # latest-value sampling at tick times
    ii = latest_index(raw.imu_t, tick_t)
    accel = raw.accel_b[ii]
    gyro = raw.gyro_b[ii]
    ji = latest_index(raw.joint_t, tick_t)
    jpos = raw.joint_pos[ji]
    jvel = raw.joint_vel[ji]
    force = raw.foot_force[ji]

    L = model.num_legs
    joints = torch.as_tensor(np.asarray(jpos[:, : 3 * L].reshape(T, L, 3), np.float64))
    p_foot = model.p_imu_2_foot(joints).numpy()
    J_foot = model.jacobian(joints).numpy()
    dq = jvel[:, : 3 * L].reshape(T, L, 3)
    contact = model.contact_from_force(torch.as_tensor(np.asarray(force, np.float64))).numpy()

    # ground truth channels (latest-value)
    if len(raw.mocap_t):
        mi = latest_index(raw.mocap_t, tick_t)
        gt_p = raw.mocap_p[mi]
        gt_v = raw.mocap_v[mi]
        q_gt = raw.mocap_q[mi]
    else:
        gt_p = np.zeros((T, 3))
        gt_v = np.zeros((T, 3))
        q_gt = np.tile([1.0, 0, 0, 0], (T, 1))
    R_gt = quat_to_rot(q_gt)

    # EKF-rate streams
    ei = latest_index(raw.imu_t, ekf_t)
    ekf_accel = raw.accel_b[ei]
    ekf_gyro = raw.gyro_b[ei]
    if len(raw.mocap_t):
        ekf_q_gt = raw.mocap_q[latest_index(raw.mocap_t, ekf_t)]
    else:
        ekf_q_gt = np.tile([1.0, 0, 0, 0], (T_ekf, 1))

    # VO events: arrival tick = first tick after t_now (processing delay is
    # whatever the stamp separation implies); sync indices by upper_bound − 1
    vo_active = np.zeros(T, bool)
    vo_dp = np.zeros((T, 3))
    vo_pre = np.zeros(T, np.int64)
    vo_now = np.zeros(T, np.int64)
    ekf_vo_active = np.zeros(T_ekf, bool)
    ekf_vo_q = np.zeros((T_ekf, 4))
    ekf_vo_sb = np.zeros(T_ekf, np.int64)
    n_discard = 0
    has_recv = len(raw.vo_t_recv) == len(raw.vo_t_now) and len(raw.vo_t_now)
    for k in range(len(raw.vo_t_now)):
        tp, tn = raw.vo_t_pre[k], raw.vo_t_now[k]
        # arrival = first estimator tick after the message is RECEIVED (the
        # callback → next timerCallback boundary); without receive stamps,
        # right after the image stamp (zero transport latency)
        t_arr = raw.vo_t_recv[k] if has_recv else tn
        arrive = int(np.searchsorted(tick_t, t_arr, side="right"))
        if arrive >= T:
            continue
        sync_pre = upper_bound_sync(tick_t, tp)
        sync_now = upper_bound_sync(tick_t, tn)
        if sync_pre < 0:
            n_discard += 1  # "not storing enough imu info" (DecentralEst.cpp:900)
            continue
        vo_active[arrive] = True
        vo_dp[arrive] = raw.vo_dp_body[k]
        vo_pre[arrive] = sync_pre
        vo_now[arrive] = sync_now
        if len(raw.vo_q_wb):
            # the orb/pos pose is stamped with the CURRENT image time
            # (stereo-pub-node.cpp:169); the EKF rewinds to it
            # (orien_ekf.cpp:175-186) at its first tick after arrival
            e_arrive = int(np.searchsorted(ekf_t, t_arr, side="right"))
            e_sync = upper_bound_sync(ekf_t, tn)
            if 0 <= e_sync and e_arrive < T_ekf:
                ekf_vo_active[e_arrive] = True
                ekf_vo_q[e_arrive] = raw.vo_q_wb[k]
                ekf_vo_sb[e_arrive] = e_arrive - e_sync
    if n_discard:
        warnings.warn(
            f"discarded {n_discard} VO pairs predating the IMU history "
            "(reference behavior: DecentralEst.cpp:898-904)"
        )

    return AlignedLog(
        accel_b=accel, omega_b=gyro, R_sb_gt=R_gt, q_gt=q_gt,
        p_foot=p_foot, J_foot=J_foot, dq=dq, contact=contact,
        gt_p=gt_p, gt_v_s=gt_v,
        ekf_gyro=ekf_gyro, ekf_accel=ekf_accel, ekf_substeps=substeps,
        ekf_q_gt=ekf_q_gt,
        vo_active=vo_active, vo_dp_body=vo_dp, vo_tick_pre=vo_pre,
        vo_tick_now=vo_now,
        ekf_vo_active=ekf_vo_active, ekf_vo_q=ekf_vo_q,
        ekf_vo_steps_back=ekf_vo_sb,
    )


# --------------------------------------------------------------- npz format
# The documented RawLog interchange schema (examples/run_go1.py --raw):
# an .npz whose keys are exactly the RawLog field names.


def save_rawlog(path: str, raw: RawLog) -> None:
    """Write a RawLog as .npz (keys = field names)."""
    np.savez_compressed(
        path, **{k: np.asarray(getattr(raw, k)) for k in RawLog.__dataclass_fields__}
    )


def load_rawlog(path: str) -> RawLog:
    """Read a RawLog .npz written by save_rawlog (missing optional keys
    default to empty)."""
    with np.load(path) as d:
        kw = {}
        for k, f in RawLog.__dataclass_fields__.items():
            if k in d.files:
                kw[k] = d[k]
        return RawLog(**kw)
