"""VO frontend geometry: camera-pose stream → estimator VO inputs.

The reference's custom ORB-SLAM3 wrapper node (C10,
src/visual_odometry/orbslam3_ros2/src/stereo-decentralized/stereo-pub-node.cpp)
takes each tracked camera pose, inverts it (:139), and with the body↔camera
extrinsics (R_ic/p_ic from parameters_go1.yaml:58-64) publishes

- ``orb/pos``: world→body pose, anchored so the first frame's body pose is
  identity: T_wb = T_wb_init⁻¹ · T_wc · T_bc⁻¹       (:164,:168-179)
- ``orb/vo``:  relative body translation between consecutive frames:
  ΔT = T_bc · T_wc_pre⁻¹ · T_wc · T_bc⁻¹, translation part (:161,:182-192)

ORB-SLAM3 itself is an external input source (replayed from logs per
BASELINE.json); this module reimplements the *geometry* so recorded camera
trajectories become `RawLog.vo_*` streams.
"""

from __future__ import annotations

import numpy as np


def _iso(R, p):
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = p
    return T


def _inv(T):
    R = T[:3, :3]
    p = T[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ p
    return out


def quat_from_rot(R):
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    if w > 1e-8:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:  # fall back via largest diagonal element
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(0.0, 1 + R[i, i] - R[j, j] - R[k, k])) * 2
        q = np.zeros(4)
        q[1 + i] = s / 4
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        q[0] = (R[k, j] - R[j, k]) / s
        return q / np.linalg.norm(q)
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


class StereoVOFrontend:
    """Stateful frame-to-frame processor (the StereoPubNode carry).

    Args:
      R_ic, p_ic: IMU/body→camera extrinsics (parameters_go1.yaml:58-64).
      camera_pose_is_inverse: ORB-SLAM3's TrackStereo returns the inverse of
        the world→camera transform; the node inverts it back
        (stereo-pub-node.cpp:139). Set False if poses are already T_wc.
    """

    def __init__(self, R_ic, p_ic, camera_pose_is_inverse: bool = True):
        self.T_bc = _iso(np.asarray(R_ic, float).reshape(3, 3),
                         np.asarray(p_ic, float))
        self._invert_input = camera_pose_is_inverse
        self._T_wc_pre = None
        self._t_pre = None
        self._T_wb_init = None

    def process(self, R_cam, p_cam, t_stamp):
        """Feed one tracked camera pose; returns None for the first frame,
        else a dict with the two published messages' payloads."""
        T = _iso(np.asarray(R_cam, float), np.asarray(p_cam, float))
        T_wc = _inv(T) if self._invert_input else T

        out = None
        if self._T_wc_pre is None:
            # first frame anchors the world→body origin (stereo-pub-node.cpp:156)
            self._T_wb_init = T_wc @ _inv(self.T_bc)
        else:
            rel = self.T_bc @ _inv(self._T_wc_pre) @ T_wc @ _inv(self.T_bc)
            T_wb = _inv(self._T_wb_init) @ T_wc @ _inv(self.T_bc)
            out = {
                "t_pre": self._t_pre,
                "t_now": t_stamp,
                "dp_body": rel[:3, 3].copy(),
                "p_world_body": T_wb[:3, 3].copy(),
                "q_world_body": quat_from_rot(T_wb[:3, :3]),
            }
        self._T_wc_pre = T_wc
        self._t_pre = t_stamp
        return out

    def process_trajectory(self, R_cams, p_cams, stamps):
        """Vector form: returns RawLog-style vo arrays (skipping frame 0)."""
        t_pre, t_now, dps, qs, ps = [], [], [], [], []
        for R, p, t in zip(R_cams, p_cams, stamps):
            out = self.process(R, p, t)
            if out is not None:
                t_pre.append(out["t_pre"])
                t_now.append(out["t_now"])
                dps.append(out["dp_body"])
                qs.append(out["q_world_body"])
                ps.append(out["p_world_body"])
        return (
            np.asarray(t_pre), np.asarray(t_now), np.asarray(dps),
            np.asarray(qs), np.asarray(ps),
        )


class RGBDVOFrontend(StereoVOFrontend):
    """RGB-D modality (C11: rgbd-slam-node.cpp:34-53): ORB-SLAM3's TrackRGBD
    returns the same metric camera pose as TrackStereo, so the downstream
    geometry is identical to the stereo frontend. Kept as its own type so
    replay configs can declare the sensor modality explicitly."""


class MonocularVOFrontend(StereoVOFrontend):
    """Monocular modality (C11: monocular-slam-node.cpp:34-43): TrackMonocular
    poses are defined only up to scale. ``scale`` rescales translations to
    metric units (e.g. fit offline against leg odometry); rotation is
    scale-free, so ``q_world_body`` is usable by the orientation EKF as-is
    while ``dp_body``/``p_world_body`` carry the calibrated scale.
    """

    def __init__(self, R_ic, p_ic, scale: float = 1.0,
                 camera_pose_is_inverse: bool = True):
        super().__init__(R_ic, p_ic, camera_pose_is_inverse)
        self.scale = float(scale)

    def process(self, R_cam, p_cam, t_stamp):
        out = super().process(
            R_cam, np.asarray(p_cam, float) * self.scale, t_stamp
        )
        return out


def approximate_time_sync(t_a, t_b, max_dt: float = 0.01):
    """Pair two stamped streams the way message_filters' ApproximateTime sync
    does for the stereo/rgbd/stereo-decentralized nodes (C10/C11,
    stereo-pub-node.cpp:74-77): each A-stamp is matched to the nearest
    B-stamp within ``max_dt``; unmatched frames are dropped.

    Returns (idx_a, idx_b) index arrays of equal length into the two streams.
    """
    t_a = np.asarray(t_a, float)
    t_b = np.asarray(t_b, float)
    if t_a.size == 0 or t_b.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    pos = np.searchsorted(t_b, t_a)
    lo = np.clip(pos - 1, 0, len(t_b) - 1)
    hi = np.clip(pos, 0, len(t_b) - 1)
    nearest = np.where(
        np.abs(t_b[hi] - t_a) < np.abs(t_b[lo] - t_a), hi, lo
    )
    ok = np.abs(t_b[nearest] - t_a) <= max_dt
    idx_a = np.nonzero(ok)[0]
    idx_b = nearest[ok]
    # each B frame pairs with at most one A frame; on collision keep the A
    # frame with the closest stamp (ApproximateTime pairs nearest, not first)
    gap = np.abs(t_b[idx_b] - t_a[idx_a])
    order = np.lexsort((gap, idx_b))  # sort by idx_b, then by |dt|
    _, first = np.unique(idx_b[order], return_index=True)
    keep = np.sort(order[first])
    return idx_a[keep], idx_b[keep]


def sync_stereo_inertial(t_imu, t_left, t_right, max_time_diff: float = 0.01):
    """Offline equivalent of the stereo-inertial node's buffered SyncWithImu
    thread (C11, stereo-inertial-node.cpp:135-216): match stereo pairs within
    ``maxTimeDiff`` (the node's 0.01 s), drop frames that outrun the IMU
    stream, and batch every IMU sample with stamp ≤ the left-image stamp to
    its frame (the `vImuMeas` slice handed to TrackStereo).

    Returns (idx_left, idx_right, imu_start, imu_end) — per matched frame,
    the image indices and the [start, end) IMU slice; slices are contiguous
    and non-overlapping exactly as the node's queue-draining loop produces.
    """
    t_imu = np.asarray(t_imu, float)
    t_left = np.asarray(t_left, float)
    t_right = np.asarray(t_right, float)
    idx_l, idx_r = approximate_time_sync(t_left, t_right, max_time_diff)
    if t_imu.size == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    # the node waits until IMU data reaches the image stamp
    ok = t_left[idx_l] <= t_imu[-1]
    idx_l, idx_r = idx_l[ok], idx_r[ok]
    imu_end = np.searchsorted(t_imu, t_left[idx_l], side="right")
    imu_start = np.concatenate([[0], imu_end[:-1]])
    return idx_l, idx_r, imu_start, imu_end
