"""rosbag2 → RawLog converter — pure Python, no ROS dependency.

The reference consumes live DDS topics (EstSub.cpp:17-23, go1Sub.cpp:13-23);
recordings of those topics are rosbag2 directories: an SQLite3 ``*.db3``
with `topics` (name, type, serialization_format='cdr') and `messages`
(topic_id, timestamp, data) tables, message payloads in CDR (XCDR1)
little-endian encapsulation. This module deserializes exactly the message
set the Go1 deployment uses and assembles an ``io.replay.RawLog`` that the
alignment pass (io/replay.align) turns into scan-ready tensors:

- ``/unitree/imu``          sensor_msgs/msg/Imu           (go1Sub.cpp:13-15)
- ``/unitree/joint_state``  sensor_msgs/msg/JointState    (go1Sub.cpp:17-19;
  position[12+i] carries the per-leg foot force used for contact detection,
  go1Sub.cpp:74)
- ``orb/vo``    custom_msgs/msg/VoRealtiveTransform (stereo-pub-node.cpp:182-192;
  carries both image stamps — the dual-timestamp sync driver)
- ``orb/pos``   geometry_msgs/msg/PoseStamped       (stereo-pub-node.cpp:168-179)
- ``/mocap/RigidBody``  optitrack_broadcast/msg/Mocap (go1Sub.cpp:128-155;
  quaternion stored [w,x,y,z] — matches this package's convention)

Quaternions from ROS geometry messages are (x,y,z,w) on the wire and are
reordered to this package's [w,x,y,z].
"""

from __future__ import annotations

import os
import sqlite3
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from decentralized_ekf_mhe_tpu_torch.io.replay import RawLog

DEFAULT_TOPICS = {
    "imu": "/unitree/imu",
    "joint_state": "/unitree/joint_state",
    "vo": "orb/vo",
    "vo_pose": "orb/pos",
    "mocap": "/mocap/RigidBody",
}


class CDRReader:
    """Minimal XCDR1 deserializer (little-endian payloads, 4-byte
    encapsulation header, natural alignment relative to the payload start)."""

    def __init__(self, buf: bytes):
        # encapsulation: {representation id (2B), options (2B)}. The id is
        # a BYTE PAIR on the wire (RTPS spec): {0x00,0x01} = CDR_LE,
        # {0x00,0x00} = CDR_BE, {0x00,0x03}/{0x00,0x02} = PL_CDR_LE/BE.
        # (An earlier revision unpacked it as a little-endian u16 and
        # compared against 0x0001 — self-consistent with this module's own
        # writer but flipping REAL ROS2 bags to big-endian; caught by the
        # hand-authored golden fixtures in tests/test_rosbag.py.)
        if len(buf) < 4:
            raise ValueError("CDR payload too short")
        self.little = buf[0] == 0x00 and buf[1] in (0x01, 0x03)
        self.buf = buf
        self.off = 4

    def _align(self, n: int):
        pad = (-(self.off - 4)) % n
        self.off += pad

    def _read(self, fmt: str, size: int):
        self._align(size)
        end = "<" if self.little else ">"
        val = struct.unpack_from(end + fmt, self.buf, self.off)[0]
        self.off += size
        return val

    def u8(self):
        return self._read("B", 1)

    def i32(self):
        return self._read("i", 4)

    def u32(self):
        return self._read("I", 4)

    def f32(self):
        return self._read("f", 4)

    def f64(self):
        return self._read("d", 8)

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off:self.off + n - 1] if n else b""
        self.off += n
        return s.decode("utf-8", "replace")

    def f64_array(self, n: int) -> np.ndarray:
        self._align(8)
        out = np.frombuffer(self.buf, dtype="<f8" if self.little else ">f8",
                            count=n, offset=self.off)
        self.off += 8 * n
        return np.asarray(out, np.float64)

    def f32_array(self, n: int) -> np.ndarray:
        self._align(4)
        out = np.frombuffer(self.buf, dtype="<f4" if self.little else ">f4",
                            count=n, offset=self.off)
        self.off += 4 * n
        return np.asarray(out, np.float64)

    def f64_seq(self) -> np.ndarray:
        return self.f64_array(self.u32())

    def string_seq(self) -> List[str]:
        return [self.string() for _ in range(self.u32())]

    def header(self) -> float:
        """std_msgs/Header → stamp in seconds (frame_id consumed).

        Reconstruction is ``sec + nanosec/1e9`` — the exact inverse of
        CDRWriter.header / quantize_time for any stamp on the nanosecond
        grid (times < ~9e6 s), so timestamp-sensitive alignment decisions
        survive a bag round trip bit-for-bit."""
        sec = self.i32()
        nanosec = self.u32()
        self.string()
        return sec + nanosec / 1e9


def _quat_xyzw_to_wxyz(x, y, z, w):
    return np.array([w, x, y, z])


def parse_imu(buf: bytes):
    r = CDRReader(buf)
    t = r.header()
    qx, qy, qz, qw = (r.f64() for _ in range(4))
    r.f64_array(9)
    gyro = np.array([r.f64(), r.f64(), r.f64()])
    r.f64_array(9)
    accel = np.array([r.f64(), r.f64(), r.f64()])
    r.f64_array(9)
    return t, accel, gyro, _quat_xyzw_to_wxyz(qx, qy, qz, qw)


def parse_joint_state(buf: bytes):
    r = CDRReader(buf)
    t = r.header()
    names = r.string_seq()
    pos = r.f64_seq()
    vel = r.f64_seq()
    eff = r.f64_seq()
    return t, names, pos, vel, eff


def parse_vo_relative_transform(buf: bytes):
    r = CDRReader(buf)
    t_now = r.header()
    t_pre = r.header()
    dp = np.array([r.f64(), r.f64(), r.f64()])
    return t_pre, t_now, dp


def parse_pose_stamped(buf: bytes):
    r = CDRReader(buf)
    t = r.header()
    p = np.array([r.f64(), r.f64(), r.f64()])
    qx, qy, qz, qw = (r.f64() for _ in range(4))
    return t, p, _quat_xyzw_to_wxyz(qx, qy, qz, qw)


def parse_mocap(buf: bytes):
    r = CDRReader(buf)
    t = r.header()
    p = r.f32_array(3)
    v = r.f32_array(3)
    r.f32_array(3)  # angular velocity (unused by the estimator)
    q = r.f32_array(4)  # already [w,x,y,z] (go1Sub.cpp:146-150)
    return t, p, v, q


def read_messages(bag_path: str) -> Dict[str, List[tuple]]:
    """Read a rosbag2 directory (or .db3 file); returns
    {topic_name: [(bag_timestamp_ns, raw_cdr_bytes), ...]} sorted by time.

    A directory with a ``metadata.yaml`` (the rosbag2 layout) is read via its
    ``relative_file_paths`` — the authoritative split-file ordering; without
    one, all ``*.db3`` files are taken in name order."""
    if os.path.isdir(bag_path):
        meta = os.path.join(bag_path, "metadata.yaml")
        paths = None
        if os.path.exists(meta):
            import yaml

            with open(meta) as f:
                info = yaml.safe_load(f) or {}
            rel = (info.get("rosbag2_bagfile_information") or {}).get(
                "relative_file_paths") or []
            if rel:
                paths = [os.path.join(bag_path, p) for p in rel]
                missing = [p for p in paths if not os.path.exists(p)]
                if missing:
                    raise FileNotFoundError(
                        f"metadata.yaml names missing bag files: {missing}")
        if paths is None:
            db3s = sorted(f for f in os.listdir(bag_path)
                          if f.endswith(".db3"))
            if not db3s:
                raise FileNotFoundError(f"no .db3 files under {bag_path}")
            paths = [os.path.join(bag_path, f) for f in db3s]
    else:
        paths = [bag_path]

    out: Dict[str, List[tuple]] = {}
    for p in paths:
        con = sqlite3.connect(p)
        try:
            topics = {tid: name for tid, name in
                      con.execute("SELECT id, name FROM topics")}
            for tid, ts, data in con.execute(
                    "SELECT topic_id, timestamp, data FROM messages"):
                out.setdefault(topics[tid], []).append((ts, bytes(data)))
        finally:
            con.close()
    for name in out:
        out[name].sort(key=lambda kv: kv[0])
    return out


def rawlog_from_rosbag(bag_path: str, topics: Optional[dict] = None,
                       num_legs: int = 4,
                       use_header_stamps: bool = True) -> RawLog:
    """Convert a Go1-deployment rosbag2 recording to a RawLog.

    ``use_header_stamps``: timestamps come from each message's header (the
    reference syncs on header stamps, DecentralEst.cpp:889-913); False falls
    back to bag receive times (for bags recorded without synchronized clocks).
    """
    tp = dict(DEFAULT_TOPICS)
    if topics:
        tp.update(topics)
    msgs = read_messages(bag_path)

    def stamps_of(pairs, header_t):
        return (np.asarray(header_t)
                if use_header_stamps else
                np.asarray([ts / 1e9 for ts, _ in pairs]))

    imu_pairs = msgs.get(tp["imu"], [])
    if not imu_pairs:
        raise ValueError(f"no messages on IMU topic {tp['imu']!r}; "
                         f"topics present: {sorted(msgs)}")
    imu = [parse_imu(b) for _, b in imu_pairs]
    imu_t = stamps_of(imu_pairs, [m[0] for m in imu])
    accel_b = np.stack([m[1] for m in imu])
    gyro_b = np.stack([m[2] for m in imu])

    js_pairs = msgs.get(tp["joint_state"], [])
    if not js_pairs:
        raise ValueError(f"no messages on joint-state topic "
                         f"{tp['joint_state']!r}")
    js = [parse_joint_state(b) for _, b in js_pairs]
    joint_t = stamps_of(js_pairs, [m[0] for m in js])
    n_j = 3 * num_legs
    joint_pos = np.stack([np.resize(m[2], n_j + num_legs)[:n_j] for m in js])
    joint_vel = np.stack([np.resize(m[3], n_j)[:n_j] for m in js])
    # foot force rides in position[12+i] on the Go1 (go1Sub.cpp:74)
    foot_force = np.stack([
        m[2][n_j:n_j + num_legs] if len(m[2]) >= n_j + num_legs
        else np.zeros(num_legs) for m in js])

    vo_pairs = msgs.get(tp["vo"], [])
    vo = [parse_vo_relative_transform(b) for _, b in vo_pairs]
    vo_t_pre = np.asarray([m[0] for m in vo])
    vo_t_now = np.asarray([m[1] for m in vo])
    vo_dp = (np.stack([m[2] for m in vo])
             if vo else np.zeros((0, 3)))
    # bag receive times carry the real transport latency → arrival ticks
    vo_t_recv = np.asarray([ts / 1e9 for ts, _ in vo_pairs])

    pose_pairs = msgs.get(tp["vo_pose"], [])
    poses = [parse_pose_stamped(b) for _, b in pose_pairs]
    # pair world-orientation quaternions to VO events by the image stamp
    vo_q = np.zeros((len(vo), 4))
    if poses and vo:
        pose_t = np.asarray([m[0] for m in poses])
        pose_q = np.stack([m[2] for m in poses])
        idx = np.clip(np.searchsorted(pose_t, vo_t_now), 0, len(poses) - 1)
        near = np.abs(pose_t[idx] - vo_t_now) < 0.5 / max(len(poses), 1) * (
            pose_t[-1] - pose_t[0] + 1e-9) + 1e-3
        vo_q = np.where(near[:, None], pose_q[idx],
                        np.tile([1.0, 0, 0, 0], (len(vo), 1)))

    mocap_pairs = msgs.get(tp["mocap"], [])
    mc = [parse_mocap(b) for _, b in mocap_pairs]
    mocap_t = stamps_of(mocap_pairs, [m[0] for m in mc]) if mc else np.zeros(0)
    mocap_p = np.stack([m[1] for m in mc]) if mc else np.zeros((0, 3))
    mocap_v = np.stack([m[2] for m in mc]) if mc else np.zeros((0, 3))
    mocap_q = np.stack([m[3] for m in mc]) if mc else np.zeros((0, 4))

    return RawLog(
        imu_t=imu_t, accel_b=accel_b, gyro_b=gyro_b,
        joint_t=joint_t, joint_pos=joint_pos, joint_vel=joint_vel,
        foot_force=foot_force,
        vo_t_pre=vo_t_pre, vo_t_now=vo_t_now, vo_dp_body=vo_dp,
        vo_q_wb=vo_q, vo_t_recv=vo_t_recv,
        mocap_t=mocap_t, mocap_p=mocap_p, mocap_v=mocap_v, mocap_q=mocap_q,
    )


def quantize_time(t):
    """Project stamps onto the wire's nanosecond grid (what a header stamp
    can represent); idempotent with CDRWriter.header/CDRReader.header."""
    t = np.asarray(t, np.float64)
    total_ns = np.round(t * 1e9)
    return (total_ns // 1_000_000_000) + (total_ns % 1_000_000_000) / 1e9


def quantize_rawlog(raw: RawLog) -> RawLog:
    """RawLog with every timestamp quantized to the wire grid — what the
    same log looks like after any rosbag round trip."""
    import dataclasses

    return dataclasses.replace(
        raw,
        imu_t=quantize_time(raw.imu_t), joint_t=quantize_time(raw.joint_t),
        vo_t_pre=quantize_time(raw.vo_t_pre),
        vo_t_now=quantize_time(raw.vo_t_now),
        vo_t_recv=quantize_time(raw.vo_t_recv),
        mocap_t=quantize_time(raw.mocap_t),
    )


# -------------------------------------------------------- CDR serialization
# (writer side — used to synthesize test bags and to round-trip RawLogs)


class CDRWriter:
    def __init__(self):
        # CDR_LE encapsulation: the wire bytes are {0x00, 0x01, 0x00, 0x00}
        self.parts = [b"\x00\x01\x00\x00"]
        self.off = 0

    def _align(self, n: int):
        pad = (-self.off) % n
        if pad:
            self.parts.append(b"\x00" * pad)
            self.off += pad

    def _write(self, fmt: str, size: int, val):
        self._align(size)
        self.parts.append(struct.pack("<" + fmt, val))
        self.off += size

    def i32(self, v):
        self._write("i", 4, int(v))

    def u32(self, v):
        self._write("I", 4, int(v))

    def f64(self, v):
        self._write("d", 8, float(v))

    def f32(self, v):
        self._write("f", 4, float(v))

    def string(self, s: str):
        b = s.encode() + b"\x00"
        self.u32(len(b))
        self.parts.append(b)
        self.off += len(b)

    def f64_array(self, vals):
        for v in np.asarray(vals).ravel():
            self.f64(v)

    def f32_array(self, vals):
        for v in np.asarray(vals).ravel():
            self.f32(v)

    def f64_seq(self, vals):
        vals = np.asarray(vals).ravel()
        self.u32(len(vals))
        self.f64_array(vals)

    def string_seq(self, vals):
        self.u32(len(vals))
        for s in vals:
            self.string(s)

    def header(self, t: float, frame_id: str = ""):
        total_ns = int(round(t * 1e9))
        self.i32(total_ns // 1_000_000_000)
        self.u32(total_ns % 1_000_000_000)
        self.string(frame_id)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


def _ser_imu(t, accel, gyro, q_wxyz=(1.0, 0, 0, 0)):
    w = CDRWriter()
    w.header(t)
    qw, qx, qy, qz = q_wxyz
    for v in (qx, qy, qz, qw):
        w.f64(v)
    w.f64_array(np.zeros(9))
    w.f64_array(gyro)
    w.f64_array(np.zeros(9))
    w.f64_array(accel)
    w.f64_array(np.zeros(9))
    return w.bytes()


def _ser_joint_state(t, pos, vel, eff):
    w = CDRWriter()
    w.header(t)
    w.string_seq([f"j{i}" for i in range(len(pos))])
    w.f64_seq(pos)
    w.f64_seq(vel)
    w.f64_seq(eff)
    return w.bytes()


def _ser_vo(t_pre, t_now, dp):
    w = CDRWriter()
    w.header(t_now)
    w.header(t_pre)
    w.f64_array(dp)
    return w.bytes()


def _ser_pose(t, p, q_wxyz):
    w = CDRWriter()
    w.header(t)
    w.f64_array(p)
    qw, qx, qy, qz = q_wxyz
    for v in (qx, qy, qz, qw):
        w.f64(v)
    return w.bytes()


def _ser_mocap(t, p, v, q_wxyz):
    w = CDRWriter()
    w.header(t)
    w.f32_array(p)
    w.f32_array(v)
    w.f32_array(np.zeros(3))
    w.f32_array(q_wxyz)
    return w.bytes()


def write_rosbag(bag_dir: str, rawlog: RawLog, topics: Optional[dict] = None,
                 max_messages_per_file: Optional[int] = None):
    """Write a RawLog back out as a rosbag2-layout directory: one or more
    ``data_<i>.db3`` files plus a ``metadata.yaml`` (the layout `ros2 bag
    record --max-bag-size` produces; test fixture + interchange with
    reference tooling).

    ``max_messages_per_file`` splits the stream across multiple .db3 files
    in time order (every file carries the full topics table, as rosbag2
    does); default is one file. Returns the first .db3 path."""
    tp = dict(DEFAULT_TOPICS)
    if topics:
        tp.update(topics)
    os.makedirs(bag_dir, exist_ok=True)
    names_types = [
        (1, tp["imu"], "sensor_msgs/msg/Imu"),
        (2, tp["joint_state"], "sensor_msgs/msg/JointState"),
        (3, tp["vo"], "custom_msgs/msg/VoRealtiveTransform"),
        (4, tp["vo_pose"], "geometry_msgs/msg/PoseStamped"),
        (5, tp["mocap"], "optitrack_broadcast/msg/Mocap"),
    ]

    def write_db(path, chunk):
        con = sqlite3.connect(path)
        try:
            con.execute("""CREATE TABLE topics (
                id INTEGER PRIMARY KEY, name TEXT NOT NULL, type TEXT NOT NULL,
                serialization_format TEXT NOT NULL,
                offered_qos_profiles TEXT NOT NULL)""")
            con.execute("""CREATE TABLE messages (
                id INTEGER PRIMARY KEY, topic_id INTEGER NOT NULL,
                timestamp INTEGER NOT NULL, data BLOB NOT NULL)""")
            for tid, name, typ in names_types:
                con.execute("INSERT INTO topics VALUES (?,?,?,?,?)",
                            (tid, name, typ, "cdr", ""))
            con.executemany(
                "INSERT INTO messages (topic_id, timestamp, data) "
                "VALUES (?,?,?)", chunk)
            con.commit()
        finally:
            con.close()

    if True:
        rows = []
        for k in range(len(rawlog.imu_t)):
            rows.append((1, int(rawlog.imu_t[k] * 1e9),
                         _ser_imu(rawlog.imu_t[k], rawlog.accel_b[k],
                                  rawlog.gyro_b[k])))
        L = rawlog.foot_force.shape[1] if rawlog.foot_force.ndim == 2 else 0
        for k in range(len(rawlog.joint_t)):
            pos = np.concatenate([rawlog.joint_pos[k], rawlog.foot_force[k]])
            rows.append((2, int(rawlog.joint_t[k] * 1e9),
                         _ser_joint_state(rawlog.joint_t[k], pos,
                                          rawlog.joint_vel[k],
                                          np.zeros(len(pos)))))
        has_recv = len(rawlog.vo_t_recv) == len(rawlog.vo_t_now)
        for k in range(len(rawlog.vo_t_now)):
            # bag timestamp = receive time when known (transport latency
            # survives the rosbag round trip)
            ts = (rawlog.vo_t_recv[k] if has_recv and len(rawlog.vo_t_recv)
                  else rawlog.vo_t_now[k])
            rows.append((3, int(ts * 1e9),
                         _ser_vo(rawlog.vo_t_pre[k], rawlog.vo_t_now[k],
                                 rawlog.vo_dp_body[k])))
            if len(rawlog.vo_q_wb):
                rows.append((4, int(ts * 1e9),
                             _ser_pose(rawlog.vo_t_now[k], np.zeros(3),
                                       rawlog.vo_q_wb[k])))
        for k in range(len(rawlog.mocap_t)):
            rows.append((5, int(rawlog.mocap_t[k] * 1e9),
                         _ser_mocap(rawlog.mocap_t[k], rawlog.mocap_p[k],
                                    rawlog.mocap_v[k], rawlog.mocap_q[k])))
        rows.sort(key=lambda r: r[1])

    n_per = max_messages_per_file or max(len(rows), 1)
    n_files = max(1, -(-len(rows) // n_per))
    rel_paths = []
    for fi in range(n_files):
        rel = f"data_{fi}.db3"
        write_db(os.path.join(bag_dir, rel),
                 rows[fi * n_per:(fi + 1) * n_per])
        rel_paths.append(rel)

    # metadata.yaml (rosbag2_bagfile_information) — the authoritative file
    # list + per-topic counts (what `ros2 bag info` reads)
    from collections import Counter

    counts = Counter(tid for tid, _, _ in rows)
    t0 = rows[0][1] if rows else 0
    t1 = rows[-1][1] if rows else 0
    topic_entries = "\n".join(
        f"    - topic_metadata:\n"
        f"        name: {name}\n"
        f"        type: {typ}\n"
        f"        serialization_format: cdr\n"
        f"        offered_qos_profiles: \"\"\n"
        f"      message_count: {counts.get(tid, 0)}"
        for tid, name, typ in names_types)
    with open(os.path.join(bag_dir, "metadata.yaml"), "w") as f:
        f.write(
            "rosbag2_bagfile_information:\n"
            "  version: 5\n"
            "  storage_identifier: sqlite3\n"
            "  relative_file_paths:\n"
            + "".join(f"    - {p}\n" for p in rel_paths)
            + f"  duration:\n    nanoseconds: {t1 - t0}\n"
            f"  starting_time:\n    nanoseconds_since_epoch: {t0}\n"
            f"  message_count: {len(rows)}\n"
            "  topics_with_message_count:\n"
            + topic_entries + "\n"
            "  compression_format: \"\"\n"
            "  compression_mode: \"\"\n")
    return os.path.join(bag_dir, rel_paths[0])
