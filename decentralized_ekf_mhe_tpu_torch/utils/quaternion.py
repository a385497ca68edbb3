"""Quaternion and small-rotation primitives in standard layout (…, 4).

Counterpart of the reference ``utils/quaternion.py``: quaternion = [w, x, y,
z] (scalar first, orien_ekf.cpp:216), every function broadcasting over
leading batch axes. The instance-minor twins (…, 4, B) of the fleet path live
in ``ops/ekf_lanes.py``.

Reference anchors (behavioral parity):
- gyro_to_omega    <- orien_ekf::gyro_2_Ohm        (orien_ekf.cpp:214-228)
- quat_to_W        <- orien_ekf::quat_2_W          (orien_ekf.cpp:270-294)
- to_rot           <- orien_ekf::quat_2_Rot        (orien_ekf.cpp:296-305)
- quat_to_H        <- orien_ekf::quat_2_H          (orien_ekf.cpp:307-329)
- to_euler         <- orien_ekf::quaternionToEuler (orien_ekf.cpp:331-351)
- mul/inv          <- orien_ekf.cpp:230-268 (Eigen Quaterniond semantics)
- skew             <- EigenUtils::vector3dSkew     (EigenUtils.hpp:91-97)
"""

from __future__ import annotations

import math

import torch


def _mat(entries, shape, rows, cols):
    """Stack scalar fields (…) into a (…, rows, cols) matrix, row-major."""
    return torch.stack(entries, dim=-1).reshape(tuple(shape) + (rows, cols))


def normalize(q):
    """q / ||q|| (orien_ekf::quat_norm, orien_ekf.cpp:353-357)."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def mul(a, b):
    """Hamilton product a ⊗ b, [w,x,y,z]; normalized like quat_mul (:262)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    out = torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )
    return normalize(out)


def inv(q):
    """Inverse of a (normalized-first) quaternion (quat_inv, :230-244)."""
    qn = normalize(q)
    return qn * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=qn.dtype, device=qn.device)


def to_rot(q):
    """(…,4) -> (…,3,3) rotation matrix of the normalized quaternion
    (quat_2_Rot, orien_ekf.cpp:296-305). R maps body -> world for q = q_sb."""
    w, x, y, z = normalize(q).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return _mat(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        q.shape[:-1], 3, 3,
    )


def gyro_to_omega(w):
    """(…,3) gyro -> (…,4,4) Ω(ω) with q̇ = ½ Ω q (gyro_2_Ohm, :214-228)."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return _mat(
        [
            z, -wx, -wy, -wz,
            wx, z, wz, -wy,
            wy, -wz, z, wx,
            wz, wy, -wx, z,
        ],
        w.shape[:-1], 4, 4,
    )


def quat_to_W(q, dt, quirk_compatible: bool = True):
    """(…,4) -> (…,4,3) process-noise Jacobian, (dt/2)-scaled.

    The textbook matrix is (dt/2) [[-x,-y,-z],[w,-z,y],[z,w,-x],[-y,x,w]];
    the shipped reference (orien_ekf.cpp:277-293) overwrites row 2 with
    (z, x, w) and leaves row 3 at (-y, 0, 0). ``quirk_compatible=True``
    reproduces the shipped matrix."""
    w, x, y, z = q.unbind(-1)
    zero = torch.zeros_like(w)
    if quirk_compatible:
        rows = [-x, -y, -z, w, -z, y, z, x, w, -y, zero, zero]
    else:
        rows = [-x, -y, -z, w, -z, y, z, w, -x, -y, x, w]
    return (0.5 * dt) * _mat(rows, q.shape[:-1], 4, 3)


def quat_to_H(q, gravity):
    """(…,4) -> (…,3,4) Jacobian of h(q) = R(q)ᵀ g w.r.t. q (quat_2_H, :307-329)."""
    w, x, y, z = q.unbind(-1)
    gx, gy, gz = gravity[..., 0], gravity[..., 1], gravity[..., 2]
    return 2.0 * _mat(
        [
            gx * w + gy * z - gz * y,
            gx * x + gy * y + gz * z,
            -gx * y + gy * x - gz * w,
            -gx * z + gy * w + gz * x,
            -gx * z + gy * w + gz * x,
            gx * y - gy * x + gz * w,
            gx * x + gy * y + gz * z,
            -gx * w - gy * z + gz * y,
            gx * y - gy * x + gz * w,
            gx * z - gy * w - gz * x,
            gx * w + gy * z - gz * y,
            gx * x + gy * y + gz * z,
        ],
        q.shape[:-1], 3, 4,
    )


def to_euler(q):
    """(…,4) -> (…,3) [roll, pitch, yaw] (quaternionToEuler, :331-351)."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    sinp = 2 * (w * y - z * x)
    pitch = torch.where(
        torch.abs(sinp) >= 1.0,
        torch.sign(sinp) * (math.pi / 2),
        torch.asin(torch.clamp(sinp, -1.0, 1.0)),
    )
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def skew(v):
    """(…,3) -> (…,3,3) skew-symmetric matrix (EigenUtils.hpp:91-97)."""
    vx, vy, vz = v.unbind(-1)
    z = torch.zeros_like(vx)
    return _mat([z, -vz, vy, vz, z, -vx, -vy, vx, z], v.shape[:-1], 3, 3)
