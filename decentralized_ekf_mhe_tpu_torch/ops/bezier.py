"""Cubic-Bezier VO interpolation carry.

The reference turns sparse ~30 Hz VO frames into per-tick equality-constraint
increments by fitting a cubic Bezier over the last 4 accumulated VO waypoints
and sampling it at the estimator rate (Bezier_simple.cpp:12-82, driven from
DecentralEst.cpp:915-933). The waypoint list is a fixed (B,4,3) buffer and
interpolation emits a fixed-length masked node array.

Waypoint *times* and the *count* are either shared by the whole fleet — one
camera clock: times (4,), count 0-d int32 — or per instance — every lane its
own camera clock: times (B,4), count (B,) (``init(per_instance_schedule=
True)``); ``add_way_point`` and ``eval_at`` take both layouts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device


class BezierCarry(NamedTuple):
    pts: torch.Tensor      # (...,4,3) control points, oldest..newest
    times: torch.Tensor    # (4,) shared or (B,4) per-instance waypoint times
    count: torch.Tensor    # int32 points ever added: 0-d or (B,); a host int
                           # in the standard layout's state (ops.mhe), as T is
    p_accum: torch.Tensor  # (...,3) accumulated world-frame VO path


def init(dtype=torch.float32, batch=(), per_instance_schedule=False,
         device="cuda") -> BezierCarry:
    device = resolve_device(device)
    sched = tuple(batch) if per_instance_schedule else ()
    return BezierCarry(
        pts=torch.zeros(tuple(batch) + (4, 3), dtype=dtype, device=device),
        times=torch.zeros(sched + (4,), dtype=dtype, device=device),
        count=torch.zeros(sched, dtype=torch.int32, device=device),
        p_accum=torch.zeros(tuple(batch) + (3,), dtype=dtype, device=device),
    )


def add_way_point(c: BezierCarry, p: torch.Tensor, t_end,
                  mask=None) -> BezierCarry:
    """Push (p, t); keep the last 4 (Bezier_simple.cpp:12-27). Returns a new
    carry; the old tensors are not modified.

    With a per-instance schedule (or a ``mask``) the push is a masked select
    per instance, as in the reference: ``t_end`` is a scalar or (B,), and
    instances whose ``mask`` (B,) is False keep their carry (their VO frame
    did not arrive). A count held as a host int stays one, and is read
    without a device sync."""
    if mask is not None or (torch.is_tensor(c.count) and c.count.ndim):
        return _add_way_point_masked(c, p, t_end, mask)
    count = int(c.count)
    pts, times = c.pts, c.times
    if count >= 4:
        pts = torch.roll(pts, -1, dims=-2)
        times = torch.roll(times, -1, dims=-1)
        write = 3
    else:
        pts = pts.clone()
        times = times.clone()
        write = max(count, 0)
    pts[..., write, :] = p
    times[write] = torch.as_tensor(t_end, dtype=times.dtype, device=times.device)
    return BezierCarry(pts=pts, times=times, count=c.count + 1,
                       p_accum=c.p_accum)


def _add_way_point_masked(c: BezierCarry, p, t_end, mask):
    """``add_way_point`` as mask-selects (the reference's form), for batched
    times/count and masked pushes."""
    full = c.count >= 4
    write = torch.where(full, torch.full_like(c.count, 3),
                        torch.clamp(c.count, 0, 3))
    sel = torch.arange(4, device=c.count.device) == write[..., None]   # (...,4)
    base = torch.where(full[..., None, None], torch.roll(c.pts, -1, dims=-2),
                       c.pts)
    pts = torch.where(sel[..., None], p[..., None, :], base)
    base_t = torch.where(full[..., None], torch.roll(c.times, -1, dims=-1),
                         c.times)
    t_val = torch.as_tensor(t_end, dtype=c.times.dtype, device=c.times.device)
    t_val = t_val[..., None] if t_val.ndim else t_val
    times = torch.where(sel, t_val, base_t)
    new = BezierCarry(pts=pts, times=times, count=c.count + 1,
                      p_accum=c.p_accum)
    if mask is None:
        return new
    m = torch.as_tensor(mask, device=c.pts.device).bool()

    def pick(a, b):
        return torch.where(m.reshape(m.shape + (1,) * (a.ndim - m.ndim)), a, b)

    return BezierCarry(*(pick(a, b) for a, b in zip(new, c)))


def _bezier(u, P0, P1, P2, P3):
    """Cubic blend (Bezier_simple.cpp:73-82); u (...,n) broadcasts over
    nodes, P* are (...,3) -> result (...,n,3)."""
    u = u[..., :, None]
    P0, P1, P2, P3 = (P[..., None, :] for P in (P0, P1, P2, P3))
    return (
        u**3 * (-P0 + 3 * P1 - 3 * P2 + P3)
        + u**2 * (3 * P0 - 6 * P1 + 3 * P2)
        + u * (-3 * P0 + 3 * P1)
        + P0
    )


def interpolate_increments(c: BezierCarry, t_start, num, dt, max_nodes: int):
    """Sample ``num`` nodes from t_start at spacing dt; returns per-node
    increments (diffs (...,max_nodes,3)), nodes, and a validity mask.

    diffs[0] = node_0 − 0 (node_pre seeded to zero, Bezier_simple.cpp:70) —
    the consumer skips it exactly as UpdateVOConstraints does
    (DecentralEst.cpp:993-999 uses _distances[i+1]).
    """
    dtype, dev = c.times.dtype, c.times.device
    t_interval = c.times[3] - c.times[0]
    u0 = (torch.as_tensor(t_start, dtype=dtype, device=dev) - c.times[0]) / t_interval
    du = dt / t_interval
    i = torch.arange(max_nodes, dtype=dtype, device=dev)
    u = u0 + du * i
    nodes = _bezier(
        u, c.pts[..., 0, :], c.pts[..., 1, :], c.pts[..., 2, :], c.pts[..., 3, :]
    )
    node_prev = torch.cat(
        [torch.zeros_like(nodes[..., :1, :]), nodes[..., :-1, :]], dim=-2
    )
    diffs = nodes - node_prev
    mask = i < torch.as_tensor(num, dtype=dtype, device=dev)
    return diffs, nodes, mask


def eval_at(c: BezierCarry, u):
    """Evaluate the current cubic at parameter(s) ``u`` (...,n) -> (...,n,3)."""
    return _bezier(u, c.pts[..., 0, :], c.pts[..., 1, :], c.pts[..., 2, :],
                   c.pts[..., 3, :])
