"""The launch geometry of the kernels that run a group of threads per instance.

The MHE tick (``mhe_replay_kernel``), the whole-window box-ADMM
(``admm_kernel``, K4) and the block-tridiagonal solve (``tridiag_kernel``, K5)
each run ``group_size(s)`` threads per instance — 16 below s=16 (two
instances per warp), a whole warp of 32 from s=16 to s=31 (Go1 with its foot
positions as states, s=21) — so ``block // group_size(s)`` instances per
block, each with its own slice of the block's dynamic shared memory, whose
size the CUDA side computes from the same layout (``BoxLayout::stride`` of
``csrc/admm_group.cuh``, ``TriLayout::stride`` of ``csrc/tridiag.cuh``,
``TickLayout::stride`` of ``csrc/mhe_body.cuh``). The
orientation-EKF stage (``ekf_kernel``, K1) runs ``EKF_G`` = 4 threads per
instance, one warp per block, with the history ring per instance and the
staged input stream per block in shared memory (``EkfDims`` of
``csrc/ekf.cuh``). Here the wrappers choose a block and refuse, before a
launch, a block the card could not take (each geometry computed once: a
launch asks for it every call).
"""

from __future__ import annotations

import functools
from typing import NamedTuple


# the largest state size a group runs: a warp's 32 lanes, lane r row r
MAX_GROUP_STATES = 31


def group_size(s):
    """Threads per instance of the group kernels at state size ``s``, as
    ``group_size<S>()`` of ``csrc/admm_group.cuh`` decides: 16 below s=16, 32
    (a warp) from s=16 to s=31. Raises ``ValueError`` for s >= 32, which no
    group runs."""
    if not 1 <= s <= MAX_GROUP_STATES:
        raise ValueError(f"s={s}: a group of threads per instance runs 1..{MAX_GROUP_STATES} "
                         "states (lane r owns row r of a warp)")
    return 16 if s < 16 else 32


# threads per block unless the caller names ``block``: eight instances of 16
# threads, the fastest of 2, 4, 5 and 8 at Go1's and Cassie's shapes in
# float32 in the sweep of tools/roofline.py --box-layouts on the card (PERF.md
# §5), or as many as fit a block's shared memory where eight do not (float64);
# on a warp per instance the same eight instances, 256 threads, as far as
# they fit
BLOCK_BOX = 128
# what one block may use of an SM's shared memory, and what an SM has for its
# blocks, each of which reserves 1 KB more (H100: 227 KB and 228 KB)
SHARED_PER_BLOCK, SHARED_PER_SM, SHARED_RESERVED_PER_BLOCK = 232448, 233472, 1024


def check_block(block):
    """Threads per block of a launch: 1..1024."""
    block = int(block)
    if not 1 <= block <= 1024:
        raise ValueError(f"block: {block} threads per block, expected 1..1024")
    return block


def instance_bytes(scalars, dtype, G=16):
    """Bytes of one instance's shared memory of ``scalars`` elements of
    ``dtype`` on a group of ``G`` threads (``group_stride`` of
    ``csrc/admm_group.cuh``): padded to 16 mod 32 four-byte words on a group
    of 16 (so that the two groups of a warp use different banks), rounded up
    to 16 bytes on a warp per instance."""
    words = scalars * dtype.itemsize // 4
    if G == 32:
        return -(-words // 4) * 16
    return (words + (16 - words % 32) % 32) * 4


def group_launch(scalars, dtype, block, what, default=BLOCK_BOX, G=16):
    """(instances per block, threads per block, shared bytes of a block,
    instances per SM as far as shared memory, threads and blocks allow) of a
    launch of ``block`` threads (None: the instances of ``default`` threads of
    groups of 16, capped to the instances whose shared memory fits a block),
    ``G`` per instance, each instance with
    ``scalars`` of shared memory (``instance_bytes``). Raises ``ValueError``
    for a block that is no multiple of ``G`` in G..1024 or whose shared memory
    exceeds what a block may use."""
    one = instance_bytes(scalars, dtype, G)
    if block is None:
        block = G * min(default // 16, SHARED_PER_BLOCK // one)
    block = check_block(block)
    if block % G or block < G:
        raise ValueError(f"block: {block} threads per block is not a multiple of "
                         f"{G}, the {what}'s threads per instance")
    ipb = block // G
    shared = ipb * one
    if shared > SHARED_PER_BLOCK:
        raise ValueError(
            f"{what}: {shared} bytes of shared memory for {ipb} instances per block "
            f"({dtype}), more than the {SHARED_PER_BLOCK} a block may use")
    blocks = min(SHARED_PER_SM // (shared + SHARED_RESERVED_PER_BLOCK), 32, 2048 // block)
    return ipb, block, shared, blocks * ipb


def card_figures(out, last=None):
    """out[0..5] of a library's geometry entry point (``group_geometry`` of
    ``csrc/admm_group.cuh``), and out[6] as the flag named ``last`` where
    there is one, as a dict, with the instances per SM the card keeps
    resident."""
    keys = ("instances_per_block", "threads_per_block", "shared_bytes", "blocks_per_sm",
            "registers_per_thread", "local_bytes_per_thread")
    res = dict(zip(keys, list(out)))
    if last is not None:
        res[last] = bool(out[6])
    res["instances_per_sm"] = res["blocks_per_sm"] * res["instances_per_block"]
    return res


def box_u_shared(s):
    """Whether the box-ADMM keeps U_j in shared memory (layout (b)) at state
    size s, as ``csrc/admm_group.cuh``'s ``box_u_shared`` decides: at s=9; at
    s=15 and s=21 it reads U_j from global memory (layout (a))."""
    return s <= 9


class BoxGeometry(NamedTuple):
    """The launch of the box-ADMM's group (``box_geometry``)."""

    instances_per_block: int
    threads_per_block: int
    shared_bytes: int           # dynamic shared memory of one block
    u_shared: bool              # U_j in shared memory (layout (b))
    instances_per_sm: int       # as far as shared memory, threads and blocks allow


def box_shared_scalars(s, N, u_shared):
    """Scalars of one instance's shared memory (``BoxLayout``): Sinv N s², U
    (N−1) s² in layout (b), x, z, y, the sweep vectors and r 5 N s, 6 s of
    broadcast buffers."""
    return N * s * s + (N - 1) * s * s * int(u_shared) + 5 * N * s + 6 * s


@functools.lru_cache(maxsize=None)
def box_geometry(s, dtype, block=None, N=20, what="constrained tick"):
    """The launch geometry of the box-ADMM on its group (the constrained
    tick's window solve, or K4 ``admm_solve``) at state size ``s``, element
    type ``dtype``, ``block`` threads per block (default ``BLOCK_BOX``,
    capped to the instances whose shared memory fits a block) and ``N``
    slots: ``group_size(s)`` threads per instance, so ``block //
    group_size(s)`` instances per block, each with ``box_shared_scalars``
    padded as ``instance_bytes`` pads (``BoxLayout::stride``); U_j sits in
    shared memory where ``box_u_shared(s)``. Raises ``ValueError`` when
    ``block`` is not a multiple of the group in G..1024, for s >= 32
    (``group_size``), or when the block's shared memory exceeds what a block
    may use (232,448 bytes)."""
    G = group_size(s)
    u_shared = box_u_shared(s)
    ipb, block, shared, per_sm = group_launch(
        box_shared_scalars(s, N, u_shared), dtype, block, f"{what} (s={s}, N={N})", G=G)
    return BoxGeometry(ipb, block, shared, u_shared, per_sm)


class TridiagGeometry(NamedTuple):
    """The launch of K5 on its group (``tridiag_geometry``)."""

    instances_per_block: int
    threads_per_block: int
    shared_bytes: int           # dynamic shared memory of one block
    instances_per_sm: int       # as far as shared memory, threads and blocks allow


def tridiag_shared_scalars(s, N):
    """Scalars of one instance's shared memory in K5 (``TriLayout``): the
    chain N s², W and the staged U block 2 s², y N s and 6 s of broadcast
    buffers."""
    return N * s * s + 2 * s * s + N * s + 6 * s


@functools.lru_cache(maxsize=None)
def tridiag_geometry(s, dtype, block=None, N=20):
    """The launch geometry of K5 (``tridiag_solve``, either layout) at state
    size ``s``, element type ``dtype``, ``block`` threads per block (default
    ``BLOCK_BOX``, capped to the instances whose shared memory fits a block)
    and ``N`` slots. Raises ``ValueError`` as ``box_geometry`` does."""
    ipb, block, shared, per_sm = group_launch(
        tridiag_shared_scalars(s, N), dtype, block, f"tridiagonal solve (s={s}, N={N})",
        G=group_size(s))
    return TridiagGeometry(ipb, block, shared, per_sm)


# K1: threads per instance (csrc/ekf.cuh's EKF_G: lane l owns row l), threads
# per block (one warp, 8 instances) and the substeps of one staged chunk of the
# input stream, rounded down to whole ticks (the launch takes the ticks)
EKF_G, EKF_BLOCK, EKF_CHUNK = 4, 32, 48


class EkfGeometry(NamedTuple):
    """The launch of K1 on its group (``ekf_geometry``)."""

    instances_per_block: int
    threads_per_block: int
    shared_bytes: int           # dynamic shared memory of one block
    ticks_per_chunk: int        # ticks of the input stream staged at a time
    instances_per_sm: int       # as far as shared memory, threads and blocks allow


@functools.lru_cache(maxsize=None)
def ekf_geometry(R, S, dtype, per_lane_vo_q=False):
    """The launch geometry of K1 (``ekf_stage``) for a ring of ``R`` slots,
    ``S`` substeps per tick, element type ``dtype`` and a shared or per-lane
    VO quaternion: ``EKF_BLOCK`` threads per block, ``max(1, EKF_CHUNK // S)``
    ticks per chunk, and the block's dynamic shared memory as ``EkfDims``
    lays it out: per instance the ring, 26 R scalars padded to 4 mod 32
    four-byte words (the 8 instances of a warp start in different banks); two
    buffers of the staged stream (gyro, accel and a per-lane VO quaternion: 6
    or 10 scalars per substep and instance) and of the shared VO quaternion
    (4 per substep); two buffers of the schedule (3 ints per substep). Raises
    ``ValueError`` when R or S is below 1, or when the block's shared memory
    exceeds what a block may use (232,448 bytes)."""
    if R < 1 or S < 1:
        raise ValueError(f"ekf_stage: ring of {R} slots, {S} substeps per tick")
    ipb, item = EKF_BLOCK // EKF_G, dtype.itemsize
    ct = max(1, EKF_CHUNK // S)
    cs = ct * S
    words = 26 * R * item // 4
    stride = (words + (EKF_G - words) % 32) * 4 // item
    scalars = ipb * stride + 2 * cs * (6 + 4 * bool(per_lane_vo_q)) * ipb + 2 * cs * 4
    shared = scalars * item + 2 * 3 * cs * 4
    if shared > SHARED_PER_BLOCK:
        raise ValueError(
            f"ekf_stage (R={R}, S={S}): {shared} bytes of shared memory for {ipb} instances "
            f"per block ({dtype}), more than the {SHARED_PER_BLOCK} a block may use")
    blocks = min(SHARED_PER_SM // (shared + SHARED_RESERVED_PER_BLOCK), 32, 2048 // EKF_BLOCK)
    return EkfGeometry(ipb, EKF_BLOCK, shared, ct, blocks * ipb)
