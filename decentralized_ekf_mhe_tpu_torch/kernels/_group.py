"""The launch geometry of the kernels that run a group of threads per instance.

The constrained MHE tick (``mhe_replay_kernel``), the whole-window box-ADMM
(``admm_kernel``, K4) and the block-tridiagonal solve (``tridiag_kernel``, K5)
each run ``BOX_G`` = 16 threads per instance: ``block // BOX_G`` instances per
block, each with its own slice of the block's dynamic shared memory, whose
size the CUDA side computes from the same layout (``BoxLayout::stride`` of
``csrc/admm_group.cuh``, ``TriLayout::stride`` of ``csrc/tridiag.cuh``). Here
the wrappers choose a block and refuse, before a launch, a block the card
could not take (each geometry computed once: a launch asks for it every call).
"""

from __future__ import annotations

import functools
from typing import NamedTuple


BOX_G = 16          # threads per instance (csrc/admm_group.cuh's BOX_G)
# threads per block unless the caller names ``block``: eight instances, the
# fastest of 2, 4, 5 and 8 at Go1's and Cassie's shapes in float32 in the sweep
# of tools/roofline.py --box-layouts on the card (PERF.md §5), or as many as
# fit a block's shared memory where eight do not (float64)
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


def instance_bytes(scalars, dtype):
    """Bytes of one instance's shared memory of ``scalars`` elements of
    ``dtype``, padded to 16 mod 32 four-byte words (so that the two groups of
    a warp use different banks)."""
    words = scalars * dtype.itemsize // 4
    return (words + (16 - words % 32) % 32) * 4


def group_launch(scalars, dtype, block, what, default=BLOCK_BOX):
    """(instances per block, threads per block, shared bytes of a block,
    instances per SM as far as shared memory, threads and blocks allow) of a
    launch of ``block`` threads (None: ``default``, capped to the instances
    whose shared memory fits a block), ``BOX_G`` per instance, each instance
    with ``scalars`` of shared memory (``instance_bytes``). Raises
    ``ValueError`` for a block that is no multiple of ``BOX_G`` in 16..1024 or
    whose shared memory exceeds what a block may use."""
    one = instance_bytes(scalars, dtype)
    if block is None:
        block = min(default, BOX_G * (SHARED_PER_BLOCK // one))
    block = check_block(block)
    if block % BOX_G or block < BOX_G:
        raise ValueError(f"block: {block} threads per block is not a multiple of "
                         f"{BOX_G}, the {what}'s threads per instance")
    ipb = block // BOX_G
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
    s=15 it reads U_j from global memory (layout (a))."""
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
    slots: ``BOX_G`` threads per instance, so ``block // BOX_G`` instances per
    block, each with ``box_shared_scalars`` padded to 16 mod 32 four-byte
    words (``BoxLayout::stride``); U_j sits in shared memory where
    ``box_u_shared(s)``. Raises ``ValueError`` when ``block`` is not a
    multiple of ``BOX_G`` in 16..1024, when s > ``BOX_G``, or when the block's
    shared memory exceeds what a block may use (232,448 bytes)."""
    if s > BOX_G:
        raise ValueError(f"s={s}: the {what} runs at most {BOX_G} states")
    u_shared = box_u_shared(s)
    ipb, block, shared, per_sm = group_launch(
        box_shared_scalars(s, N, u_shared), dtype, block, f"{what} (s={s}, N={N})")
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
    if s > BOX_G:
        raise ValueError(f"s={s}: the tridiagonal solve runs at most {BOX_G} states")
    ipb, block, shared, per_sm = group_launch(
        tridiag_shared_scalars(s, N), dtype, block, f"tridiagonal solve (s={s}, N={N})")
    return TridiagGeometry(ipb, block, shared, per_sm)
