"""Batched block-tridiagonal solve: hand-written CUDA kernel + plain version.

Replaces the reference's TPU kernel ``pallas/tridiag_kernel.py``
(``solve_lanes`` → ``_kernel``) with ``csrc/tridiag.cu``: a group of
``_group.group_size(s)`` CUDA threads per instance (16 below s=16, a warp from
s=16) runs the forward block-Thomas sweep
with a row-parallel pivot-free Gauss-Jordan inverse per slot and the backward
sweep, lane i a row of every block (``csrc/tridiag.cuh``). The TPU kernel's
lane-tile padding does not carry over: the ragged edge is masked in the
kernel.

What bounds it on an H100: bytes (about 5k floating-point operations per
slot against 2·s² + 2·s values moved, ``kernels/_work.py``) — and, below a
few tens of thousands of instances, the serial dependency chain of one
instance. On the group each product of that chain is s dependent
multiply-adds instead of s², and B=1024 instances are 512 warps instead of
32. The factorization chain sits in the block's shared memory
(``_group.tridiag_geometry``: threads and instances per block, dynamic shared
bytes; a block the card cannot take raises before a launch, a launch it
refuses raises with its CUDA error).

On the lanes fleet path this kernel runs once per replay: the tick-0 init
solve of ``mhe_replay_kernel.replay``. The state size is a template
parameter: s=9 (Go1, PogoX), s=15 (Cassie) and s=21 (Go1 with its foot
positions as states, a warp per instance; ``_build.SOLVE_SIZES``).

``solve_batched`` is the reference's standard-layout route
(``pallas/tridiag_kernel.py`` ``solve_batched``): the drop-in for
``ops.tridiag.solve`` on (K, B, s, s) operands that ``ops.mhe.solve_window``
takes every tick of the standard-layout fleet runner
(``parallel.batch.make_fused_batched_runner(use_pallas=True)``). The same
kernel reads that layout, through any strides, and the (K, B) warm-up mask
itself — a dead slot
loads as an identity block with zero coupling and right-hand side, the values
of ``ops.tridiag.mask_system`` — and writes x in (K, B, s): one launch, no
PyTorch pass around it (the reference's XLA glue masks and moves B to the
minor axis and back).
"""

from __future__ import annotations

import ctypes

import torch

from decentralized_ekf_mhe_tpu_torch.kernels import _build, _group
from decentralized_ekf_mhe_tpu_torch.ops import lanes, tridiag
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device

launches = 0     # incremented where the CUDA kernel is launched, nowhere else
launches_batched = 0   # launches made by the standard-layout route (solve_batched)


def solve_lanes_plain(D, U, r):
    """Plain PyTorch version: ``ops.lanes.thomas_solve``."""
    return lanes.thomas_solve(D, U, r)


def solve_lanes(D, U, r, device="cuda"):
    """Solve with instance-on-lanes operands.

    Args:
      D: (N, s, s, B) diagonal blocks (already warmup-masked).
      U: (N-1, s, s, B) couplings.
      r: (N, s, B) right-hand side.
    Returns x: (N, s, B). CPU tensors (``device="cpu"``) take the plain
    version; CUDA tensors launch the kernel or raise.
    """
    device = resolve_device(device)
    if D.ndim != 4:
        raise ValueError(f"D: expected (N,s,s,B), got {tuple(D.shape)}")
    N, s, _, B = D.shape
    if D.device.type != device.type:
        raise ValueError(f"D: on {D.device}, expected {device}")
    if D.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"D: dtype {D.dtype} not supported")
    dev = D.device
    _build.require_lanes("D", D, (N, s, s, B), D.dtype, dev)
    _build.require_lanes("U", U, (N - 1, s, s, B), D.dtype, dev)
    _build.require_lanes("r", r, (N, s, B), D.dtype, dev)
    if dev.type == "cpu":
        return solve_lanes_plain(D, U, r)
    return _launch(D, U, r)


def solve_batched_plain(D, U, r, valid=None):
    """Plain PyTorch version of the standard-layout route: ``ops.tridiag.solve``
    (the same masking and layout moves around ``ops.lanes.thomas_solve``)."""
    return tridiag.solve(D, U, r, valid)


def solve_batched(D, U, r, valid=None, device="cuda"):
    """Drop-in for ``ops.tridiag.solve`` on standard-layout operands with one
    batch axis.

    Args:
      D: (K, B, s, s) diagonal blocks.
      U: (K-1, B, s, s) couplings.
      r: (K, B, s) right-hand side.
      valid: optional (K, B) bool mask of live slots.
    Returns x: (K, B, s). Dead slots solve as identity blocks with zero
    coupling and right-hand side (``ops.tridiag.mask_system``'s values). CPU
    tensors (``device="cpu"``) take the plain version; CUDA tensors launch
    the kernel, which reads this layout and the mask itself, or raise.
    """
    global launches_batched
    device = resolve_device(device)
    if D.ndim != 4:
        raise ValueError(f"D: expected (K,B,s,s), got {tuple(D.shape)}")
    K, B, s, _ = D.shape
    if D.device.type != device.type:
        raise ValueError(f"D: on {D.device}, expected {device}")
    if D.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"D: dtype {D.dtype} not supported")
    dev = D.device
    for name, t, shape in (("D", D, (K, B, s, s)), ("U", U, (K - 1, B, s, s)),
                           ("r", r, (K, B, s))):
        if t.device != dev or t.dtype != D.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape} {D.dtype} on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if valid is not None and (valid.device != dev or valid.dtype != torch.bool
                              or tuple(valid.shape) != (K, B)):
        raise ValueError(f"valid: expected ({K}, {B}) bool on {dev}, got "
                         f"{tuple(valid.shape)} {valid.dtype} on {valid.device}")
    if dev.type == "cpu":
        return solve_batched_plain(D, U, r, valid)
    x = _launch(D, U, r, valid, standard=True)
    launches_batched += 1
    return x


def geometry(s, dtype, block=None, N=20):
    """The launch of ``tridiag_solve`` (either route):
    ``_group.tridiag_geometry``; raises ``ValueError`` for a block the card
    cannot take."""
    return _group.tridiag_geometry(s, dtype, block, N)


def occupancy(s, dtype, block=None, N=20, standard=False):
    """The launch's geometry as the card reports it (``dem_tridiag_geometry``,
    on the current device): instances and threads per block, dynamic shared
    bytes, blocks resident per SM, registers and local bytes per thread.
    Raises as a launch would."""
    g = geometry(s, dtype, block, N)
    fn = _build.entry(_build.solve_library("tridiag", s), "dem_tridiag_geometry",
                      [ctypes.c_int] * 5 + [ctypes.c_void_p])
    out = (ctypes.c_int * 6)()
    _build.check_launch(fn(int(dtype == torch.float64), s, int(standard), N,
                           g.threads_per_block, ctypes.cast(out, ctypes.c_void_p)),
                        "tridiag_solve geometry")
    return _group.card_figures(out)


def _launch(D, U, r, valid=None, standard=False):
    """Allocate the output, launch ``dem_tridiag_solve`` on the current
    stream on the lanes layout (D (N,s,s,B)) or, ``standard``, the standard
    layout (D (K,B,s,s), U, r read in place through their strides) with its
    mask ``valid``, with ``geometry``'s threads per block; count the launch."""
    global launches
    if standard:
        N, B, s, _ = D.shape
        x = torch.empty((N, B, s), dtype=D.dtype, device=D.device)
    else:
        N, s, _, B = D.shape
        x = torch.empty((N, s, B), dtype=D.dtype, device=D.device)
    g = geometry(s, D.dtype, N=N)
    fn = _build.load(_build.solve_library("tridiag", s))
    ptr = lambda t: None if t is None else t.data_ptr()
    strides = (ctypes.c_longlong * 13)(*(
        [*D.stride(), *U.stride(), *r.stride(), *(valid.stride() if valid is not None else (0, 0))]
        if standard else [0] * 13))
    with torch.cuda.device(D.device):
        err = fn(int(D.dtype == torch.float64), s, int(standard), ptr(D), ptr(U), ptr(r),
                 ptr(valid), strides, ptr(x), N, B, g.threads_per_block,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "tridiag_solve")
    launches += 1
    return x
