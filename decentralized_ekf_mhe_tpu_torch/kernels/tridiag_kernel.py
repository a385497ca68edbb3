"""Batched block-tridiagonal solve: hand-written CUDA kernel + plain version.

Replaces the reference's TPU kernel ``pallas/tridiag_kernel.py``
(``solve_lanes`` → ``_kernel``) with ``csrc/tridiag.cu``: one CUDA thread per
instance runs the forward block-Thomas sweep with a pivot-free Gauss-Jordan
inverse per slot and the backward sweep, on operands in the instance-minor
lanes layout, so a warp's loads are coalesced. The TPU kernel's lane-tile
padding does not carry over: the ragged edge is masked in the kernel.

What bounds it on an H100: bytes (about 5k floating-point operations per
slot against 2·s² + 2·s values moved, ``kernels/_work.py``) — and, below a
few tens of thousands of instances, the serial dependency chain of one
instance, because B instances fill only B/32 warps. The design does nothing about that yet (several threads
per instance and shared-memory staging are later work); it is the simple
version that is right.

On the lanes fleet path this kernel runs once per replay: the tick-0 init
solve of ``mhe_replay_kernel.replay``. The state size is a template
parameter: s=9 (Go1, PogoX) and s=15 (Cassie).

``solve_batched`` is the reference's standard-layout route
(``pallas/tridiag_kernel.py`` ``solve_batched``): the drop-in for
``ops.tridiag.solve`` on (K, B, s, s) operands that ``ops.mhe.solve_window``
takes every tick of the standard-layout fleet runner
(``parallel.batch.make_fused_batched_runner(use_pallas=True)``). It masks the
warm-up slots, moves B to the minor axis, launches the same kernel and moves
the result back; the masking and the two moves are plain PyTorch, as they are
XLA glue around the reference's kernel.
"""

from __future__ import annotations

import torch

from decentralized_ekf_mhe_tpu_torch.kernels import _build
from decentralized_ekf_mhe_tpu_torch.ops import lanes, tridiag
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device

BLOCK = 32       # threads per block: one warp, so a small fleet spreads over SMs
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
    Returns x: (K, B, s). Dead slots become identity blocks with zero
    coupling and right-hand side (``ops.tridiag.mask_system``), B moves to
    the minor axis, the kernel solves, and B moves back. The kernel masks the
    ragged edge of the last block itself, so B needs no padding. CPU tensors
    (``device="cpu"``) take the plain version; CUDA tensors launch the kernel
    or raise.
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
    D, U, r = tridiag.mask_system(D, U, r, valid)
    x = _launch(*(torch.movedim(a, 1, -1).contiguous() for a in (D, U, r)))
    launches_batched += 1
    return torch.movedim(x, -1, 1)


def _launch(D, U, r):
    """Allocate output and scratch, launch ``dem_tridiag_solve`` on the
    current stream, count the launch."""
    global launches
    N, s, _, B = D.shape
    dev = D.device
    fn = _build.load(_build.solve_library("tridiag", s))
    x = torch.empty((N, s, B), dtype=D.dtype, device=dev)
    Sinv_ws = torch.empty((N, s, s, B), dtype=D.dtype, device=dev)
    y_ws = torch.empty((N, s, B), dtype=D.dtype, device=dev)
    with torch.cuda.device(dev):
        err = fn(int(D.dtype == torch.float64), s, D.data_ptr(), U.data_ptr(),
                 r.data_ptr(), x.data_ptr(), Sinv_ws.data_ptr(),
                 y_ws.data_ptr(), N, B, BLOCK,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "tridiag_solve")
    launches += 1
    return x
