"""One whole box-ADMM solve per call: hand-written CUDA kernel + plain version.

Replaces the reference's TPU kernel ``pallas/admm_kernel.py``
(``solve_box_lanes`` → ``_solve_padded`` → ``_make_kernel``) with
``csrc/admm.cu``, whose body is ``admm_solve_group`` of
``csrc/admm_group.cuh``: the constrained ``mhe_tick`` kernel's window solve
(``admm_box_solve_group``, the port of ``pallas/admm_core.py::admm_box_solve``)
with its warm starts read in slot order. A group of ``_group.group_size(s)``
CUDA threads per instance (16 below s=16, a warp from s=16) runs the ρ-epoch factorizations, the α-relaxed projection
iterations, the converged-freeze, the adaptive-ρ updates and the active-set
polish on operands in the instance-minor lanes layout; lane i owns row i of
every block.

What the TPU kernel keeps in its on-chip memory (the factorization chain,
the iterates and the sweep vectors: about 6k scalars per instance at N=20,
s=9) sits in the block's shared memory for the whole solve, and U_j with
them at s=9 (``_group.box_geometry``: threads and instances per block,
dynamic shared bytes; a block the card cannot take raises before a launch,
and a launch it refuses raises with its CUDA error). A converged instance
stops iterating instead of computing masked updates: a frozen instance
changes nothing, ρ included, so the results are the same, and ``iters`` says
what each instance ran. What bounds it on an H100: operations
(``kernels/_work.py``), in practice the serial chain of one instance. The
TPU wrapper's pad to a lane tile does not carry over: the ragged edge is
masked in the kernel.

ADMM settings are runtime values, so every budget shares one binary; only the
state size is a template parameter: s=9 (Go1, PogoX), s=15 (Cassie) and s=21
(Go1 with its foot positions as states; the foot-position states usually carry
±inf bounds: they pass the clip unchanged and the polish never pins them).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from decentralized_ekf_mhe_tpu_torch.kernels import _build, _group
from decentralized_ekf_mhe_tpu_torch.ops import admm
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device

launches = 0     # incremented where the CUDA kernel is launched, nowhere else
# launches of any kernel that runs the box-ADMM solve (K3, admm_box_solve_group
# of csrc/admm_group.cuh on a group of threads per instance): this module's
# admm_solve and the constrained mhe_tick (kernels/mhe_replay_kernel)
launches_core = 0
timer = _build.KernelTimer()   # times the kernel call alone


class ADMMCoreStatic(NamedTuple):
    """The ADMM constants the kernels take (ops.admm.ADMMSettings minus the
    bounds, which are per-lane operands)."""

    N: int
    s: int
    rho0: float
    sigma: float
    alpha: float
    iters: int
    E: int                 # rho_update_every
    adaptive: bool
    abs_tol: float
    rel_tol: float
    polish: bool
    polish_penalty: float

    @classmethod
    def from_settings(cls, st, N: int, s: int) -> "ADMMCoreStatic":
        return cls(
            N=int(N), s=int(s), rho0=float(st.rho), sigma=float(st.sigma),
            alpha=float(st.alpha), iters=int(st.iters),
            E=max(1, int(st.rho_update_every)),
            adaptive=bool(st.adaptive_rho),
            abs_tol=float(st.abs_tol), rel_tol=float(st.rel_tol),
            polish=bool(st.polish),
            polish_penalty=float(st.polish_penalty),
        )

    def pack(self):
        """(int32[5], float64[7]) as ``csrc/admm.cuh::admm_settings`` reads
        them: iters, E, adaptive, check, polish; rho0, sigma, alpha, 1−alpha,
        abs_tol, rel_tol, polish_penalty."""
        check = self.abs_tol > 0.0 or self.rel_tol > 0.0
        ints = np.array([self.iters, self.E, self.adaptive, check, self.polish],
                        np.int32)
        reals = np.array([self.rho0, self.sigma, self.alpha, 1 - self.alpha,
                          self.abs_tol, self.rel_tol, self.polish_penalty],
                         np.float64)
        return ints, reals


def solve_box_lanes_plain(D, U, r, lb, ub, settings, valid=None, z0=None,
                          y0=None):
    """Plain PyTorch version: ``ops.admm.solve_box_tridiag_lanes``."""
    return admm.solve_box_tridiag_lanes(D, U, r, lb, ub, settings,
                                        valid=valid, z0=z0, y0=y0)


def solve_box_lanes(D, U, r, lb, ub, settings, valid=None, z0=None, y0=None,
                    device="cuda"):
    """Box-constrained block-tridiagonal solve with instance-on-lanes operands.

    Args:
      D: (N, s, s, B) diagonal blocks; U: (N-1, s, s, B); r: (N, s, B).
      lb, ub: (s,) shared or (s, B) per-lane bounds (±inf ⇒ unconstrained).
      settings: ops.admm.ADMMSettings.
      valid: optional shared (N,) warm-up mask (dead slots become identity
        blocks with zero coupling and right-hand side).
      z0, y0: optional (N, s, B) warm-start iterates (default zeros).
    Returns ops.admm.ADMMResult; the final residuals are computed outside the
    kernel. CPU tensors (``device="cpu"``) take the plain version; CUDA
    tensors launch the kernel or raise.
    """
    device = resolve_device(device)
    if D.ndim != 4:
        raise ValueError(f"D: expected (N,s,s,B), got {tuple(D.shape)}")
    N, s, _, B = D.shape
    if D.device.type != device.type:
        raise ValueError(f"D: on {D.device}, expected {device}")
    if D.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"D: dtype {D.dtype} not supported")
    dev, dtype = D.device, D.dtype
    _build.require_lanes("D", D, (N, s, s, B), dtype, dev)
    _build.require_lanes("U", U, (N - 1, s, s, B), dtype, dev)
    _build.require_lanes("r", r, (N, s, B), dtype, dev)
    for name, a in (("z0", z0), ("y0", y0)):
        if a is not None:
            _build.require_lanes(name, a, (N, s, B), dtype, dev)
    if valid is not None and (tuple(valid.shape) != (N,) or valid.device != dev):
        raise ValueError(f"valid: expected shared (N,)=({N},) on {dev}")
    lb_l, ub_l = admm.broadcast_bounds(lb, ub, s, B, dtype, dev)
    if dev.type == "cpu":
        return solve_box_lanes_plain(D, U, r, lb_l, ub_l, settings,
                                     valid=valid, z0=z0, y0=y0)
    if valid is not None:
        D, U, r = (a.contiguous() for a in admm.mask_system(D, U, r, valid))
    x, z, y, iters = _launch(D, U, r, lb_l, ub_l, z0, y0,
                             ADMMCoreStatic.from_settings(settings, N, s))
    prim, dual = admm.final_residuals(D, U, r, x, z, y)
    return admm.ADMMResult(x, z, y, prim, dual, iters)


def geometry(s, dtype, block=None, N=20):
    """The launch of ``admm_solve``: ``_group.box_geometry`` (threads and
    instances per block, dynamic shared bytes); raises ``ValueError`` for a
    block the card cannot take."""
    return _group.box_geometry(s, dtype, block, N, what="box-ADMM solve")


def occupancy(s, dtype, block=None, N=20):
    """The launch's geometry as the card reports it (``dem_admm_geometry``, on
    the current device): instances and threads per block, dynamic shared
    bytes, blocks resident per SM, registers and local bytes per thread,
    whether U_j sits in shared memory. Raises as a launch would."""
    block = geometry(s, dtype, block, N).threads_per_block
    fn = _build.entry(_build.solve_library("admm", s), "dem_admm_geometry",
                      [ctypes.c_int] * 4 + [ctypes.c_void_p])
    out = (ctypes.c_int * 7)()
    _build.check_launch(fn(int(dtype == torch.float64), s, N, block,
                           ctypes.cast(out, ctypes.c_void_p)), "admm_solve geometry")
    return _group.card_figures(out, "u_shared")


def _launch(D, U, r, lb, ub, z0, y0, static: ADMMCoreStatic):
    """Allocate the outputs, launch ``dem_admm_solve`` on the current stream
    (``geometry``'s threads per block), count the launch.
    The kernel updates z and y in place, so they start as copies of the warm
    starts."""
    global launches, launches_core
    N, s, _, B = D.shape
    dev, dtype = D.device, D.dtype
    block = geometry(s, dtype, N=N).threads_per_block
    fn = _build.load(_build.solve_library("admm", s))
    x = torch.empty((N, s, B), dtype=dtype, device=dev)
    z = torch.zeros_like(r) if z0 is None else z0.clone()
    y = torch.zeros_like(r) if y0 is None else y0.clone()
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    tensors = [D, U, r, lb, ub, x, z, y, iters]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    ints, reals = static.pack()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream()
        timer.record(stream)
        err = fn(int(dtype == torch.float64), s, ptrs, len(tensors),
                 ints.ctypes.data, reals.ctypes.data, N, B, block,
                 stream.cuda_stream)
        timer.record(stream)
    _build.check_launch(err, "admm_solve")
    launches += 1
    launches_core += 1
    return x, z, y, iters
