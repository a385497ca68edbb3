"""The MHE replay loop: hand-written CUDA kernel + plain version.

Replaces the reference's TPU mega-kernel ``pallas/mhe_replay_kernel.py``
(``replay`` → ``_replay_chunk`` → ``_make_kernel``) with ``csrc/mhe_body.cuh``
(C entry points in ``csrc/mhe.cu``): one CUDA thread, or a group of 16, per
instance loops over the ticks handed to it, each tick being VO ingestion +
Bezier carry, arrival-cost marginalization, ring shift + assembly of the two
changed slots, the incremental ``Dslot/Ub/routb`` cache update, and the masked
normal equations with a streaming forward block-Thomas sweep.

Design on an H100 (details in ``csrc/mhe_body.cuh``): parallelism is the
instance axis only; time is a loop inside ONE launch per ``replay_ticks`` call
(the TPU wrapper's chunking and its 128-instance tiles do not carry over — any
B works, the ragged edge is masked in the kernel); the ~10.3k scalars of
window state per instance stay in global memory in the instance-minor layout
(coalesced; L2-resident at B=1024 in float32), addressed by the physical ring
slot. What bounds it: operations, and in practice the serial dependency chain
of one instance with B/32 warps in flight (and at s=15 the s×s temporaries
spilling to local memory). So the unconstrained tick, with either tail at
every shape (``tick_group``), runs ``BOX_G`` = 16 threads per instance
instead: lane 0 ingests the VO, the 3×3 blocks of the two changed slots are
built on lane 0 or (the velocity form: Go1, PogoX) one lane per leg, the group
the marginalization, the shift with its cache update and the streaming sweep, each
lane a row of every s×s block (with the Cholesky tail: a column of L⁻¹U_prev,
then a row of the factor), with the blocks that a product reads whole in
shared memory (``tick_geometry``: threads and instances per block, dynamic
shared bytes; ``tick_occupancy``: what the card keeps resident). No switch
restores the one-thread body.

With state box constraints in the consts (``c.x_lb``) the constrained variant
of the same kernel runs (the TPU kernel with ``admm_ks`` set): the assembly
loop writes the whole masked window system to per-launch scratch in global
memory instead of streaming the Thomas sweep, the box-ADMM solves it, and the
warm-start iterates ``z_adm``/``y_adm`` ride two more ring-indexed state
tensors. That kernel runs ``BOX_G`` = 16 threads per instance
(``csrc/admm_group.cuh``): lane 0 of each group runs the tick's one-thread
statements up to the assembled system, then the group solves the window with
the factorization chain, the iterates and the sweep vectors in shared memory
(``box_geometry``: threads and instances per block, dynamic shared bytes).
The scratch (the masked system, about 3.8k scalars per instance at s=9) is
allocated by the wrapper and is not part of ``KernelState``. The ADMM
iterations each instance ran per tick come back as ``KernelState.iters``.

A per-instance ``VOData`` (active, tick_pre, tick_now (T,B): a camera clock
per lane) runs the per-instance variant of either kernel (the TPU kernel with
``per_instance=True``): each thread ingests its own lane's VO events and keeps
its own Bezier schedule, which ``KernelState`` then carries per lane
((4,B) times, (1,B) counts). Everything after the ingestion is the same code.

The tail of the window solve is the Gauss-Jordan chain (``mk_solve="gj"``,
the default) or the Cholesky factor-and-substitute chain (``"chol"``, the TPU
kernel's ``mk_solve='chol'``; ``csrc/mhe_body.cuh``, ``CHOL``). As in the
reference, ``replay`` reads the tail from the environment variable
``DEM_MK_SOLVE`` at each call when ``mk_solve`` is None, so the fleet runners,
which never name it, run whichever the environment asks for. Unlike the
reference, a value other than "gj" or "chol" raises ``ValueError`` instead of
running GJ. The two tails return the same newest state of the same window, so
the plain version of either is the same ``mhe_lanes.step`` loop (but for the
stage ablation, below). The box kernels ignore the tail: their window solve is
the ADMM.

Every model shape the reference runs has its own instantiations, in one
library per variant group, each built at its first use (``_build.MHE_SHAPES``,
``_build.MHE_GROUPS``): Go1 (s=9, m=12, L=4, leg_odom_type=0), Cassie (15, 6,
2, 1: foot positions as states) and PogoX (9, 3, 1, 0), each with the shared
camera clock, a clock per lane, and the Cholesky tail on either clock.

The stage ablation (``ablate=``, the TPU kernel's ``ablate``; a timing
diagnostic that ``tools/roofline.py --ablate`` drives) runs the tick with one
stage skipped — "ingest", "marg", "build", "assembly" or "solve"
(``csrc/mhe_body.cuh``, ``ABL``) — so that the time it saves is that stage's
share; its output is wrong by construction. It composes with everything the
tick does, as the TPU kernel's does: every shape, either clock, either tail,
box consts (in the constrained tick's one-thread prelude; "assembly" runs no
ADMM, and there is no "solve" stage: ``ValueError``, as the reference's
constrained loop never reaches the sum that stage returns). The Cholesky
tick's "assembly" and "solve" stages never reach the tail, so they run the
Gauss-Jordan tick's units (``_build.TAIL_FREE_STAGES``). Its plain version
skips the same stages on the logical window (``_step_ablated``), with the
Cholesky tail its own factor-and-substitute sweep (``_chol_sweep``: where
the ablated window is singular the two tails break down in different
places).

State contract: ``KernelState`` carries the window tensors in PHYSICAL ring
order together with the tick counter ``t`` (newest tick in the window), so a
log split over two ``replay_ticks`` calls equals one call.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from decentralized_ekf_mhe_tpu_torch.kernels import _build, admm_kernel
from decentralized_ekf_mhe_tpu_torch.kernels.admm_kernel import ADMMCoreStatic
from decentralized_ekf_mhe_tpu_torch.ops import admm, bezier, lanes, mhe_lanes
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device

# the constrained tick: threads per instance (csrc/admm_group.cuh's BOX_G), and
# its threads per block unless the caller names ``block``: eight instances, the
# fastest of 2, 4, 5 and 8 at Go1's and Cassie's shapes in float32 in the sweep
# of tools/roofline.py --box-layouts on the card (PERF.md §5), or as many as
# fit a block's shared memory where eight do not (float64)
BOX_G = 16
BLOCK_BOX = 128
# the unconstrained tick where ``tick_group`` holds (the Gauss-Jordan tail at
# every shape, the Cholesky tail above s=9) runs BOX_G threads per instance
# too; its threads per block unless the caller names ``block``
BLOCK_TICK = 128
# what one block may use of an SM's shared memory, and what an SM has for its
# blocks, each of which reserves 1 KB more (H100: 227 KB and 228 KB)
SHARED_PER_BLOCK, SHARED_PER_SM, SHARED_RESERVED_PER_BLOCK = 232448, 233472, 1024
MK_SOLVES = ("gj", "chol")     # the tails of the window solve
ABLATE_STAGES = _build.ABLATE_STAGES
# the variants of the ablated units, as csrc/mhe.cu's symbols name them: the
# Gauss-Jordan tick ("", "pi": on a clock per lane), the Cholesky tick
# ("chol", "pi_chol") and the constrained one ("box", "pi_box")
ABLATE_VARIANTS = ("", "pi", "chol", "pi_chol", "box", "pi_box")

# incremented where a CUDA kernel is launched, nowhere else: one count per
# kernel — the unconstrained tick (mhe_kernel), the constrained one
# (mhe_box_kernel), their per-lane-clock variants (mhe_pi_kernel,
# mhe_pi_box_kernel), the unconstrained tick with the Cholesky tail
# (mhe_chol_kernel, mhe_pi_chol_kernel) and the stage ablation (mhe_abl_kernel,
# mhe_pi_abl_kernel, mhe_chol_abl_kernel, mhe_box_abl_kernel: one count per
# variant of ABLATE_VARIANTS and stage)
launches = 0
launches_box = 0
launches_pi = 0
launches_pi_box = 0
launches_chol = 0
launches_pi_chol = 0
launches_abl = {v: dict.fromkeys(ABLATE_STAGES, 0) for v in ABLATE_VARIANTS}
# (constrained, per-lane clock, Cholesky tail) -> counter
_COUNTER = {(False, False, False): "launches", (True, False, False): "launches_box",
            (False, True, False): "launches_pi", (True, True, False): "launches_pi_box",
            (False, False, True): "launches_chol", (False, True, True): "launches_pi_chol"}

# times the kernel call alone, apart from the wrapper's state copy
timer = _build.KernelTimer()

# positions of the ring-indexed tensors (leading axis N) in KernelState.arrays;
# the constrained state appends z_adm, y_adm at 18, 19
_RING = (0, 1, 2, 3, 4, 5, 6, 7, 15, 16, 17)
_RING_BOX = _RING + (18, 19)


class KernelConsts(NamedTuple):
    """Host (numpy) constants handed to the kernel by value."""

    N: int
    s: int
    m: int
    L: int
    lot: int              # leg_odom_type
    dt: float
    A_meas: np.ndarray    # (m,s)
    P_cam: np.ndarray     # (3,s)
    Q_vo_p: np.ndarray    # (3,3)
    C_p: np.ndarray
    C_accel: np.ndarray
    Q_accel_bias: np.ndarray
    C_enc_pos: np.ndarray
    C_enc_vel: np.ndarray
    C_gyro: np.ndarray
    Q_foot_swing: np.ndarray
    gravity: np.ndarray   # (3,)
    Q_foot_slide: np.ndarray   # foot-state noise in contact (leg_odom_type 1)


def consts_from_mhe(c) -> KernelConsts:
    """Extract the numpy constants the kernel needs from ops.mhe.MHEConsts
    (one small device-to-host copy per call when the consts live on CUDA)."""
    nc = c.nc
    f = lambda a: a.detach().to("cpu", torch.float64).numpy()
    return KernelConsts(
        N=int(c.N), s=int(c.dim_state), m=int(c.dim_meas),
        L=int(c.num_legs), lot=int(c.leg_odom_type), dt=float(c.dt),
        A_meas=f(c.A_meas), P_cam=f(c.P_cam), Q_vo_p=f(c.Q_vo_p),
        C_p=f(nc.C_p), C_accel=f(nc.C_accel),
        Q_accel_bias=f(nc.Q_accel_bias), C_enc_pos=f(nc.C_enc_pos),
        C_enc_vel=f(nc.C_enc_vel), C_gyro=f(nc.C_gyro),
        Q_foot_swing=f(nc.Q_foot_swing),
        gravity=f(nc.gravity),
        Q_foot_slide=f(nc.Q_foot_slide),
    )


def _pack_consts(kc: KernelConsts) -> np.ndarray:
    """The constants in the order of ``MheConsts`` (csrc/mhe_body.cuh)."""
    return np.concatenate([
        [kc.dt], kc.A_meas.ravel(), kc.P_cam.ravel(), kc.Q_vo_p.ravel(),
        kc.C_p.ravel(), kc.C_accel.ravel(), kc.Q_accel_bias.ravel(),
        kc.C_enc_pos.ravel(), kc.C_enc_vel.ravel(), kc.C_gyro.ravel(),
        kc.Q_foot_swing.ravel(), kc.gravity.ravel(), kc.Q_foot_slide.ravel(),
    ]).astype(np.float64)


def ablate_variant(constrained, per_lane_clock, mk_solve, ablate):
    """The variant (``ABLATE_VARIANTS``) of the unit that runs stage
    ``ablate``: the Cholesky tick's tail-free stages run the Gauss-Jordan
    tick's unit, and the box kernels ignore the tail."""
    chol = mk_solve == "chol" and not constrained and ablate not in _build.TAIL_FREE_STAGES
    return "_".join(w for w, on in (("pi", per_lane_clock), ("box", constrained),
                                     ("chol", chol)) if on)


def kernel_library(s, m, L, lot, per_lane_clock, chol=False, ablate="", constrained=False,
                   double=True):
    """The library (``_build.UNITS``) whose kernels tick this shape and clock,
    with the Cholesky tail if ``chol`` (unconstrained ticks only: the box
    kernels ignore the tail), or with stage ``ablate`` skipped (of the
    constrained tick if ``constrained``; a library per type, float64 if
    ``double``); raises ``NotImplementedError`` for a shape outside
    ``_build.MHE_SHAPES``, which the CUDA build does not instantiate."""
    lib = _build.mhe_library(s, m, L, lot)
    if lib is None:
        raise NotImplementedError(
            f"mhe_tick: no CUDA instantiation for s={s}, m={m}, L={L}, "
            f"leg_odom_type={lot} (shapes: {sorted(_build.MHE_SHAPES)})")
    if ablate:
        variant = ablate_variant(constrained, per_lane_clock, "chol" if chol else "gj", ablate)
        group = "abl" + ("_" + variant if variant else "")
        return _build.mhe_library(s, m, L, lot, f"{group}_{'f64' if double else 'f32'}")
    return _build.mhe_library(s, m, L, lot, "chol" if chol else "pi" if per_lane_clock else "")


def check_mk_solve(mk_solve):
    """Raise ``ValueError`` for a tail that does not exist (the reference runs
    Gauss-Jordan there without a word)."""
    if mk_solve not in MK_SOLVES:
        raise ValueError(f"mk_solve / DEM_MK_SOLVE: {mk_solve!r} is not one of {MK_SOLVES}")


def check_ablate(c, ablate, per_lane_clock, mk_solve):
    """Raise ``ValueError`` for a stage that does not exist, and for the
    "solve" stage with box consts, which the reference does not define (its
    constrained loop collects the window for the ADMM before the stage's sum,
    which it then never sets: the TPU kernel fails to trace there);
    ``NotImplementedError`` for a shape without an instantiation.
    ``ablate=""`` runs the whole tick."""
    if not ablate:
        return
    if ablate not in ABLATE_STAGES:
        raise ValueError(f"ablate: {ablate!r} is not one of {ABLATE_STAGES} (or '')")
    if ablate == "solve" and c.x_lb is not None:
        raise ValueError(
            "ablate='solve' with box consts: the reference defines no such stage (its "
            "constrained loop hands the window to the ADMM before the stage's sum and "
            "never sets it)")
    kernel_library(c.dim_state, c.dim_meas, c.num_legs, int(c.leg_odom_type), per_lane_clock,
                   mk_solve == "chol", ablate, c.x_lb is not None)


def _check_block(block):
    """Threads per block of a launch: 1..1024."""
    block = int(block)
    if not 1 <= block <= 1024:
        raise ValueError(f"block: {block} threads per block, expected 1..1024")
    return block


def box_u_shared(s):
    """Whether the constrained tick keeps U_j in shared memory (layout (b)) at
    state size s, as ``csrc/admm_group.cuh``'s ``box_u_shared`` decides: at
    s=9; at s=15 it reads U_j from the assembly's scratch (layout (a))."""
    return s <= 9


class BoxGeometry(NamedTuple):
    """The launch of the constrained tick (``box_geometry``)."""

    instances_per_block: int
    threads_per_block: int
    shared_bytes: int           # dynamic shared memory of one block
    u_shared: bool              # U_j in shared memory (layout (b))
    instances_per_sm: int       # as far as shared memory, threads and blocks allow


def _group_launch(scalars, dtype, block, what):
    """(instances per block, threads per block, shared bytes of a block,
    instances per SM as far as shared memory, threads and blocks allow) of a
    launch of ``block`` threads, ``BOX_G`` per instance, each instance with
    ``scalars`` of shared memory padded to 16 mod 32 four-byte words (so that
    the two groups of a warp use different banks). Raises ``ValueError`` for
    a block that is no multiple of ``BOX_G`` in 16..1024 or whose shared
    memory exceeds what a block may use."""
    item = torch.empty((), dtype=dtype).element_size()
    words = scalars * item // 4
    one = (words + (16 - words % 32) % 32) * 4      # bytes of one instance
    if block is None:
        block = min(BLOCK_BOX, BOX_G * (SHARED_PER_BLOCK // one))
    block = _check_block(block)
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


def box_shared_scalars(s, N, u_shared):
    """Scalars of one instance's shared memory (``BoxLayout``): Sinv N s², U
    (N−1) s² in layout (b), x, z, y, the sweep vectors and r 5 N s, 6 s of
    broadcast buffers."""
    return N * s * s + (N - 1) * s * s * int(u_shared) + 5 * N * s + 6 * s


def box_geometry(s, dtype, block=None, N=20):
    """The launch geometry of the constrained tick at state size ``s``, element
    type ``dtype``, ``block`` threads per block (default ``BLOCK_BOX``, capped
    to the instances whose shared memory fits a block) and ``N`` slots:
    ``BOX_G`` threads per instance, so ``block // BOX_G``
    instances per block, each with ``box_shared_scalars`` padded to 16 mod 32
    four-byte words (``BoxLayout::stride``, so that the two groups of a warp
    use different banks); U_j sits in shared memory where
    ``box_u_shared(s)``. Raises ``ValueError`` when ``block`` is not a
    multiple of ``BOX_G`` in 16..1024, when s > ``BOX_G``, or when the block's
    shared memory exceeds what a block may use (232,448 bytes)."""
    if s > BOX_G:
        raise ValueError(f"s={s}: the constrained tick runs at most {BOX_G} states")
    u_shared = box_u_shared(s)
    ipb, block, shared, per_sm = _group_launch(
        box_shared_scalars(s, N, u_shared), dtype, block, f"constrained tick (s={s}, N={N})")
    return BoxGeometry(ipb, block, shared, u_shared, per_sm)


def tick_group(s, mk_solve="gj"):
    """Whether the unconstrained tick with the tail ``mk_solve`` runs a group
    of ``BOX_G`` threads per instance at state size ``s``: with either tail
    (and its stage ablation) at every shape; only the constrained tick's
    prelude stays on one thread."""
    check_mk_solve(mk_solve)
    return True


class TickGeometry(NamedTuple):
    """The launch of the unconstrained group tick (``tick_geometry``)."""

    instances_per_block: int
    threads_per_block: int
    shared_bytes: int           # dynamic shared memory of one block
    instances_per_sm: int       # as far as shared memory, threads and blocks allow


def tick_shared_scalars(s, m):
    """Scalars of one instance's shared memory in the group tick
    (``TickLayout``): A_meas m s and P_cam 3 s, five matrix buffers of
    max(s², m²), four vectors of max(s, m) and the pivot buffers 4 s."""
    return m * s + 3 * s + 5 * max(s * s, m * m) + 4 * max(s, m) + 4 * s


def tick_geometry(s, m, dtype, block=None, mk_solve="gj"):
    """The launch geometry of the unconstrained tick with the tail
    ``mk_solve`` where it runs on a group (``tick_group``) at state size
    ``s``, ``m`` measurements, element type ``dtype`` and ``block`` threads
    per block (default ``BLOCK_TICK``): ``BOX_G`` threads per instance, so
    ``block // BOX_G`` instances per block, each with ``tick_shared_scalars``
    padded to 16 mod 32 four-byte words. Raises ``ValueError`` for a tail
    that does not exist, for a block that is no multiple of ``BOX_G`` in
    16..1024, or for more shared memory than a block may use."""
    check_mk_solve(mk_solve)
    return TickGeometry(*_group_launch(tick_shared_scalars(s, m), dtype,
                                       BLOCK_TICK if block is None else block,
                                       f"unconstrained tick (s={s}, m={m})"))


def _occupancy(c, dtype, constrained, per_lane_clock, block, chol=False):
    """A group launch's geometry as the card reports it (``dem_mhe_geometry``,
    on the current device), of the unit with the Cholesky tail if ``chol``."""
    lib = kernel_library(c.dim_state, c.dim_meas, c.num_legs, int(c.leg_odom_type),
                         per_lane_clock, chol)
    fn = _build.entry(lib, "dem_mhe_geometry", [ctypes.c_int] * 10 + [ctypes.c_void_p])
    out = (ctypes.c_int * 7)()
    err = fn(int(dtype == torch.float64), int(constrained), int(per_lane_clock), int(chol),
             c.dim_state, c.dim_meas, c.num_legs, int(c.leg_odom_type), c.N, block,
             ctypes.cast(out, ctypes.c_void_p))
    _build.check_launch(err, f"mhe_tick ({'constrained' if constrained else 'group'}) geometry")
    keys = ("instances_per_block", "threads_per_block", "shared_bytes", "blocks_per_sm",
            "registers_per_thread", "local_bytes_per_thread", "u_shared")
    res = dict(zip(keys, list(out)))
    res["instances_per_sm"] = res["blocks_per_sm"] * res["instances_per_block"]
    return res


def box_occupancy(c, dtype, per_lane_clock=False, block=None):
    """The constrained tick's geometry as the card reports it for the consts
    ``c`` (shape and N), through the library's C entry point
    (``dem_mhe_geometry``, on the current device): instances and threads
    per block, dynamic shared bytes, blocks resident per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and local
    bytes per thread, and whether U_j is in shared memory. Raises as a launch
    would."""
    if block is None:
        block = box_geometry(c.dim_state, dtype, None, c.N).threads_per_block
    res = _occupancy(c, dtype, True, per_lane_clock, block)
    res["u_shared"] = bool(res["u_shared"])
    return res


def tick_occupancy(c, dtype, per_lane_clock=False, block=None, mk_solve="gj"):
    """The same figures of the unconstrained group tick (``tick_group``) with
    the tail ``mk_solve`` for the consts ``c``, without ``u_shared``: those
    of the unit that runs."""
    check_mk_solve(mk_solve)
    if block is None:
        block = tick_geometry(c.dim_state, c.dim_meas, dtype, mk_solve=mk_solve).threads_per_block
    res = _occupancy(c, dtype, False, per_lane_clock, block, mk_solve == "chol")
    del res["u_shared"]
    return res


class KernelState(NamedTuple):
    """Window state as the kernel holds it between calls."""

    arrays: tuple             # the 18 (constrained: 20) tensors of state_shapes(), physical ring order
    bez_times: torch.Tensor   # (4,) shared or (4,B) per-lane Bezier waypoint times
    bez_count: torch.Tensor   # (1,) or (1,B) int32
    t: int                    # newest tick in the window
    # (Tn,B) int32 ADMM iterations per tick and instance of the call that
    # produced this state; None for an unconstrained or a fresh state
    iters: torch.Tensor | None = None


def state_shapes(N, s, m, L, constrained=False):
    """Per-instance shapes of ``KernelState.arrays`` (the instance axis B is
    appended): y_meas, Q_meas, A_dyn, b_dyn, Q_dyn, b_cam, Q_cam, cam_act,
    M_p, n_p, bez_pts, p_accum, prev_R, prev_accel_s, prev_contact, the
    incremental assembly caches Dslot, Ub, routb and, when constrained, the
    ADMM warm starts z_adm, y_adm."""
    shapes = [
        (N, m), (N, m, m), (N, s, s), (N, s), (N, s, s), (N, 3),
        (N, 3, 3), (N,), (s, s), (s,), (4, 3), (3,), (3, 3), (3,), (L,),
        (N, s, s), (N, s, s), (N, s),
    ]
    if constrained:
        shapes += [(N, s), (N, s)]
    return shapes


def _state_to_arrays(st: mhe_lanes.MHEStateL, c):
    """MHEStateL -> the 18 (constrained: 20) kernel tensors in LOGICAL slot order, including
    the incremental assembly caches, computed from whatever state is handed
    in (so resumed states work too):
        Dslot[p] = HᵀR_p H + A_pᵀQd_p A_p;  Ub[p] = −A_pᵀQd_p;
        routb[p] = HᵀR_p y_p + A_pᵀQd_p b_p
    """
    pts = torch.movedim(st.bez.pts, 0, -1)          # (B,4,3) -> (4,3,B)
    p_accum = torch.movedim(st.bez.p_accum, 0, -1)  # (B,3) -> (3,B)
    H = c.A_meas.to(st.y_meas.dtype)
    HtR = lanes.cmm_t(H, st.Q_meas)              # (N,s,m,B)
    AtQd = lanes.mm_tn(st.A_dyn, st.Q_dyn)       # (N,s,s,B)
    Dslot = lanes.mmc(HtR, H) + lanes.mm(AtQd, st.A_dyn)
    Ub = -AtQd
    routb = lanes.mv(HtR, st.y_meas) + lanes.mv(AtQd, st.b_dyn)
    base = (
        st.y_meas, st.Q_meas, st.A_dyn, st.b_dyn, st.Q_dyn, st.b_cam,
        st.Q_cam, st.cam_active.to(st.y_meas.dtype), st.M_p, st.n_p,
        pts, p_accum, st.prev_R, st.prev_accel_s, st.prev_contact,
        Dslot, Ub, routb,
    )
    if c.x_lb is not None:
        return base + (st.z_adm, st.y_adm)
    return base


def kernel_state_from_mhe(st: mhe_lanes.MHEStateL, c) -> KernelState:
    """Logical window -> physical ring order: logical slot l of the window
    whose newest tick is T sits at physical slot (T % N + l) % N."""
    base = int(st.T) % c.N
    arrays = list(_state_to_arrays(st, c))
    for k in (_RING_BOX if c.x_lb is not None else _RING):
        arrays[k] = torch.roll(arrays[k], base, dims=0)
    arrays = tuple(a.contiguous() for a in arrays)
    dtype = st.y_meas.dtype
    if st.bez.count.ndim:   # per-instance schedule: (B,4), (B,) -> (4,B), (1,B)
        times, count = st.bez.times.T, st.bez.count[None]
    else:
        times, count = st.bez.times, st.bez.count.reshape(1)
    return KernelState(
        arrays=arrays,
        bez_times=times.to(dtype).contiguous(),
        bez_count=count.to(torch.int32).contiguous(),
        t=int(st.T),
    )


def mhe_state_from_kernel(ks: KernelState, c) -> mhe_lanes.MHEStateL:
    """Inverse of ``kernel_state_from_mhe`` (the caches are dropped)."""
    base = ks.t % c.N
    a = list(ks.arrays)
    constrained = len(a) == 20
    for k in (_RING_BOX if constrained else _RING):
        a[k] = torch.roll(a[k], -base, dims=0)
    if ks.bez_count.ndim == 2:      # per-instance schedule
        times, count = ks.bez_times.T, ks.bez_count[0]
    else:
        times, count = ks.bez_times, ks.bez_count.reshape(())
    return mhe_lanes.MHEStateL(
        y_meas=a[0], Q_meas=a[1], A_dyn=a[2], b_dyn=a[3], Q_dyn=a[4],
        b_cam=a[5], Q_cam=a[6], cam_active=a[7] != 0, M_p=a[8], n_p=a[9],
        T=ks.t,
        bez=bezier.BezierCarry(
            pts=torch.movedim(a[10], -1, 0), times=times,
            count=count, p_accum=torch.movedim(a[11], -1, 0)),
        prev_R=a[12], prev_accel_s=a[13], prev_contact=a[14],
        z_adm=a[18] if constrained else (),
        y_adm=a[19] if constrained else (),
    )


def _chol(A):
    """The Cholesky factor of the (s,s,B) blocks A, statement by statement as
    the reference's ``pallas/tridiag_kernel.py`` ``_chol`` (its row loop
    taken at once): L (s,s,B), zero above the diagonal, and the reciprocal
    pivots rd (s,B). Each pivot is clamped at 1e-30 before its root (NaN
    passes)."""
    s = A.shape[0]
    L = torch.zeros_like(A)
    rd = torch.zeros_like(A[0])
    tiny = torch.tensor(1e-30, dtype=A.dtype, device=A.device)
    for k in range(s):
        d = A[k, k]
        for m in range(k):
            d = d - L[k, m] * L[k, m]
        d = torch.sqrt(torch.maximum(d, tiny))
        L[k, k] = d
        rd[k] = 1.0 / d
        e = A[k + 1:, k]
        for m in range(k):
            e = e - L[k + 1:, m] * L[k, m]
        L[k + 1:, k] = e * rd[k]
    return L, rd


def _trsm_l(L, rd, Bm):
    """X = L⁻¹ Bm for (s,n,B) Bm, row by row as the reference's ``_trsm_l``."""
    X = torch.empty_like(Bm)
    for i in range(L.shape[0]):
        acc = Bm[i]
        for m in range(i):
            acc = acc - L[i, m] * X[m]
        X[i] = acc * rd[i]
    return X


def _trsv_lt(L, rd, z):
    """x = L⁻ᵀ z for (s,B) z, from the last row up (the reference's
    ``_trsv_lt``)."""
    s = L.shape[0]
    x = torch.empty_like(z)
    for i in range(s - 1, -1, -1):
        acc = z[i]
        for m in range(i + 1, s):
            acc = acc - L[m, i] * x[m]
        x[i] = acc * rd[i]
    return x


def _chol_sweep(D, U, r):
    """x_{N-1} of masked window systems (D (N,s,s,K), U (N-1,s,s,K), r
    (N,s,K); K lanes) by the Cholesky tail's forward sweep (``mk_solve='chol'``,
    the reference's ``mhe_replay_kernel.py:743-772, 801-802``): the oldest
    block factored, then per slot W = L⁻¹U_prev, S_j = D_j − WᵀW (each
    element's sum over the rows of W in order), yv = r_j − Wᵀ(L⁻¹yv) and the
    factor of S_j; x = L⁻ᵀL⁻¹yv. Where a window is singular it breaks down
    where the reference's Cholesky chain does, not where the Gauss-Jordan one
    does. Every statement acts on each lane alone, so windows side by side
    give each one's x as alone."""
    N = D.shape[0]
    L, rd = _chol(D[0])
    yv = r[0]
    for j in range(1, N):
        W = _trsm_l(L, rd, U[j - 1])                  # (s,s,K), rows of W
        wtw = W[0][:, None] * W[0][None, :]
        for i in range(1, W.shape[0]):
            wtw = wtw + W[i][:, None] * W[i][None, :]
        z = _trsm_l(L, rd, yv[:, None])[:, 0]
        wz = W[0] * z[0]
        for i in range(1, W.shape[0]):
            wz = wz + W[i] * z[i]
        yv = r[j] - wz
        L, rd = _chol(D[j] - wtw)
    return _trsv_lt(L, rd, _trsm_l(L, rd, yv[:, None])[:, 0])


def _step_ablated(c, st: mhe_lanes.MHEStateL, R_sb, accel_b, omega_b, p_foot, J_foot, dq,
                  contact, vo_active, vo_tick_pre, vo_tick_now, vo_inc, ablate, mk_solve="gj",
                  systems=None):
    """``mhe_lanes.step`` (``step_per_instance_vo`` where ``vo_active`` is a
    (B,) tensor) with stage ``ablate`` skipped, as the kernel's ``ABL`` skips
    it (the plain version of K2e): "ingest" — no VO ingestion and no Bezier
    carry; "marg" — no marginalization; "build" — the fresh slot's dynamics,
    camera weight and measurement are zeros; "assembly" — x = n_p after the
    shift (and, with box consts, the z/y shift; no ADMM, 0 iterations);
    "solve" — x = Σ_j (D_j[:,0] + r_j + U_j[:,0]) over the masked system
    (U_{N-1} = 0) in place of its solution. The window is solved as the tick
    solves it: with box consts the warm-started ADMM, else with the tail
    ``mk_solve`` (the Cholesky one by ``_chol_sweep``; a caller that passes
    a list ``systems`` gets the masked system appended there, and x None, to
    sweep many ticks' windows at once). Returns (new state, x (s,B), the (B,)
    int32 ADMM iterations or None unconstrained)."""
    if ablate != "ingest":
        if torch.is_tensor(vo_active) and vo_active.ndim == 1:
            st = mhe_lanes._apply_vo_per_instance(c, st, vo_inc, vo_tick_pre, vo_tick_now,
                                                  vo_active)
        elif bool(vo_active):
            st = mhe_lanes._apply_vo(c, st, vo_inc, int(vo_tick_pre), int(vo_tick_now))
    if ablate != "marg" and st.T + 1 >= c.N:
        M_new, n_new = mhe_lanes._marginalize(c, st)
    else:
        M_new, n_new = st.M_p, st.n_p
    if ablate == "build":
        s, m, B = c.dim_state, c.dim_meas, accel_b.shape[-1]
        z = lambda *sh: torch.zeros(sh + (B,), dtype=accel_b.dtype, device=accel_b.device)
        fresh = (z(s, s), z(s), z(s, s), z(3, 3), z(m), z(m, m))
    else:
        fresh = mhe_lanes._fresh_slot(c, st, R_sb, omega_b, p_foot, J_foot, dq, contact)
    st = mhe_lanes._shift_append(c, st, M_new, n_new, fresh, R_sb, accel_b, contact)
    constrained = c.x_lb is not None
    if ablate == "assembly":
        return st, st.n_p, (torch.zeros(st.n_p.shape[-1], dtype=torch.int32,
                                        device=st.n_p.device) if constrained else None)
    if constrained:
        res = mhe_lanes._solve_window_admm(c, st)
        return st._replace(z_adm=res.z, y_adm=res.y), res.x[c.N - 1], res.iters
    if ablate == "solve":
        D, U, r = mhe_lanes._masked_system(c, st)
        x = None
        for j in range(c.N):
            term = D[j, :, 0] + r[j]
            if j < c.N - 1:
                term = term + U[j, :, 0]
            x = term if x is None else x + term
        return st, x, None
    if mk_solve == "chol":
        if systems is not None:
            systems.append(mhe_lanes._masked_system(c, st))
            return st, None, None
        return st, _chol_sweep(*mhe_lanes._masked_system(c, st)), None
    return st, mhe_lanes.solve_window(c, st)[c.N - 1], None


def solve_stage_scales(c, ks: KernelState, d, v, i):
    """Per tick and state of the "solve" stage's result x = Σ_j (D_j[:,0] +
    r_j + U_j[:,0]): ``terms``, the same sum over the magnitudes of its
    elementary products (the normal equations assembled from the absolute
    values of every operand, each difference a sum), the scale of the
    rounding that two orders of summation leave in x; ``system``, the sum of
    the magnitudes of the masked system's own entries Σ_j (|D_j[:,0]| + |r_j|
    + |U_j[:,0]|); and ``r_sum``, Σ_j r_j, what a sum without r would miss.
    Each (Tn, s, B), from the plain version's ticks (``_step_ablated``), on
    the inputs of ``replay_ticks`` (either clock; unconstrained consts)."""
    N, real, dev = c.N, d.accel_b.dtype, d.accel_b.device
    H, P = c.A_meas.abs(), c.P_cam.abs()
    st = mhe_state_from_kernel(ks, c)
    if v.active.ndim == 2:
        act, pre, now = v.active, v.tick_pre, v.tick_now
    else:
        act, pre, now = v.active.tolist(), v.tick_pre.tolist(), v.tick_now.tolist()
    out = {"terms": [], "system": [], "r_sum": []}
    for t in range(d.accel_b.shape[0]):
        st, _, _ = _step_ablated(c, st, d.R_sb[t], d.accel_b[t], d.omega_b[t], d.p_foot[t],
                                 d.J_foot[t], d.dq[t], d.contact[t], act[t], pre[t], now[t],
                                 i[t], "solve")
        Ds, Us, rs = mhe_lanes._masked_system(c, st)
        out["system"].append(Ds[:, :, 0].abs().sum(0) + rs.abs().sum(0) + Us[:, :, 0].abs().sum(0))
        out["r_sum"].append(rs.sum(0))
        first = N - min(st.T + 1, N)
        j = torch.arange(N, device=dev)
        iv = ((j >= first) & (j <= N - 2)).to(real)[:, None, None, None]
        cam = (st.cam_active.to(real)[:, None, None, :] * iv)
        A, Qd, b = st.A_dyn.abs(), st.Q_dyn.abs() * iv, st.b_dyn.abs()
        AtQd = lanes.mm_tn(A, Qd)
        PtQc = lanes.cmm_t(P, st.Q_cam.abs()) * cam
        PtQcP = lanes.mmc(PtQc, P)
        HtR = lanes.cmm_t(H, st.Q_meas.abs())
        pc = lanes.mv(PtQc, st.b_cam.abs())
        shift = lambda a: torch.cat([torch.zeros_like(a[:1]), a[:-1]])
        D = lanes.mmc(HtR, H) + lanes.mm(AtQd, A) + PtQcP + shift(Qd + PtQcP)
        r = (lanes.mv(HtR, st.y_meas.abs()) + lanes.mv(AtQd, b) + pc
             + shift(lanes.mv(Qd, b) + pc))
        D[first] += st.M_p.abs()
        r[first] += st.n_p.abs()
        valid = (j >= first).to(real)
        out["terms"].append((D[:, :, 0] * valid[:, None, None] + (1 - valid)[:, None, None]
                             * (j[:, None] == 0).to(real)[..., None]).sum(0)
                            + (r * valid[:, None, None]).sum(0)
                            + ((AtQd + PtQcP)[:-1, :, 0] * valid[:-1, None, None]).sum(0))
    return {k: torch.stack(a) for k, a in out.items()}


def replay_ticks_plain(c, ks: KernelState, data_l, vo, vo_inc, ablate="", mk_solve="gj"):
    """Plain PyTorch version of ``replay_ticks``: a Python loop over
    ``mhe_lanes.step`` (per-instance ``vo``: ``step_per_instance_vo``; with
    ``ablate``, ``_step_ablated`` with the tail ``mk_solve``) on the logical
    (shift-by-roll) window."""
    st = mhe_state_from_kernel(ks, c)
    Tn = data_l.accel_b.shape[0]
    if vo.active.ndim == 2:
        active, tick_pre, tick_now = vo.active, vo.tick_pre, vo.tick_now
        step = mhe_lanes.step_per_instance_vo
    else:
        active = vo.active.tolist()
        tick_pre = vo.tick_pre.tolist()
        tick_now = vo.tick_now.tolist()
        step = mhe_lanes.step
    xs, its, systems = [], [], []
    for i in range(Tn):
        d_i = (data_l.R_sb[i], data_l.accel_b[i], data_l.omega_b[i], data_l.p_foot[i],
               data_l.J_foot[i], data_l.dq[i], data_l.contact[i])
        if ablate:
            st, x_T, it = _step_ablated(c, st, *d_i, active[i], tick_pre[i], tick_now[i],
                                        vo_inc[i], ablate, mk_solve, systems)
        else:
            st, (x_T, _, it) = step(c, st, *d_i, active[i], None, tick_pre[i], tick_now[i],
                                    None, vo_inc=vo_inc[i])
        xs.append(x_T)
        its.append(it)
    s, B = c.dim_state, data_l.accel_b.shape[-1]
    dev = data_l.accel_b.device
    if systems:   # the Cholesky sweeps of every tick at once, its windows side by side
        x_all = _chol_sweep(*(torch.cat(a, dim=-1) for a in zip(*systems)))
        xs = list(x_all.reshape(s, Tn, B).movedim(1, 0))
    x = (torch.stack(xs, dim=0) if xs else
         torch.zeros((0, s, B), dtype=data_l.accel_b.dtype, device=dev))
    iters = None
    if c.x_lb is not None:
        iters = (torch.stack(its) if its else
                 torch.zeros((0, B), dtype=torch.int32, device=dev))
    return x, kernel_state_from_mhe(st, c)._replace(iters=iters)


def replay_ticks(c, ks: KernelState, data_l, vo, vo_inc, device="cuda", nvcc_flags=(),
                 mk_solve="gj", ablate="", block=None):
    """Advance the window over the ticks handed in.

    Args:
      c: ops.mhe.MHEConsts; with ``c.x_lb`` set ((s,) shared or (s,B)
        per-lane box) the constrained variant runs and ``ks`` carries the
        z/y warm-start rings.
      ks: KernelState whose newest tick is ``ks.t``; the first tick of
        ``data_l`` is tick ``ks.t + 1``.
      data_l: estimator.TickData in lanes layout (Tn, ..., B), contiguous.
      vo: estimator.VOData for the same ticks: the shared schedule (active,
        tick_pre, tick_now (Tn,)) or a camera clock per lane ((Tn,B), with a
        ``ks`` whose Bezier schedule is per lane); ``dp_body`` is not read
        here.
      vo_inc: (Tn,3,B) world-frame VO increments
        (``estimator.vo_world_increments``), zero on inactive ticks.
    Returns (x (Tn,s,B), new KernelState); ``ks`` is not modified. On
    constrained consts the new state's ``iters`` holds the (Tn,B) ADMM
    iterations this call ran per tick and instance. CPU
    tensors (``device="cpu"``) take the plain version; CUDA tensors launch
    the kernel or raise. ``nvcc_flags`` launches a variant build of the
    kernel instead (``_build.load``), e.g. ``("-fmad=false",)`` to compare
    builds. ``mk_solve`` is the tail of the unconstrained window solve, "gj"
    or "chol" (see the module docstring); the box kernels do not depend on
    it, nor does the plain version but for the stage ablation. ``ablate``
    skips one stage of the tick (see the module docstring; "" runs it all).
    ``block`` is the launch's threads per block, a multiple of ``BOX_G``
    whose shared memory fits (default ``BLOCK_TICK``, with box consts
    ``BLOCK_BOX``; see ``tick_geometry`` and ``box_geometry``, which raise
    ``ValueError`` otherwise, on the CPU as on the card); the plain version
    does not depend on it.
    """
    check_mk_solve(mk_solve)
    check_ablate(c, ablate, vo.active.ndim == 2, mk_solve)
    constrained = c.x_lb is not None
    device = resolve_device(device)
    N, s, m, L = c.N, c.dim_state, c.dim_meas, c.num_legs
    if N < 2:
        raise ValueError("the window needs N >= 2")
    Tn = data_l.accel_b.shape[0]
    B = data_l.accel_b.shape[-1]
    dtype = ks.arrays[0].dtype
    dev = ks.arrays[0].device
    if dev.type != device.type:
        raise ValueError(f"state on {dev}, expected {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype {dtype} not supported")
    inputs = [
        ("R_sb", data_l.R_sb, (Tn, 3, 3, B)),
        ("accel_b", data_l.accel_b, (Tn, 3, B)),
        ("omega_b", data_l.omega_b, (Tn, 3, B)),
        ("p_foot", data_l.p_foot, (Tn, L, 3, B)),
        ("J_foot", data_l.J_foot, (Tn, L, 3, 3, B)),
        ("dq", data_l.dq, (Tn, L, 3, B)),
        ("contact", data_l.contact, (Tn, L, B)),
        ("vo_inc", vo_inc, (Tn, 3, B)),
    ]
    for name, a, sh in inputs:
        _build.require_lanes(name, a, sh, dtype, dev)
    if constrained:
        block = box_geometry(s, dtype, block, N).threads_per_block
    else:
        block = tick_geometry(s, m, dtype, block, mk_solve).threads_per_block
    shapes = state_shapes(N, s, m, L, constrained)
    if len(ks.arrays) != len(shapes):
        raise ValueError(
            f"window state: {len(ks.arrays)} tensors, expected {len(shapes)} "
            f"for {'constrained' if constrained else 'unconstrained'} consts")
    for a, sh in zip(ks.arrays, shapes):
        _build.require_lanes("window state", a, sh + (B,), dtype, dev)
    bounds = (admm.broadcast_bounds(c.x_lb, c.x_ub, s, B, dtype, dev)
              if constrained else None)
    pi = vo.active.ndim == 2
    meta = (Tn, B) if pi else (Tn,)
    for name, a in (("vo.active", vo.active), ("vo.tick_pre", vo.tick_pre),
                    ("vo.tick_now", vo.tick_now)):
        if tuple(a.shape) != meta or a.device != dev:
            raise ValueError(f"{name}: expected {'per-lane' if pi else 'shared'} "
                             f"{meta} on {dev}, got {tuple(a.shape)} on {a.device}")
    sched = ((4, B), (1, B)) if pi else ((4,), (1,))
    if ((tuple(ks.bez_times.shape), tuple(ks.bez_count.shape)) != sched
            or ks.bez_times.device != dev or ks.bez_count.device != dev):
        raise ValueError(
            f"Bezier schedule: times {tuple(ks.bez_times.shape)}, count "
            f"{tuple(ks.bez_count.shape)}, expected {sched[0]}, {sched[1]} on {dev}"
            + (" (a camera clock per lane needs a state from "
               "mhe_lanes.init(per_instance_vo=True))" if pi else ""))
    if dev.type == "cpu":
        return replay_ticks_plain(c, ks, data_l, vo, vo_inc, ablate, mk_solve)
    return _launch(c, ks, [a for _, a, _ in inputs], vo, bounds, nvcc_flags, mk_solve,
                   ablate, block)


def _launch(c, ks: KernelState, inputs, vo, bounds=None, nvcc_flags=(), mk_solve="gj",
            ablate="", block=BLOCK_TICK):
    """Copy the window state, launch the tick kernel through ``dem_mhe_tick``
    (constrained with ``bounds``, the (lb, ub) pair of (s,B) tensors; on a
    camera clock per lane when ``vo``'s metadata is (Tn,B); unconstrained
    with the tail ``mk_solve``; with stage ``ablate`` skipped) on the current
    stream over all Tn ticks with ``block`` threads per block, count the
    launch. ``inputs`` are the eight per-tick tensors in the kernel's order
    (R, accel, omega, p_foot, J_foot, dq, contact, vo_inc); ``replay_ticks``
    has checked the arguments, and ``kernel_library`` refuses a shape that
    has no instantiation; a launch the card refuses raises."""
    N, s, m, L = c.N, c.dim_state, c.dim_meas, c.num_legs
    Tn, B = inputs[1].shape[0], inputs[1].shape[-1]
    dtype, dev = ks.arrays[0].dtype, ks.arrays[0].device
    pi = vo.active.ndim == 2
    variant = ablate_variant(bounds is not None, pi, mk_solve, ablate)
    chol = mk_solve == "chol" and bounds is None and (not ablate or "chol" in variant)
    lib = kernel_library(s, m, L, int(c.leg_odom_type), pi, chol, ablate, bounds is not None,
                         dtype == torch.float64)
    kc = consts_from_mhe(c)
    # the kernel updates the window in place: work on copies
    state = [a.clone() for a in ks.arrays]
    x = torch.empty((Tn, s, B), dtype=dtype, device=dev)
    bez_times_out = torch.empty(tuple(ks.bez_times.shape), dtype=dtype, device=dev)
    bez_count_out = torch.empty(tuple(ks.bez_count.shape), dtype=torch.int32, device=dev)
    meta = [vo.active.to(torch.int32).contiguous(),
            vo.tick_pre.to(torch.int32).contiguous(),
            vo.tick_now.to(torch.int32).contiguous()]
    tensors = (meta + [ks.bez_times.to(dtype).contiguous(),
                       ks.bez_count.to(torch.int32).contiguous()]
               + list(inputs) + state[:18]
               + [x, bez_times_out, bez_count_out])
    iters = None
    if bounds is not None:
        iters = torch.empty((Tn, B), dtype=torch.int32, device=dev)
        ws = lambda *sh: torch.empty(sh + (B,), dtype=dtype, device=dev)
        # lb, ub, z_adm, y_adm, iters, then the per-launch scratch: the masked
        # system Dw, Uw, rw (the solve keeps the rest in shared memory)
        tensors += list(bounds) + state[18:] + [
            iters, ws(N, s, s), ws(N - 1, s, s), ws(N, s)]
        ints, reals = ADMMCoreStatic.from_settings(c.admm, N, s).pack()
        settings = (ints.ctypes.data, reals.ctypes.data)
    else:
        settings = (None, None)
    fn = _build.load(lib, extra_flags=nvcc_flags)
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    consts = _pack_consts(kc)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream()
        timer.record(stream)
        err = fn(int(dtype == torch.float64), int(bounds is not None), int(pi), int(chol),
                 ABLATE_STAGES.index(ablate) + 1 if ablate else 0, s, m, L, kc.lot, ptrs,
                 len(tensors), consts.ctypes.data, *settings, N, B, Tn, ks.t + 1, block,
                 stream.cuda_stream)
        timer.record(stream)
    _build.check_launch(err, "mhe_tick")
    if ablate:
        launches_abl[variant][ablate] += 1
    else:
        globals()[_COUNTER[bounds is not None, pi, chol]] += 1
    if bounds is not None and ablate != "assembly":
        admm_kernel.launches_core += 1
    return x, KernelState(arrays=tuple(state), bez_times=bez_times_out,
                          bez_count=bez_count_out, t=ks.t + Tn, iters=iters)


def replay(c, data_l, vo, dtype=torch.float32, device="cuda", mk_solve=None, ablate="",
           block=None):
    """Full-log fleet MHE replay.

    Args:
      c: ops.mhe.MHEConsts.
      data_l: estimator.TickData in LANES layout (T, ..., B) on ``device``.
      vo: estimator.VOData — the shared fleet schedule (active (T,), dp_body
        (T,3) or per-lane (T,3,B) content), or a PER-INSTANCE schedule
        (active, tick_pre, tick_now (T,B), dp_body (T,3,B)) — told apart by
        active's rank; the latter runs the per-lane-clock kernel variant.
    Returns x_seq (T, s, B) — newest-state estimate per tick. Tick 0 is the
    init-window solve (with ``c.use_pallas`` through
    ``tridiag_kernel.solve_lanes`` or, for constrained consts,
    ``admm_kernel.solve_box_lanes``), as in ``estimator.run_mhe_lanes``; only
    its x is kept, so tick 1 warm-starts the ADMM from zeros. Ticks 1.. run
    in ``replay_ticks`` with the tail ``mk_solve``: "gj" or "chol", read from
    the environment variable ``DEM_MK_SOLVE`` (default "gj") at each call
    when None, as the reference reads it, with stage ``ablate`` skipped
    (timing only; tick 0 is not ablated, as in the reference) and ``block``
    threads per block.
    """
    from decentralized_ekf_mhe_tpu_torch.ops import estimator

    if mk_solve is None:
        mk_solve = os.environ.get("DEM_MK_SOLVE", "gj")
    check_mk_solve(mk_solve)
    device = resolve_device(device)
    N = c.N
    d0 = estimator.TickData(*(a[0] for a in data_l))
    st0 = mhe_lanes.init(c, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot,
                         d0.J_foot, d0.dq, d0.contact, dtype=dtype,
                         per_instance_vo=vo.active.ndim == 2, device=device)
    x0 = mhe_lanes.solve_window(c, st0)[N - 1]            # (s,B)
    vo_inc = estimator.vo_world_increments(data_l.R_sb, vo)
    rest = estimator.TickData(*(a[1:] for a in data_l))
    vo_rest = estimator.VOData(*(a[1:] for a in vo))
    x, _ = replay_ticks(c, kernel_state_from_mhe(st0, c), rest, vo_rest,
                        vo_inc[1:], device=device, mk_solve=mk_solve, ablate=ablate,
                        block=block)
    return torch.cat([x0[None], x], dim=0)
