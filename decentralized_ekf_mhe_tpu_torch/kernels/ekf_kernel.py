"""Orientation-EKF stage: hand-written CUDA kernel + plain version.

Replaces the reference's TPU kernel ``pallas/ekf_kernel.py`` (``replay`` →
``_chunk_call`` → ``_make_kernel``) with ``csrc/ekf.cu`` (body
``csrc/ekf.cuh``): the whole 500 Hz stage — history-ring push, delayed-VO
rewind + replay with the 4×4 VO correction at the first replayed step, gyro
predict, (‖a‖/g)²-scaled accel correct — as ONE launch over all the ticks
handed to it, a group of ``_group.EKF_G`` = 4 CUDA threads per instance, one
warp per block: lane i owns row i of P and of each product and its own
entries of every quotient (the normalizations of q, the 3×3 inverse), and
the group gathers them with warp shuffles.

What the TPU kernel kept in VMEM stays on chip: each instance's history ring
sits in the block's shared memory for the whole launch (read once from the
carried-in state, written once to the state carried out), and the input
stream (gyro, accel, the shared schedule and VO quaternion) comes through
shared memory a chunk of ticks at a time, double buffered with asynchronous
copies, so no global load waits inside a filter step's chain. The TPU
wrapper's 128-instance tile does not carry over: any B works, the ragged edge
is masked in the kernel. What bounds it on an H100: operations (about 1k per
substep against 6 streamed inputs, ``kernels/_work.py``); in practice the
serial chain of one instance's filter steps.

``replay`` keeps the carry-in/carry-out contract: state in, final state out
(fresh tensors; the input state is not modified), so a log split over two
calls equals one call.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from decentralized_ekf_mhe_tpu_torch.kernels import _build, _group
from decentralized_ekf_mhe_tpu_torch.ops.ekf import GRAVITY
from decentralized_ekf_mhe_tpu_torch.ops.ekf_lanes import EKFStateL
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device

launches = 0     # incremented where the CUDA kernel is launched, nowhere else
timer = _build.KernelTimer()   # times the kernel call alone


def replay_plain(ec, ekf_st, eb):
    """Plain PyTorch version: ``estimator.scan_ekf_blocks`` (a Python loop
    over ``ekf_lanes.substep_block``). Returns (q_seq (T,4,B), final_state)."""
    from decentralized_ekf_mhe_tpu_torch.ops import estimator

    final, q_seq = estimator.scan_ekf_blocks(ekf_st, eb, ec)
    return q_seq, final


def _pack_consts(ec) -> np.ndarray:
    return np.concatenate([
        [float(ec.dt)],
        np.asarray(ec.C_gyro, np.float64).ravel(),
        np.asarray(ec.C_accel, np.float64).ravel(),
        np.asarray(ec.C_vo, np.float64).ravel(),
        np.asarray(ec.gravity, np.float64).ravel(),
        [GRAVITY * GRAVITY],
    ]).astype(np.float64)


def replay(ec, ekf_st: EKFStateL, eb, device="cuda"):
    """Full EKF stage over the blocks handed in.

    Args:
      ec: ekf_lanes.EKFConstsL.
      ekf_st: ekf_lanes.EKFStateL (lanes layout, any B).
      eb: estimator.EKFBlocks with lanes gyro/accel (T,S,3,B), SHARED
        valid/vo_active/vo_steps_back (T,S), vo_q shared (T,S,4) or per-lane
        (T,S,4,B).
    Returns (q_seq (T,4,B), final_state); the input state is not modified.
    CPU tensors (``device="cpu"``) take the plain version; CUDA tensors
    launch the kernel or raise.
    """
    device = resolve_device(device)
    if eb.gyro.ndim != 4:
        raise ValueError(f"gyro: expected (T,S,3,B), got {tuple(eb.gyro.shape)}")
    if eb.vo_active.ndim != 2:
        raise NotImplementedError(
            "per-lane VO timing has no EKF kernel (nor has the reference's): "
            "estimator.scan_ekf_blocks runs it; a kernel for it is listed in "
            "ROADMAP.md under kernel work that is not a port")
    T, S, _, B = eb.gyro.shape
    R = ekf_st.gyro_hist.shape[0]
    dtype = ekf_st.q.dtype
    dev = ekf_st.q.device
    if dev.type != device.type:
        raise ValueError(f"state on {dev}, expected {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype {dtype} not supported")
    per_lane_vo_q = eb.vo_q.ndim == 4
    _build.require_lanes("gyro", eb.gyro, (T, S, 3, B), dtype, dev)
    _build.require_lanes("accel", eb.accel, (T, S, 3, B), dtype, dev)
    _build.require_lanes("vo_q", eb.vo_q,
                         (T, S, 4, B) if per_lane_vo_q else (T, S, 4), dtype, dev)
    for name, a in (("valid", eb.valid), ("vo_active", eb.vo_active),
                    ("vo_steps_back", eb.vo_steps_back)):
        if tuple(a.shape) != (T, S) or a.device != dev:
            raise ValueError(f"{name}: expected shared (T,S)={T, S} on {dev}")
    if dev.type == "cpu":
        return replay_plain(ec, ekf_st, eb)
    return _launch(ec, ekf_st, eb)


def geometry(R, S, dtype, per_lane_vo_q=False):
    """The launch of ``ekf_stage``: ``_group.ekf_geometry`` (threads and
    instances per block, dynamic shared bytes, ticks per staged chunk); raises
    ``ValueError`` for a block the card cannot take."""
    return _group.ekf_geometry(R, S, dtype, per_lane_vo_q)


def occupancy(R, S, dtype, per_lane_vo_q=False):
    """The launch's geometry as the card reports it (``dem_ekf_geometry``, on
    the current device): instances and threads per block, dynamic shared
    bytes, blocks resident per SM, registers and local bytes per thread, ticks
    per chunk. Raises as a launch would."""
    g = geometry(R, S, dtype, per_lane_vo_q)
    fn = _build.entry("ekf", "dem_ekf_geometry", [ctypes.c_int] * 6 + [ctypes.c_void_p])
    out = (ctypes.c_int * 7)()
    _build.check_launch(fn(int(dtype == torch.float64), S, R, int(bool(per_lane_vo_q)),
                           g.ticks_per_chunk, g.threads_per_block,
                           ctypes.cast(out, ctypes.c_void_p)), "ekf_stage geometry")
    res = _group.card_figures(out)
    res["ticks_per_chunk"] = out[6]
    return res


def _launch(ec, ekf_st: EKFStateL, eb):
    """Allocate the state carried out, launch ``dem_ekf_stage`` on the current
    stream over all T ticks (``geometry``'s block), count the launch. The
    substep counter is taken before the launch, so the host does not wait
    for the kernel."""
    global launches
    T, S, _, B = eb.gyro.shape
    R = ekf_st.gyro_hist.shape[0]
    dtype, dev = ekf_st.q.dtype, ekf_st.q.device
    per_lane_vo_q = eb.vo_q.ndim == 4
    state = [ekf_st.q, ekf_st.P, ekf_st.gyro_hist, ekf_st.accel_hist,
             ekf_st.q_hist, ekf_st.P_hist]
    shapes = [(4, B), (4, 4, B), (R, 3, B), (R, 3, B), (R, 4, B), (R, 4, 4, B)]
    for a, sh in zip(state, shapes):
        _build.require_lanes("ekf state", a, sh, dtype, dev)
    g = geometry(R, S, dtype, per_lane_vo_q)
    valid = eb.valid.to(torch.int32).contiguous()
    vo_active = eb.vo_active.to(torch.int32).contiguous()
    vo_sb = eb.vo_steps_back.to(torch.int32).contiguous()
    # the substep counter advances by the number of valid substeps
    t_final = int(ekf_st.t) + int(valid.sum().item())
    out = [torch.empty(sh, dtype=dtype, device=dev) for sh in shapes]
    q_seq = torch.empty((T, 4, B), dtype=dtype, device=dev)

    fn = _build.load("ekf")
    tensors = [eb.gyro, eb.accel, valid, vo_active, vo_sb, eb.vo_q] + state + out + [q_seq]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    consts = _pack_consts(ec)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream()
        timer.record(stream)
        err = fn(int(dtype == torch.float64), ptrs, consts.ctypes.data, int(bool(ec.quirk_W)),
                 T, S, R, B, int(ekf_st.t), int(per_lane_vo_q), g.ticks_per_chunk,
                 g.threads_per_block, stream.cuda_stream)
        timer.record(stream)
    _build.check_launch(err, "ekf_stage")
    launches += 1
    final = EKFStateL(q=out[0], P=out[1], t=t_final, gyro_hist=out[2],
                      accel_hist=out[3], q_hist=out[4], P_hist=out[5])
    return q_seq, final
