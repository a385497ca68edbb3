"""Hardware-in-the-loop streaming demo: the reference's realtime loop, closed.

Counterpart of the reference's ``examples/run_hil.py``. The reference runs
online: the 500 Hz orientation EKF (`orien_est`, orien_ekf.cpp:77-105)
publishes `imu/filter`, sensor callbacks mutate `robot_store`, and a wall
timer drives one MHE tick every 5 ms (EstSub.cpp:25,58-91). This driver is
the analog of that FULL cycle for replayed or live-fed data — the orientation
EKF runs IN the loop (``ops.facade.PipelineEstimator``), consuming raw
gyro/accel substep blocks, not ground-truth orientation.

Aligned tick rows stream through the C++ ``BlockFeeder``
(native/dem_native.cpp: dem_feeder_*), which alternates two staging buffers
so the block handed to the estimator stays valid while the next one is being
copied — the host-side analog of double-buffered DMA. Each block moves to the
device once, then runs tick by tick: the EKF substeps, the rotation, and the
MHE tick, whose window solve is one launch of the block-tridiagonal kernel at
B=1 (``use_pallas=True``; the box-ADMM kernel with a box).

Run:  python -m decentralized_ekf_mhe_tpu_torch.examples.run_hil
          [--ticks 2000] [--block 20] [--no-native] [--cpu]

Prints the sustained per-tick latency series (p50/p99) of the FULL EKF+MHE
cycle against the reference's 5 ms budget, plus a tick-at-a-time comparison
(``DecentralizedEstimator``, the standard layout, one call per tick). The
fence after each block is a host read of its result. The estimator is the
reference bench's Go1 configuration (``tools/roofline.bench_params``, N=20)
with the default ``EKFParams``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def pack_rows(log, eb) -> np.ndarray:
    """Flatten each tick's aligned FULL-cycle inputs into one f64 row.

    Layout per tick: ekf_gyro(S*3) ekf_accel(S*3) ekf_valid(S)
    ekf_vo_active(S) ekf_vo_q(S*4) ekf_vo_sb(S) | accel(3) omega(3)
    p_foot(L*3) J_foot(L*9) dq(L*3) contact(L) vo_active(1) vo_dp(3)
    vo_tick_pre(1) vo_tick_now(1).
    """
    T = log.accel_b.shape[0]
    f = np.float64
    parts = [
        np.asarray(eb.gyro, f).reshape(T, -1),
        np.asarray(eb.accel, f).reshape(T, -1),
        np.asarray(eb.valid, f).reshape(T, -1),
        np.asarray(eb.vo_active, f).reshape(T, -1),
        np.asarray(eb.vo_q, f).reshape(T, -1),
        np.asarray(eb.vo_steps_back, f).reshape(T, -1),
        log.accel_b.reshape(T, -1), log.omega_b.reshape(T, -1),
        log.p_foot.reshape(T, -1),
        log.J_foot.reshape(T, -1), log.dq.reshape(T, -1),
        log.contact.reshape(T, -1),
        np.asarray(log.vo_active, f).reshape(T, 1),
        log.vo_dp_body.reshape(T, -1),
        np.asarray(log.vo_tick_pre, f).reshape(T, 1),
        np.asarray(log.vo_tick_now, f).reshape(T, 1),
    ]
    return np.ascontiguousarray(np.concatenate(parts, axis=1))


def unpack_rows(rows: np.ndarray, L: int, S: int):
    """Inverse of pack_rows for a (K, width) block."""
    K = rows.shape[0]
    o = 0

    def take(n, shape):
        nonlocal o
        out = rows[:, o:o + n].reshape((K,) + shape)
        o += n
        return out

    ekf_gyro = take(3 * S, (S, 3))
    ekf_accel = take(3 * S, (S, 3))
    ekf_valid = take(S, (S,)).astype(bool)
    ekf_va = take(S, (S,)).astype(bool)
    ekf_vq = take(4 * S, (S, 4))
    ekf_sb = take(S, (S,)).astype(np.int64)
    accel = take(3, (3,))
    omega = take(3, (3,))
    p_foot = take(3 * L, (L, 3))
    J_foot = take(9 * L, (L, 3, 3))
    dq = take(3 * L, (L, 3))
    contact = take(L, (L,))
    vo_active = take(1, ()).astype(bool)
    vo_dp = take(3, (3,))
    vo_tick_pre = take(1, ()).astype(np.int64)
    vo_tick_now = take(1, ()).astype(np.int64)
    return dict(
        ekf_gyro=ekf_gyro, ekf_accel=ekf_accel, ekf_valid=ekf_valid,
        accel_b=accel, omega_b=omega, p_foot=p_foot, J_foot=J_foot, dq=dq,
        contact=contact, ekf_vo_active=ekf_va, ekf_vo_q=ekf_vq,
        ekf_vo_steps_back=ekf_sb, vo_active=vo_active, vo_dp=vo_dp,
        vo_tick_pre=vo_tick_pre, vo_tick_now=vo_tick_now)


class NumpyFeeder:
    """Pure-numpy fallback with the BlockFeeder interface."""

    def __init__(self, src: np.ndarray, block: int):
        self._src = src.reshape(src.shape[0], -1)
        self._block = block
        self._pos = 0

    def next(self):
        n = min(self._block, self._src.shape[0] - self._pos)
        if n <= 0:
            self._pos, n = 0, min(self._block, self._src.shape[0])
        out = np.zeros((self._block, self._src.shape[1]))
        out[:n] = self._src[self._pos:self._pos + n]
        self._pos += n
        return out, n


def stream(log, params, ekf_params, block, dtype, device, use_native=True):
    """Stream ``log`` through a ``PipelineEstimator(use_pallas=True)`` in
    blocks of ``block`` ticks fed by the native ``BlockFeeder``
    (``use_native``) or the numpy feeder: tick 0 initializes, then
    (T-1)//block blocks run, the first one untimed. Each block's latency runs from fetching it to a host read of its
    result. Returns {"x", "v", "q": tensors of every tick streamed (tick 0
    first), "latency_ms": per-tick latency of each timed block, "feeder"}."""
    import torch

    from decentralized_ekf_mhe_tpu_torch import native
    from decentralized_ekf_mhe_tpu_torch.ops import estimator
    from decentralized_ekf_mhe_tpu_torch.ops.facade import PipelineEstimator

    L = params.num_legs
    T = log.accel_b.shape[0]
    eb = estimator.ekfblocks_from_log(log, dtype=torch.float64, device="cpu")
    S = int(eb.gyro.shape[1])
    rows = pack_rows(log, eb)
    feeder = (native.BlockFeeder(rows[1:], block) if use_native
              else NumpyFeeder(rows[1:], block))

    est = PipelineEstimator(params, ekf_params, dtype=dtype, use_pallas=True, device=device)
    est.initialize(eb.gyro[0], eb.accel[0], eb.valid[0], log.accel_b[0], log.omega_b[0],
                   log.p_foot[0], log.J_foot[0], log.dq[0], log.contact[0],
                   ekf_vo_active=eb.vo_active[0], ekf_vo_q=eb.vo_q[0],
                   ekf_vo_steps_back=eb.vo_steps_back[0])
    xs, vs, qs = [est.x[None]], [est.v_body[None]], [est.q[None]]
    lat = []
    for b in range((T - 1) // block):
        t0 = time.perf_counter()
        blk, n_valid = feeder.next()
        x, v, q = est.update_block(**unpack_rows(blk[:n_valid], L, S))
        float(x.sum())                    # fence: device -> host
        if b:                             # the first block warms up
            lat.append((time.perf_counter() - t0) / n_valid)
        xs.append(x)
        vs.append(v)
        qs.append(q)
    return dict(x=torch.cat(xs), v=torch.cat(vs), q=torch.cat(qs),
                latency_ms=np.asarray(lat) * 1e3,
                feeder="native BlockFeeder" if use_native else "numpy feeder")


def tick_at_a_time(log, params, dtype, device, n):
    """Per-tick latency (ms) of ``DecentralizedEstimator.update`` over ticks
    2..n-1 (tick 1 warms up), each fenced by a host read."""
    from decentralized_ekf_mhe_tpu_torch.ops.facade import DecentralizedEstimator

    args = lambda k: [a[k] for a in (log.R_sb_gt, log.accel_b, log.omega_b, log.p_foot,
                                      log.J_foot, log.dq, log.contact)]
    est = DecentralizedEstimator(params, dtype=dtype, device=device)
    est.initialize(*args(0))
    est.update(*args(1))
    float(est.x.sum())
    lat = []
    for k in range(2, n):
        t0 = time.perf_counter()
        est.update(*args(k))
        float(est.x.sum())
        lat.append(time.perf_counter() - t0)
    return np.asarray(lat) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ticks", type=int, default=2000)
    ap.add_argument("--block", type=int, default=20,
                    help="ticks per block (0.1 s at 200 Hz)")
    ap.add_argument("--no-native", action="store_true",
                    help="use the numpy feeder even if the C++ lib is built")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    import torch

    from decentralized_ekf_mhe_tpu_torch import native
    from decentralized_ekf_mhe_tpu_torch.config import EKFParams
    from decentralized_ekf_mhe_tpu_torch.io import synth
    from decentralized_ekf_mhe_tpu_torch.tools.roofline import bench_params

    device = "cpu" if args.cpu else "cuda"
    where = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    p = bench_params()
    log = synth.generate(synth.SynthConfig(T=args.ticks, seed=0))
    use_native = native.available() and not args.no_native
    print(f"streaming {args.ticks} FULL EKF+MHE cycles in blocks of "
          f"{args.block} via {'native BlockFeeder' if use_native else 'numpy feeder'} "
          f"on {where}", file=sys.stderr)
    out = stream(log, p, EKFParams(), args.block, torch.float32, device, use_native)
    lat_ms = out["latency_ms"]
    done = out["x"].shape[0]
    print(f"sustained per-tick latency over {done} FULL cycles (EKF "
          f"substeps + MHE solve each): "
          f"p50 {np.percentile(lat_ms, 50):.3f} ms, "
          f"p99 {np.percentile(lat_ms, 99):.3f} ms "
          f"(reference cycle budget: 5 ms)", file=sys.stderr)

    # sanity: the streamed estimate tracks ground truth (spatial velocity)
    v_err = out["x"][-1, 3:6].double().cpu().numpy() - log.gt_v_s[done - 1]
    print(f"final-tick velocity error vs GT: {np.abs(v_err).max():.4f} m/s",
          file=sys.stderr)

    # tick-at-a-time comparison: what one call per tick costs (MHE facade)
    lat1_ms = tick_at_a_time(log, p, torch.float32, device, min(40, args.ticks - 1))
    print(f"tick-at-a-time comparison (n={len(lat1_ms)}): "
          f"p50 {np.percentile(lat1_ms, 50):.3f} ms/tick — blocking "
          f"{np.percentile(lat1_ms, 50) / max(np.percentile(lat_ms, 50), 1e-9):.1f}x",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
