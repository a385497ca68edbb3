"""Where the MHE tick kernel's time goes on the card: its roofline, a stage
ablation, a block/fleet-size sweep, a profiler trace and the constrained
tick's per-iteration cost.

The port of the reference's ``tools/roofline.py``, with the card's ceilings in
place of the TPU's: one NVIDIA H100 SXM at its data-sheet peaks, 3.35 TB/s of
HBM and 67 TFLOP/s in float32 outside the tensor cores (the tick's s×s blocks
never reach a tensor core). Operations and bytes come from
``kernels/_work.mhe_tick``, the rule every bound of this package follows.

    python -m decentralized_ekf_mhe_tpu_torch.tools.roofline [--ablate] [--sweep]
        [--trace [--trace-out FILE]] [--constrained-sweep]
        [--model go1|cassie_bench|pogox_bench] [--rate TICKS_PER_S] [--B 1024] [--T 200]
        [--device cuda]

Modes (each prints a table to stderr and one JSON line to stdout):

* no mode: the analytic model of one tick (``tick_model``); ``--rate`` the
  achieved rates of a measured one (``report``).
* ``--ablate`` (``ablation``): the tick kernel (K2) and its five stage
  ablations (K2e: ingest, marg, build, assembly, solve) at B=1024, T=200, each
  timed alone with CUDA events, best of 3; full minus ablated is the stage's
  share. The ablated outputs are wrong by construction (timing only).
  ``--model pogox_bench`` (``cassie_bench``) ablates PogoX's (Cassie's) tick.
  The ``ablation`` function takes, as ``replay`` does, any fleet (per-lane
  clocks included), the tail and any consts (box consts: the constrained
  tick, whose stages are all but "solve").
* ``--sweep`` (``sweep``): the kernel's threads per block (32, 64, 128, 256)
  against the fleet size (1024, 4096, 16384) — the port has no chunk to sweep
  (one launch replays the whole log), so the block is its launch knob.
  The unconstrained tick runs 16 threads per instance, so every block is a
  multiple of 16. ``--model cassie_bench`` (``pogox_bench``) sweeps Cassie's
  (PogoX's) tick.
* ``--trace`` (``trace_capture``): a ``torch.profiler`` capture of the Go1
  pipeline runner (EKF kernel, K5 at tick 0, the tick kernel): device time by
  kernel, the device's busy and idle share, the host time per launch; where
  the profiler shows no device time, CUDA events around the run instead, and
  the result says so.
* ``--constrained-sweep`` (``constrained_sweep``): the constrained tick (K2c)
  at ADMM budgets 5, 10, 20, 40 with and without polish; the slope over the
  budget is the cost of one ADMM iteration. ``--model cassie_bench`` runs it
  at Cassie's shape (s=15) at the bench's settings.

The fleet is the reference bench's headline one (``bench.py``'s Go1
parameters and perturbation: per-lane IMU/encoder noise, per-lane VO
translation, one shared camera clock), drawn here with an explicit
``torch.Generator``; "cassie_bench" is Cassie's shape at the bench's settings
(two legs, foot positions as states, its log of seed 2, ``bench.py:455-460``)
and "pogox_bench" PogoX's (one leg, the velocity form, its log of seed 2).
Every entry point defaults to ``device="cuda"``; with ``device="cpu"`` the
wrappers take their plain versions and the times are the host's, which the
results label as such (control flow only: no device figure comes from a CPU
run).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from decentralized_ekf_mhe_tpu_torch.config import EKFParams, EstimatorParams
from decentralized_ekf_mhe_tpu_torch.io import synth
from decentralized_ekf_mhe_tpu_torch.kernels import _work
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import estimator, mhe, mhe_lanes
from decentralized_ekf_mhe_tpu_torch.parallel import batch
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device

# one H100 SXM, NVIDIA data sheet: HBM3 3.35 TB/s, 67 TFLOP/s float32 outside
# the tensor cores (at the 700 W power limit)
PEAK_BYTES_S, PEAK_F32_FLOPS = 3.35e12, 67e12
F32 = torch.float32


def bench_params() -> EstimatorParams:
    """The reference bench's Go1 estimator (its ``_params``)."""
    return EstimatorParams(
        num_legs=4, leg_odom_type=0, rate=200, N=20,
        p_process_std=[0.001] * 3, accel_input_std=[0.025, 0.025, 0.02],
        gyro_input_std=[0.03] * 3, accel_bias_std=[0.07, 0.02, 0.03],
        joint_position_std=[0.04] * 3, joint_velocity_std=[0.22] * 3,
        foot_slide_std=[0.003] * 3, foot_swing_std=[1e7] * 3,
        vo_p_std=[1.5e-5] * 3,
    )


MODELS = ("go1", "cassie_bench", "pogox_bench")
# the bench's legged shapes (bench.py:455-460): model -> (legs, leg_odom_type)
LEGGED = {"cassie_bench": (2, 1), "pogox_bench": (1, 0)}


def bench_fleet(B, T, device="cuda", dtype=F32, seed=0, model="go1"):
    """The bench's headline fleet on ``device``: the Go1 log (seed 0) tiled
    into B perturbed instances — IMU/encoder noise (``perturb_log_batch``), the
    EKF blocks with per-lane VO quaternions, per-lane VO translation on the
    shared camera clock — from one ``torch.Generator`` seeded with ``seed``;
    ``model="cassie_bench"`` (``"pogox_bench"``): Cassie's (PogoX's) shape at
    the bench's settings on its own log. Returns (params, data (T,B,...), EKF
    blocks, VOData)."""
    device = resolve_device(device)
    if model not in MODELS:
        raise ValueError(f"model: {model!r} is not one of {MODELS}")
    p = bench_params()
    if model in LEGGED:
        p.num_legs, p.leg_odom_type = LEGGED[model]
    log = synth.generate(synth.SynthConfig(T=T, seed=0 if model == "go1" else 2,
                                           num_legs=p.num_legs))
    g = torch.Generator(device=device).manual_seed(seed)
    data = estimator.tickdata_from_log(log, dtype=dtype, device=device)
    vo = estimator.vodata_from_log(log, dtype=dtype, device=device)
    data_b = batch.to_time_leading(batch.perturb_log_batch(data, B, g, p, dtype=dtype))
    eb = batch.perturb_ekf_blocks(
        estimator.ekfblocks_from_log(log, dtype=dtype, device=device), B, g, p,
        dtype=dtype, vo_noise_scale=1.0, ekf_params=EKFParams())
    eb = eb._replace(gyro=eb.gyro.contiguous(), accel=eb.accel.contiguous())
    return p, data_b, eb, batch.perturb_vo_batch(vo, B, g, p, dtype=dtype)


def tick_inputs(c, data_b, vo):
    """What ``mhe_replay_kernel.replay`` hands ``replay_ticks`` for this fleet:
    (tick-0 kernel state, ticks 1.. of the lanes-layout data, of the VO
    schedule, of the world-frame VO increments)."""
    data_l = batch.tickdata_to_lanes(data_b)
    d0 = estimator.TickData(*(a[0] for a in data_l))
    st0 = mhe_lanes.init(c, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot, d0.J_foot, d0.dq,
                         d0.contact, dtype=data_l.accel_b.dtype,
                         per_instance_vo=vo.active.ndim == 2, device=data_l.accel_b.device)
    vo_inc = estimator.vo_world_increments(data_l.R_sb, vo)
    return (mrk.kernel_state_from_mhe(st0, c),
            estimator.TickData(*(a[1:].contiguous() for a in data_l)),
            estimator.VOData(*(a[1:] for a in vo)), vo_inc[1:].contiguous())


def tick_work(c, ks, d, v, itemsize, ablate="", tail="gj", iters=None):
    """(bytes, operations) of one ``replay_ticks`` call on these inputs with
    the tail ``tail`` and stage ``ablate`` skipped (``_work.mhe_tick``, on
    per-lane clocks ``mhe_tick_lanes``); with box consts ``iters`` are the
    (Tn,B) ADMM iterations the call ran."""
    box = None
    if c.x_lb is not None:
        a = c.admm
        box = (iters.cpu().numpy(), a.rho_update_every, a.adaptive_rho,
               a.abs_tol > 0 or a.rel_tol > 0, a.polish)
    shape = (c.N, c.dim_state, c.dim_meas, c.num_legs)
    kw = dict(box=box, lot=int(c.leg_odom_type), tail=tail, ablate=ablate)
    n_stance = int((d.contact > 0).sum())
    if v.active.ndim == 2:
        groups = _work.mhe_lane_schedules(v.active.cpu().numpy(), v.tick_pre.cpu().numpy(),
                                          v.tick_now.cpu().numpy(), c.N,
                                          ks.bez_count[0].cpu().numpy())
        return _work.mhe_tick_lanes(*shape, groups, n_stance, itemsize, **kw)
    sched = _work.mhe_schedule(v.active.tolist(), v.tick_pre.tolist(), v.tick_now.tolist(),
                               c.N, int(ks.bez_count))
    return _work.mhe_tick(*shape, d.accel_b.shape[-1], sched, n_stance, itemsize, **kw)


def bound(work):
    """{bound_ms, bound_by} of (bytes, operations): the larger of the bytes
    over the memory rate and the operations over the float32 peak."""
    t_b, t_f = work[0] / PEAK_BYTES_S * 1e3, work[1] / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_b, t_f), "bound_by": "bytes" if t_b >= t_f else "operations"}


def device_info(device):
    """Where the numbers come from: the card's name and power limit (as
    nvidia-smi prints them) and the clock the times are read with."""
    if device.type != "cuda":
        return {"device": "cpu", "clock": "host clock around the plain versions on the CPU: "
                "control flow only, not a device time"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return {"device": torch.cuda.get_device_name(device),
            "card": smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None,
            "clock": "CUDA events around the tick kernel alone"}


def best_ms(fn, device, reps=3):
    """``fn()`` once to warm up, then the best of ``reps`` runs in ms: on the
    card the tick kernel alone (``mhe_replay_kernel.timer``: CUDA events
    around each launch ``fn`` makes), on the CPU the host clock around
    ``fn``."""
    fn()
    best = math.inf
    for _ in range(reps):
        if device.type == "cuda":
            mrk.timer.on = True
            try:
                fn()
            finally:
                mrk.timer.on = False
            best = min(best, sum(mrk.timer.ms()))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def tick_model(N=20, s=9, m=12, L=4, lot=0, T=200, itemsize=4):
    """Operations and bytes of ONE tick of ONE instance of the unconstrained
    tick kernel at this shape, on the bench log's shared camera clock over
    ticks 1..T-1: ``_work.mhe_tick`` of one lane, over T-1 (the window state
    is read and written once per call, so its bytes are spread over the
    call's ticks)."""
    log = synth.generate(synth.SynthConfig(T=T, seed=0, num_legs=L))
    vo = estimator.vodata_from_log(log, device="cpu")
    data = estimator.tickdata_from_log(log, device="cpu")
    sched = _work.mhe_schedule(vo.active[1:].tolist(), vo.tick_pre[1:].tolist(),
                               vo.tick_now[1:].tolist(), N)
    nbytes, ops = _work.mhe_tick(N, s, m, L, 1, sched, int((data.contact[1:] > 0).sum()),
                                 itemsize, lot=lot)
    return {"flops_per_tick": ops / (T - 1), "bytes_per_tick": nbytes / (T - 1),
            "intensity": ops / nbytes, "N": N, "s": s, "m": m, "L": L, "T": T,
            "itemsize": itemsize}


def report(rate_ticks_per_s, file=sys.stderr, **shape):
    """Achieved operation and byte rates of a measured tick rate (instance
    ticks per second) against the card's peaks, and which one binds."""
    mdl = tick_model(**shape)
    flops = rate_ticks_per_s * mdl["flops_per_tick"]
    nbytes = rate_ticks_per_s * mdl["bytes_per_tick"]
    f_frac, b_frac = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    bound_by = "operations" if f_frac > b_frac else "bytes"
    print(f"roofline (N={mdl['N']}, s={mdl['s']}): {mdl['flops_per_tick'] / 1e3:.1f} "
          f"kFLOP/tick, {mdl['bytes_per_tick']:.0f} B/tick (intensity "
          f"{mdl['intensity']:.0f} FLOP/B) -> {flops / 1e9:.1f} GFLOP/s "
          f"({100 * f_frac:.3f}% of {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s float32), "
          f"{nbytes / 1e9:.2f} GB/s ({100 * b_frac:.3f}% of {PEAK_BYTES_S / 1e12:.2f} TB/s); "
          f"{bound_by}-bound", file=file)
    return {"rate_ticks_per_s": rate_ticks_per_s, "gflops": flops / 1e9,
            "gbytes_s": nbytes / 1e9, "flops_share": f_frac, "bytes_share": b_frac,
            "bound_by": bound_by, "model": mdl}


def ablation(B=1024, T=200, device="cuda", fleet=None, reps=3, model="go1", mk_solve="gj",
             consts=None):
    """Per-stage time of the tick by ablation: the tick kernel (K2, float32)
    and each of its stage ablations (K2e) on the same inputs, the kernel
    alone, best of ``reps`` after a warm-up; ``full − ablated`` over ``full``
    is the stage's share. ``fleet`` (params, data, EKF blocks, VOData: the
    shared camera clock or a clock per lane) replaces ``model``'s bench fleet
    of B instances over T ticks; as ``replay`` does, the tick takes the tail
    ``mk_solve`` and ``consts`` (e.g. box consts: the constrained tick, whose
    stages are all but "solve"; default the fleet's params unconstrained).
    Returns {"full": {...}, "stages": {stage: {"ms", "share", "bound_ms",
    ...}}, ...}."""
    device = resolve_device(device)
    p, data_b, _, vo = fleet if fleet is not None else bench_fleet(B, T, device, model=model)
    B, T = data_b.accel_b.shape[1], data_b.accel_b.shape[0]
    c = consts if consts is not None else mhe.make_consts(p, data_b.accel_b.dtype, device=device)
    ks, d, v, i = tick_inputs(c, data_b, vo)
    itemsize = data_b.accel_b.element_size()
    got = {}

    def run(ablate):
        got["ks"] = mrk.replay_ticks(c, ks, d, v, i, device=device, mk_solve=mk_solve,
                                     ablate=ablate)[1]

    work_of = lambda ablate: tick_work(c, ks, d, v, itemsize, ablate, mk_solve, got["ks"].iters)
    full = best_ms(lambda: run(""), device, reps)
    work = work_of("")
    box = c.x_lb is not None
    out = {"B": B, "T": T, "s": c.dim_state, "m": c.dim_meas, "mk_solve": mk_solve,
           "constrained": box, "per_lane_clocks": vo.active.ndim == 2, **device_info(device),
           "full": {"ms": full, "ticks_per_s": B * (T - 1) / (full / 1e3), **bound(work),
                    "bytes": work[0], "operations": work[1]},
           "stages": {}}
    print(f"ablation (s={c.dim_state}, m={c.dim_meas}, {mk_solve}"
          f"{', box' if box else ''}{', per-lane clocks' if vo.active.ndim == 2 else ''}, "
          f"B={B}, T={T}): full {full:.3f} ms -> "
          f"{B * (T - 1) / (full / 1e3):,.0f} ticks/s", file=sys.stderr)
    for stage in mrk.ABLATE_STAGES:
        if box and stage == "solve":
            continue
        t = best_ms(lambda: run(stage), device, reps)
        work = work_of(stage)
        out["stages"][stage] = {"ms": t, "share": (full - t) / full, **bound(work),
                                "bytes": work[0], "operations": work[1]}
        print(f"  minus {stage:9s}: {t:9.3f} ms -> stage share "
              f"{100 * (full - t) / full:6.2f}% of the tick", file=sys.stderr)
    ranked = sorted(out["stages"].items(), key=lambda kv: -kv[1]["share"])
    print("  top sinks: " + ", ".join(f"{n} {100 * r['share']:.1f}%" for n, r in ranked[:3]),
          file=sys.stderr)
    return out


def sweep(Bs=(1024, 4096, 16384), blocks=(32, 64, 128, 256), T=200, device="cuda", reps=3,
          model="go1"):
    """The tick kernel's time against its threads per block and the fleet
    size, float32, the kernel alone, best of ``reps``, on ``model``'s fleet
    (the tick runs 16 threads per instance, so every block is a multiple of
    16): rows of {B, block, ms, ticks_per_s, roofline}."""
    device = resolve_device(device)
    rows = []
    for B in Bs:
        p, data_b, _, vo = bench_fleet(B, T, device, model=model)
        c = mhe.make_consts(p, F32, device=device)
        ks, d, v, i = tick_inputs(c, data_b, vo)
        del data_b
        work = tick_work(c, ks, d, v, 4)
        for block in blocks:
            ms = best_ms(lambda: mrk.replay_ticks(c, ks, d, v, i, device=device, block=block),
                         device, reps)
            rate = B * (T - 1) / (ms / 1e3)
            print(f"B={B:6d} block={block:4d}: {ms:9.3f} ms, {rate:,.0f} ticks/s",
                  file=sys.stderr)
            rows.append({"B": B, "block": block, "ms": ms, "ticks_per_s": rate,
                         "roofline": report(rate, s=c.dim_state, m=c.dim_meas, L=c.num_legs,
                                             lot=int(c.leg_odom_type)), **bound(work)})
        del ks, d, v, i
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return {"T": T, "model": model, **device_info(device), "rows": rows}


def _union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def trace_capture(B=1024, T=200, device="cuda", out_file=None):
    """A ``torch.profiler`` capture of one run of the Go1 pipeline runner
    (``make_pipeline_fleet_runner(use_megakernel=True)``: EKF kernel,
    orientation, K5 at tick 0, the tick kernel, body velocity) after a warm
    run: device time by kernel, the device's busy share of the profiled
    window (the union of its kernels' intervals) and idle share, and the host
    time per device launch. If the profiler shows no device time on the card,
    CUDA events around the run give its device time instead and the result
    says so. ``out_file`` keeps the Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    p, data_b, eb, vo = bench_fleet(B, T, device)
    run = batch.make_pipeline_fleet_runner(p, EKFParams(), F32, use_megakernel=True,
                                           device=device)
    run(data_b, eb, vo)                                  # builds and warms outside
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(data_b, eb, vo)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if out_file:
        prof.export_chrome_trace(out_file)
    events = prof.events()
    dev_ev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"B": B, "T": T, **device_info(device), "wall_ms": wall_ms,
           "ticks_per_s": B * (T - 1) / (wall_ms / 1e3)}
    launches = [e for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                "cudaLaunchKernelExC")]
    if dev_ev:
        by_kernel = {}
        for e in dev_ev:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        start = min(e.time_range.start for e in events)
        end = max(e.time_range.end for e in events)
        busy = _union_us([(e.time_range.start, e.time_range.end) for e in dev_ev])
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])
        out.update(
            clock="torch.profiler (CUPTI) device events",
            window_ms=(end - start) / 1e3, device_busy_ms=busy / 1e3,
            busy_share=busy / (end - start), idle_share=1 - busy / (end - start),
            device_kernels=len(dev_ev), device_ms_by_kernel=dict(top[:12]),
            device_ms_total=sum(by_kernel.values()),
            host_ms_per_launch=wall_ms / len(dev_ev),
            launch_api_us_mean=(sum(e.time_range.elapsed_us() for e in launches)
                                / len(launches)) if launches else None)
        print(f"trace: wall {wall_ms:.1f} ms, device busy {busy / 1e3:.1f} ms of a "
              f"{(end - start) / 1e3:.1f} ms window ({100 * out['busy_share']:.1f}%), "
              f"{len(dev_ev)} kernels, host {out['host_ms_per_launch']:.3f} ms per launch",
              file=sys.stderr)
        for name, ms in top[:8]:
            print(f"  {ms:10.3f} ms  {name[:90]}", file=sys.stderr)
    elif cuda:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        run(data_b, eb, vo)
        e1.record()
        e1.synchronize()
        out.update(clock="CUDA events around the run: the profiler showed no device time",
                   device_ms_total=e0.elapsed_time(e1), busy_share=None, idle_share=None)
        print(f"trace: the profiler showed no device time; CUDA events around the run: "
              f"{out['device_ms_total']:.1f} ms", file=sys.stderr)
    else:
        top = sorted(((e.key, e.self_cpu_time_total / 1e3) for e in prof.key_averages()),
                     key=lambda kv: -kv[1])
        out.update(host_ms_by_operator=dict(top[:12]), busy_share=None, idle_share=None)
    return out


def bench_box(p, iters, device, polish=True):
    """Constrained consts of the bench's box (``bench.py:371-417``): |v| <=
    0.3, fixed rho 5000, OSQP tolerances 1e-6, ``iters`` ADMM iterations,
    float32."""
    s = p.dim_state
    ub = np.full(s, np.inf)
    ub[3:6] = 0.3
    p.osqp.abs_tol = p.osqp.relative_tol = 1e-6
    p.osqp.rho, p.osqp.adapt_rho, p.osqp.polish = 5000.0, False, polish
    return mhe.make_consts(p, F32, x_lb=-ub, x_ub=ub, admm_iters=iters, use_pallas=True,
                           device=device)


def constrained_sweep(B=1024, T=200, iters_list=(5, 10, 20, 40), device="cuda", reps=3,
                      model="go1"):
    """The constrained tick (K2c, float32, the bench's |v| <= 0.3 box, fixed
    rho 5000, OSQP tolerances 1e-6) at each ADMM budget, with and without
    polish, the kernel alone, best of ``reps``: per row the time, the time per tick
    and the mean iterations the instances ran; the least-squares slope over
    the budget without polish is the cost of one ADMM iteration."""
    device = resolve_device(device)
    p, data_b, _, vo = bench_fleet(B, T, device, model=model)
    rows = []
    for polish in (True, False):
        for iters in iters_list:
            c = bench_box(p, iters, device, polish)
            ks, d, v, i = tick_inputs(c, data_b, vo)
            got = {}

            def run():
                got["ks"] = mrk.replay_ticks(c, ks, d, v, i, device=device)[1]

            ms = best_ms(run, device, reps)
            rows.append({"polish": polish, "iters": iters, "ms": ms,
                         "us_per_tick": ms * 1e3 / (T - 1),
                         "iters_run_mean": float(got["ks"].iters.double().mean())})
            print(f"polish={int(polish)} iters={iters:3d}: {ms:9.3f} ms, "
                  f"{rows[-1]['us_per_tick']:.2f} us per tick, "
                  f"{rows[-1]['iters_run_mean']:.2f} iterations run", file=sys.stderr)
    out = {"B": B, "T": T, "model": model, **device_info(device), "rows": rows}
    free = [(r["iters"], r["us_per_tick"]) for r in rows if not r["polish"]]
    if len(free) >= 2:
        slope, intercept = np.polyfit(*zip(*free), 1)
        polish_us = [r["us_per_tick"] - dict(free)[r["iters"]] for r in rows if r["polish"]]
        out.update(us_per_iteration_per_tick=float(slope), intercept_us_per_tick=float(intercept),
                   polish_us_per_tick=float(np.mean(polish_us)))
        print(f"per ADMM iteration {slope:.3f} us per tick (all {B} instances); intercept "
              f"{intercept:.2f} us; polish adds {out['polish_us_per_tick']:.2f} us",
              file=sys.stderr)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--trace-out", default=None, help="keep the Chrome trace in this file")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--constrained-sweep", action="store_true")
    ap.add_argument("--model", default="go1", choices=MODELS,
                    help="the shape of --sweep, --ablate and --constrained-sweep")
    ap.add_argument("--B", type=int, default=1024)
    ap.add_argument("--T", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rate", type=float, default=None,
                    help="report for a known measured rate (instance ticks per second)")
    a = ap.parse_args(argv)
    results = {}
    with torch.inference_mode():
        if a.rate:
            results["report"] = report(a.rate)
        if a.sweep:
            results["sweep"] = sweep(T=a.T, device=a.device, model=a.model)
        if a.trace:
            results["trace"] = trace_capture(B=a.B, T=a.T, device=a.device,
                                             out_file=a.trace_out)
        if a.ablate:
            results["ablation"] = ablation(B=a.B, T=a.T, device=a.device, model=a.model)
        if a.constrained_sweep:
            results["constrained_sweep"] = constrained_sweep(B=a.B, T=a.T, device=a.device,
                                                             model=a.model)
        if not results:
            results["tick_model"] = tick_model()
    for mode, res in results.items():
        print(json.dumps({mode: res}), flush=True)
    return results


if __name__ == "__main__":
    main()
