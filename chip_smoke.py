#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: python3 chip_smoke.py

Needs one NVIDIA GPU, nvcc, and nothing else: it builds the CUDA kernels from
``decentralized_ekf_mhe_tpu_torch/csrc``, holds each against its plain PyTorch
version on the card at a small size (split log, both forms of the measured
quaternion, a ragged fleet), drives the Go1 EKF→MHE fleet pipeline
(``parallel.batch.make_pipeline_fleet_runner(use_megakernel=True)``) at full
width — N=20, s=9, m=12, EKF ring 16, T=2000 ticks, B=1024 instances, float32,
with the full Monte-Carlo sensor perturbation — and then holds each kernel
against its plain version again at that full size, in float64 element-wise
and in float32 by accuracy, timing both.

The same pipeline then runs with state box constraints (|v| <= 0.3, which
binds on this log): the box-ADMM kernels at the small size against their plain
versions (fixed and adaptive rho, shared and per-lane bounds, warm-up mask,
warm starts, a ragged fleet, split log), the constrained main path at full
size in float32 and float64, the per-lane bound sweep, the adaptive-rho
setting with one ``admm_solve`` launch per tick, and the constrained kernels
against their plain versions at full width: float64 element-wise at reduced
depth, float32 at full depth by accuracy (the eager plain version of a
constrained tick is thousands of small launches).

Any failed check ends the run with a non-zero exit code. Each phase prints one
JSON line; the line before the last lists every kernel, the last line is the
verdict.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

from decentralized_ekf_mhe_tpu_torch.config import EKFParams, EstimatorParams
from decentralized_ekf_mhe_tpu_torch.io import synth
from decentralized_ekf_mhe_tpu_torch.kernels import _build, _work
from decentralized_ekf_mhe_tpu_torch.kernels import admm_kernel, ekf_kernel, tridiag_kernel
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import admm, ekf_lanes, estimator, mhe, mhe_lanes
from decentralized_ekf_mhe_tpu_torch.parallel import batch

DEV = torch.device("cuda")
F32, F64 = torch.float32, torch.float64

# main-path size (the headline fleet of the reference's bench)
N_WIN, T_MAIN, B_MAIN, RING = 20, 2000, 1024, 16
SKIP = 100            # warm-up ticks left out of the RMSE
# small size of the split-log, shared-quaternion and ragged-fleet checks (the
# eager plain versions are Python loops of thousands of small launches)
T_CHK, B_CHK, B_RAGGED, T_RAGGED = 64, 256, 1000, 24

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 3.35 TB/s,
# 67 TFLOP/s float32 outside the tensor cores
PEAK_BYTES_S, PEAK_F32_FLOPS = 3.35e12, 67e12

# tolerances: as the reference's tests hold each kernel against its scan at
# float64 (EKF rtol 1e-10/atol 1e-12; MHE and tridiagonal rtol 1e-8/atol 1e-8)
TOL_EKF = dict(rtol=1e-10, atol=1e-12)
TOL_MHE = dict(rtol=1e-8, atol=1e-8)
# unconverged box-ADMM iterates after rho has adapted during the solve, as a
# share of the output's largest magnitude (see check_admm): three times what
# the plain version itself moves by between a GPU and a CPU (3.3e-7, PERF.md)
TOL_ADAPT = 1e-6

# the constrained path: the velocity box of the reference's bench, the depth of
# the one-launch-per-tick run, and the depth at which the constrained tick is
# held against its eager plain version at full width in float64 (6 ring wraps)
V_BOX, T_PER_TICK, T_BOX_PLAIN = 0.3, 200, 120


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def go1_params(N=N_WIN):
    return EstimatorParams(
        num_legs=4, leg_odom_type=0, rate=200, N=N,
        p_process_std=[0.001] * 3, accel_input_std=[0.025, 0.025, 0.02],
        gyro_input_std=[0.03] * 3, accel_bias_std=[0.07, 0.02, 0.03],
        joint_position_std=[0.04] * 3, joint_velocity_std=[0.22] * 3,
        foot_slide_std=[0.003] * 3, foot_swing_std=[1e7] * 3,
        vo_p_std=[1.5e-5] * 3,
    )


def make_fleet(T, B, dtype, seed, vo_noise=1.0):
    """One synthetic log tiled into a perturbed B-instance fleet on the card:
    per-lane IMU/encoder noise, per-lane VO quaternion into the EKF, per-lane
    VO translation into the MHE, one shared camera clock."""
    p, pe = go1_params(), EKFParams()
    log = synth.generate(synth.SynthConfig(T=T, seed=0))
    g = torch.Generator(device=DEV).manual_seed(seed)
    data = estimator.tickdata_from_log(log, dtype=dtype, device=DEV)
    vo = estimator.vodata_from_log(log, dtype=dtype, device=DEV)
    data_b = batch.to_time_leading(batch.perturb_log_batch(data, B, g, p, dtype=dtype))
    eb = batch.perturb_ekf_blocks(
        estimator.ekfblocks_from_log(log, dtype=dtype, device=DEV), B, g, p,
        dtype=dtype, vo_noise_scale=vo_noise, ekf_params=pe)
    eb = eb._replace(gyro=eb.gyro.contiguous(), accel=eb.accel.contiguous())
    vo_b = batch.perturb_vo_batch(vo, B, g, p, dtype=dtype)
    return log, data_b, eb, vo_b


def cast(nt, dtype):
    """Cast the float leaves of a NamedTuple of tensors to ``dtype``."""
    return type(nt)(*((a.to(dtype) if a.is_floating_point() else a).contiguous()
                      for a in nt))


def close(a, b, rtol, atol):
    err = (a - b).abs()
    ok = bool((err <= atol + rtol * b.abs()).all()) and bool(torch.isfinite(a).all())
    return ok, float(err.max())


def timed(fn, reps=3):
    """Best-of-reps device time of fn() in ms (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best


def mhe_inputs(c, data_l, vo, dtype):
    """Tick-0 state and the per-tick inputs of ``mrk.replay_ticks`` for a
    whole log, exactly as ``mrk.replay`` prepares them."""
    d0 = estimator.TickData(*(a[0] for a in data_l))
    st0 = mhe_lanes.init(c, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot,
                         d0.J_foot, d0.dq, d0.contact, dtype=dtype, device=DEV)
    vo_inc = estimator.vo_world_increments(data_l.R_sb, vo)
    return st0, vo_inc


def seg(data_l, vo, vo_inc, sl):
    return (estimator.TickData(*(a[sl].contiguous() for a in data_l)),
            estimator.VOData(*(a[sl] for a in vo)), vo_inc[sl].contiguous())


def vel_rmse(x_tsb, ref_tsb, skip=0):
    return float(torch.sqrt(((x_tsb[skip:, 3:6].double() - ref_tsb[skip:, 3:6].double()) ** 2).mean()))


# ---------------------------------------------------------------- phases


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    assert smi.returncode == 0, smi.stderr
    card = smi.stdout.strip().splitlines()[0]
    emit("device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return card


def phase_build():
    t0 = time.time()
    _build.build(verbose=False)
    for name in _build.SOURCES:
        _build.load(name)
    emit("build", seconds=round(time.time() - t0, 2), sources=list(_build.SOURCES),
         flags=" ".join(_build.NVCC_FLAGS))


def check_kernels():
    """Kernel vs plain version on the card at the small size, float64,
    identical inputs, the reference's tolerances: both forms of the measured
    quaternion, split-log resume, a ragged fleet. The plain side is PyTorch
    only (its window solves do not go through the tridiagonal kernel)."""
    p, pe = go1_params(), EKFParams()
    res = {}
    log, data_b, eb_l, vo_b = make_fleet(T_CHK, B_CHK, F64, seed=1, vo_noise=1.0)
    ec = ekf_lanes.make_consts(pe, F64)
    st = ekf_lanes.init_state(pe, B_CHK, RING, F64, device=DEV)

    # ---- K1 ekf_stage: per-lane and shared measured quaternion, split log
    _, _, eb_s, _ = make_fleet(T_CHK, B_CHK, F64, seed=1, vo_noise=0.0)
    errs = {}
    for tag, eb in (("per_lane_vo_q", eb_l), ("shared_vo_q", eb_s)):
        q_p, fin_p = ekf_kernel.replay_plain(ec, st, eb)
        q_k, fin_k = ekf_kernel.replay(ec, st, eb, device=DEV)
        ok, err = close(q_k, q_p, **TOL_EKF)
        ok2, err2 = close(fin_k.P_hist, fin_p.P_hist, **TOL_EKF)
        assert ok and ok2 and fin_k.t == fin_p.t, (tag, err, err2, fin_k.t, fin_p.t)
        errs[tag] = max(err, err2)
        if tag == "per_lane_vo_q":
            cut = 25
            ebA = estimator.EKFBlocks(*(a[:cut].contiguous() for a in eb))
            ebB = estimator.EKFBlocks(*(a[cut:].contiguous() for a in eb))
            qA, stA = ekf_kernel.replay(ec, st, ebA, device=DEV)
            qB, _ = ekf_kernel.replay(ec, stA, ebB, device=DEV)
            ok, err = close(torch.cat([qA, qB]), q_p, **TOL_EKF)
            assert ok, ("ekf split-log resume", err)
            errs["split_log"] = err
            q_seq = q_p
    res["ekf_err"] = errs

    # ---- K2 mhe_tick: VO events, marginalization (T > N), split log
    c = mhe.make_consts(p, F64, use_pallas=False, device=DEV)
    data_l = batch.tickdata_to_lanes(data_b)._replace(R_sb=ekf_lanes.to_rot(q_seq))
    st0, vo_inc = mhe_inputs(c, data_l, vo_b, F64)
    ks0 = mrk.kernel_state_from_mhe(st0, c)
    d1, v1, i1 = seg(data_l, vo_b, vo_inc, slice(1, None))
    x_p, ks_p = mrk.replay_ticks_plain(c, ks0, d1, v1, i1)
    x_k, ks_k = mrk.replay_ticks(c, ks0, d1, v1, i1, device=DEV)
    ok, err = close(x_k, x_p, **TOL_MHE)
    assert ok, ("mhe_tick vs plain", err)
    errs = {"x": err}
    dA, vA, iA = seg(data_l, vo_b, vo_inc, slice(1, 30))
    dB, vB, iB = seg(data_l, vo_b, vo_inc, slice(30, None))
    xA, ksA = mrk.replay_ticks(c, ks0, dA, vA, iA, device=DEV)
    xB, ksB = mrk.replay_ticks(c, ksA, dB, vB, iB, device=DEV)
    ok, err = close(torch.cat([xA, xB]), x_p, **TOL_MHE)
    assert ok and ksB.t == ks_p.t == T_CHK - 1, ("mhe split-log resume", err)
    errs["split_log"] = err
    # a resumed kernel state continues identically in the plain version
    xBp, _ = mrk.replay_ticks_plain(c, ksA, dB, vB, iB)
    ok, err = close(xB, xBp, **TOL_MHE)
    assert ok, ("plain version from a kernel state", err)
    errs["plain_from_kernel_state"] = err
    assert int(v1.active.sum()) > 0 and T_CHK > N_WIN
    res["mhe_err"] = errs

    # ---- K5 tridiag_solve: the tick-0 system and a full late window
    errs = {}
    for tag, st_w in (("tick0_window", st0),
                      ("full_window", mrk.mhe_state_from_kernel(ks_k, c))):
        D, U, r = (a.contiguous() for a in mhe_lanes._masked_system(c, st_w))
        x_pl = tridiag_kernel.solve_lanes_plain(D, U, r)
        x_kn = tridiag_kernel.solve_lanes(D, U, r, device=DEV)
        ok, err = close(x_kn, x_pl, **TOL_MHE)
        assert ok, ("tridiag_solve vs plain", tag, err)
        errs[tag] = err
    # the kernel's newest state equals the full solve's last slot
    ok, err = close(x_kn[-1], x_k[-1], **TOL_MHE)
    assert ok, ("mhe_tick newest state vs full window solve", err)
    res["tridiag_err"] = errs

    # ---- ragged edge: B not a multiple of the block, whole pipeline
    _, data_r, eb_r, vo_r = make_fleet(T_RAGGED, B_RAGGED, F64, seed=2)
    run_k = batch.make_pipeline_fleet_runner(p, pe, F64, use_megakernel=True, device=DEV)
    run_p = batch.make_pipeline_fleet_runner(p, pe, F64, use_pallas=False,
                                             use_megakernel=False, device=DEV)
    xk, vk, qk = run_k(data_r, eb_r, vo_r)
    xp, vp, qp = run_p(data_r, eb_r, vo_r)
    okq, eq = close(qk, qp, **TOL_EKF)
    okx, ex = close(xk, xp, **TOL_MHE)
    okv, ev = close(vk, vp, **TOL_MHE)
    assert okq and okx and okv, ("ragged B", eq, ex, ev)
    res["ragged_err"] = {"B": B_RAGGED, "T": T_RAGGED, "q": eq, "x": ex, "v": ev}
    emit("kernels", dtype="float64", N=N_WIN, T=T_CHK, B=B_CHK,
         tol_ekf=TOL_EKF, tol_mhe_tridiag=TOL_MHE, **res)


def main_path(fleet64, fleet32, gt_v):
    """The slice at full width through its entry point; returns the launch
    counts of that one float32 run and the float64 run's (x, q)."""
    p, pe = go1_params(), EKFParams()
    data_b, eb, vo_b = fleet32
    runner = batch.make_pipeline_fleet_runner(p, pe, F32, use_megakernel=True, device=DEV)

    reset_counts()
    x, v, q = runner(data_b, eb, vo_b)
    torch.cuda.synchronize()
    counts = read_counts()
    assert counts == {"tridiag_solve": 1, "ekf_stage": 1, "mhe_tick": 1,
                      "mhe_tick_box": 0, "admm_solve": 0, "admm_box_solve": 0}, counts

    assert x.shape == (T_MAIN, B_MAIN, 9) and v.shape == (T_MAIN, B_MAIN, 3) and q.shape == (T_MAIN, 4, B_MAIN)
    assert torch.isfinite(x).all() and torch.isfinite(v).all() and torch.isfinite(q).all()
    rmse = fleet_rmse(x, gt_v)
    assert rmse < 0.1, f"fleet velocity RMSE vs ground truth {rmse}"

    # float64 run of the same path on the same fleet
    run64 = batch.make_pipeline_fleet_runner(p, pe, F64, use_megakernel=True, device=DEV)
    x64, _, q64 = run64(*fleet64)
    r64 = fleet_rmse(x64, gt_v)
    assert abs(rmse - r64) < 1e-3, ("f32-vs-f64 velocity-RMSE delta", rmse, r64)

    # wall time of the whole pipeline: best of 3 after the warm-up above
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        runner(data_b, eb, vo_b)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    wall = min(walls)
    emit("main_path", config="Go1 N=20 s=9 m=12 L=4 ring=16", T=T_MAIN, B=B_MAIN,
         dtype="float32", launches=counts, rmse_vs_ground_truth=rmse,
         rmse_f64=r64, f64_instances=B_MAIN, wall_s=wall, walls_s=walls,
         pipeline_ticks_per_s=B_MAIN * (T_MAIN - 1) / wall,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    return counts, x64, q64


def reset_counts():
    for mod in (tridiag_kernel, ekf_kernel, mrk, admm_kernel):
        mod.launches = 0
    mrk.launches_box = admm_kernel.launches_core = 0


def read_counts():
    return {"tridiag_solve": tridiag_kernel.launches, "ekf_stage": ekf_kernel.launches,
            "mhe_tick": mrk.launches, "mhe_tick_box": mrk.launches_box,
            "admm_solve": admm_kernel.launches,
            "admm_box_solve": admm_kernel.launches_core}


def fleet_rmse(x_tbs, gt_v):
    """Fleet velocity RMSE of x (T,B,s) against the log's ground truth."""
    err = x_tbs[SKIP:, :, 3:6].double() - gt_v[SKIP:, None]
    return float(torch.sqrt((err ** 2).mean()))


def stage_inputs(p, fleet, q_seq, dtype):
    """What the three kernel wrappers receive on the main path for ``fleet``,
    with the orientation ``q_seq`` feeding the MHE stage."""
    data_b, eb, vo_b = fleet
    c = mhe.make_consts(p, dtype, use_pallas=False, device=DEV)
    data_l = batch.tickdata_to_lanes(data_b)._replace(R_sb=ekf_lanes.to_rot(q_seq))
    st0, vo_inc = mhe_inputs(c, data_l, vo_b, dtype)
    tri = tuple(a.contiguous() for a in mhe_lanes._masked_system(c, st0))
    ks0 = mrk.kernel_state_from_mhe(st0, c)
    return c, tri, ks0, seg(data_l, vo_b, vo_inc, slice(1, None))


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.time() - t0) * 1e3


def full_size(fleet64, fleet32, x64_main, q64_main, counts):
    """Each kernel against its plain version at the main path's own size
    (T=2000, B=1024, N=20) on identical inputs, and the whole float64 main
    path against the chain of plain versions: float64 by the reference's
    tolerances, float32 by the velocity-RMSE gate; the kernels' and the plain
    versions' float32 times at that size; the bounds from this run's inputs."""
    p, pe = go1_params(), EKFParams()
    err, ms, plain_ms = {}, {}, {}

    # ---- float64, element-wise
    ec = ekf_lanes.make_consts(pe, F64)
    st = ekf_lanes.init_state(pe, B_MAIN, RING, F64, device=DEV)
    eb = fleet64[1]
    (q_p, fin_p), ekf_plain64_ms = wall_ms(lambda: ekf_kernel.replay_plain(ec, st, eb))
    q_k, fin_k = ekf_kernel.replay(ec, st, eb, device=DEV)
    ok, e1 = close(q_k, q_p, **TOL_EKF)
    ok2, e2 = close(fin_k.P_hist, fin_p.P_hist, **TOL_EKF)
    assert ok and ok2 and fin_k.t == fin_p.t, ("ekf_stage at full size", e1, e2)
    err["ekf_stage"] = max(e1, e2)

    c, tri, ks0, (d1, v1, i1) = stage_inputs(p, fleet64, q_p, F64)
    (x_p, _), mhe_plain64_ms = wall_ms(lambda: mrk.replay_ticks_plain(c, ks0, d1, v1, i1))
    x_k, ks_k = mrk.replay_ticks(c, ks0, d1, v1, i1, device=DEV)
    ok, e = close(x_k, x_p, **TOL_MHE)
    assert ok, ("mhe_tick at full size", e)
    err["mhe_tick"] = e

    tri_late = tuple(a.contiguous() for a in mhe_lanes._masked_system(
        c, mrk.mhe_state_from_kernel(ks_k, c)))
    errs = []
    for D, U, r in (tri, tri_late):
        ok, e = close(tridiag_kernel.solve_lanes(D, U, r, device=DEV),
                      tridiag_kernel.solve_lanes_plain(D, U, r), **TOL_MHE)
        assert ok, ("tridiag_solve at full size", e)
        errs.append(e)
    err["tridiag_solve"] = max(errs)

    # the float64 main path (EKF kernel -> tridiagonal kernel at tick 0 ->
    # MHE kernel) against the chain of plain versions
    x0_p = tridiag_kernel.solve_lanes_plain(*tri)[-1]
    okq, eq = close(q64_main, q_p, **TOL_EKF)
    okx, ex = close(torch.movedim(x64_main, 1, -1), torch.cat([x0_p[None], x_p]), **TOL_MHE)
    assert okq and okx, ("float64 main path vs plain chain", eq, ex)
    err["main_path_f64"] = {"q": eq, "x": ex}

    # ---- float32: same inputs cast; times of kernel and plain version
    ec32 = ekf_lanes.make_consts(pe, F32)
    st32 = ekf_lanes.init_state(pe, B_MAIN, RING, F32, device=DEV)
    eb32 = fleet32[1]
    (q32p, _), plain_ms["ekf_stage"] = wall_ms(lambda: ekf_kernel.replay_plain(ec32, st32, eb32))
    q32k, _ = ekf_kernel.replay(ec32, st32, eb32, device=DEV)
    ms["ekf_stage"] = timed(lambda: ekf_kernel.replay(ec32, st32, eb32, device=DEV))
    assert torch.isfinite(q32k).all()
    dq_k, dq_p = float((q32k.double() - q_p).abs().max()), float((q32p.double() - q_p).abs().max())
    assert abs(dq_k - dq_p) < 1e-3, (dq_k, dq_p)

    c32, tri32, ks32, (d32, v32, i32) = stage_inputs(p, fleet32, q_p.to(F32), F32)
    (x32p, _), plain_ms["mhe_tick"] = wall_ms(lambda: mrk.replay_ticks_plain(c32, ks32, d32, v32, i32))
    x32k, _ = mrk.replay_ticks(c32, ks32, d32, v32, i32, device=DEV)
    mrk.timer.on = True
    ms["mhe_tick"] = timed(lambda: mrk.replay_ticks(c32, ks32, d32, v32, i32, device=DEV), reps=2)
    mrk.timer.on = False
    kernel_only_ms = min(mrk.timer.ms())
    assert torch.isfinite(x32k).all()
    rk, rp = vel_rmse(x32k, x_p, SKIP), vel_rmse(x32p, x_p, SKIP)
    assert abs(rk - rp) < 1e-3, ("f32 velocity-RMSE delta", rk, rp)
    ms["tridiag_solve"] = timed(lambda: tridiag_kernel.solve_lanes(*tri32, device=DEV))
    plain_ms["tridiag_solve"] = timed(lambda: tridiag_kernel.solve_lanes_plain(*tri32))

    emit("full_size", T=T_MAIN, B=B_MAIN, N=N_WIN, tol_ekf=TOL_EKF,
         tol_mhe_tridiag=TOL_MHE, max_abs_err_f64=err,
         plain_f64_ms={"ekf_stage": ekf_plain64_ms, "mhe_tick": mhe_plain64_ms},
         f32={"ekf_q_err_kernel": dq_k, "ekf_q_err_plain": dq_p,
              "mhe_vel_rmse_vs_f64_kernel": rk, "mhe_vel_rmse_vs_f64_plain": rp},
         kernel_f32_ms=ms, plain_f32_ms=plain_ms,
         mhe_tick_kernel_only_ms=kernel_only_ms)

    # bounds from this run's inputs: the schedule the kernels walked, the
    # stance legs they saw, the tick-0 window's single real slot
    n_valid, n_replayed, n_vo = _work.ekf_schedule(
        eb32.valid.tolist(), eb32.vo_active.tolist(), eb32.vo_steps_back.tolist(), RING)
    sched = _work.mhe_schedule(v32.active.tolist(), v32.tick_pre.tolist(),
                               v32.tick_now.tolist(), N_WIN, int(ks32.bez_count))
    works = {
        "tridiag_solve": _work.tridiag(N_WIN, 9, B_MAIN, 4, n_states=1),
        "ekf_stage": _work.ekf(T_MAIN, B_MAIN, RING, n_valid, n_replayed, n_vo,
                               eb32.vo_q.ndim == 4, 4, quirk_W=ec32.quirk_W),
        "mhe_tick": _work.mhe_tick(N_WIN, 9, 12, 4, B_MAIN, sched,
                                   int((d32.contact > 0).sum()), 4),
    }
    return kernel_rows({
        "tridiag_solve": ("decentralized_ekf_mhe_tpu_torch/csrc/tridiag.cu",
                          "decentralized_ekf_mhe_tpu/pallas/tridiag_kernel.py:213"),
        "ekf_stage": ("decentralized_ekf_mhe_tpu_torch/csrc/ekf.cu",
                      "decentralized_ekf_mhe_tpu/pallas/ekf_kernel.py:370"),
        "mhe_tick": ("decentralized_ekf_mhe_tpu_torch/csrc/mhe.cu",
                     "decentralized_ekf_mhe_tpu/pallas/mhe_replay_kernel.py:917"),
    }, works, counts, err, ms, plain_ms)


def kernel_rows(meta, works, counts, err, ms, plain_ms, **more):
    """One entry of the ``kernels`` line per kernel of ``meta`` (name ->
    (source, TPU kernel it replaces)); ``more`` adds per-kernel extra keys."""
    kernels = []
    for name, (src, repl) in meta.items():
        nbytes, ops = works[name]
        t_b, t_f = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": counts[name], "max_abs_err": err[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations",
            "library_ms": None,
            # every number is taken at this shape on identical inputs: ms and
            # plain_ms in float32, max_abs_err (kernel vs plain) in float64
            "shape": {"T": T_MAIN, "B": B_MAIN, "N": N_WIN},
            "ms_dtype": "float32", "max_abs_err_dtype": "float64",
            "bytes": nbytes, "operations": ops,
            **more.get(name, {}),
        })
    return kernels


# ------------------------------------------------- the constrained path


def box_params(adaptive=False, tol=1e-6):
    """Go1 params with the OSQP settings of the constrained bench: fixed
    rho=5000 with polish (the production budget), or the default adaptive rho."""
    p = go1_params()
    p.osqp.abs_tol = p.osqp.relative_tol = tol
    if not adaptive:
        p.osqp.rho, p.osqp.adapt_rho, p.osqp.polish = 5000.0, False, True
    return p


def box_consts(p, dtype, bound, iters, use_pallas=True):
    """MHE consts with the velocity box ±bound on states 3:6; ``bound`` is a
    float (shared (s,) bounds) or a (B,) tensor (per-lane (s,B) bounds)."""
    per_lane = torch.is_tensor(bound)
    shape = (9, bound.shape[0]) if per_lane else (9,)
    ub = torch.full(shape, float("inf"), dtype=dtype, device=DEV)
    ub[3:6] = bound.to(dtype) if per_lane else bound
    return mhe.make_consts(p, dtype, x_lb=-ub, x_ub=ub, admm_iters=iters,
                           use_pallas=use_pallas, device=DEV)


def check_admm(tag, D, U, r, lb, ub, settings, **kw):
    """admm_solve kernel vs its plain version on one system. Iteration counts
    equal, and x, z, y within TOL_MHE — except the unconverged iterates of a
    solve during which rho adapted (z and y always; x too without the
    polish): the rho rule divides two residuals that are differences of nearly
    equal numbers, so a change of summation order moves those iterates by more
    than 1e-8 (the plain version itself does not reproduce them between a GPU
    and a CPU, PERF.md). They are held to atol + TOL_ADAPT times the output's
    largest magnitude instead.
    Returns ({field: error}, {loosened field: its limit}, result)."""
    res_p = admm_kernel.solve_box_lanes_plain(D, U, r, lb, ub, settings, **kw)
    res_k = admm_kernel.solve_box_lanes(D, U, r, lb, ub, settings, device=DEV, **kw)
    assert torch.equal(res_k.iters, res_p.iters), ("admm_solve iteration counts", tag)
    rho_adapts = settings.adaptive_rho and settings.iters > settings.rho_update_every
    loose = (("z", "y") if settings.polish else ("x", "z", "y")) if rho_adapts else ()
    errs, limits = {}, {}
    for f in ("x", "z", "y"):
        k, p = getattr(res_k, f), getattr(res_p, f)
        ok, errs[f] = close(k, p, **TOL_MHE)
        if f in loose:
            limits[f] = TOL_MHE["atol"] + TOL_ADAPT * float(p.abs().max())
            ok = bool(torch.isfinite(k).all()) and errs[f] <= limits[f]
        assert ok, ("admm_solve vs plain", tag, f, errs, limits)
    return errs, limits, res_k


def check_box_tick(c, c_plain, ks0, d, v, i, tag):
    """Constrained mhe_tick kernel vs its plain version over the ticks handed
    in: x, the z/y warm-start rings and the per-tick iteration counts."""
    x_p, ks_p = mrk.replay_ticks_plain(c_plain, ks0, d, v, i)
    x_k, ks_k = mrk.replay_ticks(c, ks0, d, v, i, device=DEV)
    errs = {}
    for f, a, b in (("x", x_k, x_p), ("z", ks_k.arrays[18], ks_p.arrays[18]),
                    ("y", ks_k.arrays[19], ks_p.arrays[19])):
        ok, errs[f] = close(a, b, **TOL_MHE)
        assert ok, ("mhe_tick_box vs plain", tag, f, errs[f])
    assert torch.equal(ks_k.iters, ks_p.iters), ("mhe_tick_box iteration counts", tag)
    return x_k, ks_k, x_p, errs


def box_small_setup():
    """Inputs of the small-size constrained checks (T_CHK, B_CHK, float64, OSQP
    tolerances 1e-8): the fleet with the EKF kernel's orientation, a box that
    binds (half the unconstrained run's largest |v|), consts with shared and
    with per-lane bounds (fixed rho, 20 iterations, polish), the tick-0 state.
    Returns (bound, lane_bound, c, c_pl, data_l, vo_b, vo_inc, ks0)."""
    pe = EKFParams()
    log, data_b, eb, vo_b = make_fleet(T_CHK, B_CHK, F64, seed=1)
    ec = ekf_lanes.make_consts(pe, F64)
    st = ekf_lanes.init_state(pe, B_CHK, RING, F64, device=DEV)
    q_seq, _ = ekf_kernel.replay(ec, st, eb, device=DEV)
    data_l = batch.tickdata_to_lanes(data_b)._replace(R_sb=ekf_lanes.to_rot(q_seq))
    x_free = mrk.replay(mhe.make_consts(go1_params(), F64, device=DEV), data_l, vo_b,
                        dtype=F64, device=DEV)
    bound = 0.5 * float(x_free[:, 3:6].abs().max())
    p = box_params(tol=1e-8)
    c = box_consts(p, F64, bound, 20)
    lane_bound = torch.linspace(0.4 * bound, 1.2 * bound, B_CHK, dtype=F64, device=DEV)
    c_pl = box_consts(p, F64, lane_bound, 20)
    st0, vo_inc = mhe_inputs(c, data_l, vo_b, F64)
    return (bound, lane_bound, c, c_pl, data_l, vo_b, vo_inc,
            mrk.kernel_state_from_mhe(st0, c))


def admm_cases(c, c_pl, ks0, ks_k, first_ticks):
    """(tag, operands, keywords) of the admm_solve checks on assembled
    windows: the full final window of state ``ks_k`` with the ring's warm
    starts, and a warm-up window (after ``first_ticks`` from ``ks0``) through
    the valid mask; fixed and adaptive rho, shared and per-lane bounds,
    budgets that end inside an epoch, a ragged fleet."""
    st_full = mrk.mhe_state_from_kernel(ks_k, c)
    D, U, r = (a.contiguous() for a in mhe_lanes._masked_system(c, st_full))
    _, ks5 = mrk.replay_ticks(c, ks0, *first_ticks, device=DEV)
    st5 = mrk.mhe_state_from_kernel(ks5, c)
    D5, U5, r5, valid5 = mhe_lanes.assemble_normal_equations(c, st5)
    D5, U5, r5 = D5.contiguous(), U5[:-1].contiguous(), r5.contiguous()
    assert not bool(valid5.all())
    fixed = c.admm
    adaptive = admm.ADMMSettings.from_osqp(box_params(adaptive=True, tol=1e-8).osqp, 50)
    lb_pl, ub_pl = c_pl.x_lb, c_pl.x_ub
    tile = lambda a, n: torch.cat([a] * (-(-n // a.shape[-1])), dim=-1)[..., :n].contiguous()
    return [
        ("fixed_rho_20_warm", (D, U, r, c.x_lb, c.x_ub, fixed),
         dict(z0=st_full.z_adm.contiguous(), y0=st_full.y_adm.contiguous())),
        ("adaptive_50_per_lane", (D, U, r, lb_pl, ub_pl, adaptive), {}),
        ("adaptive_50_valid_warm", (D5, U5, r5, c.x_lb, c.x_ub, adaptive),
         dict(valid=valid5, z0=st5.z_adm.contiguous(), y0=st5.y_adm.contiguous())),
        ("fixed_rho_valid", (D5, U5, r5, lb_pl, ub_pl, fixed), dict(valid=valid5)),
        ("adaptive_25_of_10", (D, U, r, c.x_lb, c.x_ub, adaptive._replace(iters=25)), {}),
        ("adaptive_7_of_10", (D, U, r, c.x_lb, c.x_ub, adaptive._replace(iters=7)), {}),
        ("no_check_no_polish", (D, U, r, c.x_lb, c.x_ub,
                                adaptive._replace(abs_tol=0.0, rel_tol=0.0, polish=False)), {}),
        ("ragged_B", (tile(D, B_RAGGED), tile(U, B_RAGGED), tile(r, B_RAGGED),
                      tile(lb_pl, B_RAGGED), tile(ub_pl, B_RAGGED), adaptive), {}),
    ]


def check_kernels_box():
    """The box-ADMM kernels against their plain versions at the small size,
    float64, OSQP tolerances 1e-8, on real assembled windows."""
    bound, lane_bound, c, c_pl, data_l, vo_b, vo_inc, ks0 = box_small_setup()
    res = {"box": bound}

    # ---- K2c mhe_tick (constrained): fixed rho, 20 iterations, polish
    c_plain = c._replace(use_pallas=False)
    d1, v1, i1 = seg(data_l, vo_b, vo_inc, slice(1, None))
    x_k, ks_k, x_p, errs = check_box_tick(c, c_plain, ks0, d1, v1, i1, "shared bounds")
    vmax = float(x_k[:, 3:6].abs().max())
    assert bound - 1e-6 <= vmax <= bound + 1e-3, ("box not active or violated", vmax, bound)
    dA, vA, iA = seg(data_l, vo_b, vo_inc, slice(1, 30))
    dB, vB, iB = seg(data_l, vo_b, vo_inc, slice(30, None))
    xA, ksA = mrk.replay_ticks(c, ks0, dA, vA, iA, device=DEV)
    xB, ksB = mrk.replay_ticks(c, ksA, dB, vB, iB, device=DEV)
    ok, errs["split_log"] = close(torch.cat([xA, xB]), x_p, **TOL_MHE)
    assert ok and ksB.t == T_CHK - 1, ("constrained split-log resume", errs["split_log"])
    xBp, _ = mrk.replay_ticks_plain(c_plain, ksA, dB, vB, iB)
    ok, errs["plain_from_kernel_state"] = close(xB, xBp, **TOL_MHE)
    assert ok, ("plain version from a constrained kernel state", errs["plain_from_kernel_state"])
    # per-lane bounds through the same kernel
    ks0_pl = mrk.kernel_state_from_mhe(mhe_inputs(c_pl, data_l, vo_b, F64)[0], c_pl)
    x_pl, _, _, e_pl = check_box_tick(c_pl, c_pl._replace(use_pallas=False), ks0_pl,
                                      dA, vA, iA, "per-lane bounds")
    assert bool((x_pl[:, 3:6].abs().amax(dim=(0, 1)) <= lane_bound + 1e-3).all())
    errs["per_lane_bounds"] = max(e_pl.values())
    res["mhe_box_err"] = errs

    # ---- K4 admm_solve on assembled windows
    cases = admm_cases(c, c_pl, ks0, ks_k, seg(data_l, vo_b, vo_inc, slice(1, 6)))
    errs = {}
    for tag, args, kw in cases:
        e, limits, res_k = check_admm(tag, *args, **kw)
        errs[tag] = dict(e, iters=[int(res_k.iters.min()), int(res_k.iters.max())])
        if limits:
            errs[tag]["limit_where_rho_adapted"] = limits
    res["admm_err"] = errs
    emit("kernels_box", dtype="float64", N=N_WIN, T=T_CHK, B=B_CHK, B_ragged=B_RAGGED,
         tol=TOL_MHE, tol_adaptive_rho_iterates_over_max_abs=TOL_ADAPT, osqp_tol=1e-8,
         **res)


def box_main_path(fleet64, fleet32, gt_v):
    """The constrained production pipeline at full size through its entry
    point: fixed rho=5000, 20 iterations + polish, |v| <= 0.3."""
    pe = EKFParams()
    p = box_params()
    data_b, eb, vo_b = fleet32
    runner = batch.make_pipeline_fleet_runner(
        p, pe, F32, use_megakernel=True, consts=box_consts(p, F32, V_BOX, 20), device=DEV)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    x, v, q = runner(data_b, eb, vo_b)
    torch.cuda.synchronize()
    counts = read_counts()
    assert counts == {"tridiag_solve": 0, "ekf_stage": 1, "mhe_tick": 0,
                      "mhe_tick_box": 1, "admm_solve": 1, "admm_box_solve": 2}, counts

    assert x.shape == (T_MAIN, B_MAIN, 9) and v.shape == (T_MAIN, B_MAIN, 3)
    assert torch.isfinite(x).all() and torch.isfinite(v).all() and torch.isfinite(q).all()
    vmax = float(x[..., 3:6].abs().max())
    assert V_BOX - 1e-2 <= vmax <= V_BOX + 1e-3, ("velocity box", vmax)
    rmse = fleet_rmse(x, gt_v)
    assert rmse < 0.1, f"constrained fleet velocity RMSE vs ground truth {rmse}"

    run64 = batch.make_pipeline_fleet_runner(
        p, pe, F64, use_megakernel=True, consts=box_consts(p, F64, V_BOX, 20), device=DEV)
    x64, _, q64 = run64(*fleet64)
    r64 = fleet_rmse(x64, gt_v)
    vmax64 = float(x64[..., 3:6].abs().max())
    assert abs(rmse - r64) < 1e-3, ("constrained f32-vs-f64 velocity-RMSE delta", rmse, r64)

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        runner(data_b, eb, vo_b)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    wall = min(walls)
    emit("box_main_path", config="Go1 N=20 s=9 m=12 L=4 ring=16, |v|<=0.3, rho=5000 fixed, 20 it + polish",
         T=T_MAIN, B=B_MAIN, dtype="float32", launches=counts, max_abs_v=vmax,
         max_abs_v_f64=vmax64, rmse_vs_ground_truth=rmse, rmse_f64=r64, wall_s=wall,
         walls_s=walls, pipeline_ticks_per_s=B_MAIN * (T_MAIN - 1) / wall,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    return counts, x64, q64


def box_sweep(fleet32):
    """Per-lane bound sweep: every lane its own box, one launch."""
    p = box_params()
    data_b, _, vo_b = fleet32
    bnds = torch.linspace(0.25, 0.42, B_MAIN, dtype=F64, device=DEV)
    run = batch.make_lanes_fleet_runner(p, F32, use_megakernel=True,
                                        consts=box_consts(p, F32, bnds, 20), device=DEV)
    reset_counts()
    (x, _), ms = wall_ms(lambda: run(data_b, vo_b))
    counts = read_counts()
    assert counts["mhe_tick_box"] == 1 and counts["admm_solve"] == 1, counts
    per_lane_max = x[..., 3:6].abs().double().amax(dim=(0, 2))
    n_active = int((per_lane_max >= bnds - 1e-3).sum())
    assert torch.isfinite(x).all() and bool((per_lane_max <= bnds + 1e-3).all()), "a lane left its box"
    assert n_active > 0, "no lane's box ever binds"
    emit("box_sweep", T=T_MAIN, B=B_MAIN, dtype="float32", bounds=[0.25, 0.42],
         lanes_at_their_bound=n_active, wall_s=ms / 1e3, launches=counts)


def box_per_tick(fleet32):
    """Adaptive rho, 50 iterations, no mega-kernel: the eager tick loop with
    one admm_solve launch per tick."""
    p = box_params(adaptive=True)
    data_b, _, vo_b = fleet32
    data_s = estimator.TickData(*(a[:T_PER_TICK] for a in data_b))
    vo_s = estimator.VOData(*(a[:T_PER_TICK] for a in vo_b))
    run = batch.make_lanes_fleet_runner(p, F32, use_megakernel=False,
                                        consts=box_consts(p, F32, V_BOX, 50), device=DEV)
    reset_counts()
    admm_kernel.timer.on = True
    (x, _), ms = wall_ms(lambda: run(data_s, vo_s))
    admm_kernel.timer.on = False
    k_ms = admm_kernel.timer.ms()
    counts = read_counts()
    assert counts["admm_solve"] == T_PER_TICK == len(k_ms) and counts["mhe_tick_box"] == 0, counts
    vmax = float(x[..., 3:6].abs().max())
    assert torch.isfinite(x).all() and vmax <= V_BOX + 1e-3, ("velocity box", vmax)
    emit("box_per_tick", T=T_PER_TICK, B=B_MAIN, dtype="float32", admm_iters=50,
         adaptive_rho=True, launches=counts, admm_solve_mean_ms=sum(k_ms) / len(k_ms),
         admm_solve_max_ms=max(k_ms), wall_s=ms / 1e3, max_abs_v=vmax)


def box_full_width(fleet64, fleet32, x64, q64, counts):
    """The constrained kernels against their plain versions at full width:
    float64 element-wise over T_BOX_PLAIN ticks; float32 over the whole log
    by accuracy against the float64 main path ``x64``, timing both; the
    bounds from what this run's instances iterated. Returns the kernels'
    entries of the last-but-one line."""
    p = box_params()
    R64 = ekf_lanes.to_rot(q64)

    def inputs(fleet, dtype, T):
        data_b, _, vo_b = fleet
        c = box_consts(p, dtype, V_BOX, 20)
        data_l = batch.tickdata_to_lanes(
            estimator.TickData(*(a[:T] for a in data_b)))._replace(R_sb=R64[:T].to(dtype))
        vo = estimator.VOData(*(a[:T] for a in vo_b))
        st0, vo_inc = mhe_inputs(c, data_l, vo, dtype)
        return c, st0, mrk.kernel_state_from_mhe(st0, c), seg(data_l, vo, vo_inc, slice(1, None))

    def window(c, st):
        """The operands admm_solve gets for the window of state ``st``."""
        return (*(a.contiguous() for a in mhe_lanes._masked_system(c, st)), c.x_lb, c.x_ub, c.admm)

    warm = lambda st: dict(z0=st.z_adm.contiguous(), y0=st.y_adm.contiguous())

    # ---- float64, element-wise, reduced depth
    c, st0, ks0, (d1, v1, i1) = inputs(fleet64, F64, T_BOX_PLAIN)
    t0 = time.time()
    _, ks_k, _, e_tick = check_box_tick(c, c._replace(use_pallas=False), ks0, d1, v1, i1,
                                        "full width")
    plain64_s = time.time() - t0
    st_l = mrk.mhe_state_from_kernel(ks_k, c)
    e0, _, _ = check_admm("tick-0 window", *window(c, st0))
    el, _, _ = check_admm("final window", *window(c, st_l), **warm(st_l))
    # the largest error over the outputs x, z, y; y (the dual iterate) is of
    # magnitude 1e4 on these windows, so its absolute error leads
    err = {"mhe_tick_box": max(e_tick.values()),
           "admm_solve": max(*e0.values(), *el.values()),
           "admm_box_solve": max(el.values())}

    # ---- float32 at the main path's shapes: T_MAIN ticks, kernel and plain
    # version once each, both held to the float64 main path by accuracy
    cm, stm, ksm, (dm, vm, im) = inputs(fleet32, F32, T_MAIN)
    ms, plain_ms = {}, {}
    (x32p, _), plain_ms["mhe_tick_box"] = wall_ms(
        lambda: mrk.replay_ticks_plain(cm._replace(use_pallas=False), ksm, dm, vm, im))
    x32k, ks_end = mrk.replay_ticks(cm, ksm, dm, vm, im, device=DEV)
    assert torch.isfinite(x32k).all()
    ref = torch.movedim(x64, 1, -1)[1:]
    rk, rp = vel_rmse(x32k, ref, SKIP), vel_rmse(x32p, ref, SKIP)
    assert abs(rk - rp) < 1e-3, ("constrained f32 velocity-RMSE delta", rk, rp)
    del x32p, ref
    mrk.timer.on = True
    ms["mhe_tick_box"] = timed(lambda: mrk.replay_ticks(cm, ksm, dm, vm, im, device=DEV), reps=1)
    mrk.timer.on = False
    kernel_only_ms = min(mrk.timer.ms())
    iters_tick = ks_end.iters

    # admm_solve on the main path's tick-0 window (one real slot); the device
    # function alone on one full window: admm_solve on the main path's final
    # window with its warm starts, which is its work once per tick in mhe_tick_box
    st_end = mrk.mhe_state_from_kernel(ks_end, cm)
    iters = {}
    for name, args, kw in (("admm_solve", window(cm, stm), {}),
                           ("admm_box_solve", window(cm, st_end), warm(st_end))):
        run = lambda: admm_kernel.solve_box_lanes(*args, device=DEV, **kw)
        iters[name] = run().iters
        ms[name] = timed(run)
        plain_ms[name] = timed(lambda: admm_kernel.solve_box_lanes_plain(*args, **kw), reps=1)

    a = cm.admm
    box = (a.rho_update_every, a.adaptive_rho, a.abs_tol > 0 or a.rel_tol > 0, a.polish)
    sched = _work.mhe_schedule(vm.active.tolist(), vm.tick_pre.tolist(),
                               vm.tick_now.tolist(), N_WIN, int(ksm.bez_count))
    it_np = {k: v.cpu().numpy() for k, v in iters.items()}
    works = {
        "mhe_tick_box": _work.mhe_tick(N_WIN, 9, 12, 4, B_MAIN, sched,
                                       int((dm.contact > 0).sum()), 4,
                                       box=(iters_tick.cpu().numpy(),) + box),
        "admm_solve": _work.admm(N_WIN, 9, B_MAIN, 4, it_np["admm_solve"], *box, n_states=1),
        "admm_box_solve": _work.admm(N_WIN, 9, B_MAIN, 4, it_np["admm_box_solve"], *box),
    }
    # the device function's share of the main path's operations
    core_ops = works["admm_solve"][1] + sum(
        _work.admm_ops(9, n_states, it, *box)
        for (n_states, *_), it in zip(sched, iters_tick.cpu().numpy()))
    emit("box_full_width", B=B_MAIN, N=N_WIN, T_f64=T_BOX_PLAIN, T_f32=T_MAIN, tol=TOL_MHE,
         max_abs_err_f64={"mhe_tick_box": e_tick, "admm_solve": {"tick0": e0, "final": el}},
         plain_and_kernel_f64_s=plain64_s,
         f32={"vel_rmse_vs_f64_kernel": rk, "vel_rmse_vs_f64_plain": rp},
         kernel_f32_ms=ms, plain_f32_ms=plain_ms, mhe_tick_box_kernel_only_ms=kernel_only_ms,
         admm_iters_mean={"mhe_tick_box": float(iters_tick.double().mean()),
                          **{k: float(v.double().mean()) for k, v in iters.items()}})
    f64_shape = {"T": T_BOX_PLAIN, "B": B_MAIN}
    return kernel_rows({
        "mhe_tick_box": ("decentralized_ekf_mhe_tpu_torch/csrc/mhe.cu",
                         "decentralized_ekf_mhe_tpu/pallas/mhe_replay_kernel.py:917 (admm_ks set)"),
        "admm_box_solve": ("decentralized_ekf_mhe_tpu_torch/csrc/admm.cuh",
                           "decentralized_ekf_mhe_tpu/pallas/admm_core.py:133"),
        "admm_solve": ("decentralized_ekf_mhe_tpu_torch/csrc/admm.cu",
                       "decentralized_ekf_mhe_tpu/pallas/admm_kernel.py:75"),
    }, works, counts, err, ms, plain_ms,
        mhe_tick_box=dict(max_abs_err_shape=f64_shape, max_abs_err_by_output=e_tick,
                          f32_vel_rmse_vs_f64={"kernel": rk, "plain": rp}),
        admm_solve={"shape": {"B": B_MAIN, "N": N_WIN, "window": "tick 0: one real slot"},
                    "max_abs_err_shape": dict(f64_shape, window="tick 0 and final"),
                    "max_abs_err_by_output": {"tick0_window": e0, "final_window": el}},
        admm_box_solve={
            "shape": {"B": B_MAIN, "N": N_WIN, "window": "final: 20 real slots"},
            "note": "device function, never launched alone: launches counts the launches "
                    "of the two kernels that run it (mhe_tick_box, admm_solve); ms, "
                    "plain_ms and the bound are of one whole-window solve, taken "
                    "through admm_solve on the main path's final window (20 real "
                    "slots, warm-started), its work once per tick inside mhe_tick_box",
            "max_abs_err_shape": dict(f64_shape, window="final"), "max_abs_err_by_output": el,
            "main_path_operations": core_ops,
            "main_path_bound_ms": core_ops / PEAK_F32_FLOPS * 1e3})


def main():
    card = phase_device()
    phase_build()
    check_kernels()
    # one perturbed fleet at full width, drawn in float64; the main path runs
    # its float32 cast, so both precisions see the same inputs
    log, *fleet64 = make_fleet(T_MAIN, B_MAIN, F64, seed=0)
    fleet32 = tuple(cast(nt, F32) for nt in fleet64)
    gt_v = torch.as_tensor(log.gt_v_s, device=DEV)
    counts, x64, q64 = main_path(fleet64, fleet32, gt_v)
    kernels = full_size(fleet64, fleet32, x64, q64, counts)
    del x64
    check_kernels_box()
    box_counts, x64_box, q64_box = box_main_path(fleet64, fleet32, gt_v)
    box_sweep(fleet32)
    box_per_tick(fleet32)
    kernels += box_full_width(fleet64, fleet32, x64_box, q64_box, box_counts)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
