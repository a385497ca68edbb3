#!/usr/bin/env python3
"""Compare two checkouts' kernels on one card: every kernel's ptxas figures,
the whole-window box-ADMM (K4 ``admm_solve``) and the block-tridiagonal solve
(K5 ``tridiag_solve``, lanes and standard routes) in turns, and their float64
results and those of the constrained tick, whose residual maxima they share;
and the orientation-EKF stage (K1 ``ekf_stage``).

    python3 chip_ab_mhe_tick.py OTHER_CHECKOUT [--turns-only | --bits-only | --f8-only |
                                                --ekf-only | --ekf-diag | --sass-only]

Run from the root of this checkout on a machine with one NVIDIA GPU and nvcc.
``OTHER_CHECKOUT`` is the root of a second checkout (for instance the parent
commit unpacked with ``git archive`` into a git-ignored directory). First both
checkouts build all their libraries at once, each with ptxas' report, and
the script prints, for every kernel the two have in common, whether its
registers, stack frame and spill stores and loads are the same, and which of
those that differ are outside the set this comparison expects to change
(``CHANGED``: K1's kernels, now on a group of threads per instance).
Then, since two versions are only comparable within one run on one card, the
timing turns go other, this, this, other; each turn is a fresh process. Go1's
unconstrained tick (K2) on the headline fleet (cell (a): T=2000, B=1024,
float32, seed 0; the EKF kernel's orientation) prints best-of-3 device times
of ``mhe_replay_kernel.replay_ticks`` over ticks 1..T-1, three times, as the
control (the card's name and power limit printed first). Then the subjects
(``SOLVE_TURN``): K4 in ``chip_smoke.box_per_tick`` (adaptive rho, 50
iterations, one launch per tick over 200 ticks, each launch timed alone);
K4 and K5 on the windows of Go1's and Cassie's constrained fleets (T=120,
B=1024, float32, the EKF kernel's orientation; best of 3, around the
wrapper): K4 on the tick-0 window (one real slot, as at tick 0 of every
constrained replay) and on the last window with its warm starts, K5's lanes
route on the tick-0 window (as at tick 0 of every unconstrained replay) and
the last, K5's standard route on the last window's (N,B,...) views with a
per-lane warm-up mask; and K5's standard route per replay: the
standard-layout fleet runner at T=2000, B=1024, float32 (cell (q)), every
route call and its launch timed (CUDA events). ``--turns-only`` stops there,
without the ptxas builds. Last, each checkout solves
those windows in float64 (K4: x, z, y, counts; K5 on both routes: x), and
runs the constrained tick on Go1's fleet (cell (b)) and Cassie's at the
bench's settings (cell (k)) in float64 over 120 ticks and in float32 over the
whole log, and the script prints whether the results are bit-identical,
NaN where NaN, and where not the largest difference in units of the limit
rtol=atol=1e-8 and the count of elements that differ; a comparison that is
not bit-identical runs once more with both checkouts' libraries built without
FMA contraction (``-fmad=false``, ``FMAD_OFF``): identical there, the
difference is nvcc's contraction of the same operations. ``--bits-only``
runs this part alone. Last, fault F8 at cell (k) (``--f8-only`` alone): the
constrained tick there in turns, the kernel alone over the whole float32 log;
where this checkout's iteration counts differ from the other's, whether they
equal the plain version's on every tick (each plain tick run from the
kernel's state before it), and at the first differing tick and lane the
plain ADMM's residuals at each epoch end with a NaN kept and dropped, and
the terms behind the first one that is not finite (``F8_TURN``). Then K1
(``--ekf-only`` alone): K1 alone at (a) (T=2000, B=1024, float32) in turns,
CUDA events around the library call in either checkout, and its float64
q_seq and final state over (a)'s first 300 ticks bit for bit, again with
``-fmad=false`` in both where they differ (``EKF_TURN``). ``--ekf-diag``
runs in this checkout only (not part of a run without flags): K1 alone at (a)
as built and built with approximate division and square root, in turns, as a
diagnostic of what the IEEE sequences cost; and the SASS opcode counts of
both builds. ``--sass-only`` (not part of a run without flags either) builds
the libraries of ``SASS_LIBRARIES`` in both checkouts at once — every tick,
K4 and K5 library below s=16 but the stage ablation's — and prints, for every
kernel the two have in common, whether its SASS (``cuobjdump -sass``, every
instruction with its offset) is the same: the check that a change to the
group's size at s=21 left the code that runs below s=16 as it was.
"""

import json
import os
import re
import subprocess
import sys
import tempfile

# run with a checkout's root as working directory: ``python -c`` puts it first
# on the module path, so each turn imports that checkout's chip_smoke and package
TURN = r'''
import json
import chip_smoke as cs
from decentralized_ekf_mhe_tpu_torch.config import EKFParams
from decentralized_ekf_mhe_tpu_torch.kernels import ekf_kernel
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import ekf_lanes
_, *fleet64 = cs.make_fleet(cs.T_MAIN, cs.B_MAIN, cs.F64, seed=0)
fleet32 = tuple(cs.cast(nt, cs.F32) for nt in fleet64)
del fleet64
pe = EKFParams()
ec = ekf_lanes.make_consts(pe, cs.F32)
st = ekf_lanes.init_state(pe, cs.B_MAIN, cs.RING, cs.F32, device=cs.DEV)
q, _ = ekf_kernel.replay(ec, st, fleet32[1], device=cs.DEV)
c, _, ks, (d, v, i) = cs.stage_inputs(cs.go1_params(), fleet32, q, cs.F32)
ms = [cs.timed(lambda: mrk.replay_ticks(c, ks, d, v, i, device=cs.DEV), reps=3)
      for _ in range(3)]
print(json.dumps({"mhe_tick_ms_best_of_3": ms}))
'''

# one tick kernel on one fleet: python -c TICK_TURN MODEL CLOCK CON DTYPE T OUT|- [FLAGS]
# (CLOCK shared or pi, CON free, box or chol — unconstrained with the Cholesky
# tail; "-": time one whole-log run after a warm-up and print it; else save x
# and the state of one run to OUT; FLAGS: further nvcc flags, one string, for a
# variant build of the tick's library)
TICK_TURN = r'''
import json, sys
import torch
import chip_smoke as cs
from decentralized_ekf_mhe_tpu_torch.config import EKFParams
from decentralized_ekf_mhe_tpu_torch.kernels import ekf_kernel
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import ekf_lanes, mhe
model, pi, box, dtype = sys.argv[1], sys.argv[2] == "pi", sys.argv[3] == "box", sys.argv[4]
tail = "chol" if sys.argv[3] == "chol" else "gj"
T, out = int(sys.argv[5]), sys.argv[6]
flags = tuple(sys.argv[7].split()) if len(sys.argv) > 7 else ()
dtype = {"f32": cs.F32, "f64": cs.F64}[dtype]
with torch.inference_mode():
    make = cs.make_clock_fleet if pi else cs.make_fleet
    _, *fleet = make(T, cs.B_MAIN, cs.F64, seed=0, model=model)
    fleet = tuple(cs.cast(nt, dtype) for nt in fleet)
    c = (cs.box_consts(cs.box_params(model=model), dtype, cs.V_BOX, 20) if box
         else mhe.make_consts(cs.robot_params(model)[0], dtype, device=cs.DEV))
    if model == "go1" and not pi:   # cells (a), (b), (p): the pipeline's EKF orientation
        pe = EKFParams()
        st = ekf_lanes.init_state(pe, cs.B_MAIN, cs.RING, dtype, device=cs.DEV)
        q, _ = ekf_kernel.replay(ekf_lanes.make_consts(pe, dtype), st, fleet[1], device=cs.DEV)
        _, ks, (d, v, i) = cs.window_inputs(c, fleet, ekf_lanes.to_rot(q), dtype, T)
    else:                            # the lanes runner's inputs (cells (c), (i), (n), (r))
        ks, (d, v, i) = cs.clock_inputs(c, fleet, dtype)
    del fleet
    run = lambda n: mrk.replay_ticks(c, ks, *(type(a)(*(t[:n] for t in a)) if isinstance(a, tuple)
                                             else a[:n] for a in (d, v, i)), device=cs.DEV,
                                     mk_solve=tail, nvcc_flags=flags)
    if out == "-":
        run(50)
        mrk.timer.on = True
        run(T - 1)
        mrk.timer.on = False
        (ms,) = mrk.timer.ms()
        print(json.dumps({"model": model, "clock": sys.argv[2], "tick": sys.argv[3], "T": T,
                          "kernel_alone_ms": ms}))
    else:
        x, k = run(T - 1)
        res = {"x": x.cpu(), "state": [a.cpu() for a in k.arrays[:18]],
               "bez_times": k.bez_times.cpu(), "bez_count": k.bez_count.cpu()}
        if box:
            res.update(z=k.arrays[18].cpu(), y=k.arrays[19].cpu(), iters=k.iters.cpu())
        torch.save(res, out)
'''

# K4 and K5 in one checkout: python -c SOLVE_TURN MODE MODEL OUT|- [FLAGS]
# (MODE per_tick: chip_smoke.box_per_tick, its line printed; std_replay: the
# standard-layout fleet runner with every route call timed; windows: K4 and
# K5 timed on MODEL's windows, float32; bits: their float64 results on those
# windows saved to OUT; FLAGS: further nvcc flags, one string, for a variant
# build of the solve libraries)
SOLVE_TURN = r'''
import json, sys
import torch
import chip_smoke as cs
from decentralized_ekf_mhe_tpu_torch.config import EKFParams
from decentralized_ekf_mhe_tpu_torch.kernels import _build, admm_kernel, ekf_kernel, tridiag_kernel
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import ekf_lanes, mhe_lanes
mode, model, out = sys.argv[1:4]
flags = tuple(sys.argv[4].split()) if len(sys.argv) > 4 else ()
if flags:
    load = _build.load
    _build.load = lambda name, extra_flags=(): load(
        name, flags if name.startswith(("admm_", "tridiag_")) else extra_flags)


def views(c, st, dtype):
    """The last window's system as ops.mhe.solve_window hands it to the
    standard route: (N,B,...) views of (B,N,...) storage, with a per-lane
    warm-up mask (lane b's first b % 7 slots dead)."""
    D, U, r, valid = mhe_lanes.assemble_normal_equations(c, st)
    N, B = r.shape[0], r.shape[-1]
    lane = torch.arange(N, device=cs.DEV)[:, None] >= (torch.arange(B, device=cs.DEV) % 7)[None]
    v = (valid[:, None] & lane).T.contiguous().movedim(0, 1)
    return (D.permute(3, 0, 1, 2).contiguous().movedim(0, 1),
            U[:-1].permute(3, 0, 1, 2).contiguous().movedim(0, 1),
            r.permute(2, 0, 1).contiguous().movedim(0, 1), v)


with torch.inference_mode():
    if mode == "per_tick":
        _, *fleet = cs.make_fleet(cs.T_MAIN, cs.B_MAIN, cs.F64, seed=0)
        fleet32 = tuple(cs.cast(nt, cs.F32) for nt in fleet)
        del fleet
        cs.box_per_tick(fleet32)
        sys.exit()
    if mode == "std_replay":
        _, *fleet = cs.make_fleet(cs.T_MAIN, cs.B_MAIN, cs.F64, seed=0)
        pe = EKFParams()
        st = ekf_lanes.init_state(pe, cs.B_MAIN, cs.RING, cs.F64, device=cs.DEV)
        q64, _ = ekf_kernel.replay(ekf_lanes.make_consts(pe, cs.F64), st, fleet[1], device=cs.DEV)
        d32, v32 = cs.std_fleet(tuple(cs.cast(nt, cs.F32) for nt in fleet), q64, cs.F32)
        del fleet
        run = cs.batch.make_fused_batched_runner(cs.go1_params(), cs.F32, use_pallas=True,
                                                 device=cs.DEV)
        with cs.route_calls() as calls:
            _, wall = cs.wall_ms(lambda: run(d32, v32))
        route = sum(cs.call_ms(c) for c in calls)
        kernel = sum(c["kernel_events"][0].elapsed_time(c["kernel_events"][1]) for c in calls)
        print(json.dumps({"std_replay": {"launches": len(calls), "wall_s": wall / 1e3,
                                         "route_ms_summed": route, "kernel_ms_summed": kernel,
                                         "route_ms_per_launch": route / len(calls)}}))
        sys.exit()
    dtype = cs.F32 if mode == "windows" else cs.F64
    _, *fleet = cs.make_fleet(cs.T_BOX_PLAIN, cs.B_MAIN, cs.F64, seed=0, model=model)
    fleet = cs.ekf_oriented(model, tuple(cs.cast(nt, dtype) for nt in fleet), dtype)
    c = cs.box_consts(cs.box_params(model=model), dtype, cs.V_BOX, 20)
    ks0, (d, v, i) = cs.clock_inputs(c, fleet, dtype)
    del fleet
    _, ks = mrk.replay_ticks(c, ks0, d, v, i, device=cs.DEV)
    st0, stT = (mrk.mhe_state_from_kernel(k, c) for k in (ks0, ks))
    sys0, sysT = ((*(a.contiguous() for a in mhe_lanes._masked_system(c, st)),)
                  for st in (st0, stT))
    warm = dict(z0=stT.z_adm.contiguous(), y0=stT.y_adm.contiguous())
    std = views(c, stT, dtype)
    runs = {
        "k4_tick0": lambda: admm_kernel.solve_box_lanes(*sys0, c.x_lb, c.x_ub, c.admm,
                                                        device=cs.DEV),
        "k4_last_warm": lambda: admm_kernel.solve_box_lanes(*sysT, c.x_lb, c.x_ub, c.admm,
                                                            device=cs.DEV, **warm),
        "k5_lanes_tick0": lambda: tridiag_kernel.solve_lanes(*sys0, device=cs.DEV),
        "k5_lanes_last": lambda: tridiag_kernel.solve_lanes(*sysT, device=cs.DEV),
        "k5_standard_last": lambda: tridiag_kernel.solve_batched(*std[:3], valid=std[3],
                                                                 device=cs.DEV),
    }
    if mode == "windows":
        print(json.dumps({"model": model, "s": c.dim_state, "B": cs.B_MAIN,
                          "dtype": "float32", "ms_best_of_3": {
                              k: cs.timed(f) for k, f in runs.items()}}))
    else:
        res = {}
        for k, f in runs.items():
            o = f()
            if k.startswith("k4"):
                res.update({f"{k}_{n}": getattr(o, n).cpu() for n in ("x", "z", "y", "iters")})
            else:
                res[k] = o.cpu()
        torch.save(res, out)
'''

# fault F8 at cell (k) in this checkout: python -c F8_TURN OTHER_RUN (OTHER_RUN:
# the other checkout's TICK_TURN save of the constrained tick at Cassie's bench
# settings, float32, T=2000). Prints one JSON line: where this checkout's
# iteration counts differ from the other's; this kernel's counts against the
# plain version's on every tick from 100 before the first difference on, each
# plain tick run from the kernel's state before it; and, at the first differing (tick, lane), the plain ADMM's
# residuals at each epoch end on that window with NaN kept (torch.amax, this
# checkout) and dropped (the other's maxima), and the terms behind the first
# non-finite one
F8_TURN = r"""
import json, sys
import torch
import chip_smoke as cs
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import admm, estimator, lanes
model, T, dtype = "cassie_bench", 2000, cs.F32
other = torch.load(sys.argv[1])["iters"]


def keep(a):      # |a|'s largest element, NaN if any is (torch.amax, jnp.max)
    return float(a.abs().amax())


def drop(a):      # the same with the NaN dropped, as the other checkout's fold
    a = a.abs()
    a = a[~a.isnan()]
    return float(a.amax()) if a.numel() else 0.0


def first_bad(a):     # (slot, row) of a's first non-finite element, or None
    bad = (~torch.isfinite(a)).nonzero()
    return None if not len(bad) else [int(k) for k in bad[0][:2]]


with torch.inference_mode():
    _, *fleet = cs.make_fleet(T, cs.B_MAIN, cs.F64, seed=0, model=model)
    fleet = tuple(cs.cast(nt, dtype) for nt in fleet)
    c = cs.box_consts(cs.box_params(model=model), dtype, cs.V_BOX, 20)
    c_plain = cs.box_consts(cs.box_params(model=model), dtype, cs.V_BOX, 20, use_pallas=False)
    ks0, (d, v, i) = cs.clock_inputs(c, fleet, dtype)
    del fleet
    cut = lambda k: (estimator.TickData(*(a[k:k + 1] for a in d)),
                     estimator.VOData(*(a[k:k + 1] for a in v)), i[k:k + 1])
    _, ks = mrk.replay_ticks(c, ks0, d, v, i, device=cs.DEV)
    this = ks.iters.cpu()
    differ = this != other
    ticks = differ.any(1).nonzero().flatten() + 1
    pairs = torch.stack([other[differ], this[differ]], 1).unique(dim=0, return_counts=True)
    out = {"model": model, "T": T, "B": cs.B_MAIN, "dtype": "float32", "counts": {
        "elements": this.numel(), "differ": int(differ.sum()),
        "ticks_with_a_difference": len(ticks),
        "first_tick": int(ticks[0]) if len(ticks) else None,
        "last_tick": int(ticks[-1]) if len(ticks) else None,
        "other_to_this": {f"{int(a)}->{int(b)}": int(n) for (a, b), n in zip(*pairs)}}}
    # the plain version from the kernel's state before each tick; the ADMM
    # call of the first differing tick caught on its way in
    caught, solve = {}, admm.solve_box_tridiag_lanes
    t1 = int(ticks[0]) if len(ticks) else 0
    b1 = int(differ[t1 - 1].nonzero()[0]) if len(ticks) else 0

    def spy(*args, **kw):
        if catch:
            caught.update(args=args, kw=kw)
        return solve(*args, **kw)

    catch = False
    admm.solve_box_tridiag_lanes = spy
    t0 = max(1, t1 - 100)      # the first tick held
    ks = ks0
    if t0 > 1:
        _, ks = mrk.replay_ticks(c, ks0, *(type(a)(*(q[:t0 - 1] for q in a))
                                           if isinstance(a, tuple) else a[:t0 - 1]
                                           for a in (d, v, i)), device=cs.DEV)
    plain, step_same = [], True
    for k in range(t0 - 1, T - 1):
        catch = k + 1 == t1
        _, kp = mrk.replay_ticks_plain(c_plain, ks, *cut(k))
        _, ks = mrk.replay_ticks(c, ks, *cut(k), device=cs.DEV)
        step_same &= bool(torch.equal(ks.iters[0].cpu(), this[k]))
        plain.append(kp.iters[0].cpu())
    admm.solve_box_tridiag_lanes = solve
    plain = torch.cat([this[:t0 - 1], torch.stack(plain)])
    agree = plain == this
    agree[:t0 - 1] = True
    out["kernel_vs_plain_counts"] = {
        "ticks_held": [t0, T - 1], "elements_held": int(this[t0 - 1:].numel()),
        "stepwise_kernel_equals_whole_run": step_same,
        "disagree": int((~agree).sum()),
        "disagree_where_the_checkouts_differ": int((~agree & differ).sum()),
        "disagree_elsewhere": int((~agree & ~differ).sum()),
        "plain_equals_other_where_the_checkouts_differ": int((plain == other)[differ].sum())}
    if caught:
        D, U, r, lb, ub, st = caught["args"]
        one = lambda a: a[..., b1:b1 + 1].contiguous()
        lb1, ub1 = ((a[:, b1:b1 + 1] if a.ndim == 2 else a) for a in (lb, ub))
        D1, U1, r1, z0, y0 = (one(a) for a in (D, U, r, caught["kw"]["z0"], caught["kw"]["y0"]))
        E = st.rho_update_every
        epochs, prev = [], None
        for e in range(1, st.iters // E + 1):
            res = admm.solve_box_tridiag_lanes(
                D1, U1, r1, lb1, ub1, st._replace(iters=e * E, abs_tol=0.0, rel_tol=0.0,
                                                  polish=False), z0=z0, y0=y0)
            x, z, y = res.x, res.z, res.y
            Dx = lanes.mv(D1, x)
            Ux, Utx = torch.zeros_like(x), torch.zeros_like(x)
            Ux[:-1] = lanes.mv(U1, x[1:])
            Utx[1:] = lanes.mv_t(U1, x[:-1])
            Tx = admm.t_apply(D1, U1, x)
            terms = {"prim": x - z, "dual": Tx - r1 + y, "x": x, "z": z, "Tx": Tx, "y": y,
                     "r": r1}
            row = {"iteration": e * E,
                   "keep": {n: keep(a) for n, a in terms.items()},
                   "drop": {n: drop(a) for n, a in terms.items()},
                   "iterates_as_the_epoch_before": prev is not None and all(
                       bool(torch.allclose(a, b, rtol=0.0, atol=0.0, equal_nan=True))
                       for a, b in zip((x, z, y), prev))}
            for how in ("keep", "drop"):
                m = row[how]
                ps, ds = max(m["x"], m["z"]), max(m["Tx"], m["y"], m["r"])
                if any(q != q for q in (m["x"], m["z"])):
                    ps = float("nan")
                if any(q != q for q in (m["Tx"], m["y"], m["r"])):
                    ds = float("nan")
                row[f"converged_{how}"] = (m["prim"] <= st.abs_tol + st.rel_tol * ps
                                           and m["dual"] <= st.abs_tol + st.rel_tol * ds)
            bad = {n: first_bad(a) for n, a in terms.items()}
            row["first_nonfinite"] = {n: b for n, b in bad.items() if b is not None}
            if bad["dual"] is not None:
                j, q = bad["dual"]
                prods = (D1[j, q, :, 0] * x[j, :, 0]).tolist()
                row["dual_there"] = {
                    "slot": j, "row": q, "Dx": float(Dx[j, q, 0]), "Ux_next": float(Ux[j, q, 0]),
                    "Utx_prev": float(Utx[j, q, 0]), "r": float(r1[j, q, 0]),
                    "y": float(y[j, q, 0]), "x_row": x[j, :, 0].tolist(),
                    "D_row": D1[j, q, :, 0].tolist(), "D_row_times_x": prods,
                    "max_abs_D_slot": float(D1[j].abs().max()),
                    "max_abs_U": float(U1.abs().max())}
            epochs.append(row)
            prev = (x, z, y)
        # where the iterates stop being finite: the iteration, the slot of
        # the ADMM's factorization (D + (sigma + rho) I) and the step of that
        # slot's Gauss-Jordan inverse, beside the exact factorization of D
        # that the polish runs
        first_it = next((k for k in range(1, st.iters + 1) if not bool(torch.isfinite(
            admm.solve_box_tridiag_lanes(D1, U1, r1, lb1, ub1, st._replace(
                iters=k, abs_tol=0.0, rel_tol=0.0, polish=False), z0=z0, y0=y0).x).all())),
            None)
        eye = torch.eye(D1.shape[1], dtype=dtype, device=D1.device)[:, :, None]
        shift = torch.full((1,), st.sigma + st.rho, dtype=dtype, device=D1.device)
        fac = {}
        for name, A in (("admm", D1 + shift * eye), ("exact", D1)):
            Sinv = lanes.thomas_factor(A, U1)[0]
            slots = (~torch.isfinite(Sinv)).flatten(1).any(1).nonzero().flatten().tolist()
            row = {"nonfinite_slots": slots}
            if slots:
                j = slots[0]
                S_j = A[j] if j == 0 else A[j] - lanes.mm_tn(U1[j - 1],
                                                             lanes.mm(Sinv[j - 1], U1[j - 1]))
                n = S_j.shape[0]
                aug = torch.cat([S_j, torch.eye(n, dtype=dtype, device=S_j.device)[:, :, None]],
                                dim=-2)
                pivots = []
                for q in range(n):   # lanes.gj_inv's steps, each pivot as it is divided by
                    pivots.append(float(aug[q, q, 0]))
                    rowq = aug[q] / aug[q, q][None]
                    aug = aug - aug[:, q][:, None] * rowq[None]
                    aug[q] = rowq
                row.update(slot_block_max_abs=float(S_j.abs().max()), pivots=pivots)
            fac[name] = row
        out["first_difference"] = {
            "tick": t1, "lane": b1, "other_iters": int(other[t1 - 1, b1]),
            "this_iters": int(this[t1 - 1, b1]), "plain_iters": int(plain[t1 - 1, b1]),
            "window_nonfinite": {n: int((~torch.isfinite(a)).sum())
                                 for n, a in (("D", D1), ("U", U1), ("r", r1), ("z0", z0),
                                              ("y0", y0))},
            "first_nonfinite_iteration": first_it, "factorizations": fac,
            "settings": {"rho": st.rho, "iters": st.iters, "every": E, "abs_tol": st.abs_tol,
                         "rel_tol": st.rel_tol, "adaptive_rho": st.adaptive_rho},
            "epochs": epochs}
    print(json.dumps(out))
"""

# K1 in one checkout: python -c EKF_TURN MODE OUT|- [FLAGS] [BLOCKS]
# (MODE time: K1 alone at (a) — T=2000, B=1024, float32, seed 0 — best of 3
# device times of its launch (CUDA events around the library call, so the
# wrapper's copies are left out, in either checkout), once per block of
# BLOCKS (comma-separated threads per block, "-": the wrapper's default);
# bits: the float64 q_seq and final state (q, P, the rings) over (a)'s first
# 300 ticks saved to OUT; FLAGS: further nvcc flags, one string, for a variant
# build of the EKF library)
EKF_TURN = r"""
import json, sys
import torch
import chip_smoke as cs
from decentralized_ekf_mhe_tpu_torch.config import EKFParams
from decentralized_ekf_mhe_tpu_torch.kernels import _build, ekf_kernel
from decentralized_ekf_mhe_tpu_torch.ops import ekf_lanes, estimator
mode, out = sys.argv[1:3]
flags = tuple(sys.argv[3].split()) if len(sys.argv) > 3 else ()
events, load = [], _build.load


def timed_load(name, extra_flags=()):
    fn = load(name, flags if name == "ekf" else extra_flags)
    if name != "ekf":
        return fn

    def call(*a):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        r = fn(*a)
        e1.record()
        events.append((e0, e1))
        return r
    return call


_build.load = timed_load
with torch.inference_mode():
    dtype = cs.F32 if mode == "time" else cs.F64
    _, _, eb, _ = cs.make_fleet(cs.T_MAIN if mode == "time" else 300, cs.B_MAIN, cs.F64, seed=0)
    eb = cs.cast(eb, dtype)
    pe = EKFParams()
    ec = ekf_lanes.make_consts(pe, dtype)
    st = ekf_lanes.init_state(pe, cs.B_MAIN, cs.RING, dtype, device=cs.DEV)
    if mode == "time":
        ekf_kernel.replay(ec, st, eb, device=cs.DEV)
        torch.cuda.synchronize()
        events.clear()
        for _ in range(3):
            ekf_kernel.replay(ec, st, eb, device=cs.DEV)
        torch.cuda.synchronize()
        print(json.dumps({"ekf_stage_alone_ms_best_of_3": min(
            a.elapsed_time(b) for a, b in events), "nvcc_flags": " ".join(flags),
            "T": cs.T_MAIN, "B": cs.B_MAIN, "dtype": "float32"}))
    else:
        q, fin = ekf_kernel.replay(ec, st, eb, device=cs.DEV)
        torch.save({"q_seq": q.cpu(), "t": fin.t, **{k: getattr(fin, k).cpu() for k in (
            "q", "P", "gyro_hist", "accel_hist", "q_hist", "P_hist")}}, out)
"""

# the SASS of this checkout's K1 kernels (cuobjdump of the library built with
# FLAGS): per kernel the instruction count and the counts of the opcodes that
# shape its chain
SASS = r"""
import collections, json, os, re, shutil, subprocess, sys
from decentralized_ekf_mhe_tpu_torch.kernels import _build
flags = tuple(sys.argv[1].split()) if len(sys.argv) > 1 else ()
lib = os.path.join(_build.build(extra_flags=flags, libraries=("ekf",)), "libekf.so")
exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
text = subprocess.run([exe, "-sass", lib], capture_output=True, text=True, check=True).stdout
res, name = {}, None
for line in text.splitlines():
    m = re.search(r"Function : (\S+)", line)
    if m:
        name, res[m.group(1)] = m.group(1), collections.Counter()
    m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
    if m and name:
        op = m.group(2).split(".")[0]
        res[name]["instructions"] += 1
        if op in ("MUFU", "FCHK", "CALL", "BRA", "WARPSYNC", "BAR", "LDS", "STS", "LDGSTS",
                  "FFMA", "FMUL", "FADD", "DFMA", "DMUL", "DADD", "FSEL", "SEL"):
            res[name][op] += 1
print(json.dumps({"sass": {k: dict(v) for k, v in res.items()}, "nvcc_flags": " ".join(flags)}))
"""

# build a checkout's libraries with ptxas' report, but those whose name
# matches the pattern argv[1] (units the other checkout has not): {kernel:
# figures}
BUILD = r'''
import json, re, sys
import chip_smoke as cs
from decentralized_ekf_mhe_tpu_torch.kernels import _build
_build.build(ptxas=True, libraries=[n for n in _build.LIBRARIES
                                    if not re.search(sys.argv[1], n)])
figs = {}
for report in _build.report.values():
    for _, out, _ in report["units"]:
        figs.update(cs.ptxas_figures(out))
print(json.dumps(figs))
'''


def ptxas_both(other):
    """Both checkouts' builds at once; prints the comparison of the kernels
    they have in common."""
    procs = {tree: subprocess.Popen([sys.executable, "-c", BUILD, NEW_LIBRARIES], cwd=tree,
                                    text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for tree in (other, ".")}
    figs = {}
    for tree, p in procs.items():
        out, err = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"{tree}: {err[-2000:]}")
        figs[tree] = json.loads(out.strip().splitlines()[-1])
    common = sorted(set(figs[other]) & set(figs["."]))
    differ = {k: {"other": figs[other][k], "this": figs["."][k]} for k in common
              if figs[other][k] != figs["."][k]}
    print(json.dumps({"ptxas_registers_frame_spill_stores_loads": {
        "kernels_in_common": len(common), "identical": len(common) - len(differ),
        "differ": differ, "expected_to_change": CHANGED.pattern,
        "differ_outside_the_expected": sorted(k for k in differ if not CHANGED.search(k)),
        "only_in_this": sorted(set(figs["."]) - set(figs[other])),
        "only_in_other": sorted(set(figs[other]) - set(figs["."]))}}), flush=True)


# the libraries whose SASS ``--sass-only`` compares (a full match of the name)
SASS_LIBRARIES = r"mhe_(go1|pogox|cassie)(_pi|_chol)?|(tridiag|admm)_s(9|15)"
# build a checkout's libraries matching argv[1]: {library kernel: [sha256 of
# its SASS, instructions]}
SASS_BUILD = r'''
import hashlib, json, os, re, shutil, subprocess, sys
from decentralized_ekf_mhe_tpu_torch.kernels import _build
names = [n for n in _build.LIBRARIES if re.fullmatch(sys.argv[1], n)]
out_dir = _build.build(libraries=names)
exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
res = {}
for n in names:
    text = subprocess.run([exe, "-sass", os.path.join(out_dir, f"lib{n}.so")],
                          capture_output=True, text=True, check=True).stdout
    name, lines = None, {}
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = f"{n} {m.group(1)}"
            lines[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            lines[name].append(line.strip())
    res.update({k: [hashlib.sha256("\n".join(v).encode()).hexdigest(), len(v)]
                for k, v in lines.items()})
print(json.dumps(res))
'''


def sass_both(other):
    """Both checkouts' builds of SASS_LIBRARIES at once; prints, for the
    kernels they have in common, how many have the same SASS and which do
    not."""
    procs = {tree: subprocess.Popen([sys.executable, "-c", SASS_BUILD, SASS_LIBRARIES],
                                    cwd=tree, text=True, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
             for tree in (other, ".")}
    sass = {}
    for tree, p in procs.items():
        out, err = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"{tree}: {err[-2000:]}")
        sass[tree] = json.loads(out.strip().splitlines()[-1])
    common = sorted(set(sass[other]) & set(sass["."]))
    differ = [k for k in common if sass[other][k] != sass["."][k]]
    print(json.dumps({"sass": {
        "libraries": SASS_LIBRARIES, "kernels_in_common": len(common),
        "identical": len(common) - len(differ),
        "instructions_in_common": sum(sass["."][k][1] for k in common),
        "differ": {k: {"other": sass[other][k][1], "this": sass["."][k][1]} for k in differ},
        "only_in_this": sorted(set(sass["."]) - set(sass[other])),
        "only_in_other": sorted(set(sass[other]) - set(sass["."]))}}), flush=True)


def run_turn(tree, code, *args):
    """One turn: ``code`` in a fresh process with ``tree`` as working
    directory; its last line of output, parsed, if it prints JSON."""
    r = subprocess.run([sys.executable, "-c", code, *args], cwd=tree, capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise SystemExit(f"{tree}: {r.stderr[-2000:]}")
    lines = r.stdout.strip().splitlines()
    return json.loads(lines[-1]) if lines else None


# the kernels this comparison expects to change ptxas figures: K1's (on a
# group of threads per instance, with a new signature, so they show as only
# in one checkout)
CHANGED = re.compile(r"10ekf_kernelI")
# libraries one checkout has and the other does not (none): not built for
# the comparison
NEW_LIBRARIES = r"^$"
FMAD_OFF = "-fmad=false"
# the constrained tick on Go1's fleet (cell (b)) and at Cassie's bench
# settings (cell (k))
BOX_TICKS = [("go1", "shared", "box"), ("cassie_bench", "shared", "box")]
SOLVE_MODELS = ("go1", "cassie")


def solve_bits(other, models, flags=""):
    """K4's (x, z, y, counts) and K5's (x, both routes) float64 results on
    ``models``' windows in both checkouts (``SOLVE_TURN`` bits; ``flags``:
    further nvcc flags of both checkouts' solve libraries): per model and
    result whether they are bit-identical, NaN where NaN, and where not the
    largest |this - other| / (1e-8 + 1e-8 |other|) and the count of elements
    that differ. Returns the models that are not bit-identical."""
    import torch

    differ = []
    with tempfile.TemporaryDirectory() as tmp:
        for model in models:
            res = {}
            for tree in (other, "."):
                f = os.path.join(tmp, f"{'this' if tree == '.' else 'other'}.pt")
                run_turn(tree, SOLVE_TURN, "bits", model, f, flags)
                res[tree] = torch.load(f)
            row = {k: compare(res["."][k], res[other][k]) for k in res["."]}
            same = all(r["bit_identical"] for r in row.values())
            if not same:
                differ.append(model)
            print(json.dumps({"solve_float64": {"model": model, "B": 1024, "nvcc_flags": flags,
                                                "all_bit_identical": same, **row}}), flush=True)
    return differ


def compare(a, b):
    """Whether a and b are bit-identical (NaN where NaN), and where not how
    far apart."""
    import torch

    row = {"bit_identical": bool(torch.equal(a, b) or (
        a.dtype.is_floating_point and torch.equal(a.isnan(), b.isnan())
        and torch.equal(a[~a.isnan()], b[~b.isnan()])))}
    if not row["bit_identical"]:
        row["elements_differ"] = int((a != b).sum())
        if a.dtype.is_floating_point:
            row["over_tol_max"] = float(
                ((a - b).abs() / (1e-8 + 1e-8 * b.abs())).nan_to_num(0.0).max())
    return row


def tick_bits(other, runs, T=120, dtype="f64", flags=""):
    """The tick kernels in ``dtype`` in both checkouts over ticks 1..T-1
    (``runs``: (model, clock, free|box|chol); ``flags``: further nvcc flags
    of both checkouts' tick libraries); per run, whether x, the window
    state and the Bezier schedule (the constrained tick: x, z, y and the
    iteration counts) are bit-identical, NaN where NaN, and where not, the
    largest |this - other| / (1e-8 + 1e-8 |other|) and the count of elements
    that differ; and each checkout's first tick whose x is not finite (None
    where every x is). Returns the runs that are not bit-identical."""
    import torch

    differ = []
    with tempfile.TemporaryDirectory() as tmp:
        for model, clock, con in runs:
            res = {}
            for tree in (other, "."):
                f = os.path.join(tmp, f"{'this' if tree == '.' else 'other'}.pt")
                run_turn(tree, TICK_TURN, model, clock, con, dtype, str(T), f, flags)
                res[tree] = torch.load(f)
            keys = ("x", "z", "y", "iters") if con == "box" else (
                "x", "bez_times", "bez_count", *(f"state{k}" for k in range(18)))
            row = {}
            for k in keys:
                get = lambda r: r["state"][int(k[5:])] if k.startswith("state") else r[k]
                row[k] = compare(get(res["."]), get(res[other]))
            bad = {("this" if tree == "." else "other"): first_nonfinite_tick(res[tree]["x"])
                   for tree in (other, ".")}
            same = all(r["bit_identical"] for r in row.values())
            if not same:
                differ.append((model, clock, con))
            print(json.dumps({{"f64": "float64", "f32": "float32"}[dtype]: {
                "model": model, "clock": clock, "tick": con, "T": T, "B": 1024,
                "nvcc_flags": flags, "all_bit_identical": same,
                "first_nonfinite_tick": bad, **row}}), flush=True)
    return differ


def first_nonfinite_tick(x):
    """The first tick (x (T-1, s, B) holds ticks 1..T-1) at which some
    element of x is not finite, or None."""
    import torch

    bad = (~torch.isfinite(x)).flatten(1).any(1).nonzero()
    return int(bad[0]) + 1 if len(bad) else None


def turns(other, code, *args):
    """One subject in turns: other, this, this, other."""
    for tree in (other, ".", ".", other):
        print(json.dumps({"checkout": tree, **run_turn(tree, code, *args)}), flush=True)


def f8(other):
    """Cell (k)'s constrained tick (Cassie at the bench's settings, float32,
    T=2000, B=1024) in turns, the kernel alone over the whole log; then
    ``F8_TURN`` against the other checkout's iteration counts."""
    turns(other, TICK_TURN, "cassie_bench", "shared", "box", "f32", "2000", "-")
    with tempfile.TemporaryDirectory() as tmp:
        f = os.path.join(tmp, "other.pt")
        run_turn(other, TICK_TURN, "cassie_bench", "shared", "box", "f32", "2000", f)
        print(json.dumps({"f8": run_turn(".", F8_TURN, f)}), flush=True)


def ekf_bits(other, flags=""):
    """K1's float64 results over (a)'s first 300 ticks in both checkouts
    (``EKF_TURN`` bits; ``flags``: further nvcc flags of both checkouts' EKF
    library): whether q_seq and the final state are bit-identical, and where
    not how far apart. Returns True where every result is."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        res = {}
        for tree in (other, "."):
            f = os.path.join(tmp, f"{'this' if tree == '.' else 'other'}.pt")
            run_turn(tree, EKF_TURN, "bits", f, flags)
            res[tree] = torch.load(f)
    row = {k: compare(res["."][k], res[other][k]) for k in res["."] if k != "t"}
    row["t_equal"] = res["."]["t"] == res[other]["t"]
    same = all(r["bit_identical"] for r in row.values() if isinstance(r, dict))
    print(json.dumps({"ekf_float64": {"T": 300, "B": 1024, "nvcc_flags": flags,
                                      "all_bit_identical": same, **row}}), flush=True)
    return same


# K1's diagnostic in this checkout: the library as built and built with
# approximate division and square root (-prec-div=false -prec-sqrt=false: what
# the IEEE sequences cost; no wrapper takes such a build), in turns (as built,
# approximate, approximate, as built), then the SASS of both builds
EKF_DIAG = "-prec-div=false -prec-sqrt=false"


def ekf_diag():
    for flags in ("", EKF_DIAG, EKF_DIAG, ""):
        print(json.dumps(run_turn(".", EKF_TURN, "time", "-", flags)), flush=True)
    for flags in ("", EKF_DIAG):
        print(json.dumps(run_turn(".", SASS, flags)), flush=True)


def main(other, mode=""):
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if not mode:
        ptxas_both(other)
    if mode in ("", "--turns-only"):
        turns(other, TURN)
        turns(other, SOLVE_TURN, "per_tick", "go1", "-")
        for model in SOLVE_MODELS:
            turns(other, SOLVE_TURN, "windows", model, "-")
        turns(other, SOLVE_TURN, "std_replay", "go1", "-")
    if mode in ("", "--bits-only"):
        if solve_bits(other, SOLVE_MODELS):    # the same without FMA contraction in either
            solve_bits(other, SOLVE_MODELS, flags=FMAD_OFF)
        for T, dtype in ((120, "f64"), (2000, "f32")):
            differ = tick_bits(other, BOX_TICKS, T=T, dtype=dtype)
            if differ and dtype == "f64":
                tick_bits(other, differ, T=T, dtype=dtype, flags=FMAD_OFF)
    if mode in ("", "--f8-only"):
        f8(other)
    if mode in ("", "--ekf-only"):
        turns(other, EKF_TURN, "time", "-")
        if not ekf_bits(other):
            ekf_bits(other, FMAD_OFF)
    if mode == "--ekf-diag":
        ekf_diag()
    if mode == "--sass-only":
        sass_both(other)


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in (
            [], ["--turns-only"], ["--bits-only"], ["--f8-only"], ["--ekf-only"],
            ["--ekf-diag"], ["--sass-only"]):
        raise SystemExit(__doc__)
    main(*sys.argv[1:])
