#!/usr/bin/env python3
"""Compare two checkouts' kernels on one card: every kernel's ptxas figures,
the unconstrained tick's time in turns at Go1's and PogoX's shapes (s=9) with
either tail, and the Cholesky tick's float64 and float32 results there.

    python3 chip_ab_mhe_tick.py OTHER_CHECKOUT [--turns-only | --bits-only]

Run from the root of this checkout on a machine with one NVIDIA GPU and nvcc.
``OTHER_CHECKOUT`` is the root of a second checkout (for instance the parent
commit unpacked with ``git archive`` into a git-ignored directory). First both
checkouts build all their libraries at once, each with ptxas' report, and
the script prints, for every kernel the two have in common, whether its
registers, stack frame and spill stores and loads are the same, and which of
those that differ are outside the set this comparison expects to change
(``CHANGED``: the unconstrained Cholesky tick at s=9, ``mhe_chol_kernel`` and
``mhe_pi_chol_kernel``). Then, since
two versions are only comparable within one run on one card, the timing turns
go other, this, this, other; each turn is a fresh process. Go1's
unconstrained tick (K2) on the headline fleet (cell (a): T=2000, B=1024,
float32, seed 0; the EKF kernel's orientation) prints best-of-3 device times
of ``mhe_replay_kernel.replay_ticks`` over ticks 1..T-1, three times, as the
control. Then the subject, the four fleets with the Cholesky tail (K2d,
K2d-PI: Go1's cells (p), (r), and PogoX's fleet (cell (i)'s, the lanes
runner's inputs) and its 15 clocks), and Go1's Gauss-Jordan tick on its 15
clocks per lane (cell (c), K2b) and PogoX's on its fleets (cells (i), (n))
as controls, each run the whole log once per turn after a short warm-up,
the kernel alone (``mrk.timer``).
``--turns-only`` stops after cell (a)'s turns. Last, each checkout runs Go1's
and PogoX's unconstrained Cholesky tick on both clocks in float64 on the
first 120 ticks (B=1024), then in float32 over the whole log, and the script
prints, per run, whether x, the window state and the Bezier schedule are
bit-identical between the checkouts, and the largest difference in units of
the limit rtol=atol=1e-8 and the count of elements that differ where they are
not, and each checkout's first tick whose x is not finite. A run that is not
bit-identical runs once more in both checkouts with their tick's library
built without FMA contraction (``-fmad=false``, ``FMAD_OFF``): identical there,
the difference is nvcc's contraction of the same operations.
``--bits-only`` runs this last part alone.
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


def run_turn(tree, code, *args):
    """One turn: ``code`` in a fresh process with ``tree`` as working
    directory; its last line of output, parsed, if it prints JSON."""
    r = subprocess.run([sys.executable, "-c", code, *args], cwd=tree, capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise SystemExit(f"{tree}: {r.stderr[-2000:]}")
    lines = r.stdout.strip().splitlines()
    return json.loads(lines[-1]) if lines else None


# the kernels this comparison expects to change ptxas figures: the
# unconstrained Cholesky tick at s=9 (K2d, K2d-PI at Go1's and PogoX's
# shapes, now on a group per instance)
CHANGED = re.compile(r"(15mhe_chol_kernel|18mhe_pi_chol_kernel)I[fd]Li9E")
# the libraries of the stage ablation's compositions that a checkout before
# them does not have (per-lane clocks, the Cholesky tail, box consts; Cassie's
# shape): not built for the comparison
NEW_LIBRARIES = r"^mhe_\w+_abl_(pi|chol|box)_|^mhe_cassie_abl"
FMAD_OFF = "-fmad=false"
# Go1's and PogoX's unconstrained Cholesky tick on both clocks (K2d, K2d-PI)
S9_CHOL = [(model, clock, "chol") for model in ("go1", "pogox") for clock in ("shared", "pi")]


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
                a, b = get(res["."]), get(res[other])
                row[k] = {"bit_identical": bool(torch.equal(a, b) or (
                    a.dtype.is_floating_point and torch.equal(a.isnan(), b.isnan())
                    and torch.equal(a[~a.isnan()], b[~b.isnan()])))}
                if not row[k]["bit_identical"]:
                    row[k]["elements_differ"] = int((a != b).sum())
                    if a.dtype.is_floating_point:
                        row[k]["over_tol_max"] = float(
                            ((a - b).abs() / (1e-8 + 1e-8 * b.abs())).nan_to_num(0.0).max())
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


def main(other, mode=""):
    if not mode:
        ptxas_both(other)
    if mode != "--bits-only":
        for tree in (other, ".", ".", other):
            print(json.dumps({"checkout": tree, **run_turn(tree, TURN)}), flush=True)
    if mode == "--turns-only":
        return
    if not mode:
        for model, clock, con in (*S9_CHOL, ("go1", "pi", "free"), ("pogox", "shared", "free"),
                                  ("pogox", "pi", "free")):
            for tree in (other, ".", ".", other):
                print(json.dumps({"checkout": tree, **run_turn(
                    tree, TICK_TURN, model, clock, con, "f32", "2000", "-")}), flush=True)
    for T, dtype in ((120, "f64"), (2000, "f32")):
        differ = tick_bits(other, S9_CHOL, T=T, dtype=dtype)
        if differ:   # the same runs without FMA contraction in either checkout
            tick_bits(other, differ, T=T, dtype=dtype, flags=FMAD_OFF)


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in (
            [], ["--turns-only"], ["--bits-only"]):
        raise SystemExit(__doc__)
    main(*sys.argv[1:])
