#!/usr/bin/env python3
"""Compare two checkouts' kernels on one card: every kernel's ptxas figures,
the unconstrained ``mhe_tick`` kernel's time in turns, and the constrained
tick's (K2c) time in turns and float64 results.

    python3 chip_ab_mhe_tick.py OTHER_CHECKOUT

Run from the root of this checkout on a machine with one NVIDIA GPU and nvcc.
``OTHER_CHECKOUT`` is the root of a second checkout (for instance the parent
commit unpacked with ``git archive`` into a git-ignored directory). First both
checkouts build all their libraries at once, each with ptxas' report, and
the script prints, for every kernel the two have in common, whether its
registers, stack frame and spill stores and loads are the same. Then, since
two versions are only comparable within one run on one card, the timing
turns go other, this, this, other; each turn is a fresh process that draws
the headline fleet (T=2000, B=1024, float32, seed 0) and prints best-of-3
device times of ``mhe_replay_kernel.replay_ticks`` over ticks 1..T-1, three
times. The constrained tick (the bench's box: |v| <= 0.3, rho=5000 fixed, 20
iterations + polish, float32) is timed the same way, in turns other, this,
this, other, on Go1's headline fleet (cell (b): the EKF kernel's orientation)
and on Cassie's shape at the bench's settings (cell (k): the lanes runner's
inputs), one run of the whole log per turn after a short warm-up. Last, each
checkout runs the constrained tick in float64 on the first 120 ticks of
those fleets (B=1024), on the shared camera clock and on 15 clocks per lane
(K2c-PI), and the script prints, per run, whether x, the z/y rings and the
iteration counts are bit-identical between the checkouts, and the largest
difference in units of the limit rtol=atol=1e-8 where they are not.
"""

import json
import os
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

# the constrained tick of one fleet: python -c BOX_TURN MODEL PI DTYPE T OUT|-
# ("-": time one whole-log run after a warm-up and print it; else save x, the
# z/y rings and the iteration counts of one run to OUT)
BOX_TURN = r'''
import json, sys
import torch
import chip_smoke as cs
from decentralized_ekf_mhe_tpu_torch.config import EKFParams
from decentralized_ekf_mhe_tpu_torch.kernels import ekf_kernel
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import ekf_lanes
model, pi, dtype, T, out = sys.argv[1], sys.argv[2] == "pi", sys.argv[3], int(sys.argv[4]), sys.argv[5]
dtype = {"f32": cs.F32, "f64": cs.F64}[dtype]
with torch.inference_mode():
    make = cs.make_clock_fleet if pi else cs.make_fleet
    _, *fleet = make(T, cs.B_MAIN, cs.F64, seed=0, model=model)
    fleet = tuple(cs.cast(nt, dtype) for nt in fleet)
    c = cs.box_consts(cs.box_params(model=model), dtype, cs.V_BOX, 20)
    if model == "go1" and not pi:   # cell (b): the pipeline's EKF orientation
        pe = EKFParams()
        st = ekf_lanes.init_state(pe, cs.B_MAIN, cs.RING, dtype, device=cs.DEV)
        q, _ = ekf_kernel.replay(ekf_lanes.make_consts(pe, dtype), st, fleet[1], device=cs.DEV)
        _, ks, (d, v, i) = cs.window_inputs(c, fleet, ekf_lanes.to_rot(q), dtype, T)
    else:                            # the lanes runner's inputs (cell (k))
        ks, (d, v, i) = cs.clock_inputs(c, fleet, dtype)
    del fleet
    run = lambda n: mrk.replay_ticks(c, ks, *(type(a)(*(t[:n] for t in a)) if isinstance(a, tuple)
                                             else a[:n] for a in (d, v, i)), device=cs.DEV)
    if out == "-":
        run(50)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        run(T - 1)
        e1.record()
        torch.cuda.synchronize()
        print(json.dumps({"model": model, "T": T, "mhe_tick_box_ms": e0.elapsed_time(e1)}))
    else:
        x, k = run(T - 1)
        torch.save({"x": x.cpu(), "z": k.arrays[18].cpu(), "y": k.arrays[19].cpu(),
                    "iters": k.iters.cpu()}, out)
'''

# build all of a checkout's libraries with ptxas' report: {kernel: figures}
BUILD = r'''
import json
import chip_smoke as cs
from decentralized_ekf_mhe_tpu_torch.kernels import _build
_build.build(ptxas=True)
figs = {}
for report in _build.report.values():
    for _, out, _ in report["units"]:
        figs.update(cs.ptxas_figures(out))
print(json.dumps(figs))
'''


def ptxas_both(other):
    """Both checkouts' builds at once; prints the comparison of the kernels
    they have in common."""
    procs = {tree: subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree, text=True,
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
    # the constrained tick's kernels (K2c, K2c-PI) are mhe_box_kernel and
    # mhe_pi_box_kernel; every other kernel is listed apart
    box = ("14mhe_box_kernel", "17mhe_pi_box_kernel")
    print(json.dumps({"ptxas_registers_frame_spill_stores_loads": {
        "kernels_in_common": len(common), "identical": len(common) - len(differ),
        "differ": differ,
        "differ_other_than_the_constrained_tick": sorted(
            k for k in differ if not any(b in k for b in box)),
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


def box_bits(other, T=120):
    """The constrained tick in float64 in both checkouts: per fleet and clock,
    whether x, z, y and the iteration counts are bit-identical, and where
    not, the largest |this - other| / (1e-8 + 1e-8 |other|) and the count of
    elements that differ."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        for model in ("go1", "cassie_bench"):
            for clock in ("shared", "pi"):
                res = {}
                for tree in (other, "."):
                    f = os.path.join(tmp, f"{'this' if tree == '.' else 'other'}.pt")
                    run_turn(tree, BOX_TURN, model, clock, "f64", str(T), f)
                    res[tree] = torch.load(f)
                row = {}
                for k in ("x", "z", "y", "iters"):
                    a, b = res["."][k], res[other][k]
                    row[k] = {"bit_identical": bool(torch.equal(a, b))}
                    if not row[k]["bit_identical"]:
                        row[k]["elements_differ"] = int((a != b).sum())
                        if k != "iters":
                            row[k]["over_tol_max"] = float(
                                ((a - b).abs() / (1e-8 + 1e-8 * b.abs())).max())
                print(json.dumps({"constrained_float64": {"model": model, "clock": clock,
                                                          "T": T, "B": 1024, **row}}),
                      flush=True)


def main(other):
    ptxas_both(other)
    for tree in (other, ".", ".", other):
        print(json.dumps({"checkout": tree, **run_turn(tree, TURN)}), flush=True)
    for model in ("go1", "cassie_bench"):
        for tree in (other, ".", ".", other):
            print(json.dumps({"checkout": tree, **run_turn(tree, BOX_TURN, model, "shared",
                                                           "f32", "2000", "-")}), flush=True)
    box_bits(other)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
