#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: python3 chip_smoke.py

Needs one NVIDIA GPU, nvcc, and nothing else: it builds the CUDA kernels from
``decentralized_ekf_mhe_tpu_torch/csrc``, holds each against its plain PyTorch
version on the card at a small size (split log, both forms of the measured
quaternion, a ragged fleet), drives the Go1 EKF→MHE fleet pipeline
(``parallel.batch.make_pipeline_fleet_runner(use_megakernel=True)``) at full
width — N=20, s=9, m=12, EKF ring 16, T=2000 ticks, B=1024 instances, float32,
with the full Monte-Carlo sensor perturbation — and then holds each kernel
against its plain version again at that full width, in float64 element-wise
and in float32 by accuracy over the first 120 ticks (the plain versions are
eager loops of small launches), timing the kernels over the whole log.

The same pipeline then runs with state box constraints (|v| <= 0.3, which
binds on this log): the box-ADMM kernels at the small size against their plain
versions (fixed and adaptive rho, shared and per-lane bounds, warm-up mask,
warm starts, a ragged fleet, split log), the constrained main path at full
size in float32 and float64, the per-lane bound sweep, the adaptive-rho
setting with one ``admm_solve`` launch per tick, and the constrained kernels
against their plain versions at full width: float64 element-wise at reduced
depth, float32 at full depth by accuracy (the eager plain version of a
constrained tick is thousands of small launches).

Then every lane follows its own camera clock (15 clocks, every 64th lane
VO-free, per-lane VO content): the per-lane-clock variants of the tick kernel
against their plain versions at the small size (split log, plain version from
a kernel state, a ragged fleet, per-lane bounds, and uniform per-lane clocks
against the shared-clock kernels), the MHE-only runner at full size
unconstrained and constrained, and the pipeline runner with per-lane MHE
clocks, once on the shared EKF clock (EKF kernel) and once with per-lane EKF
timing (the eager scan: neither package has an EKF kernel for it). Their
float32 accuracy gates are held over the lanes with a camera: a VO-free lane
breaks down in float32 after a few hundred ticks (ROADMAP.md, fault F5), which
each of these phases reports; the float64 runs hold every lane.

Then the PogoX fleet, the go1feet group and the Cassie fleet
(configs/parameters_{cassie,pogox}.yaml:
Cassie with foot positions as states, s=15, m=6, L=2; PogoX one leg, s=9,
m=3): each shape's tick kernels (unconstrained and constrained), the
tridiagonal solve and the box-ADMM at its state size against their plain
versions at the small size, the pipeline runner at full width (T=2000,
B=1024, float32) unconstrained and with the |v| <= 0.3 box, each against a
float64 run of the same path, and every new instantiation against its plain
version at full width (float64 element-wise over 120 ticks, timed in
float32). Cassie's float32 runs break down after a thousand-odd ticks (fault
F6, shared with the reference): their gates hold over the ticks before it.
Cassie's shape also runs at the reference bench's own settings through the
bench's route (the lanes runner), where float32 stays finite over the whole
log: unconstrained and constrained, gated over the whole log, and the
constrained tick timed there.

The go1feet group, between PogoX and Cassie: the bench's Go1 estimator with
its foot positions as states (leg_odom_type=1, 4 legs: s=21, m=12; Go1's
log, seed 0, perturbed as Go1's), on which every group kernel runs a warp of
32 threads per instance. Every tick variant (K2, K2b, K2c, K2c-PI, K2d,
K2d-PI), K5 on both routes and K4 against their plain versions at the small
size (float64, split log, ragged B; where the Cholesky tick departs from the
Gauss-Jordan one beyond the reference's test of the two tails, each against
its own tail's plain version, ``tails_witness``), the pipeline runner at
full width (u) against a float64 twin, its constrained pipeline (v) over its
first 500 ticks against a float64 twin over 200, and each kernel timed at
full width for its row of the kernels line.

The Cholesky tail of the tick (DEM_MK_SOLVE=chol, the reference's
mk_solve='chol') at each shape: against its plain version and the
Gauss-Jordan kernel at the small size, then on each robot's headline path at
full width (Go1's and PogoX's pipeline runner, Cassie's bench route) against
a float64 run, element-wise against its plain version, and timed in turns
with the Gauss-Jordan tick on the same inputs. And per-lane camera clocks at
the PogoX and Cassie (bench settings) shapes: the small checks of the Go1
ones, then each fleet on 15 clocks through the lanes runner at full width,
unconstrained and with the box.

The standard layout (cell (q)): the block-tridiagonal kernel's standard-layout
route against its plain version on every window of the standard-layout fleet
runner's first 40 ticks (float64; s=9 on Go1's fleet, s=15 at Cassie's small
size), the runner (``parallel.batch.make_fused_batched_runner(use_pallas=True)``,
the route every tick) at full width in float32 and float64, the latter against
the lanes runner's tick kernel, and the reference bench's float64 oracle — the
single-instance orientation EKF, then the single-instance MHE — on the card,
with the KF baseline and a constrained single instance.

The Cholesky tail on per-lane camera clocks (K2d-PI, cell (r)) at each shape:
against its plain version, against the Gauss-Jordan tick on the same clocks
(K2b) and, with the fleet's clock given to every lane, against the
shared-clock Cholesky tick at the small size (split log, plain version from a
kernel state, a ragged fleet through the lanes runner with DEM_MK_SOLVE=chol);
then each robot's 15-clock fleet through the lanes runner at full width with
DEM_MK_SOLVE=chol against a float64 run, element-wise against its plain
version, and timed against K2b. And, last, the stage ablation of the tick
(K2e, cell (s)) at Go1's, PogoX's and Cassie's shapes, at every composition
— either clock, either tail, box consts — in the tick it ablates (the group,
or the constrained tick's one-thread prelude): each of its 72 float64 units
against its plain version at a small size (the same positions of non-finite
values; with box consts z, y and the iteration counts too), then the stage
tables of
``decentralized_ekf_mhe_tpu_torch.tools.roofline.ablation`` on the headline
fleets ((a), (i), (k)): the Gauss-Jordan tick at each shape, the Cholesky
tick and the constrained tick at Go1's and Cassie's, printed for each.

The constrained tick runs its window solve on 16 threads per instance: the
small checks also show that a launch it cannot take raises (a block that is
no multiple of 16, shared memory beyond the card's), and a last phase prints
its launch geometry at each shape, clock and type — threads, instances and
dynamic shared memory per block, the blocks the card keeps resident per SM,
the units' ptxas figures — and holds every float32 launch to at least 8
instances per SM. The kernels line's rows of the constrained tick name the
source of its window solve. The unconstrained tick with either tail (K2,
K2b, K2d, K2d-PI) at every shape runs the whole tick on 16 threads per
instance: the ragged fleet of the small checks (1001 instances) ends each of
its launches in a partial block, the Cholesky phases print their units'
launch, and a phase after the last prints the geometry of each such unit
beside the constrained tick's, which the kernels line's rows of those
kernels carry. The whole-window box-ADMM (K4 ``admm_solve``, with its body
K3) and the block-tridiagonal solve (K5 ``tridiag_solve``, both routes; the
standard route reads its layout and warm-up mask in the kernel) run 16
threads per instance too: the last phase prints their launches at s=9 and
s=15 in both types (K5 with the chain in shared memory and in global
scratch, the two timed in turns), which their rows carry, and K4's row at s=9 carries the per-tick
run (``box_per_tick``): the mean time per launch beside the mean bound of
those launches, from the iterations each returned.

The facade group, after the standard layout's: the online surface
(``ops/facade.py``) on one instance, Go1 at the bench's settings.
``PipelineEstimator(use_pallas=True)`` streams 200 ticks in float64 in uneven
blocks against the offline pipeline replay at B=1 with plain consts,
unconstrained (K5 at B=1 every tick) and with the bench's box (K4 every
tick), each launch count exactly the ticks plus one; its carry, written
halfway, resumes in a fresh estimator bit for bit; the float32 HIL stream of
``examples/run_hil.py`` (500 ticks, blocks of 20, the native BlockFeeder,
built here if missing) is gated on its velocity RMSE and its float32-float64
delta, and prints its per-tick latency; ``DecentralizedEstimator`` (no
kernel) is held to ``run_mhe`` and ``run_kf``; and K5 and K4 at B=1 are held
to their plain versions and timed, their launches queued behind a spin on the
card so that the host's launch cost is hidden.

The kernels are built from csrc/ at the start: the Go1 shared-clock
libraries first, every unit at once; every other library compiles at a
lower priority while the phases run, in the order the phases need them (the
stage ablation's last), and each phase waits for its own libraries only.

Any failed check ends the run with a non-zero exit code. Each phase prints one
JSON line; the line before the last lists every kernel, the last line is the
verdict.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

from decentralized_ekf_mhe_tpu_torch import native
from decentralized_ekf_mhe_tpu_torch.config import EKFParams, load_yaml_params
from decentralized_ekf_mhe_tpu_torch.examples import run_hil
from decentralized_ekf_mhe_tpu_torch.io import synth
from decentralized_ekf_mhe_tpu_torch.kernels import _build, _group, _work
from decentralized_ekf_mhe_tpu_torch.kernels import admm_kernel, ekf_kernel, tridiag_kernel
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import admm, ekf_lanes, estimator, mhe, mhe_lanes, tridiag
from decentralized_ekf_mhe_tpu_torch.ops.facade import DecentralizedEstimator, PipelineEstimator
from decentralized_ekf_mhe_tpu_torch.parallel import batch
from decentralized_ekf_mhe_tpu_torch.tools import roofline
from decentralized_ekf_mhe_tpu_torch.utils import checkpoint

DEV = torch.device("cuda")
F32, F64 = torch.float32, torch.float64

# main-path size (the headline fleet of the reference's bench)
N_WIN, T_MAIN, B_MAIN, RING = 20, 2000, 1024, 16
SKIP = 100            # warm-up ticks left out of the RMSE
# small size of the split-log, shared-quaternion and ragged-fleet checks (the
# eager plain versions are Python loops of thousands of small launches); the
# ragged fleet is odd, divisible by no power of two up to 32, so that every
# launch of a group of threads per instance ends in a partial block
T_CHK, B_CHK, B_RAGGED, T_RAGGED = 48, 256, 1001, 24

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 3.35 TB/s,
# 67 TFLOP/s float32 outside the tensor cores
PEAK_BYTES_S, PEAK_F32_FLOPS = roofline.PEAK_BYTES_S, roofline.PEAK_F32_FLOPS

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
# held against its eager plain version at full width (6 ring wraps; float64
# element-wise, float32 for the plain version's time)
V_BOX, T_PER_TICK, T_BOX_PLAIN = 0.3, 200, 120
# the depth of the float32 plain versions at full width, timed and held to
# the float64 ones by accuracy (eager loops of small launches, the longest
# phases of this script)
T_PLAIN_F32 = 60

# per-lane camera clocks: lane b follows clock b % 15 (vo_every 5..9, latency
# 1..3 ticks), every 64th lane has no VO at all; the depth of the ragged-fleet
# check and of the eager per-lane EKF timing run
N_CLOCKS, VO_FREE_EVERY, T_RAGGED_PI, T_EKF_PI = 15, 64, 30, 100

# the constrained tick on per-lane clocks at full width: its dual iterate y
# (y += rho (alpha x~ + (1 - alpha) z - z+), rho = 5000) carries the primal
# iterates' rounding times rho, so at a few elements it moves by about
# TOL_MHE's limit with the order and the contraction of the arithmetic (the
# plain version itself does, between the card and the CPU: PERF.md §7). There
# the kernel as built holds y to Y_OVER_TOL_FMA times that limit, and the
# kernel built with FMAD_OFF must meet TOL_MHE itself against the plain
# version on the CPU, on the FMA_LANES lanes where the built kernel's y is
# furthest off (fma_witness). That build needs the float64 constrained
# kernels only, and compiles no other (csrc/mhe.cu)
FMAD_OFF, Y_OVER_TOL_FMA, FMA_LANES = ("-fmad=false", "-DDEM_MHE_ONLY_BOX_F64"), 10.0, 8
# K2c on the shared clock at Cassie's shape (s=15) shows the same: at full
# width its y came to 1.98 times TOL_MHE's limit at one element (x and z at
# 1e-10). There the kernel built without FMA contraction is no closer to the
# plain version on the CPU (1.97 times), and the plain version on the card is
# 2.04 times the limit off the same code on the CPU: y is not reproducible to
# that limit by the reference's own arithmetic once the rounding changes. So
# that one comparison (legged_full_width) holds y to Y_OVER_TOL_ROUNDING times
# the limit, about 1.5 times the largest of those readings, and runs
# fma_witness, which there must find the plain version itself beyond the
# limit between card and CPU, and the kernel as built within
# Y_OVER_TOL_ROUNDING of the plain version on the CPU (x, z and the counts
# within the limit itself)
Y_ROUNDING_ROBOTS, Y_OVER_TOL_ROUNDING = ("cassie", "cassie_bench"), 3.0

# the Cassie and PogoX fleets: each robot's own parameter file (N=20) and the
# synthetic log the reference's bench runs them on (seed 2, bench.py:459-460);
# and Cassie's shape at the bench's own settings ("cassie_bench", see
# robot_params), whose float32 runs stay finite over the whole log
LEGGED, LEGGED_LOG_SEED = ("pogox", "cassie"), 2
# the fleets on Go1's synthetic log (seed 0): Go1's, and "go1feet", the
# reference bench's Go1 estimator with its foot positions as states
# (leg_odom_type=1, four legs: s = 9 + 3·4 = 21, m=12; bench.py:455-458
# builds cassie_bench the same way), which every group kernel runs on a warp
# per instance
GO1_LOGS = ("go1", "go1feet")
# each fleet's velocity-RMSE gate against ground truth: Go1's bench
# (bench.py:178-181), the other shapes' (bench.py:484)
RMSE_GATE = {"go1": 0.1, "cassie": 0.5, "pogox": 0.5, "cassie_bench": 0.5, "go1feet": 0.5}
# the constrained runs' float64 twin covers the first T_BOX_F64 ticks
T_BOX_F64 = 200
# fault F6 (ROADMAP.md): with Cassie's parameter file the float32 estimate
# drifts from the float64 one — position and feet by centimetres within a
# few hundred ticks, velocity too after about 500 — and turns non-finite after
# a thousand-odd ticks (the arrival cost's float32 Schur complement stops
# being positive definite), in the reference as in this package
# (tests/test_torch_foot_states_float32.py); float64 stays sound. Such a
# fleet's float32 gates hold over its first F6_TICKS[fleet] ticks, which must
# be finite; its phases print the first non-finite tick and the
# float32-float64 velocity difference per 100 ticks. Every other fleet's
# float32 runs are gated over the whole log and must stay finite throughout.
# Cassie's shape at the bench's settings ("cassie_bench") is sound in float32
# over the whole log on the bench's own route (bench_route: the Gauss-Jordan
# tick on the shared clock, gated there over the whole log); with the box, on
# per-lane clocks or with the Cholesky tail it stays within 2e-3 m/s of
# float64 and inside the box over its first 1000 ticks, and then leaves the
# box, drifts by tenths to tens of m/s or turns non-finite (the Cholesky tail
# at tick 1073), while float64 holds
F6_TICKS = {"cassie": 300, "cassie_bench": 1000}
# yaml Cassie's pipelines (main_path, box_path: cells (g), (h)) run their first
# T_F6_BOX ticks, the ticks their float32 gates cover (F6_TICKS), and the
# constrained Cassie tick's time row comes from bench_route's fleet
T_F6_BOX = 300
# the pipeline runner on Cassie's shape at the bench's settings (bench_route)
# runs its first T_F6_PIPE ticks, to show where its float32 estimate stops
# being finite
T_F6_PIPE = 1000
# on per-lane clocks at Cassie's shape (cells (l), (m)) the float32 plain
# tick also runs on the card over ticks F6_WITNESS of the counted run's
# inputs, from the kernel's state, to show whether the plain version departs
# from float64 and leaves the box in those ticks as the kernel does (F6) or
# not (a float32 fault of the kernel alone): ``f6_witness``
F6_WITNESS = (1000, 1100)
# the go1feet group (Go1 with its foot positions as states, s=21): its
# K2b, K2d and K2d-PI rows run the first T_GO1FEET_CLOCKS ticks at full
# width; its constrained pipeline (v) runs the first T_GO1FEET_BOX ticks (the
# constrained tick's one-thread prelude on lane 0 is an s^3 chain: at s=21
# about 2.7 times Cassie's per tick, on one lane of each warp where two lanes
# of a warp share it below s=16: 68 ms a tick at B=1024 in float32), its
# float64 twin T_BOX_F64 of them; K2c-PI's row runs T_GO1FEET_PI_BOX ticks
# (its RMSE gate covers those after the SKIP warm-up ticks); the plain
# versions of its rows run the first T_GO1FEET_PLAIN ticks at full width
# (eager loops of small launches)
T_GO1FEET_CLOCKS, T_GO1FEET_BOX, T_GO1FEET_PI_BOX, T_GO1FEET_PLAIN = 400, 500, 150, 40
# the Cholesky tail (DEM_MK_SOLVE=chol) against the Gauss-Jordan one: the
# reference's own test of the two tails (tests/test_megakernel.py:261-273)
TOL_CHOL_VS_GJ = dict(rtol=1e-9, atol=1e-10)
# cell (q), the standard layout: K5's standard-layout route is held against
# its plain version on every window of the fused runner's first T_STD_CHK
# ticks of cell (a)'s fleet (float64; the warm-up ticks among them), the
# float64 run against the lanes runner's tick kernel at the reference's
# lanes-vs-standard tolerance (tests/test_mhe_lanes.py:157); the float64
# oracle's KF baseline at the reference test's gate (tests/test_kf_slice.py:99)
# and its constrained single-instance run over T_ORACLE_BOX ticks; the oracle
# replays Go1's synthetic log (seed 0) of T_ORACLE ticks (a single instance is
# host-bound on the card: thousands of small launches per tick)
T_STD_CHK, TOL_STD_VS_LANES, KF_RMSE_GATE, T_ORACLE_BOX = 40, dict(rtol=1e-7, atol=1e-8), 0.06, 200
T_ORACLE = 300
# the element-wise float64 check of the main path's kernels (full_size) covers
# its first T_F64_CHK ticks at TOL_MHE; over the whole log std_path holds the
# lanes runner's tick kernel (K2) against the standard-layout fused runner (its
# window solves through K5's standard route on the card) at TOL_STD_VS_LANES
T_F64_CHK = 300
# cell (s), the stage ablation (K2e): each ablated unit is held against its
# plain version over T_ABL ticks (the window full, then six ticks of
# marginalization) of a B_ABL-instance fleet in float64, x and the window
# state it leaves, and the tool's stage tables run over the first T_ABL_TABLE
# ticks of the headline fleets. The "solve" stage
# returns a sum over the window's slots of the assembled system's entries,
# which are themselves sums of products of either sign up to about 1e12 in
# size that cancel to a few hundred or to rounding noise, so no limit on the
# value separates rounding from a wrong sum (the kernel read 41 times TOL_MHE
# there, PERF.md §7). It is held to ATOL_SOLVE + RTOL_SOLVE times the
# magnitude of its elementary products (``mrk.solve_stage_scales``' terms: the normal
# equations of the absolute values), the scale of the rounding that the
# kernel's and the plain version's orders of summation leave in it: 900 eps,
# where the sound kernel reads up to 6.3e-14 (280 eps) of it; the readings
# of a kernel that wrote zeros or dropped r, and on the value and on the
# masked system's own entries (whose own rounding is of the 4e10 weights'
# size), are printed beside it
T_ABL, B_ABL, T_ABL_TABLE = N_WIN + 6, 64, 100
RTOL_SOLVE, ATOL_SOLVE = 2e-13, 1e-8
# the facade group (the online surface, ops/facade.py) on Go1's synthetic log
# (seed 0) at the bench's settings, one instance: PipelineEstimator streamed
# in float64 over the first T_FACADE ticks in the uneven blocks FACADE_SPLITS
# (its carry snapshot after tick FACADE_SNAPSHOT - 1, resumed into a fresh
# estimator), the HIL stream (examples/run_hil.py) in float32 over T_HIL ticks
# in blocks of HIL_BLOCK, DecentralizedEstimator over T_FACADE_STD ticks, and
# the window solves at B=1 timed over FACADE_REPS launches queued behind a
# spin of SPIN_CYCLES clock cycles on the card (so the host's launch cost is
# hidden; K4 over K4_REPS: its wrapper queues about 20 operations a call, and
# a full launch queue would stall the host until the spin ends)
T_FACADE, T_HIL, HIL_BLOCK, T_FACADE_STD = 200, 500, 20, 50
FACADE_SPLITS, FACADE_SNAPSHOT = ((1, 11), (11, 97), (97, 150), (150, T_FACADE)), 150
FACADE_REPS, K4_REPS, SPIN_CYCLES = 200, 25, 2_000_000_000
HIL_RMSE_GATE, TOL_FACADE_STD = 0.1, dict(rtol=0, atol=1e-9)
# a main-path run longer than this many seconds is timed once, in its
# counted run (the spread within a call is about 3%)
WALL_ONCE_S = 2.0
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


T_START = time.time()
# the libraries the Go1 shared-clock phases launch, built first; every other
# library compiles beside the phases at a lower priority, BUILDS_AT_ONCE
# libraries at a time in the order the phases need them (LATER_BUILDS; a
# build without FMA contraction, for fma_witness, as (library, FMAD_OFF)),
# and each later phase waits for its own only (``need``). A compiler beside
# them halves the speed of the host-bound eager plain versions (PERF.md §5),
# and more of them than cores slow them further: at most NVCC_JOBS nvcc
# processes run beside the phases. The stage ablation's units that the last
# phases launch (ABL_LIBRARIES: every float64 unit, and the float32 units of
# the stage tables, ABL_TABLES) compile last; its other float32 units no
# phase launches, and they are not built here (ABL_NOT_BUILT)
GO1_LIBRARIES = ("tridiag_s9", "ekf", "mhe_go1", "admm_s9")
NVCC_JOBS = 6
# the variants whose stage table cell (s) draws at each shape, on its headline
# fleet ((a), (i), (k)), and the ablation library of each variant
ABL_TABLES = {"go1": ("", "chol", "box"), "pogox": ("",), "cassie": ("", "chol", "box")}
ABL_GROUP = {"": "abl", "chol": "abl_chol", "box": "abl_box"}
ABL_LIBRARIES = {m: tuple(f"mhe_{m}_{g}_f64" for g in _build.MHE_ABL_GROUPS)
                 + tuple(f"mhe_{m}_{ABL_GROUP[v]}_f32" for v in ABL_TABLES[m])
                 for m in ABL_TABLES}
LATER_BUILDS = ("mhe_go1feet", "tridiag_s21", "admm_s21", "mhe_go1_chol",
                "mhe_go1_pi", ("mhe_go1_pi", FMAD_OFF), "mhe_go1feet_chol", "mhe_go1feet_pi",
                "mhe_pogox", "mhe_pogox_chol", "mhe_pogox_pi",
                "tridiag_s15", "admm_s15", "mhe_cassie", ("mhe_cassie", FMAD_OFF),
                "mhe_cassie_chol", "mhe_cassie_pi",
                *ABL_LIBRARIES["go1"], *ABL_LIBRARIES["pogox"], *ABL_LIBRARIES["cassie"])
BUILDS_AT_ONCE = 4
ABL_NOT_BUILT = sorted(set(_build.LIBRARIES) - set(GO1_LIBRARIES)
                       - {b for b in LATER_BUILDS if isinstance(b, str)})
assert all(re.fullmatch(r"mhe_\w+_abl\w*_f32", n) for n in ABL_NOT_BUILT), ABL_NOT_BUILT


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw, "t_s": round(time.time() - T_START, 1)}),
          flush=True)


def go1_params():
    """The reference bench's Go1 estimator (N=20, ``bench.py``'s ``_params``)."""
    return roofline.bench_params()


def robot_params(model="go1"):
    """(EstimatorParams, EKFParams) of a robot: Go1's as above, Cassie's and
    PogoX's from their parameter files, "cassie_bench", Cassie's shape at
    the reference bench's own settings (Go1's with 2 legs and foot positions
    as states, bench.py:455-458), and "go1feet", Go1's with its 4 legs' foot
    positions as states (s=21)."""
    if model == "go1":
        return go1_params(), EKFParams()
    if model in ("cassie_bench", "go1feet"):
        p = go1_params()
        p.num_legs, p.leg_odom_type = (2, 1) if model == "cassie_bench" else (4, 1)
        return p, EKFParams()
    return load_yaml_params(os.path.join(CONFIGS, f"parameters_{model}.yaml"))


def make_fleet(T, B, dtype, seed, vo_noise=1.0, model="go1"):
    """One synthetic log tiled into a perturbed B-instance fleet on the card:
    per-lane IMU/encoder noise, per-lane VO quaternion into the EKF, per-lane
    VO translation into the MHE, one shared camera clock. ``model`` picks the
    robot: Go1's log (seed 0, 4 legs; Go1's estimator, or "go1feet" with its
    foot positions as states), or Cassie's or PogoX's (seed 2, their own
    legs)."""
    p, pe = robot_params(model)
    log = synth.generate(synth.SynthConfig(
        T=T, seed=0 if model in GO1_LOGS else LEGGED_LOG_SEED, num_legs=p.num_legs))
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


def clock_logs(T, model="go1"):
    """The synthetic log of each camera clock: the same seed as ``model``'s
    fleet, so the same trajectory and IMU/encoder streams; VO every 5..9
    ticks, 1..3 ticks late."""
    legs = robot_params(model)[0].num_legs
    return [synth.generate(synth.SynthConfig(
        T=T, seed=0 if model in GO1_LOGS else LEGGED_LOG_SEED, num_legs=legs,
        vo_every=5 + k % 5, vo_latency=1 + (k // 5) % 3))
        for k in range(N_CLOCKS)]


def make_clock_fleet(T, B, dtype, seed, ekf_per_lane=False, model="go1"):
    """The fleet of ``make_fleet`` (per-lane IMU/encoder noise, per-lane VO
    quaternion into the shared-clock EKF blocks) with a camera clock per
    lane: lane b takes the VO schedule and content of clock b % 15, every
    64th lane none, and its own VO-content draw (std ``vo_p_std``) on its
    own events. ``ekf_per_lane`` gives the EKF blocks each lane's own
    delayed-VO events too. ``model`` picks the robot (see ``make_fleet``).
    Returns (log, data_b, eb, vo) with a per-instance ``vo`` (active,
    tick_pre, tick_now (T,B), dp_body (T,3,B))."""
    p = robot_params(model)[0]
    log, data_b, eb, _ = make_fleet(T, B, dtype, seed, model=model)
    logs = clock_logs(T, model)
    lane = torch.arange(B, device=DEV) % N_CLOCKS
    free = torch.arange(B, device=DEV) % VO_FREE_EVERY == VO_FREE_EVERY - 1
    vos = [estimator.vodata_from_log(lg, dtype=dtype, device=DEV) for lg in logs]
    pick = lambda f: torch.stack([getattr(v, f) for v in vos], -1)[..., lane].contiguous()
    active = pick("active") & ~free
    g = torch.Generator(device=DEV).manual_seed(seed + 1000)
    std = torch.tensor(p.vo_p_std, dtype=dtype, device=DEV)[None, :, None]
    dp = pick("dp_body") + std * torch.randn((T, 3, B), generator=g, dtype=dtype,
                                             device=DEV) * active[:, None, :]
    vo = estimator.VOData(active=active, dp_body=dp, tick_pre=pick("tick_pre"),
                          tick_now=pick("tick_now"))
    if ekf_per_lane:
        ebs = [estimator.ekfblocks_from_log(lg, dtype=dtype, device=DEV) for lg in logs]
        pick_e = lambda f: torch.stack([getattr(e, f) for e in ebs], -1)[..., lane].contiguous()
        q = pick_e("vo_q")
        eb = eb._replace(vo_active=pick_e("vo_active") & ~free, vo_q=q,
                         vo_steps_back=pick_e("vo_steps_back"))
    return log, data_b, eb, vo


def cast(nt, dtype):
    """Cast the float leaves of a NamedTuple of tensors to ``dtype``."""
    return type(nt)(*((a.to(dtype) if a.is_floating_point() else a).contiguous()
                      for a in nt))


def head(fleet, T):
    """The first T ticks of a (TickData, EKFBlocks, VOData) fleet."""
    return tuple(type(nt)(*(a[:T] for a in nt)) for nt in fleet)


def close(a, b, rtol, atol):
    err = (a - b).abs()
    ok = bool((err <= atol + rtol * b.abs()).all()) and bool(torch.isfinite(a).all())
    return ok, float(err.max())


def timed(fn, reps=3):
    """Best-of-reps device time of fn() in ms (CUDA events), after a warm-up
    call."""
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
                         d0.J_foot, d0.dq, d0.contact, dtype=dtype,
                         per_instance_vo=vo.active.ndim == 2, device=DEV)
    vo_inc = estimator.vo_world_increments(data_l.R_sb, vo)
    return st0, vo_inc


def seg(data_l, vo, vo_inc, sl):
    return (estimator.TickData(*(a[sl].contiguous() for a in data_l)),
            estimator.VOData(*(a[sl] for a in vo)), vo_inc[sl].contiguous())


def vel_rmse(x_tsb, ref_tsb, skip=0, lanes=slice(None)):
    err = x_tsb[skip:, 3:6, lanes].double() - ref_tsb[skip:, 3:6, lanes].double()
    return float(torch.sqrt((err ** 2).mean()))


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


def ptxas_figures(out):
    """{kernel: [registers, stack frame, spill stores, spill loads]} from
    ptxas' report of one unit."""
    figs, name, prop = {}, None, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            figs[name] = [None, 0, 0, 0]
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            prop = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name and prop == name:
            figs[name][1:] = [int(v) for v in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            figs[name][0] = int(m.group(1))
    return figs


def build_report(libraries):
    """Each library's seconds, the slowest units and every kernel's ptxas
    figures from ``_build.report``."""
    figs, seconds, slowest = {}, {}, []
    for lib in libraries:
        seconds[lib] = round(_build.report[lib]["seconds"], 2)
        for flags, out, done in _build.report[lib]["units"]:
            slowest.append((round(done, 2), f"{lib} {flags}"))
            for kern, fig in ptxas_figures(out).items():
                figs[f"{lib} {kern}"] = fig
    return dict(library_seconds=seconds, slowest_units_s=sorted(slowest, reverse=True)[:4],
                ptxas_registers_frame_spill_stores_loads=figs)


def phase_build(pool):
    """The Go1 shared-clock phases' libraries, every unit at once, waited for
    here; then every later build (LATER_BUILDS) in ``pool``, in the order the
    phases need them, at scheduling priority 10, which go on compiling while
    the Go1 phases run. Returns those builds' futures."""
    t0 = time.time()
    _build.build(ptxas=True, libraries=GO1_LIBRARIES)
    for name in GO1_LIBRARIES:
        _build.load(name)
    _build.limit_jobs(NVCC_JOBS)
    builds = start_builds(pool, LATER_BUILDS)
    emit("build", seconds=round(time.time() - t0, 2), libraries=list(GO1_LIBRARIES),
         not_built_no_phase_launches_them=ABL_NOT_BUILT, nvcc_jobs_beside_the_phases=NVCC_JOBS,
         flags=" ".join(_build.NVCC_FLAGS), **build_report(GO1_LIBRARIES),
         compiling_beside_the_go1_phases=[" ".join((b[0],) + b[1]) if isinstance(b, tuple)
                                          else b for b in LATER_BUILDS],
         at_once=BUILDS_AT_ONCE)
    return builds


def start_builds(pool, names):
    """Submit the builds ``names`` to ``pool``, at scheduling priority 10:
    {name: future}; a name (library, flags) is a variant build."""
    return {b: pool.submit(_build.build, libraries=(b[0],), extra_flags=b[1], nice=10)
            if isinstance(b, tuple) else
            pool.submit(_build.build, ptxas=True, libraries=(b,), nice=10) for b in names}


def need(builds, *libs):
    """Wait for the builds of ``libs`` (started by ``phase_build``; a witness
    build as (library, FMAD_OFF)) and load them; print how long this waited
    and each library's build seconds and ptxas figures."""
    t0 = time.time()
    for lib in libs:
        builds[lib].result()
        _build.load(*lib) if isinstance(lib, tuple) else _build.load(lib)
    names = [lib for lib in libs if not isinstance(lib, tuple)]
    witness = {lib[0]: round(_build.report[" ".join(lib[:1] + lib[1])]["seconds"], 2)
               for lib in libs if isinstance(lib, tuple)}
    emit("build_ready", libraries=names, waited_s=round(time.time() - t0, 2),
         **build_report(names), without_fma_seconds=witness)


def ekf_geometry_phase():
    """K1's launch on its group of threads per instance, in both types and
    with either form of the VO quaternion, as the card reports it
    (``ekf_kernel.occupancy``) held equal to the geometry the wrapper computes
    (``_group.ekf_geometry``), with the kernel's ptxas figures; every launch
    keeps all B_MAIN instances resident at once. Returns the float32 figures
    (shared VO quaternion, as on the main path) for the kernels line."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    figs = tick_ptxas("ekf", "ekf_kernel")
    res = {}
    for dtype, name in ((F32, "float"), (F64, "double")):
        for pl in (False, True):
            want = ekf_kernel.geometry(RING, 3, dtype, pl)
            card = ekf_kernel.occupancy(RING, 3, dtype, pl)
            assert (card["shared_bytes"], card["instances_per_block"], card["threads_per_block"],
                    card["ticks_per_chunk"]) == (
                want.shared_bytes, want.instances_per_block, want.threads_per_block,
                want.ticks_per_chunk), (name, pl, card, want)
            assert card["instances_per_sm"] * n_sm >= B_MAIN, (name, pl, card)
            res[f"{name} {'per-lane' if pl else 'shared'} vo_q"] = card
    emit("ekf_geometry", threads_per_instance=_group.EKF_G, ring=RING, substeps_per_tick=3,
         sms=n_sm, ptxas_registers_frame_spill_stores_loads=figs, **res)
    return dict(res["float shared vo_q"], ptxas_registers_frame_spill_stores_loads=figs)


def tick_ptxas(lib, kernel):
    """The ptxas figures of one tick kernel of ``lib``: {"float": [...],
    "double": [...]} (registers, stack frame, spill stores, spill loads)."""
    out = {}
    for _, text, _ in _build.report[lib]["units"]:
        for name, fig in ptxas_figures(text).items():
            m = re.search(rf"{len(kernel)}{kernel}I([fd])", name)
            if m:
                out[{"f": "float", "d": "double"}[m.group(1)]] = fig
    return out


# the steps-back cases K1's float64 check adds to the fleet's camera clock:
# (tick, steps back) on the tick's first substep — beyond t, 1, R - 1, R,
# beyond R, and (tick 17, twelve back) a replay that reaches into the chunk
# of the input stream staged before (16 ticks at Go1's 3 substeps per tick)
EDGE_EVENTS = ((1, 10), (3, 1), (8, RING - 1), (12, RING), (20, 40), (17, 12), (30, 5))


def edge_schedule(eb):
    """``eb`` with a VO event of EDGE_EVENTS at the first valid substep of each
    of their ticks; asserts that each case is reached as named."""
    act, sb = eb.vo_active.clone(), eb.vo_steps_back.clone()
    valid = eb.valid.tolist()
    for k, n in EDGE_EVENTS:
        j = valid[k].index(True)
        act[k, j], sb[k, j] = True, n
    t = {k: sum(map(sum, valid[:k])) for k, _ in EDGE_EVENTS}
    assert EDGE_EVENTS[0][1] > t[EDGE_EVENTS[0][0]] and all(
        n <= t[k] for k, n in EDGE_EVENTS[1:]), t
    return eb._replace(vo_active=act, vo_steps_back=sb)


def ekf_err(q_k, fin_k, q_p, fin_p, tag):
    """K1 against its plain version: q_seq and every tensor of the state
    carried out within TOL_EKF, the same substep count; the largest error."""
    errs = []
    for name in ("q_seq", "q", "P", "gyro_hist", "accel_hist", "q_hist", "P_hist"):
        a, b = (q_k, q_p) if name == "q_seq" else (getattr(fin_k, name), getattr(fin_p, name))
        ok, err = close(a, b, **TOL_EKF)
        assert ok, (tag, name, err)
        errs.append(err)
    assert fin_k.t == fin_p.t, (tag, fin_k.t, fin_p.t)
    return max(errs)


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

    # ---- K1 ekf_stage: per-lane and shared measured quaternion, split log,
    # a ragged fleet, the steps-back edge cases; q_seq and every state tensor
    _, _, eb_s, _ = make_fleet(T_CHK, B_CHK, F64, seed=1, vo_noise=0.0)
    _, _, eb_r, _ = make_fleet(T_CHK, B_RAGGED, F64, seed=2)
    st_r = ekf_lanes.init_state(pe, B_RAGGED, RING, F64, device=DEV)
    errs = {}
    for tag, eb, st_ in (("per_lane_vo_q", eb_l, st), ("shared_vo_q", eb_s, st),
                         ("ragged_B", eb_r, st_r), ("steps_back_edges", edge_schedule(eb_l), st)):
        q_p, fin_p = ekf_kernel.replay_plain(ec, st_, eb)
        q_k, fin_k = ekf_kernel.replay(ec, st_, eb, device=DEV)
        errs[tag] = ekf_err(q_k, fin_k, q_p, fin_p, tag)
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
    res["ekf_err"] = dict(errs, B_ragged=B_RAGGED, steps_back=EDGE_EVENTS)

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


def main_path(model, fleet64, fleet32, gt_v):
    """``model``'s fleet through the pipeline runner at full width: launches,
    accuracy against ground truth (``RMSE_GATE``) and against the float64 run
    of the same path on the same fleet, the float32-float64 velocity
    difference per 100 ticks, wall (best of 3 after the counted run, or the
    counted run's own when it took over WALL_ONCE_S) and the tick kernel's
    own time in those runs; for every robot but Go1 (whose lanes
    runner ``box_sweep`` and the per-lane-clock phases drive) the lanes runner
    once, the reference bench's route for the other shapes. Returns the
    counted run's launches, the float64 run's (x, q) and the tick kernel's
    time alone (best of the 3 runs)."""
    p, pe = robot_params(model)
    s, gate = p.dim_state, RMSE_GATE[model]
    T = fleet32[0].accel_b.shape[0]
    runner = batch.make_pipeline_fleet_runner(p, pe, F32, use_megakernel=True, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    mrk.timer.on = True
    (x, v, q), counted_ms = wall_ms(lambda: runner(*fleet32))
    mrk.timer.on = False
    counted_tick_ms = mrk.timer.ms()
    counts = read_counts()
    assert counts == dict(NO_LAUNCH, tridiag_solve=1, ekf_stage=1, mhe_tick=1), counts
    assert x.shape == (T, B_MAIN, s) and v.shape == (T, B_MAIN, 3)
    assert q.shape == (T, 4, B_MAIN) and torch.isfinite(q).all()
    n, t_bad = f32_ticks(model, x)      # n = T but for fault F6
    assert bool(torch.isfinite(v[:n]).all())
    rmse = fleet_rmse(x[:n], gt_v[:n])
    assert rmse < gate, f"{model} fleet velocity RMSE vs ground truth {rmse}"

    # float64 run of the same path on the same fleet
    run64 = batch.make_pipeline_fleet_runner(p, pe, F64, use_megakernel=True, device=DEV)
    x64, _, q64 = run64(*fleet64)
    assert bool(torch.isfinite(x64).all()), f"{model} float64 run not finite"
    r64_all = fleet_rmse(x64, gt_v)
    assert r64_all < gate, f"{model} float64 RMSE vs ground truth {r64_all}"
    r64 = fleet_rmse(x64[:n], gt_v[:n])
    assert abs(rmse - r64) < 1e-3, (f"{model} f32-vs-f64 velocity-RMSE delta", rmse, r64)
    # the float32 velocity's largest departure from float64, per 100 ticks
    dv = (x[..., 3:6].double() - x64[..., 3:6]).abs().reshape(T // 100, -1)
    drift = [float(d.max()) if bool(torch.isfinite(d).all()) else None for d in dv]
    del dv

    # wall time of the whole pipeline: best of 3 after the counted run, or
    # the counted run's own for a fleet whose run takes seconds
    walls, tick_ms = [counted_ms / 1e3], counted_tick_ms
    if walls[0] <= WALL_ONCE_S:
        walls = []
        mrk.timer.on = True
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            runner(*fleet32)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
        mrk.timer.on = False
        tick_ms = mrk.timer.ms()
    tick_alone_ms = min(tick_ms)
    wall = min(walls)

    lanes_runner = None
    if model != "go1":
        lanes = batch.make_lanes_fleet_runner(p, F32, use_megakernel=True, device=DEV)
        reset_counts()
        (xl, _), lanes_ms = wall_ms(lambda: lanes(fleet32[0], fleet32[2]))
        lanes_counts = read_counts()
        assert lanes_counts == dict(NO_LAUNCH, tridiag_solve=1, mhe_tick=1), lanes_counts
        n_l, t_bad_l = f32_ticks(model, xl)
        lanes_rmse = fleet_rmse(xl[:n_l], gt_v[:n_l])
        assert lanes_rmse < gate, f"{model} lanes runner RMSE {lanes_rmse}"
        lanes_runner = {"wall_s": lanes_ms / 1e3, "launches": lanes_counts,
                        "rmse_vs_ground_truth": lanes_rmse,
                        "f32_gated_ticks": n_l, "f32_first_nonfinite_tick": t_bad_l,
                        "ticks_per_s": B_MAIN * (T - 1) / (lanes_ms / 1e3)}
    emit("main_path" if model == "go1" else f"{model}_main_path",
         config=f"{model} N={N_WIN} s={s} m={p.dim_meas} L={p.num_legs} "
                f"leg_odom_type={p.leg_odom_type} ring={RING}",
         T=T, B=B_MAIN, dtype="float32", launches=counts, rmse_vs_ground_truth=rmse,
         rmse_f64=r64, rmse_f64_all_ticks=r64_all, rmse_gate=gate,
         f32_gated_ticks=n, f32_first_nonfinite_tick=t_bad,
         f32_vs_f64_velocity_max_abs_per_100_ticks=drift,
         wall_s=wall, walls_s=walls, wall_from="the counted run" if len(walls) == 1 else
         "best of 3 after the counted run", pipeline_ticks_per_s=B_MAIN * (T - 1) / wall,
         mhe_tick_kernel_only_ms=tick_alone_ms,
         peak_mem_bytes=torch.cuda.max_memory_allocated(), lanes_runner=lanes_runner)
    return counts, x64, q64, tick_alone_ms


def reset_counts():
    for mod in (tridiag_kernel, ekf_kernel, mrk, admm_kernel):
        mod.launches = 0
    mrk.launches_box = mrk.launches_pi = mrk.launches_pi_box = mrk.launches_chol = 0
    mrk.launches_pi_chol = 0
    for by_stage in mrk.launches_abl.values():
        by_stage.update(dict.fromkeys(mrk.ABLATE_STAGES, 0))
    admm_kernel.launches_core = 0
    tridiag_kernel.launches_batched = 0


def read_counts():
    return {"tridiag_solve": tridiag_kernel.launches, "ekf_stage": ekf_kernel.launches,
            "mhe_tick": mrk.launches, "mhe_tick_box": mrk.launches_box,
            "mhe_tick_pi": mrk.launches_pi, "mhe_tick_pi_box": mrk.launches_pi_box,
            "mhe_tick_chol": mrk.launches_chol, "mhe_tick_pi_chol": mrk.launches_pi_chol,
            "mhe_tick_abl": sum(sum(v.values()) for v in mrk.launches_abl.values()),
            "admm_solve": admm_kernel.launches,
            "admm_box_solve": admm_kernel.launches_core,
            "tridiag_solve_batched": tridiag_kernel.launches_batched}


NO_LAUNCH = {"tridiag_solve": 0, "ekf_stage": 0, "mhe_tick": 0, "mhe_tick_box": 0,
             "mhe_tick_pi": 0, "mhe_tick_pi_box": 0, "mhe_tick_chol": 0, "mhe_tick_pi_chol": 0,
             "mhe_tick_abl": 0, "admm_solve": 0,
             "admm_box_solve": 0, "tridiag_solve_batched": 0}


@contextlib.contextmanager
def tick_calls():
    """Record every ``mrk.replay_ticks`` call made inside (a runner makes
    one): its arguments, what it returned and the device time around it
    (CUDA events, read with ``call_ms`` after a synchronize), so that a
    runner's counted run also gives the tick's time, the inputs it ticked,
    its schedule and its ADMM iterations."""
    calls, inner = [], mrk.replay_ticks

    def spy(c, ks, data_l, vo, vo_inc, *a, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = inner(c, ks, data_l, vo, vo_inc, *a, **kw)
        e1.record()
        calls.append({"args": (c, ks, data_l, vo, vo_inc), "out": out, "events": (e0, e1)})
        return out

    mrk.replay_ticks = spy
    try:
        yield calls
    finally:
        mrk.replay_ticks = inner


def call_ms(call):
    return call["events"][0].elapsed_time(call["events"][1])


@contextlib.contextmanager
def mk_solve_env(tail):
    """``DEM_MK_SOLVE=tail`` inside, as a user sets it for a whole run."""
    old = os.environ.get("DEM_MK_SOLVE")
    os.environ["DEM_MK_SOLVE"] = tail
    try:
        yield
    finally:
        if old is None:
            del os.environ["DEM_MK_SOLVE"]
        else:
            os.environ["DEM_MK_SOLVE"] = old


def fleet_rmse(x_tbs, gt_v, lanes=slice(None)):
    """Fleet velocity RMSE of x (T,B,s) against the log's ground truth, over
    the ticks after the SKIP warm-up ticks (there must be some)."""
    assert x_tbs.shape[0] > SKIP, ("RMSE over no tick after the warm-up", x_tbs.shape[0], SKIP)
    err = x_tbs[SKIP:, lanes, 3:6].double() - gt_v[SKIP:, None]
    return float(torch.sqrt((err ** 2).mean()))


def split_vo_free(x_tbs, vo):
    """The lanes of a per-lane-clock fleet that have a camera (a (B,) mask),
    after checking that every value of theirs is finite; and the first tick at
    which a VO-free lane's estimate is not finite, or None. Without any VO the
    absolute position is held by the arrival cost alone, whose information
    the float32 marginalization loses to cancellation against the process
    model's 4e10 position weight: such a lane breaks down after several
    hundred ticks in float32, in the reference as in this package (ROADMAP.md,
    fault F5), and stays finite in float64."""
    cam = vo.active.any(0)
    assert bool(torch.isfinite(x_tbs[:, cam]).all()), "a lane with a camera is not finite"
    bad = ~torch.isfinite(x_tbs[:, ~cam]).all(-1).all(-1)
    return cam, (int(torch.nonzero(bad)[0, 0]) if bool(bad.any()) else None)


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
    """Each kernel against its plain version at the main path's size (T=2000,
    B=1024, N=20) on identical inputs, and the float64 main path against the
    chain of plain versions: float64 element-wise over the first T_F64_CHK
    ticks, float32 by the velocity-RMSE gate over the first T_PLAIN_F32 ticks
    (the eager plain versions are host-bound loops of small launches); the
    kernels' float32 times over the whole log, the plain versions' over
    T_PLAIN_F32 ticks; the bounds from this run's inputs."""
    p, pe = go1_params(), EKFParams()
    err, ms, plain_ms = {}, {}, {}
    head32 = head(fleet32, T_PLAIN_F32)

    # ---- float64, element-wise over the first T_F64_CHK ticks
    ec = ekf_lanes.make_consts(pe, F64)
    st = ekf_lanes.init_state(pe, B_MAIN, RING, F64, device=DEV)
    head64 = head(fleet64, T_F64_CHK)
    eb = head64[1]
    (q_p, fin_p), ekf_plain64_ms = wall_ms(lambda: ekf_kernel.replay_plain(ec, st, eb))
    q_k, fin_k = ekf_kernel.replay(ec, st, eb, device=DEV)
    ok, e1 = close(q_k, q_p, **TOL_EKF)
    ok2, e2 = close(fin_k.P_hist, fin_p.P_hist, **TOL_EKF)
    assert ok and ok2 and fin_k.t == fin_p.t, ("ekf_stage at full width", e1, e2)
    err["ekf_stage"] = max(e1, e2)

    c, tri, ks0, (d1, v1, i1) = stage_inputs(p, head64, q_p, F64)
    (x_p, _), mhe_plain64_ms = wall_ms(lambda: mrk.replay_ticks_plain(c, ks0, d1, v1, i1))
    x_k, ks_k = mrk.replay_ticks(c, ks0, d1, v1, i1, device=DEV)
    ok, e = close(x_k, x_p, **TOL_MHE)
    assert ok, ("mhe_tick at full width", e)
    err["mhe_tick"] = e

    tri_late = tuple(a.contiguous() for a in mhe_lanes._masked_system(
        c, mrk.mhe_state_from_kernel(ks_k, c)))
    errs = []
    for D, U, r in (tri, tri_late):
        ok, e = close(tridiag_kernel.solve_lanes(D, U, r, device=DEV),
                      tridiag_kernel.solve_lanes_plain(D, U, r), **TOL_MHE)
        assert ok, ("tridiag_solve at full width", e)
        errs.append(e)
    err["tridiag_solve"] = max(errs)

    # the float64 main path (EKF kernel -> tridiagonal kernel at tick 0 ->
    # MHE kernel) against the chain of plain versions
    x0_p = tridiag_kernel.solve_lanes_plain(*tri)[-1]
    okq, eq = close(q64_main[:T_F64_CHK], q_p, **TOL_EKF)
    okx, ex = close(torch.movedim(x64_main[:T_F64_CHK], 1, -1), torch.cat([x0_p[None], x_p]),
                    **TOL_MHE)
    assert okq and okx, ("float64 main path vs plain chain", eq, ex)
    err["main_path_f64"] = {"q": eq, "x": ex}

    # ---- float32: same inputs cast; the kernels over the whole log, the plain
    # versions over T_PLAIN_F32 ticks
    ec32 = ekf_lanes.make_consts(pe, F32)
    st32 = ekf_lanes.init_state(pe, B_MAIN, RING, F32, device=DEV)
    eb32 = fleet32[1]
    (q32p, _), plain_ms["ekf_stage"] = wall_ms(
        lambda: ekf_kernel.replay_plain(ec32, st32, head32[1]))
    q32k, _ = ekf_kernel.replay(ec32, st32, eb32, device=DEV)
    ms["ekf_stage"] = timed(lambda: ekf_kernel.replay(ec32, st32, eb32, device=DEV))
    ekf_kernel.timer.on = True
    timed(lambda: ekf_kernel.replay(ec32, st32, eb32, device=DEV))
    ekf_kernel.timer.on = False
    ekf_alone_ms = min(ekf_kernel.timer.ms())
    assert torch.isfinite(q32k).all()
    dq_k = float((q32k[:T_PLAIN_F32].double() - q_p[:T_PLAIN_F32]).abs().max())
    dq_p = float((q32p.double() - q_p[:T_PLAIN_F32]).abs().max())
    assert abs(dq_k - dq_p) < 1e-3, (dq_k, dq_p)

    R32 = q64_main.to(F32)
    c32, tri32, ks32, (d32, v32, i32) = stage_inputs(p, fleet32, R32, F32)
    _, _, ks32p, (d32p, v32p, i32p) = stage_inputs(p, head32, R32[:T_PLAIN_F32], F32)
    (x32p, _), plain_ms["mhe_tick"] = wall_ms(
        lambda: mrk.replay_ticks_plain(c32, ks32p, d32p, v32p, i32p))
    x32k, _ = mrk.replay_ticks(c32, ks32, d32, v32, i32, device=DEV)
    mrk.timer.on = True
    ms["mhe_tick"] = timed(lambda: mrk.replay_ticks(c32, ks32, d32, v32, i32, device=DEV), reps=2)
    mrk.timer.on = False
    kernel_only_ms = min(mrk.timer.ms())
    assert torch.isfinite(x32k).all()
    rk = vel_rmse(x32k[:T_PLAIN_F32 - 1], x_p[:T_PLAIN_F32 - 1], N_WIN)
    rp = vel_rmse(x32p, x_p[:T_PLAIN_F32 - 1], N_WIN)
    assert abs(rk - rp) < 1e-3, ("f32 velocity-RMSE delta", rk, rp)
    ms["tridiag_solve"] = timed(lambda: tridiag_kernel.solve_lanes(*tri32, device=DEV))
    plain_ms["tridiag_solve"] = timed(lambda: tridiag_kernel.solve_lanes_plain(*tri32))
    lib_ms, lib_diff = library_ms(*(torch.movedim(a, -1, 1) for a in tri32))

    emit("full_size", T=T_MAIN, B=B_MAIN, N=N_WIN, T_f64=T_F64_CHK, T_f32_plain=T_PLAIN_F32,
         tol_ekf=TOL_EKF, tol_mhe_tridiag=TOL_MHE, max_abs_err_f64=err,
         plain_f64_ms={"ekf_stage": ekf_plain64_ms, "mhe_tick": mhe_plain64_ms},
         f32={"ekf_q_err_kernel": dq_k, "ekf_q_err_plain": dq_p,
              "mhe_vel_rmse_vs_f64_kernel": rk, "mhe_vel_rmse_vs_f64_plain": rp,
              "ticks": [N_WIN + 1, T_PLAIN_F32 - 1]},
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
        "mhe_tick": ("decentralized_ekf_mhe_tpu_torch/csrc/mhe_body.cuh",
                     "decentralized_ekf_mhe_tpu/pallas/mhe_replay_kernel.py:917"),
    }, works, counts, err, ms, plain_ms,
        tridiag_solve={"library_ms": lib_ms, "library_minus_kernel_max_abs_f32": lib_diff,
                       "library": "torch.linalg.solve on the densified (B, N*s, N*s) system",
                       "max_abs_err_shape": {"T": T_F64_CHK, "B": B_MAIN}},
        **{k: {"plain_ms_shape": {"T": T_PLAIN_F32, "B": B_MAIN, "N": N_WIN},
               "max_abs_err_shape": {"T": T_F64_CHK, "B": B_MAIN},
               **({"kernel_alone_ms": ekf_alone_ms} if k == "ekf_stage" else {})}
           for k in ("ekf_stage", "mhe_tick")})


def mark_window_solve(kernels, geometry):
    """The constrained tick's rows (K2c, K2c-PI at every shape) name the file
    of their window solve, which runs on a group of threads per instance, and
    carry that launch's geometry as the card reports it
    (``box_geometry_phase``, float32)."""
    for row in kernels:
        name, _, model = row["name"].partition("[")
        if name in ("mhe_tick_box", "mhe_tick_pi_box"):
            row["window_solve_source"] = "decentralized_ekf_mhe_tpu_torch/csrc/admm_group.cuh"
            key = (model.rstrip("]") or "go1", name == "mhe_tick_pi_box")
            if key in geometry:
                row["threads_per_instance"] = geometry[key]["threads_per_instance"]
                row["group_geometry"] = geometry[key]


# the rows of the unconstrained tick: (per-lane clock, tail) by name
TICK_ROWS = {"mhe_tick": (False, "gj"), "mhe_tick_pi": (True, "gj"),
             "mhe_tick_chol": (False, "chol"), "mhe_tick_pi_chol": (True, "chol")}


def mark_tick_group(kernels, geometry):
    """The rows of the unconstrained tick (K2, K2b, K2d, K2d-PI at every
    shape, each on a group of threads per instance) carry that launch's
    geometry as the card reports it (``tick_geometry_phase``), float32, with
    the units' ptxas figures."""
    for row in kernels:
        name, _, model = row["name"].partition("[")
        model = model.rstrip("]")   # Go1's rows name no shape, but its Cholesky rows do
        key = ("" if model == "go1" else model, *TICK_ROWS.get(name, (None, None)))
        if key in geometry:
            row["threads_per_instance"] = geometry[key]["threads_per_instance"]
            row["group_geometry"] = geometry[key]


def kernel_rows(meta, works, counts, err, ms, plain_ms, **more):
    """One entry of the ``kernels`` line per kernel of ``meta`` (name ->
    (source, TPU kernel it replaces)); ``more`` adds per-kernel extra keys."""
    kernels = []
    for name, (src, repl) in meta.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": counts[name], "max_abs_err": err[name], "ms": ms[name],
            "plain_ms": plain_ms[name], **bound(works[name]),
            "library_ms": None,
            # every number is taken at this shape on identical inputs: ms and
            # plain_ms in float32, max_abs_err (kernel vs plain) in float64
            "shape": {"T": T_MAIN, "B": B_MAIN, "N": N_WIN},
            "ms_dtype": "float32", "max_abs_err_dtype": "float64",
            "bytes": works[name][0], "operations": works[name][1],
            **more.get(name, {}),
        })
    return kernels


# bound_ms and bound_by of (bytes, operations): the larger of the bytes over
# the memory rate and the operations over the float32 peak
bound = roofline.bound


# ------------------------------------------ the standard layout (cell (q))


def std_fleet(fleet, q64, dtype):
    """``fleet`` as the standard-layout fleet runner takes it: TickData
    (T,B,...) whose orientation comes from the float64 EKF quaternions
    ``q64`` (T,4,B), as ``stage_inputs`` builds it, and VOData whose per-lane
    translation is (T,B,3)."""
    data_b, _, vo = fleet
    T = data_b.accel_b.shape[0]
    R = torch.movedim(ekf_lanes.to_rot(q64[:T].to(dtype)), -1, 1).contiguous()
    return data_b._replace(R_sb=R), vo._replace(dp_body=vo.dp_body.transpose(1, 2).contiguous())


@contextlib.contextmanager
def route_calls(keep=lambda i: False):
    """Record every call of K5's standard-layout route
    (``tridiag_kernel.solve_batched``) made inside: CUDA events around the
    route and around its kernel launch, and, for the calls ``keep(i)``
    selects, the operands and the result."""
    calls, route, launch = [], tridiag_kernel.solve_batched, tridiag_kernel._launch
    event = lambda: torch.cuda.Event(enable_timing=True)

    def spy_launch(*a, **kw):
        e = calls[-1]["kernel_events"] = (event(), event())
        e[0].record()
        out = launch(*a, **kw)
        e[1].record()
        return out

    def spy_route(D, U, r, valid=None, device="cuda"):
        call = {"events": (event(), event())}
        calls.append(call)
        call["events"][0].record()
        out = route(D, U, r, valid=valid, device=device)
        call["events"][1].record()
        if keep(len(calls) - 1):
            call.update(args=(D, U, r, valid), out=out)
        return out

    tridiag_kernel.solve_batched, tridiag_kernel._launch = spy_route, spy_launch
    try:
        yield calls
    finally:
        tridiag_kernel.solve_batched, tridiag_kernel._launch = route, launch


def dense_system(D, U, r, valid=None):
    """A standard-layout block-tridiagonal system (K,B,s,s) (masked by
    ``valid`` as the route masks it) as B dense (K·s, K·s) matrices and (K·s,)
    right-hand sides: the operands of the library's one-call solve."""
    D, U, r = tridiag.mask_system(D, U, r, valid)
    K, B, s, _ = D.shape
    H = torch.zeros((B, K * s, K * s), dtype=D.dtype, device=D.device)
    for j in range(K):
        a = slice(j * s, (j + 1) * s)
        H[:, a, a] = D[j]
        if j < K - 1:
            b = slice((j + 1) * s, (j + 2) * s)
            H[:, a, b] = U[j]
            H[:, b, a] = U[j].transpose(-1, -2)
    return H, r.transpose(0, 1).reshape(B, K * s)


def library_ms(D, U, r, valid=None):
    """(ms, |x_library - x_route| max) of ``torch.linalg.solve`` on the
    densified system, timed alone (best of 3; densified outside the timed
    region)."""
    H, rhs = dense_system(D, U, r, valid)
    ms = timed(lambda: torch.linalg.solve(H, rhs))
    x = torch.linalg.solve(H, rhs).reshape(D.shape[1], D.shape[0], -1).transpose(0, 1)
    return ms, float((x - tridiag_kernel.solve_batched(D, U, r, valid, device=DEV)).abs().max())


def check_kernels_std(model, data, vo, B_ragged):
    """K5's standard-layout route against its plain version, float64,
    TOL_MHE, on real windows: every window solve of the standard-layout fleet
    runner over ``data``/``vo`` (float64, T > N, so the warm-up ticks with
    dead slots are among them), and the last window cut to a ragged fleet of
    ``B_ragged`` lanes. Returns the largest error."""
    p = robot_params(model)[0]
    run = batch.make_fused_batched_runner(p, F64, use_pallas=True, device=DEV)
    with route_calls(keep=lambda i: True) as calls:
        run(data, vo)
    T, B = data.accel_b.shape[:2]
    assert len(calls) == T, (model, len(calls))
    errs = []
    for call in calls:
        ok, e = close(call["out"], tridiag_kernel.solve_batched_plain(*call["args"]), **TOL_MHE)
        assert ok, ("standard-layout route vs plain", model, len(errs), e)
        errs.append(e)
    n_warm = sum(not bool(c["args"][3].all()) for c in calls)
    assert n_warm == N_WIN - 1, (model, n_warm)
    cut = tuple(a[:, :B_ragged].contiguous() for a in calls[-1]["args"])
    ok, e_ragged = close(tridiag_kernel.solve_batched(*cut, device=DEV),
                         tridiag_kernel.solve_batched_plain(*cut), **TOL_MHE)
    assert ok, ("standard-layout route vs plain, ragged B", model, e_ragged)
    emit("kernels_std", model=model, s=p.dim_state, dtype="float64", N=N_WIN, T=T, B=B,
         tol=TOL_MHE, windows=len(calls), warm_up_windows=n_warm,
         max_abs_err={"windows": max(errs), "warm_up_windows": max(errs[:n_warm]),
                      f"ragged_B_{B_ragged}": e_ragged})
    return max(errs + [e_ragged])


def std_path(fleet64, fleet32, q64, gt_v, err_std):
    """Cell (q): the standard-layout fleet runner
    (``batch.make_fused_batched_runner(use_pallas=True)``) at full width on
    cell (a)'s fleet, orientation from the float64 main path's EKF: the
    counted float32 run — K5's standard-layout route every tick, timed per
    call (route and kernel) — and a float64 run of the same path: launches,
    RMSE against ground truth, the f32-vs-f64 delta, the float64 result
    against the lanes runner's tick kernel (K2) over the whole log. Then the
    route on the float32 run's final window: its time, its kernel's alone,
    its plain version's and the library's dense solve. Returns the route's
    entry of the last-but-one line."""
    p = go1_params()
    d32, v32 = std_fleet(fleet32, q64, F32)
    run32 = batch.make_fused_batched_runner(p, F32, use_pallas=True, device=DEV)
    reset_counts()
    with route_calls(keep=lambda i: i == T_MAIN - 1) as calls:
        (x, v), wall = wall_ms(lambda: run32(d32, v32))
    counts = read_counts()
    want = dict(NO_LAUNCH, tridiag_solve=T_MAIN, tridiag_solve_batched=T_MAIN)
    assert counts == want, counts
    route_ms = sum(call_ms(c) for c in calls)
    kernel_ms = sum(c["kernel_events"][0].elapsed_time(c["kernel_events"][1]) for c in calls)
    final = calls[-1]["args"]
    del calls
    assert x.shape == (T_MAIN, B_MAIN, 9) and v.shape == (T_MAIN, B_MAIN, 3)
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(v).all())
    rmse = fleet_rmse(x, gt_v)
    assert rmse < RMSE_GATE["go1"], f"standard-layout fleet RMSE vs ground truth {rmse}"

    d64, v64 = std_fleet(fleet64, q64, F64)
    run64 = batch.make_fused_batched_runner(p, F64, use_pallas=True, device=DEV)
    reset_counts()
    (x64, vb64), wall64 = wall_ms(lambda: run64(d64, v64))
    counts64 = read_counts()
    assert counts64 == want, counts64
    assert bool(torch.isfinite(x64).all()) and bool(torch.isfinite(vb64).all())
    r64 = fleet_rmse(x64, gt_v)
    assert r64 < RMSE_GATE["go1"] and abs(rmse - r64) < 1e-3, ("f32-vs-f64 delta", rmse, r64)
    # the float64 result against the lanes runner's tick kernel, whole log
    lanes64 = batch.make_lanes_fleet_runner(p, F64, use_megakernel=True, device=DEV)
    xl, vl = lanes64(d64, fleet64[2])
    okx, ex = close(x64, xl, **TOL_STD_VS_LANES)
    okv, ev = close(vb64, vl, **TOL_STD_VS_LANES)
    assert okx and okv, ("standard-layout runner vs lanes runner (K2), float64", ex, ev)
    del x64, vb64, xl, vl

    # the route per launch, on the float32 run's final window (20 real slots;
    # the views ops.mhe.solve_window hands it): the wrapper, and its kernel
    # launch alone
    ms = timed(lambda: tridiag_kernel.solve_batched(*final, device=DEV))
    kernel_only = timed(lambda: tridiag_kernel._launch(*final, standard=True))
    plain = timed(lambda: tridiag_kernel.solve_batched_plain(*final))
    lib_ms, lib_diff = library_ms(*final)
    # the bound is the function's own work (K5's: D, U, r read once, x
    # written once)
    work = _work.tridiag(N_WIN, 9, B_MAIN, 4)
    replay = [_work.tridiag(N_WIN, 9, B_MAIN, 4, n_states=min(t + 1, N_WIN))
              for t in range(T_MAIN)]
    replay_bound = bound((sum(w[0] for w in replay), sum(w[1] for w in replay)))
    emit("std_path", config="Go1 N=20 s=9 m=12 L=4, standard layout, use_pallas=True",
         T=T_MAIN, B=B_MAIN, dtype="float32", launches=counts, launches_f64=counts64,
         wall_s=wall / 1e3, ticks_per_s=B_MAIN * (T_MAIN - 1) / (wall / 1e3),
         wall_f64_s=wall64 / 1e3, rmse_vs_ground_truth=rmse, rmse_f64=r64,
         rmse_gate=RMSE_GATE["go1"], f64_vs_lanes_runner={"x": ex, "v": ev, "tol": TOL_STD_VS_LANES},
         route_ms_summed=route_ms, kernel_ms_summed=kernel_ms,
         wrapper_share=(route_ms - kernel_ms) / route_ms, route_share_of_wall=route_ms / wall,
         final_window_ms={"route": ms, "kernel_only": kernel_only, "plain": plain,
                          "library_linalg_solve": lib_ms},
         library_minus_route_max_abs_f32=lib_diff,
         bound_ms_per_launch=bound(work)["bound_ms"],
         bound_ms_summed_per_replay=replay_bound["bound_ms"])
    name = "tridiag_solve_batched"
    return kernel_rows(
        {name: ("decentralized_ekf_mhe_tpu_torch/csrc/tridiag.cu (tridiag_std_kernel; route: "
                "decentralized_ekf_mhe_tpu_torch/kernels/tridiag_kernel.py solve_batched)",
                "decentralized_ekf_mhe_tpu/pallas/tridiag_kernel.py:227-245 (solve_batched) "
                "-> :213")},
        {name: work}, {name: counts[name]}, {name: err_std}, {name: ms},
        {name: plain},
        **{name: {"library_ms": lib_ms, "kernel_only_ms": kernel_only,
                  "ms_how": "one route call (the wrapper and its one launch, which reads "
                            "the standard layout and the mask) on the float32 run's final "
                            "window, best of 3",
                  "replay": {"route_ms_summed": route_ms, "kernel_ms_summed": kernel_ms,
                             "wrapper_share": (route_ms - kernel_ms) / route_ms,
                             "bound_ms_summed": replay_bound["bound_ms"], "launches": T_MAIN},
                  "max_abs_err_shape": {"T": T_STD_CHK, "B": B_MAIN, "ragged_B": B_RAGGED},
                  "path": "make_fused_batched_runner(use_pallas=True)"}})


def oracle():
    """The reference bench's float64 oracle on the card, in the steps of
    bench.py:57-65 but on a log of its own (Go1's synthetic log of T_ORACLE
    ticks, seed 0; the bench's log has 2000): the single-instance orientation
    EKF over the log's 500 Hz stream, then the single-instance MHE on its
    orientation.
    Then the KF baseline on the same inputs, and the single-instance MHE
    with the |v| <= 0.3 box over its first T_ORACLE_BOX ticks. A single
    instance takes no kernel (its window solve has no batch axis, as in the
    reference). RMSE gates, the box, and each run's wall."""
    p, pe = go1_params(), EKFParams()
    log = synth.generate(synth.SynthConfig(T=T_ORACLE, seed=0))
    gt_v = torch.as_tensor(log.gt_v_s, device=DEV)
    reset_counts()
    (R, _), ekf_ms = wall_ms(lambda: estimator.ekf_orientation_sequence(pe, log, F64, device=DEV))
    data = estimator.tickdata_from_log(log, dtype=F64, device=DEV)._replace(R_sb=R)
    vo = estimator.vodata_from_log(log, dtype=F64, device=DEV)
    (x, _), mhe_ms = wall_ms(lambda: estimator.run_mhe(p, data, vo=vo, dtype=F64, device=DEV))
    (xk, _), kf_ms = wall_ms(lambda: estimator.run_kf(p, data, dtype=F64, device=DEV))
    pb = box_params()
    cut = lambda nt: type(nt)(*(a[:T_ORACLE_BOX] for a in nt))
    (xb, _), box_ms = wall_ms(lambda: estimator.run_mhe(
        pb, cut(data), vo=cut(vo), dtype=F64, consts=box_consts(pb, F64, V_BOX, 20), device=DEV))
    counts = read_counts()
    rmse = lambda a: float(torch.sqrt(((a[SKIP:, 3:6] - gt_v[SKIP:a.shape[0]]) ** 2).mean()))
    vmax = float(xb[:, 3:6].abs().max())
    failed = [what for what, ok in (
        ("no kernel launched", counts == NO_LAUNCH),
        ("finite", all(bool(torch.isfinite(a).all()) for a in (R, x, xk, xb))),
        ("MHE RMSE vs ground truth", rmse(x) < RMSE_GATE["go1"]),
        ("KF RMSE vs ground truth", rmse(xk) < KF_RMSE_GATE),
        ("velocity box", V_BOX - 1e-2 <= vmax <= V_BOX + 1e-3)) if not ok]
    emit("oracle", config=f"Go1 N=20, single instance, float64; the steps of bench.py:57-65 on "
         f"Go1's synthetic log of {T_ORACLE} ticks, seed 0", T=T_ORACLE, seed=0,
         launches=counts, ekf_orientation_sequence_s=ekf_ms / 1e3, run_mhe_s=mhe_ms / 1e3,
         rmse_vs_ground_truth=rmse(x), rmse_gate=RMSE_GATE["go1"], run_kf_s=kf_ms / 1e3,
         kf_rmse_vs_ground_truth=rmse(xk), kf_rmse_gate=KF_RMSE_GATE,
         constrained={"T": T_ORACLE_BOX, "box": V_BOX, "max_abs_v": vmax, "wall_s": box_ms / 1e3,
                      "rmse_vs_ground_truth": rmse(xb)},
         failed=failed)
    assert not failed, failed


# ------------------------------------------------- the constrained path


def box_params(adaptive=False, tol=1e-6, model="go1"):
    """A robot's params with the OSQP settings of the constrained bench: fixed
    rho=5000 with polish (the production budget), or the default adaptive rho."""
    p = robot_params(model)[0]
    p.osqp.abs_tol = p.osqp.relative_tol = tol
    if not adaptive:
        p.osqp.rho, p.osqp.adapt_rho, p.osqp.polish = 5000.0, False, True
    return p


def box_consts(p, dtype, bound, iters, use_pallas=True):
    """MHE consts with the velocity box ±bound on states 3:6 (±inf on the
    others); ``bound`` is a float (shared (s,) bounds) or a (B,) tensor
    (per-lane (s,B) bounds)."""
    per_lane = torch.is_tensor(bound)
    s = p.dim_state
    shape = (s, bound.shape[0]) if per_lane else (s,)
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


def over_tol(a, b, tol=TOL_MHE):
    """The largest |a - b| / (atol + rtol |b|), per lane (last axis)."""
    r = (a - b).abs() / (tol["atol"] + tol["rtol"] * b.abs())
    return r.reshape(-1, r.shape[-1]).amax(0)


def check_box_tick(c, c_plain, ks0, d, v, i, tag, fma=False, rounding=False, plain=None):
    """Constrained mhe_tick kernel (either clock) vs its plain version over
    the ticks handed in: x, the z/y warm-start rings, the per-tick iteration
    counts and the final Bezier schedule, all to TOL_MHE; "y_over_tol" is how
    far y comes to that limit (the largest |dy| / (atol + rtol |y|)). With
    ``fma`` y may go to Y_OVER_TOL_FMA times the limit, and fma_witness must
    then show the kernel without FMA contraction meeting TOL_MHE; with
    ``rounding`` to Y_OVER_TOL_ROUNDING times, and fma_witness must then show
    the plain version itself beyond the limit between the card and the CPU
    where y is, and the kernel within Y_OVER_TOL_ROUNDING of the CPU.
    The witness runs only where y does exceed TOL_MHE's limit. ``plain`` is
    the plain version's result on these inputs, if the caller has it."""
    y_limit = Y_OVER_TOL_ROUNDING if rounding else Y_OVER_TOL_FMA
    fma = fma or rounding
    x_p, ks_p = plain or mrk.replay_ticks_plain(c_plain, ks0, d, v, i)
    x_k, ks_k = mrk.replay_ticks(c, ks0, d, v, i, device=DEV)
    errs = {}
    for f, a, b in (("x", x_k, x_p), ("z", ks_k.arrays[18], ks_p.arrays[18]),
                    ("y", ks_k.arrays[19], ks_p.arrays[19])):
        ok, errs[f] = close(a, b, **TOL_MHE)
        if f == "y":
            y_lane = over_tol(a, b)
            errs["y_over_tol"] = float(y_lane.max())
            if fma:
                ok = bool(torch.isfinite(a).all()) and errs["y_over_tol"] <= y_limit
        assert ok, ("mhe_tick_box vs plain", tag, f, errs)
    assert torch.equal(ks_k.iters, ks_p.iters), ("mhe_tick_box iteration counts", tag)
    check_schedule(ks_k, ks_p, tag)
    if fma and errs["y_over_tol"] > 1.0:
        errs["without_fma"] = fma_witness(c, ks0, d, v, i, (x_k, ks_k), (x_p, ks_p),
                                          y_lane, tag, rounding)
    return x_k, ks_k, x_p, errs


def on_cpu(tree, lanes=None, B=None):
    """A tensor, or a (Named)tuple of them, on the CPU; with ``lanes`` only
    those lanes of the tensors whose last axis is the B lanes (a shared
    camera clock's schedule stays whole). Anything else (a tick counter, a
    setting) as it is."""
    if torch.is_tensor(tree):
        per_lane = lanes is not None and tree.ndim > 0 and tree.shape[-1] == B
        return (tree[..., lanes] if per_lane else tree).contiguous().cpu()
    if isinstance(tree, tuple):
        items = [on_cpu(a, lanes, B) for a in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def fma_witness(c, ks0, d, v, i, kernel, plain, y_lane, tag, rounding=False):
    """Where the constrained tick's y differs between the kernel as built and
    its plain version by more than TOL_MHE: the same inputs through the
    kernel built without FMA contraction (FMAD_OFF), and, on the FMA_LANES
    lanes where the built kernel's y is furthest off, through the plain
    version on the CPU. The kernel without FMA contraction must meet TOL_MHE
    there in x, z, y and the iteration counts. Emits the comparisons of all
    four (the plain version on the card and on the CPU included) before it
    asserts. Returns the errors."""
    x_n, ks_n = mrk.replay_ticks(c, ks0, d, v, i, device=DEV, nvcc_flags=FMAD_OFF)
    idx = torch.topk(y_lane, FMA_LANES).indices
    B = y_lane.numel()
    x_c, ks_c = mrk.replay_ticks_plain(on_cpu(c)._replace(use_pallas=False),
                                       *(on_cpu(a, idx, B) for a in (ks0, d, v, i)))

    def over(a, b):
        (xa, ka), (xb, kb) = a, b
        out = {f: float(over_tol(p.double().cpu(), q.double().cpu()).max())
               for f, p, q in (("x", xa, xb), ("z", ka.arrays[18], kb.arrays[18]),
                               ("y", ka.arrays[19], kb.arrays[19]))}
        out["iters_equal"] = bool(torch.equal(ka.iters.cpu(), kb.iters.cpu()))
        return out

    res = {"lanes": idx.tolist(), "over_tol": {
        "without_fma_vs_plain_cpu": over(on_cpu((x_n, ks_n), idx, B), (x_c, ks_c)),
        "kernel_vs_plain_cpu": over(on_cpu(kernel, idx, B), (x_c, ks_c)),
        "plain_card_vs_plain_cpu": over(on_cpu(plain, idx, B), (x_c, ks_c)),
        "without_fma_vs_plain_card": over((x_n, ks_n), plain),
        "kernel_vs_plain_card": over(kernel, plain)}}
    emit("fma_witness", of=tag, flags=" ".join(FMAD_OFF), tol=TOL_MHE, **res)
    w = res["over_tol"]["without_fma_vs_plain_cpu"]
    assert w["iters_equal"] and max(w["x"], w["z"]) <= 1.0, ("kernel without FMA", w)
    if rounding:
        # where the kernel's y is beyond the limit, so is the plain version's
        # own between the card and the CPU; and the kernel as built stays
        # within Y_OVER_TOL_ROUNDING of the plain version on the CPU
        assert (float(y_lane.max()) <= 1.0
                or res["over_tol"]["plain_card_vs_plain_cpu"]["y"] > 1.0), res
        k = res["over_tol"]["kernel_vs_plain_cpu"]
        assert k["iters_equal"] and max(k["x"], k["z"]) <= 1.0, ("kernel vs plain on the CPU", k)
        assert k["y"] <= Y_OVER_TOL_ROUNDING, ("kernel vs plain on the CPU", k)
    else:
        assert w["y"] <= 1.0, ("kernel without FMA", w)
    return res


def check_schedule(ks_k, ks_p, tag):
    """The Bezier schedule the kernel leaves equals the plain version's."""
    assert torch.equal(ks_k.bez_count, ks_p.bez_count), ("Bezier counts", tag)
    ok, e = close(ks_k.bez_times, ks_p.bez_times, **TOL_MHE)
    assert ok, ("Bezier times", tag, e)


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


def admm_cases(c, c_pl, ks0, ks_k, first_ticks, model="go1"):
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
    adaptive = admm.ADMMSettings.from_osqp(
        box_params(adaptive=True, tol=1e-8, model=model).osqp, 50)
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
    errs["per_lane_bounds"] = max(e_pl[f] for f in "xzy")
    res["mhe_box_err"] = errs
    res["refused"] = box_refusals(c, ks0, dA, vA, iA)

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


def box_refusals(c, ks0, d, v, i):
    """The constrained tick refuses what it cannot launch: a block that is no
    multiple of its threads per instance raises ValueError before a launch
    (``box_geometry``), and a launch whose shared memory the card refuses
    raises RuntimeError (the library returns the error; no other kernel and
    no plain version runs instead). Returns the two messages."""
    launched = mrk.launches_box
    try:
        mrk.replay_ticks(c, ks0, d, v, i, device=DEV, block=mrk.group_size(c.dim_state) + 8)
    except ValueError as e:
        by_wrapper = str(e)
    else:
        raise AssertionError("a block that is no multiple of the group size was taken")
    bounds = admm.broadcast_bounds(c.x_lb, c.x_ub, c.dim_state, d.accel_b.shape[-1],
                                   d.accel_b.dtype, d.accel_b.device)
    try:
        mrk._launch(c, ks0, [d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq,
                             d.contact, i], v, bounds, block=1024)
    except RuntimeError as e:
        by_card = str(e)
    else:
        raise AssertionError("a launch beyond the card's shared memory was taken")
    torch.cuda.synchronize()
    assert mrk.launches_box == launched, "a refused launch was counted"
    return {"block_not_a_multiple": by_wrapper, "shared_memory_beyond_the_card": by_card}


def box_geometry_phase():
    """The constrained tick's launch geometry at each robot's shape, on both
    clocks, in both types: threads and instances per block and the dynamic
    shared bytes (``mrk.box_geometry``, held equal to what the library
    computes), the blocks the card keeps resident per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor through the library's C
    entry point, ``mrk.box_occupancy``), registers and local bytes per thread,
    and the ptxas figures of the units (registers, stack frame, spill stores,
    spill loads). Every float32 launch below s=16 keeps at least 8 instances
    resident per SM, all B_MAIN instances on the card at once; at s=21 (a
    warp per instance, 5 instances of 44 KB a block) B_MAIN takes a second
    wave, which is printed. Returns the float32 figures by (the robot's tag
    in the kernels line's names, per-lane clock)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    res, rows = {}, {}
    for model, tag in (("go1", "go1"), ("pogox", "pogox"), ("cassie_bench", "cassie"),
                       ("go1feet", "go1feet")):
        p = box_params(model=model)
        c = box_consts(p, F32, V_BOX, 20)
        for pi in (False, True):
            lib = mrk.kernel_library(p.dim_state, p.dim_meas, p.num_legs, p.leg_odom_type, pi)
            figs = tick_ptxas(lib, "mhe_pi_box_kernel" if pi else "mhe_box_kernel")
            for dtype, name in ((F32, "float"), (F64, "double")):
                want = mrk.box_geometry(p.dim_state, dtype, None, N_WIN)
                card = mrk.box_occupancy(c, dtype, pi)
                assert (card["shared_bytes"], card["u_shared"], card["instances_per_block"]) == (
                    want.shared_bytes, want.u_shared, want.instances_per_block), (tag, pi, card, want)
                if dtype == F32 and p.dim_state < 16:
                    assert card["instances_per_sm"] >= 8, (tag, pi, card)
                    assert card["instances_per_sm"] * n_sm >= B_MAIN, (tag, pi, card)
                res[f"{tag} {'per-lane' if pi else 'shared'} clock {name}"] = dict(
                    card, s=p.dim_state, threads_per_instance=mrk.group_size(p.dim_state),
                    waves_at_B_MAIN=-(-B_MAIN // (card["instances_per_sm"] * n_sm)),
                    ptxas=figs[name])
            rows[(tag, pi)] = {k: v for k, v in res[
                f"{tag} {'per-lane' if pi else 'shared'} clock float"].items() if k != "ptxas"}
    emit("box_geometry", sms=n_sm, N=N_WIN,
         shared_per_block_max=mrk.SHARED_PER_BLOCK, shared_per_sm=mrk.SHARED_PER_SM,
         **res)
    return rows


def solve_ptxas(s):
    """The ptxas figures of K4's and K5's kernels at state size ``s``:
    {"admm_solve" | "tridiag_solve" | "tridiag_solve_batched": {"float": [...],
    "double": [...]}} (registers, stack frame, spill stores, spill loads)."""
    names = {"admm_kernel": "admm_solve", "tridiag_kernel": "tridiag_solve",
             "tridiag_std_kernel": "tridiag_solve_batched"}
    out = {}
    for lib in (f"admm_s{s}", f"tridiag_s{s}"):
        for _, text, _ in _build.report[lib]["units"]:
            for name, fig in ptxas_figures(text).items():
                m = re.search(r"\d+(admm_kernel|tridiag_kernel|tridiag_std_kernel)I([fd])Li\d+E",
                              name)
                if m:
                    out.setdefault(names[m.group(1)], {})[
                        {"f": "float", "d": "double"}[m.group(2)]] = fig
    return out


def solve_geometry_phase():
    """K4 (``admm_solve``) and K5 (``tridiag_solve``, both routes) on their
    groups of threads per instance at s=9, s=15 and s=21 (a warp per
    instance), in both types, as the card reports them
    (``admm_kernel.occupancy``, ``tridiag_kernel.occupancy``: the library's C
    entry point), held equal to the geometry the wrappers compute
    (``kernels/_group.py``), with the kernels' ptxas figures; every launch
    keeps all B_MAIN instances resident at once but in float64 K4's (every
    size) and K5's above s=9, and at s=21 in either type, whose shared memory
    leaves a second wave. Returns the float32 launches by row name for the
    kernels line."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    res, rows = {}, {}
    for s in _build.SOLVE_SIZES:
        figs = solve_ptxas(s)
        for dtype, name in ((F32, "float"), (F64, "double")):
            launches = [("admm_solve", admm_kernel.geometry(s, dtype),
                         admm_kernel.occupancy(s, dtype))]
            for std in (False, True):
                launches.append(("tridiag_solve" + "_batched" * std,
                                 tridiag_kernel.geometry(s, dtype),
                                 tridiag_kernel.occupancy(s, dtype, standard=std)))
            for key, want, card in launches:
                assert (card["shared_bytes"], card["instances_per_block"],
                        card["threads_per_block"]) == (
                    want.shared_bytes, want.instances_per_block,
                    want.threads_per_block), (key, s, name, card, want)
                if key == "admm_solve":
                    assert card["u_shared"] == want.u_shared, (s, name, card, want)
                assert card["instances_per_sm"] * n_sm >= B_MAIN or s > 15 or (
                    dtype == F64 and (key == "admm_solve" or s > 9)), (key, s, name, card)
                G = _group.group_size(s)
                res[f"{key} s={s} {name}"] = dict(card, threads_per_instance=G,
                                                  ptxas=figs.get(key, {}).get(name))
                if dtype == F32:
                    row = key if s == 9 else f"{key}[s={s}]"
                    rows[row] = dict(card, threads_per_instance=G,
                                     ptxas_registers_frame_spill_stores_loads={
                                         t: figs.get(key, {}).get(t) for t in ("float", "double")})
    emit("solve_geometry", sms=n_sm, N=N_WIN, shared_per_block_max=_group.SHARED_PER_BLOCK, **res)
    for s in _build.SOLVE_SIZES:
        tag = "" if s == 9 else f"[s={s}]"
        rows["admm_box_solve" + tag] = rows["admm_solve" + tag]
    return rows


def mark_solve_group(kernels, geometry, per_tick):
    """The rows of K4 (``admm_solve``), K3 (``admm_box_solve``) and K5
    (``tridiag_solve``, ``tridiag_solve_batched``) at every state size carry
    their launch on a group of threads per instance as the card reports it
    (``solve_geometry_phase``, float32); K4's row at s=9 also the per-tick
    run (``box_per_tick``): its mean time per launch beside the mean bound of
    those launches from the iterations each returned."""
    for row in kernels:
        if row["name"] in geometry:
            row["threads_per_instance"] = geometry[row["name"]]["threads_per_instance"]
            row["group_geometry"] = geometry[row["name"]]
    row = next(k for k in kernels if k["name"] == "admm_solve")
    row["box_per_tick"] = dict(
        per_tick, how="T=200, B=1024, float32, adaptive rho, 50 iterations, one launch per "
                      "tick (make_lanes_fleet_runner(use_megakernel=False)); each launch "
                      "timed alone, CUDA events; bound per launch from _work.admm with the "
                      "iterations it returned and min(t+1, N) real slots")


def tick_group_figures(p, pi, tail):
    """The unconstrained tick's group launch at ``p``'s shape on a clock
    (``pi``) with a tail, in both types, as the card reports it: threads and
    instances per block and the dynamic shared bytes (``mrk.tick_geometry``,
    held equal to what the library computes), the blocks the card keeps
    resident per SM, registers and local bytes per thread
    (``mrk.tick_occupancy`` of the unit that runs) and the unit's ptxas
    figures; every launch keeps all B_MAIN instances resident at once.
    {"float": ..., "double": ...}."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    c = mhe.make_consts(p, F32, device=DEV)
    lib = mrk.kernel_library(p.dim_state, p.dim_meas, p.num_legs, p.leg_odom_type, pi,
                             tail == "chol")
    figs = tick_ptxas(lib, "mhe_" + "pi_" * pi + "chol_" * (tail == "chol") + "kernel")
    res = {}
    for dtype, name in ((F32, "float"), (F64, "double")):
        want = mrk.tick_geometry(p.dim_state, p.dim_meas, dtype, mk_solve=tail)
        card = mrk.tick_occupancy(c, dtype, pi, mk_solve=tail)
        assert (card["shared_bytes"], card["instances_per_block"],
                card["threads_per_block"]) == (
            want.shared_bytes, want.instances_per_block, want.threads_per_block), (
            p.dim_state, pi, tail, card, want)
        assert card["instances_per_sm"] * n_sm >= B_MAIN, (p.dim_state, pi, tail, card)
        res[name] = dict(card, threads_per_instance=mrk.group_size(p.dim_state),
                         ptxas=figs[name])
    return res


def tick_geometry_phase():
    """The unconstrained tick's launch on a group of threads per instance,
    with either tail at Go1's, PogoX's, Cassie's and Go1's with its foot
    positions as states shapes, on both clocks, in both types
    (``tick_group_figures``). Returns the float32 figures by (the robot's tag
    in the kernels line's names, per-lane clock, tail) for the kernels
    line."""
    res, rows = {}, {}
    for model, tag in (("go1", ""), ("pogox", "pogox"), ("cassie_bench", "cassie"),
                       ("go1feet", "go1feet")):
        p = robot_params(model)[0]
        for pi in (False, True):
            for tail in mrk.MK_SOLVES:
                figs = tick_group_figures(p, pi, tail)
                for name, card in figs.items():
                    res[f"{tag or model} {'per-lane' if pi else 'shared'} clock {tail} "
                        f"{name}"] = dict(card, s=p.dim_state, m=p.dim_meas)
                f32 = {k: v for k, v in figs["float"].items() if k != "ptxas"}
                rows[(tag, pi, tail)] = dict(f32, ptxas_registers_frame_spill_stores_loads={
                    name: card["ptxas"] for name, card in figs.items()})
    emit("tick_geometry",
         sms=torch.cuda.get_device_properties(0).multi_processor_count,
         shared_per_block_max=mrk.SHARED_PER_BLOCK, shared_per_sm=mrk.SHARED_PER_SM, **res)
    return rows


def box_path(model, fleet64, fleet32, gt_v):
    """``model``'s constrained production pipeline at full width through its
    entry point (|v| <= 0.3 on states 3:6, rho=5000 fixed, 20 it + polish):
    launches, the box, accuracy, wall (the counted run); its float64 twin over
    the whole log for Go1 (``box_full_width`` holds the kernels against it),
    over the first T_BOX_F64 ticks for the others. A fleet of fault F6 runs
    its first T_F6_BOX ticks, Go1's with its foot positions as states its
    first T_GO1FEET_BOX. Returns the launches, the float64 twin's (x, q) and
    the counted run's constrained tick: its time around the wrapper and alone,
    (bytes, operations), ADMM iterations, final state and first non-finite
    tick."""
    p = box_params(model=model)
    pe = robot_params(model)[1]
    gate = RMSE_GATE[model]
    if model in F6_TICKS:
        fleet32 = head(fleet32, T_F6_BOX)
    elif model == "go1feet":
        fleet32 = head(fleet32, T_GO1FEET_BOX)
    T = fleet32[0].accel_b.shape[0]
    gt_v = gt_v[:T]
    runner = batch.make_pipeline_fleet_runner(
        p, pe, F32, use_megakernel=True, consts=box_consts(p, F32, V_BOX, 20), device=DEV)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    mrk.timer.on = True
    with tick_calls() as calls:
        (x, v, q), wall = wall_ms(lambda: runner(*fleet32))
    mrk.timer.on = False
    k_only = min(mrk.timer.ms())
    counts = read_counts()
    assert counts == dict(NO_LAUNCH, ekf_stage=1, mhe_tick_box=1, admm_solve=1,
                          admm_box_solve=2), counts
    ms_tick, work, iters = box_tick_figures(p, box_consts(p, F32, V_BOX, 20), calls[0])
    tick = {"ms": ms_tick, "kernel_only_ms": k_only, "work": work, "iters": iters,
            "ks_end": calls[0]["out"][1], "t_bad": first_nonfinite(x), "T": T}
    del calls
    assert x.shape == (T, B_MAIN, p.dim_state) and v.shape == (T, B_MAIN, 3)
    assert torch.isfinite(q).all()
    n, t_bad = f32_ticks(model, x)      # n = T_MAIN but for fault F6
    t64 = T_MAIN if model == "go1" else T_BOX_F64
    assert n >= t64 and bool(torch.isfinite(v[:n]).all())
    vmax = float(x[:n, :, 3:6].abs().max())
    assert V_BOX - 1e-2 <= vmax <= V_BOX + 1e-3, (f"{model} velocity box", vmax)
    rmse = fleet_rmse(x[:n], gt_v[:n])
    assert rmse < gate, f"{model} constrained fleet velocity RMSE vs ground truth {rmse}"

    run64 = batch.make_pipeline_fleet_runner(
        p, pe, F64, use_megakernel=True, consts=box_consts(p, F64, V_BOX, 20), device=DEV)
    x64, _, q64 = run64(*head(fleet64, t64))
    assert bool(torch.isfinite(x64).all()), f"{model} constrained float64 run not finite"
    r32, r64 = fleet_rmse(x[:t64], gt_v[:t64]), fleet_rmse(x64, gt_v[:t64])
    assert abs(r32 - r64) < 1e-3, (f"{model} constrained f32-vs-f64 velocity-RMSE delta", r32, r64)
    wall /= 1e3
    emit("box_main_path" if model == "go1" else f"{model}_box",
         config=f"{model} N={N_WIN} s={p.dim_state}, |v|<=0.3, rho=5000 fixed, 20 it + polish",
         T=T, B=B_MAIN, dtype="float32", launches=counts, max_abs_v=vmax,
         max_abs_v_f64=float(x64[..., 3:6].abs().max()), rmse_vs_ground_truth=rmse,
         rmse_gate=gate, f32_gated_ticks=n, f32_first_nonfinite_tick=t_bad,
         f64_twin={"T": t64, "rmse_f32": r32, "rmse_f64": r64},
         wall_s=wall, pipeline_ticks_per_s=B_MAIN * (T - 1) / wall,
         mhe_tick_box_ms=ms_tick, mhe_tick_box_kernel_only_ms=k_only,
         admm_iters_mean=float(iters.double().mean()),
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    return counts, x64, q64, tick


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


@contextlib.contextmanager
def admm_calls():
    """Record the iteration counts (B,) each ``admm_kernel._launch`` returns
    inside (K4's launches), for the bound of each launch."""
    calls, launch = [], admm_kernel._launch

    def spy(*a, **kw):
        out = launch(*a, **kw)
        calls.append(out[3])
        return out

    admm_kernel._launch = spy
    try:
        yield calls
    finally:
        admm_kernel._launch = launch


def box_per_tick(fleet32):
    """Adaptive rho, 50 iterations, no mega-kernel: the eager tick loop with
    one admm_solve launch per tick, each timed alone (CUDA events), each with
    its bound from the iterations it ran (tick t's window has min(t+1, N)
    real slots). Returns the figures of K4's row."""
    p = box_params(adaptive=True)
    data_b, _, vo_b = fleet32
    data_s = estimator.TickData(*(a[:T_PER_TICK] for a in data_b))
    vo_s = estimator.VOData(*(a[:T_PER_TICK] for a in vo_b))
    c = box_consts(p, F32, V_BOX, 50)
    run = batch.make_lanes_fleet_runner(p, F32, use_megakernel=False, consts=c, device=DEV)
    reset_counts()
    admm_kernel.timer.on = True
    with admm_calls() as iters:
        (x, _), ms = wall_ms(lambda: run(data_s, vo_s))
    admm_kernel.timer.on = False
    k_ms = admm_kernel.timer.ms()
    counts = read_counts()
    assert counts["admm_solve"] == T_PER_TICK == len(k_ms) == len(iters), counts
    assert counts["mhe_tick_box"] == 0, counts
    vmax = float(x[..., 3:6].abs().max())
    assert torch.isfinite(x).all() and vmax <= V_BOX + 1e-3, ("velocity box", vmax)
    bounds = [bound(_work.admm(N_WIN, 9, B_MAIN, 4, it.cpu().numpy(), *admm_work_settings(c),
                               n_states=min(t + 1, N_WIN)))["bound_ms"]
              for t, it in enumerate(iters)]
    it_mean = [float(it.double().mean()) for it in iters]
    res = dict(launches=T_PER_TICK, mean_ms=sum(k_ms) / len(k_ms), max_ms=max(k_ms),
               min_ms=min(k_ms), summed_ms=sum(k_ms), wall_s=ms / 1e3,
               bound_ms_mean=sum(bounds) / len(bounds), bound_ms_summed=sum(bounds),
               iters_mean=sum(it_mean) / len(it_mean), iters_max=int(max(int(it.max())
                                                                       for it in iters)))
    emit("box_per_tick", T=T_PER_TICK, B=B_MAIN, dtype="float32", admm_iters=50,
         adaptive_rho=True, launches=counts, admm_solve_mean_ms=res["mean_ms"],
         admm_solve_max_ms=res["max_ms"], wall_s=ms / 1e3, max_abs_v=vmax,
         admm_solve_share_of_wall=res["summed_ms"] / ms,
         bound_ms_per_launch_mean=res["bound_ms_mean"], admm_iters_mean=res["iters_mean"])
    return res


def box_full_width(fleet64, fleet32, x64, q64, counts, tick):
    """The constrained kernels against their plain versions at full width:
    float64 element-wise over T_BOX_PLAIN ticks; float32 by accuracy against
    the float64 main path ``x64`` over the first T_PLAIN_F32 ticks; the
    constrained tick's time and bound from the main path's counted run
    (``tick``, from ``box_path``), the plain version's over T_PLAIN_F32 ticks.
    Returns the kernels' entries of the last-but-one line."""
    p = box_params()
    R64 = ekf_lanes.to_rot(q64)

    def inputs(fleet, dtype, T):
        c = box_consts(p, dtype, V_BOX, 20)
        return (c, *window_inputs(c, fleet, R64, dtype, T))

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
    err = {"mhe_tick_box": max(e_tick[f] for f in "xzy"),
           "admm_solve": max(*e0.values(), *el.values()),
           "admm_box_solve": max(el.values())}

    # ---- float32 at the main path's shapes: the kernel and its plain version
    # over the first T_PLAIN_F32 ticks (the eager constrained tick is
    # thousands of small launches per tick), both held to the float64 main
    # path by accuracy over the ticks after the window's warm-up (ticks
    # N_WIN+1 .. T_PLAIN_F32-1); the kernel over the whole log is the main
    # path's counted run (``tick``)
    cm, stm, ksp, (dp_, vp, ip) = inputs(fleet32, F32, T_PLAIN_F32)
    ms, plain_ms = {"mhe_tick_box": tick["ms"]}, {}
    (x32p, _), plain_ms["mhe_tick_box"] = wall_ms(
        lambda: mrk.replay_ticks_plain(cm._replace(use_pallas=False), ksp, dp_, vp, ip))
    x32k, _ = mrk.replay_ticks(cm, ksp, dp_, vp, ip, device=DEV)
    assert torch.isfinite(x32k).all() and tick["t_bad"] is None
    ref = torch.movedim(x64, 1, -1)[1:T_PLAIN_F32]
    rk, rp = vel_rmse(x32k, ref, N_WIN), vel_rmse(x32p, ref, N_WIN)
    assert abs(rk - rp) < 1e-3, ("constrained f32 velocity-RMSE delta", rk, rp)
    rmse_ticks = [N_WIN + 1, T_PLAIN_F32 - 1]
    del x32p, ref
    kernel_only_ms = tick["kernel_only_ms"]
    iters_tick, ks_end = tick["iters"], tick["ks_end"]

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

    box = admm_work_settings(cm)
    # the main path's schedule (ticks 1..), which the counted run walked
    sched = _work.mhe_schedule(*(a.tolist() for a in (fleet32[2].active[1:],
                                                      fleet32[2].tick_pre[1:],
                                                      fleet32[2].tick_now[1:])),
                               N_WIN, int(ksp.bez_count))
    it_np = {k: v.cpu().numpy() for k, v in iters.items()}
    works = {
        "mhe_tick_box": tick["work"],
        "admm_solve": _work.admm(N_WIN, 9, B_MAIN, 4, it_np["admm_solve"], *box, n_states=1),
        "admm_box_solve": _work.admm(N_WIN, 9, B_MAIN, 4, it_np["admm_box_solve"], *box),
    }
    # the device function's share of the main path's operations
    core_ops = works["admm_solve"][1] + sum(
        _work.admm_ops(9, n_states, it, *box)
        for (n_states, *_), it in zip(sched, iters_tick.cpu().numpy()))
    emit("box_full_width", B=B_MAIN, N=N_WIN, T_f64=T_BOX_PLAIN, T_f32_kernel=T_MAIN,
         T_f32_plain=T_PLAIN_F32, tol=TOL_MHE,
         max_abs_err_f64={"mhe_tick_box": e_tick, "admm_solve": {"tick0": e0, "final": el}},
         plain_and_kernel_f64_s=plain64_s,
         f32={"vel_rmse_vs_f64_kernel": rk, "vel_rmse_vs_f64_plain": rp, "ticks": rmse_ticks},
         kernel_f32_ms=ms, plain_f32_ms=plain_ms, mhe_tick_box_kernel_only_ms=kernel_only_ms,
         admm_iters_mean={"mhe_tick_box": float(iters_tick.double().mean()),
                          **{k: float(v.double().mean()) for k, v in iters.items()}})
    f64_shape = {"T": T_BOX_PLAIN, "B": B_MAIN}
    return kernel_rows({
        "mhe_tick_box": ("decentralized_ekf_mhe_tpu_torch/csrc/mhe_body.cuh",
                         "decentralized_ekf_mhe_tpu/pallas/mhe_replay_kernel.py:917 (admm_ks set)"),
        "admm_box_solve": ("decentralized_ekf_mhe_tpu_torch/csrc/admm_group.cuh",
                           "decentralized_ekf_mhe_tpu/pallas/admm_core.py:133"),
        "admm_solve": ("decentralized_ekf_mhe_tpu_torch/csrc/admm.cu",
                       "decentralized_ekf_mhe_tpu/pallas/admm_kernel.py:75"),
    }, works, counts, err, ms, plain_ms,
        mhe_tick_box=dict(max_abs_err_shape=f64_shape, max_abs_err_by_output=e_tick,
                          plain_ms_shape={"T": T_PLAIN_F32, "B": B_MAIN, "N": N_WIN},
                          f32_vel_rmse_vs_f64={"kernel": rk, "plain": rp, "ticks": rmse_ticks}),
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


# ------------------------------------------------ per-lane camera clocks


def clock_inputs(c, fleet, dtype, T=None):
    """Tick-0 kernel state and the per-tick inputs of ``mrk.replay_ticks``
    for the MHE-only runner on ``fleet`` (orientation ``data.R_sb``), over its
    first ``T`` ticks (default all): (ks0, (data, vo, vo_inc) of ticks 1..)."""
    data_b, _, vo = fleet
    sl = slice(0, T)
    data_l = batch.tickdata_to_lanes(estimator.TickData(*(a[sl] for a in data_b)))
    vo = estimator.VOData(*(a[sl] for a in vo))
    st0, vo_inc = mhe_inputs(c, data_l, vo, dtype)
    return mrk.kernel_state_from_mhe(st0, c), seg(data_l, vo, vo_inc, slice(1, None))


def uniform_clock(vo, B):
    """A shared-clock VOData as a per-instance one: every lane on the fleet's
    clock."""
    T = vo.active.shape[0]
    return estimator.VOData(vo.active[:, None].expand(T, B).contiguous(), vo.dp_body,
                            vo.tick_pre[:, None].expand(T, B).contiguous(),
                            vo.tick_now[:, None].expand(T, B).contiguous())


def check_tick(c, ks0, d, v, i, tag, split=30, mk_solve="gj"):
    """The tick kernel (either variant, by the consts; unconstrained with the
    tail ``mk_solve``) against its plain version over the ticks handed in: x,
    the final Bezier schedule and, when constrained, z, y and the iteration
    counts; then the log split at tick ``split`` over two calls, and the plain
    version continuing from the first call's kernel state. Returns ({check:
    error}, x and final state of the kernel)."""
    c_plain = c._replace(use_pallas=False)
    if c.x_lb is not None:
        x_k, ks_k, _, errs = check_box_tick(c, c_plain, ks0, d, v, i, tag)
    else:
        x_p, ks_p = mrk.replay_ticks_plain(c_plain, ks0, d, v, i)
        x_k, ks_k = mrk.replay_ticks(c, ks0, d, v, i, device=DEV, mk_solve=mk_solve)
        ok, e = close(x_k, x_p, **TOL_MHE)
        assert ok, ("per-lane-clock mhe_tick vs plain", tag, e)
        check_schedule(ks_k, ks_p, tag)
        errs = {"x": e}
    cut = lambda sl: (estimator.TickData(*(a[sl] for a in d)),
                      estimator.VOData(*(a[sl] for a in v)), i[sl])
    xA, ksA = mrk.replay_ticks(c, ks0, *cut(slice(0, split)), device=DEV, mk_solve=mk_solve)
    xB, ksB = mrk.replay_ticks(c, ksA, *cut(slice(split, None)), device=DEV, mk_solve=mk_solve)
    ok, errs["split_log"] = close(torch.cat([xA, xB]), x_k, **TOL_MHE)
    assert ok and ksB.t == ks_k.t, ("per-lane-clock split-log resume", tag, errs["split_log"])
    xBp, _ = mrk.replay_ticks_plain(c_plain, ksA, *cut(slice(split, None)))
    ok, errs["plain_from_kernel_state"] = close(xB, xBp, **TOL_MHE)
    assert ok, ("plain version from a per-lane-clock kernel state", tag,
                errs["plain_from_kernel_state"])
    return errs, x_k, ks_k


def check_kernels_pi(model="go1"):
    """The per-lane-clock tick kernels (unconstrained and constrained) of
    ``model``'s shape against their plain versions at the small size,
    float64, on a fleet with 15 camera clocks and VO-free lanes; a ragged
    fleet through the runner; per-lane bounds; and uniform per-lane clocks
    against the shared-clock kernels, which they must reproduce (the
    ingestion runs the same statements)."""
    p = robot_params(model)[0]
    res = {}
    _, *fleet = make_clock_fleet(T_CHK, B_CHK, F64, seed=1, model=model)
    vo = fleet[2]
    assert int(vo.active.any(0).sum()) == B_CHK - B_CHK // VO_FREE_EVERY
    c = mhe.make_consts(p, F64, device=DEV)
    ks0, (d1, v1, i1) = clock_inputs(c, fleet, F64)
    res["mhe_tick_pi_err"], x_free, ks = check_tick(c, ks0, d1, v1, i1, "unconstrained")
    counts = ks.bez_count[0]
    assert int(counts.min()) == 0 and len(set(counts.tolist())) > 3, "clocks did not go apart"

    # constrained, on a box that binds (half the unconstrained run's largest
    # |v|), OSQP tolerances 1e-8, fixed rho, 20 iterations, polish
    bound = 0.5 * float(x_free[:, 3:6].abs().max())
    pb = box_params(tol=1e-8, model=model)
    cb = box_consts(pb, F64, bound, 20)
    ksb, _ = clock_inputs(cb, fleet, F64)
    res["mhe_tick_pi_box_err"], xb, _ = check_tick(cb, ksb, d1, v1, i1, "constrained")
    vmax = float(xb[:, 3:6].abs().max())
    assert bound - 1e-6 <= vmax <= bound + 1e-3, ("box not active or violated", vmax, bound)
    lane_bound = torch.linspace(0.4 * bound, 1.2 * bound, B_CHK, dtype=F64, device=DEV)
    c_pl = box_consts(pb, F64, lane_bound, 20)
    ks_pl, (dA, vA, iA) = clock_inputs(c_pl, fleet, F64, T=30)
    x_pl, _, _, e_pl = check_box_tick(c_pl, c_pl._replace(use_pallas=False), ks_pl, dA, vA, iA,
                                      "per-lane clocks and bounds")
    assert bool((x_pl[:, 3:6].abs().amax(dim=(0, 1)) <= lane_bound + 1e-3).all())
    res["mhe_tick_pi_box_err"]["per_lane_bounds"] = max(e_pl[f] for f in "xzy")

    # ragged fleet through the MHE-only runner: kernel route vs eager route
    _, *fleet_r = make_clock_fleet(T_RAGGED_PI, B_RAGGED, F64, seed=2, model=model)
    errs = {}
    for tag, cr in (("unconstrained", mhe.make_consts(p, F64, device=DEV)),
                    ("constrained", box_consts(pb, F64, bound, 20))):
        run_k = batch.make_lanes_fleet_runner(p, F64, use_megakernel=True, consts=cr, device=DEV)
        run_p = batch.make_lanes_fleet_runner(p, F64, use_megakernel=False,
                                              consts=cr._replace(use_pallas=False), device=DEV)
        (xk, vk), (xp, vp) = run_k(fleet_r[0], fleet_r[2]), run_p(fleet_r[0], fleet_r[2])
        okx, ex = close(xk, xp, **TOL_MHE)
        okv, ev = close(vk, vp, **TOL_MHE)
        assert okx and okv, ("ragged B, per-lane clocks", tag, ex, ev)
        errs[tag] = {"x": ex, "v": ev}
    res["ragged_err"] = {"B": B_RAGGED, "T": T_RAGGED_PI, **errs}

    # uniform per-lane clocks against the shared-clock kernels, bit for bit
    # in the ingestion: the same fleet once on its shared clock, once with
    # that clock broadcast to every lane
    _, data_s, _, vo_s = make_fleet(T_CHK, B_CHK, F64, seed=1, model=model)
    errs = {}
    for tag, cc in (("mhe_tick", c), ("mhe_tick_box", cb)):
        ks_s, (ds, vs, i_s) = clock_inputs(cc, (data_s, None, vo_s), F64)
        ks_u, (_, vu, iu) = clock_inputs(cc, (data_s, None, uniform_clock(vo_s, B_CHK)), F64)
        x_s, _ = mrk.replay_ticks(cc, ks_s, ds, vs, i_s, device=DEV)
        x_u, _ = mrk.replay_ticks(cc, ks_u, ds, vu, iu, device=DEV)
        ok, errs[tag] = close(x_u, x_s, rtol=0.0, atol=1e-12)
        assert ok, ("uniform per-lane clocks vs the shared-clock kernel", tag, errs[tag])
    res["uniform_clock_vs_shared_err"] = errs
    emit("kernels_pi" if model == "go1" else "kernels_pi_legged", model=model,
         s=p.dim_state, m=p.dim_meas, L=p.num_legs, leg_odom_type=p.leg_odom_type,
         dtype="float64", N=N_WIN, T=T_CHK, B=B_CHK, clocks=N_CLOCKS,
         vo_free_lanes=B_CHK // VO_FREE_EVERY, tol=TOL_MHE, tol_uniform_vs_shared=1e-12,
         box=bound, osqp_tol=1e-8, **res)
    return res


def pi_main_path(fleet64, fleet32, gt_v, shared32):
    """The MHE-only runner at full width on the 15-clock fleet (orientation
    from the log): launches, accuracy, wall; then the per-lane-clock tick
    against its plain version — float64 element-wise over T_BOX_PLAIN ticks;
    float32, the kernel timed over the whole log, the plain version over
    T_PLAIN_F32 ticks — and, on the shared-clock fleet ``shared32``, the shared
    and the per-lane-clock tick in turns on the same schedule, which splits
    the per-lane clocks' cost into the variant's own and the divergence.
    Returns the kernel's entry of the last-but-one line."""
    p = go1_params()
    data_b, _, vo = fleet32
    runner = batch.make_lanes_fleet_runner(p, F32, use_megakernel=True, device=DEV)
    reset_counts()
    x, v = runner(data_b, vo)
    torch.cuda.synchronize()
    counts = read_counts()
    assert counts == dict(NO_LAUNCH, tridiag_solve=1, mhe_tick_pi=1), counts
    assert x.shape == (T_MAIN, B_MAIN, 9) and v.shape == (T_MAIN, B_MAIN, 3)
    cam, free_bad = split_vo_free(x, vo)
    assert bool(torch.isfinite(v[:, cam]).all())
    rmse = fleet_rmse(x, gt_v, cam)
    assert rmse < 0.1, f"per-lane-clock fleet velocity RMSE vs ground truth {rmse}"
    run64 = batch.make_lanes_fleet_runner(p, F64, use_megakernel=True, device=DEV)
    x64 = run64(fleet64[0], fleet64[2])[0]
    assert bool(torch.isfinite(x64).all()), "float64 run not finite"
    r64 = fleet_rmse(x64, gt_v, cam)
    assert abs(rmse - r64) < 1e-3, ("per-lane-clock f32-vs-f64 velocity-RMSE delta", rmse, r64)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        runner(data_b, vo)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    wall = min(walls)

    # float64 element-wise at full width over T_BOX_PLAIN ticks
    c64 = mhe.make_consts(p, F64, use_pallas=False, device=DEV)
    ks, (d, vv, i) = clock_inputs(c64, fleet64, F64, T=T_BOX_PLAIN)
    (x_p, _), plain64_ms = wall_ms(lambda: mrk.replay_ticks_plain(c64, ks, d, vv, i))
    ok, err = close(mrk.replay_ticks(c64, ks, d, vv, i, device=DEV)[0], x_p, **TOL_MHE)
    assert ok, ("per-lane-clock mhe_tick at full width", err)

    # float32: the kernel over all ticks (around the wrapper, and alone)
    c32 = mhe.make_consts(p, F32, use_pallas=False, device=DEV)
    ks, (d, vv, i) = clock_inputs(c32, fleet32, F32)
    mrk.timer.on = True
    ms = timed(lambda: mrk.replay_ticks(c32, ks, d, vv, i, device=DEV), reps=2)
    mrk.timer.on = False
    kernel_only_ms = min(mrk.timer.ms())
    x32k, _ = mrk.replay_ticks(c32, ks, d, vv, i, device=DEV)
    ks_s, (ds, vs, i_s) = clock_inputs(c32, shared32, F32)
    ks_u, (_, vu, iu) = clock_inputs(c32, (shared32[0], None, uniform_clock(shared32[2], B_MAIN)),
                                     F32)
    ab = {"mhe_tick_shared_clock": [], "mhe_tick_pi_uniform_clock": []}
    for _ in range(2):
        ab["mhe_tick_shared_clock"].append(
            timed(lambda: mrk.replay_ticks(c32, ks_s, ds, vs, i_s, device=DEV), reps=2))
        ab["mhe_tick_pi_uniform_clock"].append(
            timed(lambda: mrk.replay_ticks(c32, ks_u, ds, vu, iu, device=DEV), reps=2))
    # the plain version over the first T_PLAIN_F32 ticks, both held to the
    # float64 run by accuracy over the ticks after the window's warm-up
    ksp, (dp_, vp, ip) = clock_inputs(c32, fleet32, F32, T=T_PLAIN_F32)
    (x32p, _), plain_ms = wall_ms(lambda: mrk.replay_ticks_plain(c32, ksp, dp_, vp, ip))
    ref = torch.movedim(x64, 1, -1)[1:T_PLAIN_F32]
    rk = vel_rmse(x32k[:T_PLAIN_F32 - 1], ref, N_WIN, cam)
    rp = vel_rmse(x32p, ref, N_WIN, cam)
    assert abs(rk - rp) < 1e-3, ("per-lane-clock f32 velocity-RMSE delta", rk, rp)
    _, free_bad_plain = split_vo_free(torch.movedim(x32p, -1, 1), vp)
    free_bad_plain = None if free_bad_plain is None else free_bad_plain + 1   # from tick 1

    groups = _work.mhe_lane_schedules(vv.active.cpu().numpy(), vv.tick_pre.cpu().numpy(),
                                      vv.tick_now.cpu().numpy(), N_WIN,
                                      ks.bez_count[0].cpu().numpy())
    work = _work.mhe_tick_lanes(N_WIN, 9, 12, 4, groups, int((d.contact > 0).sum()), 4)
    n_events = int(vv.active.sum())
    emit("pi_main_path", config="Go1 N=20 s=9 m=12 L=4, 15 camera clocks, every 64th lane VO-free",
         T=T_MAIN, B=B_MAIN, dtype="float32", launches=counts, rmse_vs_ground_truth=rmse,
         rmse_f64=r64, rmse_lanes=int(cam.sum()),
         vo_free_lanes_first_nonfinite_tick={"kernel": free_bad, "plain": free_bad_plain,
                                             "float64": None},
         wall_s=wall, walls_s=walls,
         pipeline_ticks_per_s=B_MAIN * (T_MAIN - 1) / wall,
         mhe_tick_pi_ms=ms, mhe_tick_pi_kernel_only_ms=kernel_only_ms,
         same_schedule_in_turns_ms=ab,
         max_abs_err_f64={"T": T_BOX_PLAIN, "x": err}, plain_f64_ms=plain64_ms,
         plain_f32_ms={"T": T_PLAIN_F32, "ms": plain_ms},
         f32_vel_rmse_vs_f64={"kernel": rk, "plain": rp, "ticks": [N_WIN + 1, T_PLAIN_F32 - 1]},
         vo_events=n_events,
         distinct_lane_schedules=len(groups))
    return kernel_rows({"mhe_tick_pi": (
        "decentralized_ekf_mhe_tpu_torch/csrc/mhe_body.cuh",
        "decentralized_ekf_mhe_tpu/pallas/mhe_replay_kernel.py:917 (per_instance=True)")},
        {"mhe_tick_pi": work}, counts, {"mhe_tick_pi": err}, {"mhe_tick_pi": ms},
        {"mhe_tick_pi": plain_ms},
        mhe_tick_pi={"max_abs_err_shape": {"T": T_BOX_PLAIN, "B": B_MAIN},
                     "plain_ms_shape": {"T": T_PLAIN_F32, "B": B_MAIN, "N": N_WIN},
                     "kernel_only_ms": kernel_only_ms,
                     "path": "make_lanes_fleet_runner, per-instance VOData"})


def pi_box(fleet64, fleet32, gt_v):
    """Configuration 1 on per-lane clocks: the constrained production box
    (|v| <= 0.3, rho=5000 fixed, 20 it + polish) through the MHE-only runner
    at full width, the counted run also the timed one (wall, the tick around
    its wrapper and alone, its ADMM iterations); the tick against its float64
    plain version over T_BOX_PLAIN ticks, the float32 plain version timed over
    T_PLAIN_F32. Returns the kernel's entry of the
    last-but-one line."""
    p = box_params()
    data_b, _, vo = fleet32
    c32 = box_consts(p, F32, V_BOX, 20)
    runner = batch.make_lanes_fleet_runner(p, F32, use_megakernel=True, consts=c32, device=DEV)
    reset_counts()
    mrk.timer.on = True
    with tick_calls() as calls:
        (x, v), wall = wall_ms(lambda: runner(data_b, vo))
    mrk.timer.on = False
    kernel_only_ms = min(mrk.timer.ms())
    wall /= 1e3
    ms, ks_end = call_ms(calls[0]), calls[0]["out"][1]
    counts = read_counts()
    assert counts == dict(NO_LAUNCH, mhe_tick_pi_box=1, admm_solve=1, admm_box_solve=2), counts
    cam, free_bad = split_vo_free(x, vo)
    assert bool(torch.isfinite(v[:, cam]).all())
    vmax = float(x[:, cam, 3:6].abs().max())
    assert V_BOX - 1e-2 <= vmax <= V_BOX + 1e-3, ("velocity box, per-lane clocks", vmax)
    rmse = fleet_rmse(x, gt_v, cam)
    assert rmse < 0.1, f"constrained per-lane-clock RMSE vs ground truth {rmse}"
    run64 = batch.make_lanes_fleet_runner(
        p, F64, use_megakernel=True, consts=box_consts(p, F64, V_BOX, 20), device=DEV)
    x64 = run64(fleet64[0], fleet64[2])[0]
    assert bool(torch.isfinite(x64).all()), "constrained float64 run not finite"
    r64 = fleet_rmse(x64, gt_v, cam)
    assert abs(rmse - r64) < 1e-3, ("constrained per-lane-clock f32-vs-f64 delta", rmse, r64)
    _, ks, d, vv, _ = calls[0]["args"]
    del calls
    # float64 element-wise over T_BOX_PLAIN ticks (y as FMA contraction
    # allows, with the witness); float32 plain time there
    c64 = box_consts(p, F64, V_BOX, 20)
    ks64, (d64, v64, i64) = clock_inputs(c64, fleet64, F64, T=T_BOX_PLAIN)
    _, _, _, e_tick = check_box_tick(c64, c64._replace(use_pallas=False), ks64, d64, v64, i64,
                                     "per-lane clocks, full width", fma=True)
    ksp, (dp_, vp, ip) = clock_inputs(c32, fleet32, F32, T=T_PLAIN_F32)
    _, plain_ms = wall_ms(lambda: mrk.replay_ticks_plain(c32._replace(use_pallas=False),
                                                        ksp, dp_, vp, ip))
    a = c32.admm
    box = (ks_end.iters.cpu().numpy(), a.rho_update_every, a.adaptive_rho,
           a.abs_tol > 0 or a.rel_tol > 0, a.polish)
    groups = _work.mhe_lane_schedules(vv.active.cpu().numpy(), vv.tick_pre.cpu().numpy(),
                                      vv.tick_now.cpu().numpy(), N_WIN,
                                      ks.bez_count[0].cpu().numpy())
    work = _work.mhe_tick_lanes(N_WIN, 9, 12, 4, groups, int((d.contact > 0).sum()), 4, box=box)
    emit("pi_box", config="Go1 N=20, 15 camera clocks, |v|<=0.3, rho=5000 fixed, 20 it + polish",
         T=T_MAIN, B=B_MAIN, dtype="float32", launches=counts, max_abs_v=vmax,
         max_abs_v_f64=float(x64[..., 3:6].abs().max()), rmse_vs_ground_truth=rmse, rmse_f64=r64,
         rmse_lanes=int(cam.sum()), vo_free_lanes_first_nonfinite_tick=free_bad,
         wall_s=wall, wall_from="the counted run",
         pipeline_ticks_per_s=B_MAIN * (T_MAIN - 1) / wall,
         mhe_tick_pi_box_ms=ms, mhe_tick_pi_box_kernel_only_ms=kernel_only_ms,
         max_abs_err_f64={"T": T_BOX_PLAIN, **e_tick},
         plain_f32_ms={"T": T_PLAIN_F32, "ms": plain_ms},
         admm_iters_mean=float(ks_end.iters.double().mean()))
    return kernel_rows({"mhe_tick_pi_box": (
        "decentralized_ekf_mhe_tpu_torch/csrc/mhe_body.cuh",
        "decentralized_ekf_mhe_tpu/pallas/mhe_replay_kernel.py:917 (per_instance=True, admm_ks set)")},
        {"mhe_tick_pi_box": work}, counts, {"mhe_tick_pi_box": max(e_tick[f] for f in "xzy")},
        {"mhe_tick_pi_box": ms}, {"mhe_tick_pi_box": plain_ms},
        mhe_tick_pi_box={"max_abs_err_shape": {"T": T_BOX_PLAIN, "B": B_MAIN},
                         "max_abs_err_by_output": e_tick,
                         "plain_ms_shape": {"T": T_PLAIN_F32, "B": B_MAIN, "N": N_WIN},
                         "kernel_only_ms": kernel_only_ms,
                         "path": "make_lanes_fleet_runner, per-instance VOData, box consts"})


def pi_pipeline(fleet32, gt_v):
    """Configuration 2: the pipeline runner on the shared EKF clock (the EKF
    kernel) with per-lane MHE clocks, at full width; then the pipeline runner
    with per-lane EKF timing too, at T_EKF_PI ticks — its EKF stage is the
    eager scan, timed apart."""
    p, pe = go1_params(), EKFParams()
    data_b, eb, vo = fleet32
    runner = batch.make_pipeline_fleet_runner(p, pe, F32, use_megakernel=True, device=DEV)
    reset_counts()
    (x, v, q), ms = wall_ms(lambda: runner(data_b, eb, vo))
    counts = read_counts()
    assert counts == dict(NO_LAUNCH, ekf_stage=1, tridiag_solve=1, mhe_tick_pi=1), counts
    cam, free_bad = split_vo_free(x, vo)
    assert bool(torch.isfinite(v[:, cam]).all()) and bool(torch.isfinite(q).all())
    rmse = fleet_rmse(x, gt_v, cam)
    assert rmse < 0.1, f"pipeline, per-lane MHE clocks: RMSE vs ground truth {rmse}"

    log, data_e, eb_e, vo_e = make_clock_fleet(T_EKF_PI, B_MAIN, F32, seed=3, ekf_per_lane=True)
    assert eb_e.vo_active.ndim == 3 and bool(eb_e.vo_active.any())
    reset_counts()
    (xe, ve, qe), ms_e = wall_ms(lambda: runner(data_e, eb_e, vo_e))
    counts_e = read_counts()
    assert counts_e == dict(NO_LAUNCH, tridiag_solve=1, mhe_tick_pi=1), counts_e
    assert torch.isfinite(xe).all() and torch.isfinite(qe).all()
    ec = ekf_lanes.make_consts(pe, F32)
    st = ekf_lanes.init_state(pe, B_MAIN, RING, F32, device=DEV)
    (_, q2), ekf_ms = wall_ms(lambda: estimator.scan_ekf_blocks(st, eb_e, ec))
    ok, e = close(q2, qe, rtol=0.0, atol=1e-6)      # the runner's EKF stage
    assert ok, ("per-lane EKF stage of the runner vs scan_ekf_blocks", e)
    gt_e = torch.as_tensor(log.gt_v_s, device=DEV)
    err = xe[20:, :, 3:6].double() - gt_e[20:, None]
    emit("pi_pipeline", T=T_MAIN, B=B_MAIN, dtype="float32", launches=counts, wall_ms=ms,
         rmse_vs_ground_truth=rmse, rmse_lanes=int(cam.sum()),
         vo_free_lanes_first_nonfinite_tick=free_bad,
         per_lane_ekf_timing={"T": T_EKF_PI, "B": B_MAIN, "launches": counts_e,
                              "wall_ms": ms_e, "ekf_stage_eager_ms": ekf_ms,
                              "ekf_events": int(eb_e.vo_active.sum()),
                              "rmse_vs_ground_truth_ticks_20_on": float(torch.sqrt((err ** 2).mean()))})


# ------------------------------------------------ the Cassie and PogoX fleets


def f32_ticks(model, x_tbs, lanes=slice(None)):
    """(gated, first non-finite tick or None) of a float32 result x
    (T,B,...) over ``lanes``: the number of leading ticks its gates hold over
    — all T, or F6_TICKS[model] for a fleet of fault F6 — which must all be
    finite."""
    t_bad = first_nonfinite(x_tbs[:, lanes])
    n = F6_TICKS.get(model, x_tbs.shape[0])
    assert t_bad is None or t_bad >= n, (model, "float32 estimate not finite from tick", t_bad)
    return n, t_bad


def ekf_oriented(model, fleet, dtype):
    """``fleet`` with ``data.R_sb`` replaced by the EKF kernel's orientation,
    as the pipeline feeds the MHE stage."""
    pe = robot_params(model)[1]
    data_b, eb, vo = fleet
    B = data_b.accel_b.shape[1]
    st = ekf_lanes.init_state(pe, B, RING, dtype, device=DEV)
    q, _ = ekf_kernel.replay(ekf_lanes.make_consts(pe, dtype), st, eb, device=DEV)
    R = torch.movedim(ekf_lanes.to_rot(q), -1, 1).contiguous()
    return data_b._replace(R_sb=R), eb, vo


def check_kernels_legged(model):
    """The tick kernels of ``model``'s shape (unconstrained and constrained),
    the tridiagonal solve and the box-ADMM at its state size against their
    plain versions at the small size, float64, the reference's tolerances, on
    the EKF kernel's orientation: a log split over two calls, the plain
    version continuing from a kernel state, per-lane bounds, box-ADMM cases on
    assembled windows, and a ragged fleet through the pipeline runner."""
    p, pe = robot_params(model)
    res = {}
    fleet = ekf_oriented(model, make_fleet(T_CHK, B_CHK, F64, seed=1, model=model)[1:], F64)

    # ---- K2 mhe_tick at this shape; K5 on the tick-0 and a full late window
    c = mhe.make_consts(p, F64, device=DEV)
    ks0, (d1, v1, i1) = clock_inputs(c, fleet, F64)
    assert int(v1.active.sum()) > 0 and T_CHK > N_WIN
    res["mhe_tick_err"], x_free, ks_free = check_tick(c, ks0, d1, v1, i1, f"{model} unconstrained")
    errs = {}
    for tag, ks in (("tick0_window", ks0), ("full_window", ks_free)):
        D, U, r = (a.contiguous() for a in mhe_lanes._masked_system(c, mrk.mhe_state_from_kernel(ks, c)))
        x_kn = tridiag_kernel.solve_lanes(D, U, r, device=DEV)
        ok, errs[tag] = close(x_kn, tridiag_kernel.solve_lanes_plain(D, U, r), **TOL_MHE)
        assert ok, ("tridiag_solve vs plain", model, tag, errs[tag])
    ok, errs["newest_state_vs_full_solve"] = close(x_kn[-1], x_free[-1], **TOL_MHE)
    assert ok, ("mhe_tick newest state vs full window solve", model)
    res["tridiag_err"] = errs

    # ---- K2c on a box that binds (half the unconstrained run's largest |v|),
    # shared and per-lane bounds; K4 on assembled windows
    bound = 0.5 * float(x_free[:, 3:6].abs().max())
    pb = box_params(tol=1e-8, model=model)
    cb = box_consts(pb, F64, bound, 20)
    ksb, _ = clock_inputs(cb, fleet, F64)
    res["mhe_tick_box_err"], xb, ksb_end = check_tick(cb, ksb, d1, v1, i1, f"{model} constrained")
    vmax = float(xb[:, 3:6].abs().max())
    assert bound - 1e-6 <= vmax <= bound + 1e-3, ("box not active or violated", model, vmax, bound)
    lane_bound = torch.linspace(0.4 * bound, 1.2 * bound, B_CHK, dtype=F64, device=DEV)
    c_pl = box_consts(pb, F64, lane_bound, 20)
    ks_pl, (dA, vA, iA) = clock_inputs(c_pl, fleet, F64, T=30)
    x_pl, _, _, e_pl = check_box_tick(c_pl, c_pl._replace(use_pallas=False), ks_pl, dA, vA, iA,
                                      f"{model} per-lane bounds")
    assert bool((x_pl[:, 3:6].abs().amax(dim=(0, 1)) <= lane_bound + 1e-3).all())
    res["mhe_tick_box_err"]["per_lane_bounds"] = max(e_pl[f] for f in "xzy")
    first = (estimator.TickData(*(a[:5] for a in d1)), estimator.VOData(*(a[:5] for a in v1)),
             i1[:5])
    errs = {}
    for tag, args, kw in admm_cases(cb, c_pl, ksb, ksb_end, first, model=model):
        e, limits, res_k = check_admm(f"{model} {tag}", *args, **kw)
        errs[tag] = dict(e, iters=[int(res_k.iters.min()), int(res_k.iters.max())])
        if limits:
            errs[tag]["limit_where_rho_adapted"] = limits
    res["admm_err"] = errs

    # ---- a ragged fleet through the pipeline runner: kernels vs eager path
    _, *fleet_r = make_fleet(T_RAGGED, B_RAGGED, F64, seed=2, model=model)
    errs = {}
    for tag, cr in (("unconstrained", mhe.make_consts(p, F64, device=DEV)),
                    ("constrained", box_consts(pb, F64, bound, 20))):
        run_k = batch.make_pipeline_fleet_runner(p, pe, F64, use_megakernel=True, consts=cr,
                                                 device=DEV)
        run_p = batch.make_pipeline_fleet_runner(p, pe, F64, use_megakernel=False,
                                                 consts=cr._replace(use_pallas=False), device=DEV)
        (xk, vk, qk), (xp, vp, qp) = run_k(*fleet_r), run_p(*fleet_r)
        okq, eq = close(qk, qp, **TOL_EKF)
        okx, ex = close(xk, xp, **TOL_MHE)
        okv, ev = close(vk, vp, **TOL_MHE)
        assert okq and okx and okv, ("ragged B", model, tag, eq, ex, ev)
        errs[tag] = {"q": eq, "x": ex, "v": ev}
    res["ragged_err"] = {"B": B_RAGGED, "T": T_RAGGED, **errs}
    emit("kernels_legged", model=model, s=p.dim_state, m=p.dim_meas, L=p.num_legs,
         leg_odom_type=p.leg_odom_type, dtype="float64", N=N_WIN, T=T_CHK, B=B_CHK,
         tol=TOL_MHE, tol_ekf=TOL_EKF, box=bound, osqp_tol=1e-8, **res)
    return res


def admm_work_settings(c):
    """(E, adaptive, check, polish) of consts ``c``'s box-ADMM, as ``_work``
    counts them."""
    a = c.admm
    return a.rho_update_every, a.adaptive_rho, a.abs_tol > 0 or a.rel_tol > 0, a.polish


def first_nonfinite(x_tbs):
    """The first tick at which a (T,B,...) result is not finite, or None."""
    bad = ~torch.isfinite(x_tbs.reshape(x_tbs.shape[0], -1)).all(-1)
    return int(torch.nonzero(bad)[0, 0]) if bool(bad.any()) else None


def box_tick_figures(p, c, call):
    """A constrained tick call recorded by ``tick_calls`` (a runner's counted
    run): its ms around the wrapper, its (bytes, operations) from the
    schedule it walked and the ADMM iterations its instances took, and those
    iterations ((Tn,B))."""
    _, ks0, d, v, _ = call["args"]
    iters = call["out"][1].iters
    sched = _work.mhe_schedule(v.active.tolist(), v.tick_pre.tolist(), v.tick_now.tolist(),
                               N_WIN, int(ks0.bez_count))
    work = _work.mhe_tick(N_WIN, p.dim_state, p.dim_meas, p.num_legs, d.accel_b.shape[-1], sched,
                          int((d.contact > 0).sum()), 4,
                          box=(iters.cpu().numpy(),) + admm_work_settings(c), lot=p.leg_odom_type)
    return call_ms(call), work, iters


def bench_route(model, fleet64, fleet32, gt_v):
    """``model``'s fleet through the route of the reference's bench for the
    legged shapes (bench.py:451-491): the lanes runner (the MHE alone, on the
    log's orientation) at full width, unconstrained and with the |v| <= 0.3
    box: launches, finite and the RMSE against ground truth over the whole
    log, the float64 run of the same route on the same fleet over the whole
    log, constrained too, the f32-vs-f64 RMSE delta over it (the constrained
    one over its first T_BOX_F64 ticks), the box over the whole float64 run
    and the first F6_TICKS[model] ticks of the float32 one (fault F6). The counted float32
    runs are the timed ones: the tick kernel alone (``mrk.timer``), and for
    the constrained tick its time around the wrapper, bound and ADMM
    iterations. Also prints where the pipeline runner's float32 estimate on
    this fleet stops being finite (fault F6). Returns the constrained tick's
    figures and the unconstrained tick's kernel-alone time. The pipeline
    runner's run covers the first T_F6_PIPE ticks."""
    p, pe = robot_params(model)
    pb = box_params(model=model)
    gate = RMSE_GATE[model]
    data_b, eb, vo_b = fleet32
    res, failed = {}, []
    per_100 = lambda a: a.reshape(a.shape[0] // 100, -1).amax(-1).tolist()
    for tag, pp, c32, c64, t_delta, launched in (
            ("unconstrained", p, None, None, T_MAIN, dict(tridiag_solve=1, mhe_tick=1)),
            ("constrained", pb, box_consts(pb, F32, V_BOX, 20), box_consts(pb, F64, V_BOX, 20),
             T_BOX_F64, dict(admm_solve=1, mhe_tick_box=1, admm_box_solve=2))):
        run = batch.make_lanes_fleet_runner(pp, F32, use_megakernel=True, consts=c32, device=DEV)
        reset_counts()
        mrk.timer.on = True
        with tick_calls() as calls:
            (x, _), ms = wall_ms(lambda: run(data_b, vo_b))
        mrk.timer.on = False
        k_only = min(mrk.timer.ms())
        counts = read_counts()
        assert counts == dict(NO_LAUNCH, **launched), (model, tag, counts)
        run64 = batch.make_lanes_fleet_runner(pp, F64, use_megakernel=True, consts=c64,
                                              device=DEV)
        # both float64 twins run the whole log: the constrained one holds
        # the box past the ticks where float32 leaves it (F6)
        t64 = T_MAIN
        d64, _, vo64 = head(fleet64, t64)
        x64 = run64(d64, vo64)[0]
        rmse, r64 = fleet_rmse(x, gt_v), fleet_rmse(x64, gt_v[:t64])
        r32_d, r64_d = fleet_rmse(x[:t_delta], gt_v[:t_delta]), fleet_rmse(x64[:t_delta], gt_v[:t_delta])
        res[tag] = {"wall_s": ms / 1e3, "ticks_per_s": B_MAIN * (T_MAIN - 1) / (ms / 1e3),
                    "launches": counts, "tick_kernel_only_ms": k_only,
                    "rmse_vs_ground_truth": rmse, "rmse_f64": r64,
                    "f32_vs_f64_delta_gated": {"T": t_delta, "rmse_f32": r32_d, "rmse_f64": r64_d},
                    "f64_twin_T": t64, "f32_vs_f64_velocity_max_abs_per_100_ticks":
                        per_100((x[:t64, :, 3:6].double() - x64[..., 3:6]).abs())}
        failed += [(tag, what) for what, ok in (
            ("float32 estimate finite", bool(torch.isfinite(x).all())),
            ("float64 estimate finite", bool(torch.isfinite(x64).all())),
            ("RMSE vs ground truth", rmse < gate and r64 < gate),
            ("f32-vs-f64 velocity-RMSE delta", abs(r32_d - r64_d) < 1e-3)) if not ok]
        if c32 is not None:
            v32, v64 = x[..., 3:6].abs(), x64[..., 3:6].abs()
            n_box = F6_TICKS[model]
            vmax, vmax64 = float(v32[:n_box].max()), float(v64.max())
            res[tag].update(max_abs_v={"T": n_box, "f32": vmax},
                            max_abs_v_f64=vmax64, max_abs_v_per_100_ticks=per_100(v32),
                            max_abs_v_f64_per_100_ticks=per_100(v64))
            failed += [(tag, what) for what, ok in (
                ("velocity box, float32", V_BOX - 1e-2 <= vmax <= V_BOX + 1e-3),
                ("velocity box, float64", V_BOX - 1e-2 <= vmax64 <= V_BOX + 1e-3)) if not ok]
            del v32, v64
            # the constrained tick of the counted run: time, bound, iterations
            ms_tick, work, iters = box_tick_figures(pp, c32, calls[0])
            t_bad = first_nonfinite(x)
            tick = {"fleet": model, "T": T_MAIN, "B": B_MAIN, "dtype": "float32", "ms": ms_tick,
                    "kernel_only_ms": k_only, "ms_per_tick": ms_tick / (T_MAIN - 1),
                    **bound(work), "bytes": work[0], "operations": work[1],
                    "f32_first_nonfinite_tick": t_bad,
                    "admm_iters_mean": float(iters.double().mean()),
                    "path": "the counted run of make_lanes_fleet_runner"}
        else:
            k2_ms = k_only
        del x, x64, calls

    pipe = batch.make_pipeline_fleet_runner(p, pe, F32, use_megakernel=True, device=DEV)
    pipe_bad = first_nonfinite(pipe(*head(fleet32, T_F6_PIPE))[0])
    emit("bench_route", model=model,
         config=f"{model} N={N_WIN} s={p.dim_state} m={p.dim_meas} L={p.num_legs} "
                f"leg_odom_type={p.leg_odom_type}; lanes runner; box |v|<=0.3, rho=5000 fixed, "
                "20 it + polish",
         T=T_MAIN, B=B_MAIN, dtype="float32", rmse_gate=gate, f32_gated_ticks=T_MAIN, **res,
         mhe_tick_box_alone=tick,
         pipeline_runner_f32_first_nonfinite_tick=pipe_bad,
         failed=failed)
    assert not failed, (model, failed)
    return tick, k2_ms


def window_inputs(c, fleet, R, dtype, T):
    """The first T ticks of ``fleet`` as the MHE stage gets them on the
    orientation R (T,3,3,B): (tick-0 state, its kernel state, the per-tick
    inputs of ticks 1..T-1)."""
    data_b, _, vo_b = fleet
    data_l = batch.tickdata_to_lanes(
        estimator.TickData(*(a[:T] for a in data_b)))._replace(R_sb=R[:T].to(dtype))
    vo = estimator.VOData(*(a[:T] for a in vo_b))
    st0, vo_inc = mhe_inputs(c, data_l, vo, dtype)
    return st0, mrk.kernel_state_from_mhe(st0, c), seg(data_l, vo, vo_inc, slice(1, None))


def legged_full_width(model, fleet64, fleet32, q64, counts, box_counts, mhe_tick_ms, box_tick):
    """``model``'s new kernel instantiations against their plain versions at
    the main path's width (B=1024, N=20) on the float64 main path's
    orientation: float64 element-wise over T_BOX_PLAIN ticks; the kernels'
    float32 times over the whole log (the ticks' from the main path's runs:
    the unconstrained one's ``mhe_tick_ms``, the constrained one's
    ``box_tick`` from ``box_path``), the plain versions' over T_PLAIN_F32
    ticks (eager loops), and the float32 kernel held to the float64 plain
    version by accuracy there; the bounds from this run's inputs. Returns the
    kernels' entries of the last-but-one line."""
    p = robot_params(model)[0]
    pb = box_params(model=model)
    s, m, L, lot = p.dim_state, p.dim_meas, p.num_legs, p.leg_odom_type
    R64 = ekf_lanes.to_rot(q64)
    tag = f"[{model}]"
    inputs = lambda c, fleet, dtype, T: window_inputs(c, fleet, R64, dtype, T)

    def window(c, st):
        return (*(a.contiguous() for a in mhe_lanes._masked_system(c, st)), c.x_lb, c.x_ub, c.admm)

    err, ms, plain_ms, works, more = {}, {}, {}, {}, {}
    # ---- unconstrained: K2 at this shape, K5 at this state size
    c64 = mhe.make_consts(p, F64, use_pallas=False, device=DEV)
    st0, ks0, (d, v, i) = inputs(c64, fleet64, F64, T_BOX_PLAIN)
    (x_p, _), plain64_ms = wall_ms(lambda: mrk.replay_ticks_plain(c64, ks0, d, v, i))
    x_k, ks_k = mrk.replay_ticks(c64, ks0, d, v, i, device=DEV)
    ok, err["mhe_tick" + tag] = close(x_k, x_p, **TOL_MHE)
    assert ok, (f"{model} mhe_tick at full width", err["mhe_tick" + tag])
    errs = []
    for st_w in (st0, mrk.mhe_state_from_kernel(ks_k, c64)):
        D, U, r = (a.contiguous() for a in mhe_lanes._masked_system(c64, st_w))
        ok, e = close(tridiag_kernel.solve_lanes(D, U, r, device=DEV),
                      tridiag_kernel.solve_lanes_plain(D, U, r), **TOL_MHE)
        assert ok, (f"{model} tridiag_solve at full width", e)
        errs.append(e)
    err[f"tridiag_solve[s={s}]"] = max(errs)

    c32 = mhe.make_consts(p, F32, use_pallas=False, device=DEV)
    T = fleet32[0].accel_b.shape[0]      # T_F6_BOX for yaml Cassie (F6)
    st32, ks32, (d32, v32, i32) = inputs(c32, fleet32, F32, T)
    ms["mhe_tick" + tag] = mhe_tick_ms
    _, ksp, (dp_, vp, ip) = inputs(c32, fleet32, F32, T_PLAIN_F32)
    (x32p, _), plain_ms["mhe_tick" + tag] = wall_ms(
        lambda: mrk.replay_ticks_plain(c32, ksp, dp_, vp, ip))
    x32k, _ = mrk.replay_ticks(c32, ksp, dp_, vp, ip, device=DEV)
    ref = x_p[:T_PLAIN_F32 - 1]
    rk, rp = vel_rmse(x32k, ref, N_WIN), vel_rmse(x32p, ref, N_WIN)
    assert abs(rk - rp) < 1e-3, (f"{model} f32 velocity-RMSE delta", rk, rp)
    tri32 = tuple(a.contiguous() for a in mhe_lanes._masked_system(c32, st32))
    ms[f"tridiag_solve[s={s}]"] = timed(lambda: tridiag_kernel.solve_lanes(*tri32, device=DEV))
    plain_ms[f"tridiag_solve[s={s}]"] = timed(lambda: tridiag_kernel.solve_lanes_plain(*tri32))
    lib_ms, lib_diff = library_ms(*(torch.movedim(a, -1, 1) for a in tri32))
    more[f"tridiag_solve[s={s}]"] = {
        "library_ms": lib_ms, "library_minus_kernel_max_abs_f32": lib_diff,
        "library": "torch.linalg.solve on the densified (B, N*s, N*s) system"}
    sched = _work.mhe_schedule(v32.active.tolist(), v32.tick_pre.tolist(),
                               v32.tick_now.tolist(), N_WIN, int(ks32.bez_count))
    n_stance = int((d32.contact > 0).sum())
    works["mhe_tick" + tag] = _work.mhe_tick(N_WIN, s, m, L, B_MAIN, sched, n_stance, 4, lot=lot)
    works[f"tridiag_solve[s={s}]"] = _work.tridiag(N_WIN, s, B_MAIN, 4, n_states=1)
    more["mhe_tick" + tag] = {
        "max_abs_err_shape": {"T": T_BOX_PLAIN, "B": B_MAIN},
        "shape": {"T": T, "B": B_MAIN, "N": N_WIN},
        "ms_how": "the kernel alone (CUDA events), best of the main path's timed runs",
        "plain_ms_shape": {"T": T_PLAIN_F32, "B": B_MAIN, "N": N_WIN},
        "plain_f64_ms": plain64_ms,
        "f32_vel_rmse_vs_f64": {"kernel": rk, "plain": rp, "ticks": [N_WIN + 1, T_PLAIN_F32 - 1]}}
    del x32k, x32p

    # ---- constrained: K2c at this shape, K4 and K3 at this state size
    cb64 = box_consts(pb, F64, V_BOX, 20)
    st0b, ks0b, (db, vb, ib) = inputs(cb64, fleet64, F64, T_BOX_PLAIN)
    t0 = time.time()
    x_bk, ksb_k, x_bp, e_tick = check_box_tick(cb64, cb64._replace(use_pallas=False), ks0b, db,
                                               vb, ib, f"{model} full width",
                                               rounding=model in Y_ROUNDING_ROBOTS)
    plainb64_s = time.time() - t0
    st_l = mrk.mhe_state_from_kernel(ksb_k, cb64)
    e0, _, _ = check_admm(f"{model} tick-0 window", *window(cb64, st0b))
    el, _, _ = check_admm(f"{model} final window", *window(cb64, st_l),
                          z0=st_l.z_adm.contiguous(), y0=st_l.y_adm.contiguous())
    err["mhe_tick_box" + tag] = max(e_tick[f] for f in "xzy")
    err[f"admm_solve[s={s}]"] = max(*e0.values(), *el.values())
    err[f"admm_box_solve[s={s}]"] = max(el.values())

    cb32 = box_consts(pb, F32, V_BOX, 20)
    stb32, ksbp, (dbp, vbp, ibp) = inputs(cb32, fleet32, F32, T_PLAIN_F32)
    xb32, _ = mrk.replay_ticks(cb32, ksbp, dbp, vbp, ibp, device=DEV)
    (xb32p, _), plain_ms["mhe_tick_box" + tag] = wall_ms(
        lambda: mrk.replay_ticks_plain(cb32._replace(use_pallas=False), ksbp, dbp, vbp, ibp))
    ms["mhe_tick_box" + tag], works["mhe_tick_box" + tag] = box_tick["ms"], box_tick["work"]
    kb_only, nb, ks_end = box_tick["kernel_only_ms"], box_tick["t_bad"], box_tick["ks_end"]
    ref = x_bp[:T_PLAIN_F32 - 1]
    rbk, rbp = vel_rmse(xb32, ref, N_WIN), vel_rmse(xb32p, ref, N_WIN)
    assert abs(rbk - rbp) < 1e-3, (f"{model} constrained f32 velocity-RMSE delta", rbk, rbp)
    del xb32, xb32p
    st_end = mrk.mhe_state_from_kernel(ks_end, cb32)
    iters = {}
    for name, args, kw in ((f"admm_solve[s={s}]", window(cb32, stb32), {}),
                           (f"admm_box_solve[s={s}]", window(cb32, st_end),
                            dict(z0=st_end.z_adm.contiguous(), y0=st_end.y_adm.contiguous()))):
        run = lambda: admm_kernel.solve_box_lanes(*args, device=DEV, **kw)
        iters[name] = run().iters.cpu().numpy()
        ms[name] = timed(run)
        plain_ms[name] = timed(lambda: admm_kernel.solve_box_lanes_plain(*args, **kw), reps=1)
    box = admm_work_settings(cb32)
    works[f"admm_solve[s={s}]"] = _work.admm(N_WIN, s, B_MAIN, 4, iters[f"admm_solve[s={s}]"],
                                            *box, n_states=1)
    works[f"admm_box_solve[s={s}]"] = _work.admm(N_WIN, s, B_MAIN, 4,
                                                iters[f"admm_box_solve[s={s}]"], *box)
    f64_shape = {"T": T_BOX_PLAIN, "B": B_MAIN}
    more["mhe_tick_box" + tag] = {
        "max_abs_err_shape": f64_shape, "max_abs_err_by_output": e_tick,
        "kernel_only_ms": kb_only, "ms_runs": 1, "plain_and_kernel_f64_s": plainb64_s,
        "ms_how": "the constrained main path's counted run (box_path), around the wrapper",
        "f32_first_nonfinite_tick": nb,
        "plain_ms_shape": {"T": T_PLAIN_F32, "B": B_MAIN, "N": N_WIN},
        "admm_iters_mean": float(box_tick["iters"].double().mean()),
        "f32_vel_rmse_vs_f64": {"kernel": rbk, "plain": rbp, "ticks": [N_WIN + 1, T_PLAIN_F32 - 1]}}
    more[f"admm_solve[s={s}]"] = {"shape": {"B": B_MAIN, "N": N_WIN, "window": "tick 0: one real slot"},
                                  "max_abs_err_by_output": {"tick0_window": e0, "final_window": el}}
    more[f"admm_box_solve[s={s}]"] = {
        "shape": {"B": B_MAIN, "N": N_WIN, "window": "final: 20 real slots"},
        "note": "device function inside mhe_tick_box and admm_solve: launches counts those "
                "two kernels' launches; ms, plain_ms and the bound are of one warm-started "
                "whole-window solve through admm_solve"}
    emit(f"{model}_full_width", B=B_MAIN, N=N_WIN, T_f64=T_BOX_PLAIN, T_f32_kernel=T,
         T_f32_plain=T_PLAIN_F32, tol=TOL_MHE, max_abs_err_f64=err,
         max_abs_err_f64_by_output={"mhe_tick_box": e_tick, "admm_solve": {"tick0": e0, "final": el}},
         kernel_f32_ms=ms, plain_f32_ms=plain_ms, mhe_tick_box_kernel_only_ms=kb_only)

    src = "decentralized_ekf_mhe_tpu_torch/csrc/"
    tpu = "decentralized_ekf_mhe_tpu/pallas/"
    meta = {"mhe_tick" + tag: (src + "mhe_body.cuh", tpu + "mhe_replay_kernel.py:917"),
            "mhe_tick_box" + tag: (src + "mhe_body.cuh",
                                   tpu + "mhe_replay_kernel.py:917 (admm_ks set)")}
    launches = {"mhe_tick" + tag: counts["mhe_tick"],
                "mhe_tick_box" + tag: box_counts["mhe_tick_box"]}
    if s != 9:     # the s=9 solves are Go1's instantiations, in their rows above
        meta.update({
            f"tridiag_solve[s={s}]": (src + "tridiag.cu", tpu + "tridiag_kernel.py:213"),
            f"admm_solve[s={s}]": (src + "admm.cu", tpu + "admm_kernel.py:75"),
            f"admm_box_solve[s={s}]": (src + "admm_group.cuh", tpu + "admm_core.py:133")})
        launches.update({f"tridiag_solve[s={s}]": counts["tridiag_solve"],
                         f"admm_solve[s={s}]": box_counts["admm_solve"],
                         f"admm_box_solve[s={s}]": box_counts["admm_box_solve"]})
    return kernel_rows(meta, works, launches, err, ms, plain_ms,
                       **{k: dict(v, model=model) for k, v in more.items() if k in meta})



# ------------------------------------------- the Cholesky tail (K2d)


def check_kernels_chol(model):
    """K2d, the tick with the Cholesky tail, at ``model``'s shape against its
    plain version (the tick loop both tails share) and against K2, at the
    small size, float64, on the EKF kernel's orientation: a log split over
    two calls, the plain version from a kernel state, a ragged fleet through
    the lanes runner with DEM_MK_SOLVE=chol. Then K2d-PI, the tail on
    per-lane camera clocks, on the 15-clock fleet: against its plain version
    (split log, plain version from a kernel state), against K2b, with the
    shared-clock fleet's clock given to every lane against K2d (1e-12
    absolute: the ingestion runs the same statements), and a ragged 15-clock
    fleet through the lanes runner with DEM_MK_SOLVE=chol. And the refusal of
    a tail that does not exist."""
    p = robot_params(model)[0]
    fleet = ekf_oriented(model, make_fleet(T_CHK, B_CHK, F64, seed=1, model=model)[1:], F64)
    c = mhe.make_consts(p, F64, device=DEV)
    ks0, (d1, v1, i1) = clock_inputs(c, fleet, F64)
    assert int(v1.active.sum()) > 0 and T_CHK > N_WIN
    x_p, ks_p = mrk.replay_ticks_plain(c._replace(use_pallas=False), ks0, d1, v1, i1)
    reset_counts()
    x_k, ks_k = mrk.replay_ticks(c, ks0, d1, v1, i1, device=DEV, mk_solve="chol")
    assert read_counts() == dict(NO_LAUNCH, mhe_tick_chol=1), read_counts()
    errs = {}
    ok, errs["x"] = close(x_k, x_p, **TOL_MHE)
    assert ok, ("mhe_tick_chol vs plain", model, errs["x"])
    check_schedule(ks_k, ks_p, f"{model} chol")
    x_g, _ = mrk.replay_ticks(c, ks0, d1, v1, i1, device=DEV)
    ok, errs["vs_gauss_jordan_kernel"] = close(x_k, x_g, **TOL_CHOL_VS_GJ)
    if not ok:
        errs["tails_witness"] = tails_witness(c, ks0, d1, v1, i1, x_k, x_g, f"{model} chol")
    cut = lambda sl: (estimator.TickData(*(a[sl] for a in d1)),
                      estimator.VOData(*(a[sl] for a in v1)), i1[sl])
    xA, ksA = mrk.replay_ticks(c, ks0, *cut(slice(0, 30)), device=DEV, mk_solve="chol")
    xB, ksB = mrk.replay_ticks(c, ksA, *cut(slice(30, None)), device=DEV, mk_solve="chol")
    ok, errs["split_log"] = close(torch.cat([xA, xB]), x_k, **TOL_MHE)
    assert ok and ksB.t == ks_k.t, ("mhe_tick_chol split-log resume", model, errs["split_log"])
    xBp, _ = mrk.replay_ticks_plain(c._replace(use_pallas=False), ksA, *cut(slice(30, None)))
    ok, errs["plain_from_kernel_state"] = close(xB, xBp, **TOL_MHE)
    assert ok, ("plain version from a mhe_tick_chol state", model, errs["plain_from_kernel_state"])

    # a ragged fleet through the lanes runner, the tail from the environment
    _, data_r, _, vo_r = make_fleet(T_RAGGED, B_RAGGED, F64, seed=2, model=model)
    run_p = batch.make_lanes_fleet_runner(p, F64, use_megakernel=False, use_pallas=False,
                                          device=DEV)
    with mk_solve_env("chol"):
        run_k = batch.make_lanes_fleet_runner(p, F64, use_megakernel=True, device=DEV)
        reset_counts()
        xk, vk = run_k(data_r, vo_r)
        assert read_counts() == dict(NO_LAUNCH, tridiag_solve=1, mhe_tick_chol=1), read_counts()
        xp, vp = run_p(data_r, vo_r)
        okx, ex = close(xk, xp, **TOL_MHE)
        okv, ev = close(vk, vp, **TOL_MHE)
        assert okx and okv, ("ragged B, DEM_MK_SOLVE=chol", model, ex, ev)
        errs["ragged"] = {"B": B_RAGGED, "T": T_RAGGED, "x": ex, "v": ev}
        # per-lane clocks: a ragged 15-clock fleet through the same runners
        _, data_c, _, vo_c = make_clock_fleet(T_RAGGED_PI, B_RAGGED, F64, seed=2, model=model)
        reset_counts()
        xk, vk = run_k(data_c, vo_c)
        assert read_counts() == dict(NO_LAUNCH, tridiag_solve=1, mhe_tick_pi_chol=1), \
            read_counts()
        xp, vp = run_p(data_c, vo_c)
        okx, ex = close(xk, xp, **TOL_MHE)
        okv, ev = close(vk, vp, **TOL_MHE)
        assert okx and okv, ("ragged B, per-lane clocks, DEM_MK_SOLVE=chol", model, ex, ev)
        pi_ragged = {"B": B_RAGGED, "T": T_RAGGED_PI, "x": ex, "v": ev}

    # K2d-PI at the small size on the 15-clock fleet
    _, *cfleet = make_clock_fleet(T_CHK, B_CHK, F64, seed=1, model=model)
    cks0, (cd, cv, ci) = clock_inputs(c, cfleet, F64)
    reset_counts()
    pi_errs, x_pi, _ = check_tick(c, cks0, cd, cv, ci, f"{model} Cholesky tail, per-lane clocks",
                                  mk_solve="chol")
    assert read_counts() == dict(NO_LAUNCH, mhe_tick_pi_chol=3), read_counts()
    x_pg, _ = mrk.replay_ticks(c, cks0, cd, cv, ci, device=DEV)
    ok, pi_errs["vs_gauss_jordan_kernel"] = close(x_pi, x_pg, **TOL_CHOL_VS_GJ)
    if not ok:
        pi_errs["tails_witness"] = tails_witness(c, cks0, cd, cv, ci, x_pi, x_pg,
                                                 f"{model} pi_chol")
    ks_u, (_, vu, iu) = clock_inputs(c, (fleet[0], None, uniform_clock(fleet[2], B_CHK)), F64)
    x_u, _ = mrk.replay_ticks(c, ks_u, d1, vu, iu, device=DEV, mk_solve="chol")
    ok, pi_errs["uniform_clock_vs_shared"] = close(x_u, x_k, rtol=0.0, atol=1e-12)
    assert ok, ("uniform per-lane clocks vs mhe_tick_chol", model,
                pi_errs["uniform_clock_vs_shared"])
    pi_errs["ragged"] = pi_ragged
    try:
        mrk.replay(c, batch.tickdata_to_lanes(data_r), vo_r, dtype=F64, device=DEV,
                   mk_solve="cholesky")
        unknown = None
    except ValueError as e:
        unknown = str(e)
    assert unknown, "an unknown tail must raise"
    # both units run a group of threads per instance: their launch
    group = {clock: tick_group_figures(p, pi, "chol")
             for clock, pi in (("shared", False), ("per_lane", True))}
    emit("kernels_chol", model=model, s=p.dim_state, m=p.dim_meas, L=p.num_legs,
         leg_odom_type=p.leg_odom_type, threads_per_instance=mrk.group_size(p.dim_state),
         group_launch=group, dtype="float64", N=N_WIN, T=T_CHK, B=B_CHK,
         tol=TOL_MHE, tol_vs_gauss_jordan=TOL_CHOL_VS_GJ, tol_uniform_vs_shared=1e-12,
         mhe_tick_chol_err=errs, clocks=N_CLOCKS, vo_free_lanes=B_CHK // VO_FREE_EVERY,
         mhe_tick_pi_chol_err=pi_errs, unknown_tail_refused=unknown)
    return {"mhe_tick_chol": errs, "mhe_tick_pi_chol": pi_errs}


def plain_chol_ticks(c, ks0, d, v, i):
    """x of the plain tick loop over the ticks handed in with the Cholesky
    tail's own sweep (``mrk._step_ablated`` with no stage skipped and
    ``mrk._chol_sweep`` over every tick's window side by side, as
    ``mrk.replay_ticks_plain`` runs it for the stage ablation): the plain
    version of K2d and K2d-PI statement by statement, where the shared plain
    version of both tails solves each window by Gauss-Jordan."""
    c = c._replace(use_pallas=False)
    st = mrk.mhe_state_from_kernel(ks0, c)
    per_lane = v.active.ndim == 2
    act, pre, now = ((v.active, v.tick_pre, v.tick_now) if per_lane else
                     (v.active.tolist(), v.tick_pre.tolist(), v.tick_now.tolist()))
    Tn, B, systems = d.accel_b.shape[0], d.accel_b.shape[-1], []
    for t in range(Tn):
        st, _, _ = mrk._step_ablated(c, st, d.R_sb[t], d.accel_b[t], d.omega_b[t], d.p_foot[t],
                                     d.J_foot[t], d.dq[t], d.contact[t], act[t], pre[t], now[t],
                                     i[t], "", "chol", systems)
    x = mrk._chol_sweep(*(torch.cat(a, dim=-1) for a in zip(*systems)))
    return x.reshape(c.dim_state, Tn, B).movedim(1, 0)


def tails_witness(c, ks0, d, v, i, x_chol, x_gj, tag):
    """Where the Cholesky-tail kernel (``x_chol``) departs from the
    Gauss-Jordan one (``x_gj``) by more than TOL_CHOL_VS_GJ — the reference's
    test of the two tails, which it runs at Go1's shape (s=9) — the two
    tails' plain versions on the same inputs (float64, on the card): the
    Gauss-Jordan one (``mrk.replay_ticks_plain``) and the Cholesky one's own
    sweep (``plain_chol_ticks``). The kernels may depart only where the plain
    tails depart beyond the limit themselves (at s=21 they do: the two
    algorithms' rounding departs by more at that shape, ROADMAP §3 fault
    F10); then each kernel must meet TOL_MHE against its own tail's plain
    version, and the kernels' difference may reach at most
    Y_OVER_TOL_ROUNDING times the limit. Emits and returns the readings (the
    largest |a - b| / (atol + rtol |b|))."""
    x_pg, _ = mrk.replay_ticks_plain(c._replace(use_pallas=False), ks0, d, v, i)
    x_pc = plain_chol_ticks(c, ks0, d, v, i)
    ratio = lambda a, b, tol=TOL_CHOL_VS_GJ: float(over_tol(a, b, tol).max())
    res = {"kernels_over_tol": ratio(x_chol, x_gj), "plain_tails_over_tol": ratio(x_pc, x_pg),
           "chol_kernel_vs_plain_chol_over_tol_mhe": ratio(x_chol, x_pc, TOL_MHE),
           "gj_kernel_vs_plain_gj_over_tol_mhe": ratio(x_gj, x_pg, TOL_MHE),
           "max_abs": {"kernels": float((x_chol - x_gj).abs().max()),
                       "plain_tails": float((x_pc - x_pg).abs().max())},
           "tol": TOL_CHOL_VS_GJ, "allowance": Y_OVER_TOL_ROUNDING}
    emit("tails_witness", of=tag, **res)
    assert res["plain_tails_over_tol"] > 1.0, ("mhe_tick_chol vs mhe_tick", tag, res)
    assert (res["chol_kernel_vs_plain_chol_over_tol_mhe"] <= 1.0
            and res["gj_kernel_vs_plain_gj_over_tol_mhe"] <= 1.0), ("tails witness", tag, res)
    assert res["kernels_over_tol"] <= Y_OVER_TOL_ROUNDING, ("tails witness", tag, res)
    return res


def chol_path(model, fleet64, fleet32, gt_v, k2_ms=None):
    """Cell (p): DEM_MK_SOLVE=chol on ``model``'s headline path at full width —
    Go1's and PogoX's pipeline runner, Cassie's (at the bench's settings) lanes
    runner, where the pipeline runner's float32 estimate breaks down (F6).
    The counted float32 run (also the timed one: the tick kernel alone) and a
    float64 run of the same path: launches, accuracy against ground truth and
    float32 against float64 over the whole log (on Cassie's shape, where the
    float32 Cholesky tail breaks down on this fleet (F6), over its first
    F6_TICKS[model] ticks: ``f32_ticks``), the difference per 100 ticks;
    K2d against its plain version in float64 on the float64 run's own inputs
    over T_BOX_PLAIN ticks; K2d and K2 on the float32 run's inputs timed in
    turns (two each; Cassie: the counted run against ``k2_ms``, the
    Gauss-Jordan tick of ``bench_route``'s counted run on the same fleet),
    with both kernels' ptxas figures. Returns the kernel's entry of the
    last-but-one line."""
    p, pe = robot_params(model)
    s, tag = p.dim_state, {"cassie_bench": "cassie"}.get(model, model)
    lanes = model == "cassie_bench"
    gate = RMSE_GATE[model]

    def make(dtype):
        if lanes:
            run = batch.make_lanes_fleet_runner(p, dtype, use_megakernel=True, device=DEV)
            return lambda f: run(f[0], f[2])[0]
        run = batch.make_pipeline_fleet_runner(p, pe, dtype, use_megakernel=True, device=DEV)
        return lambda f: run(*f)[0]

    with mk_solve_env("chol"):
        run32 = make(F32)
        reset_counts()
        mrk.timer.on = True
        with tick_calls() as calls:
            x, wall = wall_ms(lambda: run32(fleet32))
        mrk.timer.on = False
        counted_ms = mrk.timer.ms()
        counts = read_counts()
        want = dict(NO_LAUNCH, tridiag_solve=1, mhe_tick_chol=1, ekf_stage=0 if lanes else 1)
        assert counts == want, (model, counts)
        with tick_calls() as calls64:
            x64 = make(F64)(fleet64)
    assert x.shape == (T_MAIN, B_MAIN, s)
    n, t_bad = f32_ticks(model, x)
    rmse, r64_all = fleet_rmse(x[:n], gt_v[:n]), fleet_rmse(x64, gt_v)
    r64 = fleet_rmse(x64[:n], gt_v[:n])
    rmse_all = fleet_rmse(x, gt_v)
    failed = [what for what, ok in (
        ("float64 estimate finite", bool(torch.isfinite(x64).all())),
        ("RMSE vs ground truth", rmse < gate and r64_all < gate),
        ("f32-vs-f64 velocity-RMSE delta", abs(rmse - r64) < 1e-3)) if not ok]
    dv = (x[..., 3:6].double() - x64[..., 3:6]).abs().reshape(T_MAIN // 100, -1)
    drift = [float(d.max()) if bool(torch.isfinite(d).all()) else None for d in dv]
    del dv, x, x64

    # float64, element-wise, on the float64 run's own tick inputs
    c64, ks64, d, v, i = calls64[0]["args"]
    T = T_BOX_PLAIN - 1
    d64, v64, i64 = (estimator.TickData(*(a[:T].contiguous() for a in d)),
                     estimator.VOData(*(a[:T] for a in v)), i[:T].contiguous())
    del calls64, d, v, i
    (x_p, _), plain_ms = wall_ms(
        lambda: mrk.replay_ticks_plain(c64._replace(use_pallas=False), ks64, d64, v64, i64))
    x_k, _ = mrk.replay_ticks(c64, ks64, d64, v64, i64, device=DEV, mk_solve="chol")
    ok, err = close(x_k, x_p, **TOL_MHE)
    failed += [] if ok else ["mhe_tick_chol against its plain version at full width"]

    # K2d and K2 on the float32 run's inputs, in turns
    c32, ks32, d32, v32, i32 = calls[0]["args"]
    ab = {"mhe_tick_chol": [min(counted_ms)], "mhe_tick": [] if k2_ms is None else [k2_ms]}
    if not lanes:
        mrk.timer.on = True
        for _ in range(2):
            for tail, key in (("chol", "mhe_tick_chol"), ("gj", "mhe_tick")):
                mrk.replay_ticks(c32, ks32, d32, v32, i32, device=DEV, mk_solve=tail)
                ab[key] += mrk.timer.ms()
        mrk.timer.on = False
    sched = _work.mhe_schedule(v32.active.tolist(), v32.tick_pre.tolist(),
                               v32.tick_now.tolist(), N_WIN, int(ks32.bez_count))
    n_stance = int((d32.contact > 0).sum())
    work = _work.mhe_tick(N_WIN, s, p.dim_meas, p.num_legs, B_MAIN, sched, n_stance, 4,
                          lot=p.leg_odom_type, tail="chol")
    work_gj = _work.mhe_tick(N_WIN, s, p.dim_meas, p.num_legs, B_MAIN, sched, n_stance, 4,
                             lot=p.leg_odom_type)
    del calls
    ptxas = {"mhe_tick_chol": tick_ptxas(f"mhe_{tag}_chol", "mhe_chol_kernel"),
             "mhe_tick": tick_ptxas(f"mhe_{tag}", "mhe_kernel")}
    ms = min(ab["mhe_tick_chol"])
    emit("chol_path", model=model, config=f"{model} N={N_WIN} s={s} m={p.dim_meas} "
         f"L={p.num_legs} leg_odom_type={p.leg_odom_type}, DEM_MK_SOLVE=chol, "
         + ("lanes runner" if lanes else "pipeline runner"),
         group_launch_f32=tick_group_figures(p, False, "chol")["float"],
         T=T_MAIN, B=B_MAIN, dtype="float32", launches=counts, wall_s=wall / 1e3,
         pipeline_ticks_per_s=B_MAIN * (T_MAIN - 1) / (wall / 1e3),
         rmse_vs_ground_truth=rmse, rmse_f64=r64, rmse_f64_all_ticks=r64_all, rmse_gate=gate,
         f32_gated_ticks=n, f32_first_nonfinite_tick=t_bad, rmse_f32_all_ticks=rmse_all,
         f32_vs_f64_velocity_max_abs_per_100_ticks=drift,
         max_abs_err_f64={"T": T_BOX_PLAIN, "x": err}, plain_f64_ms=plain_ms,
         kernel_only_ms_in_turns=ab, bound_ms={"mhe_tick_chol": bound(work)["bound_ms"],
                                               "mhe_tick": bound(work_gj)["bound_ms"]},
         ptxas_registers_frame_spill_stores_loads=ptxas, failed=failed)
    assert not failed, (model, failed)
    return kernel_rows({f"mhe_tick_chol[{tag}]": (
        "decentralized_ekf_mhe_tpu_torch/csrc/mhe_body.cuh",
        "decentralized_ekf_mhe_tpu/pallas/mhe_replay_kernel.py:917 (mk_solve='chol')")},
        {f"mhe_tick_chol[{tag}]": work}, {f"mhe_tick_chol[{tag}]": counts["mhe_tick_chol"]},
        {f"mhe_tick_chol[{tag}]": err}, {f"mhe_tick_chol[{tag}]": ms},
        {f"mhe_tick_chol[{tag}]": plain_ms},
        **{f"mhe_tick_chol[{tag}]": {
            "model": model, "ms_how": "the kernel alone (CUDA events), best of the runs in turns"
            if not lanes else "the kernel alone (CUDA events), the counted run",
            "max_abs_err_shape": {"T": T_BOX_PLAIN, "B": B_MAIN},
            "plain_ms_shape": {"T": T_BOX_PLAIN, "B": B_MAIN, "N": N_WIN},
            "plain_ms_dtype": "float64", "gauss_jordan_kernel_only_ms": ab["mhe_tick"],
            "ptxas": ptxas, "path": "DEM_MK_SOLVE=chol, " + (
                "make_lanes_fleet_runner" if lanes else "make_pipeline_fleet_runner")}})


# ----------------------- per-lane camera clocks at the Cassie and PogoX shapes


def f6_witness(call, x, x64, cam):
    """The float32 plain version of a counted run's per-lane-clock tick
    (``call``, recorded by ``tick_calls``) on the card over ticks F6_WITNESS,
    from the kernel's state at the tick before (the kernel reruns the ticks up
    to it): per 100 ticks over the lanes with a camera (``cam``), the largest
    |v| of plain and kernel (``x``, the counted run), their largest velocity
    difference from each other and, where the float64 run ``x64`` reaches,
    from float64 (None where a block is not finite). A plain version that
    departs from float64 and leaves the box in the ticks where the kernel does
    shows fault F6, not a float32 fault of the kernel alone."""
    c, ks0, d, v, i = call["args"]
    a, b = F6_WITNESS
    cut = lambda sl: (estimator.TickData(*(t[sl] for t in d)),
                      estimator.VOData(*(t[sl] for t in v)), i[sl])
    # tick call j gives x[j + 1]
    _, ks = mrk.replay_ticks(c, ks0, *cut(slice(0, a - 1)), device=DEV)
    (xp, _), plain_ms = wall_ms(lambda: mrk.replay_ticks_plain(
        c._replace(use_pallas=False), ks, *cut(slice(a - 1, b - 1))))
    vp = torch.movedim(xp, -1, 1)[:, cam, 3:6].double()
    vk = x[a:b, cam, 3:6].double()
    per_100 = lambda t: [float(m) if math.isfinite(m) else None for m in
                         t.reshape(t.shape[0] // 100, -1).amax(-1).tolist()]
    out = {"ticks": [a, b], "plain_f32_ms": plain_ms,
           "max_abs_v_plain_per_100_ticks": per_100(vp.abs()),
           "max_abs_v_kernel_per_100_ticks": per_100(vk.abs()),
           "plain_vs_kernel_velocity_max_abs_per_100_ticks": per_100((vp - vk).abs())}
    if x64.shape[0] >= b:
        v64 = x64[a:b, cam, 3:6]
        out["plain_vs_f64_velocity_max_abs_per_100_ticks"] = per_100((vp - v64).abs())
        out["kernel_vs_f64_velocity_max_abs_per_100_ticks"] = per_100((vk - v64).abs())
    return out


def pi_cell(model, box, clocks64, clocks32, gt_v):
    """Cells (l)-(o): ``model``'s fleet with a camera clock per lane (15
    clocks, every 64th lane VO-free) through the lanes runner at full width,
    unconstrained (K2b) or with the |v| <= 0.3 box (K2c on per-lane clocks).
    The counted float32 run is the timed one (wall, the tick around its
    wrapper and alone; the bound from the schedules it walked and, with the
    box, the ADMM iterations it ran); a float64 run of the same path, over
    the whole log unconstrained and T_BOX_F64 ticks with the box: RMSE against
    ground truth and float32 against float64 over the lanes with a camera
    (F5), the difference per 100 ticks, the box; for a fleet of fault F6
    the float32 plain tick over ticks F6_WITNESS (``f6_witness``); then the
    tick against its plain version in float64 over T_BOX_PLAIN ticks at full
    width (with the box the y limit and witness of its shared-clock or Go1
    twin). Returns the
    kernel's entry of the last-but-one line."""
    p = box_params(model=model) if box else robot_params(model)[0]
    s, m, L, lot = p.dim_state, p.dim_meas, p.num_legs, p.leg_odom_type
    tag = {"cassie_bench": "cassie"}.get(model, model)
    name = ("mhe_tick_pi_box" if box else "mhe_tick_pi") + f"[{tag}]"
    gate = RMSE_GATE[model]
    consts = lambda dt: (box_consts(p, dt, V_BOX, 20) if box else
                         mhe.make_consts(p, dt, use_pallas=True, device=DEV))
    data_b, _, vo = clocks32
    run = batch.make_lanes_fleet_runner(p, F32, use_megakernel=True, consts=consts(F32), device=DEV)
    reset_counts()
    mrk.timer.on = True
    with tick_calls() as calls:
        (x, _), wall = wall_ms(lambda: run(data_b, vo))
    mrk.timer.on = False
    k_only = min(mrk.timer.ms())
    counts = read_counts()
    want = (dict(NO_LAUNCH, mhe_tick_pi_box=1, admm_solve=1, admm_box_solve=2) if box
            else dict(NO_LAUNCH, tridiag_solve=1, mhe_tick_pi=1))
    assert counts == want, (model, counts)
    assert x.shape == (T_MAIN, B_MAIN, s)
    cam = vo.active.any(0)
    n, t_bad = f32_ticks(model, x, cam)
    free_bad = first_nonfinite(x[:, ~cam])
    rmse, rmse_all = fleet_rmse(x[:n], gt_v[:n], cam), fleet_rmse(x, gt_v, cam)
    t64 = T_BOX_F64 if box else T_MAIN
    run64 = batch.make_lanes_fleet_runner(p, F64, use_megakernel=True, consts=consts(F64),
                                          device=DEV)
    d64, _, v64 = head(clocks64, t64)
    x64 = run64(d64, v64)[0]
    r64_all = fleet_rmse(x64, gt_v[:t64])
    td = min(n, t64)
    r32, r64 = fleet_rmse(x[:td], gt_v[:td], cam), fleet_rmse(x64[:td], gt_v[:td], cam)
    failed = [what for what, ok in (
        ("float64 estimate finite", bool(torch.isfinite(x64).all())),
        ("RMSE vs ground truth", rmse < gate and r64_all < gate),
        ("f32-vs-f64 velocity-RMSE delta", abs(r32 - r64) < 1e-3)) if not ok]
    dv = (x[:t64, cam, 3:6].double() - x64[:, cam, 3:6]).abs()
    drift = [float(d.max()) if bool(torch.isfinite(d).all()) else None
             for d in dv.reshape(t64 // 100, -1)]
    extra = {}
    if box:
        vmax = float(x[:n, cam, 3:6].abs().max())
        vmax64 = float(x64[..., 3:6].abs().max())
        failed += [what for what, ok in (
            ("velocity box, float32", V_BOX - 1e-2 <= vmax <= V_BOX + 1e-3),
            ("velocity box, float64", V_BOX - 1e-2 <= vmax64 <= V_BOX + 1e-3)) if not ok]
        extra = {"max_abs_v": {"T": n, "f32": vmax}, "max_abs_v_f64": {"T": t64, "f64": vmax64},
                 "max_abs_v_f32_per_100_ticks":
                     x[:, cam, 3:6].abs().reshape(T_MAIN // 100, -1).amax(-1).tolist()}
    if model in F6_TICKS:
        extra["f6_witness"] = f6_witness(calls[0], x, x64, cam)
    del dv, x, x64
    call = calls[0]
    ms, (_, ks0, d, v, _) = call_ms(call), call["args"]
    iters = call["out"][1].iters if box else None
    groups = _work.mhe_lane_schedules(v.active.cpu().numpy(), v.tick_pre.cpu().numpy(),
                                      v.tick_now.cpu().numpy(), N_WIN,
                                      ks0.bez_count[0].cpu().numpy())
    work = _work.mhe_tick_lanes(
        N_WIN, s, m, L, groups, int((d.contact > 0).sum()), 4, lot=lot,
        box=(iters.cpu().numpy(),) + admm_work_settings(call["args"][0]) if box else None)
    del calls, call, d, v

    # float64 element-wise at full width over T_BOX_PLAIN ticks
    c64 = consts(F64)
    ks, (d, vv, i) = clock_inputs(c64, clocks64, F64, T=T_BOX_PLAIN)
    plain, plain_ms = wall_ms(lambda: mrk.replay_ticks_plain(c64._replace(use_pallas=False),
                                                            ks, d, vv, i))
    if box:
        _, _, _, errs = check_box_tick(c64, c64._replace(use_pallas=False), ks, d, vv, i,
                                       f"{model} per-lane clocks, full width",
                                       fma=model not in Y_ROUNDING_ROBOTS,
                                       rounding=model in Y_ROUNDING_ROBOTS, plain=plain)
        err = max(errs[f] for f in "xzy")
    else:
        x_k, ks_k = mrk.replay_ticks(c64, ks, d, vv, i, device=DEV)
        ok, err = close(x_k, plain[0], **TOL_MHE)
        failed += [] if ok else ["per-lane-clock mhe_tick against its plain version at full width"]
        check_schedule(ks_k, plain[1], f"{model} per-lane clocks, full width")
        errs = {"x": err}
    emit(f"{tag}_pi_box" if box else f"{tag}_pi",
         config=f"{model} N={N_WIN} s={s} m={m} L={L} leg_odom_type={lot}, 15 camera clocks, "
         "every 64th lane VO-free" + (", |v|<=0.3, rho=5000 fixed, 20 it + polish" if box else ""),
         T=T_MAIN, B=B_MAIN, dtype="float32", launches=counts, wall_s=wall / 1e3,
         wall_from="the counted run", pipeline_ticks_per_s=B_MAIN * (T_MAIN - 1) / (wall / 1e3),
         tick_ms=ms, tick_kernel_only_ms=k_only, rmse_vs_ground_truth=rmse, rmse_gate=gate,
         rmse_lanes=int(cam.sum()), f32_gated_ticks=n, f32_first_nonfinite_tick=t_bad,
         rmse_f32_all_ticks=rmse_all, vo_free_lanes_first_nonfinite_tick=free_bad,
         f64_twin={"T": t64, "rmse_f32": r32, "rmse_f64": r64, "ticks_compared": td,
                   "rmse_f64_all_lanes": r64_all},
         f32_vs_f64_velocity_max_abs_per_100_ticks=drift, **extra,
         max_abs_err_f64={"T": T_BOX_PLAIN, **errs}, plain_f64_ms=plain_ms,
         admm_iters_mean=None if iters is None else float(iters.double().mean()),
         distinct_lane_schedules=len(groups), failed=failed)
    assert not failed, (model, failed)
    return kernel_rows({name: (
        "decentralized_ekf_mhe_tpu_torch/csrc/mhe_body.cuh",
        "decentralized_ekf_mhe_tpu/pallas/mhe_replay_kernel.py:917 (per_instance=True"
        + (", admm_ks set)" if box else ")"))},
        {name: work}, {name: counts["mhe_tick_pi_box" if box else "mhe_tick_pi"]}, {name: err},
        {name: ms}, {name: plain_ms},
        **{name: {"model": model, "kernel_only_ms": k_only,
                  "ms_how": "the counted run, around the wrapper",
                  "max_abs_err_shape": {"T": T_BOX_PLAIN, "B": B_MAIN},
                  "max_abs_err_by_output": errs,
                  "plain_ms_shape": {"T": T_BOX_PLAIN, "B": B_MAIN, "N": N_WIN},
                  "plain_ms_dtype": "float64",
                  "path": "make_lanes_fleet_runner, per-instance VOData"
                          + (", box consts" if box else "")}})


def pi_chol_cell(model, clocks64, clocks32, gt_v, k2b_ms=None):
    """Cell (r): DEM_MK_SOLVE=chol on ``model``'s 15-clock fleet (cells (c),
    (n), (l)) through the lanes runner at full width — K5 at tick 0, then
    K2d-PI. The counted float32 run is the timed one (wall, the tick alone);
    a float64 run of the same path over the whole log: RMSE against ground
    truth and float32 against float64 over the lanes with a camera (F5; on
    Cassie's shape the float32 gates over F6_TICKS ticks, ``f32_ticks``), the
    difference per 100 ticks; K2d-PI against its plain version in float64
    over T_BOX_PLAIN ticks at full width; K2d-PI and K2b alone on the counted
    run's inputs in turns (two each; Cassie: the counted run against
    ``k2b_ms``, the K2b tick of ``pi_cell``'s counted run on the same fleet),
    with both kernels' ptxas figures. Returns the kernel's entry of the
    last-but-one line."""
    p = robot_params(model)[0]
    s, m, L, lot = p.dim_state, p.dim_meas, p.num_legs, p.leg_odom_type
    tag = {"cassie_bench": "cassie"}.get(model, model)
    name = f"mhe_tick_pi_chol[{tag}]"
    gate = RMSE_GATE[model]
    data_b, _, vo = clocks32
    with mk_solve_env("chol"):
        run = batch.make_lanes_fleet_runner(p, F32, use_megakernel=True, device=DEV)
        reset_counts()
        mrk.timer.on = True
        with tick_calls() as calls:
            (x, _), wall = wall_ms(lambda: run(data_b, vo))
        mrk.timer.on = False
        k_only = min(mrk.timer.ms())
        counts = read_counts()
        assert counts == dict(NO_LAUNCH, tridiag_solve=1, mhe_tick_pi_chol=1), (model, counts)
        run64 = batch.make_lanes_fleet_runner(p, F64, use_megakernel=True, device=DEV)
        x64 = run64(clocks64[0], clocks64[2])[0]
    assert x.shape == (T_MAIN, B_MAIN, s)
    cam = vo.active.any(0)
    n, t_bad = f32_ticks(model, x, cam)
    free_bad = first_nonfinite(x[:, ~cam])
    rmse, rmse_all = fleet_rmse(x[:n], gt_v[:n], cam), fleet_rmse(x, gt_v, cam)
    r64_all = fleet_rmse(x64, gt_v)
    r64 = fleet_rmse(x64[:n], gt_v[:n], cam)
    failed = [what for what, ok in (
        ("float64 estimate finite", bool(torch.isfinite(x64).all())),
        ("RMSE vs ground truth", rmse < gate and r64_all < gate),
        ("f32-vs-f64 velocity-RMSE delta", abs(rmse - r64) < 1e-3)) if not ok]
    dv = (x[:, cam, 3:6].double() - x64[:, cam, 3:6]).abs()
    drift = [float(d.max()) if bool(torch.isfinite(d).all()) else None
             for d in dv.reshape(T_MAIN // 100, -1)]
    del dv, x, x64

    # float64 element-wise at full width over T_BOX_PLAIN ticks
    c64 = mhe.make_consts(p, F64, device=DEV)
    ks, (d, vv, i) = clock_inputs(c64, clocks64, F64, T=T_BOX_PLAIN)
    (x_p, ks_p), plain_ms = wall_ms(lambda: mrk.replay_ticks_plain(
        c64._replace(use_pallas=False), ks, d, vv, i))
    x_k, ks_k = mrk.replay_ticks(c64, ks, d, vv, i, device=DEV, mk_solve="chol")
    ok, err = close(x_k, x_p, **TOL_MHE)
    failed += [] if ok else ["mhe_tick_pi_chol against its plain version at full width"]
    check_schedule(ks_k, ks_p, f"{model} Cholesky tail, per-lane clocks, full width")
    del x_p, x_k, d, vv, i

    # K2d-PI and K2b alone on the counted run's inputs, in turns
    call = calls[0]
    c32, ks32, d32, v32, i32 = call["args"]
    ab = {"mhe_tick_pi_chol": [k_only], "mhe_tick_pi": [] if k2b_ms is None else [k2b_ms]}
    if k2b_ms is None:
        mrk.timer.on = True
        for _ in range(2):
            for tail, key in (("chol", "mhe_tick_pi_chol"), ("gj", "mhe_tick_pi")):
                mrk.replay_ticks(c32, ks32, d32, v32, i32, device=DEV, mk_solve=tail)
                ab[key] += mrk.timer.ms()
        mrk.timer.on = False
    groups = _work.mhe_lane_schedules(v32.active.cpu().numpy(), v32.tick_pre.cpu().numpy(),
                                      v32.tick_now.cpu().numpy(), N_WIN,
                                      ks32.bez_count[0].cpu().numpy())
    n_stance = int((d32.contact > 0).sum())
    work = _work.mhe_tick_lanes(N_WIN, s, m, L, groups, n_stance, 4, lot=lot, tail="chol")
    work_gj = _work.mhe_tick_lanes(N_WIN, s, m, L, groups, n_stance, 4, lot=lot)
    del calls, call, c32, ks32, d32, v32, i32
    ptxas = {"mhe_tick_pi_chol": tick_ptxas(f"mhe_{tag}_chol", "mhe_pi_chol_kernel"),
             "mhe_tick_pi": tick_ptxas(f"mhe_{tag}_pi", "mhe_pi_kernel")}
    ms = min(ab["mhe_tick_pi_chol"])
    emit(f"{tag}_pi_chol",
         config=f"{model} N={N_WIN} s={s} m={m} L={L} leg_odom_type={lot}, 15 camera clocks, "
         "every 64th lane VO-free, DEM_MK_SOLVE=chol, lanes runner",
         group_launch_f32=tick_group_figures(p, True, "chol")["float"],
         T=T_MAIN, B=B_MAIN, dtype="float32", launches=counts, wall_s=wall / 1e3,
         wall_from="the counted run", pipeline_ticks_per_s=B_MAIN * (T_MAIN - 1) / (wall / 1e3),
         tick_kernel_only_ms=k_only, rmse_vs_ground_truth=rmse, rmse_gate=gate,
         rmse_lanes=int(cam.sum()), rmse_f64=r64, rmse_f64_all_lanes_all_ticks=r64_all,
         f32_gated_ticks=n, f32_first_nonfinite_tick=t_bad, rmse_f32_all_ticks=rmse_all,
         vo_free_lanes_first_nonfinite_tick=free_bad,
         f32_vs_f64_velocity_max_abs_per_100_ticks=drift,
         max_abs_err_f64={"T": T_BOX_PLAIN, "x": err}, plain_f64_ms=plain_ms,
         kernel_only_ms_in_turns=ab, bound_ms={"mhe_tick_pi_chol": bound(work)["bound_ms"],
                                               "mhe_tick_pi": bound(work_gj)["bound_ms"]},
         ptxas_registers_frame_spill_stores_loads=ptxas, distinct_lane_schedules=len(groups),
         failed=failed)
    assert not failed, (model, failed)
    return kernel_rows({name: (
        "decentralized_ekf_mhe_tpu_torch/csrc/mhe_body.cuh",
        "decentralized_ekf_mhe_tpu/pallas/mhe_replay_kernel.py:917 "
        "(per_instance=True, mk_solve='chol')")},
        {name: work}, {name: counts["mhe_tick_pi_chol"]}, {name: err}, {name: ms},
        {name: plain_ms},
        **{name: {"model": model, "ms_how": "the kernel alone (CUDA events), best of the runs "
                  "in turns" if k2b_ms is None else
                  "the kernel alone (CUDA events), the counted run",
                  "max_abs_err_shape": {"T": T_BOX_PLAIN, "B": B_MAIN},
                  "plain_ms_shape": {"T": T_BOX_PLAIN, "B": B_MAIN, "N": N_WIN},
                  "plain_ms_dtype": "float64", "gauss_jordan_kernel_only_ms": ab["mhe_tick_pi"],
                  "ptxas": ptxas,
                  "path": "DEM_MK_SOLVE=chol, make_lanes_fleet_runner, per-instance VOData"}})


# ------------------------------------------------- the stage ablation (K2e)


# the tensors of KernelState.arrays, in mrk.state_shapes' order
STATE_NAMES = ("y_meas", "Q_meas", "A_dyn", "b_dyn", "Q_dyn", "b_cam", "Q_cam", "cam_act",
               "M_p", "n_p", "bez_pts", "p_accum", "prev_R", "prev_accel_s", "prev_contact",
               "Dslot", "Ub", "routb")


def state_scales(arrays):
    """The scale each entry of a window state is held to, by name: its own
    magnitude, except in the symmetric weights and the cache D (Q_meas, Q_dyn,
    Q_cam, M_p, Dslot), where it is at least the diagonal scale
    sqrt(|W_ii W_jj|), and in the cache U = -AᵀQd, at least sqrt(|Dslot_ii|
    |Q_dyn_jj|) (both bound |W_ij| for a positive semi-definite matrix): an
    entry that is zero but for rounding next to a 4e10 weight keeps rounding
    of that weight's size."""
    w = dict(zip(STATE_NAMES, arrays))
    diag = lambda a: torch.diagonal(a, dim1=-3, dim2=-2).abs().movedim(-1, -2)   # (..., n, B)
    out = {n: a.abs() for n, a in w.items()}
    for n in ("Q_meas", "Q_dyn", "Q_cam", "M_p", "Dslot"):
        out[n] = torch.maximum(out[n], torch.sqrt(diag(w[n])[..., :, None, :]
                                                  * diag(w[n])[..., None, :, :]))
    out["Ub"] = torch.maximum(out["Ub"], torch.sqrt(diag(w["Dslot"])[..., :, None, :]
                                                    * diag(w["Q_dyn"])[..., None, :, :]))
    return out


def check_state(ks_k, ks_p, tag):
    """Every tensor of the window state the kernel leaves against the plain
    version's: the same non-finite positions, the finite entries within
    TOL_MHE of ``state_scales``; the Bezier schedule (``check_schedule``) and
    the tick counter. Returns per tensor the largest |dk - dp| / (atol + rtol
    scale) ("scaled") and the same on the entry's own magnitude ("own")."""
    assert ks_k.t == ks_p.t and len(ks_k.arrays) == len(STATE_NAMES), (tag, ks_k.t, ks_p.t)
    check_schedule(ks_k, ks_p, tag)
    scales = state_scales(ks_p.arrays)
    read = {}
    for n, a, b in zip(STATE_NAMES, ks_k.arrays, ks_p.arrays):
        fin = torch.isfinite(b)
        assert torch.equal(fin, torch.isfinite(a)) and torch.equal(torch.isnan(a),
                                                                   torch.isnan(b)), (tag, n)
        lim = lambda sc: TOL_MHE["atol"] + TOL_MHE["rtol"] * sc[fin]
        dif = (a - b).abs()[fin]
        read[n] = {"scaled": float((dif / lim(scales[n])).max()) if bool(fin.any()) else None,
                   "own": float((dif / lim(b.abs())).max()) if bool(fin.any()) else None,
                   "finite_share": float(fin.double().mean())}
        assert read[n]["scaled"] is None or read[n]["scaled"] <= 1.0, (tag, n, read[n])
    return read


# the compositions of the stage ablation: variant (mrk.ABLATE_VARIANTS) ->
# (per-lane clock, tail, box consts); the stage tables are ABL_TABLES'
# (float32, T_ABL_TABLE ticks of B_MAIN instances)
ABL_COMPOSITIONS = {"": (False, "gj", False), "pi": (True, "gj", False),
                    "chol": (False, "chol", False), "pi_chol": (True, "chol", False),
                    "box": (False, "gj", True), "pi_box": (True, "gj", True)}
ABL_TAGS = {"go1": "", "pogox": "pogox", "cassie": "cassie"}   # in the kernels line's names


def abl_row_name(model, variant, stage):
    """The kernels line's name of an ablated unit: mhe_tick_abl[<shape>
    <variant> <stage>], Go1's shape and the Gauss-Jordan shared-clock variant
    unnamed."""
    return "mhe_tick_abl[" + " ".join(w for w in (ABL_TAGS[model], variant, stage) if w) + "]"


def abl_consts(model, box, dtype):
    """``model``'s consts, unconstrained or with cell (b)'s box (|v| <= V_BOX,
    20 ADMM iterations)."""
    p = robot_params(model)[0]
    return (box_consts(box_params(model=model), dtype, V_BOX, 20) if box
            else mhe.make_consts(p, dtype, device=DEV))


def abl_ptxas(model):
    """The ptxas figures of every ablated unit of ``model``'s shape that this
    script builds: {(variant, stage): {"float": [...], "double": [...]}} from
    its libraries' reports (the kernels differ in their template
    arguments)."""
    out = {}
    pat = re.compile(r"(\d+)(mhe_(?:pi_|chol_|box_)?abl_kernel)I([fd])(?:Li\d+E){4}"
                     r"(?:Lb([01])E)?Li(\d)E")
    for lib in ABL_LIBRARIES[model]:
        for _, text, _ in _build.report[lib]["units"]:
            for kern, fig in ptxas_figures(text).items():
                m = pat.search(kern)
                if not m:
                    continue
                base, pi = m.group(2), m.group(4) == "1" or m.group(2) == "mhe_pi_abl_kernel"
                variant = "_".join(w for w, on in (("pi", pi), ("box", "box" in base),
                                                   ("chol", "chol" in base)) if on)
                stage = mrk.ABLATE_STAGES[int(m.group(5)) - 1]
                out.setdefault((variant, stage), {})[
                    {"f": "float", "d": "double"}[m.group(3)]] = fig
    return out


def check_ablation(model):
    """Every unit of the stage ablation (K2e) at ``model``'s shape — each
    composition of ABL_COMPOSITIONS (either clock, either tail, box consts)
    and each of its stages — against its plain version over T_ABL ticks of a
    B_ABL-instance fleet, float64: the shared clock on the EKF kernel's
    orientation, per-lane clocks on the 15-clock fleet (a VO-free lane
    among them). x with the same non-finite positions and its finite entries
    within TOL_MHE (the "solve" stage's within ATOL_SOLVE + RTOL_SOLVE of its
    terms, see T_ABL), the window state it leaves (``check_state``); with box
    consts also z, y (TOL_MHE, the same non-finite positions) and the
    iteration counts (equal on every tick and lane, a non-finite window
    included: fault F8, repaired). Each unit's launch is counted alone and timed
    (the kernel alone, CUDA events). The Cholesky tick's tail-free stages run
    the Gauss-Jordan units of their clock: their result must equal those bit
    for bit, with the launch counted there. The "solve" stage with box consts
    must raise ``ValueError``, on the card as on the CPU. Returns ({(variant,
    stage): readings}, {refusal: message})."""
    p = robot_params(model)[0]
    fleets = {False: ekf_oriented(model, make_fleet(T_ABL, B_ABL, F64, seed=1,
                                                    model=model)[1:], F64),
              True: tuple(make_clock_fleet(T_ABL, B_ABL, F64, seed=1, model=model)[1:])}
    consts = {box: abl_consts(model, box, F64) for box in (False, True)}
    inputs = {(pi, box): clock_inputs(consts[box], fleets[pi], F64)
              for pi in (False, True) for box in (False, True)}
    res, refused, gj = {}, {}, {}
    for variant, (pi, tail, box) in ABL_COMPOSITIONS.items():
        c = consts[box]
        ks0, (d, v, i) = inputs[pi, box]
        assert int(v.active.sum()) > 0 and T_ABL > N_WIN
        for stage in mrk.ABLATE_STAGES:
            if box and stage == "solve":
                continue
            unit = mrk.ablate_variant(box, pi, tail, stage)
            reset_counts()
            mrk.timer.on = True
            x_k, ks_k = mrk.replay_ticks(c, ks0, d, v, i, device=DEV, mk_solve=tail,
                                         ablate=stage)
            mrk.timer.on = False
            (ms,) = mrk.timer.ms()
            want = dict(NO_LAUNCH, mhe_tick_abl=1,
                        admm_box_solve=int(box and stage != "assembly"))
            assert read_counts() == want and mrk.launches_abl[unit][stage] == 1, (
                model, variant, stage, read_counts())
            if unit != variant:     # a tail-free stage of the Cholesky tick
                xg, ksg = gj[unit, stage]
                assert torch.equal(x_k.isnan(), xg.isnan()) and torch.equal(
                    x_k.nan_to_num(), xg.nan_to_num()) and all(
                    torch.equal(a.nan_to_num(), b.nan_to_num())
                    for a, b in zip(ks_k.arrays, ksg.arrays)), (model, variant, stage)
                res[unit, stage]["same_unit_as"] = res[unit, stage].get(
                    "same_unit_as", []) + [variant]
                continue
            (x_p, ks_p), plain_ms = wall_ms(
                lambda: mrk.replay_ticks_plain(c._replace(use_pallas=False), ks0, d, v, i,
                                               ablate=stage, mk_solve=tail))
            if tail == "gj":
                gj[variant, stage] = (x_k, ks_k)
            same_nan = torch.equal(torch.isnan(x_k), torch.isnan(x_p))
            same_inf = torch.equal(torch.isinf(x_k), torch.isinf(x_p))
            fin = torch.isfinite(x_p)
            diff = (x_k - x_p)[fin].abs()
            over = lambda sc, tol=TOL_MHE: float((diff / (tol["atol"] + tol["rtol"]
                                                          * sc[fin])).max())
            tag = ("ablated mhe_tick", model, variant, stage)
            r = {"max_abs_err": float(diff.max()) if bool(fin.any()) else None,
                 "same_nonfinite": same_nan and same_inf,
                 "finite_share": float(fin.double().mean()),
                 "x_over_tol": over(x_p.abs()) if bool(fin.any()) else None,
                 "state_over_tol": check_state(ks_k._replace(arrays=ks_k.arrays[:18]),
                                               ks_p._replace(arrays=ks_p.arrays[:18]), tag),
                 "kernel_ms_f64": ms, "plain_ms_f64": plain_ms,
                 "work_f64": roofline.tick_work(c, ks0, d, v, 8, stage, tail, ks_k.iters)}
            ok = same_nan and same_inf
            if stage == "solve":
                sc = mrk.solve_stage_scales(c, ks0, d, v, i)
                tol = dict(rtol=RTOL_SOLVE, atol=ATOL_SOLVE)
                r.update(
                    x_over_tol_of_terms=over(sc["terms"], tol),
                    x_over_tol_of_system=over(sc["system"], tol),
                    zeros_over_tol_of_terms=float((x_p.abs() / (ATOL_SOLVE + RTOL_SOLVE
                                                                * sc["terms"])).max()),
                    without_r_over_tol_of_terms=float((sc["r_sum"].abs() / (
                        ATOL_SOLVE + RTOL_SOLVE * sc["terms"])).max()),
                    max_err_over_terms=float((diff / sc["terms"][fin]).max()))
                ok = ok and r["x_over_tol_of_terms"] <= 1.0
            elif bool(fin.any()):
                ok = ok and r["x_over_tol"] <= 1.0
            if box:
                for f, a, b in (("z", ks_k.arrays[18], ks_p.arrays[18]),
                                ("y", ks_k.arrays[19], ks_p.arrays[19])):
                    fb = torch.isfinite(b)
                    ok = ok and torch.equal(fb, torch.isfinite(a)) and torch.equal(
                        a.isnan(), b.isnan())
                    r[f"{f}_over_tol"] = (float(over_tol(a[fb], b[fb]).max())
                                          if bool(fb.any()) else None)
                    ok = ok and (r[f"{f}_over_tol"] or 0.0) <= 1.0
                # the counts on every tick and lane, a window the "build"
                # stage has left non-finite included: the kernel's maxima keep
                # a NaN residual as the plain version's do (fault F8,
                # repaired), so neither stops there
                fin_tb = torch.isfinite(x_p).all(1)
                r["iters_equal"] = bool(torch.equal(ks_k.iters, ks_p.iters))
                r["iters_share_where_x_not_finite"] = float((~fin_tb).double().mean())
                r["iters_mean"] = float(ks_k.iters.double().mean())
                ok = ok and r["iters_equal"] and (stage != "assembly" or not bool(
                    ks_k.iters.any()))
            assert ok, (tag, r)
            res[variant, stage] = r
    ks0, (d, v, i) = inputs[False, True]
    try:
        mrk.replay_ticks(consts[True], ks0, d, v, i, device=DEV, ablate="solve")
        refused["solve with box consts"] = None
    except ValueError as e:
        refused["solve with box consts"] = str(e)
    assert refused["solve with box consts"], "the box solve stage must be refused"
    return res, refused


def ablation_phase(model, fleet32):
    """Cell (s), the stage ablation of the tick at ``model``'s shape:
    ``check_ablation`` (every unit, float64), then the stage tables of
    ``roofline.ablation`` on the first T_ABL_TABLE ticks of its headline
    float32 fleet ``fleet32`` ((a), (i), (k)) for the variants of
    ABL_TABLES[model] (the tick and its units, each alone, best of 3), whose
    launches are counted. A unit with a table takes its ms, launches and bound
    from there; the others from their float64 check (the kernel alone, one
    launch, at T_ABL, B_ABL). Returns the units' entries of the
    last-but-one line."""
    res, refused = check_ablation(model)
    p = robot_params(model)[0]
    table_model = "cassie_bench" if model == "cassie" else model   # (k)'s shape
    fleet = (robot_params(table_model)[0], *head(fleet32, T_ABL_TABLE))
    tables, table_counts = {}, {}
    for variant in ABL_TABLES[model]:
        pi, tail, box = ABL_COMPOSITIONS[variant]
        reset_counts()
        tables[variant] = roofline.ablation(
            device=DEV, fleet=fleet, mk_solve=tail,
            consts=abl_consts(table_model, True, F32) if box else None)
        counts = read_counts()
        stages = tables[variant]["stages"]
        full = {"": "mhe_tick", "chol": "mhe_tick_chol", "box": "mhe_tick_box"}[variant]
        assert counts == dict(NO_LAUNCH, **{full: 4, "mhe_tick_abl": 4 * len(stages)},
                              admm_box_solve=4 * len(stages) if box else 0), (
            model, variant, counts)
        # each stage's unit: the Cholesky tick's tail-free stages are the
        # Gauss-Jordan units
        table_counts[variant] = {st: mrk.launches_abl[mrk.ablate_variant(box, pi, tail, st)][st]
                                 for st in stages}
        assert all(n == 4 for n in table_counts[variant].values()), (model, variant,
                                                                      table_counts)
        t = tables[variant]
        print(f"stage table, {model} {variant or 'gj'} (full - ablated over full; float32, "
              f"T={t['T']}, B={t['B']}): full {t['full']['ms']:.3f} ms; " + "; ".join(
                  f"{stage} {row['ms']:.3f} ms, {100 * row['share']:.1f} %"
                  for stage, row in t["stages"].items()), flush=True)
    ptxas = abl_ptxas(model)
    emit("ablation", model=model,
         config=f"{model} N={N_WIN} s={p.dim_state} m={p.dim_meas} L={p.num_legs}, the tick "
         f"with one stage skipped, every composition (clock, tail, box consts), "
         "roofline.ablation on the headline fleet",
         check={"T": T_ABL, "B": B_ABL, "dtype": "float64", "tol": TOL_MHE,
                "tol_solve_of_terms": dict(rtol=RTOL_SOLVE, atol=ATOL_SOLVE),
                "errors": {f"{v or 'gj'} {st}": r for (v, st), r in res.items()}},
         refused=refused, tables=tables, table_launches=table_counts,
         ptxas_registers_frame_spill_stores_loads={f"{v or 'gj'} {st}": f
                                                   for (v, st), f in ptxas.items()})
    rows = []
    for (variant, stage), r in res.items():
        name = abl_row_name(model, variant, stage)
        row = tables.get(variant, {}).get("stages", {}).get(stage)
        if row is not None:
            ms, work, n = row["ms"], (row["bytes"], row["operations"]), table_counts[variant][stage]
            how = {"shape": {"T": tables[variant]["T"], "B": tables[variant]["B"], "N": N_WIN},
                   "ms_how": "roofline.ablation: the kernel alone (CUDA events), best of 3",
                   "share_of_the_tick": row["share"],
                   "full_tick_ms": tables[variant]["full"]["ms"]}
        else:
            ms, work, n = r["kernel_ms_f64"], r["work_f64"], 1
            how = {"shape": {"T": T_ABL - 1, "B": B_ABL, "N": N_WIN}, "ms_dtype": "float64",
                   "ms_how": "its float64 check's launch: the kernel alone (CUDA events)"}
        rows += kernel_rows({name: (
            "decentralized_ekf_mhe_tpu_torch/csrc/mhe_body.cuh",
            f"decentralized_ekf_mhe_tpu/pallas/mhe_replay_kernel.py:917 (ablate='{stage}'"
            + (", per_instance=True" if "pi" in variant else "")
            + (", mk_solve='chol'" if "chol" in variant else "")
            + (", admm_ks set" if "box" in variant else "") + ")")},
            {name: work}, {name: n}, {name: r["max_abs_err"]}, {name: ms},
            {name: r["plain_ms_f64"]},
            **{name: {"model": model, "variant": variant or "gj",
                      "threads_per_instance": mrk.group_size(p.dim_state), **how,
                      "max_abs_err_shape": {"T": T_ABL, "B": B_ABL},
                      "max_abs_err_detail": dict(
                          {k: v for k, v in r.items() if k not in ("state_over_tol", "work_f64")},
                          state_over_tol_max=max((t["scaled"] or 0.0)
                                                 for t in r["state_over_tol"].values())),
                      "plain_ms_shape": {"T": T_ABL - 1, "B": B_ABL, "N": N_WIN},
                      "plain_ms_dtype": "float64",
                      "ptxas": ptxas.get((variant, stage)),
                      "path": "tools.roofline.ablation (mhe_replay_kernel.replay_ticks, "
                              "ablate=)" if row is not None else
                              "mhe_replay_kernel.replay_ticks(ablate=) at the check's size"}})
    return rows


def legged_phases(model, builds, rows, abl_fleets):
    """Every phase of ``model``'s shape (PogoX, Cassie): its shared-clock
    fleet (g)-(j) against float64 and the plain versions, its Cholesky tail
    (Cassie's on the bench's route (k), run first), and its fleet on per-lane
    clocks (l)-(o) and, with the Cholesky tail, (r), each after waiting for
    its libraries. Returns the kernels' entries of the last-but-one line;
    ``rows`` are the entries so far. The first T_ABL_TABLE ticks of its
    headline float32 fleet ((i), (k)) go into ``abl_fleets[model]`` for its
    stage tables."""
    s = robot_params(model)[0].dim_state
    need(builds, f"mhe_{model}", *((f"tridiag_s{s}", f"admm_s{s}") if s != 9 else ()),
         *(((f"mhe_{model}", FMAD_OFF),) if model in Y_ROUNDING_ROBOTS else ()))
    check_kernels_legged(model)
    err_std = None
    if s != 9:      # K5's standard-layout route at this state size, small size
        data, _, vo = ekf_oriented(model, make_fleet(T_STD_CHK, B_CHK, F64, seed=1,
                                                     model=model)[1:], F64)
        err_std = check_kernels_std(model, data, vo._replace(
            dp_body=vo.dp_body.transpose(1, 2).contiguous()), B_CHK - 6)
    log, *f64 = make_fleet(T_MAIN, B_MAIN, F64, seed=0, model=model)
    gt = torch.as_tensor(log.gt_v_s, device=DEV)
    if model in F6_TICKS:
        # yaml Cassie's (g), like its (h), runs its first T_F6_BOX ticks: its
        # float32 gates cover F6_TICKS of them (fault F6)
        f64, gt = head(f64, T_F6_BOX), gt[:T_F6_BOX]
    f32 = tuple(cast(nt, F32) for nt in f64)
    counts, x64, q64, tick_ms = main_path(model, f64, f32, gt)
    del x64
    box_counts, _, _, box_tick = box_path(model, f64, f32, gt)
    kernels = legged_full_width(model, f64, f32, q64, counts, box_counts, tick_ms, box_tick)
    del q64, box_tick
    if model == "pogox":       # cell (s) at this shape, on its fleet (i)
        abl_fleets[model] = head(f32, T_ABL_TABLE)
    if err_std is not None:
        # K5's standard-layout route at this state size: held against its
        # plain version at the small size only; its row is the s=9 route's
        row = next(k for k in rows if k["name"] == "tridiag_solve_batched")
        row.setdefault("max_abs_err_other_sizes", {})[f"s={s}"] = {
            "max_abs_err": err_std, "model": model, "T": T_STD_CHK, "B": B_CHK}
    chol_model = model
    if model == "cassie":
        # Cassie's shape at the reference bench's settings through the
        # bench's route (k): float32 gated over the whole log, the
        # constrained tick timed on ticks that all do full work; the
        # Cholesky tail runs on the same route (p)
        log, *f64 = make_fleet(T_MAIN, B_MAIN, F64, seed=0, model="cassie_bench")
        f32 = tuple(cast(nt, F32) for nt in f64)
        gt = torch.as_tensor(log.gt_v_s, device=DEV)
        abl_fleets[model] = head(f32, T_ABL_TABLE)   # cell (s) at this shape, on (k)
        tick, k2_ms = bench_route("cassie_bench", f64, f32, gt)
        # the constrained Cassie tick's row: its time and bound from (k),
        # on which every tick does full work; the yaml fleet's (h) beside
        row = next(k for k in kernels if k["name"] == "mhe_tick_box[cassie]")
        keys = ("ms", "kernel_only_ms", "bound_ms", "bound_by", "bytes", "operations",
                "admm_iters_mean", "f32_first_nonfinite_tick")
        row["on_the_yaml_fleet"] = {k: row[k] for k in keys} | {"T": T_F6_BOX}
        row.update({k: tick[k] for k in keys}, fleet="cassie_bench",
                   ms_how="the counted run of bench_route's constrained lanes runner (k)")
        chol_model = "cassie_bench"
    else:
        k2_ms = None
    need(builds, f"mhe_{model}_chol")
    check_kernels_chol(model)
    kernels += chol_path(chol_model, f64, f32, gt, k2_ms=k2_ms)
    del f64, f32
    need(builds, *(b for b in (f"mhe_{model}_pi", (f"mhe_{model}_pi", FMAD_OFF)) if b in builds))
    check_kernels_pi(model)
    clock_model = "cassie_bench" if model == "cassie" else model
    log, *c64 = make_clock_fleet(T_MAIN, B_MAIN, F64, seed=0, model=clock_model)
    c32 = tuple(cast(nt, F32) for nt in c64)
    gt = torch.as_tensor(log.gt_v_s, device=DEV)
    for box in (False, True):
        kernels += pi_cell(clock_model, box, c64, c32, gt)
    # cell (r) on the same fleet; Cassie's ticks take seconds, so its K2b time
    # comes from pi_cell's counted run instead of runs in turns
    k2b = next(k for k in kernels if k["name"] == f"mhe_tick_pi[{model}]")["kernel_only_ms"]
    kernels += pi_chol_cell(clock_model, c64, c32, gt,
                            k2b_ms=k2b if model == "cassie" else None)
    return kernels


# --------------------- Go1 with its foot positions as states (s=21, a warp)


def max_err(errs):
    """The largest absolute error of a check's result dict (nested dicts
    included), leaving out what is no error: the readings that are ratios to
    a limit (``*_over_tol``), the limits themselves, an ``fma_witness`` or
    ``tails_witness`` reading, the iteration ranges and the shapes."""
    out = 0.0
    for k, v in errs.items():
        if (k.startswith("limit") or k in ("without_fma", "tails_witness")
                or k.endswith("_over_tol")):
            continue
        if isinstance(v, dict):
            out = max(out, max_err(v))
        elif isinstance(v, float):
            out = max(out, v)
    return out


def go1feet_phases(builds, rows):
    """Every phase of the go1feet shape (s=21, m=12, L=4, leg_odom_type=1: a
    warp of 32 threads per instance in every group kernel): the tick kernels
    on either clock with either tail, K5 on both routes and K4 against their
    plain versions at the small size (float64, split log, ragged B); the
    pipeline runner at full width (u) with its float64 twin; its constrained
    pipeline (v) over the first T_GO1FEET_BOX ticks with its float64 twin
    over T_BOX_F64; and the rows of the kernels line (``go1feet_rows``,
    ``go1feet_clock_rows``). ``rows`` are the entries so far (K5's standard
    route at s=21 joins the s=9 route's row, as s=15's does)."""
    model = "go1feet"
    s = robot_params(model)[0].dim_state
    need(builds, "mhe_go1feet", "tridiag_s21", "admm_s21")
    errs = {"legged": check_kernels_legged(model)}
    data, _, vo = ekf_oriented(model, make_fleet(T_STD_CHK, B_CHK, F64, seed=1,
                                                 model=model)[1:], F64)
    err_std = check_kernels_std(model, data, vo._replace(
        dp_body=vo.dp_body.transpose(1, 2).contiguous()), B_CHK - 6)
    del data, vo
    need(builds, "mhe_go1feet_chol")
    errs["chol"] = check_kernels_chol(model)
    need(builds, "mhe_go1feet_pi")
    errs["pi"] = check_kernels_pi(model)
    log, *f64 = make_fleet(T_MAIN, B_MAIN, F64, seed=0, model=model)
    gt = torch.as_tensor(log.gt_v_s, device=DEV)
    f32 = tuple(cast(nt, F32) for nt in f64)
    counts, x64, q64, tick_ms = main_path(model, f64, f32, gt)
    del x64
    box_counts, _, _, box_tick = box_path(model, f64, f32, gt)
    del f64
    kernels = go1feet_rows(f32, q64, counts, box_counts, tick_ms, box_tick, errs["legged"])
    del q64, box_tick
    kernels += go1feet_clock_rows(f32, gt, errs)
    row = next(k for k in rows if k["name"] == "tridiag_solve_batched")
    row.setdefault("max_abs_err_other_sizes", {})[f"s={s}"] = {
        "max_abs_err": err_std, "model": model, "T": T_STD_CHK, "B": B_CHK,
        "threads_per_instance": _group.group_size(s)}
    return kernels


def go1feet_rows(fleet32, q64, counts, box_counts, tick_ms, box_tick, errs):
    """The kernels line's rows of go1feet's K2, K2c, K5 (s=21), K4 (s=21)
    and K3 (s=21): ms from the main path's runs ((u): the tick alone, best of
    its timed runs; (v): the counted constrained run; K5, K4 and K3 timed on
    the float32 windows of (u) and (v)), launches from those runs, the bounds
    from this run's inputs, the plain versions' float32 ms over the first
    T_GO1FEET_PLAIN ticks at full width (the solves on the same windows), K5's
    library time (``torch.linalg.solve`` on the densified system), and
    max_abs_err from the small-size float64 checks (``errs``, those of
    ``check_kernels_legged``)."""
    model, tag = "go1feet", "[go1feet]"
    p, pb = robot_params(model)[0], box_params(model=model)
    s, m, L, lot = p.dim_state, p.dim_meas, p.num_legs, p.leg_odom_type
    R64 = ekf_lanes.to_rot(q64)
    inputs = lambda c, T: window_inputs(c, fleet32, R64, F32, T)
    names = {k: f"{k}{tag}" for k in ("mhe_tick", "mhe_tick_box")}
    names.update({k: f"{k}[s={s}]" for k in ("tridiag_solve", "admm_solve", "admm_box_solve")})
    ms, plain_ms, works, err, more = {}, {}, {}, {}, {}
    Tp = T_GO1FEET_PLAIN

    # K2 and K5: the unconstrained path (u)
    c32 = mhe.make_consts(p, F32, use_pallas=False, device=DEV)
    st32, ks32, (d32, v32, i32) = inputs(c32, T_MAIN)
    _, ksp, (dp_, vp, ip) = inputs(c32, Tp)
    _, plain_ms[names["mhe_tick"]] = wall_ms(lambda: mrk.replay_ticks_plain(c32, ksp, dp_, vp, ip))
    ms[names["mhe_tick"]] = tick_ms
    sched = _work.mhe_schedule(v32.active.tolist(), v32.tick_pre.tolist(), v32.tick_now.tolist(),
                               N_WIN, int(ks32.bez_count))
    works[names["mhe_tick"]] = _work.mhe_tick(N_WIN, s, m, L, B_MAIN, sched,
                                              int((d32.contact > 0).sum()), 4, lot=lot)
    err[names["mhe_tick"]] = max_err(errs["mhe_tick_err"])
    more[names["mhe_tick"]] = {"ms_how": "the kernel alone (CUDA events), best of the main "
                                         "path's timed runs (u)"}
    del d32, v32, i32, dp_, vp, ip
    tri32 = tuple(a.contiguous() for a in mhe_lanes._masked_system(c32, st32))
    k = names["tridiag_solve"]
    ms[k] = timed(lambda: tridiag_kernel.solve_lanes(*tri32, device=DEV))
    plain_ms[k] = timed(lambda: tridiag_kernel.solve_lanes_plain(*tri32))
    lib_ms, lib_diff = library_ms(*(torch.movedim(a, -1, 1) for a in tri32))
    works[k] = _work.tridiag(N_WIN, s, B_MAIN, 4, n_states=1)
    err[k] = max_err(errs["tridiag_err"])
    more[k] = {"library_ms": lib_ms, "library_minus_kernel_max_abs_f32": lib_diff,
               "library": "torch.linalg.solve on the densified (B, N*s, N*s) system",
               "ms_how": "tick 0's window of (u), float32, best of 3",
               "plain_ms_shape": {"B": B_MAIN, "N": N_WIN, "window": "tick 0"}}
    del tri32, st32, ks32, ksp

    # K2c, K4 and K3: the constrained path (v)
    cb32 = box_consts(pb, F32, V_BOX, 20)
    k = names["mhe_tick_box"]
    stb32, _, _ = inputs(cb32, 2)
    _, ksbp, (dbp, vbp, ibp) = inputs(cb32, Tp)
    _, plain_ms[k] = wall_ms(lambda: mrk.replay_ticks_plain(cb32._replace(use_pallas=False), ksbp,
                                                            dbp, vbp, ibp))
    ms[k], works[k] = box_tick["ms"], box_tick["work"]
    err[k] = max_err(errs["mhe_tick_box_err"])
    more[k] = {"shape": {"T": box_tick["T"], "B": B_MAIN, "N": N_WIN},
               "kernel_only_ms": box_tick["kernel_only_ms"], "ms_runs": 1,
               "ms_how": "the constrained main path's counted run (v), around the wrapper",
               "f32_first_nonfinite_tick": box_tick["t_bad"],
               "admm_iters_mean": float(box_tick["iters"].double().mean()),
               "y_over_tol": errs["mhe_tick_box_err"].get("y_over_tol")}
    st_end = mrk.mhe_state_from_kernel(box_tick["ks_end"], cb32)
    window = lambda st: (*(a.contiguous() for a in mhe_lanes._masked_system(cb32, st)),
                         cb32.x_lb, cb32.x_ub, cb32.admm)
    box = admm_work_settings(cb32)
    # the rows' errors: the production settings' cases (fixed rho, polish);
    # the adaptive-rho cases' unconverged iterates are held to their own
    # limit (F4) and printed in kernels_legged
    for key, st, kw, n_states, cases in (
            ("admm_solve", stb32, {}, 1, ("fixed_rho_20_warm", "fixed_rho_valid")),
            ("admm_box_solve", st_end, dict(z0=st_end.z_adm.contiguous(),
                                            y0=st_end.y_adm.contiguous()), None,
             ("fixed_rho_20_warm",))):
        k, args = names[key], window(st)
        run = lambda: admm_kernel.solve_box_lanes(*args, device=DEV, **kw)
        iters = run().iters.cpu().numpy()
        ms[k] = timed(run)
        plain_ms[k] = timed(lambda: admm_kernel.solve_box_lanes_plain(*args, **kw), reps=1)
        works[k] = _work.admm(N_WIN, s, B_MAIN, 4, iters, *box, n_states=n_states)
        err[k] = max(max_err(errs["admm_err"][case]) for case in cases)
        more[k] = {"shape": {"B": B_MAIN, "N": N_WIN, "window": "tick 0: one real slot"
                             if n_states == 1 else f"tick {box_tick['T'] - 1} of (v): 20 real slots"},
                   "ms_how": "one whole-window solve through admm_solve, float32, best of 3"}
    more[names["admm_box_solve"]]["note"] = (
        "device function inside mhe_tick_box and admm_solve: launches counts those two "
        "kernels' launches in (v)")
    launches = {names["mhe_tick"]: counts["mhe_tick"], names["tridiag_solve"]: counts["tridiag_solve"],
                names["mhe_tick_box"]: box_counts["mhe_tick_box"],
                names["admm_solve"]: box_counts["admm_solve"],
                names["admm_box_solve"]: box_counts["admm_box_solve"]}
    src = "decentralized_ekf_mhe_tpu_torch/csrc/"
    tpu = "decentralized_ekf_mhe_tpu/pallas/"
    meta = {names["mhe_tick"]: (src + "mhe_body.cuh", tpu + "mhe_replay_kernel.py:917"),
            names["mhe_tick_box"]: (src + "mhe_body.cuh",
                                    tpu + "mhe_replay_kernel.py:917 (admm_ks set)"),
            names["tridiag_solve"]: (src + "tridiag.cu", tpu + "tridiag_kernel.py:213"),
            names["admm_solve"]: (src + "admm.cu", tpu + "admm_kernel.py:75"),
            names["admm_box_solve"]: (src + "admm_group.cuh", tpu + "admm_core.py:133")}
    shape = {"model": model, "max_abs_err_shape": {"T": T_CHK, "B": B_CHK},
             "plain_ms_shape": {"T": Tp, "B": B_MAIN, "N": N_WIN}, "plain_ms_dtype": "float32"}
    emit("go1feet_rows", T_plain=Tp, B=B_MAIN, ms=ms, plain_ms=plain_ms, max_abs_err=err)
    return kernel_rows(meta, works, launches, err, ms, plain_ms,
                       **{k: dict(shape, **more.get(k, {})) for k in meta})


def go1feet_clock_rows(fleet32, gt_v, errs):
    """The rows of go1feet's K2b, K2c-PI, K2d and K2d-PI: each through the
    MHE-only lanes runner at full width (B=1024), counted and timed in one run
    (the kernel alone, CUDA events) over the first T_GO1FEET_CLOCKS ticks — K2d
    on (u)'s fleet with DEM_MK_SOLVE=chol, K2b and K2d-PI on the 15-clock
    fleet of seed 0 (``make_clock_fleet``, every 64th lane VO-free), K2c-PI on
    its first T_GO1FEET_PI_BOX ticks with the box: launches, the lanes with a camera finite and within the RMSE gate
    (fault F5: a VO-free lane's float32 first non-finite tick is printed),
    the box; the bounds from each run's inputs, the plain versions' float32 ms
    over the first T_GO1FEET_PLAIN ticks of the same inputs, max_abs_err from
    the small-size float64 checks (``errs``)."""
    model = "go1feet"
    p, pb = robot_params(model)[0], box_params(model=model)
    gate = RMSE_GATE[model]
    T_c = T_GO1FEET_CLOCKS
    _, *clocks = make_clock_fleet(T_c, B_MAIN, F32, seed=0, model=model)
    Tp = T_GO1FEET_PLAIN
    runs = (("mhe_tick_pi", clocks, "gj", None, T_c),
            ("mhe_tick_pi_chol", clocks, "chol", None, T_c),
            ("mhe_tick_chol", fleet32, "chol", None, T_c),
            ("mhe_tick_pi_box", clocks, "gj", box_consts(pb, F32, V_BOX, 20), T_GO1FEET_PI_BOX))
    small = {"mhe_tick_pi": errs["pi"]["mhe_tick_pi_err"],
             "mhe_tick_pi_box": errs["pi"]["mhe_tick_pi_box_err"],
             "mhe_tick_chol": errs["chol"]["mhe_tick_chol"],
             "mhe_tick_pi_chol": errs["chol"]["mhe_tick_pi_chol"]}
    rows, res = [], {}
    for key, fleet, tail, consts, T in runs:
        name = f"{key}[go1feet]"
        data_b, _, vo = head(fleet, T)
        with mk_solve_env(tail):
            run = batch.make_lanes_fleet_runner(p, F32, use_megakernel=True, consts=consts,
                                                device=DEV)
            reset_counts()
            mrk.timer.on = True
            with tick_calls() as calls:
                (x, _), wall = wall_ms(lambda: run(data_b, vo))
            mrk.timer.on = False
            alone = min(mrk.timer.ms())
            counts = read_counts()
        want = dict(NO_LAUNCH, **({"admm_solve": 1, "admm_box_solve": 2} if consts is not None
                                  else {"tridiag_solve": 1}), **{key: 1})
        assert counts == want, (name, counts)
        c, ks, d, v, i = calls[0]["args"]
        per_lane = vo.active.ndim == 2
        cam, t_bad = split_vo_free(x, vo) if per_lane else (slice(None), first_nonfinite(x))
        assert per_lane or t_bad is None, (name, "float32 estimate not finite from tick", t_bad)
        rmse = fleet_rmse(x, gt_v[:T], lanes=cam)
        assert rmse < gate, (name, "velocity RMSE vs ground truth", rmse)
        vmax = None
        iters = calls[0]["out"][1].iters
        if consts is not None:
            vmax = float(x[:, cam, 3:6].abs().max())
            assert V_BOX - 1e-2 <= vmax <= V_BOX + 1e-3, (name, "velocity box", vmax)
        work = roofline.tick_work(c, ks, d, v, 4, tail=tail, iters=iters)
        cut = (estimator.TickData(*(a[:Tp - 1].contiguous() for a in d)),
               estimator.VOData(*(a[:Tp - 1] for a in v)), i[:Tp - 1].contiguous())
        _, plain = wall_ms(lambda: mrk.replay_ticks_plain(c._replace(use_pallas=False), ks, *cut))
        del calls, x, d, v, i, cut
        res[name] = {"T": T, "wall_s": wall / 1e3, "kernel_only_ms": alone, "rmse": rmse,
                     "launches": counts, "f32_first_nonfinite_tick_vo_free": t_bad,
                     "max_abs_v": vmax, "plain_ms": plain}
        src = ("decentralized_ekf_mhe_tpu_torch/csrc/mhe_body.cuh",
               "decentralized_ekf_mhe_tpu/pallas/mhe_replay_kernel.py:917 ("
               + ", ".join(w for w, on in (("per_instance=True", per_lane),
                                            ("mk_solve='chol'", tail == "chol"),
                                            ("admm_ks set", consts is not None)) if on) + ")")
        rows += kernel_rows({name: src}, {name: work}, {name: counts[key]},
                            {name: max_err(small[key])}, {name: alone}, {name: plain},
                            **{name: {"model": model, "shape": {"T": T, "B": B_MAIN, "N": N_WIN},
                                      "ms_how": "the kernel alone (CUDA events), the counted "
                                                "run of make_lanes_fleet_runner",
                                      "path": ("DEM_MK_SOLVE=chol, " if tail == "chol" else "")
                                      + ("15 camera clocks" if per_lane else "(u)'s fleet")
                                      + (", the box" if consts is not None else ""),
                                      "rmse_vs_ground_truth": rmse,
                                      "max_abs_err_shape": {"T": T_CHK, "B": B_CHK},
                                      "plain_ms_shape": {"T": Tp, "B": B_MAIN, "N": N_WIN},
                                      "plain_ms_dtype": "float32"}})
    emit("go1feet_clocks", B=B_MAIN, clocks=N_CLOCKS, rmse_gate=gate, **res)
    return rows


# ------------------------------------------- the facade group (ops/facade.py)


def facade_inputs(log, T):
    """The first T ticks of ``log`` as the facade takes them: host arrays of
    the EKF substep blocks and the tick-rate rows."""
    eb = estimator.ekfblocks_from_log(log, dtype=F64, device="cpu")
    return dict(
        ekf_gyro=eb.gyro[:T].numpy(), ekf_accel=eb.accel[:T].numpy(),
        ekf_valid=eb.valid[:T].numpy(), accel_b=log.accel_b[:T], omega_b=log.omega_b[:T],
        p_foot=log.p_foot[:T], J_foot=log.J_foot[:T], dq=log.dq[:T], contact=log.contact[:T],
        ekf_vo_active=eb.vo_active[:T].numpy(), ekf_vo_q=eb.vo_q[:T].numpy(),
        ekf_vo_steps_back=eb.vo_steps_back[:T].numpy(), vo_active=log.vo_active[:T],
        vo_dp=log.vo_dp_body[:T], vo_tick_pre=log.vo_tick_pre[:T],
        vo_tick_now=log.vo_tick_now[:T])


TICK0_KEYS = ("ekf_gyro", "ekf_accel", "ekf_valid", "accel_b", "omega_b", "p_foot", "J_foot",
              "dq", "contact", "ekf_vo_active", "ekf_vo_q", "ekf_vo_steps_back")


def facade_init(est, src):
    """Tick 0 of ``src`` into ``est.initialize``."""
    return est.initialize(**{k: src[k][0] for k in TICK0_KEYS})


def facade_stream(est, src, splits, snapshot_at=None, path=None):
    """``est.update_block`` over the blocks ``splits`` of ``src``; the carry
    is written to ``path`` when the stream reaches tick ``snapshot_at``.
    Returns (x (T,s), v (T,3), q (T,4)) of the ticks streamed."""
    outs = []
    for lo, hi in splits:
        if lo == snapshot_at:
            checkpoint.save_carry(path, est.carry)
        outs.append(est.update_block(**{k: v[lo:hi] for k, v in src.items()}))
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def facade_offline(p, log, T, consts):
    """The offline reference of a streamed run: ``run_pipeline_lanes`` at
    B=1 over the first T ticks on the card, float64, with ``consts``."""
    lanes1 = lambda t: t[:T, None].movedim(1, -1).contiguous()
    data = estimator.TickData(*map(lanes1, estimator.tickdata_from_log(log, dtype=F64,
                                                                       device=DEV)))
    eb = estimator.ekfblocks_from_log(log, F64, device=DEV)
    eb = estimator.EKFBlocks(*(a[:T] for a in eb))
    eb = eb._replace(gyro=eb.gyro[..., None], accel=eb.accel[..., None])
    vo = estimator.VOData(*(a[:T] for a in estimator.vodata_from_log(log, F64, device=DEV)))
    return estimator.run_pipeline_lanes(p, EKFParams(), data, eb, vo=vo, dtype=F64,
                                        consts=consts, ekf_ring_len=RING, device=DEV)


def facade_box():
    """The bench's constrained settings (fixed rho=5000, polish, 20
    iterations, the |v| <= V_BOX box): (params, x_lb, x_ub)."""
    p = box_params()
    p.osqp.max_iter = 20
    ub = torch.full((9,), float("inf"), dtype=F64)
    ub[3:6] = V_BOX
    return p, -ub, ub


def backlog_ms(fn, reps):
    """(mean device ms of one ``fn()``, host ms to queue them, spin ms):
    ``reps`` calls queued behind a spin kernel, CUDA events around them, so that the
    host's launch cost is hidden; the queueing must end within the spin."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    spin_ms = ev[0].elapsed_time(ev[1])
    assert host_ms < spin_ms, ("queueing outran the spin", host_ms, spin_ms)
    return ev[1].elapsed_time(ev[2]) / reps, host_ms, spin_ms


def facade_kernel_rows(tri_windows, box_window, box_consts_, counts, hil_counts):
    """K5 and K4 at B=1 on windows of the streams: each against its plain
    version in float64 (K5 on the tick-0 window, whose dead slots the warm-up
    masks, and the last one; K4 on the last window of the box stream with its
    warm starts, x, z, y and the iteration counts, ``check_admm``), then
    timed in float32 on the last window, beside its plain version, its bound
    (``_work``, this window's iterations) and, for K5, the library's dense
    solve. Returns the two rows of the kernels line."""
    errs = []
    for D, U, r in tri_windows:
        ok, e = close(tridiag_kernel.solve_lanes(D, U, r, device=DEV),
                      tridiag_kernel.solve_lanes_plain(D, U, r), **TOL_MHE)
        assert ok, ("tridiag_solve at B=1 vs plain", e)
        errs.append(e)
    (D, U, r, z0, y0), c = box_window, box_consts_
    kw = dict(z0=z0, y0=y0)
    box_errs, _, res = check_admm("B=1", D, U, r, c.x_lb, c.x_ub, c.admm, **kw)

    tri32 = tuple(a.float().contiguous() for a in tri_windows[-1])
    k5_ms, k5_host, spin = backlog_ms(lambda: tridiag_kernel.solve_lanes(*tri32, device=DEV),
                                      FACADE_REPS)
    k5_plain_ms = timed(lambda: tridiag_kernel.solve_lanes_plain(*tri32))
    lib_ms, lib_diff = library_ms(*(torch.movedim(a, -1, 1) for a in tri32))
    box32 = tuple(a.float().contiguous() for a in box_window)
    lb32, ub32 = c.x_lb.float(), c.x_ub.float()
    k4 = lambda: admm_kernel.solve_box_lanes(*box32[:3], lb32, ub32, c.admm, z0=box32[3],
                                             y0=box32[4], device=DEV)
    admm_kernel.timer.on = True
    _, k4_host, _ = backlog_ms(k4, K4_REPS)
    admm_kernel.timer.on = False
    k4_alone = admm_kernel.timer.ms()[1:]      # the first is backlog_ms' warm-up call
    assert len(k4_alone) == K4_REPS, len(k4_alone)
    k4_ms = sum(k4_alone) / len(k4_alone)
    k4_plain_ms = timed(lambda: admm_kernel.solve_box_lanes_plain(*box32[:3], lb32, ub32, c.admm,
                                                                  z0=box32[3], y0=box32[4]))
    iters = k4().iters.cpu().numpy()
    works = {"tridiag_solve": _work.tridiag(N_WIN, 9, 1, 4),
             "admm_solve": _work.admm(N_WIN, 9, 1, 4, iters, *admm_work_settings(c))}
    how = ("mean of %d (K5) or %d (K4) launches queued behind a spin on the card (CUDA events; "
           "the host's launch cost hidden), float32, the last window of the float64 stream cast"
           % (FACADE_REPS, K4_REPS))
    rows = []
    for name, src, repl, err, ms, plain, lib, extra in (
            ("tridiag_solve", "tridiag.cu", "tridiag_kernel.py:213", max(errs), k5_ms,
             k5_plain_ms, lib_ms,
             {"library": "torch.linalg.solve on the densified (1, N*s, N*s) system",
              "library_minus_kernel_max_abs_f32": lib_diff, "host_queue_ms": k5_host}),
            ("admm_solve", "admm.cu", "admm_kernel.py:75", max(box_errs.values()), k4_ms,
             k4_plain_ms, None,
             {"iters": int(iters[0]), "ms_kernel_alone": "KernelTimer events around each launch",
              "host_queue_ms": k4_host, "max_abs_err_xzy": box_errs})):
        rows.append({
            "name": f"{name}[B=1]", "route": "cuda",
            "source": f"decentralized_ekf_mhe_tpu_torch/csrc/{src}",
            "replaces": f"decentralized_ekf_mhe_tpu/pallas/{repl}",
            "launches": counts[name], "max_abs_err": err, "ms": ms, "plain_ms": plain,
            **bound(works[name]), "library_ms": lib,
            "shape": {"N": N_WIN, "s": 9, "B": 1}, "ms_dtype": "float32",
            "max_abs_err_dtype": "float64", "ms_how": how, "spin_ms": spin,
            "path": "PipelineEstimator(use_pallas=True) streamed, T=%d, one launch per tick "
                    "and one at initialize" % T_FACADE,
            "launches_hil_stream": hil_counts[name],
            "bytes": works[name][0], "operations": works[name][1], **extra})
    emit("facade_kernels", tol=TOL_MHE, tridiag_solve_max_abs_err=errs,
         admm_solve_max_abs_err=box_errs, admm_iters=int(iters[0]),
         ms={"tridiag_solve": k5_ms, "admm_solve": k4_ms},
         plain_ms={"tridiag_solve": k5_plain_ms, "admm_solve": k4_plain_ms},
         library_ms={"tridiag_solve": lib_ms},
         bound_ms={k: bound(w)["bound_ms"] for k, w in works.items()})
    return rows


def facade_group():
    """The online surface on one instance (Go1, the bench's settings, ring
    RING): PipelineEstimator(use_pallas=True) streamed in float64 in uneven
    blocks against the offline pipeline replay with plain consts at B=1,
    unconstrained (K5 every tick) and with the bench's box (K4 every tick),
    the launch counts exact; its carry snapshot halfway resumed bit for bit;
    the float32 HIL stream through the native BlockFeeder with its latency;
    DecentralizedEstimator in float64 against run_mhe and run_kf; and K5 and
    K4 at B=1 against their plain versions. Returns the kernels line's rows."""
    p = go1_params()
    log = synth.generate(synth.SynthConfig(T=T_HIL, seed=0))
    src = facade_inputs(log, T_FACADE)
    gt_v = torch.as_tensor(log.gt_v_s, device=DEV)
    res, counts, windows = {}, {}, {}
    path = os.path.join(_build.BUILD_ROOT, "facade_carry.npz")

    # 1, 3: the streamed float64 runs, unconstrained and boxed, each counted
    t_step = time.time()
    for box in (False, True):
        pb, lb, ub = facade_box() if box else (p, None, None)
        est = PipelineEstimator(pb, EKFParams(), dtype=F64, x_lb=lb, x_ub=ub, use_pallas=True,
                                ekf_ring_len=RING, device=DEV)
        reset_counts()
        x0 = facade_init(est, src)
        st0 = est.carry[1]
        x, v, q = facade_stream(est, src, FACADE_SPLITS, FACADE_SNAPSHOT if not box else None,
                                path)
        torch.cuda.synchronize()
        n = read_counts()
        kern, other = ("admm_solve", "tridiag_solve") if box else ("tridiag_solve", "admm_solve")
        assert n[kern] == T_FACADE and n[other] == 0, ("facade launches", box, n)
        assert n == dict(NO_LAUNCH, **{kern: T_FACADE}, **({"admm_box_solve": T_FACADE}
                                                           if box else {})), n
        counts[kern] = n[kern]
        x = torch.cat([x0[None], x])
        consts = box_consts(pb, F64, V_BOX, 20, use_pallas=False) if box else None
        x_r, v_r, q_r = facade_offline(pb, log, T_FACADE, consts)
        okx, ex = close(x, x_r[:, 0], **TOL_MHE)
        okv, ev = close(v, v_r[1:, 0], **TOL_MHE)
        okq, eq = close(q, q_r[1:, :, 0], **TOL_EKF)
        assert okx and okv and okq, ("facade stream vs offline", box, ex, ev, eq)
        vmax = float(x[:, 3:6].abs().max())
        if box:
            assert vmax <= V_BOX + 1e-6, ("facade box", vmax)
            st = est.carry[1]
            windows["box"] = (*(a.contiguous() for a in mhe_lanes._masked_system(est.consts, st)),
                              st.z_adm.contiguous(), st.y_adm.contiguous())
            windows["box_consts"] = est.consts
        else:
            windows["tri"] = [tuple(a.contiguous() for a in mhe_lanes._masked_system(
                est.consts, s_)) for s_ in (st0, est.carry[1])]
            x64 = x
            # 6: resume the carry written at tick FACADE_SNAPSHOT into a
            # fresh estimator: the rest of the stream bit for bit
            fresh = PipelineEstimator(p, EKFParams(), dtype=F64, use_pallas=True,
                                      ekf_ring_len=RING, device=DEV)
            facade_init(fresh, src)
            fresh.carry = checkpoint.load_carry(path, fresh.carry)
            assert fresh.T == FACADE_SNAPSHOT, fresh.T
            tail = facade_stream(fresh, src, ((FACADE_SNAPSHOT, T_FACADE),))
            k = FACADE_SNAPSHOT - 1          # x, v, q of update_block start at tick 1
            same = [torch.equal(a, b[k:]) for a, b in zip(tail, (x[1:], v, q))]
            assert all(same), ("checkpoint resume", same)
            res["resume"] = {"snapshot_after_tick": FACADE_SNAPSHOT - 1, "bit_identical": True}
        res["box" if box else "unconstrained"] = {
            "launches": n, "max_abs_err_vs_offline": {"x": ex, "v_body": ev, "q": eq},
            "max_abs_v": vmax, "rmse_vs_gt": fleet_rmse(x[:, None], gt_v[:T_FACADE]),
            "seconds": round(time.time() - t_step, 1)}
        emit("facade_stream", box=box, **res["box" if box else "unconstrained"])
        t_step = time.time()

    # 4: the float32 HIL stream through the native BlockFeeder
    if not native.available():
        subprocess.run(["sh", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           "native", "build.sh")], check=True,
                       capture_output=True, timeout=300)
        native._TRIED = False
    assert native.available(), "the native runtime library (native/build.sh) did not build"
    reset_counts()
    hil = run_hil.stream(log, p, EKFParams(), HIL_BLOCK, F32, DEV, use_native=True,
                         use_pallas=True)
    hil_counts = read_counts()
    n_hil = hil["x"].shape[0]
    assert hil["feeder"] == "native BlockFeeder"
    assert hil_counts == dict(NO_LAUNCH, tridiag_solve=n_hil), hil_counts
    x32 = hil["x"]
    assert torch.isfinite(x32).all()
    rmse32 = fleet_rmse(x32[:, None], gt_v[:n_hil])
    assert rmse32 < HIL_RMSE_GATE, ("HIL float32 velocity RMSE", rmse32)
    r32 = fleet_rmse(x32[:T_FACADE, None], gt_v[:T_FACADE])
    r64 = fleet_rmse(x64[:, None], gt_v[:T_FACADE])
    assert abs(r32 - r64) < 1e-3, ("HIL f32-vs-f64 RMSE delta", r32, r64)
    lat = hil["latency_ms"]
    tick1 = run_hil.tick_at_a_time(log, p, F32, DEV, 40)
    res["hil"] = {"T": T_HIL, "block": HIL_BLOCK, "ticks_streamed": n_hil,
                  "feeder": hil["feeder"], "dtype": "float32", "launches": hil_counts,
                  "latency_ms_p50": float(np.percentile(lat, 50)),
                  "latency_ms_p99": float(np.percentile(lat, 99)),
                  "latency_ms_mean": float(lat.mean()), "blocks_timed": len(lat),
                  "tick_at_a_time_ms_p50": float(np.percentile(tick1, 50)),
                  "rmse_vs_gt": rmse32, "rmse_f32_first_300": r32, "rmse_f64_first_300": r64,
                  "budget_ms": 5.0, "seconds": round(time.time() - t_step, 1)}
    emit("facade_hil", **res["hil"])
    t_step = time.time()

    # 5: DecentralizedEstimator (standard layout, one instance, no kernel)
    data = estimator.tickdata_from_log(log, dtype=F64, device=DEV)
    data = estimator.TickData(*(a[:T_FACADE_STD] for a in data))
    vo = estimator.VOData(*(a[:T_FACADE_STD] for a in estimator.vodata_from_log(log, F64,
                                                                                 device=DEV)))
    args = lambda k: [a[k] for a in (log.R_sb_gt, log.accel_b, log.omega_b, log.p_foot,
                                      log.J_foot, log.dq, log.contact)]
    std = {}
    for est_type, ref in ((0, estimator.run_mhe), (1, estimator.run_kf)):
        pt = go1_params()
        pt.est_type = est_type
        est = DecentralizedEstimator(pt, dtype=F64, use_pallas=True, device=DEV)
        reset_counts()
        xs = [est.initialize(*args(0))]
        for k in range(1, T_FACADE_STD):
            vo_k = dict(vo_active=bool(log.vo_active[k]), vo_dp=log.vo_dp_body[k],
                        vo_tick_pre=int(log.vo_tick_pre[k]),
                        vo_tick_now=int(log.vo_tick_now[k])) if est_type == 0 else {}
            xs.append(est.update(*args(k), **vo_k))
        n = read_counts()
        assert n == NO_LAUNCH, ("DecentralizedEstimator launches", n)
        x_ref, _ = ref(pt, data, **({"vo": vo} if est_type == 0 else {}), dtype=F64, device=DEV)
        ok, e = close(torch.stack(xs), x_ref, **TOL_FACADE_STD)
        assert ok, ("DecentralizedEstimator vs", ref.__name__, e)
        std[ref.__name__] = e
    res["decentralized_estimator"] = {"T": T_FACADE_STD, "tol": TOL_FACADE_STD,
                                      "max_abs_err": std, "seconds": round(time.time() - t_step, 1)}

    rows = facade_kernel_rows(windows["tri"], windows["box"], windows["box_consts"], counts,
                              hil_counts)
    res["hil"]["tridiag_solve_B1_mean_launch_ms"] = rows[0]["ms"]
    emit("facade", T=T_FACADE, splits=FACADE_SPLITS, N=N_WIN, ring=RING, tol=TOL_MHE,
         tol_ekf=TOL_EKF, **res)
    print(f"facade: HIL stream of {n_hil} float32 cycles (blocks of {HIL_BLOCK}, "
          f"{hil['feeder']}): per-tick latency p50 {res['hil']['latency_ms_p50']:.3f} ms, "
          f"p99 {res['hil']['latency_ms_p99']:.3f} ms (budget 5 ms); one K5 launch at B=1 "
          f"{rows[0]['ms'] * 1e3:.1f} us; tick-at-a-time p50 "
          f"{res['hil']['tick_at_a_time_ms_p50']:.3f} ms", flush=True)
    return rows


def main():
    t_start = time.time()
    group_s, t_group = {}, [t_start]

    def done(group):
        """Close a group of phases: its seconds go into the script line."""
        now = time.time()
        group_s[group] = round(now - t_group[0], 1)
        t_group[0] = now

    card = phase_device()
    pool = ThreadPoolExecutor(BUILDS_AT_ONCE)
    builds = phase_build(pool)
    ekf_row = ekf_geometry_phase()
    done("build_go1")
    check_kernels()
    # one perturbed fleet at full width, drawn in float64; the main path runs
    # its float32 cast, so both precisions see the same inputs
    log, *fleet64 = make_fleet(T_MAIN, B_MAIN, F64, seed=0)
    fleet32 = tuple(cast(nt, F32) for nt in fleet64)
    gt_v = torch.as_tensor(log.gt_v_s, device=DEV)
    counts, x64, q64, _ = main_path("go1", fleet64, fleet32, gt_v)
    kernels = full_size(fleet64, fleet32, x64, q64, counts)
    del x64
    check_kernels_box()
    box_counts, x64_box, q64_box, box_tick = box_path("go1", fleet64, fleet32, gt_v)
    box_sweep(fleet32)
    per_tick = box_per_tick(fleet32)
    kernels += box_full_width(fleet64, fleet32, x64_box, q64_box, box_counts, box_tick)
    del x64_box, box_tick
    done("go1_shared_clock")
    # cell (q): the standard layout on cell (a)'s fleet, and the float64 oracle
    err_std = check_kernels_std("go1", *std_fleet(head(fleet64, T_STD_CHK), q64, F64), B_RAGGED)
    kernels += std_path(fleet64, fleet32, q64, gt_v, err_std)
    oracle()
    done("go1_standard_layout")
    # the online surface: the stateful facade and the streaming HIL cycle
    kernels += facade_group()
    done("facade")
    # the Cholesky tail at Go1's shape: cell (p) on cell (a)'s fleet
    need(builds, "mhe_go1_chol")
    check_kernels_chol("go1")
    kernels += chol_path("go1", fleet64, fleet32, gt_v)
    del fleet64
    done("go1_cholesky")
    # cell (s), the stage ablation, runs last, on cell (a)'s fleet at Go1's shape
    abl_fleets = {"go1": head(fleet32, T_ABL_TABLE)}
    need(builds, "mhe_go1_pi", ("mhe_go1_pi", FMAD_OFF))
    check_kernels_pi()
    _, *clocks64 = make_clock_fleet(T_MAIN, B_MAIN, F64, seed=0)
    clocks32 = tuple(cast(nt, F32) for nt in clocks64)
    kernels += pi_main_path(clocks64, clocks32, gt_v, fleet32)
    del fleet32
    kernels += pi_box(clocks64, clocks32, gt_v)
    pi_pipeline(clocks32, gt_v)
    kernels += pi_chol_cell("go1", clocks64, clocks32, gt_v)
    del clocks64, clocks32
    done("go1_per_lane_clocks")
    # PogoX, then Go1 with its foot positions as states (s=21, a warp per
    # instance), then Cassie (whose s=15 libraries compile longest)
    kernels += legged_phases("pogox", builds, kernels, abl_fleets)
    done("pogox")
    kernels += go1feet_phases(builds, kernels)
    done("go1feet")
    kernels += legged_phases("cassie", builds, kernels, abl_fleets)
    done("cassie")
    # cell (s): every unit of the stage ablation at each shape, once its
    # libraries are built
    for model, fleet in abl_fleets.items():
        need(builds, *ABL_LIBRARIES[model])
        kernels += ablation_phase(model, fleet)
        done(f"{model}_ablation")
    pool.shutdown()
    mark_window_solve(kernels, box_geometry_phase())
    mark_tick_group(kernels, tick_geometry_phase())
    mark_solve_group(kernels, solve_geometry_phase(), per_tick)
    row = next(k for k in kernels if k["name"] == "ekf_stage")
    row.update(threads_per_instance=_group.EKF_G, group_geometry=ekf_row)
    emit("script", seconds=time.time() - t_start, groups_s=group_s)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    # no autograd bookkeeping: the eager plain versions are host-bound loops
    # of small launches, and nothing here differentiates
    with torch.inference_mode():
        sys.exit(main())
