"""The unconstrained tick on a group of threads per instance.

The unconstrained tick runs ``BOX_G`` = 16 threads per instance with either
tail (K2, K2b; K2d, K2d-PI) at every shape (Go1, PogoX, Cassie):
``tick_geometry`` gives the
launch (threads and instances per block, dynamic shared bytes), and the
wrapper on CPU tensors still takes the plain version, with a block that must
be a multiple of 16. Without a card, ``tests/box_group_host/tick_harness.cpp``
builds the tick body of ``csrc/mhe_body.cuh`` with g++ and runs it on the
group (each instance's 16 lanes as host threads) and on one thread per
instance, from plain-path states of the bench's Go1, PogoX and Cassie fleets
with either tail, for 24 ticks (the window full from tick 20, so the
marginalization runs), in float64 and float32, on the shared camera clock and
on a clock per lane with a VO-free lane: x, every window-state tensor and the
Bezier schedule must agree bit for bit, and the float64 result must match the
plain version (the window's weights on their diagonal scale). The group's
units of the stage ablation (K2e) at Go1's shape, on either clock with either
tail, run there too, in float64, against the plain version that skips the
same stage.
"""

import os
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu_torch.io import synth
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import estimator, mhe

torch.set_num_threads(1)

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-8)
HOST = os.path.join(os.path.dirname(__file__), "box_group_host")
CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "decentralized_ekf_mhe_tpu_torch",
                    "csrc")
B_HOST, T_HOST = 5, 25       # ticks 1..24 in the harness
# the "solve" stage's x against ATOL_SOLVE + RTOL_SOLVE times the magnitude of
# its elementary products, as chip_smoke.py's check_ablation holds it
RTOL_SOLVE, ATOL_SOLVE = 2e-13, 1e-8


def _layout_bytes(s, m, item):
    """csrc/mhe_body.cuh's TickLayout: A_meas and P_cam, five matrix buffers
    of max(s², m²), four vectors of max(s, m), the pivot buffers 4 s; padded
    to 16 mod 32 four-byte words."""
    words = (m * s + 3 * s + 5 * max(s * s, m * m) + 4 * max(s, m) + 4 * s) * item // 4
    return (words + (16 - words % 32) % 32) * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_tick_geometry(dtype):
    """At s=15 (Cassie) the unconstrained tick, with either tail, launches 16
    threads per instance, BLOCK_TICK threads per block by default, with the
    layout's shared bytes per instance (the Cholesky tail keeps its packed
    factor and reciprocal pivots, s(s+1)/2 + s scalars, in a matrix buffer of
    max(s², m²), and z, yv, x in three of the four vectors); any multiple of
    16 up to 256 fits a block; a block that is no multiple of 16 raises, and
    so does an unknown tail. At s=9 the tick launches the same way with
    either tail at Go1's and PogoX's layouts (8 instances per block at
    B=1024 fill 128 of the 132 SMs; the Cholesky tail's packed factor and
    pivots, 54 scalars, fit a matrix buffer, and lane 9 is its spare lane)."""
    item = torch.empty((), dtype=dtype).element_size()
    per = _layout_bytes(15, 6, item)
    assert per % 128 == 64 and per == {4: 5568, 8: 11072}[item]
    assert 15 * 16 // 2 + 15 <= max(15 * 15, 6 * 6) and 15 < mrk.BOX_G   # a spare lane
    with pytest.raises(ValueError, match="mk_solve"):
        mrk.tick_occupancy(None, dtype, mk_solve="cholesky")
    with pytest.raises(ValueError, match="mk_solve"):
        mrk.tick_group(9, "cholesky")
    assert mrk.tick_group(15) and mrk.tick_group(9)
    assert mrk.tick_group(15, "chol") and mrk.tick_group(9, "chol")
    assert 9 * 10 // 2 + 9 <= 9 * 9 and 9 < mrk.BOX_G
    for m, want in ((12, {4: 3776, 8: 7616}), (3, {4: 2240, 8: 4288})):   # Go1, PogoX
        g = mrk.tick_geometry(9, m, dtype)
        assert _layout_bytes(9, m, item) == want[item] and want[item] % 128 == 64
        assert (g.instances_per_block, g.threads_per_block, g.shared_bytes) == (
            8, mrk.BLOCK_TICK, 8 * want[item])
        assert -(-1024 // g.instances_per_block) == 128
        with pytest.raises(ValueError, match="block"):
            mrk.tick_geometry(9, m, dtype, 40)
    g = mrk.tick_geometry(15, 6, dtype)
    assert g.threads_per_block == mrk.BLOCK_TICK
    assert g.instances_per_block == mrk.BLOCK_TICK // mrk.BOX_G
    assert g.shared_bytes == g.instances_per_block * per
    assert 132 * g.instances_per_sm >= 1024
    for block in (16, 32, 64, 128, 256):
        g = mrk.tick_geometry(15, 6, dtype, block)
        assert (g.instances_per_block, g.threads_per_block, g.shared_bytes) == (
            block // 16, block, block // 16 * per)
    for block in (8, 24, 40, 1000, 2048):
        with pytest.raises(ValueError, match="block"):
            mrk.tick_geometry(15, 6, dtype, block)
    for m in (12, 3):
        assert mrk.tick_geometry(9, m, dtype, mk_solve="chol") == mrk.tick_geometry(9, m, dtype)
        with pytest.raises(ValueError, match="block"):
            mrk.tick_geometry(9, m, dtype, 40, mk_solve="chol")


def _fleet(per_lane, B=B_HOST, T=T_HOST, model="cassie_bench"):
    """Consts and replay_ticks' inputs of the bench's fleet of ``model``
    ("go1", "pogox_bench", "cassie_bench"; float64, the plain path's tick-0
    state): on its shared camera clock, or with lane b on a clock of a frame
    every 3 + b % 3 ticks, 1 + b % 2 ticks late, and the last lane VO-free."""
    from decentralized_ekf_mhe_tpu_torch.tools import roofline

    p, data_b, _, vo = roofline.bench_fleet(B, T, device="cpu", dtype=F64, model=model)
    c = mhe.make_consts(p, F64, device="cpu")
    if per_lane:
        vos = [estimator.vodata_from_log(synth.generate(synth.SynthConfig(
            T=T, seed=2, num_legs=p.num_legs, vo_every=3 + b % 3, vo_latency=1 + b % 2)),
            dtype=F64, device="cpu") for b in range(B)]
        lanes = lambda f: torch.stack([getattr(v, f) for v in vos], dim=-1)
        active = lanes("active")
        active[:, -1] = False
        vo = estimator.VOData(active=active, dp_body=lanes("dp_body") * active[:, None, :],
                              tick_pre=lanes("tick_pre"), tick_now=lanes("tick_now"))
    return (c,) + tuple(roofline.tick_inputs(c, data_b, vo))


STATE = ("y_meas", "Q_meas", "A_dyn", "b_dyn", "Q_dyn", "b_cam", "Q_cam", "cam_act", "M_p",
         "n_p", "bez_pts", "p_accum", "prev_R", "prev_accel_s", "prev_contact", "Dslot", "Ub",
         "routb")


def _state_scales(arrays):
    """The scale each window-state entry is held to: its magnitude, and in the
    symmetric weights and the cache D at least the diagonal scale
    sqrt(|W_ii W_jj|), in the cache U = -AᵀQd at least sqrt(|D_ii| |Q_dyn_jj|)
    (a 4e10 position weight leaves rounding of its size in the entries beside
    it; chip_smoke.py's state_scales)."""
    w = dict(zip(STATE, arrays))
    diag = lambda a: torch.diagonal(a, dim1=-3, dim2=-2).abs().movedim(-1, -2)
    out = {n: a.abs() for n, a in w.items()}
    for n in ("Q_meas", "Q_dyn", "Q_cam", "M_p", "Dslot"):
        out[n] = torch.maximum(out[n], torch.sqrt(diag(w[n])[..., :, None, :]
                                                  * diag(w[n])[..., None, :, :]))
    out["Ub"] = torch.maximum(out["Ub"], torch.sqrt(diag(w["Dslot"])[..., :, None, :]
                                                    * diag(w["Q_dyn"])[..., None, :, :]))
    return [out[n] for n in STATE]


def _write_case(path, c, ks, d, v, i, chol=False, ablate=""):
    """One case for tick_harness.cpp: N, B, Tn, t0, per-lane clock, Cholesky
    tail, ablated stage (0 none, else 1 + its index in ``mrk.ABLATE_STAGES``),
    the shape (s, m, L, leg_odom_type); the packed consts; the VO metadata and
    Bezier count (int32); the Bezier times, the tick inputs and the window
    state (float64, lanes layout)."""
    Tn, B = d.accel_b.shape[0], d.accel_b.shape[-1]
    pi = v.active.ndim == 2
    abl = mrk.ABLATE_STAGES.index(ablate) + 1 if ablate else 0
    ints = lambda a: np.ascontiguousarray(a.numpy().astype(np.int32)).tobytes()
    f64 = lambda a: np.ascontiguousarray(a.double().numpy()).tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("11i", c.N, B, Tn, ks.t + 1, int(pi), int(chol), abl, c.dim_state,
                            c.dim_meas, c.num_legs, int(c.leg_odom_type)))
        f.write(mrk._pack_consts(mrk.consts_from_mhe(c)).tobytes())
        for a in (v.active, v.tick_pre, v.tick_now, ks.bez_count):
            f.write(ints(a))
        f.write(f64(ks.bez_times))
        for a in (d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq, d.contact, i):
            f.write(f64(a))
        for a in ks.arrays:
            f.write(f64(a))


@pytest.fixture(scope="module")
def tick_harness(tmp_path_factory):
    """tick_harness.cpp built once with g++ (no FMA contraction): the
    instantiations of Go1's, PogoX's and Cassie's shapes in one executable."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host harness")
    exe = str(tmp_path_factory.mktemp("tick_host") / "tick_harness")
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
                    f"-I{CSRC}", f"-I{HOST}", os.path.join(HOST, "tick_harness.cpp"), "-o", exe],
                   check=True, capture_output=True, text=True)
    return exe


def _run_harness(exe, case, out):
    run = subprocess.run([exe, case, out], capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    return run.stdout.splitlines()


def _read_out(out, xp, ksp):
    """The harness's float64 x, window state and Bezier times, shaped as the
    plain version's."""
    got = torch.from_numpy(np.fromfile(out, dtype=np.float64))
    k, arrays = xp.numel(), []
    for a in ksp.arrays:
        arrays.append(got[k:k + a.numel()].reshape(a.shape))
        k += a.numel()
    return got[:xp.numel()].reshape(xp.shape), arrays, got[k:].reshape(ksp.bez_times.shape)


def _hold_state(arrays, ksp):
    """The window state against the plain version's: the same non-finite
    positions, the finite entries within TOL of their scale."""
    for name, a, b, scale in zip(STATE, arrays, ksp.arrays, _state_scales(ksp.arrays)):
        fin = torch.isfinite(b)
        assert torch.equal(fin, torch.isfinite(a)) and torch.equal(b.isnan(), a.isnan()), name
        assert bool(((a - b).abs()[fin] <= TOL["atol"] + TOL["rtol"] * scale[fin]).all()), name


@pytest.mark.parametrize("model,tail,per_lane", [
    pytest.param("cassie_bench", "gj", False, id="shared_clock"),
    pytest.param("cassie_bench", "gj", True, id="per_lane_clocks"),
    pytest.param("cassie_bench", "chol", False, id="chol-shared_clock"),
    pytest.param("cassie_bench", "chol", True, id="chol-per_lane_clocks"),
    pytest.param("go1", "gj", False, id="go1-shared_clock"),
    pytest.param("go1", "gj", True, id="go1-per_lane_clocks"),
    pytest.param("pogox_bench", "gj", False, id="pogox-shared_clock"),
    pytest.param("pogox_bench", "gj", True, id="pogox-per_lane_clocks"),
    pytest.param("go1", "chol", False, id="go1-chol-shared_clock"),
    pytest.param("go1", "chol", True, id="go1-chol-per_lane_clocks"),
    pytest.param("pogox_bench", "chol", False, id="pogox-chol-shared_clock"),
    pytest.param("pogox_bench", "chol", True, id="pogox-chol-per_lane_clocks")])
def test_group_tick_equals_one_thread_tick_on_the_host(tick_harness, tmp_path, model, tail,
                                                       per_lane):
    """mhe_body on the group (GRP: the marginalization, the shift with its
    cache update and the streaming sweep row-parallel, lane 0 the VO
    ingestion and the fresh slots' blocks; with the Cholesky tail W column-parallel,
    S_j row-parallel and the factor column by column) gives the one-thread
    body's x, window state and Bezier schedule bit for bit over 24 ticks, in
    float64 and float32, at Cassie's, Go1's and PogoX's shapes with the
    Gauss-Jordan tail ("gj") and the Cholesky tail ("chol": at s=9 lane 9 is
    the spare lane, and at Go1's shape it also owns a measurement row); on
    per-lane clocks with a lane that never ingests. Its
    float64 x and state are the plain version's (the plain version does not
    depend on the tail). A lane that leaves a sync alone hangs the barrier,
    which the time limit turns into a failure."""
    c, ks, d, v, i = _fleet(per_lane, model=model)
    if per_lane:
        assert not bool(v.active[:, -1].any()) and int(v.active[:, 0].sum()) >= 4
    case, out = str(tmp_path / "case.bin"), str(tmp_path / "out.bin")
    _write_case(case, c, ks, d, v, i, chol=tail == "chol")
    lines = _run_harness(tick_harness, case, out)
    assert lines[-1] == "ALL BIT-IDENTICAL" and len(lines) == 3, lines
    shape = f" s={c.dim_state} m={c.dim_meas} "
    assert all(shape in ln and f" {tail}: x 0 state 0 schedule 0 differ" in ln
               for ln in lines[:2]), lines

    # the group's float64 x and state against the plain version
    xp, ksp = mrk.replay_ticks_plain(c, ks, d, v, i)
    x, arrays, times = _read_out(out, xp, ksp)
    torch.testing.assert_close(x, xp, **TOL)
    _hold_state(arrays, ksp)
    assert torch.equal(times, ksp.bez_times)
    assert ksp.t == T_HOST - 1 >= c.N


@pytest.mark.parametrize("stage", mrk.ABLATE_STAGES)
def test_group_ablation_matches_the_plain_version_on_the_host(tick_harness, tmp_path, stage):
    """The group's float64 tick with one stage skipped (K2e: ABL on the group,
    Go1's shape, the shared clock) against ``replay_ticks_plain(...,
    ablate=stage)`` over 24 ticks, as chip_smoke.py's check_ablation holds it:
    x with the same non-finite positions and its finite entries within TOL
    (the "solve" stage's within ATOL_SOLVE + RTOL_SOLVE of its elementary
    products' magnitude, ``mrk.solve_stage_scales``), the window state it
    leaves with the same non-finite positions and within TOL of its scale."""
    c, ks, d, v, i = _fleet(False, model="go1")
    assert int(v.active.sum()) > 0
    case, out = str(tmp_path / "case.bin"), str(tmp_path / "out.bin")
    _write_case(case, c, ks, d, v, i, ablate=stage)
    _hold_ablated(tick_harness, case, out, c, ks, d, v, i, stage)


def _hold_ablated(exe, case, out, c, ks, d, v, i, stage, tail="gj"):
    """Run an ablation case of the harness and hold its float64 x and window
    state against ``replay_ticks_plain(..., ablate=stage, mk_solve=tail)``."""
    pi = v.active.ndim == 2
    lines = _run_harness(exe, case, out)
    assert lines == [f"{case} s=9 m=12 f64 {'per-lane' if pi else 'shared'} {tail} ablation "
                     f"{mrk.ABLATE_STAGES.index(stage) + 1}: written", "ALL BIT-IDENTICAL"], lines
    xp, ksp = mrk.replay_ticks_plain(c, ks, d, v, i, ablate=stage, mk_solve=tail)
    x, arrays, times = _read_out(out, xp, ksp)
    fin = torch.isfinite(xp)
    assert torch.equal(fin, torch.isfinite(x)) and torch.equal(xp.isnan(), x.isnan())
    # zeroed fresh data: a singular window, on which the Gauss-Jordan chain
    # leaves nothing finite and the Cholesky chain breaks down in places
    assert bool(fin.all()) == (stage != "build")
    if tail == "gj":
        assert bool(fin.any()) == (stage != "build")
    if stage == "solve":
        scale, tol = mrk.solve_stage_scales(c, ks, d, v, i)["terms"], dict(rtol=RTOL_SOLVE,
                                                                          atol=ATOL_SOLVE)
    else:
        scale, tol = xp.abs(), TOL
    assert bool(((x - xp).abs()[fin] <= tol["atol"] + tol["rtol"] * scale[fin]).all())
    _hold_state(arrays, ksp)
    assert torch.equal(times, ksp.bez_times)


@pytest.mark.parametrize("stage,tail,per_lane", [
    *(pytest.param(st, "gj", True, id=f"per_lane_clocks-{st}") for st in mrk.ABLATE_STAGES),
    *(pytest.param(st, "chol", pl, id=f"chol-{'per_lane_clocks' if pl else 'shared_clock'}-{st}")
      for pl in (False, True) for st in ("ingest", "marg", "build"))])
def test_group_ablation_on_either_clock_and_tail_on_the_host(tick_harness, tmp_path, stage,
                                                             tail, per_lane):
    """The group's float64 tick with one stage skipped on per-lane clocks (a
    VO-free lane among them; the ingest stage skips lane 0's per-lane
    ingestion and Bezier carry) and with the Cholesky tail on either clock
    (the stages before the tail; its tail-free stages are the Gauss-Jordan
    units) against ``replay_ticks_plain(..., ablate=stage, mk_solve=tail)``
    over 24 ticks at Go1's shape, as the shared-clock units are held: where
    "build" leaves the window singular, the Cholesky chain's non-finite
    positions are the plain Cholesky sweep's."""
    c, ks, d, v, i = _fleet(per_lane, model="go1")
    case, out = str(tmp_path / "case.bin"), str(tmp_path / "out.bin")
    _write_case(case, c, ks, d, v, i, chol=tail == "chol", ablate=stage)
    _hold_ablated(tick_harness, case, out, c, ks, d, v, i, stage, tail)


def test_unconstrained_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the unconstrained ``replay_ticks`` at Cassie's shape is
    its plain version at any block the group launch takes, with either tail;
    a block that is no multiple of 16 raises here too, with either tail."""
    c, ks, d, v, i = _fleet(False, B=2, T=6)
    before = mrk.launches
    x, st = mrk.replay_ticks(c, ks, d, v, i, device="cpu")
    x48, _ = mrk.replay_ticks(c, ks, d, v, i, device="cpu", block=48)
    xp, stp = mrk.replay_ticks_plain(c, ks, d, v, i)
    assert mrk.launches == before
    assert torch.equal(x, xp) and torch.equal(x48, xp)
    assert all(torch.equal(a, b) for a, b in zip(st.arrays, stp.arrays))
    with pytest.raises(ValueError, match="multiple of"):
        mrk.replay_ticks(c, ks, d, v, i, device="cpu", block=40)
    # the Cholesky tail runs on the group at this shape too
    xc, _ = mrk.replay_ticks(c, ks, d, v, i, device="cpu", block=48, mk_solve="chol")
    assert torch.equal(xc, xp) and mrk.launches_chol == 0
    with pytest.raises(ValueError, match="multiple of"):
        mrk.replay_ticks(c, ks, d, v, i, device="cpu", block=40, mk_solve="chol")


def test_tool_cassie_sweep_on_the_cpu():
    """tools/roofline.py's --sweep at Cassie's shape (``model=``) runs at a
    tiny size on the CPU (the plain versions; control flow only), at blocks
    that are multiples of 16; one that is not raises before a launch."""
    from decentralized_ekf_mhe_tpu_torch.tools import roofline

    sw = roofline.sweep(Bs=(2,), blocks=(32, 48), T=6, device="cpu", reps=1,
                        model="cassie_bench")
    assert sw["model"] == "cassie_bench" and sw["device"] == "cpu"
    assert [r["block"] for r in sw["rows"]] == [32, 48]
    assert sw["rows"][0]["roofline"]["model"]["s"] == 15
    with pytest.raises(ValueError, match="multiple of"):
        roofline.sweep(Bs=(2,), blocks=(40,), T=6, device="cpu", reps=1, model="cassie_bench")
