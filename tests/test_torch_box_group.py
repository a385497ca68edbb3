"""The constrained tick's launch on a group of threads per instance.

``box_geometry`` (threads and instances per block, the dynamic shared memory
of ``csrc/admm_group.cuh``'s layout, and what an SM holds of it) at the
state sizes of the three robots, its refusals, and the constrained wrapper on
CPU tensors: it still takes the plain version there, with the results of
the eager lanes loop on the fixtures of ``tests/test_torch_mhe.py`` (which
holds both against the JAX package).
"""

import os
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu_torch.config import EstimatorParams
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.kernels.admm_kernel import ADMMCoreStatic
from decentralized_ekf_mhe_tpu_torch.ops import admm, estimator, mhe, mhe_lanes

from test_torch_mhe import F64, TOL, _box_fleet, _box_params

torch.set_num_threads(1)


def _layout_bytes(s, N, item, u_shared):
    """csrc/admm_group.cuh's BoxLayout: Sinv N s², U (N-1) s² when it sits in
    shared memory, x, z, y, the sweep vectors and r 5 N s, six s of buffers;
    padded to 16 mod 32 four-byte words."""
    scalars = N * s * s + (N - 1) * s * s * u_shared + 5 * N * s + 6 * s
    words = scalars * item // 4
    return (words + (16 - words % 32) % 32) * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("s", [9, 15])
def test_box_geometry(s, dtype):
    """G >= s; the default block is BLOCK_BOX threads or, where that does not
    fit, as many instances as do; the shared bytes are the layout's, at most
    what a block may use; float32 keeps at least 8 instances per SM (every
    instance of B=1024 resident on the 132 SMs); a block that is no multiple
    of G raises."""
    g = mrk.box_geometry(s, dtype)
    item = torch.empty((), dtype=dtype).element_size()
    assert g.u_shared == (s == 9)
    per = _layout_bytes(s, 20, item, g.u_shared)
    # BLOCK_BOX threads, or as many instances as fit a block
    ipb = min(mrk.BLOCK_BOX // mrk.BOX_G, mrk.SHARED_PER_BLOCK // per)
    assert mrk.BOX_G >= s and g.instances_per_block == ipb
    assert g.threads_per_block == ipb * mrk.BOX_G
    assert g.shared_bytes == ipb * per <= mrk.SHARED_PER_BLOCK
    assert per % 128 == 64
    if dtype == torch.float32:
        assert g.instances_per_sm >= 8 and 132 * g.instances_per_sm >= 1024
    for block in (8, 40, 1000, 2048):
        with pytest.raises(ValueError):
            mrk.box_geometry(s, dtype, block)


def test_box_geometry_refuses_what_a_block_cannot_hold():
    """Shared memory beyond 232,448 bytes per block raises before a launch;
    so does a state size beyond the group."""
    assert mrk.box_geometry(15, torch.float64, 64).shared_bytes <= mrk.SHARED_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        mrk.box_geometry(15, torch.float64, 128)
    with pytest.raises(ValueError, match="shared memory"):
        mrk.box_geometry(15, torch.float32, 160)
    with pytest.raises(ValueError, match="states"):
        mrk.box_geometry(17, torch.float32)


def test_constrained_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the constrained ``replay_ticks`` is its plain version:
    no launch, the same numbers, and on the fixtures of test_torch_mhe.py the
    estimates of the eager lanes loop; a block the card could not take
    raises here too."""
    N, T, Bs, vb = 5, 12, 4, 0.08
    _, _, _, tdata_l, tvo, tc = _box_fleet(T, Bs, 9, N, vb, 20)
    d0 = estimator.TickData(*(a[0] for a in tdata_l))
    st0 = mhe_lanes.init(tc, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot, d0.J_foot, d0.dq,
                         d0.contact, dtype=F64, device="cpu")
    vo_inc = estimator.vo_world_increments(tdata_l.R_sb, tvo)
    ks0 = mrk.kernel_state_from_mhe(st0, tc)
    rest = (estimator.TickData(*(a[1:].contiguous() for a in tdata_l)),
            estimator.VOData(*(a[1:] for a in tvo)), vo_inc[1:].contiguous())
    before = (mrk.launches_box, mrk.launches_pi_box)
    x, ks = mrk.replay_ticks(tc, ks0, *rest, device="cpu")
    x48, _ = mrk.replay_ticks(tc, ks0, *rest, device="cpu", block=48)
    xp, ksp = mrk.replay_ticks_plain(tc, ks0, *rest)
    assert (mrk.launches_box, mrk.launches_pi_box) == before
    assert torch.equal(x, xp) and torch.equal(x48, xp) and torch.equal(ks.iters, ksp.iters)
    assert all(torch.equal(a, b) for a, b in zip(ks.arrays, ksp.arrays))
    with pytest.raises(ValueError, match="multiple of"):
        mrk.replay_ticks(tc, ks0, *rest, device="cpu", block=40)
    ex, _ = estimator.run_mhe_lanes(_box_params(N, EstimatorParams), tdata_l, vo=tvo, dtype=F64,
                                    consts=tc, device="cpu")
    np.testing.assert_allclose(x.numpy(), torch.movedim(ex, 1, -1)[1:].numpy(), **TOL)
    assert float(x[:, 3:6].abs().max()) <= vb + 1e-6


def test_tool_cassie_constrained_sweep_on_the_cpu():
    """tools/roofline.py's --constrained-sweep at Cassie's shape runs at a
    tiny size on the CPU (the plain versions; control flow only)."""
    from decentralized_ekf_mhe_tpu_torch.tools import roofline

    cs = roofline.constrained_sweep(B=2, T=6, iters_list=(2, 4), device="cpu", reps=1,
                                    model="cassie_bench")
    assert cs["model"] == "cassie_bench" and len(cs["rows"]) == 4
    assert "us_per_iteration_per_tick" in cs and cs["device"] == "cpu"
    with pytest.raises(ValueError, match="model"):
        roofline.bench_fleet(2, 22, device="cpu", model="pogox")


HOST = os.path.join(os.path.dirname(__file__), "box_group_host")
CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "decentralized_ekf_mhe_tpu_torch",
                    "csrc")


def _write_case(path, D, U, r, ub, z0, y0, static, zbase):
    """One window system for tests/box_group_host/harness.cpp: the ring
    z0/y0 given by logical slot is stored so that physical slot
    (zbase + j) % N holds slot j, as the tick's ring does."""
    N, s, _, B = D.shape
    ints, reals = static.pack()
    z0, y0 = torch.roll(z0, zbase, 0), torch.roll(y0, zbase, 0)
    with open(path, "wb") as f:
        f.write(struct.pack("4i", N, s, B, zbase))
        f.write(np.asarray(ints, np.int32).tobytes())
        f.write(np.asarray(reals, np.float64).tobytes())
        for a in (D, U, r, -ub, ub, z0, y0):
            f.write(a.contiguous().double().numpy().tobytes())


def _cases(model, tmp, B=3, T=26):
    """Window systems of the bench's constrained fleet at ``model``'s shape
    (float64, the plain path): after 6 ticks and with the window full, each
    under the production settings (fixed rho, 20 iterations, polish), with
    adaptive rho, a loose tolerance (some windows stop after 10 iterations)
    and no polish, with no convergence check, and from a cold start; a
    per-lane box, and the ring turned by a different zbase each."""
    from decentralized_ekf_mhe_tpu_torch.tools import roofline

    p, data_b, _, vo = roofline.bench_fleet(B, T, device="cpu", dtype=F64, model=model)
    s = p.dim_state
    p.osqp.abs_tol = p.osqp.relative_tol = 1e-6
    p.osqp.rho, p.osqp.adapt_rho, p.osqp.polish = 5000.0, False, True
    ub = torch.full((s, B), float("inf"), dtype=F64)
    ub[3:6] = torch.linspace(0.05, 0.3, B, dtype=F64)
    c = mhe.make_consts(p, F64, x_lb=-ub, x_ub=ub, admm_iters=20, device="cpu")
    ks, d, v, i = roofline.tick_inputs(c, data_b, vo)
    fixed = ADMMCoreStatic.from_settings(c.admm, c.N, s)
    adapt = ADMMCoreStatic.from_settings(
        admm.ADMMSettings(rho=0.1, iters=25, abs_tol=1e-3, rel_tol=1e-3), c.N, s)
    variants = (fixed, adapt._replace(polish=False),
                adapt._replace(iters=7, abs_tol=0.0, rel_tol=0.0))
    paths = []
    for Tk in (6, T - 1):
        cut = lambda a: a[:Tk]
        _, ksT = mrk.replay_ticks(c, ks, estimator.TickData(*map(cut, d)),
                                  estimator.VOData(*map(cut, v)), cut(i), device="cpu")
        st = mrk.mhe_state_from_kernel(ksT, c)
        D, U, r = mhe_lanes._masked_system(c, st)
        for k, static in enumerate(variants):
            paths.append(os.path.join(tmp, f"{model}_t{Tk}_{k}.bin"))
            _write_case(paths[-1], D, U, r, ub, st.z_adm, st.y_adm, static, (Tk + 7 * k) % c.N)
    zero = torch.zeros_like(st.z_adm)
    paths.append(os.path.join(tmp, f"{model}_cold.bin"))
    _write_case(paths[-1], D, U, r, ub, zero, zero, fixed, 3)
    return paths


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ to build the host harness")
def test_group_solve_equals_one_thread_solve_on_the_host(tmp_path):
    """admm_box_solve_group, each instance's 16 lanes as host threads with a
    barrier for __syncwarp, gives the one-thread admm_box_solve's x, z/y ring
    and iteration counts bit for bit, in float64 and float32, at Go1's
    (s=9, U_j in shared memory) and Cassie's (s=15, U_j from global memory)
    shapes: the check of the group's syncs, row ownership and reductions that
    runs without a card. Lanes that disagree on when to stop leave the
    barrier waiting, which the time limit turns into a failure."""
    exe = str(tmp_path / "harness")
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
                    f"-I{CSRC}", f"-I{HOST}", os.path.join(HOST, "harness.cpp"), "-o", exe],
                   check=True, capture_output=True, text=True)
    paths = _cases("go1", str(tmp_path)) + _cases("cassie_bench", str(tmp_path))
    run = subprocess.run([exe, *paths], capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    lines = run.stdout.splitlines()
    assert lines[-1] == "ALL BIT-IDENTICAL" and len(lines) == 2 * len(paths) + 1, run.stdout
    assert sum(" s=9 USH=1:" in ln for ln in lines) == sum(" s=15 USH=0:" in ln for ln in lines)
