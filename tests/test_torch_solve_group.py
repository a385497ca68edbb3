"""The whole-window box-ADMM (K4 ``admm_solve``) and the block-tridiagonal
solve (K5 ``tridiag_solve``, both routes) on a group of 16 threads per
instance.

Without a card: the launch geometry of both kernels (``kernels/_group.py``)
and its refusals; the wrappers on CPU tensors (their plain versions, no
launch); the group bodies built for the host (``tests/box_group_host/
harness.cpp``, 16 ``std::thread``s per instance, ``g++ -ffp-contract=off``)
against the one-thread bodies bit for bit in float64 and float32 on window
systems of the bench's Go1 (s=9) and Cassie (s=15) fleets, N=20 — K4's kernel
entry (fixed and adaptive rho, per-lane bounds, a warm-up window with dead
leading slots, warm starts, a ragged B), K5 on the lanes layout and on the
standard layout read in place with a per-lane warm-up mask; the plain versions against the JAX
package's Pallas kernels in interpret mode at these shapes; and fault F8: on
a window with one non-finite entry, the plain K4, the JAX kernel and both
host bodies run every iteration on that instance.
"""

import os
import re
import shutil
import struct
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu.ops import admm as jadmm
from decentralized_ekf_mhe_tpu.pallas import admm_kernel as jak
from decentralized_ekf_mhe_tpu.pallas import tridiag_kernel as jtk
from decentralized_ekf_mhe_tpu_torch.kernels import _group, admm_kernel, tridiag_kernel
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.kernels.admm_kernel import ADMMCoreStatic
from decentralized_ekf_mhe_tpu_torch.ops import admm, estimator, mhe, mhe_lanes, tridiag

torch.set_num_threads(1)

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-8)       # tests/test_torch_admm.py, test_torch_standard.py
HOST = os.path.join(os.path.dirname(__file__), "box_group_host")
CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "decentralized_ekf_mhe_tpu_torch",
                    "csrc")
MODELS = {"go1": 9, "cassie_bench": 15}


# ------------------------------------------------------------ the geometry


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("s", [9, 15])
def test_admm_geometry_is_the_box_layout(s, dtype):
    """K4 launches the box-ADMM's group with the constrained tick's layout:
    the same instances, threads and shared bytes per block, U_j in shared
    memory at s=9."""
    g = admm_kernel.geometry(s, dtype)
    assert g == mrk.box_geometry(s, dtype)
    assert g.u_shared == (s == 9) and g.threads_per_block == 16 * g.instances_per_block
    assert g.shared_bytes == g.instances_per_block * _group.instance_bytes(
        _group.box_shared_scalars(s, 20, g.u_shared), dtype) <= _group.SHARED_PER_BLOCK
    with pytest.raises(ValueError, match="multiple of"):
        admm_kernel.geometry(s, dtype, 40)


def _tri_bytes(s, N, item):
    """csrc/tridiag.cuh's TriLayout: the chain N s², W and the staged U
    block 2 s², y N s, six s of buffers; padded to 16 mod 32 four-byte
    words."""
    scalars = N * s * s + 2 * s * s + N * s + 6 * s
    words = scalars * item // 4
    return (words + (16 - words % 32) % 32) * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("s", [9, 15])
def test_tridiag_geometry(s, dtype):
    """K5 keeps its whole chain in shared memory; the default block is eight
    instances, or as many as fit a block (five at s=15 in float64); the bytes
    are the layout's; every instance of B=1024 is resident at once over 132
    SMs but at s=15 in float64, where one block of five fits an SM."""
    g = tridiag_kernel.geometry(s, dtype)
    item = torch.empty((), dtype=dtype).element_size()
    big = s == 15 and dtype == torch.float64
    per = _tri_bytes(s, 20, item)
    assert g.instances_per_block == (5 if big else 8)
    assert g.threads_per_block == 16 * g.instances_per_block
    assert g.shared_bytes == g.instances_per_block * per and per % 128 == 64
    assert g.shared_bytes <= _group.SHARED_PER_BLOCK
    assert (132 * g.instances_per_sm >= 1024) == (not big)
    assert g == tridiag_kernel.geometry(s, dtype, g.threads_per_block)


def test_solve_geometry_refuses_what_a_block_cannot_hold():
    """Shared memory beyond 232,448 bytes per block, a block that is no
    multiple of 16 threads and a state beyond the group raise ValueError
    before a launch, for K4 and for K5."""
    assert admm_kernel.geometry(15, F64).threads_per_block == 64
    with pytest.raises(ValueError, match="shared memory"):
        admm_kernel.geometry(15, F64, 128)
    with pytest.raises(ValueError, match="shared memory"):
        tridiag_kernel.geometry(15, F64, 128)
    assert tridiag_kernel.geometry(15, F64, 80).shared_bytes <= _group.SHARED_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        tridiag_kernel.geometry(9, F64, 1024, N=200)
    for fn in (admm_kernel.geometry, tridiag_kernel.geometry):
        for block in (8, 40, 2048):
            with pytest.raises(ValueError):
                fn(9, torch.float32, block)
        with pytest.raises(ValueError, match="states"):
            fn(17, torch.float32)


# ------------------------------------------------- the wrappers on the CPU


def _spd(rng, K, B, s, scale=0.3):
    """A random SPD block-tridiagonal system, standard layout (numpy)."""
    M = rng.standard_normal((K, B, s, s))
    D = M @ np.swapaxes(M, -1, -2) + s * np.eye(s)
    U = scale * rng.standard_normal((K - 1, B, s, s))
    r = rng.standard_normal((K, B, s))
    return D, U, r


def test_standard_route_reads_a_view_on_the_cpu():
    """solve_batched takes the (K,B,...) view of (B,K,...) storage that
    ``ops.mhe.solve_window`` hands it, with a per-lane warm-up mask: the plain
    version on CPU tensors, no launch, the exact sweep's bits (on the card
    the kernel reads any view through its strides)."""
    rng = np.random.default_rng(4)
    D, U, r = (torch.as_tensor(a) for a in _spd(rng, 6, 5, 9))
    valid = torch.ones((6, 5), dtype=torch.bool)
    valid[:2, 1] = False
    valid[:4, 3] = False
    view = lambda a: torch.movedim(a.movedim(0, 1).contiguous(), 0, 1)
    Dv, Uv, rv, vv = (view(a) for a in (D, U, r, valid))
    assert not Dv.is_contiguous()
    before = (tridiag_kernel.launches, tridiag_kernel.launches_batched)
    x = tridiag_kernel.solve_batched(Dv, Uv, rv, valid=vv, device="cpu")
    assert (tridiag_kernel.launches, tridiag_kernel.launches_batched) == before
    assert torch.equal(x, tridiag.solve(D, U, r, valid=valid))
    assert float(x[:2, 1].abs().max()) == 0.0 and float(x[:4, 3].abs().max()) == 0.0


def test_admm_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors solve_box_lanes is its plain version: no launch, the
    same bits."""
    rng = np.random.default_rng(5)
    D, U, r = (torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 1, -1)))
               for a in _spd(rng, 8, 3, 9))
    st = admm.ADMMSettings(rho=0.5, iters=30, adaptive_rho=True, abs_tol=1e-6, rel_tol=1e-6)
    before = (admm_kernel.launches, admm_kernel.launches_core)
    ub = np.full(9, 0.2)
    got = admm_kernel.solve_box_lanes(D, U, r, -ub, ub, st, device="cpu")
    assert (admm_kernel.launches, admm_kernel.launches_core) == before
    want = admm.solve_box_tridiag_lanes(D, U, r, -ub, ub, st)
    assert all(torch.equal(getattr(got, f), getattr(want, f)) for f in ("x", "z", "y", "iters"))


# ---------------------------------------------- the group bodies on the host


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host harness")
    exe = str(tmp_path_factory.mktemp("harness") / "harness")
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
                    f"-I{CSRC}", f"-I{HOST}", os.path.join(HOST, "harness.cpp"), "-o", exe],
                   check=True, capture_output=True, text=True)
    return exe


def _run(exe, paths):
    run = subprocess.run([exe, *paths], capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    lines = run.stdout.splitlines()
    assert lines[-1] == "ALL BIT-IDENTICAL", run.stdout
    return lines[:-1]


_windows_cache = {}


def _windows(model, B=5, T=26):
    """(consts, early state, late state) of the bench's constrained fleet at
    ``model``'s shape, float64, the plain path: after 6 ticks (the window's
    leading slots dead) and with the window full; per-lane bounds on the
    velocity states."""
    if model not in _windows_cache:
        from decentralized_ekf_mhe_tpu_torch.tools import roofline

        p, data_b, _, vo = roofline.bench_fleet(B, T, device="cpu", dtype=F64, model=model)
        s = p.dim_state
        p.osqp.abs_tol = p.osqp.relative_tol = 1e-6
        p.osqp.rho, p.osqp.adapt_rho, p.osqp.polish = 5000.0, False, True
        ub = torch.full((s, B), float("inf"), dtype=F64)
        ub[3:6] = torch.linspace(0.05, 0.3, B, dtype=F64)
        c = mhe.make_consts(p, F64, x_lb=-ub, x_ub=ub, admm_iters=20, device="cpu")
        ks, d, v, i = roofline.tick_inputs(c, data_b, vo)
        states = []
        for Tk in (6, T - 1):
            cut = lambda a: a[:Tk]
            _, ksT = mrk.replay_ticks(c, ks, estimator.TickData(*map(cut, d)),
                                      estimator.VOData(*map(cut, v)), cut(i), device="cpu")
            states.append(mrk.mhe_state_from_kernel(ksT, c))
        _windows_cache[model] = (c, ub, *states)
    return _windows_cache[model]


def _write_admm(path, D, U, r, lb, ub, z0, y0, static):
    """A K4 case of the harness (header -2): K4's kernel entry."""
    N, s, _, B = D.shape
    ints, reals = static.pack()
    with open(path, "wb") as f:
        f.write(struct.pack("4i", -2, N, s, B))
        f.write(np.asarray(ints, np.int32).tobytes())
        f.write(np.asarray(reals, np.float64).tobytes())
        for a in (D, U, r, lb, ub, z0, y0):
            f.write(a.contiguous().double().numpy().tobytes())


def _write_tridiag(path, D, U, r, valid=None, storage="bn"):
    """A K5 case of the harness. Lanes: the masked lanes system. Standard
    (``valid`` (N,B)): D (N,B,s,s), U, r unmasked and the mask as the views
    the kernel reads in place, through their strides, of a storage:
    ``"bn"`` (B,N,...), as ``ops.mhe.solve_window`` hands them over, or
    ``"lanes"`` (N,s,s,B), (N,s,B), (N,B); and the lanes system the old
    route gave: ops.tridiag.mask_system, then B to the minor axis."""
    N, s = D.shape[0], D.shape[2]
    std = valid is not None
    lanes = (tuple(torch.movedim(a, 1, -1) for a in tridiag.mask_system(D, U, r, valid))
             if std else (D, U, r))
    B = lanes[0].shape[-1]
    with open(path, "wb") as f:
        f.write(struct.pack("5i", -1, N, s, B, int(std)))
        for a in lanes:
            f.write(a.contiguous().double().numpy().tobytes())
        if std:
            views = [a.double() for a in (D, U, r, valid)]
            if storage == "bn":
                stores = [a.movedim(0, 1).contiguous() for a in views]
                views = [a.movedim(0, 1) for a in stores]
            else:
                stores = [torch.movedim(a, 1, -1).contiguous() for a in views]
                views = [torch.movedim(a, -1, 1) for a in stores]
            f.write(np.asarray([k for v in views for k in v.stride()], np.int64).tobytes())
            for a in stores:
                f.write(a.numpy().tobytes())


def _k4_cases(model, tmp):
    """K4's cases at ``model``'s shape: the full late window with the ring's
    warm starts under the production settings (fixed rho, polish) and per-lane
    bounds; with adaptive rho and a loose tolerance (instances stop at
    different epochs); a budget that ends inside an epoch without the check;
    the early window (dead leading slots, masked as the wrapper masks it)
    from a cold start; and a ragged B of 3."""
    c, ub, st_e, st_l = _windows(model)
    s = c.dim_state
    fixed = ADMMCoreStatic.from_settings(c.admm, c.N, s)
    adapt = ADMMCoreStatic.from_settings(
        admm.ADMMSettings(rho=0.1, iters=50, abs_tol=1e-3, rel_tol=1e-3), c.N, s)
    D, U, r = mhe_lanes._masked_system(c, st_l)
    De, Ue, re, valid = mhe_lanes.assemble_normal_equations(c, st_e)
    assert not bool(valid.all()) and bool(valid[-1])
    De, Ue, re = admm.mask_system(De, Ue[:-1], re, valid)
    zero = torch.zeros_like(r)
    cases = [("warm_fixed", (D, U, r, -ub, ub, st_l.z_adm, st_l.y_adm, fixed)),
             ("adaptive", (D, U, r, -ub, ub, zero, zero, adapt)),
             ("no_check_7", (D, U, r, -ub, ub, st_l.z_adm, st_l.y_adm,
                             adapt._replace(iters=7, abs_tol=0.0, rel_tol=0.0, polish=False))),
             ("warm_up", (De, Ue, re, -ub, ub, zero, zero, adapt._replace(polish=True))),
             ("ragged_3", tuple(a[..., :3] if torch.is_tensor(a) else a
                                for a in (D, U, r, -ub, ub, zero, zero, adapt)))]
    paths = []
    for tag, args in cases:
        paths.append(os.path.join(tmp, f"k4_{model}_{tag}.bin"))
        _write_admm(paths[-1], *args)
    return paths


@pytest.mark.parametrize("model", list(MODELS))
def test_k4_group_entry_equals_one_thread_solve_on_the_host(model, harness, tmp_path):
    """K4's kernel body (admm_solve_group: the group solve with zbase 0,
    lane i's bounds, x written from shared memory, the count from lane 0)
    gives the one-thread admm_box_solve's x, z, y and iteration counts bit
    for bit in float64 and float32, in the layout the shape takes on the card
    (U_j in shared memory at s=9, from global memory at s=15); the adaptive
    case's instances stop at different epochs."""
    paths = _k4_cases(model, str(tmp_path))
    lines = _run(harness, paths)
    s = MODELS[model]
    assert len(lines) == 2 * len(paths)
    assert all(f" k4 " in ln and f" s={s} USH={int(s == 9)}:" in ln for ln in lines), lines
    counts = {ln.split()[0]: re.search(r"iters (\d+)\.\.(\d+)", ln).groups() for ln in lines}
    if model == "go1":      # some instances stop at an epoch end, others run on
        adaptive = [v for k, v in counts.items() if k.endswith("_adaptive.bin")][0]
        assert int(adaptive[0]) < int(adaptive[1]) == 50
    assert [v for k, v in counts.items() if k.endswith("_no_check_7.bin")][0] == ("7", "7")


def _k5_cases(model, tmp):
    """K5's cases at ``model``'s shape: the lanes layout on the masked early
    (dead leading slots) and late windows; the standard layout, unmasked,
    with a per-lane warm-up mask (lane b's first b slots dead) on the late
    window and the early window's own mask; a ragged B of 3; the late window
    read through the strides of a lanes-layout storage."""
    c, _, st_e, st_l = _windows(model)
    paths = []
    for tag, st in (("early", st_e), ("late", st_l)):
        D, U, r = mhe_lanes._masked_system(c, st)
        paths.append(os.path.join(tmp, f"k5_{model}_lanes_{tag}.bin"))
        _write_tridiag(paths[-1], D, U, r)
        Dl, Ul, rl, valid = mhe_lanes.assemble_normal_equations(c, st)
        N, B = rl.shape[0], rl.shape[-1]
        D, U, r = (torch.movedim(a, -1, 1) for a in (Dl, Ul[:-1], rl))
        if tag == "late":
            valid = torch.arange(N)[:, None] >= torch.arange(B)[None, :]
        else:
            valid = valid[:, None].expand(N, B)
        paths.append(os.path.join(tmp, f"k5_{model}_standard_{tag}.bin"))
        _write_tridiag(paths[-1], D, U, r, valid)
    paths.append(os.path.join(tmp, f"k5_{model}_standard_ragged_3.bin"))
    _write_tridiag(paths[-1], D[:, :3], U[:, :3], r[:, :3], valid[:, :3])
    paths.append(os.path.join(tmp, f"k5_{model}_standard_lanes_storage.bin"))
    _write_tridiag(paths[-1], D, U, r, valid, storage="lanes")
    return paths


@pytest.mark.parametrize("model", list(MODELS))
def test_k5_group_equals_one_thread_solve_on_the_host(model, harness, tmp_path):
    """K5's group body gives the one-thread tridiag_body's x bit for bit in
    float64 and float32: on the lanes layout, and on the standard layout read
    in place through the strides of a (B,N,...) storage's (N,B,...) view, or
    of a lanes-layout storage's, with the warm-up mask applied at load
    (against tridiag_body after ops/tridiag.mask_system and the layout
    moves)."""
    paths = _k5_cases(model, str(tmp_path))
    lines = _run(harness, paths)
    s = MODELS[model]
    assert len(lines) == 2 * len(paths)
    assert all(f" s={s}:" in ln and " x 0 differ" in ln for ln in lines), lines
    for layout in ("lanes", "standard"):
        for typ in ("f32", "f64"):
            assert any(f" k5 {layout} {typ} s={s}:" in ln for ln in lines)


# ------------------------------------------- the plain versions against JAX


# the JAX kernels in interpret mode trace every slot of the window: the
# comparisons take its last CUT slots (a principal block of an SPD system is
# SPD) to stay within seconds
CUT = 3


@pytest.mark.parametrize("model", list(MODELS))
def test_k4_plain_matches_pallas_interpret_at_the_fleet_shape(model):
    """The plain K4 (what CPU tensors take and the card is held against) ==
    the Pallas ADMM kernel in interpret mode on the last slots of the bench
    fleet's late window at its state size, per-lane bounds, warm starts,
    fixed rho (tests/test_torch_admm.py holds adaptive rho at s=5): x, z, y
    to rtol/atol 1e-8 and equal iteration counts."""
    c, ub, _, st = _windows(model)
    D, U, r = mhe_lanes._masked_system(c, st)
    D, U, r, z0, y0 = (a[-CUT:, ..., :2].contiguous()
                       for a in (D, U[1:], r, st.z_adm, st.y_adm))
    U = U[1:].contiguous()
    lb, ubb = (-ub[:, :2]).numpy(), ub[:, :2].numpy()
    kw = dict(rho=0.1, iters=20, abs_tol=1e-3, rel_tol=1e-3, adaptive_rho=False)
    jres = jak.solve_box_lanes(*(jnp.asarray(a.numpy()) for a in (D, U, r)), lb, ubb,
                               jadmm.ADMMSettings(**kw), z0=jnp.asarray(z0.numpy()),
                               y0=jnp.asarray(y0.numpy()), interpret=True)
    tres = admm_kernel.solve_box_lanes(D, U, r, lb, ubb, admm.ADMMSettings(**kw), z0=z0, y0=y0,
                                       device="cpu")
    for f in ("x", "z", "y"):
        np.testing.assert_allclose(getattr(tres, f).numpy(), np.asarray(getattr(jres, f)),
                                   err_msg=f, **TOL)
    np.testing.assert_array_equal(tres.iters.numpy(), np.asarray(jres.iters))


@pytest.mark.parametrize("model", list(MODELS))
def test_k5_plain_matches_pallas_interpret_at_the_fleet_shape(model):
    """The plain K5 on both routes == the Pallas tridiagonal kernel in
    interpret mode (solve_lanes; solve_batched with a per-lane warm-up mask)
    on the last slots of the bench fleet's late window at its state size, to
    rtol/atol 1e-8."""
    c, _, _, st = _windows(model)
    D, U, r = mhe_lanes._masked_system(c, st)
    D, U, r = (a[-CUT:, ..., :3].contiguous() for a in (D, U[1:], r))
    U = U[1:].contiguous()
    want = jtk.solve_lanes(*(jnp.asarray(a.numpy()) for a in (D, U, r)), interpret=True)
    got = tridiag_kernel.solve_lanes(D, U, r, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    Dl, Ul, rl, _ = mhe_lanes.assemble_normal_equations(c, st)
    Ds, Us, rs = (torch.movedim(a[-CUT:, ..., :3], -1, 1) for a in (Dl, Ul, rl))
    Us = Us[:-1]
    valid = torch.arange(CUT)[:, None] >= torch.arange(3)[None, :]
    want = jtk.solve_batched(*(jnp.asarray(a.contiguous().numpy()) for a in (Ds, Us, rs)),
                             valid=jnp.asarray(valid.numpy()), interpret=True)
    got = tridiag_kernel.solve_batched(Ds, Us, rs, valid=valid, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[:1, 1].abs().max()) == 0.0 and float(got[:2, 2].abs().max()) == 0.0


# ------------------------------------------------------------------- F8


def _nan_window():
    """A random SPD window (lanes layout, s=9, N=3, B=2) whose instance 1
    has one NaN entry in a diagonal block."""
    rng = np.random.default_rng(8)
    D, U, r = (np.ascontiguousarray(np.moveaxis(a, 1, -1)) for a in _spd(rng, 3, 2, 9, 0.1))
    D[1, 2, 2, 1] = np.nan
    return D, U, r


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_f8_nan_window_runs_every_iteration(adaptive, harness, tmp_path):
    """Fault F8, repaired: the residual maxima keep a NaN, as jnp.max and
    torch.amax do. On a window with one non-finite entry the plain K4, the
    JAX kernel (interpret mode) and the host harness's group (K4's entry)
    and one-thread bodies report the same iteration counts: every iteration
    on the non-finite instance, fewer on the finite one."""
    D, U, r = _nan_window()
    kw = dict(rho=2.0, iters=20, abs_tol=1e-3, rel_tol=1e-3, adaptive_rho=adaptive)
    ub = np.full(9, 0.3)
    jres = jak.solve_box_lanes(*map(jnp.asarray, (D, U, r)), -ub, ub,
                               jadmm.ADMMSettings(**kw), interpret=True)
    T = torch.as_tensor
    tres = admm.solve_box_tridiag_lanes(T(D), T(U), T(r), -ub, ub, admm.ADMMSettings(**kw))
    counts = [int(k) for k in tres.iters]
    np.testing.assert_array_equal(np.asarray(jres.iters), counts)
    assert counts[1] == 20 and counts[0] < 20
    assert bool(torch.isnan(tres.x[..., 1]).any()) and bool(torch.isfinite(tres.x[..., 0]).all())
    path = str(tmp_path / "f8.bin")
    st = ADMMCoreStatic.from_settings(admm.ADMMSettings(**kw), 3, 9)
    s, B = 9, 2
    bound = torch.full((s, B), 0.3, dtype=F64)
    _write_admm(path, T(D), T(U), T(r), -bound, bound, T(np.zeros_like(r)),
                T(np.zeros_like(r)), st)
    lines = _run(harness, [path])      # float64, then float32
    assert len(lines) == 2 and all(" iters 0 differ" in ln for ln in lines), lines
    host = [[int(k) for k in re.search(r"\[([\d,]+)\]", ln).group(1).split(",")]
            for ln in lines]
    assert host[0] == counts and host[1][1] == 20, lines
