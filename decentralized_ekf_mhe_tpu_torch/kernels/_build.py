"""Builds the CUDA sources of ``csrc/`` with nvcc and loads them with ctypes.

Each ``csrc/<source>.cu`` has a plain C interface (no PyTorch headers) and
becomes one or more shared libraries ``build/<hash>/lib<name>.so``, where
``<hash>`` covers every file under ``csrc/``, the compiler flags and the
translation units. A library is linked from one or more translation units
(``UNITS``): ``csrc/mhe.cu`` is compiled once per instantiation of its kernel
body, because one nvcc process would spend minutes on all of them in a row,
and each model shape of ``MHE_SHAPES`` has one library per variant group of
``MHE_GROUPS`` (``libmhe_go1.so``: the shared camera clock,
``libmhe_go1_pi.so``: a clock per lane, ``libmhe_go1_chol.so``: the Cholesky
tail on either clock; and the stage ablation, a library per variant and type,
``libmhe_go1_abl_f32.so`` and ``_f64``, ``_abl_pi_*``, ``_abl_chol_*``,
``_abl_pi_chol_*``, ``_abl_box_*`` and ``_abl_pi_box_*`` (``MHE_ABL_GROUPS``);
likewise ``cassie`` and ``pogox``), so a fleet builds only what it launches;
likewise ``csrc/tridiag.cu`` and
``csrc/admm.cu`` are one library per state size (``libtridiag_s9.so``,
``libadmm_s15.so``, ...). ``load`` builds a library at its first use, all its
units at once, one nvcc process each; ``build`` builds several libraries that
way together.
Nothing is built when the package is imported. A failed build raises with
nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]


# The model shapes the MHE tick is instantiated for: tag -> (s, m, L,
# leg_odom_type). Go1 (the fleet of the reference's bench), Cassie (foot
# positions as states) and PogoX (one leg).
MHE_SHAPES = {
    "go1": (9, 12, 4, 0),
    "cassie": (15, 6, 2, 1),
    "pogox": (9, 3, 1, 0),
}
# The tick's variant groups, one library each per shape (mhe_<tag>,
# mhe_<tag>_pi, mhe_<tag>_chol): group -> the (per-lane clock, constrained,
# Cholesky tail) variants of its units, each for float and double. The
# Cholesky tail exists unconstrained only, on either clock: the constrained
# tick solves its window with the box-ADMM.
MHE_GROUPS = {
    "": ((0, 0, 0), (0, 1, 0)),
    "pi": ((1, 0, 0), (1, 1, 0)),
    "chol": ((0, 0, 1), (1, 0, 1)),
}
# The stage ablation of the tick (a timing diagnostic: tools/roofline.py
# --ablate), stage k + 1 of csrc/mhe_body.cuh's ABL for ABLATE_STAGES[k], at
# every shape: group -> the (per-lane clock, constrained, Cholesky tail)
# variant of its units and the stages it has, one library
# mhe_<tag>_<group>_<f32|f64> per shape and type (a timing run launches the
# float32 units, a check against the plain version the float64 ones; each
# builds only its own). The Cholesky tick's assembly and solve stages
# never reach the tail: they are the Gauss-Jordan tick's units
# (TAIL_FREE_STAGES); the constrained tick has no solve stage (its window
# solve is the ADMM, which the reference's stage sum never reaches).
ABLATE_STAGES = ("ingest", "marg", "build", "assembly", "solve")
TAIL_FREE_STAGES = ("assembly", "solve")
MHE_ABL_GROUPS = {
    "abl": ((0, 0, 0), ABLATE_STAGES),
    "abl_pi": ((1, 0, 0), ABLATE_STAGES),
    "abl_chol": ((0, 0, 1), ABLATE_STAGES[:3]),
    "abl_pi_chol": ((1, 0, 1), ABLATE_STAGES[:3]),
    "abl_box": ((0, 1, 0), ABLATE_STAGES[:4]),
    "abl_pi_box": ((1, 1, 0), ABLATE_STAGES[:4]),
}


def _unroll(S):
    """nvcc flags of a unit at state size S: above s=12 the long loops of
    csrc/smallmat.cuh stay rolled (DEM_MAX_UNROLL, see there)."""
    return ("-DDEM_MAX_UNROLL=256",) if S > 12 else ()


SOLVE_SIZES = (9, 15)   # state sizes of the tridiagonal solve and the box-ADMM


def solve_library(source, S):
    """The library of ``csrc/<source>.cu`` (tridiag or admm) at state size S;
    raises NotImplementedError for a size the build does not instantiate."""
    if S not in SOLVE_SIZES:
        raise NotImplementedError(
            f"{source}: no CUDA instantiation for s={S} (sizes {SOLVE_SIZES}); see "
            "ROADMAP.md, 'What is left to port'")
    return f"{source}_s{S}"


def mhe_library(S, M, L, lot, group=""):
    """The library that holds the MHE tick of this shape and variant group
    (a key of ``MHE_GROUPS``), or None for a shape without one."""
    for tag, shape in MHE_SHAPES.items():
        if shape == (S, M, L, lot):
            return "mhe_" + tag + ("_" + group if group else "")
    return None


def _mhe_shape_flags(tag):
    S, M, L, lot = MHE_SHAPES[tag]
    return (f"-DDEM_MHE_SHAPE={tag}", f"-DDEM_MHE_S={S}", f"-DDEM_MHE_M={M}",
            f"-DDEM_MHE_L={L}", f"-DDEM_MHE_LOT={lot}") + _unroll(S)


def _mhe_unit(tag, suffix, real, con, pi, extra=()):
    sym = f"dem_mhe_unit_{tag}{suffix}_" + {"float": "f32", "double": "f64"}[real]
    return ("mhe", _mhe_shape_flags(tag) + (
        f"-DDEM_MHE_UNIT={sym}", f"-DDEM_MHE_REAL={real}", f"-DDEM_MHE_CON={con}",
        f"-DDEM_MHE_PI={pi}") + extra)


def _variant_suffix(pi, con, chol):
    return ("_pi" if pi else "") + ("_box" if con else "") + ("_chol" if chol else "")


def _mhe_units(tag, group):
    """csrc/mhe.cu for one shape and variant group: its entry point, then one
    unit per variant of the group and type."""
    units = [("mhe", _mhe_shape_flags(tag))]
    for pi, con, chol in MHE_GROUPS[group]:
        for real in ("float", "double"):
            units.append(_mhe_unit(tag, _variant_suffix(pi, con, chol), real, con, pi,
                                   ("-DDEM_MHE_CHOL=1",) if chol else ()))
    return tuple(units)


REALS = {"f32": "float", "f64": "double"}


def _mhe_abl_units(tag, group, typ):
    """csrc/mhe.cu's entry point, then the unit of each stage of ablation
    group ``group`` in type ``typ`` ("f32", "f64"; symbol suffix
    ``<variant>_abl<k>``, k = 1..5 as in ``ABLATE_STAGES``)."""
    (pi, con, chol), stages = MHE_ABL_GROUPS[group]
    return (("mhe", _mhe_shape_flags(tag)),) + tuple(
        _mhe_unit(tag, f"{_variant_suffix(pi, con, chol)}_abl{k}", REALS[typ], con, pi,
                  (("-DDEM_MHE_CHOL=1",) if chol else ()) + (f"-DDEM_MHE_ABL={k}",))
        for k in (ABLATE_STAGES.index(st) + 1 for st in stages))


# library -> its translation units (source, extra nvcc flags)
UNITS = {
    **{f"tridiag_s{S}": (("tridiag", (f"-DDEM_TRIDIAG_S={S}",) + _unroll(S)),)
       for S in SOLVE_SIZES},
    "ekf": (("ekf", ()),),
    **{mhe_library(*shape, group): _mhe_units(tag, group)
       for tag, shape in MHE_SHAPES.items() for group in MHE_GROUPS},
    **{f"mhe_{tag}_{group}_{typ}": _mhe_abl_units(tag, group, typ)
       for tag in MHE_SHAPES for group in MHE_ABL_GROUPS for typ in REALS},
    **{f"admm_s{S}": (("admm", (f"-DDEM_ADMM_S={S}",) + _unroll(S)),) for S in SOLVE_SIZES},
}
LIBRARIES = tuple(UNITS)
SOURCES = ("tridiag", "ekf", "mhe", "admm")   # csrc/<source>.cu

_c_int, _c_void_p = ctypes.c_int, ctypes.c_void_p
# by source: every mhe_<shape> library has the entry point of csrc/mhe.cu
_ARGTYPES = {
    # is_double, S, std_layout, D, U, r, valid, strides, x, N, B, block, stream
    "tridiag": ("dem_tridiag_solve",
                [_c_int] * 3 + [_c_void_p] * 6 + [_c_int] * 3 + [_c_void_p]),
    "ekf": ("dem_ekf_stage",
            [_c_int, _c_void_p, _c_void_p] + [_c_int] * 8 + [_c_void_p]),
    # is_double, con, pi, chol, ablate, S, M, L, lot, ptrs, nptrs, consts, ints,
    # reals, N, B, Tn, t0, block, stream: one entry point for every tick kernel
    "mhe": ("dem_mhe_tick",
            [_c_int] * 9 + [_c_void_p, _c_int] + [_c_void_p] * 3 + [_c_int] * 5
            + [_c_void_p]),
    "admm": ("dem_admm_solve",
             [_c_int, _c_int, _c_void_p, _c_int, _c_void_p, _c_void_p]
             + [_c_int] * 3 + [_c_void_p]),
}

# the nvcc processes that run at once, over every build of the process (each
# unit's compile is one single-threaded process; more of them than cores only
# crowd the host): ``limit_jobs`` sets it
_jobs = threading.BoundedSemaphore(os.cpu_count() or 8)


def limit_jobs(n: int) -> None:
    """Run at most ``n`` nvcc processes at once from now on (default: one per
    core), e.g. to leave cores to a program that builds beside its work."""
    global _jobs
    _jobs = threading.BoundedSemaphore(max(1, int(n)))


_libs: dict = {}
# what the last build of each library took: {name (and its extra flags):
# {"seconds": wall seconds until its link ended, "units": [(flags, compiler
# output, seconds until that unit compiled), ...]}}; with ``ptxas`` the output
# holds ptxas' register and spill report
report: dict = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of this package are built from "
            "source at first use and need the CUDA toolkit")
    return exe


def _source_hash() -> str:
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(UNITS)).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def _run_all(cmds, nice=0):
    """Run the nvcc commands at once, as far as ``limit_jobs`` lets them (at
    scheduling priority ``nice``); raise with the output of those that
    failed. Returns each command's (output, time.time() when it ended)."""
    def run(cmd):
        prio = ["nice", "-n", str(nice)] if nice and shutil.which("nice") else []
        with _jobs:
            r = subprocess.run(prio + cmd,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return r.returncode, r.stdout, time.time()

    with ThreadPoolExecutor(max_workers=max(1, len(cmds))) as pool:
        results = list(pool.map(run, cmds))
    failed = [f"$ {' '.join(cmd)}\n{out}" for cmd, (rc, out, _) in zip(cmds, results) if rc]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return [(out, end) for _, out, end in results]


def build(extra_flags=(), libraries=LIBRARIES, ptxas=False, nice=0) -> str:
    """Compile every library of ``libraries`` that is not built yet: all their
    translation units at once into objects, then one link per library;
    returns the build dir. ``extra_flags`` are further nvcc flags; such a
    variant gets a build dir of its own. ``ptxas`` asks ptxas for its
    register and spill report, which lands in ``report`` with the compilers'
    other output. ``nice`` lowers the compilers' scheduling priority, for a
    build that runs beside other work; several builds may run at once."""
    flags = NVCC_FLAGS + list(extra_flags)
    out_dir = os.path.join(BUILD_ROOT, _source_hash() + "".join(extra_flags))
    os.makedirs(out_dir, exist_ok=True)
    todo = [n for n in libraries
            if not os.path.exists(os.path.join(out_dir, f"lib{n}.so"))]
    if not todo:
        return out_dir
    nvcc = _nvcc()
    obj_dir = tempfile.mkdtemp(prefix="obj.", dir=out_dir)
    t0 = time.time()
    try:
        objs, compiles, owner = {}, [], []
        for n in todo:
            objs[n] = []
            for k, (src, defs) in enumerate(UNITS[n]):
                obj = os.path.join(obj_dir, f"{n}.{k}.o")
                objs[n].append(obj)
                owner.append((n, defs))
                compiles.append([nvcc] + flags + list(defs)
                                + (["-Xptxas", "-v"] if ptxas else [])
                                + ["-c", "-o", obj, os.path.join(CSRC, f"{src}.cu")])
        outs = _run_all(compiles, nice)
        compiled = {n: max(end for (m, _), (_, end) in zip(owner, outs) if m == n)
                    for n in todo}
        tmp = {n: os.path.join(obj_dir, f"lib{n}.so") for n in todo}
        linked = _run_all([[nvcc] + flags + ["-shared", "-o", tmp[n]] + objs[n]
                           for n in todo], nice)
        for n, (_, end) in zip(todo, linked):
            os.replace(tmp[n], os.path.join(out_dir, f"lib{n}.so"))
            # this library's link ran after every unit had compiled: count
            # its own units' time and its own link
            report[" ".join((n,) + tuple(extra_flags))] = {
                "seconds": compiled[n] - t0 + (end - max(compiled.values())),
                "units": [(" ".join(d), out, done - t0) for (m, d), (out, done)
                          in zip(owner, outs) if m == n]}
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    return out_dir


def library(name: str, extra_flags=()):
    """Library ``name`` (a key of ``UNITS``) loaded with ctypes, built first
    if it is not yet; ``extra_flags`` as in ``build``."""
    key = name if not extra_flags else (name,) + tuple(extra_flags)
    if key not in _libs:
        out_dir = build(extra_flags=extra_flags, libraries=(name,))
        _libs[key] = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
    return _libs[key]


def load(name: str, extra_flags=()):
    """The C entry point of library ``name`` (a key of ``UNITS``) with its
    argtypes set, built first if it is not yet. The wrappers load the
    standard build; ``extra_flags`` gives the entry point of a variant build
    (see ``build``) to a caller that compares two builds."""
    fn_name, argtypes = _ARGTYPES[UNITS[name][0][0]]
    return entry(name, fn_name, argtypes, extra_flags)


def entry(name: str, fn_name: str, argtypes, extra_flags=()):
    """The C function ``fn_name`` of library ``name`` with these argtypes and
    an int result."""
    fn = getattr(library(name, extra_flags), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


class KernelTimer:
    """CUDA events around a wrapper's kernel call alone, so its time can be
    told apart from the wrapper's copies and allocations. Off by default;
    while ``on``, every launch adds one event pair."""

    def __init__(self):
        self.on = False
        self._events = []

    def record(self, stream):
        """Record an event on ``stream`` if the timer is on (called right
        before and right after the kernel call)."""
        if self.on:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            self._events.append(ev)

    def ms(self):
        """Device times of the launches recorded so far, then forget them."""
        ev, self._events = self._events, []
        if ev:
            ev[-1].synchronize()
        return [a.elapsed_time(b) for a, b in zip(ev[::2], ev[1::2])]


def check_launch(err: int, what: str) -> None:
    """Raise on the launcher's return value (cudaGetLastError, or -1 for a
    shape the build does not instantiate)."""
    if err == -1:
        raise NotImplementedError(
            f"{what}: this shape is not instantiated in the CUDA build (MHE tick: "
            + ", ".join(f"{t} s={v[0]}, m={v[1]}, L={v[2]}, leg_odom_type={v[3]}"
                        for t, v in MHE_SHAPES.items())
            + f"; the Cholesky tail: unconstrained only; box-ADMM and tridiagonal solve: "
            f"s in {SOLVE_SIZES}); see ROADMAP.md, 'What is left to port'")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed, cudaError {err}")


def require_lanes(name: str, t, shape, dtype, device) -> None:
    """Wrapper-side operand check: device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
