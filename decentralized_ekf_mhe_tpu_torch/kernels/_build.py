"""Builds the CUDA sources of ``csrc/`` with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and
becomes its own shared library ``build/<hash>/lib<name>.so``, where ``<hash>``
covers every file under ``csrc/``, the compiler flags and the translation
units. A library is linked from one or more translation units (``UNITS``):
``csrc/mhe.cu`` is compiled once per instantiation of its kernel body, because
one nvcc process would spend minutes on all of them in a row. Every unit of
every library is compiled at once, one nvcc process each, at first use;
nothing is built when the package is imported. A failed build raises with
nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]


def _mhe_unit(pi, con, real):
    tag = {"float": "f32", "double": "f64"}[real]
    sym = "dem_mhe_unit" + ("_pi" if pi else "") + ("_box" if con else "") + "_" + tag
    return ("mhe", (f"-DDEM_MHE_UNIT={sym}", f"-DDEM_MHE_REAL={real}",
                    f"-DDEM_MHE_CON={con}", f"-DDEM_MHE_PI={pi}"))


# library -> its translation units (source, extra nvcc flags); csrc/mhe.cu:
# its entry points, then one unit per (per-lane clock, constrained, type)
UNITS = {
    "tridiag": (("tridiag", ()),),
    "ekf": (("ekf", ()),),
    "mhe": (("mhe", ()),) + tuple(_mhe_unit(pi, con, real) for pi in (0, 1)
                                  for con in (0, 1) for real in ("float", "double")),
    "admm": (("admm", ()),),
}
SOURCES = tuple(UNITS)

_c_int, _c_void_p = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = {
    "tridiag": ("dem_tridiag_solve",
                [_c_int, _c_int] + [_c_void_p] * 6 + [_c_int] * 3 + [_c_void_p]),
    "ekf": ("dem_ekf_stage",
            [_c_int, _c_void_p, _c_void_p] + [_c_int] * 8 + [_c_void_p]),
    # is_double, con, pi, S, M, L, lot, ptrs, nptrs, consts, ints, reals, N, B,
    # Tn, t0, block, stream: one entry point for the four tick kernels
    "mhe": ("dem_mhe_tick",
            [_c_int] * 7 + [_c_void_p, _c_int] + [_c_void_p] * 3 + [_c_int] * 5
            + [_c_void_p]),
    "admm": ("dem_admm_solve",
             [_c_int, _c_int, _c_void_p, _c_int, _c_void_p, _c_void_p]
             + [_c_int] * 3 + [_c_void_p]),
}

_libs: dict = {}


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


def _run_all(cmds, verbose):
    """Run the nvcc commands at once; raise with the output of those that
    failed. ``verbose`` prints what each printed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
        elif verbose and out:
            print(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build(verbose: bool = False, extra_flags=(), sources=SOURCES) -> str:
    """Compile every library of ``sources`` that is not built yet: all their
    translation units at once into objects, then one link per library;
    returns the build dir. ``extra_flags`` are further nvcc flags; such a
    variant gets a build dir of its own."""
    flags = NVCC_FLAGS + list(extra_flags)
    out_dir = os.path.join(BUILD_ROOT, _source_hash() + "".join(extra_flags))
    os.makedirs(out_dir, exist_ok=True)
    todo = [n for n in sources
            if not os.path.exists(os.path.join(out_dir, f"lib{n}.so"))]
    if not todo:
        return out_dir
    nvcc = _nvcc()
    obj_dir = os.path.join(out_dir, f"obj.{os.getpid()}")
    os.makedirs(obj_dir, exist_ok=True)
    try:
        objs, compiles = {}, []
        for n in todo:
            objs[n] = []
            for k, (src, defs) in enumerate(UNITS[n]):
                obj = os.path.join(obj_dir, f"{n}.{k}.o")
                objs[n].append(obj)
                compiles.append([nvcc] + flags + list(defs)
                                + (["-Xptxas", "-v"] if verbose else [])
                                + ["-c", "-o", obj, os.path.join(CSRC, f"{src}.cu")])
        _run_all(compiles, verbose)
        tmp = {n: os.path.join(obj_dir, f"lib{n}.so") for n in todo}
        _run_all([[nvcc] + flags + ["-shared", "-o", tmp[n]] + objs[n]
                  for n in todo], verbose=False)
        for n in todo:
            os.replace(tmp[n], os.path.join(out_dir, f"lib{n}.so"))
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    return out_dir


def load(name: str, extra_flags=()):
    """The C entry point of ``csrc/<name>.cu`` with its argtypes set. The
    wrappers load the standard build; ``extra_flags`` gives the entry point
    of a variant build (see ``build``) to a caller that compares two builds."""
    key = name if not extra_flags else (name,) + tuple(extra_flags)
    if key not in _libs:
        out_dir = (build(extra_flags=extra_flags, sources=(name,))
                   if extra_flags else build())
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        fn_name, argtypes = _ARGTYPES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[key] = fn
    return _libs[key]


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
            f"{what}: this shape is not instantiated in the CUDA build "
            "(only Go1: s=9, m=12, L=4, leg_odom_type=0); see ROADMAP.md, "
            "'Cassie/PogoX shapes'")
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
