"""ctypes bindings for the native runtime library (native/dem_native.cpp).

The C++ library supplies the host-side runtime paths (log codec, alignment
core, block feeder) as first-class native components — the framework's
counterpart to the reference's C++ runtime layer. Every entry point has a
pure-numpy fallback in io/, so the package works without the build; when
``native/build/libdem_native.so`` exists (``sh native/build.sh``), io/replay
and io/logger route their hot loops through it automatically.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_TYPE_CODES = {"double": 0, "int": 1, "VectorXd": 2, "VectorXf": 3,
               "VectorXi": 4, "Quaterniond": 5}
_ELEM_BYTES = {"double": 8, "int": 4, "VectorXd": 8, "VectorXf": 4,
               "VectorXi": 4, "Quaterniond": 8}


def _lib_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "native", "build", "libdem_native.so")


def load() -> Optional[ctypes.CDLL]:
    """Load (once) the native library; None if not built."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int64)
    lib.dem_latest_index.argtypes = [c_dp, ctypes.c_int64, c_dp,
                                     ctypes.c_int64, c_ip]
    lib.dem_upper_bound_sync.argtypes = [c_dp, ctypes.c_int64, c_dp,
                                         ctypes.c_int64, c_ip]
    lib.dem_gather_rows.argtypes = [c_dp, ctypes.c_int64, ctypes.c_int64,
                                    c_ip, ctypes.c_int64, c_dp]
    lib.dem_logger_open.restype = ctypes.c_void_p
    lib.dem_logger_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.dem_logger_add_channel.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_int, ctypes.c_int]
    lib.dem_logger_log_tick.argtypes = [ctypes.c_void_p, c_dp]
    lib.dem_logger_log_sequence.argtypes = [ctypes.c_void_p, c_dp,
                                            ctypes.c_int64, ctypes.c_int64]
    lib.dem_logger_close.argtypes = [ctypes.c_void_p]
    lib.dem_log_decode.restype = ctypes.c_int64
    lib.dem_log_decode.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.c_int, c_dp, ctypes.c_int64]
    lib.dem_feeder_create.restype = ctypes.c_void_p
    lib.dem_feeder_create.argtypes = [c_dp, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64]
    lib.dem_feeder_next.restype = c_dp
    lib.dem_feeder_next.argtypes = [ctypes.c_void_p, c_ip]
    lib.dem_feeder_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return load() is not None


def _as_c(a: np.ndarray, dtype):
    a = np.ascontiguousarray(a, dtype=dtype)
    return a, a.ctypes.data_as(
        ctypes.POINTER(ctypes.c_double if dtype == np.float64 else ctypes.c_int64)
    )


def latest_index(stream_t: np.ndarray, sample_t: np.ndarray) -> np.ndarray:
    lib = load()
    st, st_p = _as_c(stream_t, np.float64)
    sa, sa_p = _as_c(sample_t, np.float64)
    out = np.empty(len(sa), np.int64)
    lib.dem_latest_index(st_p, len(st), sa_p, len(sa),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def upper_bound_sync(tick_t: np.ndarray, stamps: np.ndarray) -> np.ndarray:
    lib = load()
    tt, tt_p = _as_c(tick_t, np.float64)
    ss, ss_p = _as_c(np.atleast_1d(stamps), np.float64)
    out = np.empty(len(ss), np.int64)
    lib.dem_upper_bound_sync(tt_p, len(tt), ss_p, len(ss),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    lib = load()
    s2 = np.ascontiguousarray(src, np.float64).reshape(src.shape[0], -1)
    ii = np.ascontiguousarray(idx, np.int64)
    out = np.empty((len(ii), s2.shape[1]), np.float64)
    lib.dem_gather_rows(
        s2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), s2.shape[0],
        s2.shape[1], ii.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(ii), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out.reshape((len(ii),) + src.shape[1:])


class NativeLogger:
    """Data_Logger-format writer backed by the C++ codec."""

    def __init__(self, name: str, log_dir: Optional[str] = None):
        lib = load()
        if lib is None:
            raise RuntimeError("native library not built (sh native/build.sh)")
        log_dir = log_dir or os.path.join(os.path.expanduser("~"), "log_exp")
        os.makedirs(log_dir, exist_ok=True)
        self._data_path = os.path.join(log_dir, f"{name}_Data")
        self._schema_path = os.path.join(log_dir, f"{name}_Name.csv")
        self._h = lib.dem_logger_open(self._data_path.encode(),
                                      self._schema_path.encode())
        if not self._h:
            raise OSError(f"cannot open {self._data_path}")
        self._lib = lib
        self._total = 0
        self._channels = []

    def add_channel(self, name: str, ctype: str = "VectorXd", length: int = 1):
        code = _TYPE_CODES[ctype]
        if ctype in ("double", "int"):
            length = 1
        if ctype == "Quaterniond":
            length = 4
        rc = self._lib.dem_logger_add_channel(self._h, name.encode(), code, length)
        if rc != 0:
            raise ValueError(f"bad channel {name}/{ctype}")
        self._channels.append((name, ctype, length))
        self._total += length

    def log_tick(self, values) -> None:
        flat = np.concatenate(
            [np.asarray(values[n], np.float64).ravel() for n, _, _ in self._channels]
        )
        assert flat.size == self._total
        self._lib.dem_logger_log_tick(
            self._h, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        )

    def log_sequence(self, sequences) -> None:
        T = np.atleast_2d(next(iter(sequences.values()))).shape[0]
        flat = np.concatenate(
            [np.asarray(sequences[n], np.float64).reshape(T, -1)
             for n, _, _ in self._channels], axis=1
        )
        flat = np.ascontiguousarray(flat)
        self._lib.dem_logger_log_sequence(
            self._h, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            T, self._total,
        )

    def close(self):
        if self._h:
            self._lib.dem_logger_close(self._h)
            self._h = None


def read_log(path_prefix: str) -> dict:
    """Native-decoded Data_Logger read (same output as io.logger.read_log)."""
    from decentralized_ekf_mhe_tpu_torch.io.logger import read_schema

    lib = load()
    schema = read_schema(path_prefix + "_Name.csv")
    n = len(schema)
    ebytes = (ctypes.c_int * n)(*[_ELEM_BYTES[t] for _, t, _ in schema])
    lens = (ctypes.c_int * n)(*[ln for _, _, ln in schema])
    total = sum(ln for _, _, ln in schema)
    size = os.path.getsize(path_prefix + "_Data")
    tick_bytes = sum(_ELEM_BYTES[t] * ln for _, t, ln in schema)
    max_ticks = size // tick_bytes
    out = np.empty((max_ticks, total), np.float64)
    T = lib.dem_log_decode(
        (path_prefix + "_Data").encode(), ebytes, lens, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_ticks,
    )
    result = {}
    off = 0
    for name, _, ln in schema:
        result[name] = out[:T, off:off + ln].copy()
        off += ln
    return result


class BlockFeeder:
    """Double-buffered tick-block server over an aligned log array."""

    def __init__(self, src: np.ndarray, block: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native library not built")
        self._src = np.ascontiguousarray(src, np.float64).reshape(src.shape[0], -1)
        self._shape_tail = src.shape[1:]
        self._lib = lib
        self._block = block
        self._h = lib.dem_feeder_create(
            self._src.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            self._src.shape[0], self._src.shape[1], block,
        )

    def next(self):
        n_valid = ctypes.c_int64()
        ptr = self._lib.dem_feeder_next(self._h, ctypes.byref(n_valid))
        width = self._src.shape[1]
        arr = np.ctypeslib.as_array(ptr, shape=(self._block, width))
        return arr.reshape((self._block,) + self._shape_tail), int(n_valid.value)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dem_feeder_destroy(self._h)
            self._h = None
