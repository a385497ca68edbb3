"""Binary data logger + reader, wire-compatible with the reference's C7.

The reference's `Data_Logger` (src/decentral_legged_est/include/
decentral_legged_est/data_logger.hpp:36-326) registers raw pointers once and,
per tick, appends little-endian binary values to ``<name>_Data`` while a
``<name>_Name.csv`` schema file records ``name,type,length,`` rows. Existing
offline MATLAB/numpy tooling that parses those files works unchanged on logs
written here, and logs recorded by the C++ stack load with ``read_log``.

Type encodings (data_logger.hpp:253-295 log() overloads):
    double      -> float64 ×1
    int         -> float32 ×1   (sic — the reference casts int to float)
    VectorXd    -> float64 ×len
    VectorXf    -> float32 ×len
    VectorXi    -> float32 ×len (cast)
    Quaterniond -> float64 ×4 in (w, x, y, z) order (spin_logging :232-239)
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

_DTYPES = {
    "double": ("<f8", 1),
    "int": ("<f4", 1),
    "VectorXd": ("<f8", None),
    "VectorXf": ("<f4", None),
    "VectorXi": ("<f4", None),
    "Quaterniond": ("<f8", 4),
}


class DataLogger:
    """Schema-on-registration, append-per-tick binary logger.

    Functional-style usage (the carry is explicit in this framework, so the
    reference's pointer registration becomes named channels):

        logger = DataLogger("go1", log_dir)
        logger.add_channel("pose", "VectorXd", 3)
        logger.add_channel("v_body", "VectorXd", 3)
        ...
        logger.log_tick({"pose": p, "v_body": v})   # per tick
        logger.close()
    """

    def __init__(self, name: str, log_dir: str | None = None):
        log_dir = log_dir or os.path.join(os.path.expanduser("~"), "log_exp")
        os.makedirs(log_dir, exist_ok=True)
        self.name = name
        self._data_path = os.path.join(log_dir, f"{name}_Data")
        self._schema_path = os.path.join(log_dir, f"{name}_Name.csv")
        self._data_file = open(self._data_path, "wb")
        self._schema_file = open(self._schema_path, "w")
        self._channels: List[Tuple[str, str, int]] = []

    def add_channel(self, name: str, ctype: str = "VectorXd", length: int = 1):
        if ctype not in _DTYPES:
            raise ValueError(f"unknown channel type {ctype}")
        fixed = _DTYPES[ctype][1]
        if fixed is not None:
            length = fixed
        self._channels.append((name, ctype, length))
        # schema row format: "name,type,length,\n" (data_logger.hpp:80-83)
        self._schema_file.write(f"{name},{ctype},{length},\n")
        self._schema_file.flush()

    def log_tick(self, values: Dict[str, np.ndarray]):
        for name, ctype, length in self._channels:
            v = np.asarray(values[name])
            dt = _DTYPES[ctype][0]
            flat = v.astype(np.dtype(dt)).ravel()
            if flat.size != length:
                raise ValueError(
                    f"channel {name}: got {flat.size} values, expected {length}"
                )
            self._data_file.write(flat.tobytes())

    def log_sequence(self, sequences: Dict[str, np.ndarray]):
        """Write a whole replay at once: arrays shaped (T, length)."""
        T = np.atleast_2d(next(iter(sequences.values()))).shape[0]
        cols = []
        for name, ctype, length in self._channels:
            dt = np.dtype(_DTYPES[ctype][0])
            v = np.ascontiguousarray(
                np.asarray(sequences[name]).reshape(T, length).astype(dt)
            )
            cols.append(v.view(np.uint8).reshape(T, -1))
        self._data_file.write(np.concatenate(cols, axis=1).tobytes())

    def close(self):
        self._data_file.close()
        self._schema_file.close()


def read_schema(schema_path: str) -> List[Tuple[str, str, int]]:
    out = []
    with open(schema_path) as f:
        for line in f:
            parts = [p for p in line.strip().split(",") if p != ""]
            if len(parts) >= 3:
                out.append((parts[0], parts[1], int(parts[2])))
    return out


def read_log(path_prefix: str) -> Dict[str, np.ndarray]:
    """Load ``<prefix>_Data`` + ``<prefix>_Name.csv`` into (T, len) arrays.

    Works on logs from this logger and from the reference C++ stack.
    """
    schema = read_schema(path_prefix + "_Name.csv")
    raw = np.fromfile(path_prefix + "_Data", dtype=np.uint8)
    # one tick = concatenation of channels in registration order
    rec = []
    for name, ctype, length in schema:
        dt = np.dtype(_DTYPES[ctype][0])
        rec.append((name, ctype, length, dt))
    tick_bytes = sum(length * dt.itemsize for _, _, length, dt in rec)
    T = len(raw) // tick_bytes
    grid = raw[: T * tick_bytes].reshape(T, tick_bytes)
    out: Dict[str, np.ndarray] = {}
    offset = 0
    for name, ctype, length, dt in rec:
        nbytes = length * dt.itemsize
        block = np.ascontiguousarray(grid[:, offset:offset + nbytes])
        out[name] = block.view(dt).reshape(T, length).astype(np.float64)
        offset += nbytes
    return out
