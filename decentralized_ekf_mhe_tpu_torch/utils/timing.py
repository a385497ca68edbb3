"""Timing probes: tic/toc scoped timers and ``torch.profiler`` integration.

Counterpart of the reference ``utils/timing.py``. The reference instruments
with static-timepoint tic/toc pairs duplicated in two classes
(MheSrb.cpp:763-777, DecentralEst.cpp:1031-1044), a per-callback rate print
(EstSub.cpp:88-90) and microsecond probes around the VO replay
(orien_ekf.cpp:167-210). Equivalents here:

- ``tic/toc`` / ``scoped_timer``: host-side wall timers for the replay driver
  (same "<name> elapsed time: ... seconds" report format);
- ``device_sync``: a completion fence — ``torch.cuda.synchronize()`` where
  CUDA is up, then a host read of the value (a CUDA launch returns before the
  device finishes);
- ``trace``: context manager around ``torch.profiler`` (CPU and, where
  available, CUDA activities) that exports a Chrome trace into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

_TIC_STACK: Dict[str, float] = {}


def tic(name: str = ""):
    _TIC_STACK[name] = time.perf_counter()


def toc(name: str = "", quiet: bool = False) -> float:
    elapsed = time.perf_counter() - _TIC_STACK.get(name, time.perf_counter())
    if not quiet:
        print(f"{name} elapsed time: {elapsed} seconds")
    return elapsed


@contextlib.contextmanager
def scoped_timer(name: str, results: dict | None = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = dt
    else:
        print(f"{name} elapsed time: {dt} seconds")


def device_sync(val) -> float:
    """Force completion of a device value; returns a scalar host float."""
    t = torch.as_tensor(val)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return float(t.reshape(-1)[0])


@contextlib.contextmanager
def trace(log_dir: str = "trace"):
    """``torch.profiler`` scope over CPU and, where CUDA is up, CUDA
    activities; writes ``log_dir/trace.json`` (Chrome trace format) on exit
    and yields the profiler (``key_averages()`` for sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def rate_probe(fn, *args, reps: int = 3, sync=device_sync):
    """Return (best wall seconds, result) over reps calls with a hard fence —
    the EstSub.cpp:88-90 cycle-rate probe generalized."""
    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        sync(out[0] if isinstance(out, tuple) else out)
        best = min(best, time.perf_counter() - t0)
    return best, out
