#!/usr/bin/env python3
"""How reproducible is a box-ADMM solve across devices and FMA contraction?

    python3 chip_admm_repro.py

Run from the repo root on a machine with one NVIDIA GPU and nvcc. On the
assembled MHE windows of ``chip_smoke.admm_cases`` (T=64, B=256, float64) it
solves every case four ways — the plain PyTorch version on the card, the same
code on the CPU, the ``admm_solve`` kernel as built, and the kernel built once
more with ``-fmad=false`` — and prints, per pair and per output x/z/y, the
largest absolute error, that error relative to the output's largest magnitude,
the largest error relative to rtol 1e-8/atol 1e-8, and the number of lanes
beyond that tolerance, with the iteration counts compared. It asserts nothing:
it shows which disagreement is the kernel's and which is the sensitivity of
adaptive-rho iterates to summation order.
"""

import ctypes
import json

import torch

import chip_smoke as cs
from decentralized_ekf_mhe_tpu_torch.kernels import _build, admm_kernel
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import admm


def launch(fn, D, U, r, lb, ub, settings, valid=None, z0=None, y0=None):
    """What ``admm_kernel.solve_box_lanes`` does around its launch, for the
    entry point ``fn`` of either build: (x, z, y, iters)."""
    N, s, _, B = D.shape
    lb, ub = admm.broadcast_bounds(lb, ub, s, B, D.dtype, D.device)
    if valid is not None:
        D, U, r = (a.contiguous() for a in admm.mask_system(D, U, r, valid))
    x = torch.empty_like(r)
    z = torch.zeros_like(r) if z0 is None else z0.clone()
    y = torch.zeros_like(r) if y0 is None else y0.clone()
    iters = torch.empty((B,), dtype=torch.int32, device=D.device)
    tensors = [D, U, r, lb, ub, x, z, y, iters, torch.empty_like(D), torch.empty_like(r)]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    ints, reals = admm_kernel.ADMMCoreStatic.from_settings(settings, N, s).pack()
    err = fn(int(D.dtype == torch.float64), s, ptrs, len(tensors), ints.ctypes.data,
             reals.ctypes.data, N, B, admm_kernel.BLOCK,
             torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "admm_solve")
    torch.cuda.synchronize()
    return admm.ADMMResult(x, z, y, None, None, iters)


def compare(a, b):
    out = {}
    for f in ("x", "z", "y"):
        A, Bt = getattr(a, f).cpu(), getattr(b, f).cpu()
        err = (A - Bt).abs()
        tol = 1e-8 + 1e-8 * Bt.abs()
        out[f] = {"max_abs_err": float(err.max()),
                  "max_err_over_max_abs": float(err.max() / Bt.abs().max()),
                  "max_err_over_tol": float((err / tol).max()),
                  "lanes_beyond_tol": int((err > tol).any(dim=0).any(dim=0).sum())}
    out["iters_equal"] = bool(torch.equal(a.iters.cpu(), b.iters.cpu()))
    return out


def main():
    kernels = {"kernel": _build.load("admm_s9"),
               "kernel_fmad_false": _build.load("admm_s9", extra_flags=("-fmad=false",))}
    _, _, c, c_pl, data_l, vo_b, vo_inc, ks0 = cs.box_small_setup()
    _, ks_k = mrk.replay_ticks(c, ks0, *cs.seg(data_l, vo_b, vo_inc, slice(1, None)),
                               device=cs.DEV)
    cpu = lambda a: a.cpu() if torch.is_tensor(a) else a
    for tag, args, kw in cs.admm_cases(c, c_pl, ks0, ks_k,
                                       cs.seg(data_l, vo_b, vo_inc, slice(1, 6))):
        on_card = admm_kernel.solve_box_lanes_plain(*args, **kw)
        on_cpu = admm.solve_box_tridiag_lanes(
            *(cpu(a) for a in args[:5]), args[5], **{k: cpu(v) for k, v in kw.items()})
        res = {"case": tag, "B": args[0].shape[-1],
               "iters": [int(on_card.iters.min()), int(on_card.iters.max())],
               "plain_card_vs_plain_cpu": compare(on_card, on_cpu)}
        for label, fn in kernels.items():
            k = launch(fn, *args, **kw)
            res[f"{label}_vs_plain_card"] = compare(k, on_card)
            res[f"{label}_vs_plain_cpu"] = compare(k, on_cpu)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
