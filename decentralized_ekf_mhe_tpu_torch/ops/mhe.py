"""Moving Horizon Estimator — static constants.

Counterpart of the reference ``ops/mhe.py``. The lanes fleet path
(ops/mhe_lanes.py) only needs the constants from it: ``MHEConsts``,
``make_consts`` and ``_params_view``. The standard-layout window engine
(``MHEState``/``init``/``step``/``solve_window`` on (..., N, s, s) tensors) is
not ported yet: ROADMAP.md, "KF baseline and single-instance paths".
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from decentralized_ekf_mhe_tpu_torch.config import EstimatorParams, std_to_gain
from decentralized_ekf_mhe_tpu_torch.ops import assembly
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device


class MHEConsts(NamedTuple):
    nc: assembly.NoiseConsts
    A_meas: torch.Tensor   # (m,s)
    P_cam: torch.Tensor    # (3,s) position selector [I 0 …]
    Q_vo_p: torch.Tensor   # (3,3)
    N: int
    dim_state: int
    dim_meas: int
    dt: float
    leg_odom_type: int
    num_legs: int
    # state box constraints. None ⇒ unconstrained (exact tridiagonal solve);
    # set ⇒ the OSQP-semantics ADMM path (ops/admm.py) with the given budget
    x_lb: object = None       # (s,) or (s,B) tensor, or None
    x_ub: object = None
    admm: object = None       # admm.ADMMSettings or None
    # route the window solve through the hand-written kernels
    # (kernels/tridiag_kernel.py, or kernels/admm_kernel.py when constrained)
    # — the field keeps the reference's name so call sites read the same on
    # both sides
    use_pallas: bool = False


def make_consts(p: EstimatorParams, dtype=torch.float32,
                x_lb=None, x_ub=None, admm_iters=None,
                use_pallas: bool = False, device="cuda") -> MHEConsts:
    """Build static MHE constants on ``device``. Passing x_lb/x_ub ((s,)
    shared or (s,B) per-lane arrays; ±inf for unconstrained dims; a missing
    side is filled with ∓inf) switches the window solve to the ADMM path with
    the OSQP settings of ``p.osqp`` and a fixed iteration budget
    ``admm_iters`` (default min(maxQPIter, 200))."""
    from decentralized_ekf_mhe_tpu_torch.ops import admm as admm_lib

    device = resolve_device(device)
    s = p.dim_state
    P = np.zeros((3, s))
    P[:, :3] = np.eye(3)
    constrained = x_lb is not None or x_ub is not None

    def f(a):
        if isinstance(a, torch.Tensor):
            return a.to(dtype=dtype, device=device)
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            dtype=dtype, device=device)

    return MHEConsts(
        nc=assembly.make_noise_consts(p, dtype, device=device),
        A_meas=assembly.a_meas(p, dtype, device=device),
        P_cam=f(P),
        Q_vo_p=f(std_to_gain(p.vo_p_std)),
        N=p.N,
        dim_state=s,
        dim_meas=p.dim_meas,
        dt=p.dt,
        leg_odom_type=p.leg_odom_type,
        num_legs=p.num_legs,
        x_lb=f(x_lb if x_lb is not None else np.full(s, -np.inf))
        if constrained else None,
        x_ub=f(x_ub if x_ub is not None else np.full(s, np.inf))
        if constrained else None,
        admm=admm_lib.ADMMSettings.from_osqp(p.osqp, admm_iters)
        if constrained else None,
        use_pallas=use_pallas,
    )


def _params_view(c: MHEConsts) -> EstimatorParams:
    """Static params needed by the assembly functions."""
    p = EstimatorParams()
    p.num_legs = c.num_legs
    p.leg_odom_type = c.leg_odom_type
    p.rate = int(round(1.0 / c.dt))
    return p
