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
    # state box constraints: always None in this port so far (the box-ADMM
    # path is not ported; make_consts raises when bounds are passed)
    x_lb: object = None
    x_ub: object = None
    admm: object = None
    # route the window solve through the hand-written block-tridiagonal
    # kernel (kernels/tridiag_kernel.py) — the field keeps the reference's
    # name so call sites read the same on both sides
    use_pallas: bool = False


def make_consts(p: EstimatorParams, dtype=torch.float32,
                x_lb=None, x_ub=None, admm_iters=None,
                use_pallas: bool = False, device="cuda") -> MHEConsts:
    """Build static MHE constants on ``device``. State box constraints
    (``x_lb``/``x_ub``) select the OSQP-semantics ADMM solve in the reference;
    that path is not ported yet."""
    if x_lb is not None or x_ub is not None or admm_iters is not None:
        raise NotImplementedError(
            "state box constraints (ADMM window solve) are not ported yet: "
            "ROADMAP.md, 'constrained ADMM'")
    device = resolve_device(device)
    s = p.dim_state
    P = np.zeros((3, s))
    P[:, :3] = np.eye(3)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
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
        use_pallas=use_pallas,
    )


def _params_view(c: MHEConsts) -> EstimatorParams:
    """Static params needed by the assembly functions."""
    p = EstimatorParams()
    p.num_legs = c.num_legs
    p.leg_odom_type = c.leg_odom_type
    p.rate = int(round(1.0 / c.dt))
    return p
