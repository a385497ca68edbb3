"""Carry constants, state and inputs across from the JAX reference.

The estimator has no weights; what the two implementations must share is
constants, state and inputs. ``from_jax_numpy`` takes one of the reference's
NamedTuples whose leaves the CALLER has already turned into numpy arrays
(``jax.tree.map(np.asarray, obj)``) and returns this package's counterpart on
the requested device and dtype. Fields are matched by name, so this module
imports nothing of the reference and nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from decentralized_ekf_mhe_tpu_torch.ops import (admm, assembly, bezier, ekf, ekf_lanes, estimator,
                                                 mhe, mhe_lanes)


def _tensor(a, dtype, device):
    """numpy leaf -> tensor; floats take ``dtype``, ints int32, bools bool."""
    a = np.array(a)  # own, writable copy
    if a.dtype.kind == "f":
        return torch.as_tensor(a).to(dtype=dtype, device=device)
    if a.dtype.kind in "iu":
        return torch.as_tensor(a.astype(np.int32)).to(device)
    if a.dtype.kind == "b":
        return torch.as_tensor(a).to(device)
    raise TypeError(f"cannot convert leaf of dtype {a.dtype}")


def _is_empty(v):
    return v is None or (isinstance(v, tuple) and len(v) == 0)


def _fields(obj, cls, dtype, device, skip=()):
    return {f: _tensor(getattr(obj, f), dtype, device)
            for f in cls._fields if f not in skip}


def _bezier(obj, dtype, device):
    """Shared (times (4,), count 0-d) or per-instance (times (B,4), count
    (B,)) schedule; the layout carries over as it is."""
    return bezier.BezierCarry(**_fields(obj, bezier.BezierCarry, dtype, device))


def _admm_settings(obj):
    """The reference's ADMMSettings -> this package's, field by field."""
    if obj is None:
        return None
    defaults = admm.ADMMSettings._field_defaults
    return admm.ADMMSettings(
        **{f: type(defaults[f])(np.asarray(getattr(obj, f)).item())
           for f in admm.ADMMSettings._fields})


def _mhe_consts(obj, dtype, device):
    bound = lambda v: None if _is_empty(v) else _tensor(v, dtype, device)
    nc = assembly.NoiseConsts(
        **_fields(obj.nc, assembly.NoiseConsts, dtype, device))
    return mhe.MHEConsts(
        nc=nc,
        A_meas=_tensor(obj.A_meas, dtype, device),
        P_cam=_tensor(obj.P_cam, dtype, device),
        Q_vo_p=_tensor(obj.Q_vo_p, dtype, device),
        N=int(obj.N), dim_state=int(obj.dim_state), dim_meas=int(obj.dim_meas),
        dt=float(obj.dt), leg_odom_type=int(obj.leg_odom_type),
        num_legs=int(obj.num_legs),
        x_lb=bound(obj.x_lb), x_ub=bound(obj.x_ub),
        admm=_admm_settings(obj.admm), use_pallas=bool(obj.use_pallas),
    )


def _mhe_state(obj, dtype, device):
    skip = ("T", "bez", "z_adm", "y_adm")
    warm = lambda v: () if _is_empty(v) else _tensor(v, dtype, device)
    return mhe_lanes.MHEStateL(
        T=int(obj.T), bez=_bezier(obj.bez, dtype, device),
        z_adm=warm(obj.z_adm), y_adm=warm(obj.y_adm),
        **_fields(obj, mhe_lanes.MHEStateL, dtype, device, skip=skip))


def _mhe_state_std(obj, dtype, device):
    skip = ("T", "bez")
    bez = _bezier(obj.bez, dtype, device)._replace(count=int(obj.bez.count))
    return mhe.MHEState(T=int(obj.T), bez=bez,
                        **_fields(obj, mhe.MHEState, dtype, device, skip=skip))


def _ekf_consts_std(obj, dtype, device):
    return ekf.EKFConsts(dt=float(obj.dt), quirk_W=bool(obj.quirk_W),
                         **_fields(obj, ekf.EKFConsts, dtype, device,
                                   skip=("dt", "quirk_W")))


def _ekf_state_std(obj, dtype, device):
    return ekf.EKFState(t=int(obj.t),
                        **_fields(obj, ekf.EKFState, dtype, device, skip=("t",)))


def _ekf_consts(obj, dtype, device):
    return ekf_lanes.EKFConstsL(
        dt=float(obj.dt),
        C_gyro=np.asarray(obj.C_gyro, np.float64),
        C_accel=np.asarray(obj.C_accel, np.float64),
        C_vo=np.asarray(obj.C_vo, np.float64),
        gravity=np.asarray(obj.gravity, np.float64),
        quirk_W=bool(obj.quirk_W),
    )


def _ekf_state(obj, dtype, device):
    return ekf_lanes.EKFStateL(
        t=int(obj.t),
        **_fields(obj, ekf_lanes.EKFStateL, dtype, device, skip=("t",)))


_CONVERTERS = {
    "MHEConsts": _mhe_consts,
    "MHEState": _mhe_state_std,
    "EKFConsts": _ekf_consts_std,
    "EKFState": _ekf_state_std,
    "EKFConstsL": _ekf_consts,
    "MHEStateL": _mhe_state,
    "EKFStateL": _ekf_state,
    "BezierCarry": _bezier,
    "TickData": lambda o, dt, dev: estimator.TickData(
        **_fields(o, estimator.TickData, dt, dev)),
    "VOData": lambda o, dt, dev: estimator.VOData(
        **_fields(o, estimator.VOData, dt, dev)),
    "EKFBlocks": lambda o, dt, dev: estimator.EKFBlocks(
        **_fields(o, estimator.EKFBlocks, dt, dev)),
}


def from_jax_numpy(obj, device, dtype):
    """Convert one of the reference's NamedTuples (numpy leaves) to this
    package's counterpart: MHEConsts, MHEState, MHEStateL, EKFConsts,
    EKFConstsL, EKFState, EKFStateL, BezierCarry, TickData, VOData or
    EKFBlocks, chosen by the class name.
    Float leaves are cast to ``dtype``; integers become int32, booleans stay
    bool; scalar counters (``T``, ``t``) become Python ints."""
    name = type(obj).__name__
    if name not in _CONVERTERS:
        raise TypeError(f"from_jax_numpy: no counterpart for {name}")
    return _CONVERTERS[name](obj, dtype, torch.device(device))
