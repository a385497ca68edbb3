"""Config schema + YAML loader.

Mirrors the reference parameter surface 1:1 so the reference's YAML files
(e.g. src/go1_example/config/parameters_go1.yaml) load unchanged:

- ``EstimatorParams`` mirrors ``struct robot_params``
  (reference: src/decentral_legged_est/include/decentral_legged_est/DecentralEst.hpp:18-63),
  declared/loaded in robotSub::paramsWrapper (src/decentral_legged_est/src/EstSub.cpp:123-208).
- ``EKFParams`` mirrors the orien_est node parameters
  (reference: src/orien_est/src/orien_ekf.cpp:13-31).
- ``OSQPParams`` mirrors the osqp.* group (EstSub.cpp:182-207); consumed by the
  ADMM solver path with the same rho/alpha/sigma semantics and the iteration
  budget standing in for the wall-clock timeLimit.

All defaults equal the reference's declare_parameter defaults.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np


def _f3(x, y, z):
    return field(default_factory=lambda: [x, y, z])


def _f4(w, x, y, z):
    return field(default_factory=lambda: [w, x, y, z])


@dataclass
class OSQPParams:
    """ADMM solver settings with OSQP semantics (EstSub.cpp:182-207).

    ``max_iter`` bounds the fixed iteration budget (standing in for both
    maxQPIter and the wall-clock timeLimit of parameters_go1.yaml:45,50).
    """

    rho: float = 0.1
    alpha: float = 1.6
    delta: float = 1e-5
    sigma: float = 1e-5
    verbose: bool = True
    adapt_rho: bool = True
    polish: bool = True
    max_iter: int = 1000
    prim_tol: float = 1e-6
    dual_tol: float = 1e-6
    relative_tol: float = 1e-3
    abs_tol: float = 1e-3
    time_limit: float = 0.005


@dataclass
class EKFParams:
    """Quaternion-EKF node parameters (orien_ekf.cpp:13-31)."""

    init_std: list = _f4(0.001, 0.001, 0.001, 0.001)
    process_std: list = _f3(0.1, 0.1, 0.1)
    gravity_meas_std: list = _f3(4.0, 4.0, 4.0)
    vo_meas_std: list = _f4(0.0001, 0.0001, 0.0001, 0.0001)
    quaternion_init: list = _f4(1.0, 0.0, 0.0, 0.0)
    rate: int = 500
    # Reference-compat flag: orien_ekf.cpp:289-291 writes W(2,1)/W(2,2) twice
    # and never fills W(3,1)/W(3,2) (vs. the documented Jacobian at :272-276).
    # True reproduces the shipped binary's process-noise Jacobian bit-for-bit;
    # False uses the textbook matrix.
    quirk_compatible_W: bool = True

    @property
    def dt(self) -> float:
        return 1.0 / float(self.rate)


@dataclass
class EstimatorParams:
    """MHE/KF estimator parameters (robot_params, DecentralEst.hpp:18-63)."""

    # prior.* (EstSub.cpp:128-135)
    p_init_std: list = _f3(0.001, 0.001, 0.001)
    v_init_std: list = _f3(0.001, 0.001, 0.001)
    foot_init_std: list = _f3(0.001, 0.001, 0.001)
    accel_bias_init_std: list = _f3(0.001, 0.001, 0.001)

    # process.* (EstSub.cpp:138-145)
    p_process_std: list = _f3(0.01, 0.01, 0.01)
    accel_input_std: list = _f3(0.01, 0.04, 0.001)
    gyro_input_std: list = _f3(0.01, 0.01, 0.01)
    accel_bias_std: list = _f3(1.0, 1.0, 0.1)

    # leg_odom.* (EstSub.cpp:148-166)
    quaternion_ib: list = _f4(1.0, 0.0, 0.0, 0.0)
    p_ib: list = _f3(0.0, 0.0, 0.0)
    num_legs: int = 4
    leg_odom_type: int = 0  # 0: foot-velocity measurements, 1: foot-position
    joint_position_std: list = _f3(0.01, 0.01, 0.01)
    joint_velocity_std: list = _f3(0.01, 0.01, 0.01)
    foot_slide_std: list = _f3(0.001, 0.001, 0.001)
    foot_swing_std: list = _f3(10000.0, 10000.0, 10000.0)
    contact_effort_threshold: float = 150.0

    # visual_odom.* (EstSub.cpp:169-170)
    vo_p_std: list = _f3(0.001, 0.001, 0.001)

    # estimation.* (EstSub.cpp:173-179)
    rate: int = 50
    interval_ms: int = 20
    N: int = 50
    est_type: int = 0  # 0: MHE, 1: KF baseline

    osqp: OSQPParams = field(default_factory=OSQPParams)

    log_name: str = "exp"

    @property
    def dt(self) -> float:
        return 1.0 / float(self.rate)

    @property
    def dim_state(self) -> int:
        # DecentralEst.cpp:20 — 9 + 3 * leg_odom_type * num_legs
        return 9 + 3 * self.leg_odom_type * self.num_legs

    @property
    def dim_meas(self) -> int:
        # DecentralEst.cpp:21
        return 3 * self.num_legs

    @property
    def dim_cam(self) -> int:
        # DecentralEst.cpp:22
        return 3


def std_to_cov(std: Sequence[float]) -> np.ndarray:
    """diag(std^2) — StdVec2CovMat (DecentralEst.cpp:1017-1022)."""
    s = np.asarray(std, dtype=np.float64)
    return np.diag(s**2)


def std_to_gain(std: Sequence[float]) -> np.ndarray:
    """diag(1/std^2) — StdVec2GainMat (DecentralEst.cpp:1024-1029)."""
    s = np.asarray(std, dtype=np.float64)
    return np.diag(1.0 / s**2)


# ---------------------------------------------------------------------------
# YAML loading — reads the reference's multi-node YAML layout unchanged:
#   est_sub:   ros__parameters: {prior: {...}, process: {...}, ...}
#   orien_sub: ros__parameters: {init_std: [...], ...}
# (parameters_go1.yaml:1,52,68)
# ---------------------------------------------------------------------------

_EST_KEYMAP = {
    ("prior", "p_init_std"): "p_init_std",
    ("prior", "v_init_std"): "v_init_std",
    ("prior", "foot_init_std"): "foot_init_std",
    ("prior", "accel_bias_init_std"): "accel_bias_init_std",
    ("process", "p_process_std"): "p_process_std",
    ("process", "accel_input_std"): "accel_input_std",
    ("process", "gyro_input_std"): "gyro_input_std",
    ("process", "accel_bias_process_std"): "accel_bias_std",
    ("leg_odom", "quaternion_ib"): "quaternion_ib",
    ("leg_odom", "p_ib"): "p_ib",
    ("leg_odom", "num_leg"): "num_legs",
    ("leg_odom", "leg_odom_type"): "leg_odom_type",
    ("leg_odom", "joint_position_std"): "joint_position_std",
    ("leg_odom", "joint_velocity_std"): "joint_velocity_std",
    ("leg_odom", "foot_slide_std"): "foot_slide_std",
    ("leg_odom", "foot_swing_std"): "foot_swing_std",
    ("leg_odom", "contact_effort_theshold"): "contact_effort_threshold",
    ("visual_odom", "vo_p_std"): "vo_p_std",
    ("estimation", "rate"): "rate",
    ("estimation", "interval"): "interval_ms",
    ("estimation", "N"): "N",
    ("estimation", "est_type"): "est_type",
}

_OSQP_KEYMAP = {
    "rho": "rho",
    "alpha": "alpha",
    "delta": "delta",
    "sigma": "sigma",
    "verbose": "verbose",
    "adaptRho": "adapt_rho",
    "polish": "polish",
    "maxQPIter": "max_iter",
    "primTol": "prim_tol",
    "dualTol": "dual_tol",
    "realtiveTol": "relative_tol",  # sic — reference spelling, EstSub.cpp:192
    "absTol": "abs_tol",
    "timeLimit": "time_limit",
}

_EKF_KEYMAP = {
    "init_std": "init_std",
    "process_std": "process_std",
    "gravity_meas_std": "gravity_meas_std",
    "vo_meas_std": "vo_meas_std",
    "quaternion_init": "quaternion_init",
    "rate": "rate",
}


def _ros_params(doc: dict, node: str) -> dict:
    sec = doc.get(node, {})
    return sec.get("ros__parameters", sec) if isinstance(sec, dict) else {}


def _coerce(obj: Any, attr: str, value: Any) -> Any:
    """Coerce a YAML value to the declared field type.

    PyYAML implements YAML 1.1, where ``1e-6`` (no dot, unsigned exponent) is a
    *string*; rclcpp's YAML front-end parses it as a double. Coerce by the
    dataclass default's type so reference YAMLs load with reference semantics.
    """
    cur = getattr(obj, attr)
    if isinstance(cur, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes", "on")
        return bool(value)
    if isinstance(cur, int) and not isinstance(value, (list, dict)):
        f = float(value)
        if not f.is_integer():
            # rclcpp would raise InvalidParameterTypeException on a double
            # handed to an integer parameter; surface the mismatch rather
            # than silently truncating (e.g. '2.7' -> 2).
            raise ValueError(
                f"parameter {attr!r} expects an integer, got {value!r}"
            )
        return int(f)
    if isinstance(cur, float) and not isinstance(value, (list, dict)):
        return float(value)
    if isinstance(cur, list) and isinstance(value, (list, tuple)):
        return [float(v) if isinstance(v, str) else v for v in value]
    return value


def load_yaml_params(path: str) -> tuple[EstimatorParams, EKFParams]:
    """Load (EstimatorParams, EKFParams) from a reference-layout YAML file."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)

    est = EstimatorParams()
    est_doc = _ros_params(doc, "est_sub")
    if "log_name" in est_doc:
        est.log_name = est_doc["log_name"]
    for (group, key), attr in _EST_KEYMAP.items():
        if group in est_doc and isinstance(est_doc[group], dict) and key in est_doc[group]:
            setattr(est, attr, _coerce(est, attr, est_doc[group][key]))
    osqp_doc = est_doc.get("osqp", {})
    for key, attr in _OSQP_KEYMAP.items():
        if key in osqp_doc:
            setattr(est.osqp, attr, _coerce(est.osqp, attr, osqp_doc[key]))

    ekf = EKFParams()
    ekf_doc = _ros_params(doc, "orien_sub")
    for key, attr in _EKF_KEYMAP.items():
        if key in ekf_doc:
            setattr(ekf, attr, _coerce(ekf, attr, ekf_doc[key]))

    return est, ekf


def asdict(params: Any) -> dict:
    return dataclasses.asdict(params)
