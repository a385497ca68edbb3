"""Stateful estimator facade — API parity with ``DecentralizedEstimation``.

Counterpart of the reference ``ops/facade.py``. The reference exposes the
estimator to deployments as a three-method object:
``initialize(store, params)`` / ``update(T)`` / ``reset()``
(DecentralEst.hpp:101-103, driven from robotSub::timerCallback,
EstSub.cpp:58-91). This facade offers the same surface for online /
tick-at-a-time use (hardware-in-the-loop, notebooks) over the functional
modules. For offline replay and fleets, prefer the drivers
(``ops/estimator.run_mhe`` / ``run_kf``, ``parallel.batch``).

The reference runs a K-tick block as one jitted ``lax.scan`` with a donated
carry; here a block is a Python loop of the same per-tick functions, its
inputs moved to the device once per block. Tick counters and the VO schedule
are host values, so a tick reads no device scalar.

``PipelineEstimator(use_pallas=True)`` solves every tick's window through the
block-tridiagonal kernel at B=1 (``kernels/tridiag_kernel.solve_lanes``), or,
with state box constraints, the box-ADMM kernel
(``kernels/admm_kernel.solve_box_lanes``): on CUDA tensors they launch or
raise; on the CPU they take their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from decentralized_ekf_mhe_tpu_torch.config import EstimatorParams
from decentralized_ekf_mhe_tpu_torch.ops import assembly, ekf_lanes, kf, lanes, mhe, mhe_lanes
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device


def _host(v, dtype=None):
    """A caller's input (numpy, list, scalar or tensor) as a numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype)


class _Inputs:
    """Moves a caller's inputs to the estimator's dtype and device."""

    def __init__(self, dtype, device):
        self.dtype, self.device = dtype, device

    def __call__(self, v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype=self.dtype, device=self.device)
        return torch.as_tensor(np.asarray(v, np.float64)).to(dtype=self.dtype,
                                                             device=self.device)


class DecentralizedEstimator:
    """Tick-at-a-time decentralized estimator (MHE or KF per est_type), one
    instance in the standard layout."""

    def __init__(self, params: EstimatorParams, dtype=torch.float32,
                 x_lb=None, x_ub=None, use_pallas: bool = False,
                 lever_arm=kf.DEFAULT_LEVER_ARM, history_ticks: int = 256,
                 device="cuda"):
        self.device = resolve_device(device)
        self.params = params
        self.dtype = dtype
        self.est_type = params.est_type
        self._a = _Inputs(dtype, self.device)
        self._c = mhe.make_consts(params, dtype, x_lb=x_lb, x_ub=x_ub,
                                  use_pallas=use_pallas, device=self.device)
        self._nc = assembly.make_noise_consts(params, dtype, device=self.device)
        self._A_meas = assembly.a_meas(params, dtype, device=self.device)
        self._lever = torch.tensor(lever_arm, dtype=dtype, device=self.device)
        # Bounded host-side orientation ring for the VO R_pre lookup
        # (DecentralEst.cpp:915). Only the single (3,3) pre-frame rotation is
        # shipped to device per update; tick indices stay ABSOLUTE (no modular
        # aliasing past the ring length — the ring only has to cover the VO
        # pipeline latency, a handful of ticks).
        self._R_hist = np.zeros((history_ticks, 3, 3))
        self._state = None
        self._kf_prev = None
        self.T = 0
        self.x = None
        self.v_body = None

    # -- DecentralizedEstimation::initialize (DecentralEst.cpp:9-150) ------
    def initialize(self, R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact):
        args = tuple(map(self._a, (R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact)))
        self._R_hist[0] = _host(R_sb)
        if self.est_type == 0:
            self._state = mhe.init(self._c, *args, dtype=self.dtype, device=self.device)
            xw = mhe.solve_window(self._c, self._state)
            self.x = xw[..., self._c.N - 1, :]
        else:
            b0, C0, _ = assembly.build_measurement(
                self.params, self._nc, args[0], args[2], args[3], args[4],
                args[5], args[6],
            )
            self._state = kf.init(self.params, self._nc, self._A_meas, b0, C0)
            self._kf_prev = (
                args[0], assembly.spatial_accel(args[0], args[1], self._nc), args[6]
            )
            self.x = self._state.x
        self.v_body = kf.body_velocity(self.x, args[0], args[2], self._lever)
        self.T = 1
        return self.x

    # -- DecentralizedEstimation::update (DecentralEst.cpp:152-198) --------
    def update(self, R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact,
               vo_active=False, vo_dp=None, vo_tick_pre=0, vo_tick_now=0):
        if self._state is None:
            raise RuntimeError("call initialize() before update()")
        args = tuple(map(self._a, (R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact)))
        H = len(self._R_hist)
        self._R_hist[self.T % H] = _host(R_sb)

        if self.est_type == 0:
            vo_dp = self._a(vo_dp) if vo_dp is not None else torch.zeros(
                3, dtype=self.dtype, device=self.device)
            if vo_active and self.T - int(vo_tick_pre) >= H:
                raise ValueError(
                    f"VO previous frame (tick {int(vo_tick_pre)}) predates the "
                    f"{H}-tick orientation history at tick "
                    f"{self.T}; raise history_ticks"
                )
            R_pre = self._a(self._R_hist[int(vo_tick_pre) % H])
            self._state, (x_T, _) = mhe.step(
                self._c, self._state, *args, bool(vo_active), vo_dp,
                int(vo_tick_pre), int(vo_tick_now), R_pre)
            self.x = x_T
        else:
            R_prev, accel_s_prev, contact_prev = self._kf_prev
            A_dyn, b_dyn, C_dyn, _ = assembly.build_dynamics(
                self.params, self._nc, R_prev, accel_s_prev, contact_prev
            )
            b_meas, C_meas, _ = assembly.build_measurement(
                self.params, self._nc, args[0], args[2], args[3], args[4],
                args[5], args[6],
            )
            self._state = kf.update(self._state, A_dyn, b_dyn, C_dyn,
                                    self._A_meas, b_meas, C_meas)
            self._kf_prev = (
                args[0], assembly.spatial_accel(args[0], args[1], self._nc), args[6]
            )
            self.x = self._state.x
        self.v_body = kf.body_velocity(self.x, args[0], args[2], self._lever)
        self.T += 1
        return self.x

    # -- block update: K ticks in one call ---------------------------------
    def update_block(self, R_sb, accel_b, omega_b, p_foot, J_foot, dq,
                     contact, vo_active=None, vo_dp=None, vo_tick_pre=None,
                     vo_tick_now=None):
        """Process K aligned ticks in one call — the HIL hot path.

        All tensor args carry a leading K axis (R_sb (K,3,3), accel_b (K,3),
        …, vo_active (K,) bool, vo_dp (K,3), vo_tick_pre/now (K,) absolute
        tick indices); the block moves to the device once. Semantics are
        exactly K calls of update() (MHE path only).

        Returns (x (K,s), v_body (K,3)); advances T by K.
        """
        if self._state is None:
            raise RuntimeError("call initialize() before update_block()")
        if self.est_type != 0:
            raise NotImplementedError("update_block is MHE-only (est_type=0)")
        R_np = _host(R_sb)
        K = R_np.shape[0]
        H = len(self._R_hist)
        # Snapshot the ring BEFORE writing the block's rows: an event at block
        # index k may reference a pre-block tick whose slot a LATER row of
        # this same block (tick vtp+H > T+k) would clobber — gathering
        # pre-block references from the snapshot and in-block references from
        # R_np keeps the semantics of exactly K calls of update().
        ring_pre = self._R_hist.copy()
        for k in range(K):
            self._R_hist[(self.T + k) % H] = R_np[k]
        va = np.zeros(K, bool) if vo_active is None else _host(vo_active, bool)
        vdp = np.zeros((K, 3)) if vo_dp is None else vo_dp
        vtp = np.zeros(K, np.int64) if vo_tick_pre is None else _host(vo_tick_pre, np.int64)
        vtn = np.zeros(K, np.int64) if vo_tick_now is None else _host(vo_tick_now, np.int64)
        ticks = self.T + np.arange(K)
        if bool((va & (ticks - vtp >= H)).any()):
            raise ValueError(
                f"a VO previous frame predates the {H}-tick orientation "
                f"history; raise history_ticks")
        in_blk = vtp >= self.T
        R_pre = np.where(in_blk[:, None, None],
                         R_np[np.clip(vtp - self.T, 0, K - 1)],
                         ring_pre[vtp % H])

        R, ab, ob, pf, Jf, dqv, ct, dp, Rp = map(
            self._a, (R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact, vdp, R_pre))
        xs, vs = [], []
        st = self._state
        for k in range(K):
            st, (x_T, _) = mhe.step(
                self._c, st, R[k], ab[k], ob[k], pf[k], Jf[k], dqv[k], ct[k],
                bool(va[k]), dp[k], int(vtp[k]), int(vtn[k]), Rp[k])
            xs.append(x_T)
            vs.append(kf.body_velocity(x_T, R[k], ob[k], self._lever))
        self._state = st
        x_seq, v_seq = torch.stack(xs), torch.stack(vs)
        self.x = x_seq[-1]
        self.v_body = v_seq[-1]
        self.T += K
        return x_seq, v_seq

    # -- DecentralizedEstimation::reset -> MHEproblem::resetQP -------------
    def reset(self):
        """Full estimator reset (DecentralEst.cpp:1011-1015, MheSrb.cpp:734-760)."""
        self._state = None
        self._kf_prev = None
        self.T = 0
        self.x = None
        self.v_body = None


class PipelineEstimator:
    """Stateful FULL-CYCLE facade: orientation EKF *in the loop* + MHE.

    The reference deployment runs `orien_est` live — the 500 Hz quaternion
    EKF publishes `imu/filter` (orien_ekf.cpp:77-105) which `robotSub`
    consumes every 5 ms cycle (EstSub.cpp:34-43) before the MHE solve. This
    facade closes the same loop for streaming/HIL use: ``update_block``
    takes RAW gyro/accel substep blocks plus the tick-rate leg-odometry
    rows and runs, per tick, ``ekf_lanes.substep_block``, ``ekf_lanes.to_rot``
    and ``mhe_lanes.step`` on one instance (B=1), keeping a device-side
    orientation ring for the MHE's delayed-VO R_pre lookup
    (DecentralEst.cpp:915). Block-streamed output equals the offline
    ``estimator.run_pipeline_lanes`` replay.

    The carry is ``(ekf_state, mhe_state, ring (H,3,3,1), t)`` with ``t`` the
    last completed tick, a host int — the reference's carry, leaf for leaf,
    for ``utils.checkpoint``. With ``use_pallas`` every window solve (one at
    ``initialize``, one per tick) is a launch of the block-tridiagonal
    kernel, or of the box-ADMM kernel with ``x_lb``/``x_ub``.
    """

    def __init__(self, params: EstimatorParams, ekf_params,
                 dtype=torch.float32, x_lb=None, x_ub=None,
                 use_pallas: bool = False, ekf_ring_len: int = 16,
                 lever_arm=kf.DEFAULT_LEVER_ARM, history_ticks: int = 256,
                 device="cuda"):
        self.device = resolve_device(device)
        self.params = params
        self.ekf_params = ekf_params
        self.dtype = dtype
        self._a = _Inputs(dtype, self.device)
        self._c = mhe.make_consts(params, dtype, x_lb=x_lb, x_ub=x_ub,
                                  use_pallas=use_pallas, device=self.device)
        self._ec = ekf_lanes.make_consts(ekf_params, dtype)
        self._ekf_ring_len = ekf_ring_len
        self._H = history_ticks
        self._lever = torch.tensor(lever_arm, dtype=dtype, device=self.device)[:, None]
        self._carry = None
        self.T = 0
        self.x = None
        self.v_body = None
        self.q = None

    @property
    def consts(self):
        """The MHE constants (``ops.mhe.MHEConsts``) the ticks solve with."""
        return self._c

    @property
    def carry(self):
        """(ekf_state, mhe_state, ring, t): the whole state between ticks."""
        return self._carry

    @carry.setter
    def carry(self, carry):
        """Resume from a carry (e.g. ``utils.checkpoint.load_carry``); the
        tick counter follows its ``t``."""
        self._carry = carry
        self.T = int(carry[3]) + 1

    def _v_body(self, R, x, omega):
        return lanes.mv(R, x[3:6] + lanes.cross(omega, self._lever))[:, 0]

    # -- tick-0: EKF over block 0 -> R_0 -> InitializeMHE ------------------
    def initialize(self, ekf_gyro, ekf_accel, ekf_valid,
                   accel_b, omega_b, p_foot, J_foot, dq, contact,
                   ekf_vo_active=None, ekf_vo_q=None, ekf_vo_steps_back=None):
        """Tick 0 (timerCallback first pass, EstSub.cpp:65-70): run the
        tick's EKF substeps (ekf_gyro/ekf_accel (S,3), ekf_valid (S,)),
        then InitializeMHE with the fused orientation."""
        a = self._a
        S = _host(ekf_valid).shape[0]
        ekf_st = ekf_lanes.init_state(self.ekf_params, 1, ring_len=self._ekf_ring_len,
                                      dtype=self.dtype, device=self.device)
        va = [False] * S if ekf_vo_active is None else _host(ekf_vo_active, bool).tolist()
        vq = a(np.zeros((S, 4)) if ekf_vo_q is None else ekf_vo_q)
        sb = [0] * S if ekf_vo_steps_back is None else _host(ekf_vo_steps_back,
                                                             np.int64).tolist()
        ekf_st = ekf_lanes.substep_block(
            ekf_st, a(ekf_gyro)[..., None], a(ekf_accel)[..., None],
            _host(ekf_valid, bool).tolist(), va, vq, sb, self._ec)
        R0 = ekf_lanes.to_rot(ekf_st.q)                  # (3,3,1)

        ab, ob, pf, Jf, dqv, ct = (a(v)[..., None] for v in
                                   (accel_b, omega_b, p_foot, J_foot, dq, contact))
        mhe_st = mhe_lanes.init(self._c, R0, ab, ob, pf, Jf, dqv, ct,
                                dtype=self.dtype, device=self.device)
        x0 = mhe_lanes.solve_window(self._c, mhe_st)[self._c.N - 1]  # (s,1)
        ring = torch.zeros((self._H, 3, 3, 1), dtype=self.dtype, device=self.device)
        ring[0] = R0
        self._carry = (ekf_st, mhe_st, ring, 0)
        self.x = x0[:, 0]
        self.q = ekf_st.q[:, 0]
        self.v_body = self._v_body(R0, x0, ob)
        self.T = 1
        return self.x

    # -- K full cycles in one call -----------------------------------------
    def update_block(self, ekf_gyro, ekf_accel, ekf_valid,
                     accel_b, omega_b, p_foot, J_foot, dq, contact,
                     ekf_vo_active=None, ekf_vo_q=None,
                     ekf_vo_steps_back=None,
                     vo_active=None, vo_dp=None, vo_tick_pre=None,
                     vo_tick_now=None):
        """Process K aligned FULL cycles (EKF substeps + MHE solve each).
        EKF-rate args carry (K,S,...) padded blocks; MHE-rate args carry a
        leading K axis; vo_tick_* are absolute tick indices. The block moves
        to the device once; its schedule stays on the host.
        Returns (x (K,s), v_body (K,3), q (K,4)); advances T by K."""
        if self._carry is None:
            raise RuntimeError("call initialize() before update_block()")
        a = self._a
        valid = _host(ekf_valid, bool)
        K, S = valid.shape[:2]
        H = self._H
        eva = (np.zeros((K, S), bool) if ekf_vo_active is None
               else _host(ekf_vo_active, bool))
        evq = a(np.zeros((K, S, 4)) if ekf_vo_q is None else ekf_vo_q)
        esb = (np.zeros((K, S), np.int64) if ekf_vo_steps_back is None
               else _host(ekf_vo_steps_back, np.int64))
        va = np.zeros(K, bool) if vo_active is None else _host(vo_active, bool)
        vdp = a(np.zeros((K, 3)) if vo_dp is None else vo_dp)
        vtp = np.zeros(K, np.int64) if vo_tick_pre is None else _host(vo_tick_pre, np.int64)
        vtn = np.zeros(K, np.int64) if vo_tick_now is None else _host(vo_tick_now, np.int64)
        ticks = self.T + np.arange(K)
        if bool((va & (ticks - vtp >= H)).any()):
            raise ValueError(
                f"a VO previous frame predates the {H}-tick orientation "
                f"ring; raise history_ticks")

        g, ac = a(ekf_gyro)[..., None], a(ekf_accel)[..., None]      # (K,S,3,1)
        ab, ob, pf, Jf, dqv, ct = (a(v)[..., None] for v in
                                   (accel_b, omega_b, p_foot, J_foot, dq, contact))
        valid, eva, esb = valid.tolist(), eva.tolist(), esb.tolist()
        ekf_st, mhe_st, ring, _ = self._carry
        # the ring is indexed by absolute tick mod H; the counter starts from
        # self.T - 1, the last completed tick
        t = self.T - 1
        ring = ring.clone()
        xs, vs, qs = [], [], []
        for k in range(K):
            ekf_st = ekf_lanes.substep_block(ekf_st, g[k], ac[k], valid[k], eva[k],
                                             evq[k], esb[k], self._ec)
            R_t = ekf_lanes.to_rot(ekf_st.q)             # (3,3,1)
            t += 1
            ring[t % H] = R_t
            mhe_st, (x_T, _, _) = mhe_lanes.step(
                self._c, mhe_st, R_t, ab[k], ob[k], pf[k], Jf[k], dqv[k], ct[k],
                bool(va[k]), vdp[k], int(vtp[k]), int(vtn[k]), ring[int(vtp[k]) % H])
            xs.append(x_T[:, 0])
            vs.append(self._v_body(R_t, x_T, ob[k]))
            qs.append(ekf_st.q[:, 0])
        self._carry = (ekf_st, mhe_st, ring, t)
        x_seq, v_seq, q_seq = torch.stack(xs), torch.stack(vs), torch.stack(qs)
        self.x = x_seq[-1]
        self.v_body = v_seq[-1]
        self.q = q_seq[-1]
        self.T += K
        return x_seq, v_seq, q_seq

    def reset(self):
        self._carry = None
        self.T = 0
        self.x = None
        self.v_body = None
        self.q = None
