"""Fleet harness: Monte-Carlo perturbations and the fleet runners.

Counterpart of the reference ``parallel/batch.py``. Ported: the three
``perturb_*`` functions, the layout helpers, the standard-layout runners
(``mhe_window_solve_batch``, ``make_batched_runner``,
``make_fused_batched_runner``) and the two lanes fleet runners (shared or
per-lane camera clocks). Everything sharded over a device mesh is listed in
ROADMAP.md ("sharding").

Random draws take an explicit ``torch.Generator`` where the reference takes a
PRNG key; the two frameworks give different numbers for the same seed, so a
comparison against the reference perturbs once and hands both sides the same
arrays.
"""

from __future__ import annotations

from typing import Optional

import torch

from decentralized_ekf_mhe_tpu_torch.config import EKFParams, EstimatorParams
from decentralized_ekf_mhe_tpu_torch.ops import estimator, kf as kf_ops
from decentralized_ekf_mhe_tpu_torch.utils.precision import resolve_device


def _randn(shape, generator, dtype, device):
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def perturb_log_batch(data: estimator.TickData, B: int,
                      generator: torch.Generator,
                      params: Optional[EstimatorParams] = None,
                      noise_scale=1.0,
                      dtype=torch.float32) -> estimator.TickData:
    """Tile one log into B Monte-Carlo instances (B, T, ...) with fresh
    IMU/encoder noise draws, scaled by the CONFIGURED sensor stds
    (accel_input_std / gyro_input_std / joint_velocity_std), so the fleet
    samples exactly the noise model the estimator assumes. The generator must
    live on the data's device."""
    p = params if params is not None else EstimatorParams()
    dev = data.accel_b.device
    acc_std = torch.tensor(p.accel_input_std, dtype=dtype, device=dev)
    gyro_std = torch.tensor(p.gyro_input_std, dtype=dtype, device=dev)
    dq_std = torch.tensor(p.joint_velocity_std, dtype=dtype, device=dev)

    d = estimator.TickData(
        *(a[None].to(dtype).expand((B,) + tuple(a.shape)) for a in data))
    T = data.accel_b.shape[0]
    return d._replace(
        accel_b=d.accel_b
        + noise_scale * acc_std * _randn((B, T, 3), generator, dtype, dev),
        omega_b=d.omega_b
        + noise_scale * gyro_std * _randn((B, T, 3), generator, dtype, dev),
        dq=d.dq + noise_scale * dq_std * _randn(tuple(d.dq.shape), generator,
                                                dtype, dev),
    )


def perturb_ekf_blocks(eb: estimator.EKFBlocks, B: int,
                       generator: torch.Generator,
                       params: Optional[EstimatorParams] = None,
                       noise_scale=1.0,
                       dtype=torch.float32,
                       vo_noise_scale=0.0,
                       ekf_params=None) -> estimator.EKFBlocks:
    """Tile one log's EKF-rate blocks into a B-instance lanes-layout fleet
    with fresh gyro/accel noise draws (the EKF half of perturb_log_batch).

    ``vo_noise_scale`` > 0 additionally perturbs the VISION content per lane:
    the measured VO quaternion becomes per-lane (T,S,4,B) with a fresh draw
    per instance scaled by ``ekf_params.vo_meas_std`` and renormalized. Event
    timing (valid/vo_active/steps_back) stays the fleet's shared camera
    clock."""
    p = params if params is not None else EstimatorParams()
    ep = ekf_params if ekf_params is not None else EKFParams()
    dev = eb.gyro.device
    T, S = eb.gyro.shape[:2]
    gyro_std = torch.tensor(p.gyro_input_std, dtype=dtype, device=dev)[None, None, :, None]
    acc_std = torch.tensor(p.accel_input_std, dtype=dtype, device=dev)[None, None, :, None]

    def tile_lanes(a):
        return a.to(dtype)[..., None].expand(tuple(a.shape) + (B,))

    vo_q = eb.vo_q.to(dtype)
    if vo_noise_scale > 0.0:
        q_std = torch.tensor(ep.vo_meas_std, dtype=dtype, device=dev)[None, None, :, None]
        q_l = tile_lanes(vo_q) + (
            vo_noise_scale * q_std
            * _randn((T, S, 4, B), generator, dtype, dev)
            * eb.vo_active.to(dtype)[..., None, None]
        )
        nrm = torch.sqrt(torch.sum(q_l * q_l, dim=-2, keepdim=True))
        vo_q = torch.where(nrm > 0, q_l / torch.clamp(nrm, min=1e-20), q_l)

    return eb._replace(
        gyro=tile_lanes(eb.gyro)
        + noise_scale * gyro_std * _randn((T, S, 3, B), generator, dtype, dev),
        accel=tile_lanes(eb.accel)
        + noise_scale * acc_std * _randn((T, S, 3, B), generator, dtype, dev),
        vo_q=vo_q.contiguous(),
    )


def perturb_vo_batch(vo: estimator.VOData, B: int,
                     generator: torch.Generator,
                     params: Optional[EstimatorParams] = None,
                     noise_scale=1.0,
                     dtype=torch.float32,
                     per_instance_timing=False) -> estimator.VOData:
    """Per-lane VO content noise for the MHE stage: dp_body becomes (T,3,B)
    with fresh per-instance draws on active events, scaled by
    ``params.vo_p_std``. Timing stays the shared camera clock; with
    ``per_instance_timing`` the active/tick metadata are broadcast per lane
    ((T,B)), which sends the fleet down the per-instance path with every lane
    on the same clock (the clocks themselves are not perturbed)."""
    p = params if params is not None else EstimatorParams()
    dev = vo.dp_body.device
    T = vo.dp_body.shape[0]
    dp_std = torch.tensor(p.vo_p_std, dtype=dtype, device=dev)[None, :, None]
    dp = vo.dp_body.to(dtype)[:, :, None].expand(T, 3, B)
    dp = dp + (
        noise_scale * dp_std * _randn((T, 3, B), generator, dtype, dev)
        * vo.active.to(dtype)[:, None, None]
    )
    if per_instance_timing:
        return estimator.VOData(
            active=vo.active[:, None].expand(T, B),
            dp_body=dp,
            tick_pre=vo.tick_pre[:, None].expand(T, B),
            tick_now=vo.tick_now[:, None].expand(T, B),
        )
    return vo._replace(dp_body=dp)


def mhe_window_solve_batch(params: EstimatorParams, dtype=torch.float32,
                           device="cuda"):
    """f(batched mhe.MHEState) -> (B, N, s): the window solve alone, on the
    default consts (the exact sweep ``ops.tridiag.solve``)."""
    from decentralized_ekf_mhe_tpu_torch.ops import mhe

    c = mhe.make_consts(params, dtype, device=resolve_device(device))

    def f(st):
        return mhe.solve_window(c, st)

    return f


def make_batched_runner(params: EstimatorParams, dtype=torch.float32, with_vo=True,
                        device="cuda"):
    """Full-log MHE replay of a B-leading fleet: f(TickData[B,T,...], VOData)
    -> (x[B,T,s], v[B,T,3]) (``with_vo=False``: f(TickData) without VO). The
    reference vmaps the single-instance replay; here B moves to the
    time-leading form and the fleet replays in one loop
    (``estimator.run_mhe``, every instance its own rows of each tensor) on the
    default consts, the exact sweep ``ops.tridiag.solve``. ``vo`` is the
    fleet's shared schedule."""
    device = resolve_device(device)

    def run(data_b: estimator.TickData, vo: Optional[estimator.VOData] = None):
        x, v = estimator.run_mhe(params, to_time_leading(data_b), vo=vo, dtype=dtype,
                                 device=device)
        return x.transpose(0, 1), v.transpose(0, 1)

    if with_vo:
        return run
    return lambda data_b: run(data_b)


def make_fused_batched_runner(params: EstimatorParams, dtype=torch.float32,
                              use_pallas=True, device="cuda"):
    """Fleet MHE replay in standard layout: f(TickData[T,B,...], VOData) ->
    (x[T,B,s], v[T,B,3]). Every ``ops.mhe`` function broadcasts over the
    instance axis, so the time-leading fleet runs through one loop with host
    tick counters. With ``use_pallas`` (the default) every tick's window solve
    takes the block-tridiagonal kernel's standard-layout route
    (``kernels/tridiag_kernel.solve_batched``: the CUDA kernel on CUDA
    tensors, its plain version on CPU tensors), as the reference takes its
    Pallas kernel. ``vo`` is the fleet's shared schedule, dp_body (T,3) or
    per instance (T,B,3)."""
    from decentralized_ekf_mhe_tpu_torch.ops import mhe

    device = resolve_device(device)
    c = mhe.make_consts(params, dtype, use_pallas=use_pallas, device=device)

    def run(data_tb: estimator.TickData, vo: Optional[estimator.VOData] = None):
        return estimator.run_mhe(params, data_tb, vo=vo, dtype=dtype, consts=c,
                                 device=device)

    return run


def to_time_leading(data_b: estimator.TickData) -> estimator.TickData:
    """(B, T, ...) TickData -> (T, B, ...)."""
    return estimator.TickData(*(a.transpose(0, 1) for a in data_b))


def tickdata_to_lanes(data_tb: estimator.TickData) -> estimator.TickData:
    """(T, B, ...) TickData -> lanes layout (T, ..., B), contiguous (a real
    transpose: the kernels read instance-minor memory)."""
    return estimator.TickData(
        *(torch.movedim(a, 1, -1).contiguous() for a in data_tb))


def _body_velocity(x, R_seq, omega_b, lever_arm):
    """Lever-arm body velocity (DecentralEst.cpp:183-185) over a whole
    (T, ..., B) result: v = R (x[3:6] + ω × lever)."""
    from decentralized_ekf_mhe_tpu_torch.ops import lanes

    B = x.shape[-1]
    lever_l = torch.tensor(lever_arm, dtype=x.dtype,
                           device=x.device)[:, None].expand(3, B)
    return lanes.mv(R_seq, x[:, 3:6] + lanes.cross(omega_b, lever_l))


def make_pipeline_fleet_runner(params: EstimatorParams, ekf_params,
                               dtype=torch.float32, use_pallas=True,
                               ekf_ring_len: int = 16,
                               use_megakernel=False, consts=None,
                               device="cuda"):
    """The full-pipeline fleet path: EKF(500 Hz) → MHE(200 Hz) staged in
    lanes layout — the reference's production pipeline, batched.

    f(TickData[T,B,...], EKFBlocks lanes, VOData) -> (x[T,B,s], v[T,B,3],
    q[T,4,B]). ``data.R_sb`` is ignored (orientation comes from the EKF).
    All inputs must lie on ``device``.

    ``use_megakernel=True`` runs each stage as one kernel launch: the EKF
    stage kernel (kernels/ekf_kernel.py), ``ekf_lanes.to_rot``, the MHE tick
    kernel (kernels/mhe_replay_kernel.py, whose tick-0 solve goes through
    kernels/tridiag_kernel.py when ``use_pallas``; a per-instance ``VOData``
    takes its per-lane-clock variant), then the lever-arm body velocity.
    EKF blocks with a camera clock per lane (``eb.vo_active`` (T,S,B)) take
    ``estimator.scan_ekf_blocks`` on ``device`` instead of the EKF kernel, as
    the reference's runner takes its scan: neither package has an EKF kernel
    for per-lane timing. ``use_megakernel=False`` runs the eager lanes path
    (``estimator.run_pipeline_lanes``), which is also what the plain versions
    of the two stage kernels are. ``use_pallas`` keeps the reference's name:
    it routes window solves through the block-tridiagonal kernel wrapper.
    """
    from decentralized_ekf_mhe_tpu_torch.ops import ekf_lanes
    from decentralized_ekf_mhe_tpu_torch.ops import mhe as mhe_lib

    device = resolve_device(device)
    c = consts if consts is not None else mhe_lib.make_consts(
        params, dtype, use_pallas=use_pallas, device=device)

    if use_megakernel:
        from decentralized_ekf_mhe_tpu_torch.kernels import ekf_kernel
        from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk

        ec = ekf_lanes.make_consts(ekf_params, dtype)

        def run(data_tb: estimator.TickData, eb: estimator.EKFBlocks,
                vo: estimator.VOData):
            data_l = tickdata_to_lanes(data_tb)
            B = data_l.accel_b.shape[-1]
            ekf_st = ekf_lanes.init_state(ekf_params, B,
                                          ring_len=ekf_ring_len, dtype=dtype,
                                          device=device)
            if eb.vo_active.ndim == 3:
                _, q_seq = estimator.scan_ekf_blocks(ekf_st, eb, ec)
            else:
                q_seq, _ = ekf_kernel.replay(ec, ekf_st, eb, device=device)
            R_seq = ekf_lanes.to_rot(q_seq)                 # (T,3,3,B)
            data_l = data_l._replace(R_sb=R_seq)
            x = mrk.replay(c, data_l, vo, dtype=dtype, device=device)
            v = _body_velocity(x, R_seq, data_l.omega_b,
                               kf_ops.DEFAULT_LEVER_ARM)
            return (torch.movedim(x, -1, 1), torch.movedim(v, -1, 1), q_seq)

        return run

    def run(data_tb: estimator.TickData, eb: estimator.EKFBlocks,
            vo: estimator.VOData):
        data_l = tickdata_to_lanes(data_tb)
        return estimator.run_pipeline_lanes(
            params, ekf_params, data_l, eb, vo=vo, dtype=dtype, consts=c,
            ekf_ring_len=ekf_ring_len, device=device)

    return run


def make_lanes_fleet_runner(params: EstimatorParams, dtype=torch.float32,
                            use_pallas=True, use_megakernel=False,
                            lever_arm=kf_ops.DEFAULT_LEVER_ARM,
                            consts=None, device="cuda"):
    """The MHE-only fleet path: f(TickData[T,B,...], VOData) -> (x[T,B,s],
    v[T,B,3]) with the whole MHE state and assembly in lanes layout;
    orientation comes from ``data.R_sb``. ``use_megakernel=True`` runs the
    ticks in the MHE tick kernel, otherwise the eager loop
    (``estimator.run_mhe_lanes``); either takes a shared or a per-instance
    ``VOData``."""
    from decentralized_ekf_mhe_tpu_torch.ops import mhe as mhe_lib

    device = resolve_device(device)
    c = consts if consts is not None else mhe_lib.make_consts(
        params, dtype, use_pallas=use_pallas, device=device)

    if use_megakernel:
        from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk

        def run(data_tb: estimator.TickData, vo: estimator.VOData):
            data_l = tickdata_to_lanes(data_tb)
            x = mrk.replay(c, data_l, vo, dtype=dtype, device=device)
            v = _body_velocity(x, data_l.R_sb, data_l.omega_b, lever_arm)
            return torch.movedim(x, -1, 1), torch.movedim(v, -1, 1)

        return run

    def run(data_tb: estimator.TickData, vo: estimator.VOData):
        data_l = tickdata_to_lanes(data_tb)
        return estimator.run_mhe_lanes(params, data_l, vo=vo,
                                       lever_arm=lever_arm, dtype=dtype,
                                       consts=c, device=device)

    return run
