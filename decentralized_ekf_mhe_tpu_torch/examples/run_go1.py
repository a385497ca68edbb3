"""Go1 pipeline driver — the `ros2 launch go1_example go1_launch.py` analog.

Counterpart of the reference's ``examples/run_go1.py``. Replays a log
(synthetic by default; a recorded RawLog npz or rosbag2 via --raw), runs the
decentralized pipeline (orientation EKF feeding the MHE or the KF baseline
per estimation.est_type), and writes a Data_Logger-compatible binary log with
the same channels the reference registers (EstSub.cpp:93-121: pose, GT_v,
v_body, x_MHE, p_vo_accmulate_, filter_euler_, gt_euler_).

Without ``--yaml`` the estimator is the reference bench's Go1 configuration
(``tools/roofline.bench_params``: N=20, Go1's noise model) with the default
``EKFParams``; ``--yaml PATH`` loads a reference parameter file instead.

Usage:
    python -m decentralized_ekf_mhe_tpu_torch.examples.run_go1 [--yaml PATH]
        [--ticks N] [--est-type {0,1}] [--gt-orientation] [--log-dir DIR]
        [--cpu] [--raw PATH] [--raw-model {go1,cartesian}]

``--raw`` replays a recorded log instead of the synthetic generator: either a
RawLog .npz (io.replay.save_rawlog schema) or a rosbag2 directory/.db3 of the
reference's topics (io.rosbag.rawlog_from_rosbag); the alignment pass
(io.replay.align) reproduces the reference's latest-value sampling, VO
timestamp sync and discard rules. ``--cpu`` runs on the CPU (the plain
versions of the kernels); otherwise everything runs on the card.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--yaml", default=None,
                    help="reference parameter file (default: the bench's Go1 estimator)")
    ap.add_argument("--ticks", type=int, default=1000)
    ap.add_argument("--est-type", type=int, default=None,
                    help="override estimation.est_type (0=MHE, 1=KF)")
    ap.add_argument("--gt-orientation", action="store_true",
                    help="feed ground-truth orientation instead of the EKF")
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--raw", default=None, metavar="PATH",
                    help="replay a RawLog .npz or rosbag2 dir/.db3 instead "
                         "of the synthetic log")
    ap.add_argument("--raw-model", default="go1",
                    choices=["go1", "cartesian"],
                    help="kinematics used by the alignment pass: 'go1' "
                         "(FROST-parity FK on joint angles) or 'cartesian' "
                         "(joint channels already carry foot positions)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from decentralized_ekf_mhe_tpu_torch.config import EKFParams, load_yaml_params
    from decentralized_ekf_mhe_tpu_torch.io import logger as log_io
    from decentralized_ekf_mhe_tpu_torch.io import synth
    from decentralized_ekf_mhe_tpu_torch.ops import estimator
    from decentralized_ekf_mhe_tpu_torch.tools.roofline import bench_params
    from decentralized_ekf_mhe_tpu_torch.utils import quaternion as quat
    from decentralized_ekf_mhe_tpu_torch.utils.timing import scoped_timer

    device = "cpu" if args.cpu else "cuda"
    if args.yaml:
        est_params, ekf_params = load_yaml_params(args.yaml)
    else:
        est_params, ekf_params = bench_params(), EKFParams()
    if args.est_type is not None:
        est_params.est_type = args.est_type
    print(f"config: rate={est_params.rate} N={est_params.N} "
          f"est_type={est_params.est_type} legs={est_params.num_legs} device={device}")

    if args.raw:
        from decentralized_ekf_mhe_tpu_torch.io import replay as replay_io
        from decentralized_ekf_mhe_tpu_torch.models import go1 as go1_model
        from decentralized_ekf_mhe_tpu_torch.models.base import CartesianFeetModel

        if args.raw.endswith(".npz"):
            raw = replay_io.load_rawlog(args.raw)
        else:
            from decentralized_ekf_mhe_tpu_torch.io import rosbag as rosbag_io

            raw = rosbag_io.rawlog_from_rosbag(args.raw, num_legs=est_params.num_legs)
        if args.raw_model == "go1":
            model = go1_model.Go1Model(
                p_ib=est_params.p_ib,
                contact_threshold=est_params.contact_effort_threshold)
        else:
            model = CartesianFeetModel(
                num_legs=est_params.num_legs, p_ib=est_params.p_ib,
                contact_threshold=est_params.contact_effort_threshold)
        log = replay_io.align(raw, model, est_rate=est_params.rate,
                              ekf_rate=ekf_params.rate)
        T_avail = log.accel_b.shape[0]
        if args.ticks < T_avail:
            T_ekf_avail = log.ekf_gyro.shape[0]
            Te = int(np.sum(log.ekf_substeps[: args.ticks]))

            def _trim(a):
                if a.shape[:1] == (T_avail,):
                    return a[: args.ticks]
                if a.shape[:1] == (T_ekf_avail,):
                    return a[:Te]
                return a

            for f in list(vars(log)):
                setattr(log, f, _trim(getattr(log, f)))
        print(f"replaying raw log {args.raw}: {log.accel_b.shape[0]} ticks")
    else:
        cfg = synth.SynthConfig(T=args.ticks, rate=est_params.rate, seed=args.seed)
        log = synth.generate(cfg)
    dtype = torch.float32

    timings = {}
    if args.gt_orientation:
        R_seq = torch.as_tensor(log.R_sb_gt)
        q_seq = torch.as_tensor(log.q_gt)
    else:
        with scoped_timer("orientation EKF", timings):
            R_seq, q_seq = estimator.ekf_orientation_sequence(
                ekf_params, log, dtype=dtype, device=device)

    data = estimator.tickdata_from_log(log, R_sb=R_seq.cpu().numpy(), dtype=dtype,
                                       device=device)
    vo = estimator.vodata_from_log(log, dtype=dtype, device=device)

    with scoped_timer("estimator replay", timings):
        if est_params.est_type == 0:
            x_seq, v_seq = estimator.run_mhe(est_params, data, vo=vo, dtype=dtype,
                                             device=device)
        else:
            x_seq, v_seq = estimator.run_kf(est_params, data, dtype=dtype, device=device)
        x_seq = x_seq.cpu().numpy()
        v_seq = v_seq.cpu().numpy()

    T = x_seq.shape[0]
    skip = min(100, T // 2)
    rmse = float(np.sqrt(((x_seq[skip:, 3:6] - log.gt_v_s[skip:T]) ** 2).mean()))
    cycle_us = timings["estimator replay"] / T * 1e6
    print(f"velocity RMSE vs GT: {rmse:.4f} m/s over {T} ticks")
    print(f"replay wall: {timings['estimator replay']:.2f}s "
          f"({cycle_us:.1f} us/tick amortized; realtime budget 5000 us)")

    # Data_Logger-compatible output (channel set of EstSub.cpp:96-120)
    gt_q = torch.as_tensor(np.asarray(log.q_gt[:T], np.float64))
    filter_euler = quat.to_euler(q_seq[:T].double().cpu()).numpy()
    gt_euler = quat.to_euler(gt_q).numpy()
    gt_v_b = np.einsum("tij,tj->ti", quat.to_rot(gt_q).numpy(), log.gt_v_s[:T])
    lg = log_io.DataLogger(est_params.log_name, args.log_dir)
    s = est_params.dim_state
    for name, ln in [("pose", 3), ("GT_v", 3), ("v_body", 3), ("x_MHE", s),
                     ("p_vo_accmulate_", 3), ("filter_euler_", 3), ("gt_euler_", 3)]:
        lg.add_channel(name, "VectorXd", ln)
    lg.log_sequence({
        "pose": log.gt_p[:T], "GT_v": gt_v_b, "v_body": v_seq,
        "x_MHE": x_seq, "p_vo_accmulate_": np.zeros((T, 3)),
        "filter_euler_": filter_euler, "gt_euler_": gt_euler,
    })
    lg.close()
    print(f"wrote {lg._data_path} (+ _Name.csv)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
