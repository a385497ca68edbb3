"""Multi-robot pipeline driver: Go1 / Cassie / PogoX (BASELINE configs 1-3).

Counterpart of the reference's ``examples/run_robot.py``: like ``run_go1``
but covering all three demonstrated robots, with optional state constraints
(PogoX high-dynamic-range velocity bounds through the box-ADMM path). Cassie
and PogoX read ``configs/parameters_{cassie,pogox}.yaml``; Go1 is the
reference bench's estimator (``tools/roofline.bench_params``).

Usage:
    python -m decentralized_ekf_mhe_tpu_torch.examples.run_robot
        --robot {go1,cassie,pogox} [--ticks N] [--v-limit V] [--cpu]
"""

import argparse
import os
import sys

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs")
ROBOTS = ("cassie", "go1", "pogox")
GAITS = {
    "go1": dict(num_legs=4, gait_hz=2.5, duty=0.6),
    "cassie": dict(num_legs=2, gait_hz=1.6, duty=0.55),
    "pogox": dict(num_legs=1, gait_hz=1.8, duty=0.45),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--robot", choices=ROBOTS, default="go1")
    ap.add_argument("--ticks", type=int, default=600)
    ap.add_argument("--v-limit", type=float, default=None,
                    help="symmetric velocity box constraint (m/s) -> ADMM path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from decentralized_ekf_mhe_tpu_torch.config import load_yaml_params
    from decentralized_ekf_mhe_tpu_torch.io import synth
    from decentralized_ekf_mhe_tpu_torch.ops import estimator, mhe
    from decentralized_ekf_mhe_tpu_torch.tools.roofline import bench_params

    device = "cpu" if args.cpu else "cuda"
    if args.robot == "go1":
        est_params = bench_params()
    else:
        est_params, _ = load_yaml_params(os.path.join(CONFIGS, f"parameters_{args.robot}.yaml"))
    g = GAITS[args.robot]
    print(f"{args.robot}: dims s/m={est_params.dim_state}/{est_params.dim_meas} "
          f"leg_odom_type={est_params.leg_odom_type} N={est_params.N} device={device}")

    log = synth.generate(synth.SynthConfig(
        T=args.ticks, rate=est_params.rate, seed=args.seed, **g))
    dtype = torch.float32
    data = estimator.tickdata_from_log(log, dtype=dtype, device=device)
    vo = estimator.vodata_from_log(log, dtype=dtype, device=device)

    consts = None
    if args.v_limit is not None:
        s = est_params.dim_state
        lb = np.full(s, -np.inf)
        ub = np.full(s, np.inf)
        lb[3:6], ub[3:6] = -args.v_limit, args.v_limit
        consts = mhe.make_consts(est_params, dtype, x_lb=lb, x_ub=ub, admm_iters=300,
                                 device=device)
        print(f"state constraints: |v| <= {args.v_limit} m/s (ADMM path)")

    x, _ = estimator.run_mhe(est_params, data, vo=vo, dtype=dtype, consts=consts,
                             device=device)
    x = x.cpu().numpy()
    T = x.shape[0]
    skip = min(100, T // 2)
    rmse = float(np.sqrt(((x[skip:, 3:6] - log.gt_v_s[skip:T]) ** 2).mean()))
    print(f"velocity RMSE vs GT: {rmse:.4f} m/s over {T} ticks")
    if args.v_limit is not None:
        print(f"max |v| estimate: {np.abs(x[:, 3:6]).max():.3f} "
              f"(bound {args.v_limit})")
    if not np.isfinite(x).all():
        raise SystemExit("non-finite estimate")
    return 0


if __name__ == "__main__":
    sys.exit(main())
