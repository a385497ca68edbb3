"""A VO-free lane breaks down in float32, in the JAX package as in the port.

Without any visual odometry the absolute position of an instance is held by
the arrival cost alone, whose information the float32 marginalization loses
to cancellation against the process model's position weight: after several
hundred ticks such a lane's estimate goes non-finite (ROADMAP.md, fault F5).
``chip_smoke.py`` reports it for the port's kernels and plain versions on the
card. Here both packages get the same inputs on the CPU — 16 perturbed
instances of the Go1 log with no VO event, 1500 ticks, the Go1 bench's noise
settings — through their ``run_mhe_lanes`` in float32, and the first
non-finite tick of each lane is printed (``pytest -s``). In both packages some
lane breaks down; which lanes, and when, depends on the rounding of each.
"""

import jax.numpy as jnp
import numpy as np
import torch

from decentralized_ekf_mhe_tpu.config import EstimatorParams as JParams
from decentralized_ekf_mhe_tpu.ops import estimator as jest
from decentralized_ekf_mhe_tpu_torch.config import EstimatorParams
from decentralized_ekf_mhe_tpu_torch.io import synth
from decentralized_ekf_mhe_tpu_torch.ops import estimator
from decentralized_ekf_mhe_tpu_torch.parallel import batch

T, B = 1500, 16
GO1 = dict(num_legs=4, leg_odom_type=0, rate=200, N=20,
           p_process_std=[0.001] * 3, accel_input_std=[0.025, 0.025, 0.02],
           gyro_input_std=[0.03] * 3, accel_bias_std=[0.07, 0.02, 0.03],
           joint_position_std=[0.04] * 3, joint_velocity_std=[0.22] * 3,
           foot_slide_std=[0.003] * 3, foot_swing_std=[1e7] * 3, vo_p_std=[1.5e-5] * 3)


def _first_nonfinite(x):
    """First tick at which lane b of x (T,B,s) is not finite, or None."""
    bad = ~np.isfinite(x).all(-1)
    return [int(np.nonzero(bad[:, b])[0][0]) if bad[:, b].any() else None
            for b in range(x.shape[1])]


def test_vo_free_lanes_break_down_in_float32_in_both_packages():
    p = EstimatorParams(**GO1)
    log = synth.generate(synth.SynthConfig(T=T, seed=0))
    data = estimator.tickdata_from_log(log, dtype=torch.float64, device="cpu")
    data_b = batch.perturb_log_batch(data, B, torch.Generator().manual_seed(0), p,
                                     dtype=torch.float64)
    data_l = batch.tickdata_to_lanes(batch.to_time_leading(data_b))
    data_l = estimator.TickData(*(a.float() if a.is_floating_point() else a for a in data_l))
    vo = estimator.VOData(active=torch.zeros((T, B), dtype=torch.bool),
                          dp_body=torch.zeros((T, 3, B)),
                          tick_pre=torch.zeros((T, B), dtype=torch.int32),
                          tick_now=torch.zeros((T, B), dtype=torch.int32))

    x, _ = estimator.run_mhe_lanes(p, data_l, vo=vo, dtype=torch.float32, device="cpu")
    jx, _ = jest.run_mhe_lanes(JParams(**GO1),
                               jest.TickData(*(jnp.asarray(a.numpy()) for a in data_l)),
                               vo=jest.VOData(*(jnp.asarray(a.numpy()) for a in vo)),
                               dtype=jnp.float32)
    first = {"port": _first_nonfinite(x.numpy()), "jax": _first_nonfinite(np.asarray(jx))}
    print("first non-finite tick per VO-free lane, float32:", first)
    assert x.dtype == torch.float32 and jx.dtype == jnp.float32
    for side, ticks in first.items():
        assert any(t is not None for t in ticks), (side, "no VO-free lane broke down", first)
        # finite through the first several hundred ticks
        assert min(t for t in ticks if t is not None) > 300, (side, first)
