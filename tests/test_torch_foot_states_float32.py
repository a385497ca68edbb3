"""Cassie's foot-position states break down in float32, in the JAX package as in the port.

With Cassie's parameter file (``configs/parameters_cassie.yaml``: 2 legs, foot
positions as states, s=15) the window's information matrices span about
thirteen decades — the position process weight (``p_process_std`` 0.001 m at
200 Hz) against the weight of a swinging foot (``foot_swing_std`` 1e4) — and
after a thousand-odd ticks the float32 arrival-cost Schur complement is no
longer positive definite: every instance's estimate goes non-finite
(ROADMAP.md, fault F6). ``chip_smoke.py`` shows it on the card and holds the
Cassie float32 gates over the ticks before it. Here both packages get the same
inputs on the CPU — 2 perturbed instances of the Cassie log the chip run uses
(seed 2), 2000 ticks, with VO — through their ``run_mhe_lanes`` in float32,
and the reference's in float64 too; the first non-finite tick of each lane and
each package's largest float32-float64 velocity difference per 100 ticks are
printed (``pytest -s``). Both drift from float64 long before they break down,
and both break down; when depends on the rounding of each.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

from decentralized_ekf_mhe_tpu import config as jconfig
from decentralized_ekf_mhe_tpu.ops import estimator as jest
from decentralized_ekf_mhe_tpu_torch import config
from decentralized_ekf_mhe_tpu_torch.io import synth
from decentralized_ekf_mhe_tpu_torch.ops import estimator
from decentralized_ekf_mhe_tpu_torch.parallel import batch

T, B = 2000, 2
CASSIE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "parameters_cassie.yaml")


def _first_nonfinite(x):
    """First tick at which lane b of x (T,B,s) is not finite, or None."""
    bad = ~np.isfinite(x).all(-1)
    return [int(np.nonzero(bad[:, b])[0][0]) if bad[:, b].any() else None
            for b in range(x.shape[1])]


def _gap_per_100(x32, x64):
    """Largest |v32 - v64| per 100 ticks (inf where a value is not finite)."""
    d = np.abs(x32[..., 3:6].astype(np.float64) - x64[..., 3:6]).reshape(T // 100, -1)
    return [float(r.max()) if np.isfinite(r).all() else np.inf for r in d]


def test_cassie_float32_breaks_down_in_both_packages():
    p, _ = config.load_yaml_params(CASSIE)
    jp, _ = jconfig.load_yaml_params(CASSIE)
    assert (p.dim_state, p.leg_odom_type) == (jp.dim_state, jp.leg_odom_type) == (15, 1)
    log = synth.generate(synth.SynthConfig(T=T, seed=2, num_legs=p.num_legs))
    g = torch.Generator().manual_seed(0)
    data = estimator.tickdata_from_log(log, dtype=torch.float64, device="cpu")
    vo = estimator.vodata_from_log(log, dtype=torch.float64, device="cpu")
    data_l = batch.tickdata_to_lanes(batch.to_time_leading(
        batch.perturb_log_batch(data, B, g, p, dtype=torch.float64)))
    vo_b = batch.perturb_vo_batch(vo, B, g, p, dtype=torch.float64)
    f32 = lambda nt: type(nt)(*(a.float() if a.is_floating_point() else a for a in nt))
    data_l, vo_b = f32(data_l), f32(vo_b)
    assert int(vo_b.active.sum()) > 100

    x, _ = estimator.run_mhe_lanes(p, data_l, vo=vo_b, dtype=torch.float32, device="cpu")
    jdata = jest.TickData(*(jnp.asarray(a.numpy()) for a in data_l))
    jvo = jest.VOData(*(jnp.asarray(a.numpy()) for a in vo_b))
    jx, _ = jest.run_mhe_lanes(jp, jdata, vo=jvo, dtype=jnp.float32)
    # the reference in float64 on the same (float32-valued) inputs
    f64 = lambda nt: type(nt)(*(a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
                                else a for a in nt))
    jx64, _ = jest.run_mhe_lanes(jp, f64(jdata), vo=f64(jvo), dtype=jnp.float64)
    jx64 = np.asarray(jx64)
    assert np.isfinite(jx64).all()
    first = {"port": _first_nonfinite(x.numpy()), "jax": _first_nonfinite(np.asarray(jx))}
    gap = {"port": _gap_per_100(x.numpy(), jx64), "jax": _gap_per_100(np.asarray(jx), jx64)}
    print("first non-finite tick per Cassie lane, float32:", first)
    print("largest float32-float64 velocity difference per 100 ticks:",
          {k: ["%.2e" % g for g in v] for k, v in gap.items()})
    assert x.dtype == torch.float32 and jx.dtype == jnp.float32
    for side, ticks in first.items():
        assert any(t is not None for t in ticks), (side, "no lane broke down", first)
        # finite through the first several hundred ticks
        t_bad = min(t for t in ticks if t is not None)
        assert t_bad > 500, (side, first)
        # float32 holds velocity to float64 within 1e-3 over the first 200
        # ticks, then drifts: by at least ten times that before it breaks down
        g = gap[side]
        assert max(g[:2]) < 1e-3, (side, gap)
        assert max(g[2:t_bad // 100]) > 10 * max(g[:2]), (side, gap)
