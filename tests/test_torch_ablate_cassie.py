"""PyTorch port vs the JAX package: the stage ablation of the MHE tick (K2e)
at Cassie's shape.

Cassie's estimator from its parameter file (foot positions as states: s=15,
m=6, L=2, leg_odom_type=1) at N=5, T=18, B=3, float64 on the CPU, on the
shared camera clock with the Gauss-Jordan tail: each stage against the Pallas
kernel with the same ``ablate`` in interpret mode, with equal positions of
non-finite values, the finite values to rtol/atol 1e-8 — but for the "solve"
stage, whose value is a sum of the assembled system's entries that cancel by
ten decades: at this shape the two packages' orders of summation leave
4e-8 in it, so it is held as chip_smoke.py's check_ablation and
test_torch_tick_group.py hold it, to ATOL_SOLVE + RTOL_SOLVE times the
magnitude of its elementary products (``mrk.solve_stage_scales``; 0.61 of
that limit here). The port runs it in ``mhe_cassie_abl_*``; its other
compositions (per-lane clocks, the Cholesky tail, box consts) share their
code with Go1's, which the other ``test_torch_ablate_*`` files hold against
the reference, and chip_smoke.py holds every unit of each against its plain
version on the card.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu import config as jconfig
from decentralized_ekf_mhe_tpu.io import synth as jsynth
from decentralized_ekf_mhe_tpu.ops import estimator as jest
from decentralized_ekf_mhe_tpu.ops import mhe as jmhe
from decentralized_ekf_mhe_tpu.pallas import mhe_replay_kernel as jmrk
from decentralized_ekf_mhe_tpu.parallel import batch as jbatch
from decentralized_ekf_mhe_tpu_torch import config, convert
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import mhe
from test_torch_ablate import B_LANES, DT, F64, N_WIN, REPO, STAGES, T_LOG, TOL, _hold, _tick_inputs
from test_torch_tick_group import ATOL_SOLVE, RTOL_SOLVE

torch.set_num_threads(1)


def _params():
    """(JAX params, port params) from Cassie's file at window N_WIN."""
    path = os.path.join(REPO, "configs", "parameters_cassie.yaml")
    jp, tp = jconfig.load_yaml_params(path)[0], config.load_yaml_params(path)[0]
    jp.N = tp.N = N_WIN
    return jp, tp


@functools.lru_cache(maxsize=None)
def _fleet():
    """Cassie's synthetic log (seed 2; a VO frame every 3 ticks) as a
    JAX-perturbed fleet on the shared camera clock: (JAX lanes TickData, JAX
    VOData, port lanes TickData, port VOData)."""
    jp = _params()[0]
    log = jsynth.generate(jsynth.SynthConfig(T=T_LOG, seed=2, num_legs=jp.num_legs,
                                             vo_every=3, vo_latency=1))
    data_l = jbatch.tickdata_to_lanes(jbatch.to_time_leading(jbatch.perturb_log_batch(
        jest.tickdata_from_log(log, dtype=DT), B_LANES, jax.random.PRNGKey(0), jp, dtype=DT)))
    vo = jbatch.perturb_vo_batch(jest.vodata_from_log(log, dtype=DT), B_LANES,
                                 jax.random.PRNGKey(2), jp, dtype=DT)
    tdata, tvo = (convert.from_jax_numpy(jax.tree.map(np.asarray, a), "cpu", F64)
                  for a in (data_l, vo))
    return data_l, vo, tdata, tvo


@pytest.mark.parametrize("stage", STAGES)
def test_cassie_stage_matches_pallas_interpret(stage):
    """``replay(..., ablate=stage)`` at Cassie's shape (the plain version of
    the ``mhe_cassie_abl_*`` units) against the Pallas kernel with the same
    ``ablate``: the same non-finite positions, the finite values to rtol/atol
    1e-8; the stage changes the estimate."""
    data_l, vo, tdata, tvo = _fleet()
    jx = np.asarray(jmrk.replay(jmhe.make_consts(_params()[0], DT), data_l, vo, dtype=DT,
                                interpret=True, ablate=stage))
    tc = mhe.make_consts(_params()[1], F64, device="cpu")
    tx = mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu", ablate=stage).numpy()
    assert tx.shape == jx.shape == (T_LOG, 15, B_LANES)
    if stage == "solve":
        terms = mrk.solve_stage_scales(tc, *_tick_inputs(tc, tdata, tvo))["terms"].numpy()
        np.testing.assert_allclose(tx[0], jx[0], **TOL)
        assert (np.abs(tx[1:] - jx[1:]) <= ATOL_SOLVE + RTOL_SOLVE * terms).all()
        fin = np.isfinite(jx)
        assert fin.all() and np.isfinite(tx).all()
    else:
        fin = _hold(tx, jx)
    assert fin[0].all() and fin[1:].any() == (stage != "build")
    full = mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu").numpy()
    assert not np.allclose(tx[1:], full[1:], equal_nan=True)
    assert mrk.kernel_library(15, 6, 2, 1, False, ablate=stage) == "mhe_cassie_abl_f64"
