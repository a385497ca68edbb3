"""PyTorch port vs the JAX package: the stage ablation of the MHE tick (K2e)
on per-lane camera clocks.

Every lane follows its own camera clock (a frame every 3 ticks, 1 + b ticks
late; the last lane VO-free), at Go1's shape, N=5, T=18, B=3, float64 on the
CPU: each stage of the Gauss-Jordan tick against the Pallas kernel with
``per_instance=True`` and the same ``ablate`` in interpret mode, with equal
positions of non-finite values (the port's plain version runs the per-lane
ingestion, ``mhe_lanes._apply_vo_per_instance``). With the Cholesky tail the
"assembly" and "solve" stages never reach the tail: the port holds them equal
to the Gauss-Jordan tick's on the same clocks (the reference's are equal too),
and routes them to the same units.
"""

import functools

import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu.ops import mhe as jmhe
from decentralized_ekf_mhe_tpu.pallas import mhe_replay_kernel as jmrk
from decentralized_ekf_mhe_tpu_torch.kernels import _build
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import mhe
from test_torch_ablate import DT, F64, STAGES, _hold
from test_torch_chol_clocks import B_LANES, T_LOG, _fleet, _params

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_x(stage):
    """The Pallas kernel's x on the per-lane-clock Go1 fleet, stage skipped
    (one interpret-mode replay per stage in this module)."""
    data_l, vo = _fleet("go1")[:2]
    return np.asarray(jmrk.replay(jmhe.make_consts(_params("go1")[0], DT), data_l, vo,
                                  dtype=DT, interpret=True, ablate=stage))


@pytest.mark.parametrize("stage", STAGES)
def test_per_lane_clock_stage_matches_pallas_interpret(stage):
    """``replay(..., ablate=stage)`` on per-lane clocks (the plain version of
    the ``mhe_<tag>_abl_pi_*`` units) against the Pallas kernel with
    ``per_instance=True`` and the same ``ablate``: the same non-finite
    positions, the finite values to rtol/atol 1e-8; the stage changes the
    estimate, and the ingest stage leaves every lane as the VO-free one's
    schedule would (no camera terms anywhere)."""
    _, _, tdata, tvo = _fleet("go1")
    tc = mhe.make_consts(_params("go1")[1], F64, device="cpu")
    tx = mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu", ablate=stage).numpy()
    jx = _jax_x(stage)
    assert tx.shape == jx.shape == (T_LOG, 9, B_LANES)
    fin = _hold(tx, jx)
    assert fin[0].all() and fin[1:].any() == (stage != "build")
    full = mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu").numpy()
    assert not np.allclose(tx[1:], full[1:], equal_nan=True)
    if stage == "ingest":   # the VO-free lane's estimate is the full tick's
        np.testing.assert_array_equal(tx[:, :, -1], full[:, :, -1])
    assert mrk.kernel_library(9, 12, 4, 0, True, ablate=stage) == "mhe_go1_abl_pi_f64"


@pytest.mark.parametrize("stage", _build.TAIL_FREE_STAGES)
def test_tail_free_stages_of_the_cholesky_tick_are_the_gauss_jordan_ones(stage):
    """With the Cholesky tail the "assembly" and "solve" stages never reach
    the tail (the reference tests ``ablate`` before ``mk_solve``): on either
    clock the port's result equals the Gauss-Jordan tick's bit for bit, and
    the kernel route takes the Gauss-Jordan tick's unit of that clock."""
    for per_lane in (True, False):
        model = "go1"
        _, _, tdata, tvo = _fleet(model)
        if not per_lane:
            tvo = tvo._replace(active=tvo.active[:, 0].contiguous(),
                               tick_pre=tvo.tick_pre[:, 0].contiguous(),
                               tick_now=tvo.tick_now[:, 0].contiguous())
        tc = mhe.make_consts(_params(model)[1], F64, device="cpu")
        xs = {tail: mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu", mk_solve=tail,
                               ablate=stage) for tail in mrk.MK_SOLVES}
        assert torch.equal(xs["chol"], xs["gj"])
        assert mrk.ablate_variant(False, per_lane, "chol", stage) == ("pi" if per_lane else "")
        assert mrk.kernel_library(9, 12, 4, 0, per_lane, chol=True, ablate=stage) == (
            "mhe_go1_abl_pi_f64" if per_lane else "mhe_go1_abl_f64")
