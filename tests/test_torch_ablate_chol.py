"""PyTorch port vs the JAX package: the stage ablation of the MHE tick (K2e)
with the Cholesky tail.

Where the ablated window is singular ("build" zeros the fresh slot) the
Gauss-Jordan and the Cholesky chains break down in different places, so the
port's plain version of the Cholesky tick's ablation runs its own Cholesky
sweep (``mhe_replay_kernel._chol_sweep``, the reference's ``_chol``,
``_trsm_l``, ``_trsv_l`` and ``_trsv_lt``). At Go1's shape, N=5, T=18, B=3,
float64 on the CPU: the stages before the tail ("ingest", "marg", "build") on
the shared camera clock, and "build" on per-lane clocks, against the Pallas
kernel with ``mk_solve="chol"`` and the same ``ablate`` in interpret mode,
with equal positions of non-finite values; and the sweep alone against the
window's exact solve.
"""

import functools

import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu.ops import mhe as jmhe
from decentralized_ekf_mhe_tpu.pallas import mhe_replay_kernel as jmrk
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import mhe, mhe_lanes
import test_torch_chol_clocks as clocks
from test_torch_ablate import B_LANES, DT, F64, T_LOG, _fleet, _hold, _params, _tick_inputs

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_x(stage, per_lane):
    """The Pallas kernel's x with the Cholesky tail and stage skipped, on the
    Go1 fleet of the shared clock or of per-lane clocks (one interpret-mode
    replay per case in this module)."""
    data_l, vo = (clocks._fleet("go1") if per_lane else _fleet(4))[:2]
    return np.asarray(jmrk.replay(jmhe.make_consts(_params()[0], DT), data_l, vo, dtype=DT,
                                  interpret=True, ablate=stage, mk_solve="chol"))


@pytest.mark.parametrize("stage,per_lane", [
    pytest.param("ingest", False, id="ingest"), pytest.param("marg", False, id="marg"),
    pytest.param("build", False, id="build"), pytest.param("build", True, id="pi-build")])
def test_cholesky_stage_matches_pallas_interpret(stage, per_lane):
    """``replay(..., mk_solve="chol", ablate=stage)`` (the plain version of
    the ``mhe_<tag>_abl_chol_*`` units) against the Pallas kernel with the
    Cholesky tail and the same ``ablate``: the same non-finite positions, the
    finite values to rtol/atol 1e-8. At "build" the Cholesky chain leaves
    other non-finite positions than the Gauss-Jordan chain on the same
    singular windows; before the tail breaks down the two tails agree."""
    _, _, tdata, tvo = clocks._fleet("go1") if per_lane else _fleet(4)
    tc = mhe.make_consts(_params()[1], F64, device="cpu")
    tx = mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu", mk_solve="chol",
                    ablate=stage).numpy()
    jx = _jax_x(stage, per_lane)
    assert tx.shape == jx.shape == (T_LOG, 9, B_LANES)
    fin = _hold(tx, jx)
    assert fin[0].all()
    gj = mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu", ablate=stage).numpy()
    if stage == "build":
        assert not np.array_equal(np.isfinite(gj), fin)
    else:
        assert fin.all()
        np.testing.assert_allclose(tx, gj, rtol=1e-9, atol=1e-10)
    assert mrk.kernel_library(9, 12, 4, 0, per_lane, chol=True, ablate=stage) == (
        "mhe_go1_abl_pi_chol_f64" if per_lane else "mhe_go1_abl_chol_f64")


def test_cholesky_sweep_solves_a_regular_window():
    """``_chol_sweep`` on the windows of an unablated replay gives the
    newest state of the exact window solve (``mhe_lanes.solve_window``) to
    1e-10: the same sweep, only another chain of roundings. The plain
    version sweeps every tick's window at once, side by side on the lane
    axis: bit for bit what one tick at a time gives, on the singular
    windows of "build" too."""
    _, _, tdata, tvo = _fleet(4)
    tc = mhe.make_consts(_params()[1], F64, device="cpu")
    ks, d, v, i = _tick_inputs(tc, tdata, tvo)
    st = mrk.mhe_state_from_kernel(mrk.replay_ticks(tc, ks, d, v, i, device="cpu")[1], tc)
    x_chol = mrk._chol_sweep(*mhe_lanes._masked_system(tc, st))
    x_exact = mhe_lanes.solve_window(tc, st)[tc.N - 1]
    torch.testing.assert_close(x_chol, x_exact, rtol=1e-10, atol=1e-10)
    for stage in ("marg", "build"):
        x_batch, _ = mrk.replay_ticks_plain(tc, ks, d, v, i, ablate=stage, mk_solve="chol")
        st, xs = mrk.mhe_state_from_kernel(ks, tc), []
        act, pre, now = v.active.tolist(), v.tick_pre.tolist(), v.tick_now.tolist()
        for t in range(d.accel_b.shape[0]):
            d_t = (d.R_sb[t], d.accel_b[t], d.omega_b[t], d.p_foot[t], d.J_foot[t], d.dq[t],
                   d.contact[t])
            st, x_t, _ = mrk._step_ablated(tc, st, *d_t, act[t], pre[t], now[t], i[t], stage,
                                           "chol")
            xs.append(x_t)
        assert torch.equal(torch.stack(xs).nan_to_num(), x_batch.nan_to_num())
        assert torch.equal(torch.stack(xs).isnan(), x_batch.isnan())
