"""PyTorch port vs the JAX package: the stage ablation of the constrained MHE
tick (K2e with box consts).

With state box constraints the window solve is the warm-started box-ADMM,
and the stages are skipped in the tick's one-thread prelude before it:
"ingest", "marg", "build", and "assembly" (x = n_p after the shift and the
z/y warm-start shift; no ADMM). The reference defines no "solve" stage there:
its constrained loop hands the window to the ADMM before the stage's sum and
never sets it, so the JAX kernel fails to trace (``TypeError``) and the port
raises ``ValueError`` before any route. At Go1's shape, N=5, T=18, B=3,
float64 on the CPU, a velocity box that binds (|v| <= 0.05, fixed rho 5000,
polish, OSQP tolerances 1e-8, 20 iterations): each stage on the shared
camera clock, and "ingest" on per-lane clocks, against the Pallas kernel with
the same ``ablate`` in interpret mode, with equal positions of non-finite
values.
"""

import functools

import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu.ops import mhe as jmhe
from decentralized_ekf_mhe_tpu.pallas import mhe_replay_kernel as jmrk
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import mhe
import test_torch_chol_clocks as clocks
from test_torch_ablate import B_LANES, DT, F64, T_LOG, _fleet, _hold, _params, _tick_inputs

torch.set_num_threads(1)

V_BOX = 0.05


def _consts():
    """(JAX, port) box consts of Go1's params at N=5."""
    jp, tp = _params()
    for p in (jp, tp):
        p.osqp.rho, p.osqp.adapt_rho, p.osqp.polish = 5000.0, False, True
        p.osqp.abs_tol = p.osqp.relative_tol = 1e-8
    ub = np.full(9, np.inf)
    ub[3:6] = V_BOX
    return (jmhe.make_consts(jp, DT, x_lb=-ub, x_ub=ub, admm_iters=20),
            mhe.make_consts(tp, F64, x_lb=-ub, x_ub=ub, admm_iters=20, use_pallas=True,
                            device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_x(stage, per_lane):
    """The constrained Pallas kernel's x with stage skipped (one
    interpret-mode replay per case in this module)."""
    data_l, vo = (clocks._fleet("go1") if per_lane else _fleet(4))[:2]
    return np.asarray(jmrk.replay(_consts()[0], data_l, vo, dtype=DT, interpret=True,
                                  ablate=stage))


@pytest.mark.parametrize("stage,per_lane", [
    pytest.param("ingest", False, id="ingest"), pytest.param("marg", False, id="marg"),
    pytest.param("build", False, id="build"), pytest.param("assembly", False, id="assembly"),
    pytest.param("ingest", True, id="pi-ingest")])
def test_box_stage_matches_pallas_interpret(stage, per_lane):
    """``replay(..., ablate=stage)`` with box consts (the plain version of the
    ``mhe_<tag>_abl_box_*`` units) against the constrained Pallas kernel with
    the same ``ablate``: the same non-finite positions, the finite values to
    rtol/atol 1e-8; the stage changes the estimate. "assembly" returns the
    arrival cost's vector and runs no ADMM: 0 iterations per tick, and the
    warm starts leave the call as shifted."""
    _, _, tdata, tvo = clocks._fleet("go1") if per_lane else _fleet(4)
    tc = _consts()[1]
    tx = mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu", ablate=stage).numpy()
    jx = _jax_x(stage, per_lane)
    assert tx.shape == jx.shape == (T_LOG, 9, B_LANES)
    fin = _hold(tx, jx)
    assert fin[0].all() and fin[1:].all() == (stage != "build")
    full = mrk.replay(tc, tdata, tvo, dtype=F64, device="cpu").numpy()
    assert not np.allclose(tx[1:], full[1:], equal_nan=True)
    assert mrk.kernel_library(9, 12, 4, 0, per_lane, ablate=stage, constrained=True) == (
        "mhe_go1_abl_pi_box_f64" if per_lane else "mhe_go1_abl_box_f64")
    ks, d, v, i = _tick_inputs(tc, tdata, tvo)
    x, st = mrk.replay_ticks(tc, ks, d, v, i, device="cpu", ablate=stage)
    assert st.iters.shape == (T_LOG - 1, B_LANES) and st.iters.dtype == torch.int32
    if stage == "assembly":
        assert not bool(st.iters.any())
        z0 = mrk.mhe_state_from_kernel(ks, tc).z_adm
        zs = mrk.mhe_state_from_kernel(st, tc).z_adm
        assert torch.equal(zs, z0[-1:].expand_as(z0))   # every slot the shifted newest
    else:
        assert bool((st.iters > 0).all())


def test_box_solve_stage_is_refused(monkeypatch):
    """The "solve" stage with box consts: the JAX kernel fails to trace
    (``TypeError``, its stage's sum is never set), the port raises
    ``ValueError`` on the CPU before either route, naming the reason."""
    data_l, vo, tdata, tvo = _fleet(4)
    with pytest.raises(TypeError, match="not a valid JAX type"):
        jmrk.replay(_consts()[0], data_l, vo, dtype=DT, interpret=True, ablate="solve")

    def route(*a, **k):
        raise AssertionError("a refused ablation reached a route")

    monkeypatch.setattr(mrk, "_launch", route)
    monkeypatch.setattr(mrk, "replay_ticks_plain", route)
    tc = _consts()[1]
    ks, d, v, i = _tick_inputs(tc, tdata, tvo)
    for tail in mrk.MK_SOLVES:
        with pytest.raises(ValueError, match="defines no such stage"):
            mrk.replay_ticks(tc, ks, d, v, i, device="cpu", ablate="solve", mk_solve=tail)
    with pytest.raises(ValueError, match="defines no such stage"):
        mrk.check_ablate(tc, "solve", True, "gj")
