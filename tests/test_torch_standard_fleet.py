"""PyTorch port vs the JAX package: the standard-layout fleet runners.

``make_fused_batched_runner(use_pallas=True)`` — every tick's window solve on
the block-tridiagonal kernel's standard-layout route, whose plain version CPU
tensors take — against the reference's fused runner (its Pallas route has no
CPU path outside interpret mode, so the reference runs ``use_pallas=False``),
against this package's ``make_batched_runner`` bit for bit (as the
reference's own test holds its vmapped and fused runners), and against the
lanes fleet runner at the reference's lanes-vs-standard tolerance; and
``mhe_window_solve_batch`` on warm-up and full windows. float64 on the CPU,
inputs perturbed once on the JAX side and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu.config import EstimatorParams as JParams
from decentralized_ekf_mhe_tpu.io import synth as jsynth
from decentralized_ekf_mhe_tpu.ops import bezier as jbez
from decentralized_ekf_mhe_tpu.ops import estimator as jest
from decentralized_ekf_mhe_tpu.ops import mhe as jmhe
from decentralized_ekf_mhe_tpu.parallel import batch as jbatch
from decentralized_ekf_mhe_tpu_torch import convert
from decentralized_ekf_mhe_tpu_torch.config import EstimatorParams
from decentralized_ekf_mhe_tpu_torch.kernels import tridiag_kernel
from decentralized_ekf_mhe_tpu_torch.ops import lanes, mhe, mhe_lanes
from decentralized_ekf_mhe_tpu_torch.parallel import batch

torch.set_num_threads(1)

CPU, F64 = torch.device("cpu"), torch.float64
TOL = dict(rtol=1e-8, atol=1e-8)
TOL_LANES = dict(rtol=1e-7, atol=1e-8)   # tests/test_mhe_lanes.py:157
T, B, N = 40, 3, 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(cls):
    return cls(num_legs=4, leg_odom_type=0, rate=200, N=N, foot_swing_std=[1e7] * 3)


@pytest.fixture(scope="module")
def fleet():
    """A B=3 Go1 fleet: the reference's Monte-Carlo sensor noise
    (perturb_log_batch) and a VO translation per instance (dp_body (T,B,3)).
    Returns (JAX data (T,B,...), JAX VOData, port data (B,T,...), port
    VOData)."""
    log = jsynth.generate(jsynth.SynthConfig(T=T, seed=3))
    data = jest.tickdata_from_log(log, dtype=jnp.float64)
    vo = jest.vodata_from_log(log, dtype=jnp.float64)
    db = jbatch.perturb_log_batch(data, B, jax.random.PRNGKey(0), dtype=jnp.float64)
    rng = np.random.default_rng(4)
    dp = (np.asarray(vo.dp_body)[:, None, :]
          + 1e-4 * rng.standard_normal((T, B, 3)) * np.asarray(vo.active)[:, None, None])
    vo = vo._replace(dp_body=jnp.asarray(dp))
    assert int(np.asarray(vo.active).sum()) >= 4
    return (jbatch.to_time_leading(db), vo, convert.from_jax_numpy(_np(db), CPU, F64),
            convert.from_jax_numpy(_np(vo), CPU, F64))


@pytest.fixture(scope="module")
def fused(fleet):
    """The port's fused runner on the standard-layout route, counting the
    route's calls: (x, v, calls)."""
    _, _, data_b, vo = fleet
    calls = []
    inner = tridiag_kernel.solve_batched

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return inner(*a, **kw)

    tridiag_kernel.solve_batched = spy
    try:
        run = batch.make_fused_batched_runner(_params(EstimatorParams), F64, use_pallas=True,
                                              device="cpu")
        x, v = run(batch.to_time_leading(data_b), vo)
    finally:
        tridiag_kernel.solve_batched = inner
    return x, v, calls


def test_fused_runner_matches_reference(fleet, fused):
    data_tb, vo, _, _ = fleet
    jx, jv = jax.jit(jbatch.make_fused_batched_runner(_params(JParams), jnp.float64,
                                                      use_pallas=False))(data_tb, vo)
    x, v, calls = fused
    assert x.shape == (T, B, 9) and v.shape == (T, B, 3)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    # every tick's window solve (tick 0 and the T-1 steps) took the route
    assert calls == [(N, B, 9, 9)] * T


def test_fused_runner_equals_batched_runner_bitwise(fleet, fused):
    _, _, data_b, vo = fleet
    xb, vb = batch.make_batched_runner(_params(EstimatorParams), F64, device="cpu")(data_b, vo)
    x, v, _ = fused
    assert torch.equal(xb, x.transpose(0, 1)) and torch.equal(vb, v.transpose(0, 1))
    # without VO, both runners agree too
    x0, _ = batch.make_batched_runner(_params(EstimatorParams), F64, with_vo=False,
                                      device="cpu")(data_b)
    xf0, _ = batch.make_fused_batched_runner(_params(EstimatorParams), F64,
                                             device="cpu")(batch.to_time_leading(data_b))
    assert torch.equal(x0, xf0.transpose(0, 1))


def test_fused_runner_matches_lanes_runner(fleet, fused):
    _, _, data_b, vo = fleet
    vo_l = vo._replace(dp_body=vo.dp_body.permute(0, 2, 1).contiguous())   # (T,3,B)
    xl, vl = batch.make_lanes_fleet_runner(_params(EstimatorParams), F64, use_megakernel=True,
                                           device="cpu")(batch.to_time_leading(data_b), vo_l)
    x, v, _ = fused
    np.testing.assert_allclose(x.numpy(), xl.numpy(), **TOL_LANES)
    np.testing.assert_allclose(v.numpy(), vl.numpy(), **TOL_LANES)


def _to_jax_state(st):
    """A port MHEState -> the reference's, leaf by leaf."""
    j = lambda a: jnp.asarray(a.numpy())
    fields = {f: j(getattr(st, f)) for f in jmhe.MHEState._fields if f not in ("T", "bez")}
    return jmhe.MHEState(T=jnp.asarray(st.T, jnp.int32),
                         bez=jbez.BezierCarry(*(j(a) for a in st.bez[:2]),
                                              jnp.asarray(st.bez.count, jnp.int32),
                                              j(st.bez.p_accum)), **fields)


def test_mhe_window_solve_batch_matches(fleet):
    """The window solve alone on the fleet's state at a warm-up tick (T < N)
    and on a full window with VO terms; and the lanes twin of the state."""
    _, _, data_b, vo = fleet
    p = _params(EstimatorParams)
    c = mhe.make_consts(p, F64, device="cpu")
    d = batch.to_time_leading(data_b)
    R_pre = d.R_sb[vo.tick_pre.long()]
    tick = lambda t: [a[t] for a in (d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq,
                                     d.contact)]
    st = mhe.init(c, *tick(0), dtype=F64, device="cpu")
    solve = batch.mhe_window_solve_batch(p, F64, device="cpu")
    jsolve = jax.jit(jbatch.mhe_window_solve_batch(_params(JParams), jnp.float64))
    states = {}
    for t in range(1, T):
        st, _ = mhe.step(c, st, *tick(t), bool(vo.active[t]), vo.dp_body[t],
                         int(vo.tick_pre[t]), int(vo.tick_now[t]), R_pre[t])
        if t == 3:
            states["warm-up"] = st
        if bool(st.cam_active.any()):
            states["full, VO terms"] = st
    assert set(states) == {"warm-up", "full, VO terms"}
    for tag, st in states.items():
        x = solve(st)
        assert x.shape == (B, N, 9)
        np.testing.assert_allclose(x.numpy(), np.asarray(jsolve(_to_jax_state(st))), **TOL)
        if tag == "warm-up":
            assert float(x[:, :N - 4].abs().max()) == 0.0      # dead warm-up slots
    # the lanes twin of a standard state solves the same window
    x_l = mhe_lanes.solve_window(c, mhe_lanes.to_lanes_state(st))
    np.testing.assert_allclose(lanes.from_lanes(x_l).numpy(), solve(st).numpy(), **TOL)
