"""Cross-package resume of the carries ``tests/test_torch_aux.py`` leaves out.

In that file's manner (CPU, float64): a snapshot the JAX package writes with
its ``utils/checkpoint.save_carry`` loads into the port's state through the
port's ``load_carry`` and continues to the JAX continuation at 1e-9 — here
a *boxed* lanes state, whose ``z_adm``/``y_adm`` warm-start rings are leaves
(the unconstrained one's are empty tuples), and the carry of the streaming
``PipelineEstimator`` (EKF state, lanes MHE state, orientation ring, tick).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu.config import EKFParams as JEKFParams
from decentralized_ekf_mhe_tpu.config import EstimatorParams as JParams
from decentralized_ekf_mhe_tpu.io import synth
from decentralized_ekf_mhe_tpu.ops import estimator as jest
from decentralized_ekf_mhe_tpu.ops import mhe as jmhe
from decentralized_ekf_mhe_tpu.ops import mhe_lanes as jmhe_lanes
from decentralized_ekf_mhe_tpu.ops.facade import PipelineEstimator as JPipelineEstimator
from decentralized_ekf_mhe_tpu.utils import checkpoint as jcheckpoint
from decentralized_ekf_mhe_tpu_torch.config import EKFParams, EstimatorParams
from decentralized_ekf_mhe_tpu_torch.ops import estimator, mhe, mhe_lanes
from decentralized_ekf_mhe_tpu_torch.ops.facade import PipelineEstimator
from decentralized_ekf_mhe_tpu_torch.utils import checkpoint

from test_torch_aux import CPU, F64, _arrays, _params, _port_run, _tick

torch.set_num_threads(1)

V_BOX = 0.05


def _box_params(cls):
    """test_torch_aux's Go1 estimator (N=10) with the bench's fixed-rho
    box-ADMM settings (rho=5000, polish)."""
    p = _params(cls)
    p.osqp.rho, p.osqp.adapt_rho, p.osqp.polish = 5000.0, False, True
    return p


def _bounds(s):
    ub = np.full(s, np.inf)
    ub[3:6] = V_BOX
    return -ub, ub


def test_cross_package_resume_boxed_lanes_state(tmp_path):
    """A JAX snapshot of a boxed lanes state (B=2, |v| <= 0.05, which binds:
    its z_adm/y_adm rings are leaves of the snapshot) resumes in the port's
    boxed lanes state to the JAX continuation's x, the warm starts carried
    across."""
    B = 2
    log = synth.generate(synth.SynthConfig(T=40, seed=5))
    rng = np.random.default_rng(0)
    lanes = [np.repeat(a[..., None], B, axis=-1) for a in _arrays(log)]
    lanes[1][..., 1] += 0.05 * rng.standard_normal(lanes[1].shape[:-1])
    lb, ub = _bounds(9)
    jc = jmhe.make_consts(_box_params(JParams), jnp.float64, x_lb=lb, x_ub=ub, admm_iters=20)
    step = jax.jit(lambda st, *a: jmhe_lanes.step(jc, st, *a))
    z3 = jnp.zeros(3)
    jdata = [jnp.asarray(a) for a in lanes]
    jst = jmhe_lanes.init(jc, *_tick(jdata, 0), dtype=jnp.float64)
    for k in range(1, 20):
        d = _tick(jdata, k)
        jst, _ = step(jst, *d, False, z3, 0, 0, d[0])
    assert float(jnp.abs(jst.z_adm).max()) > 0 and float(jnp.abs(jst.y_adm).max()) > 0
    path = str(tmp_path / "jax_lanes_box.npz")
    jcheckpoint.save_carry(path, jst)
    x_jax = []
    for k in range(20, 40):
        d = _tick(jdata, k)
        jst, (xT, _) = step(jst, *d, False, z3, 0, 0, d[0])
        x_jax.append(np.asarray(xT))

    data = [torch.as_tensor(a) for a in lanes]
    c = mhe.make_consts(_box_params(EstimatorParams), F64, x_lb=lb, x_ub=ub, admm_iters=20,
                        device=CPU)
    st = checkpoint.load_carry(path, mhe_lanes.init(c, *_tick(data, 0), dtype=F64, device=CPU))
    assert st.T == 19 and int(st.bez.count) == int(jst.bez.count)
    _, x_port = _port_run(c, st, data, range(20, 40), step=mhe_lanes.step)
    x_port = np.stack(x_port)
    np.testing.assert_allclose(x_port, np.stack(x_jax), atol=1e-9)
    # the box binds (within what the 20 iterations leave, F3)
    assert V_BOX - 1e-6 <= float(np.abs(x_port[:, 3:6]).max()) <= V_BOX + 1e-3


@pytest.mark.parametrize("box", [False, True], ids=["unconstrained", "box"])
def test_cross_package_resume_pipeline_carry(tmp_path, box):
    """A JAX ``PipelineEstimator``'s carry (EKF lanes state, lanes MHE state,
    the orientation ring, the tick: ``(ekf_st, mhe_st, ring, t)`` leaf for
    leaf), saved halfway through a stream, resumes in the port's
    ``PipelineEstimator`` (initialized on any tick-0 data) to the JAX
    continuation's x, v and q at 1e-9; with a box the warm-start rings ride
    in the carry."""
    N, T, mid = 6, 23, 12      # two blocks of 11 ticks: one JAX compile
    log = synth.generate(synth.SynthConfig(T=T, seed=4))
    eb = jest.ekfblocks_from_log(log, dtype=jnp.float64)
    g = lambda a: np.asarray(a)
    rows = lambda sl: (g(eb.gyro)[sl], g(eb.accel)[sl], g(eb.valid)[sl], log.accel_b[sl],
                       log.omega_b[sl], log.p_foot[sl], log.J_foot[sl], log.dq[sl],
                       log.contact[sl])
    vo = lambda sl: dict(ekf_vo_active=g(eb.vo_active)[sl], ekf_vo_q=g(eb.vo_q)[sl],
                         ekf_vo_steps_back=g(eb.vo_steps_back)[sl],
                         vo_active=log.vo_active[sl], vo_dp=log.vo_dp_body[sl],
                         vo_tick_pre=log.vo_tick_pre[sl], vo_tick_now=log.vo_tick_now[sl])
    kw = dict(zip(("x_lb", "x_ub"), _bounds(9))) if box else {}
    jp, tp = (_box_params(cls) if box else _params(cls) for cls in (JParams, EstimatorParams))
    jp.N = tp.N = N
    jpe = JPipelineEstimator(jp, JEKFParams(), dtype=jnp.float64, **kw)
    jpe.initialize(*rows(0), ekf_vo_active=g(eb.vo_active)[0], ekf_vo_q=g(eb.vo_q)[0],
                   ekf_vo_steps_back=g(eb.vo_steps_back)[0])
    jpe.update_block(*rows(slice(1, mid)), **vo(slice(1, mid)))
    path = str(tmp_path / "jax_pipe.npz")
    jcheckpoint.save_carry(path, jpe._carry)   # the JAX facade keeps its carry unexposed
    want = [np.asarray(a) for a in jpe.update_block(*rows(slice(mid, T)), **vo(slice(mid, T)))]

    port = PipelineEstimator(tp, EKFParams(), dtype=F64, use_pallas=True, device=CPU, **kw)
    port.initialize(*rows(0))
    port.carry = checkpoint.load_carry(path, port.carry)
    assert port.T == mid
    got = port.update_block(*rows(slice(mid, T)), **vo(slice(mid, T)))
    for name, a, b in zip("xvq", got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-9, err_msg=name)
    if box:
        assert V_BOX - 1e-6 <= float(np.abs(want[0][:, 3:6]).max()) <= V_BOX + 1e-3
