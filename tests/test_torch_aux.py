"""PyTorch port: checkpoint/resume and the timing probes (``utils/``).

Counterpart of ``tests/test_aux.py`` on the port (CPU, float64): resume is
bit-exact, a shape mismatch refuses to load, missing trailing leaves resume
from the template; and a snapshot the JAX package writes of its MHE state and
of its lanes state (unconstrained, so its empty ``z_adm``/``y_adm`` tuples
contribute no leaf) loads into the port's states and continues to the JAX
continuation's x at 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu.config import EstimatorParams as JParams
from decentralized_ekf_mhe_tpu.io import synth
from decentralized_ekf_mhe_tpu.ops import mhe as jmhe
from decentralized_ekf_mhe_tpu.ops import mhe_lanes as jmhe_lanes
from decentralized_ekf_mhe_tpu.utils import checkpoint as jcheckpoint
from decentralized_ekf_mhe_tpu_torch.config import EKFParams, EstimatorParams
from decentralized_ekf_mhe_tpu_torch.ops import estimator, mhe, mhe_lanes
from decentralized_ekf_mhe_tpu_torch.ops.facade import PipelineEstimator
from decentralized_ekf_mhe_tpu_torch.utils import checkpoint, timing

torch.set_num_threads(1)

F64 = torch.float64
CPU = "cpu"


def _params(cls, N=10):
    return cls(num_legs=4, leg_odom_type=0, rate=200, N=N, foot_swing_std=[1e7] * 3)


def _arrays(log):
    """A log's per-tick inputs, in the order the MHE takes them, float64."""
    return [np.asarray(a, np.float64) for a in (log.R_sb_gt, log.accel_b, log.omega_b,
                                                 log.p_foot, log.J_foot, log.dq, log.contact)]


def _tick(data, k):
    return [a[k] for a in data]


def _port_run(c, st, data, ks, step=mhe.step):
    """Port MHE ticks ``ks`` without VO; x_T of each."""
    outs = []
    for k in ks:
        d = _tick(data, k)
        st, out = step(c, st, *d, False, torch.zeros(3, dtype=F64), 0, 0, d[0])
        outs.append(out[0].numpy())
    return st, outs


def test_checkpoint_resume_bit_exact(tmp_path):
    """Snapshot mid-run, resume, and get bit-identical estimates."""
    log = synth.generate(synth.SynthConfig(T=60, seed=2))
    data = [torch.as_tensor(a) for a in _arrays(log)]
    c = mhe.make_consts(_params(EstimatorParams), F64, device=CPU)
    st = mhe.init(c, *_tick(data, 0), dtype=F64, device=CPU)
    st_mid, _ = _port_run(c, st, data, range(1, 30))
    path = str(tmp_path / "carry.npz")
    checkpoint.save_carry(path, st_mid)
    st_restored = checkpoint.load_carry(path, st)
    assert isinstance(st_restored.T, int) and st_restored.T == st_mid.T == 29
    assert isinstance(st_restored.bez.count, int)
    _, out_a = _port_run(c, st_mid, data, range(30, 50))
    _, out_b = _port_run(c, st_restored, data, range(30, 50))
    np.testing.assert_array_equal(np.stack(out_a), np.stack(out_b))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_pipeline_carry_resume_bit_exact(tmp_path, use_pallas):
    """A PipelineEstimator's carry snapshot halfway through a stream resumes
    into a fresh estimator (initialized on any tick-0 data) bit for bit."""
    N, T, mid = 6, 24, 12
    log = synth.generate(synth.SynthConfig(T=T, seed=4))
    eb = estimator.ekfblocks_from_log(log, device=CPU)
    rows = lambda sl: (eb.gyro[sl], eb.accel[sl], eb.valid[sl], log.accel_b[sl],
                       log.omega_b[sl], log.p_foot[sl], log.J_foot[sl], log.dq[sl],
                       log.contact[sl])
    vo = lambda sl: dict(ekf_vo_active=eb.vo_active[sl], ekf_vo_q=eb.vo_q[sl],
                         ekf_vo_steps_back=eb.vo_steps_back[sl],
                         vo_active=log.vo_active[sl], vo_dp=log.vo_dp_body[sl],
                         vo_tick_pre=log.vo_tick_pre[sl], vo_tick_now=log.vo_tick_now[sl])
    make = lambda: PipelineEstimator(_params(EstimatorParams, N), EKFParams(), dtype=F64,
                                     use_pallas=use_pallas, device=CPU)
    est = make()
    est.initialize(*rows(0), ekf_vo_active=eb.vo_active[0], ekf_vo_q=eb.vo_q[0],
                   ekf_vo_steps_back=eb.vo_steps_back[0])
    est.update_block(*rows(slice(1, mid)), **vo(slice(1, mid)))
    path = str(tmp_path / "pipe.npz")
    checkpoint.save_carry(path, est.carry)
    x_a, v_a, q_a = est.update_block(*rows(slice(mid, T)), **vo(slice(mid, T)))

    fresh = make()
    fresh.initialize(*rows(0))
    fresh.carry = checkpoint.load_carry(path, fresh.carry)
    assert fresh.T == mid
    x_b, v_b, q_b = fresh.update_block(*rows(slice(mid, T)), **vo(slice(mid, T)))
    for a, b in ((x_a, x_b), (v_a, v_b), (q_a, q_b)):
        assert torch.equal(a, b)


def test_checkpoint_shape_mismatch_raises_and_trailing_leaves(tmp_path):
    """A saved leaf whose shape disagrees with the template (the structure
    changed in a non-trailing position) refuses to load; leaves missing at
    the end resume from the template; a dict is flattened by sorted key."""
    carry = {"b": torch.ones(2), "a": torch.zeros((3, 4))}
    path = str(tmp_path / "c.npz")
    checkpoint.save_carry(path, carry)
    with np.load(path) as d:
        assert d["leaf_0"].shape == (3, 4) and d["leaf_1"].shape == (2,)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_carry(path, {"a": torch.zeros((3, 5)), "b": torch.ones(2)})
    out = checkpoint.load_carry(path, carry)
    assert torch.equal(out["a"], torch.zeros((3, 4))) and torch.equal(out["b"], torch.ones(2))

    old = (torch.arange(3.0), 7)
    checkpoint.save_carry(path, old)
    template = (torch.zeros(3, dtype=torch.float32), 0, torch.full((2,), 5.0), None, ())
    out = checkpoint.load_carry(path, template)
    assert out[0].dtype == torch.float32 and torch.equal(out[0], torch.arange(3.0))
    assert out[1] == 7 and isinstance(out[1], int)
    assert torch.equal(out[2], torch.full((2,), 5.0)) and out[3] is None and out[4] == ()


def test_cross_package_resume_standard_state(tmp_path):
    """A JAX snapshot of an ``MHEState`` (its T and Bezier count 0-d int32
    arrays, the port's host ints) resumes in the port to the JAX
    continuation's x."""
    log = synth.generate(synth.SynthConfig(T=40, seed=2))
    jdata = [jnp.asarray(a) for a in _arrays(log)]
    jc = jmhe.make_consts(_params(JParams), jnp.float64)
    step = jax.jit(lambda st, *a: jmhe.step(jc, st, *a))
    z3 = jnp.zeros(3)
    jst = jmhe.init(jc, *_tick(jdata, 0), dtype=jnp.float64)
    for k in range(1, 20):
        d = _tick(jdata, k)
        jst, _ = step(jst, *d, False, z3, 0, 0, d[0])
    path = str(tmp_path / "jax_mhe.npz")
    jcheckpoint.save_carry(path, jst)
    x_jax = []
    for k in range(20, 40):
        d = _tick(jdata, k)
        jst, (xT, _) = step(jst, *d, False, z3, 0, 0, d[0])
        x_jax.append(np.asarray(xT))

    data = [torch.as_tensor(a) for a in _arrays(log)]
    c = mhe.make_consts(_params(EstimatorParams), F64, device=CPU)
    st = checkpoint.load_carry(path, mhe.init(c, *_tick(data, 0), dtype=F64, device=CPU))
    assert st.T == 19
    _, x_port = _port_run(c, st, data, range(20, 40))
    np.testing.assert_allclose(np.stack(x_port), np.stack(x_jax), atol=1e-9)


def test_cross_package_resume_lanes_state(tmp_path):
    """A JAX snapshot of an unconstrained lanes state (B=2; its ``()`` warm
    starts write no leaf) resumes in the port's lanes state to the JAX
    continuation's x."""
    B = 2
    log = synth.generate(synth.SynthConfig(T=40, seed=5))
    rng = np.random.default_rng(0)
    arrs = _arrays(log)
    # (T,...) -> lanes (T,...,B), the second lane's accelerometer perturbed
    lanes = [np.repeat(a[..., None], B, axis=-1) for a in arrs]
    lanes[1][..., 1] += 0.05 * rng.standard_normal(lanes[1].shape[:-1])
    jc = jmhe.make_consts(_params(JParams), jnp.float64)
    step = jax.jit(lambda st, *a: jmhe_lanes.step(jc, st, *a))
    z3 = jnp.zeros(3)
    jdata = [jnp.asarray(a) for a in lanes]
    jst = jmhe_lanes.init(jc, *_tick(jdata, 0), dtype=jnp.float64)
    assert jst.z_adm == () and jst.y_adm == ()
    for k in range(1, 20):
        d = _tick(jdata, k)
        jst, _ = step(jst, *d, False, z3, 0, 0, d[0])
    path = str(tmp_path / "jax_lanes.npz")
    jcheckpoint.save_carry(path, jst)
    x_jax = []
    for k in range(20, 40):
        d = _tick(jdata, k)
        jst, (xT, _) = step(jst, *d, False, z3, 0, 0, d[0])
        x_jax.append(np.asarray(xT))

    data = [torch.as_tensor(a) for a in lanes]
    c = mhe.make_consts(_params(EstimatorParams), F64, device=CPU)
    st = checkpoint.load_carry(path, mhe_lanes.init(c, *_tick(data, 0), dtype=F64,
                                                    device=CPU))
    assert st.T == 19 and st.z_adm == () and int(st.bez.count) == int(jst.bez.count)
    _, x_port = _port_run(c, st, data, range(20, 40), step=mhe_lanes.step)
    np.testing.assert_allclose(np.stack(x_port), np.stack(x_jax), atol=1e-9)


def test_timing_probes(capsys, tmp_path):
    timing.tic("unit")
    dt = timing.toc("unit", quiet=True)
    assert dt >= 0
    timing.toc("unit")
    assert "unit elapsed time:" in capsys.readouterr().out
    res = {}
    with timing.scoped_timer("block", res):
        pass
    assert "block" in res
    w, out = timing.rate_probe(lambda x: x + 1, torch.ones(4), reps=2)
    assert w > 0 and tuple(out.shape) == (4,)
    assert timing.device_sync(torch.full((2,), 3.0)) == 3.0
    with timing.trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").exists()
    assert len(prof.key_averages()) > 0
