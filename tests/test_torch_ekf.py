"""PyTorch port vs the JAX package: the orientation-EKF stage.

The lanes filter functions, the eager block scan, and the plain version of
the ``ekf_stage`` CUDA kernel (what ``kernels.ekf_kernel.replay`` runs for CPU
tensors) are held against the JAX package at float64 on the CPU, the Pallas
kernel in interpret mode. Inputs are perturbed once (JAX ``perturb_*``), turned
into numpy, and handed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu.config import EKFParams as JEKFParams
from decentralized_ekf_mhe_tpu.io import synth as jsynth
from decentralized_ekf_mhe_tpu.ops import ekf_lanes as jekf
from decentralized_ekf_mhe_tpu.ops import estimator as jest
from decentralized_ekf_mhe_tpu.pallas import ekf_kernel as jekf_kernel
from decentralized_ekf_mhe_tpu.parallel import batch as jbatch
from decentralized_ekf_mhe_tpu_torch import convert
from decentralized_ekf_mhe_tpu_torch.config import EKFParams
from decentralized_ekf_mhe_tpu_torch.kernels import ekf_kernel
from decentralized_ekf_mhe_tpu_torch.ops import ekf_lanes, estimator

torch.set_num_threads(1)

DT = jnp.float64
F64 = torch.float64
TOL = dict(rtol=1e-10, atol=1e-12)
B = 128


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _blocks(T, seed, B_=B, vo_noise=0.0):
    """JAX-perturbed EKF blocks and their converted twin."""
    log = jsynth.generate(jsynth.SynthConfig(T=T, seed=seed))
    eb1 = jest.ekfblocks_from_log(log, dtype=DT)
    eb = jbatch.perturb_ekf_blocks(eb1, B_, jax.random.PRNGKey(seed), dtype=DT,
                                   noise_scale=1.0, vo_noise_scale=vo_noise)
    return log, eb, convert.from_jax_numpy(_np(eb), "cpu", F64)


def _rand_state(seed, B_=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((4, B_))
    q /= np.linalg.norm(q, axis=0)
    A = rng.standard_normal((4, 4, B_))
    P = 1e-3 * (np.einsum("ikb,jkb->ijb", A, A) + np.eye(4)[:, :, None])
    return rng, q, P


@pytest.mark.parametrize("name", ["normalize", "gyro_to_omega", "to_rot"])
def test_quaternion_algebra_matches_jax(name):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 3 if name == "gyro_to_omega" else 4, 6))
    j = np.asarray(getattr(jekf, name)(jnp.asarray(a)))
    t = getattr(ekf_lanes, name)(torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("quirk", [True, False])
def test_quat_jacobians_match_jax(quirk):
    _, q, _ = _rand_state(2)
    jw = np.asarray(jekf.quat_to_W(jnp.asarray(q), 0.002, quirk_compatible=quirk))
    tw = ekf_lanes.quat_to_W(torch.as_tensor(q), 0.002, quirk_compatible=quirk).numpy()
    np.testing.assert_allclose(tw, jw, rtol=1e-13, atol=1e-15)
    g = np.array([0.3, -0.2, 9.81])
    jh = np.asarray(jekf.quat_to_H(jnp.asarray(q), g))
    th = ekf_lanes.quat_to_H(torch.as_tensor(q), g).numpy()
    np.testing.assert_allclose(th, jh, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("stage", ["predict", "accel_correct", "vo_correct_shared",
                                   "vo_correct_per_lane"])
@pytest.mark.parametrize("quirk", [True, False])
def test_filter_stages_match_jax(stage, quirk):
    rng, q, P = _rand_state(3)
    jc = jekf.make_consts(JEKFParams(quirk_compatible_W=quirk), DT)
    tc = ekf_lanes.make_consts(EKFParams(quirk_compatible_W=quirk), F64)
    if stage == "predict":
        arg = 0.5 * rng.standard_normal((3, 5))
    elif stage == "accel_correct":
        arg = np.array([0.1, -0.2, 9.7])[:, None] + 0.3 * rng.standard_normal((3, 5))
    elif stage == "vo_correct_shared":
        arg = q[:, 0] + 1e-3
    else:
        arg = q + 1e-3 * rng.standard_normal((4, 5))
    fn = stage.split("_shared")[0].split("_per_lane")[0]
    jq, jP = getattr(jekf, fn)(jnp.asarray(q), jnp.asarray(P), jnp.asarray(arg), jc)
    tq, tP = getattr(ekf_lanes, fn)(torch.as_tensor(q), torch.as_tensor(P),
                                    torch.as_tensor(arg), tc)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=1e-12, atol=1e-16)


def test_consts_and_init_state_match_jax():
    jp, tp = JEKFParams(), EKFParams()
    jc, tc = jekf.make_consts(jp, DT), ekf_lanes.make_consts(tp, F64)
    assert jc.dt == tc.dt and jc.quirk_W == tc.quirk_W
    for f in ("C_gyro", "C_accel", "C_vo", "gravity"):
        assert np.array_equal(getattr(jc, f), getattr(tc, f)), f
    js = jekf.init_state(jp, 7, ring_len=16, dtype=DT)
    ts = ekf_lanes.init_state(tp, 7, ring_len=16, dtype=F64, device="cpu")
    assert ts.t == int(js.t) == 0
    for f in ("q", "P", "gyro_hist", "accel_hist", "q_hist", "P_hist"):
        assert np.array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f))), f
    # the converted state equals the port's own
    cs = convert.from_jax_numpy(_np(js), "cpu", F64)
    assert cs.t == 0 and torch.equal(cs.P_hist, ts.P_hist)


@pytest.mark.parametrize("vo_noise", [0.0, 1.0])
def test_scan_ekf_blocks_matches_jax(vo_noise):
    """Eager block scan == JAX scan at float64, incl. delayed-VO replays,
    shared and per-lane measured quaternion; final carry too."""
    T, Bs = 40, 8
    _, jeb, teb = _blocks(T, 4, B_=Bs, vo_noise=vo_noise)
    jp, tp = JEKFParams(), EKFParams()
    jst, jq = jest.scan_ekf_blocks(jekf.init_state(jp, Bs, 16, DT), jeb,
                                   jekf.make_consts(jp, DT))
    tst, tq = estimator.scan_ekf_blocks(
        ekf_lanes.init_state(tp, Bs, 16, F64, device="cpu"), teb,
        ekf_lanes.make_consts(tp, F64))
    assert int(jeb.vo_active.sum()) > 0
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    assert tst.t == int(jst.t)
    for f in ("q", "P", "gyro_hist", "accel_hist", "q_hist", "P_hist"):
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)), **TOL)


def test_substep_block_one_tick_matches_jax():
    T, Bs = 12, 4
    _, jeb, teb = _blocks(T, 5, B_=Bs)
    jp, tp = JEKFParams(), EKFParams()
    jc, tc = jekf.make_consts(jp, DT), ekf_lanes.make_consts(tp, F64)
    jst = jekf.init_state(jp, Bs, 16, DT)
    tst = ekf_lanes.init_state(tp, Bs, 16, F64, device="cpu")
    for k in range(3):
        jst = jekf.substep_block(jst, jeb.gyro[k], jeb.accel[k], jeb.valid[k],
                                 jeb.vo_active[k], jeb.vo_q[k],
                                 jeb.vo_steps_back[k], jc)
        tst = ekf_lanes.substep_block(tst, teb.gyro[k], teb.accel[k],
                                      teb.valid[k].tolist(),
                                      teb.vo_active[k].tolist(), teb.vo_q[k],
                                      teb.vo_steps_back[k].tolist(), tc)
        np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), **TOL)
        np.testing.assert_allclose(tst.P.numpy(), np.asarray(jst.P), **TOL)
        assert tst.t == int(jst.t)


@pytest.mark.parametrize("vo_noise", [0.0, 1.0])
def test_ekf_kernel_plain_matches_pallas_interpret(vo_noise):
    """The plain version of the ekf_stage kernel (the CPU path of
    kernels.ekf_kernel.replay) == the Pallas kernel in interpret mode at
    float64: warm-up, delayed-VO replays, shared and per-lane vo_q, and the
    final carry."""
    T = 40
    _, jeb, teb = _blocks(T, 4, vo_noise=vo_noise)
    jp, tp = JEKFParams(), EKFParams()
    jq, jfin = jekf_kernel.replay(jekf.make_consts(jp, DT),
                                  jekf.init_state(jp, B, 16, DT), jeb,
                                  chunk=13, interpret=True)
    launches_before = ekf_kernel.launches
    tq, tfin = ekf_kernel.replay(
        ekf_lanes.make_consts(tp, F64),
        ekf_lanes.init_state(tp, B, 16, F64, device="cpu"), teb, device="cpu")
    assert ekf_kernel.launches == launches_before   # CPU tensors: no launch
    assert tq.shape == (T, 4, B)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    assert tfin.t == int(jfin.t)
    for f in ("q", "P", "q_hist", "P_hist"):
        np.testing.assert_allclose(getattr(tfin, f).numpy(),
                                   np.asarray(getattr(jfin, f)), **TOL)


def test_ekf_kernel_plain_resume_across_calls():
    """A log split over two replay() calls (state in, final state out)
    equals one call, and equals the JAX one-call result."""
    T, Bs = 30, 16
    _, jeb, teb = _blocks(T, 9, B_=Bs)
    jp, tp = JEKFParams(), EKFParams()
    _, jq = jest.scan_ekf_blocks(jekf.init_state(jp, Bs, 16, DT), jeb,
                                 jekf.make_consts(jp, DT))
    ec = ekf_lanes.make_consts(tp, F64)
    st = ekf_lanes.init_state(tp, Bs, 16, F64, device="cpu")
    q_all, _ = ekf_kernel.replay(ec, st, teb, device="cpu")
    ebA = estimator.EKFBlocks(*(a[:12] for a in teb))
    ebB = estimator.EKFBlocks(*(a[12:] for a in teb))
    qA, stA = ekf_kernel.replay(ec, st, ebA, device="cpu")
    qB, _ = ekf_kernel.replay(ec, stA, ebB, device="cpu")
    assert torch.equal(torch.cat([qA, qB], dim=0), q_all)
    np.testing.assert_allclose(q_all.numpy(), np.asarray(jq), **TOL)
    assert st.t == 0 and torch.equal(
        st.q, ekf_lanes.init_state(tp, Bs, 16, F64, device="cpu").q)


def test_ekf_wrapper_rejects_bad_operands():
    _, _, teb = _blocks(6, 1, B_=4)
    tp = EKFParams()
    ec = ekf_lanes.make_consts(tp, F64)
    st = ekf_lanes.init_state(tp, 4, 16, F64, device="cpu")
    with pytest.raises(ValueError):
        ekf_kernel.replay(ec, st, teb._replace(gyro=teb.gyro.float()), device="cpu")
    with pytest.raises(ValueError):
        ekf_kernel.replay(ec, st, teb._replace(accel=teb.accel[..., :3]), device="cpu")
    with pytest.raises(ValueError):
        ekf_kernel.replay(ec, st, teb._replace(
            gyro=teb.gyro.transpose(0, 1).contiguous().transpose(0, 1)), device="cpu")
    per_lane_timing = teb._replace(
        vo_active=teb.vo_active[..., None].expand(*teb.vo_active.shape, 4))
    with pytest.raises(NotImplementedError):
        ekf_kernel.replay(ec, st, per_lane_timing, device="cpu")
