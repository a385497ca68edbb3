"""PyTorch port vs the JAX package: lanes algebra, synthetic log, config.

Same numpy-seeded inputs go through ``decentralized_ekf_mhe_tpu.ops.lanes``
and ``decentralized_ekf_mhe_tpu_torch.ops.lanes`` at float64 on the CPU; the
two use the same summation order, so agreement is to round-off (1e-12).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu import config as jconfig
from decentralized_ekf_mhe_tpu.io import synth as jsynth
from decentralized_ekf_mhe_tpu.ops import lanes as jl
from decentralized_ekf_mhe_tpu_torch import config as tconfig
from decentralized_ekf_mhe_tpu_torch.io import synth as tsynth
from decentralized_ekf_mhe_tpu_torch.ops import lanes as tl

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


def _both(fn_name, *arrays):
    jout = getattr(jl, fn_name)(*(jnp.asarray(a) for a in arrays))
    tout = getattr(tl, fn_name)(*(torch.as_tensor(a) for a in arrays))
    return np.asarray(jout), tout.numpy()


def _spd(rng, lead, n, B):
    A = rng.standard_normal(lead + (n, n, B))
    return np.einsum("...ikb,...jkb->...ijb", A, A) + n * np.eye(n)[:, :, None]


@pytest.mark.parametrize("name,shapes", [
    ("mm", [(2, 4, 5, 7), (2, 5, 3, 7)]),
    ("mm_tn", [(2, 5, 4, 7), (2, 5, 3, 7)]),
    ("mm_nt", [(2, 4, 5, 7), (2, 3, 5, 7)]),
    ("cmm", [(4, 5), (2, 5, 3, 7)]),
    ("cmm_t", [(5, 4), (2, 5, 3, 7)]),
    ("mmc", [(2, 4, 5, 7), (5, 3)]),
    ("mv", [(2, 4, 5, 7), (2, 5, 7)]),
    ("mv_t", [(2, 5, 4, 7), (2, 5, 7)]),
    ("cmv", [(4, 5), (2, 5, 7)]),
    ("cross", [(2, 3, 7), (2, 3, 7)]),
    ("skew", [(2, 3, 7)]),
    ("transpose", [(2, 4, 5, 7)]),
])
def test_products_match_jax(name, shapes):
    rng = np.random.default_rng(hash(name) % 2**32)
    arrays = [rng.standard_normal(s) for s in shapes]
    jout, tout = _both(name, *arrays)
    assert jout.shape == tout.shape
    np.testing.assert_allclose(tout, jout, **TOL)


@pytest.mark.parametrize("n", [4, 6, 9])
def test_gj_inv_matches_jax(n):
    rng = np.random.default_rng(n)
    A = _spd(rng, (3,), n, 5)
    jout, tout = _both("gj_inv", A)
    np.testing.assert_allclose(tout, jout, **TOL)
    eye = np.einsum("...ikb,...kjb->...ijb", A, tout)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(n)[:, :, None], eye.shape),
                               atol=1e-10)


def test_inv3_and_inv_match_jax():
    rng = np.random.default_rng(3)
    A = _spd(rng, (2,), 3, 6)
    for name in ("inv3", "inv"):
        jout, tout = _both(name, A)
        np.testing.assert_allclose(tout, jout, **TOL)
    A9 = _spd(rng, (), 9, 4)
    jout, tout = _both("inv", A9)
    np.testing.assert_allclose(tout, jout, **TOL)


def _tridiag_system(rng, N, s, B):
    D = _spd(rng, (N,), s, B) + 4 * s * np.eye(s)[None, :, :, None]
    U = 0.3 * rng.standard_normal((N - 1, s, s, B))
    r = rng.standard_normal((N, s, B))
    return D, U, r


def test_thomas_solve_matches_jax_and_dense():
    rng = np.random.default_rng(11)
    N, s, B = 6, 9, 5
    D, U, r = _tridiag_system(rng, N, s, B)
    jout, tout = _both("thomas_solve", D, U, r)
    np.testing.assert_allclose(tout, jout, **TOL)
    # against a dense solve of instance 0
    M = np.zeros((N * s, N * s))
    for j in range(N):
        M[j * s:(j + 1) * s, j * s:(j + 1) * s] = D[j, :, :, 0]
        if j < N - 1:
            M[j * s:(j + 1) * s, (j + 1) * s:(j + 2) * s] = U[j, :, :, 0]
            M[(j + 1) * s:(j + 2) * s, j * s:(j + 1) * s] = U[j, :, :, 0].T
    x = np.linalg.solve(M, r[:, :, 0].reshape(-1)).reshape(N, s)
    np.testing.assert_allclose(tout[:, :, 0], x, rtol=1e-9, atol=1e-11)


def test_thomas_factored_matches_jax():
    rng = np.random.default_rng(12)
    D, U, r = _tridiag_system(rng, 5, 9, 4)
    jfac = jl.thomas_factor(jnp.asarray(D), jnp.asarray(U))
    tfac = tl.thomas_factor(torch.as_tensor(D), torch.as_tensor(U))
    np.testing.assert_allclose(tfac[0].numpy(), np.asarray(jfac[0]), **TOL)
    jx = jl.thomas_solve_factored(jfac, jnp.asarray(r))
    tx = tl.thomas_solve_factored(tfac, torch.as_tensor(r))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(
        tx.numpy(),
        tl.thomas_solve(torch.as_tensor(D), torch.as_tensor(U),
                        torch.as_tensor(r)).numpy(), **TOL)


def test_layout_helpers():
    assert tl.eye(3, torch.float64).shape == (3, 3, 1)
    assert tl.const(torch.ones(2, 2)).shape == (2, 2, 1)


@pytest.mark.parametrize("kw", [
    dict(T=60, seed=0),
    dict(T=45, seed=7, num_legs=2, rate=100, vo_every=5),
    dict(T=30, seed=3, num_legs=1, vo_latency=3),
])
def test_synth_generate_bit_identical(kw):
    jlog = jsynth.generate(jsynth.SynthConfig(**kw))
    tlog = tsynth.generate(tsynth.SynthConfig(**kw))
    for f in dataclasses.fields(jlog):
        a, b = getattr(jlog, f.name), getattr(tlog, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert np.array_equal(a, b), f.name


def test_config_defaults_equal():
    for name in ("OSQPParams", "EKFParams", "EstimatorParams"):
        j, t = getattr(jconfig, name)(), getattr(tconfig, name)()
        assert dataclasses.asdict(j) == dataclasses.asdict(t), name
    jp, tp = jconfig.EstimatorParams(N=7, leg_odom_type=1, num_legs=2), \
        tconfig.EstimatorParams(N=7, leg_odom_type=1, num_legs=2)
    assert (jp.dim_state, jp.dim_meas, jp.dim_cam, jp.dt) == \
        (tp.dim_state, tp.dim_meas, tp.dim_cam, tp.dt)
    std = [0.1, 2.0, 3e-3]
    assert np.array_equal(jconfig.std_to_cov(std), tconfig.std_to_cov(std))
    assert np.array_equal(jconfig.std_to_gain(std), tconfig.std_to_gain(std))


@pytest.mark.parametrize("name", ["parameters_cassie.yaml", "parameters_pogox.yaml"])
def test_load_yaml_params_equal(name):
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", name)
    je, jk = jconfig.load_yaml_params(path)
    te, tk = tconfig.load_yaml_params(path)
    assert dataclasses.asdict(je) == dataclasses.asdict(te)
    assert dataclasses.asdict(jk) == dataclasses.asdict(tk)
