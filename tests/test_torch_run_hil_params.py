"""The port's HIL example streams the estimator of its JAX twin.

``examples/run_hil.py`` (the JAX package's example) builds its estimator inline
in ``main``; the port's ``examples/run_hil.main`` streams ``hil_params()`` by
default and the reference bench's Go1 estimator only behind ``--bench``. Here
the JAX example's ``EstimatorParams(...)`` call is read from its source and
evaluated with the JAX package's class, and held against what the port's
``main`` hands ``stream``, field by field, with the window-solve route:
plain by default, as the JAX example runs without Pallas, on the kernel with
``--bench``.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest

from decentralized_ekf_mhe_tpu import config as jconfig
from decentralized_ekf_mhe_tpu_torch.examples import run_hil
from decentralized_ekf_mhe_tpu_torch.tools.roofline import bench_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example_params():
    """The EstimatorParams the JAX example's main builds, from its source."""
    with open(os.path.join(REPO, "examples", "run_hil.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = [n for n in ast.walk(main) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "EstimatorParams"]
    assert len(calls) == 1
    return eval(compile(ast.Expression(calls[0]), "run_hil.py", "eval"),
                {"EstimatorParams": jconfig.EstimatorParams})


def _fields(p):
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


def _same(a, b):
    if dataclasses.is_dataclass(a):
        return _fields(a).keys() == _fields(b).keys() and all(
            _same(x, y) for x, y in zip(_fields(a).values(), _fields(b).values()))
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("argv,bench", [([], False), (["--bench"], True)],
                         ids=["default", "bench"])
def test_main_streams_the_jax_examples_estimator(monkeypatch, argv, bench):
    """By default ``main`` streams the JAX example's estimator (every field of
    EstimatorParams, the nested OSQP settings included, equal) with plain
    window solves, as the JAX example runs without Pallas; with ``--bench`` the
    bench's estimator on the kernel route. ``stream`` and ``tick_at_a_time``
    are stubbed: the parameters and the route are what is held here."""
    jp = _jax_example_params()
    assert (jp.num_legs, jp.leg_odom_type, jp.N, list(jp.foot_swing_std)) == (4, 0, 20, [1e7] * 3)
    seen = {}

    def stream(log, params, ekf_params, block, dtype, device, use_native=True,
               use_pallas=True):
        seen.update(params=params, use_pallas=use_pallas)
        T = log.accel_b.shape[0]
        import torch
        return dict(x=torch.zeros((T, 9)), latency_ms=np.ones(3), feeder="numpy feeder")

    monkeypatch.setattr(run_hil, "stream", stream)
    monkeypatch.setattr(run_hil, "tick_at_a_time", lambda log, p, dtype, device, n: np.ones(3))
    assert run_hil.main(["--ticks", "12", "--cpu", *argv]) == 0
    want = bench_params() if bench else jp
    names = [f.name for f in dataclasses.fields(jp)]
    assert [f.name for f in dataclasses.fields(seen["params"])] == names
    for name in names:
        assert _same(getattr(seen["params"], name), getattr(want, name)), name
    assert seen["use_pallas"] == bench
    assert _same(run_hil.hil_params(), jp)
    assert not _same(bench_params(), jp)      # the two estimators differ
