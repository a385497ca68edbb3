"""The orientation-EKF stage (K1 ``ekf_stage``) on a group of threads per
instance, with its history ring and input stream in shared memory.

Without a card: the launch geometry (``kernels/_group.ekf_geometry``) and its
refusals; the kernel's body (``csrc/ekf.cuh``) built for the host
(``tests/box_group_host/ekf_harness.cpp``: every thread of a block a
``std::thread``, the staged chunks copied synchronously, ``g++
-ffp-contract=off``) against the plain version ``ekf_kernel.replay_plain`` at
float64 (rtol 1e-10, atol 1e-12, the EKF tolerance of the JAX package's tests;
the plain version is held to the Pallas kernel in interpret mode by
``tests/test_torch_ekf.py``), on fleets made with numpy from a seed: a shared
and a per-lane VO quaternion, ``quirk_W`` on and off, a log split over two
calls, a ragged B, a VO replay across a chunk edge, steps-back of 1, R - 1, R
and beyond, and beyond t, a log shorter than one chunk, a carried-in ring,
ticks longer than a chunk (one tick staged at a time), and one float32 run.
"""

import os
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

from decentralized_ekf_mhe_tpu_torch.config import EKFParams
from decentralized_ekf_mhe_tpu_torch.kernels import _group, ekf_kernel
from decentralized_ekf_mhe_tpu_torch.ops import ekf_lanes, estimator

torch.set_num_threads(1)

F64 = torch.float64
TOL_EKF = dict(rtol=1e-10, atol=1e-12)    # tests/test_torch_ekf.py, chip_smoke.TOL_EKF
HOST = os.path.join(os.path.dirname(__file__), "box_group_host")
CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "decentralized_ekf_mhe_tpu_torch",
                    "csrc")
R, S = 16, 3
G = _group.EKF_G


# ------------------------------------------------------------ the geometry


@pytest.mark.parametrize("pl", [False, True], ids=["shared_vo_q", "per_lane_vo_q"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_ekf_geometry(dtype, pl):
    """One warp per block (eight instances of four threads) at the ring of 16
    and three substeps per tick, 16 ticks per staged chunk; B=1024 fills 128
    blocks, every instance resident at once on 132 SMs. A tick longer than a
    chunk is staged alone. The bytes are held to the CUDA side's layout in
    ``test_host_layout_equals_the_wrapper_geometry``."""
    g = ekf_kernel.geometry(R, S, dtype, pl)
    assert (g.instances_per_block, g.threads_per_block, g.ticks_per_chunk) == (8, 8 * G, 16)
    assert g.shared_bytes <= _group.SHARED_PER_BLOCK and 132 * g.instances_per_sm >= 1024
    assert g.shared_bytes < ekf_kernel.geometry(R, S, dtype, not pl).shared_bytes or pl
    big = ekf_kernel.geometry(R, 60, dtype, pl)       # S above a chunk: one tick each
    assert big.ticks_per_chunk == 1 and big.shared_bytes > g.shared_bytes


def test_ekf_geometry_refuses_what_a_block_cannot_hold():
    """A block whose shared memory exceeds 232,448 bytes (a ring of 200 fits
    in float32 but not in float64, whose scalars take twice the bytes), and
    an empty ring or tick, raise ValueError before a launch."""
    assert ekf_kernel.geometry(200, S, torch.float32).shared_bytes <= _group.SHARED_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        ekf_kernel.geometry(200, S, F64)
    with pytest.raises(ValueError, match="shared memory"):
        ekf_kernel.geometry(2000, S, torch.float32)
    for r, s in ((0, S), (R, 0)):
        with pytest.raises(ValueError):
            ekf_kernel.geometry(r, s, F64)


# ------------------------------------------------- the body on the host


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host harness")
    exe = str(tmp_path_factory.mktemp("ekf_harness") / "ekf_harness")
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
                    f"-I{CSRC}", f"-I{HOST}", os.path.join(HOST, "ekf_harness.cpp"), "-o", exe],
                   check=True, capture_output=True, timeout=300)
    return exe


def test_host_layout_equals_the_wrapper_geometry(harness):
    """The shared bytes that the CUDA side lays out (``EkfDims``) for the
    wrapper's block and chunk are the wrapper's."""
    for r, s, dtype, pl in ((16, 3, torch.float32, 0), (16, 3, F64, 1), (7, 5, torch.float32, 1),
                            (33, 60, F64, 0), (200, 3, torch.float32, 1)):
        g = ekf_kernel.geometry(r, s, dtype, bool(pl))
        out = subprocess.run([harness, "--layout", str(r), str(s), str(pl),
                              str(g.instances_per_block), str(dtype.itemsize),
                              str(g.ticks_per_chunk)],
                             check=True, capture_output=True, text=True).stdout.split()
        assert int(out[0]) == g.shared_bytes


# The VO events of the fleets: (tick, substep, steps back). Ticks have 3, 3, 2
# valid substeps in turn; the chunk is 16 ticks at S=3, so the replay at tick
# 17 reaches back into chunk 0.
EVENTS = [(1, 0, 10), (2, 0, 30), (3, 1, 1), (6, 2, 9), (8, 0, R - 1), (12, 1, R), (14, 0, 40),
          (17, 0, 12), (17, 2, 5), (21, 1, R - 1), (26, 0, 2), (30, 2, 3)]


def _fleet(T, B, seed, per_lane, t0=0, random_state=False, S=S):
    """(state, EKFBlocks) on the CPU in float64, from numpy: every third tick
    has one valid substep fewer than S."""
    rng = np.random.default_rng(seed)
    valid = np.zeros((T, S), bool)
    for k in range(T):
        valid[k, :S - (k % 3 == 2)] = True
    act = np.zeros((T, S), bool)
    sb = np.zeros((T, S), np.int32)
    for k, j, n in EVENTS:
        if k < T:
            act[k, j], sb[k, j] = True, n
    act[min(T - 1, 5), 2] = True        # an event on a padding substep: never read
    sb[min(T - 1, 5), 2] = 2
    gyro = rng.normal(0.0, 0.4, (T, S, 3, B))
    accel = np.array([0.3, -0.2, 9.81])[None, None, :, None] + rng.normal(0.0, 0.6, (T, S, 3, B))

    def quats(shape):
        q = np.concatenate([np.ones(shape[:2] + (1,) + shape[2:]),
                            rng.normal(0.0, 0.05, shape[:2] + (3,) + shape[2:])], axis=2)
        return q / np.linalg.norm(q, axis=2, keepdims=True)

    vo_q = quats((T, S, B)) if per_lane else quats((T, S))
    t = lambda a, dt=F64: torch.as_tensor(a, dtype=dt)
    eb = estimator.EKFBlocks(gyro=t(gyro), accel=t(accel), valid=torch.as_tensor(valid),
                             vo_active=torch.as_tensor(act), vo_q=t(vo_q),
                             vo_steps_back=torch.as_tensor(sb))
    st = ekf_lanes.init_state(EKFParams(), B, R, F64, device="cpu")
    if random_state:
        q = quats((1, 1, B))[0, 0]
        A = rng.normal(0.0, 1.0, (4, 4, B))
        P = 1e-3 * (np.einsum("ikb,jkb->ijb", A, A) + np.eye(4)[:, :, None])
        Ah = rng.normal(0.0, 1.0, (R, 4, 4, B))
        Ph = 1e-3 * (np.einsum("rikb,rjkb->rijb", Ah, Ah) + np.eye(4)[None, :, :, None])
        st = st._replace(q=t(q), P=t(P), t=t0, gyro_hist=t(rng.normal(0.0, 0.4, (R, 3, B))),
                         accel_hist=t(rng.normal(0.0, 0.5, (R, 3, B)) + [[0.0], [0.0], [9.81]]),
                         q_hist=t(quats((R, 1, B))[:, 0]), P_hist=t(Ph))
    return st, eb


def _state(st):
    return [st.q, st.P, st.gyro_hist, st.accel_hist, st.q_hist, st.P_hist]


def _run(harness, tmp_path, ec, st, eb, is_double=True, name="case"):
    """The group body on the host at the wrapper's geometry: (q_seq, the six
    state tensors carried out)."""
    T, S_, _, B = eb.gyro.shape
    pl = eb.vo_q.ndim == 4
    g = ekf_kernel.geometry(R, S_, F64 if is_double else torch.float32, pl)
    case, out = tmp_path / f"{name}.bin", tmp_path / f"{name}.out"
    with open(case, "wb") as f:
        f.write(struct.pack("10i", T, S_, R, B, int(st.t), int(pl), int(bool(ec.quirk_W)),
                            g.instances_per_block, g.ticks_per_chunk, int(is_double)))
        f.write(ekf_kernel._pack_consts(ec).tobytes())
        for a in [eb.gyro, eb.accel, eb.vo_q] + _state(st):
            f.write(np.ascontiguousarray(a.numpy(), np.float64).tobytes())
        for a in (eb.valid, eb.vo_active, eb.vo_steps_back):
            f.write(np.ascontiguousarray(a.numpy(), np.int32).tobytes())
    subprocess.run([harness, str(case), str(out)], check=True, capture_output=True, timeout=120)
    flat = torch.as_tensor(np.fromfile(out, np.float64))
    shapes = [(T, 4, B)] + [tuple(a.shape) for a in _state(st)]
    res, k = [], 0
    for sh in shapes:
        n = int(np.prod(sh))
        res.append(flat[k:k + n].reshape(sh))
        k += n
    assert k == flat.numel()
    return res


def _hold(res, q_p, fin_p, tol=TOL_EKF):
    for got, want, name in zip(res, [q_p] + _state(fin_p),
                               ("q_seq", "q", "P", "gyro_hist", "accel_hist", "q_hist",
                                "P_hist")):
        torch.testing.assert_close(got, want.to(got.dtype), **tol, msg=name)


def _walk(eb, t0):
    """The schedule as the kernel walks it: (valid count, [(t, sb) of every
    event on a valid substep])."""
    t, ev = t0, []
    for k in range(eb.valid.shape[0]):
        for j in range(eb.valid.shape[1]):
            if not eb.valid[k, j]:
                continue
            if eb.vo_active[k, j]:
                ev.append((t, int(eb.vo_steps_back[k, j]), k))
            t += 1
    return t - t0, ev


@pytest.mark.parametrize("quirk", [True, False], ids=["quirk_W", "textbook_W"])
@pytest.mark.parametrize("per_lane", [False, True], ids=["shared_vo_q", "per_lane_vo_q"])
def test_group_body_equals_plain(harness, tmp_path, per_lane, quirk):
    """40 ticks, B=13 over blocks of 8 instances (a ragged last block), every
    steps-back case; held against the plain version at float64."""
    st, eb = _fleet(40, 13, seed=3 + 2 * per_lane + quirk, per_lane=per_lane)
    n, ev = _walk(eb, 0)
    rewinds = [(t, n_) for t, n_, _ in ev if 1 <= n_ <= t and n_ < R]
    assert {1, R - 1} <= {n_ for _, n_ in rewinds}                       # sb = 1, R - 1
    assert any(n_ >= R for _, n_, _ in ev) and any(R > n_ > t for t, n_, _ in ev)
    ct = ekf_kernel.geometry(R, S, F64).ticks_per_chunk
    assert any(k >= ct and (t - n_) < sum(2 + (i % 3 != 2) for i in range(ct))
               for t, n_, k in ev if 1 < n_ <= t and n_ < R)               # across a chunk edge
    ec = ekf_lanes.make_consts(EKFParams(quirk_compatible_W=quirk), F64)
    q_p, fin_p = ekf_kernel.replay_plain(ec, st, eb)
    assert fin_p.t == n
    _hold(_run(harness, tmp_path, ec, st, eb), q_p, fin_p)


def test_group_body_split_log_and_carried_ring(harness, tmp_path):
    """A carried-in state with a random ring and t0 = 37 (the first rewinds
    read slots the launch did not push), over a log split into 25 + 15 ticks:
    the second call starts from the first one's output, and both together
    equal the plain version's one call."""
    st, eb = _fleet(40, 11, seed=7, per_lane=True, t0=37, random_state=True)
    ec = ekf_lanes.make_consts(EKFParams(), F64)
    q_p, fin_p = ekf_kernel.replay_plain(ec, st, eb)
    cut = 25
    ebA = estimator.EKFBlocks(*(a[:cut].contiguous() for a in eb))
    ebB = estimator.EKFBlocks(*(a[cut:].contiguous() for a in eb))
    resA = _run(harness, tmp_path, ec, st, ebA, name="A")
    stA = ekf_lanes.EKFStateL(q=resA[1], P=resA[2], t=st.t + _walk(ebA, st.t)[0],
                              gyro_hist=resA[3], accel_hist=resA[4], q_hist=resA[5],
                              P_hist=resA[6])
    resB = _run(harness, tmp_path, ec, stA, ebB, name="B")
    _hold([torch.cat([resA[0], resB[0]])] + resB[1:], q_p, fin_p)


def test_group_body_log_shorter_than_a_chunk(harness, tmp_path):
    """Five ticks (one partial chunk) and B=3, one block."""
    st, eb = _fleet(5, 3, seed=11, per_lane=False)
    ec = ekf_lanes.make_consts(EKFParams(), F64)
    q_p, fin_p = ekf_kernel.replay_plain(ec, st, eb)
    _hold(_run(harness, tmp_path, ec, st, eb), q_p, fin_p)


@pytest.mark.parametrize("per_lane", [False, True], ids=["shared_vo_q", "per_lane_vo_q"])
def test_group_body_one_tick_per_chunk(harness, tmp_path, per_lane):
    """50 substeps per tick, more than a chunk holds: each tick is staged
    alone, so every replay reaches back across chunk edges; 10 ticks, B=9."""
    st, eb = _fleet(10, 9, seed=5 + per_lane, per_lane=per_lane, S=50)
    assert ekf_kernel.geometry(R, 50, F64, per_lane).ticks_per_chunk == 1
    assert sum(1 <= n_ <= t and n_ < R for t, n_, _ in _walk(eb, 0)[1]) >= 4
    ec = ekf_lanes.make_consts(EKFParams(), F64)
    q_p, fin_p = ekf_kernel.replay_plain(ec, st, eb)
    _hold(_run(harness, tmp_path, ec, st, eb), q_p, fin_p)


def test_group_body_float32(harness, tmp_path):
    """The float32 instantiation against the plain version in float32 on the
    same inputs: within 1e-5 (rounding over 30 ticks of a stable filter)."""
    st, eb = _fleet(30, 10, seed=13, per_lane=False)
    ec = ekf_lanes.make_consts(EKFParams(), torch.float32)
    f32 = lambda a: a.float() if a.is_floating_point() else a
    st32 = st._replace(**{k: f32(getattr(st, k)) for k in ("q", "P", "gyro_hist", "accel_hist",
                                                          "q_hist", "P_hist")})
    eb32 = estimator.EKFBlocks(*(f32(a) for a in eb))
    q_p, fin_p = ekf_kernel.replay_plain(ec, st32, eb32)
    res = _run(harness, tmp_path, ec, st32, eb32, is_double=False)
    torch.testing.assert_close(res[0], q_p.double(), rtol=0.0, atol=1e-5)
    torch.testing.assert_close(res[2], fin_p.P.double(), rtol=1e-4, atol=1e-9)
