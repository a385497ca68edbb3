"""Checkpoint / resume for estimator carries.

Counterpart of the reference ``utils/checkpoint.py``. The reference has no
checkpointing (SURVEY.md §5); its closest analogs are MHEproblem::resetQP
(MheSrb.cpp:734-760) and the arrival-cost pair (M_p, n_p) — the compressed
sufficient statistic of all marginalized history. The whole estimator carry
(EKF ring, MHE window tensors, arrival pair, Bezier waypoints) is a small
tree of tensors, so long sweeps snapshot it as one npz and resume bit-exactly.

The file format is the reference's: the leaves in JAX's flatten order under
the keys ``leaf_{i}``, so a snapshot written by either package loads into
the other. That order is: NamedTuples, tuples and lists by position, dicts
by sorted key, ``None`` and ``()`` contributing no leaf (the lanes state's
unconstrained ``z_adm``/``y_adm``). The port keeps a few counters as host
ints where the reference holds 0-d int32 arrays (``MHEState.T``,
``EKFStateL.t``, the standard layout's ``BezierCarry.count``): they are saved
as 0-d arrays and restored as ints.
"""

from __future__ import annotations

import numpy as np
import torch

_SCALARS = (bool, int, float, np.generic)


def _flatten(tree, out):
    """Append ``tree``'s leaves to ``out`` in JAX's flatten order."""
    if isinstance(tree, (torch.Tensor, np.ndarray) + _SCALARS):
        out.append(tree)
    elif tree is None:
        pass
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _flatten(v, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    else:
        raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}")
    return out


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from the iterator ``leaves``."""
    if isinstance(like, (torch.Tensor, np.ndarray) + _SCALARS):
        return next(leaves)
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return {k: _unflatten(like[k], leaves) for k in sorted(like)}


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_carry(path: str, carry) -> None:
    """Snapshot any tree-of-tensors carry to ``path`` (npz)."""
    leaves = _flatten(carry, [])
    np.savez_compressed(path, **{f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)})


def _restore(arr, ref):
    """A saved array as the template leaf's kind: a tensor of its dtype on
    its device, a numpy array of its dtype, or a Python scalar of its type."""
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(np.array(arr)).to(dtype=ref.dtype, device=ref.device)
    if isinstance(ref, np.ndarray):
        return np.array(arr, dtype=ref.dtype)
    return type(ref)(np.asarray(arr).item())


def load_carry(path: str, like):
    """Restore a carry saved by ``save_carry``; ``like`` provides the
    structure, dtypes and device (e.g. a freshly initialized carry)."""
    like_leaves = _flatten(like, [])
    leaves = []
    with np.load(path) as data:
        for i, ref in enumerate(like_leaves):
            key = f"leaf_{i}"
            if key in data.files:
                # Leaves are matched by flatten order, so a saved array whose
                # shape disagrees with the template leaf means the carry's
                # STRUCTURE changed in a non-trailing position (e.g. a nested
                # state gained fields) and every later leaf would silently load
                # into a shifted slot — refuse rather than resume wrong state.
                saved_shape = tuple(data[key].shape)
                ref_shape = tuple(np.shape(ref))
                if saved_shape != ref_shape:
                    raise ValueError(
                        f"checkpoint leaf {i} shape {saved_shape} does not match "
                        f"the template's {ref_shape}; the carry structure changed "
                        f"in a non-trailing position — this snapshot cannot be "
                        f"resumed into the current carry type")
                leaves.append(_restore(data[key], ref))
            else:
                # Forward compatibility: a carry type may gain TRAILING fields
                # (e.g. MHEState's ADMM warm-start iterates z_adm/y_adm) after a
                # snapshot was written. Missing trailing leaves resume from the
                # template's values — correct for warm-start/diagnostic state,
                # whose zero/fresh value is a valid cold start.
                leaves.append(ref.clone() if isinstance(ref, torch.Tensor) else ref)
    return _unflatten(like, iter(leaves))
