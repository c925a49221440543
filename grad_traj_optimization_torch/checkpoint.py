"""Checkpoint / resume for long batched runs (port of
``grad_traj_optimization_tpu.checkpoint``).

The reference has no checkpointing (benchmark results are append-only
text files, compare2.cpp:219).  A checkpoint here is the JAX package's
own NumPy layout: one compressed ``.npz`` whose ``leaf_{i}`` arrays are
the tree's leaves in flattening order (NamedTuple and tuple fields in
order, dict values by sorted key, None an empty subtree).  So the JAX
package's ``restore`` reads a checkpoint this module wrote, and this
module reads one the JAX package wrote without orbax.  The port needs no
orbax.
"""

from __future__ import annotations

import numpy as np
import torch


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(tree) -> list:
    """The tree's leaves (tensors, arrays, scalars) in JAX's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _flatten(t)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return type(like)((k, out[k]) for k in like)
    if isinstance(like, (tuple, list)):
        items = [_unflatten(t, leaves) for t in like]
        if hasattr(like, "_fields"):  # NamedTuple
            return type(like)(*items)
        return type(like)(items)
    return next(leaves)


def save(path: str, tree) -> str:
    """Save a tree of tensors or arrays (Scenario/Solution batch, solver
    state, ...) to ``path`` (``.npz`` appended if missing); returns the
    file's path.  Tensors are downloaded from their device."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    out = _npz_path(path)
    np.savez_compressed(
        out, **{f"leaf_{i}": host(x) for i, x in enumerate(_flatten(tree))}
    )
    return out


def restore(path: str, like):
    """Restore a tree saved by :func:`save` (or by the JAX package's npz
    fallback); ``like`` gives the structure, and each tensor leaf of
    ``like`` its dtype and device (a CUDA Solution comes back on CUDA).
    Leaves of ``like`` that are not tensors come back as numpy arrays."""
    with np.load(_npz_path(path)) as npz:
        flat = _flatten(like)
        leaves = []
        for i, ref in enumerate(flat):
            a = npz[f"leaf_{i}"]
            if isinstance(ref, torch.Tensor):
                a = torch.as_tensor(a, device=ref.device).to(ref.dtype)
            leaves.append(a)
    return _unflatten(like, iter(leaves))
