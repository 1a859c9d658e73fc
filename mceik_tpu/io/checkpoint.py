"""Checkpoint/resume of sampler state (SURVEY.md §5 "Checkpoint").

Checkpoints are complete — every chain's parameters, log-posterior,
adaptation state and the PRNG key — so any crash resumes exactly
(bit-identical modulo reduction order). Writes are atomic
(tmp file + rename). Restoration is example-driven: leaves are stored by
their pytree key path and loaded back into a structurally identical
example, which keeps the format stable across dataclass changes that only
reorder fields. The file is a NumPy ``.npz`` archive: one array per leaf
under its key path, plus the JSON meta under ``_META``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import jax
import numpy as np


_META = "_META"


def _flatten_with_paths(tree: Any):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "name", getattr(p, "idx", getattr(p, "key", p))))
                       for p in path)
        out[key or "_root"] = np.asarray(leaf)
    return out


def save_checkpoint(path: str, state: Any, meta: Optional[Dict] = None) -> None:
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = _flatten_with_paths(state)
    arrays[_META] = np.asarray(json.dumps(meta or {}))
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, example: Any):
    """Load a checkpoint into the structure of ``example``.

    Returns ``(state, meta)``; raises KeyError if the stored leaves don't
    match the example's pytree paths (a config mismatch).
    """
    with np.load(path, allow_pickle=False) as f:
        stored = {k: f[k] for k in f.files}
    meta = json.loads(str(stored.pop(_META, "{}")))

    flat, treedef = jax.tree_util.tree_flatten_with_path(example)
    leaves = []
    for p, leaf in flat:
        key = "/".join(str(getattr(q, "name", getattr(q, "idx", getattr(q, "key", q))))
                       for q in p) or "_root"
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = stored[key]
        if arr.shape != np.shape(leaf):
            raise ValueError(f"shape mismatch for {key!r}: "
                             f"checkpoint {arr.shape} vs example {np.shape(leaf)}")
        leaves.append(arr.astype(np.asarray(leaf).dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves), meta

