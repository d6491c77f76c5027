"""Parameter trees (nested mappings of arrays) stored as .npz files.

The keys are the tree's paths joined with "/".  Numpy only, so the JAX
side can write the files without torch and the port can read them without
JAX.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping -> {"a/b/c": array}."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat: Mapping) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_flax_npz(path: str, tree: Mapping) -> None:
    """Store a parameter tree as an .npz of "/"-joined keys."""
    np.savez(path, **flatten_tree(tree))


def load_flax_npz(path: str) -> Dict[str, Any]:
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})
