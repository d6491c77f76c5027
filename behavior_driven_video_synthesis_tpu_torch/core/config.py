"""Run configs: the YAML files of ``configs/`` as nested dicts.

Counterpart of the loading half of
``behavior_driven_video_synthesis_tpu/core/config.py``: a safe YAML loader
that also reads the ``!!python/tuple`` tags of the reference's configs,
a deep merge for overrides, and the dump that keeps a run's config beside
it.  Sections stay plain dicts (``config["training"].get(...)``).
"""
from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Any

import yaml


class _TupleSafeLoader(yaml.SafeLoader):
    """SafeLoader that also understands ``!!python/tuple``."""


_TupleSafeLoader.add_constructor(
    "tag:yaml.org,2002:python/tuple",
    lambda loader, node: tuple(loader.construct_sequence(node)))


def loads_config(text: str) -> dict:
    return yaml.load(text, Loader=_TupleSafeLoader) or {}


def load_config(path: str | os.PathLike) -> dict:
    with open(path, "r") as f:
        return loads_config(f.read())


def _plain(v: Any) -> Any:
    if isinstance(v, Mapping):
        return {k: _plain(e) for k, e in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(e) for e in v]
    return v


def deep_merge(base: Mapping, override: Mapping) -> dict:
    """``override`` merged into ``base`` recursively (override wins)."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(out.get(k), Mapping) and isinstance(v, Mapping):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def save_config(config: Mapping, path: str | os.PathLike) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(_plain(config), f, default_flow_style=False,
                       sort_keys=False)
