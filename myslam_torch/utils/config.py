"""YAML config system with single-inheritance chains.

A config may name a parent via ``inherit_from``; chains resolve
root-first and child keys deep-merge over parents.  The default base is
configs/myslam.yaml, shared with the JAX package.
"""

from __future__ import annotations

import os

import yaml


def update_recursive(dst: dict, src: dict) -> None:
    """Deep-merge src into dst."""
    for k, v in src.items():
        if isinstance(v, dict):
            node = dst.setdefault(k, {})
            if isinstance(node, dict):
                update_recursive(node, v)
            else:
                dst[k] = v
        else:
            dst[k] = v


def load_config(path: str, default_path: str | None = None) -> dict:
    """Load a YAML config, resolving its ``inherit_from`` chain."""
    with open(path, "r") as f:
        cfg_special = yaml.full_load(f) or {}
    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        cfg = load_config(inherit_from, default_path)
    elif default_path is not None:
        with open(default_path, "r") as f:
            cfg = yaml.full_load(f) or {}
    else:
        cfg = {}
    update_recursive(cfg, cfg_special)
    return cfg


DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "configs",
    "myslam.yaml",
)
