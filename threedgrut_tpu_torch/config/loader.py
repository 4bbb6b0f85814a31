"""Hydra-style YAML configuration loader (copied from
threedgrut_tpu/config/loader.py:13-198: the YAML compose, the overrides
and the resolvers; the mapping to the trainer's config is
train_torch.py:trainer_config).

Composes the configs/ tree with ``defaults`` lists, group overrides like
``render: 3dgut``, dotted command-line overrides ``a.b.c=value``, the
resolvers ``${int_list:[...]}`` and ``${div:x,y}`` and ``${a.b}``
interpolation.
"""

from __future__ import annotations

import copy
import os
import re
from typing import List, Optional

import yaml


class ConfigNode(dict):
    """dict with attribute access (read/write), recursively."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return ConfigNode({k: ConfigNode.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigNode.wrap(v) for v in obj]
        return obj


def _deep_merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if (k in out and isinstance(out[k], dict) and isinstance(v, dict)):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


_INTERP = re.compile(r"\$\{([^${}]+)\}")  # innermost interpolation


def _lookup(root: dict, dotted: str):
    cur = root
    for part in dotted.split("."):
        cur = cur[part]
    return cur


def _resolve_value(root: dict, value):
    """Resolve ${...} interpolations innermost-first (handles nesting)."""
    for _ in range(10):  # nesting depth bound
        if not isinstance(value, str):
            return value
        m = _INTERP.fullmatch(value.strip())
        if m:
            value = _resolve_expr(root, m.group(1))
            continue
        if _INTERP.search(value):
            value = _INTERP.sub(
                lambda mm: str(_resolve_expr(root, mm.group(1))), value)
            continue
        return value
    return value


def _resolve_expr(root: dict, expr: str):
    expr = expr.strip()
    if expr.startswith("int_list:"):
        inner = expr[len("int_list:"):].strip()
        vals = yaml.safe_load(inner)
        return [int(v) for v in vals]
    if expr.startswith("div:"):
        args = expr[len("div:"):].split(",")
        nums = []
        for a in args:
            a = a.strip()
            m = _INTERP.fullmatch(a)
            if m:
                nums.append(float(_resolve_expr(root, m.group(1))))
            elif a.replace(".", "", 1).replace("-", "", 1).isdigit():
                nums.append(float(a))
            else:
                nums.append(float(_resolve_value(root, _lookup(root, a))))
        return nums[0] / nums[1]
    # plain dotted reference
    v = _lookup(root, expr)
    return _resolve_value(root, v)


def _resolve_tree(root: dict, node):
    if isinstance(node, dict):
        return {k: _resolve_tree(root, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_tree(root, v) for v in node]
    return _resolve_value(root, node)


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _compose(config_dir: str, name: str, group: Optional[str] = None) -> dict:
    """Load <config_dir>/[group/]<name>.yaml applying its `defaults` list."""
    rel = os.path.join(group, name) if group else name
    path = os.path.join(config_dir, rel + ".yaml")
    # sibling (non-"/") defaults resolve relative to THIS file's
    # directory, hydra-style - `name` itself may carry subdirectories
    # (e.g. load_config("paper/3dgut/sorted") referencing sorted_colmap)
    sibling_group = os.path.dirname(rel) or None
    raw = _load_yaml(path)
    defaults = raw.pop("defaults", [])
    self_pos_applied = False
    merged: dict = {}
    for item in defaults:
        if item == "_self_":
            merged = _deep_merge(merged, raw)
            self_pos_applied = True
            continue
        if isinstance(item, str):
            if item.startswith("/"):
                # absolute reference from the config root (e.g. "/base")
                ref = item.lstrip("/")
                g, _, nm = ref.rpartition("/")
                sub = _compose(config_dir, nm, g or None)
            else:
                # sibling config in the same group (e.g. 3dgut: [3dgrt])
                sub = _compose(config_dir, item, sibling_group)
            merged = _deep_merge(merged, sub)
            continue
        if isinstance(item, dict):
            for key, val in item.items():
                if key.startswith("override") or val is None:
                    continue
                g = key.lstrip("/")
                if g.startswith("hydra"):
                    continue
                sub = _compose(config_dir, str(val), g)
                merged = _deep_merge(merged, {g: sub})
    if not self_pos_applied:
        merged = _deep_merge(merged, raw)
    return merged


def load_config(name: str, config_dir: Optional[str] = None,
                overrides: Optional[List[str]] = None) -> ConfigNode:
    """Compose a config by name with optional dotted overrides.

    Example: load_config("apps/nerf_synthetic_3dgut",
                         overrides=["path=data/lego", "n_iterations=100"]).
    """
    config_dir = config_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "configs")
    conf = _compose(config_dir, name)
    _apply_overrides(conf, overrides)
    conf = _resolve_tree(conf, conf)
    return ConfigNode.wrap(conf)


def _apply_overrides(conf: dict, overrides: Optional[List[str]]):
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' must be key=value")
        key, val = ov.split("=", 1)
        parsed = yaml.safe_load(val)
        cur = conf
        parts = key.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = parsed

