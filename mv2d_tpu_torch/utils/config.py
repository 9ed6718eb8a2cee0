"""Python-file config system with `_base_` inheritance.

The port's own copy of `mv2d_tpu/utils/config.py` (the port imports
nothing of the JAX package), with the same semantics, which the reference
configs under `configs/` rely on:
  * configs are python files executed in isolation; top-level names become
    the config dict,
  * `_base_ = ['relative/path.py', ...]` composes parent configs (later
    entries and the child override earlier ones via recursive dict merge),
  * a child dict containing `_delete_: True` replaces the base dict instead
    of merging,
  * `--cfg-options a.b.c=v` style deep overrides (`apply_overrides`).
"""
from __future__ import annotations

import ast
import copy
import os
import runpy
from typing import Any, Dict, List

DELETE_KEY = '_delete_'
BASE_KEY = '_base_'


def _merge(base: Dict, child: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in child.items():
        if isinstance(v, dict) and v.get(DELETE_KEY, False):
            v = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
            out[k] = copy.deepcopy(v)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: str) -> Dict[str, Any]:
    path = os.path.abspath(path)
    ns = runpy.run_path(path)
    cfg = {k: v for k, v in ns.items()
           if not k.startswith('__') and not callable(v)
           and not isinstance(v, type(os))}
    bases = cfg.pop(BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        merged = _merge(merged, load_config(
            os.path.join(os.path.dirname(path), b)))
    return _merge(merged, cfg)


def _parse_value(v: str) -> Any:
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        pass
    # config-file style calls like `evaluation=dict(interval=10)`, which
    # mmcv's DictAction accepts; kept as a string, such a value would
    # reach its consumer as a str, so the dict(...) form is parsed
    if v.strip().startswith(('dict(', 'dict (')):
        try:
            return eval(v, {'__builtins__': {}}, {'dict': dict})
        except Exception:
            pass
    return v


def apply_overrides(cfg: Dict[str, Any], options: List[str]) -> Dict[str, Any]:
    """options: ['a.b.c=1', 'd=[1,2]'] deep-merged into cfg."""
    cfg = copy.deepcopy(cfg)
    for opt in options or []:
        key, _, val = opt.partition('=')
        parts = key.strip().split('.')
        d = cfg
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = _parse_value(val)
    return cfg
