"""Config -> model plumbing for the port's command-line tools.

The counterpart of the repository's `tools/common.py` without the
dataset: a config file under `configs/` (its `_base_` files merged, then
`--cfg-options` applied) names a preset of `mv2d_tpu_torch.configs` in
`model.preset`, with keyword overrides in `model.overrides`.
"""
from __future__ import annotations

from typing import Optional

from .. import configs as presets
from ..configs import MV2DConfig
from ..models.mv2d import MV2D
from ..routes import Routes
from ..utils.config import apply_overrides, load_config


def build_model_config(cfg: dict) -> MV2DConfig:
    m = cfg['model']
    preset_fn = getattr(presets, m['preset'])
    overrides = dict(m.get('overrides', {}))
    return preset_fn(**overrides)


def build_model(cfg: dict, routes: Optional[Routes] = None) -> MV2D:
    """The model of a config; `routes` as `MV2D` takes them (by default
    read from the environment)."""
    return MV2D(build_model_config(cfg), routes)


def load_cli_config(path: str, cfg_options=None) -> dict:
    cfg = load_config(path)
    if cfg_options:
        cfg = apply_overrides(cfg, cfg_options)
    return cfg
