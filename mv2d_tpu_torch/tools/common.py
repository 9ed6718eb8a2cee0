"""Config -> model and dataset plumbing for the port's command-line tools.

The counterpart of the repository's `tools/common.py`: a config file under
`configs/` (its `_base_` files merged, then `--cfg-options` applied) names
a preset of `mv2d_tpu_torch.configs` in `model.preset`, with keyword
overrides in `model.overrides`, and the datasets in `data.train` /
`data.val`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import configs as presets
from ..configs import MV2DConfig
from ..data.nuscenes import NuScenesDataset, SampleBuckets
from ..data.pipeline import IdaAugConfig
from ..models.mv2d import MV2D
from ..routes import Routes
from ..synthetic import init_random_weights
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


def device_and_dtype(device: str) -> Tuple[torch.device, torch.dtype]:
    """The device a tool runs on and the model's dtype there: bfloat16 on
    the GPU, float32 on the CPU.  Raises where CUDA is asked for and
    absent."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device 'cpu' "
                           '(--device cpu) to run on the CPU')
    return dev, torch.bfloat16 if dev.type == 'cuda' else torch.float32


def load_weights(model: MV2D, checkpoint: Optional[str]) -> MV2D:
    """A torch state dict with the reference's key names (a `.pth`,
    optionally under 'state_dict'), loaded with strict=True; without a
    checkpoint, `synthetic.init_random_weights` (seed 0)."""
    if checkpoint:
        sd = torch.load(checkpoint, map_location='cpu')
        model.load_state_dict(sd.get('state_dict', sd), strict=True)
    else:
        init_random_weights(model, seed=0)
    return model


def build_dataset(cfg: dict, split: str) -> NuScenesDataset:
    d = dict(cfg['data'][split])
    final_dim = tuple(d.get('final_dim', (512, 1408)))
    mcfg = build_model_config(cfg)
    # GT buckets must match the model's static shapes (DN group width;
    # max_gt2d sizes the GT-complement proposal slots)
    buckets = SampleBuckets(max_gt3d=mcfg.max_gt, max_gt2d=mcfg.max_gt2d)
    return NuScenesDataset(
        info_path=d['info_path'], ann2d_path=d.get('ann2d_path'),
        data_root=d.get('data_root', ''),
        num_frames=d.get('num_frames', 1),
        sweep_range=tuple(d.get('sweep_range', (3, 27))),
        test_mode=d.get('test_mode', split != 'train'),
        final_dim=final_dim, ida=IdaAugConfig(final_dim=final_dim),
        buckets=buckets)


def load_cli_config(path: str, cfg_options=None) -> dict:
    cfg = load_config(path)
    if cfg_options:
        cfg = apply_overrides(cfg, cfg_options)
    return cfg
