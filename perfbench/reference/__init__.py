"""The float32 reference of the benchmark's output check: plain PyTorch,
no hand kernel, no bf16, TF32 off (the caller turns it off).

A frozen copy of the port's float32 plain path (`mv2d_tpu_torch` at the
commit that added the benchmark, which the repository's CPU tests hold
to the JAX package at 1e-4): the model modules with every kernel entry
point bound to its plain version (`ops/`), the losses, matching and the
training step written out with a plain AdamW (`step.py`).  The module
docstrings are the port's; where one names a kernel, read its plain
version.  Later changes to the port do not reach this copy, so it stays
the yardstick.  It imports nothing of the program, of the JAX package or
of JAX.
"""
from __future__ import annotations

import torch

from .configs import CorrelationConfig, DetectionProposalCfg, MV2DConfig

NESTED = {'correlation': CorrelationConfig,
          'proposal_train': DetectionProposalCfg,
          'proposal_test': DetectionProposalCfg}


def build_config(model_cfg: dict) -> MV2DConfig:
    """MV2DConfig from a configuration file's `model`."""
    kw = {}
    for k, v in model_cfg.items():
        if k in NESTED:
            v = NESTED[k](**v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return MV2DConfig(**kw)


def build_model(model_cfg: dict, device) -> torch.nn.Module:
    """The reference model, float32, on `device`, with the modules'
    default initialisation (the caller loads the benchmark's weights)."""
    from .models.mv2d import MV2D
    with torch.device(device):
        model = MV2D(build_config(model_cfg))
    return model.to(device)
