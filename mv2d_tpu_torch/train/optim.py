"""Optimizer: AdamW with a backbone lr multiplier, cosine schedule with a
linear warmup, and global-norm gradient clipping.

Port of `mv2d_tpu/train/optim.py` (the reference recipe): AdamW (0.9,
0.999, weight decay 0.01), lr 2e-4, backbone lr x 0.25, grad clip 35,
cosine annealing to 1e-3 x lr with a 500-step linear warmup from lr / 3.
Frozen parameters (stem, layer1, every backbone BN affine:
requires_grad=False) are left out of the optimizer, so they never move.
"""
from __future__ import annotations

import math
from typing import Iterable

import torch


def cosine_schedule(step: int, base_lr: float, total_steps: int,
                    warmup_iters: int = 500, warmup_ratio: float = 1.0 / 3,
                    min_lr_ratio: float = 1e-3) -> float:
    """The learning rate of update `step` (0 for the first update)."""
    t = min(max(step / max(total_steps, 1), 0.0), 1.0)
    cos = base_lr * (min_lr_ratio + (1 - min_lr_ratio) * 0.5
                     * (1 + math.cos(math.pi * t)))
    if step >= warmup_iters:
        return cos
    warm = base_lr * (warmup_ratio + (1 - warmup_ratio)
                      * min(step, warmup_iters) / warmup_iters)
    return min(warm, cos)


def make_optimizer(model: torch.nn.Module, base_lr: float = 2e-4,
                   total_steps: int = 100000, weight_decay: float = 0.01,
                   backbone_lr_mult: float = 0.25) -> torch.optim.AdamW:
    """AdamW over the trainable parameters in two groups: the backbone
    (names under `base_detector.backbone`) at lr x backbone_lr_mult, and
    everything else.  `set_lr` applies the schedule before each step."""
    default, backbone = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (backbone if '.backbone.' in f'.{name}' else default).append(p)
    opt = torch.optim.AdamW(
        [{'params': default, 'lr_mult': 1.0},
         {'params': backbone, 'lr_mult': backbone_lr_mult}],
        lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay)
    opt.base_lr = base_lr
    opt.total_steps = total_steps
    return opt


def updates_done(optimizer: torch.optim.Optimizer) -> int:
    """How many steps the optimizer has taken (its parameters' count)."""
    for group in optimizer.param_groups:
        for p in group['params']:
            state = optimizer.state.get(p)
            if state and 'step' in state:
                return int(state['step'])
    return 0


def set_lr(optimizer: torch.optim.Optimizer, step: int) -> float:
    """Set each group's lr for update `step`; returns the default lr."""
    lr = cosine_schedule(step, optimizer.base_lr, optimizer.total_steps)
    for group in optimizer.param_groups:
        group['lr'] = lr * group['lr_mult']
    return lr


CLIP_NORM = 35.0


def clip_by_global_norm(params: Iterable[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """Scale every gradient by max_norm / norm when the global norm
    reaches max_norm (optax.clip_by_global_norm); returns the norm before
    clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def apply_update(optimizer: torch.optim.Optimizer):
    """Clip the gradients at CLIP_NORM, set the scheduled lr and step ->
    (gradient norm before clipping, the default group's lr)."""
    params = [p for grp in optimizer.param_groups for p in grp['params']]
    norm = clip_by_global_norm(params, CLIP_NORM)
    lr = set_lr(optimizer, updates_done(optimizer))
    optimizer.step()
    return norm, lr
