"""One training step of the reference on one scene, in float32: the port's
`parallel.dist.dp_train_step` with a world of one and no mixed precision,
written out (frozen copy of `dp_objective`'s arithmetic), and a plain
AdamW in place of `torch.optim.AdamW`.

  * the scene's losses with the 3D bbox losses deferred; each deferred
    weighted sum divided by max(num_pos, 1);
  * the gradients' global norm clipped at clip_norm;
  * AdamW (beta 0.9 / 0.999, eps 1e-8, decoupled weight decay), the
    backbone's group at lr x backbone_lr_mult, the lr of update t from the
    cosine schedule with a linear warmup (`train.optim.cosine_schedule`).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .nn.decoder import Dropout
from .train.optim import cosine_schedule
from .train.train_step import compute_losses, draw_train


class AdamW:
    """Plain AdamW over (name, parameter) pairs in two groups."""

    def __init__(self, model: torch.nn.Module, o: dict):
        self.o = o
        self.params: List[Tuple[str, torch.nn.Parameter, float]] = []
        for name, p in model.named_parameters():
            if p.requires_grad:
                bb = '.backbone.' in f'.{name}'
                self.params.append((name, p, o['backbone_lr_mult']
                                    if bb else 1.0))
        self.m = {n: torch.zeros_like(p) for n, p, _ in self.params}
        self.v = {n: torch.zeros_like(p) for n, p, _ in self.params}
        self.t = 0

    @torch.no_grad()
    def step(self) -> float:
        o = self.o
        grads = [p.grad for _, p, _ in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < o['clip_norm'], torch.ones_like(norm),
                            o['clip_norm'] / norm)
        lr = cosine_schedule(self.t, o['base_lr'], o['total_steps'])
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        for n, p, mult in self.params:
            if p.grad is None:
                continue
            g = p.grad * scale
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            mh = self.m[n] / (1 - b1 ** self.t)
            vh = self.v[n] / (1 - b2 ** self.t)
            a = lr * mult
            p.mul_(1 - a * o['weight_decay'])
            p.sub_(a * mh / (vh.sqrt() + eps))
        return float(norm)

    def first_gradient(self) -> Dict[str, torch.Tensor]:
        """After one step: the clipped gradient, m / (1 - beta1)."""
        return {n: self.m[n] / 0.1 for n, _, _ in self.params}


def objective(model, batch, generator: torch.Generator):
    """(the loss to back-propagate, the logged total) of one scene."""
    cfg = model.cfg
    draws = draw_train(cfg, batch.gt2d.boxes.shape[1], generator)
    total, metrics, deferred = compute_losses(
        model, batch, draws, Dropout(cfg.dropout, generator))
    logged = total.detach()
    for k, (s, num_pos) in deferred.items():
        d = s / num_pos.float().clamp(min=1.0)
        total = total + d
        logged = logged + d.detach()
    return total, logged


def train_step(model, opt: AdamW, batch, generator: torch.Generator
               ) -> float:
    """One update -> the logged total loss."""
    for _, p, _ in opt.params:
        p.grad = None
    loss, logged = objective(model, batch, generator)
    loss.backward()
    opt.step()
    return float(logged)
