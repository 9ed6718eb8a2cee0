"""Sigmoid focal loss, weighted L1, softmax cross-entropy and the
elementwise BCE with logits.

Port of `mv2d_tpu/ops/focal_loss.py` (mmdet FocalLoss / L1Loss with an
`avg_factor` reduction).  Every helper computes in float32, whatever the
dtype of its inputs (the reference's force_fp32 loss heads).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross-entropy with logits, elementwise."""
    return logits.clamp(min=0) - logits * targets + \
        torch.log1p(torch.exp(-logits.abs()))


def _avg(avg_factor) -> torch.Tensor | float:
    if torch.is_tensor(avg_factor):
        return avg_factor.float().clamp(min=1.0)
    return max(float(avg_factor), 1.0)


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: torch.Tensor, num_classes: int,
                       alpha: float = 0.25, gamma: float = 2.0,
                       avg_factor=1.0, loss_weight: float = 1.0
                       ) -> torch.Tensor:
    """logits [N, C]; labels [N] in [0, C] (C = background, an all-zero
    target); weights [N]."""
    logits = logits.float()
    targets = F.one_hot(labels.long(), num_classes + 1)[:, :num_classes] \
        .float()
    p = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    loss = alpha_t * (1 - p_t) ** gamma * ce
    loss = loss.sum(-1) * weights.float()
    return loss_weight * loss.sum() / _avg(avg_factor)


def weighted_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                     weights: torch.Tensor, avg_factor=1.0,
                     loss_weight: float = 1.0) -> torch.Tensor:
    loss = (pred.float() - target.float()).abs() * weights.float()
    return loss_weight * loss.sum() / _avg(avg_factor)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor, avg_factor=1.0
                          ) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return (nll * weights.float()).sum() / _avg(avg_factor)
