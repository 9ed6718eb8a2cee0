"""Hungarian set matching for the 3D head's DETR-style training.

Port of `mv2d_tpu/core/matching.py` (HungarianAssigner3D with the MV2D
costs): FocalLossCost (weight 2.0) on sigmoid probabilities and
BBox3DL1Cost (weight 0.25) over the first 8 normalized code dims.  The
assignment is the exact host solver, `scipy.optimize.linear_sum_assignment`
on a float64 copy of the [Q, G] cost (the JAX package's 'callback'
method); its on-device 'jv' and 'auction' solvers exist for a TPU that
cannot call the host and are not ported.  Padded rows and columns carry a
large constant cost and their pairs are dropped after the assignment.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_BIG = 1e8


def focal_loss_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
                    weight: float = 2.0, alpha: float = 0.25,
                    gamma: float = 2.0, eps: float = 1e-12) -> torch.Tensor:
    """cls_logits [..., Q, C], gt_labels [G] -> [..., Q, G]."""
    p = torch.sigmoid(cls_logits.float())
    neg = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    pos = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    return (pos - neg)[..., gt_labels.long()] * weight


def bbox3d_l1_cost(bbox_pred: torch.Tensor, gt_code: torch.Tensor,
                   weight: float = 0.25, ndims: int = 8) -> torch.Tensor:
    """L1 over the first `ndims` code dims: [..., Q, 10] x [G, 10] ->
    [..., Q, G]."""
    d = (bbox_pred.float()[..., :, None, :ndims]
         - gt_code.float()[None, :, :ndims]).abs()
    return d.sum(-1) * weight


def lsa_host(cost: np.ndarray) -> np.ndarray:
    """Min-cost assignment of [Q, G] -> column of each row [Q] (-1 where
    none), exact (scipy)."""
    from scipy.optimize import linear_sum_assignment
    cost = np.nan_to_num(np.asarray(cost, np.float64), nan=_BIG,
                         posinf=_BIG, neginf=-_BIG)
    rows, cols = linear_sum_assignment(cost)
    out = np.full((cost.shape[0],), -1, np.int64)
    out[rows] = cols
    return out


def hungarian_assign(costs: torch.Tensor, query_valid: torch.Tensor,
                     gt_valid: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """costs [..., Q, G] (no gradient); query_valid [Q]; gt_valid [G] ->
    (assigned gt [..., Q] int64, -1 where unmatched; positive mask
    [..., Q]).  Every valid gt meets one valid query when there are enough
    of them.  All the cost matrices reach the host in one copy."""
    G = costs.shape[-1]
    ok = query_valid[:, None] & gt_valid[None, :]
    c = torch.where(ok, costs.detach().float(),
                    torch.full_like(costs, _BIG, dtype=torch.float32))
    host = c.cpu().numpy()
    flat = host.reshape(-1, *host.shape[-2:])
    assigned = np.stack([lsa_host(m) for m in flat]).reshape(host.shape[:-1])
    assigned = torch.from_numpy(assigned).to(costs.device)
    safe = assigned.clamp(0, G - 1)
    pos = (assigned >= 0) & gt_valid[safe] & query_valid
    return torch.where(pos, assigned, torch.full_like(assigned, -1)), pos


def match_cost(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
               gt_code: torch.Tensor, gt_labels: torch.Tensor,
               weights: Sequence[float] = (2.0, 0.25)) -> torch.Tensor:
    """The MV2D matching cost: focal (2.0) + bbox L1 (0.25), [..., Q, G]."""
    return focal_loss_cost(cls_scores, gt_labels, weight=weights[0]) + \
        bbox3d_l1_cost(bbox_preds, gt_code, weight=weights[1])
