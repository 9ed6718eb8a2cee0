"""NMS-free top-k decoding of decoder outputs.

Port of `mv2d_tpu/core/coder.py`: `nms_free_decode` (ref NMSFreeCoder
.decode_single) and `nms_free_cls_decode` (ref NMSFreeClsCoder), each
with fixed [max_num] slots and a validity mask.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..utils.profiling import counters
from .boxes import denormalize_bbox
from .nms import topk

_NEG = -1e10


def nms_free_decode(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                    query_valid: torch.Tensor, max_num: int,
                    num_classes: int, post_center_range: Sequence[float]):
    """cls_scores [Q, C] logits, bbox_preds [Q, 10] codes, query_valid [Q]
    -> (boxes [max_num, 9] gravity-center, scores, labels, valid)."""
    Q, C = cls_scores.shape
    probs = torch.sigmoid(cls_scores)
    flat = torch.where(query_valid[:, None], probs,
                       torch.full_like(probs, _NEG)).reshape(-1)
    k = min(max_num, Q * C)
    scores, idx = topk(flat, k)
    labels = idx % num_classes
    bbox_index = idx // num_classes
    boxes = denormalize_bbox(bbox_preds[bbox_index])
    counters['sync.coder.range'] += 2
    lo = boxes.new_tensor(post_center_range[:3])
    hi = boxes.new_tensor(post_center_range[3:])
    inside = (boxes[:, :3] >= lo).all(-1) & (boxes[:, :3] <= hi).all(-1)
    valid = query_valid[bbox_index] & (scores > _NEG / 2) & inside
    if k < max_num:
        pad = max_num - k
        boxes = torch.cat([boxes, boxes.new_zeros(pad, boxes.shape[1])])
        scores = torch.cat([scores, scores.new_full((pad,), _NEG)])
        labels = torch.cat([labels, labels.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return boxes, torch.where(valid, scores, torch.zeros_like(scores)), \
        labels, valid


def nms_free_cls_decode(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                        query_valid: torch.Tensor, max_num: int,
                        num_classes: int,
                        post_center_range: Sequence[float] | None = None,
                        score_threshold: float | None = None):
    """The NMSFreeClsCoder variant: cls_scores [Q, num_classes + 1] logits
    (background last) -> softmax, then a per-query top-k on the best
    foreground score -> (boxes [max_num, 9] gravity-center, scores,
    labels, valid).  A padded slot's label is query 0's, as in JAX."""
    Q = cls_scores.shape[0]
    probs = torch.softmax(cls_scores, dim=-1)[:, :num_classes]
    best, labels = probs.max(-1)
    best = torch.where(query_valid, best, torch.full_like(best, _NEG))
    k = min(max_num, Q)
    scores, idx = topk(best, k)
    boxes = denormalize_bbox(bbox_preds[idx])
    valid = query_valid[idx] & (scores > _NEG / 2)
    if score_threshold is not None:
        valid = valid & (scores > score_threshold)
    if post_center_range is not None:     # Python scalars: no copy
        lo, hi = post_center_range[:3], post_center_range[3:]
        for i in range(3):
            valid = valid & (boxes[:, i] >= lo[i]) & (boxes[:, i] <= hi[i])
    if k < max_num:
        pad = max_num - k
        boxes = torch.cat([boxes, boxes.new_zeros(pad, boxes.shape[1])])
        scores = torch.cat([scores, scores.new_full((pad,), _NEG)])
        idx = torch.cat([idx, idx.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return boxes, torch.where(valid, scores, torch.zeros_like(scores)), \
        labels[idx], valid
