"""Padded, fixed-shape NMS, batched over leading dimensions.

Port of `mv2d_tpu/core/nms.py`.  Suppression is exact greedy NMS as a
blocked scan: each block is suppressed by the earlier kept boxes with one
masked reduction, then the within-block chain is resolved by a fixpoint
iteration, which converges to the unique greedy solution.  The iteration
stops once it is fixed, as the JAX package's `lax.while_loop` does: it is
PyTorch's `while_loop` operator, which eager runs as a loop and
`torch.export` keeps as one node.  There is no kernel here: the JAX
package has none on this path either.

Sorting is stable and `topk` breaks ties toward the lower index, as
`jnp.argsort` and `lax.top_k` do.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch._higher_order_ops.while_loop import while_loop_op

from . import boxes as box_utils

_NEG = -1e10
_NMS_BLOCK = 256


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, descending, ties to the lower
    index (the order `lax.top_k` returns)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx, ...rest] along the first dim after idx's batch dims."""
    extra = x.shape[idx.dim():]
    return torch.gather(x, idx.dim() - 1,
                        idx.reshape(*idx.shape, *(1,) * len(extra))
                        .expand(*idx.shape, *extra))


def _fixpoint_cond(it, k, prev, cand, kill):
    greedy_fixpoint.rounds += 1
    return (it < kill.shape[-1]) & (k != prev).any()


def _fixpoint_body(it, k, prev, cand, kill):
    return it + 1, cand & ~(kill & k[..., :, None]).any(-2), k


def greedy_fixpoint(cand: torch.Tensor, kill: torch.Tensor) -> torch.Tensor:
    """The greedy keep mask of one block: candidates cand [..., B] and the
    within-block suppressions kill [..., B, B] (i kills j > i) -> the
    fixpoint of k = cand & ~any_i(kill[i] & k[i]), from k = cand & ~(kill
    & cand) until k stops changing (at most B rounds)."""
    k = cand & ~(kill & cand[..., :, None]).any(-2)
    it = torch.zeros((), dtype=torch.int64, device=cand.device)
    # `while_loop_op` runs the loop eagerly outside a trace and becomes one
    # graph node under export (the public `while_loop` would compile)
    _, k, _ = while_loop_op(_fixpoint_cond, _fixpoint_body, (it, k, cand),
                            (cand, kill))
    return k


# the fixpoint's loop tests so far, each a host sync in eager (the stage
# benches read it: rounds a call)
greedy_fixpoint.rounds = 0


def _greedy_suppress_boxes(boxes: torch.Tensor, valid: torch.Tensor,
                           iou_threshold: float, iou_fn) -> torch.Tensor:
    """Exact greedy NMS over score-sorted boxes [..., N, D] with validity
    [..., N]; returns the keep mask [..., N]."""
    n = boxes.shape[-2]
    B = min(_NMS_BLOCK, n)
    nb = -(-n // B)
    pad = nb * B - n
    if pad:
        boxes = torch.cat([boxes, boxes.new_zeros(*boxes.shape[:-2], pad,
                                                  boxes.shape[-1])], dim=-2)
        valid = torch.cat([valid, valid.new_zeros(*valid.shape[:-1], pad)],
                          dim=-1)
    r = torch.arange(B, device=boxes.device)
    strictly_upper = r[:, None] < r[None, :]
    kept = valid.clone()
    for blk in range(nb):
        s = blk * B
        cols = iou_fn(boxes[..., :s + B, :],
                      boxes[..., s:s + B, :]) > iou_threshold   # [..., s+B, B]
        sup_prev = (cols[..., :s, :] & kept[..., :s, None]).any(-2)
        cand = kept[..., s:s + B] & ~sup_prev
        kill = cols[..., s:s + B, :] & strictly_upper
        kept[..., s:s + B] = greedy_fixpoint(cand, kill)
    return kept[..., :n]


def _sort_by_score(boxes, scores, valid):
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG))
    order = torch.argsort(-masked, dim=-1, stable=True)
    return (_take(boxes, order), torch.gather(masked, -1, order),
            torch.gather(valid, -1, order), order)


def nms_padded(boxes, scores, valid, iou_threshold: float, max_out: int):
    """Class-agnostic 2D NMS: boxes [..., N, 4], scores/valid [..., N] ->
    (boxes, scores, indices into the input, valid), each [..., max_out],
    score-descending."""
    b, s, v, order = _sort_by_score(boxes, scores, valid)
    keep = _greedy_suppress_boxes(b, v, iou_threshold,
                                  box_utils.box_iou_xyxy)
    sel = torch.argsort((~keep).to(torch.uint8), dim=-1,
                        stable=True)[..., :max_out]
    out_valid = torch.gather(keep, -1, sel)
    out_s = torch.gather(s, -1, sel)
    return (_take(b, sel), torch.where(out_valid, out_s,
                                       torch.full_like(out_s, _NEG)),
            torch.gather(order, -1, sel), out_valid)


def nms_sorted_keep(boxes, scores, valid, iou_threshold: float):
    """Greedy NMS without compaction: the score-sorted boxes and their
    post-suppression scores (suppressed or invalid = _NEG)."""
    b, s, v, _ = _sort_by_score(boxes, scores, valid)
    keep = _greedy_suppress_boxes(b, v, iou_threshold,
                                  box_utils.box_iou_xyxy)
    return b, torch.where(keep, s, torch.full_like(s, _NEG))


def multiclass_nms_2d(boxes, scores, valid, score_thr: float,
                      iou_threshold: float, nms_pre: int, max_out: int,
                      min_bbox_size: float = 0.0):
    """mmdet multiclass_nms with class-specific boxes and class-agnostic
    suppression.  boxes [..., R, C, 4], scores [..., R, C] (background
    dropped), valid [..., R] -> (boxes, scores, labels, valid), each
    [..., max_out]."""
    *lead, R, C = scores.shape
    flat_boxes = boxes.reshape(*lead, R * C, 4)
    flat_scores = scores.reshape(*lead, R * C)
    labels = torch.arange(C, device=scores.device).repeat(R)
    ok = valid.repeat_interleave(C, dim=-1) & (flat_scores > score_thr)
    if min_bbox_size > 0:
        wh = flat_boxes[..., 2:4] - flat_boxes[..., 0:2]
        ok = ok & (wh >= min_bbox_size).all(-1)
    masked = torch.where(ok, flat_scores,
                         torch.full_like(flat_scores, _NEG))
    top_scores, top_idx = topk(masked, min(nms_pre, R * C))
    top_boxes = _take(flat_boxes, top_idx)
    top_labels = labels[top_idx]
    top_valid = torch.gather(ok, -1, top_idx)
    _, os_, oi, ov = nms_padded(top_boxes, top_scores, top_valid,
                                iou_threshold, max_out)
    return (_take(top_boxes, oi), os_, torch.gather(top_labels, -1, oi),
            ov)


def nms_bev_padded(boxes_bev, scores, valid, iou_threshold: float,
                   max_out: int):
    """Rotated BEV NMS on one scene; boxes_bev [N, 5]."""
    b, s, v, order = _sort_by_score(boxes_bev, scores, valid)
    keep = _greedy_suppress_boxes(b, v, iou_threshold,
                                  box_utils.rotated_iou_bev)
    sel = torch.argsort((~keep).to(torch.uint8), stable=True)[:max_out]
    out_valid = keep[sel]
    return (order[sel], torch.where(out_valid, s[sel],
                                    torch.full_like(s[sel], _NEG)),
            out_valid)


def box3d_multiclass_nms(boxes3d, boxes_bev, scores, valid,
                         score_thr: float, max_per_scene: int,
                         iou_threshold: float, num_classes: int):
    """Cross-view 3D merge (mmdet3d box3d_multiclass_nms, rotated NMS per
    class).  boxes3d [N, B], boxes_bev [N, 5], scores [N, C+1] (last column
    background), valid [N] -> (boxes, scores, labels, valid) of
    max_per_scene slots.  iou_threshold >= 1 never suppresses."""
    N = boxes3d.shape[0]
    sel_boxes, sel_scores, sel_labels, sel_valid = [], [], [], []
    for cls in range(num_classes):
        s = scores[:, cls]
        ok = valid & (s > score_thr)
        if iou_threshold >= 1.0:
            keep_idx = torch.arange(N, device=s.device)
            keep_scores = torch.where(ok, s, torch.full_like(s, _NEG))
            keep_valid = ok
        else:
            keep_idx, keep_scores, keep_valid = nms_bev_padded(
                boxes_bev, s, ok, iou_threshold, N)
        sel_boxes.append(boxes3d[keep_idx])
        sel_scores.append(keep_scores)
        sel_labels.append(torch.full((N,), cls, dtype=torch.long,
                                     device=s.device))
        sel_valid.append(keep_valid)
    all_boxes = torch.cat(sel_boxes, 0)
    all_scores = torch.cat(sel_scores, 0)
    all_labels = torch.cat(sel_labels, 0)
    all_valid = torch.cat(sel_valid, 0)
    k = min(max_per_scene, all_scores.shape[0])
    top_scores, top_idx = topk(
        torch.where(all_valid, all_scores, torch.full_like(all_scores, _NEG)),
        k)
    out_valid = all_valid[top_idx]
    return (all_boxes[top_idx],
            torch.where(out_valid, top_scores, torch.zeros_like(top_scores)),
            all_labels[top_idx], out_valid)
