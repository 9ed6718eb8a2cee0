"""2D detector training: anchor / RoI assignment, sampling and losses.

Port of `mv2d_tpu/train/detector2d_loss.py` (the mmdet training slice of
the reference's Faster R-CNN):
  * RPN: MaxIoUAssigner(pos 0.7 / neg 0.3 / min_pos 0.3, low-quality
    matches) + RandomSampler(256, pos_fraction 0.5), BCE + L1 losses;
  * R-CNN: MaxIoUAssigner(0.5 / 0.5 / 0.5) + RandomSampler(512,
    pos_fraction 0.25, GT added as proposals), softmax CE + per-class L1;
  * the single-stage (RetinaNet) head: MaxIoUAssigner(0.5 / 0.4 / 0) over
    every anchor, sigmoid focal loss and L1 on the positives, both
    averaged by the positives' count.

Random sampling of k from a candidate set is "rank the candidates by a
uniform key, keep the k smallest", with the keys an argument (`u_pos`,
`u_neg`, one uniform per candidate), so a test can hand both packages the
same numbers.  Every function is batched over a leading view axis.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..core.boxes import box_iou_xyxy
from ..core.nms import topk
from ..nn.rpn import bbox2delta
from ..ops.focal_loss import (sigmoid_ce, softmax_cross_entropy,
                              weighted_l1_loss)


class AssignResult(NamedTuple):
    assigned_gt: torch.Tensor   # [..., N] int64, -1 = none
    is_pos: torch.Tensor        # [..., N] bool
    is_neg: torch.Tensor        # [..., N] bool
    max_iou: torch.Tensor       # [..., N]


def max_iou_assign(boxes: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor, pos_iou_thr: float,
                   neg_iou_thr: float, min_pos_iou: float,
                   match_low_quality: bool = True) -> AssignResult:
    """mmdet MaxIoUAssigner with padded GT: boxes [..., N, 4] (or shared
    [N, 4]), gt_boxes [..., G, 4], gt_valid [..., G]."""
    iou = box_iou_xyxy(boxes.float(), gt_boxes.float())
    iou = torch.where(gt_valid[..., None, :], iou, torch.zeros_like(iou))
    max_iou, argmax_gt = iou.max(-1)
    is_neg = max_iou < neg_iou_thr
    is_pos = max_iou >= pos_iou_thr
    assigned = torch.where(is_pos, argmax_gt, torch.full_like(argmax_gt, -1))
    if match_low_quality:
        # each gt's best boxes become positive; the last such gt wins
        gt_best = iou.max(-2).values                             # [..., G]
        cand = (iou == gt_best[..., None, :]) \
            & ((gt_best >= min_pos_iou) & gt_valid)[..., None, :]
        G = gt_boxes.shape[-2]
        gid = torch.arange(G, dtype=torch.int32, device=iou.device)
        last_gt = torch.where(cand, gid, -1).max(-1).values.long()
        lowq = cand.any(-1)
        assigned = torch.where(lowq, last_gt, assigned)
        is_pos = is_pos | lowq
    return AssignResult(assigned, is_pos, is_neg & ~is_pos, max_iou)


def random_sample(is_pos: torch.Tensor, is_neg: torch.Tensor, num: int,
                  pos_fraction: float, u_pos: torch.Tensor,
                  u_neg: torch.Tensor):
    """mmdet RandomSampler over the last axis: at most num * pos_fraction
    positives, the rest of `num` negatives; a candidate's rank is its
    uniform key (ties toward the lower index, as lax.top_k).  Returns
    (pos_selected, neg_selected) bool masks."""
    n = is_pos.shape[-1]
    k_pos = int(num * pos_fraction)
    two = torch.full_like(u_pos, 2.0)
    _, pidx = topk(-torch.where(is_pos, u_pos, two), min(k_pos, n))
    pos_sel = torch.zeros_like(is_pos).scatter(-1, pidx, True) & is_pos
    k_neg = num - pos_sel.sum(-1).clamp(max=k_pos)
    _, nidx = topk(-torch.where(is_neg, u_neg, two), min(num, n))
    take = torch.arange(min(num, n), device=is_pos.device) < k_neg[..., None]
    neg_sel = torch.zeros_like(is_neg).scatter(-1, nidx, take) & is_neg
    return pos_sel, neg_sel


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [..., G, D], idx [..., N] (clipped into range) -> [..., N, D]."""
    safe = idx.clamp(0, table.shape[-2] - 1)
    return torch.gather(table, -2, safe[..., None].expand(
        *safe.shape, table.shape[-1]))


def rpn_loss(flat_scores: torch.Tensor, flat_deltas: torch.Tensor,
             anchors: torch.Tensor, gt_boxes: torch.Tensor,
             gt_valid: torch.Tensor, u_pos: torch.Tensor,
             u_neg: torch.Tensor, num_sample: int = 256,
             pos_fraction: float = 0.5) -> Dict[str, torch.Tensor]:
    """Per-view RPN losses.  flat_scores [V, N] logits (levels
    concatenated); flat_deltas [V, N, 4]; anchors [N, 4]; gt [V, G, 4];
    u_pos / u_neg [V, N] -> {loss_rpn_cls, loss_rpn_bbox, rpn_num_pos}
    each [V]."""
    a = max_iou_assign(anchors, gt_boxes, gt_valid, 0.7, 0.3, 0.3)
    pos_sel, neg_sel = random_sample(a.is_pos, a.is_neg, num_sample,
                                     pos_fraction, u_pos, u_neg)
    sampled = (pos_sel | neg_sel).float()
    avg = sampled.sum(-1).clamp(min=1.0)
    loss_cls = (sigmoid_ce(flat_scores.float(), pos_sel.float())
                * sampled).sum(-1) / avg
    target = bbox2delta(anchors, _gather_rows(gt_boxes.float(),
                                              a.assigned_gt))
    loss_bbox = ((flat_deltas.float() - torch.nan_to_num(target)).abs()
                 * pos_sel[..., None].float()).sum((-1, -2)) / avg
    return {'loss_rpn_cls': loss_cls, 'loss_rpn_bbox': loss_bbox,
            'rpn_num_pos': pos_sel.sum(-1)}


class RCNNSamples(NamedTuple):
    rois: torch.Tensor          # [V, S, 4] sampled boxes (image pixels)
    labels: torch.Tensor        # [V, S] int64, num_classes = background
    reg_targets: torch.Tensor   # [V, S, 4] deltas
    is_pos: torch.Tensor        # [V, S] bool
    weight: torch.Tensor        # [V, S] 1.0 for sampled slots


def rcnn_sample(proposals: torch.Tensor, proposal_valid: torch.Tensor,
                gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                gt_valid: torch.Tensor, u_pos: torch.Tensor,
                u_neg: torch.Tensor, num_classes: int = 10,
                num_sample: int = 512, pos_fraction: float = 0.25
                ) -> RCNNSamples:
    """Assign and sample RoIs per view, GT added as proposals: proposals
    [V, P, 4], gt [V, G, 4], u_pos / u_neg [V, P + G] -> S = min(512,
    P + G) slots per view, the sampled ones first (stable)."""
    boxes = torch.cat([proposals.float(), gt_boxes.float()], dim=1)
    valid = torch.cat([proposal_valid, gt_valid], dim=1)
    a = max_iou_assign(boxes, gt_boxes, gt_valid, 0.5, 0.5, 0.5)
    pos_sel, neg_sel = random_sample(a.is_pos & valid, a.is_neg & valid,
                                     num_sample, pos_fraction, u_pos, u_neg)
    sampled = pos_sel | neg_sel
    order = torch.argsort((~sampled).to(torch.uint8), dim=-1,
                          stable=True)[:, :num_sample]
    sel_boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    sel_pos = torch.gather(pos_sel, 1, order)
    sel_gt = torch.gather(a.assigned_gt, 1, order)
    gt_sel = _gather_rows(gt_boxes.float(), sel_gt)
    labels = torch.where(sel_pos, torch.gather(
        gt_labels.long(), 1, sel_gt.clamp(0, gt_boxes.shape[1] - 1)),
        torch.full_like(sel_gt, num_classes))
    reg = bbox2delta(sel_boxes, gt_sel, stds=(0.1, 0.1, 0.2, 0.2))
    return RCNNSamples(sel_boxes, labels, torch.nan_to_num(reg), sel_pos,
                       torch.gather(sampled, 1, order).float())


def rcnn_loss(cls_logits: torch.Tensor, reg_deltas: torch.Tensor,
              samples: RCNNSamples, num_classes: int = 10
              ) -> Dict[str, torch.Tensor]:
    """cls_logits [V*S, K+1], reg_deltas [V*S, 4K] (class-specific),
    samples over the same V*S slots."""
    weight = samples.weight.reshape(-1)
    labels = samples.labels.reshape(-1)
    avg = weight.sum()
    loss_cls = softmax_cross_entropy(cls_logits, labels, weight, avg)
    d = reg_deltas.reshape(-1, num_classes, 4)
    safe = labels.clamp(0, num_classes - 1)
    d_sel = d.gather(1, safe[:, None, None].expand(-1, 1, 4))[:, 0]
    w = (samples.is_pos.reshape(-1).float() * weight)[:, None]
    loss_bbox = weighted_l1_loss(d_sel, samples.reg_targets.reshape(-1, 4),
                                 w, avg)
    return {'loss_cls': loss_cls, 'loss_bbox': loss_bbox,
            'rcnn_num_pos': samples.is_pos.sum()}
