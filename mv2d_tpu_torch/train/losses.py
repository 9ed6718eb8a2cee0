"""3D head training losses: per-layer Hungarian matching, focal / L1, DN.

Port of `mv2d_tpu/train/losses.py` (the reference's
CrossAttentionBoxHead.loss_single / dn_loss_single with per-layer stage
weights).  Padded queries and GT carry zero weights.  The bbox losses
divide by the scene's own num_pos (num_tgt for DN); with `sync_bbox_norm`
they come back unnormalised, with their num_pos, for the data-parallel
step to divide by the mean num_pos over every scene of every rank (the
reference's cross-GPU `reduce_mean`).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from ..core import matching
from ..core.boxes import bottom_to_gravity, normalize_bbox
from ..ops.focal_loss import sigmoid_focal_loss, weighted_l1_loss
from ..utils.profiling import counters

CODE_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.5, 1.5, 2.0, 2.0)


class LayerLoss(NamedTuple):
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor
    num_pos: torch.Tensor


def layer_losses(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                 query_valid: torch.Tensor, gt_code: torch.Tensor,
                 gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                 num_classes: int,
                 code_weights: Sequence[float] = CODE_WEIGHTS,
                 bbox_avg_factor: Optional[float] = None) -> LayerLoss:
    """Matching losses of every decoder layer: cls_scores [L, Q, C],
    bbox_preds [L, Q, 10], gt_code [G, 10] normalized gravity-center
    codes -> per-layer [L] losses and num_pos.  The L assignments share
    one host copy of their costs.  The bbox losses divide by
    `bbox_avg_factor` where given, else by each layer's num_pos."""
    cost = matching.match_cost(cls_scores, bbox_preds, gt_code, gt_labels)
    assigned, pos = matching.hungarian_assign(cost, query_valid, gt_valid)
    counters['sync.losses.code_weights'] += 1
    cw = bbox_preds.new_tensor(code_weights).float()
    out = []
    for lvl in range(cls_scores.shape[0]):
        p = pos[lvl]
        num_pos = p.sum().float()
        safe = assigned[lvl].clamp(0, gt_code.shape[0] - 1)
        labels = torch.where(p, gt_labels.long()[safe],
                             torch.full_like(safe, num_classes))
        targets = torch.where(p[:, None], gt_code[safe],
                              torch.zeros_like(gt_code[safe]))
        loss_cls = sigmoid_focal_loss(cls_scores[lvl], labels,
                                      query_valid.float(), num_classes,
                                      avg_factor=num_pos, loss_weight=2.0)
        notnan = torch.isfinite(targets).all(-1, keepdim=True)
        loss_bbox = weighted_l1_loss(
            bbox_preds[lvl], torch.nan_to_num(targets),
            p[:, None].float() * cw * notnan,
            avg_factor=num_pos if bbox_avg_factor is None
            else bbox_avg_factor, loss_weight=0.25)
        out.append((torch.nan_to_num(loss_cls), torch.nan_to_num(loss_bbox),
                    num_pos))
    return LayerLoss(*(torch.stack(x) for x in zip(*out)))


def dn_layer_loss(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                  dn, cfg, code_weights: Sequence[float] = CODE_WEIGHTS,
                  bbox_avg_factor: Optional[float] = None) -> LayerLoss:
    """Denoising loss of one layer (the reference's dn_loss_single):
    cls_scores [DN_PAD, C], bbox_preds [DN_PAD, 10], dn a DNInfo.  The
    bbox loss divides by `bbox_avg_factor` where given, else by
    max(num_tgt, 1)."""
    num_tgt = (cfg.denoise_scalar * dn.num_gt).float()
    cls_avg = num_tgt * 3.14159 / 6 * cfg.denoise_split ** 3
    loss_cls = sigmoid_focal_loss(cls_scores, dn.known_labels,
                                  dn.valid.float(), cfg.num_classes,
                                  avg_factor=cls_avg.clamp(min=1.0),
                                  loss_weight=2.0)
    targets = normalize_bbox(dn.known_boxes.float())
    counters['sync.losses.code_weights'] += 1
    w = bbox_preds.new_tensor(code_weights).float().expand(
        bbox_preds.shape[0], -1) * dn.valid[:, None].float()
    # DN leaves the yaw terms out (the reference: "dn always reduces mAOE")
    w = torch.cat([w[:, :6], torch.zeros_like(w[:, 6:8]), w[:, 8:]], -1)
    notnan = torch.isfinite(targets).all(-1, keepdim=True)
    loss_bbox = weighted_l1_loss(bbox_preds, torch.nan_to_num(targets),
                                 w * notnan,
                                 avg_factor=num_tgt.clamp(min=1.0)
                                 if bbox_avg_factor is None
                                 else bbox_avg_factor, loss_weight=0.25)
    return LayerLoss(torch.nan_to_num(loss_cls), torch.nan_to_num(loss_bbox),
                     num_tgt)


def mv2d_head_loss(out, gt, cfg, sync_bbox_norm: bool = False):
    """Stage-weighted 3D losses of one scene: `out` the head's outputs
    (HeadOutputs with DN), `gt` a GroundTruth3D ->
    {l{i}.loss_cls, l{i}.loss_bbox, l{i}.dn_loss_cls, l{i}.dn_loss_bbox}.

    With sync_bbox_norm -> (losses, deferred): the bbox losses leave
    `losses` for `deferred[key] = (weighted sum, num_pos)`, the sum not
    divided by num_pos (num_tgt for DN), so that the caller divides the
    mean sum by the mean num_pos over the global batch, clamped at 1
    (E[l] / E[n], not E[l / n])."""
    gt_code = normalize_bbox(bottom_to_gravity(gt.boxes.float()))
    avg = 1.0 if sync_bbox_norm else None
    ll = layer_losses(out.all_cls_scores, out.all_bbox_preds,
                      out.query_valid, gt_code, gt.labels, gt.valid,
                      cfg.num_classes, bbox_avg_factor=avg)
    losses: Dict[str, torch.Tensor] = {}
    deferred: Dict[str, tuple] = {}

    def bbox(key, loss, num_pos):
        if sync_bbox_norm:
            deferred[key] = (loss, num_pos)
        else:
            losses[key] = loss

    for lvl in range(out.all_cls_scores.shape[0]):
        lw = cfg.stage_loss_weights[lvl]
        losses[f'l{lvl}.loss_cls'] = ll.loss_cls[lvl] * lw
        bbox(f'l{lvl}.loss_bbox', ll.loss_bbox[lvl] * lw, ll.num_pos[lvl])
        if out.dn_cls_scores is not None:
            dl = dn_layer_loss(out.dn_cls_scores[lvl],
                               out.dn_bbox_preds[lvl], out.dn_info, cfg,
                               bbox_avg_factor=avg)
            losses[f'l{lvl}.dn_loss_cls'] = dl.loss_cls * lw
            bbox(f'l{lvl}.dn_loss_bbox', dl.loss_bbox * lw, dl.num_pos)
    if sync_bbox_norm:
        return losses, deferred
    return losses
