"""One scene's MV2D training losses.

Port of `mv2d_tpu/train/train_step.py` (`compute_losses`): grid mask,
backbone and FPN, the 2D losses on the current frame's views (RPN and
R-CNN, or the single-stage detector's focal and L1 losses), detections
without gradients plus missed GT, the 3D head with DN, and per-layer
Hungarian matching on the host.  The step that combines
scenes' losses and updates the model is `parallel.dist.dp_train_step`,
on one GPU as on many.  Mixed precision is the JAX package's: float32 master parameters,
a bfloat16 forward through bfloat16 copies of them (their gradients reach
the masters through the casts), losses in float32.

Every random number of a step is drawn up front into `TrainDraws` (grid
mask, DN noise, the samplers' uniform keys) or, for dropout, from the
step's generator, so a test can pin them all.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as tnn

from ..configs import MV2DConfig
from ..core.geometry import CameraParams
from ..models.mv2d import MV2D, GroundTruth2D, GroundTruth3D
from ..nn.decoder import NO_DROPOUT, Dropout
from ..nn.retina import level_anchors
from ..nn.rpn import grid_anchors, rpn_proposals
from ..ops.grid_mask import GridMaskDraws, draw_grid_mask
from ..utils.profiling import counters, span
from . import detector2d_loss as d2l
from .losses import mv2d_head_loss


class TrainBatch(NamedTuple):
    """One scene (the reference trains one scene per device)."""
    imgs: torch.Tensor          # [V, H, W, 3] normalized
    cam: CameraParams
    img_shapes: torch.Tensor    # [V, 2]
    gt2d: GroundTruth2D
    gt3d: GroundTruth3D


class TrainDraws(NamedTuple):
    grid: GridMaskDraws
    dn_noise: torch.Tensor      # [denoise_scalar * max_gt, 3] U(-1, 1)
    rpn_u: torch.Tensor         # [2, Vc, anchors] U(0, 1): pos, neg keys
    rcnn_u: torch.Tensor        # [2, Vc, rpn_max_per_img + G2]


def all_anchors(cfg: MV2DConfig) -> torch.Tensor:
    """Every anchor [N, 4] of the 2D detector's dense head (the RPN's,
    or the single-stage detector's RetinaHead's) in the flattened score
    order."""
    H, W = cfg.image_size
    level = level_anchors if cfg.detector_type == 'single_stage' \
        else grid_anchors
    return torch.from_numpy(np.concatenate(
        [level((-(-H // s), -(-W // s)), s) for s in (4, 8, 16, 32, 64)]))


def current_views(cfg: MV2DConfig) -> int:
    """Views the 2D losses see: the current frame's."""
    return cfg.num_views if cfg.num_frames > 1 else cfg.total_views


def step_generator(seed: int, step: int, scene: int = 0,
                   device='cuda') -> torch.Generator:
    """The generator of a step's draws for one scene: seeded from (seed,
    global step, the scene's index in the global batch), so a resumed run
    and a run on any number of ranks draw what an uninterrupted one-rank
    run draws."""
    key = np.random.SeedSequence([seed, step, scene]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(key))


def draw_train(cfg: MV2DConfig, num_gt2d: int,
               generator: torch.Generator) -> TrainDraws:
    """A step's draws, on the generator's device."""
    g = generator
    dev = g.device
    Vc = current_views(cfg)
    grid = draw_grid_mask(cfg.total_views, cfg.image_size, g)
    n_anchor = all_anchors(cfg).shape[0]
    n_rcnn = cfg.proposal_train.rpn_max_per_img + num_gt2d
    return TrainDraws(
        grid=grid,
        dn_noise=torch.rand(cfg.dn_pad, 3, generator=g, device=dev) * 2 - 1,
        rpn_u=torch.rand(2, Vc, n_anchor, generator=g, device=dev),
        rcnn_u=torch.rand(2, Vc, n_rcnn, generator=g, device=dev))


def compute_losses(model: MV2D, batch: TrainBatch, draws: TrainDraws,
                   drop: Dropout = NO_DROPOUT):
    """(total, metrics, deferred) of one scene, in float32: the 3D bbox
    losses are left out of `total` and `metrics` and come back as
    deferred[key] = (weighted sum, num_pos) (`mv2d_head_loss` with
    sync_bbox_norm), for the step to normalise over its batch."""
    cfg = model.cfg
    with span('forward'):
        out, det = model.forward_train(
            batch.imgs, batch.cam, batch.img_shapes, batch.gt2d, batch.gt3d,
            draws.grid, draws.dn_noise, drop)
    with span('head_loss'):
        losses, deferred = mv2d_head_loss(out, batch.gt3d, cfg,
                                          sync_bbox_norm=True)
    with span('det_loss'):
        total, metrics = _detector_losses(model, batch, draws, det, losses)
    metrics['num_queries'] = out.query_valid.sum()
    if cfg.detector_type == 'single_stage':
        return total, metrics, deferred
    # the pixel key mode's bucket accounting (the roi key mode has none)
    for k in ('key_active', 'key_overflow'):
        if k in out.diagnostics:
            metrics[k] = out.diagnostics[k]
    return total, metrics, deferred


def _detector_losses(model: MV2D, batch: TrainBatch, draws: TrainDraws,
                     det: dict, losses: dict):
    """The 2D detector's losses (RPN and R-CNN with their proposals and
    sampling, or the single-stage detector's), added to `losses` ->
    (total, metrics)."""
    cfg = model.cfg
    Vc = current_views(cfg)
    gt2d = batch.gt2d
    if cfg.detector_type == 'single_stage':
        return _single_stage_losses(cfg, det, gt2d, losses, Vc)
    # RPN losses on the current frame's views
    counters['sync.train_step.anchors'] += 1
    anchors = all_anchors(cfg).to(batch.imgs.device)
    flat_scores = torch.cat([s.reshape(s.shape[0], -1)
                             for s in det['rpn_scores']], 1)
    flat_deltas = torch.cat([d.reshape(d.shape[0], -1, 4)
                             for d in det['rpn_deltas']], 1)
    rpn = d2l.rpn_loss(flat_scores, flat_deltas, anchors, gt2d.boxes[:Vc],
                       gt2d.valid[:Vc], draws.rpn_u[0], draws.rpn_u[1])
    losses['det_loss_rpn_cls'] = rpn['loss_rpn_cls'].mean()
    losses['det_loss_rpn_bbox'] = rpn['loss_rpn_bbox'].mean()

    # R-CNN losses on sampled RoIs (train RPN settings: nms_pre 2000)
    with torch.no_grad():
        rp_boxes, _, rp_valid = rpn_proposals(
            [s.detach() for s in det['rpn_scores']],
            [d.detach() for d in det['rpn_deltas']], (4, 8, 16, 32, 64),
            cfg.image_size, nms_pre=min(2000, flat_scores.shape[1]),
            max_per_img=cfg.proposal_train.rpn_max_per_img,
            iou_threshold=0.7)
        samples = d2l.rcnn_sample(rp_boxes, rp_valid, gt2d.boxes[:Vc],
                                  gt2d.labels[:Vc], gt2d.valid[:Vc],
                                  draws.rcnn_u[0], draws.rcnn_u[1],
                                  cfg.num_classes)
    cls_logits, reg_deltas = model.rcnn_train_forward(det['fpn_feats'],
                                                      samples.rois)
    rcnn = d2l.rcnn_loss(cls_logits, reg_deltas, samples, cfg.num_classes)
    losses['det_loss_cls'] = rcnn['loss_cls']
    losses['det_loss_bbox'] = rcnn['loss_bbox']

    total = sum(v for k, v in losses.items() if 'loss' in k)
    metrics = dict(losses)
    metrics['rpn_num_pos'] = rpn['rpn_num_pos'].sum()
    metrics['rcnn_num_pos'] = rcnn['rcnn_num_pos']
    return total, metrics


def _single_stage_losses(cfg: MV2DConfig, det: dict, gt2d: GroundTruth2D,
                         losses: dict, Vc: int):
    """The single-stage detector's focal and L1 losses of each current
    view, averaged over the views, added to `losses` -> (total, metrics
    with det_num_pos, the positive anchors of all views)."""
    K = cfg.num_classes
    anchors = all_anchors(cfg).to(det['rpn_scores'][0].device)
    scores = torch.cat([s.reshape(s.shape[0], -1, K)
                        for s in det['rpn_scores']], 1)
    deltas = torch.cat([d.reshape(d.shape[0], -1, 4)
                        for d in det['rpn_deltas']], 1)
    ss = [d2l.single_stage_loss(scores[v], deltas[v], anchors,
                                gt2d.boxes[v], gt2d.labels[v],
                                gt2d.valid[v], K) for v in range(Vc)]
    losses['det_loss_cls'] = torch.stack([x['loss_cls'] for x in ss]).mean()
    losses['det_loss_bbox'] = torch.stack([x['loss_bbox']
                                           for x in ss]).mean()
    total = sum(v for k, v in losses.items() if 'loss' in k)
    metrics = dict(losses)
    metrics['det_num_pos'] = sum(x['num_pos'] for x in ss)
    return total, metrics


class _LossModule(tnn.Module):
    """Wraps compute_losses so torch.func.functional_call can run it on
    substituted (bfloat16) parameters."""

    def __init__(self, model: MV2D):
        super().__init__()
        self.model = model

    def forward(self, batch, draws, drop):
        return compute_losses(self.model, batch, draws, drop)


def bf16_call(module: tnn.Module, batch: TrainBatch, *args):
    """module(batch, *args) through bfloat16 copies of module's float32
    parameters and of the batch's images, so that the gradients reach the
    float32 masters through the casts: the mixed precision of a step."""
    params = {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
              for n, p in module.named_parameters()}
    batch = batch._replace(imgs=batch.imgs.to(torch.bfloat16))
    return torch.func.functional_call(module, params, (batch, *args),
                                      strict=False)


def step_losses(model: MV2D, batch: TrainBatch, draws: TrainDraws,
                drop: Dropout = NO_DROPOUT, mixed_precision: bool = True):
    """compute_losses; mixed_precision runs the forward in bfloat16
    (`bf16_call`)."""
    if not mixed_precision:
        return compute_losses(model, batch, draws, drop)
    return bf16_call(_LossModule(model), batch, draws, drop)
