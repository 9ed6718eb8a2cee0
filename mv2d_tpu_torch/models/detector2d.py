"""The 2D detectors: two-stage (Faster R-CNN) and single-stage
(RetinaNet).

Port of `mv2d_tpu/models/detector2d.py` with mmdet keys (backbone, neck,
rpn_head, roi_head.bbox_head; bbox_head for the single-stage head).  The
backbone is a ResNet or a VoVNet (`backbone_type`); the FPN takes its
stage widths.  The R-CNN RoIAlign runs
through `ops.roi_align.roi_align_multilevel` (kernel K3 on CUDA) in the
natural [V, P] slot order; the training RoIs through its differentiable
form `roi_align_multilevel_train` (K3 forward, B9 backward).  With
`Routes.align_v2` (the JAX package's MV2D_ALIGN_V2=1) both go through the
slab kernel B11 instead (`roi_align_slab`; B11 forward, B9 backward).
`roi_forward` takes flat RoIs with a view index through kernel B12
(`roi_align_flat`), as the JAX package's `roi_forward` takes its Pallas
patch kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn as tnn

from ..configs import DetectionProposalCfg
from ..core.nms import multiclass_nms_2d
from ..nn.fpn import FPN
from ..nn.rcnn import Shared2FCBBoxHead, decode_detections
from ..nn.resnet import ResNet
from ..nn.retina import RetinaHead, single_stage_detections
from ..nn.rpn import RPNHead, rpn_proposals
from ..nn.vovnet import VoVNet
from ..ops.roi_align import (roi_align_flat, roi_align_multilevel,
                             roi_align_multilevel_train, roi_align_slab)
from ..routes import Routes


class Proposals(NamedTuple):
    boxes: torch.Tensor     # [V, P, 4] (x1, y1, x2, y2) image pixels
    scores: torch.Tensor    # [V, P]
    labels: torch.Tensor    # [V, P]
    valid: torch.Tensor     # [V, P] bool


class _RoIHead(tnn.Module):
    def __init__(self, bbox_head: Shared2FCBBoxHead):
        super().__init__()
        self.bbox_head = bbox_head


def make_backbone(backbone_type: str, depth: int,
                  stage_with_dcn: Tuple[bool, ...], routes: Routes,
                  frozen_stages: int = 1, remat: bool = False):
    """A ResNet (its `out_channels` 256..2048) or a VoVNet (256..1024).
    frozen_stages and remat go to the ResNet; the VoVNet takes neither
    (the JAX package's detectors give it none)."""
    if backbone_type == 'vovnet':
        return VoVNet(depth)
    if backbone_type != 'resnet':
        raise ValueError(f'backbone_type {backbone_type!r}')
    return ResNet(depth, stage_with_dcn, routes, frozen_stages,
                  remat=remat)


class SingleStageDetector(tnn.Module):
    """Backbone + FPN p2..p6 + RetinaHead, decoding into the padded
    `Proposals` the 3D head takes."""
    fpn_strides = (4, 8, 16, 32, 64)

    def __init__(self, depth: int = 50, num_classes: int = 10,
                 backbone_type: str = 'resnet',
                 stage_with_dcn: Tuple[bool, ...] = (False,) * 4,
                 fpn_channels: int = 256, routes: Routes = Routes(),
                 frozen_stages: int = 1, remat: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = make_backbone(backbone_type, depth, stage_with_dcn,
                                      routes, frozen_stages, remat)
        self.neck = FPN(self.backbone.out_channels, fpn_channels,
                        num_outs=5)
        self.bbox_head = RetinaHead(num_classes, fpn_channels)

    def extract_feat(self, imgs: torch.Tensor):
        """[V, H, W, 3] -> FPN levels p2..p6, channels-last."""
        return self.neck(self.backbone(imgs))

    def detect(self, feats: Sequence[torch.Tensor],
               image_shape: Tuple[int, int],
               cfg: DetectionProposalCfg) -> Proposals:
        scores, deltas = self.bbox_head(feats)
        b, s, l, v = single_stage_detections(
            scores, deltas, self.fpn_strides, image_shape, self.num_classes,
            score_thr=cfg.score_thr, nms_pre=cfg.nms_pre,
            iou_threshold=cfg.iou_threshold, max_per_img=cfg.max_per_img,
            min_bbox_size=cfg.min_bbox_size)
        return Proposals(boxes=b, scores=s, labels=l, valid=v)


class TwoStageDetector(tnn.Module):
    fpn_strides = (4, 8, 16, 32, 64)

    def __init__(self, depth: int = 50, num_classes: int = 10,
                 backbone_type: str = 'resnet',
                 stage_with_dcn: Tuple[bool, ...] = (False,) * 4,
                 fpn_channels: int = 256, rcnn_fc_channels: int = 1024,
                 routes: Routes = Routes(), frozen_stages: int = 1,
                 remat: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.align_v2 = routes.align_v2
        self.backbone = make_backbone(backbone_type, depth, stage_with_dcn,
                                      routes, frozen_stages, remat)
        self.neck = FPN(self.backbone.out_channels, fpn_channels,
                        num_outs=5)
        self.rpn_head = RPNHead(fpn_channels)
        self.roi_head = _RoIHead(Shared2FCBBoxHead(
            fpn_channels, rcnn_fc_channels, num_classes))

    def extract_feat(self, imgs: torch.Tensor):
        """[V, H, W, 3] -> FPN levels p2..p6, channels-last."""
        return self.neck(self.backbone(imgs))

    def rpn(self, feats, image_shape, cfg: DetectionProposalCfg):
        scores, deltas = self.rpn_head(feats)
        return rpn_proposals(scores, deltas, self.fpn_strides, image_shape,
                             nms_pre=cfg.rpn_nms_pre,
                             max_per_img=cfg.rpn_max_per_img,
                             iou_threshold=cfg.rpn_iou_threshold)

    def roi_forward(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                    view_idx: torch.Tensor):
        """R-CNN head on flat RoIs [N, 4] (image pixels) of views view_idx
        [N] -> ([N, K+1], [N, 4K]), with mmcv's adaptive sampling
        (sampling_ratio 0).  The RoIAlign is kernel B12 on CUDA tensors,
        with no gradient (the JAX kernel's zero tangents); its plain
        version on the CPU."""
        roi_feats = roi_align_flat(list(feats[:4]), rois, view_idx,
                                   self.fpn_strides[:4], sampling_ratio=0)
        return self.roi_head.bbox_head(roi_feats)

    def roi_forward_views(self, feats: Sequence[torch.Tensor],
                          rois: torch.Tensor):
        """R-CNN head on sampled training RoIs [V, S, 4] with gradients to
        the first V views' features -> ([V*S, K+1], [V*S, 4K])."""
        V, S = rois.shape[:2]
        roi_feats = roi_align_multilevel_train(
            [f[:V] for f in feats[:4]], rois, self.fpn_strides[:4],
            slab=self.align_v2)
        return self.roi_head.bbox_head(
            roi_feats.reshape(V * S, *roi_feats.shape[2:]))

    def rcnn(self, feats: Sequence[torch.Tensor], prop_boxes: torch.Tensor):
        """RoIAlign (K3, or B11 under align_v2) -> Shared2FC of the
        proposals [V, P, 4] -> (cls_logits [V, P, K+1], deltas [V, P, 4K])."""
        V, Rp = prop_boxes.shape[:2]
        align = roi_align_slab if self.align_v2 else roi_align_multilevel
        roi_feats = align(list(feats[:4]), prop_boxes, self.fpn_strides[:4])
        cls_logits, deltas = self.roi_head.bbox_head(
            roi_feats.reshape(V * Rp, *roi_feats.shape[2:]))
        return cls_logits.reshape(V, Rp, -1), deltas.reshape(V, Rp, -1)

    def detections(self, prop_boxes, prop_valid, cls_logits, deltas,
                   image_shape: Tuple[int, int],
                   cfg: DetectionProposalCfg) -> Proposals:
        """Per-class decode -> multiclass NMS: padded per-view
        detections."""
        boxes, scores = decode_detections(prop_boxes, cls_logits, deltas,
                                          image_shape, self.num_classes)
        b, s, l, v = multiclass_nms_2d(
            boxes, scores, prop_valid, cfg.score_thr, cfg.iou_threshold,
            cfg.nms_pre, cfg.max_per_img, min_bbox_size=cfg.min_bbox_size)
        return Proposals(boxes=b, scores=s, labels=l, valid=v)

    def detect(self, feats: Sequence[torch.Tensor],
               image_shape: Tuple[int, int],
               cfg: DetectionProposalCfg) -> Proposals:
        """RPN -> RoIAlign -> Shared2FC -> per-class decode -> multiclass
        NMS: padded per-view detections."""
        prop_boxes, _, prop_valid = self.rpn(feats, image_shape, cfg)
        cls_logits, deltas = self.rcnn(feats, prop_boxes)
        return self.detections(prop_boxes, prop_valid, cls_logits, deltas,
                               image_shape, cfg)
