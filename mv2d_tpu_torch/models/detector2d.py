"""Two-stage 2D detector (Faster R-CNN).

Port of `mv2d_tpu/models/detector2d.py:TwoStageDetector` with mmdet keys
(backbone, neck, rpn_head, roi_head.bbox_head).  The R-CNN RoIAlign runs
through `ops.roi_align.roi_align_multilevel` (kernel K3 on CUDA) in the
natural [V, P] slot order; the training RoIs through its differentiable
form `roi_align_multilevel_train` (K3 forward, B9 backward).
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
from ..nn.rpn import RPNHead, rpn_proposals
from ..ops.roi_align import (roi_align_multilevel,
                             roi_align_multilevel_train)
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


class TwoStageDetector(tnn.Module):
    fpn_strides = (4, 8, 16, 32, 64)

    def __init__(self, depth: int = 50, num_classes: int = 10,
                 stage_with_dcn: Tuple[bool, ...] = (False,) * 4,
                 fpn_channels: int = 256, rcnn_fc_channels: int = 1024,
                 routes: Routes = Routes()):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNet(depth, stage_with_dcn, routes)
        self.neck = FPN([256, 512, 1024, 2048], fpn_channels, num_outs=5)
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

    def roi_forward_views(self, feats: Sequence[torch.Tensor],
                          rois: torch.Tensor):
        """R-CNN head on sampled training RoIs [V, S, 4] with gradients to
        the first V views' features -> ([V*S, K+1], [V*S, 4K])."""
        V, S = rois.shape[:2]
        roi_feats = roi_align_multilevel_train(
            [f[:V] for f in feats[:4]], rois, self.fpn_strides[:4])
        return self.roi_head.bbox_head(
            roi_feats.reshape(V * S, *roi_feats.shape[2:]))

    def detect(self, feats: Sequence[torch.Tensor],
               image_shape: Tuple[int, int],
               cfg: DetectionProposalCfg) -> Proposals:
        """RPN -> RoIAlign -> Shared2FC -> per-class decode -> multiclass
        NMS: padded per-view detections."""
        V = feats[0].shape[0]
        prop_boxes, _, prop_valid = self.rpn(feats, image_shape, cfg)
        Rp = prop_boxes.shape[1]
        roi_feats = roi_align_multilevel(list(feats[:4]), prop_boxes,
                                         self.fpn_strides[:4])
        cls_logits, deltas = self.roi_head.bbox_head(
            roi_feats.reshape(V * Rp, *roi_feats.shape[2:]))
        boxes, scores = decode_detections(
            prop_boxes, cls_logits.reshape(V, Rp, -1),
            deltas.reshape(V, Rp, -1), image_shape, self.num_classes)
        b, s, l, v = multiclass_nms_2d(
            boxes, scores, prop_valid, cfg.score_thr, cfg.iou_threshold,
            cfg.nms_pre, cfg.max_per_img, min_bbox_size=cfg.min_bbox_size)
        return Proposals(boxes=b, scores=s, labels=l, valid=v)
