"""RetinaNet-style single-stage detection head (channels-last).

Port of `mv2d_tpu/nn/retina.py`: mmdet RetinaHead semantics, four 3x3
conv + relu layers in each of the cls and reg towers, shared across the
FPN levels, then 3x3 convs to A x K class logits (bias -log(99), the
focal prior p 0.01) and A x 4 box deltas, A = 3 scales x 3 ratios = 9
anchors; and the decode of its outputs into padded per-view
detections.

Parameter names are mmdet RetinaHead's, under the base detector's
`bbox_head`: cls_convs.{i}.conv.*, reg_convs.{i}.conv.*, retina_cls.*,
retina_reg.* (the JAX package's converter has no table for this head;
`weights.state_dict_from_jax` maps its cls_conv{i} / reg_conv{i} /
retina_cls / retina_reg leaves onto these names).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as tnn
import torch.nn.functional as F

from ..core.nms import _take, multiclass_nms_2d, topk
from .fpn import ConvModule
from .layers import conv2d_nhwc
from .rpn import delta2bbox, grid_anchors


def retina_scales(octave_base_scale: float = 4.0,
                  scales_per_octave: int = 3) -> Tuple[float, ...]:
    """mmdet RetinaNet anchor scales: base * 2^(i/n)."""
    return tuple(octave_base_scale * 2 ** (i / scales_per_octave)
                 for i in range(scales_per_octave))


class RetinaHead(tnn.Module):
    def __init__(self, num_classes: int = 10, feat_channels: int = 256,
                 num_anchors: int = 9, stacked_convs: int = 4,
                 prior_prob: float = 0.01):
        super().__init__()
        C = feat_channels
        self.cls_convs = tnn.ModuleList(
            [ConvModule(C, C, 3, 1) for _ in range(stacked_convs)])
        self.reg_convs = tnn.ModuleList(
            [ConvModule(C, C, 3, 1) for _ in range(stacked_convs)])
        self.retina_cls = tnn.Conv2d(C, num_anchors * num_classes, 3,
                                     padding=1)
        self.retina_reg = tnn.Conv2d(C, num_anchors * 4, 3, padding=1)
        tnn.init.constant_(self.retina_cls.bias,
                           float(-np.log((1 - prior_prob) / prior_prob)))

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats [V, H, W, C] per level -> (scores [V, H, W, A*K],
        deltas [V, H, W, A*4]) per level."""
        scores, deltas = [], []
        for f in feats:
            c = r = f
            for conv in self.cls_convs:
                c = F.relu(conv(c))
            for conv in self.reg_convs:
                r = F.relu(conv(r))
            scores.append(conv2d_nhwc(c, self.retina_cls.weight,
                                      self.retina_cls.bias, 1, 1))
            deltas.append(conv2d_nhwc(r, self.retina_reg.weight,
                                      self.retina_reg.bias, 1, 1))
        return scores, deltas


def level_anchors(feat_shape: Tuple[int, int], stride: int) -> np.ndarray:
    """The head's anchors of one level [H*W*9, 4] in its output order."""
    return grid_anchors(feat_shape, stride, retina_scales())


def single_stage_detections(scores: List[torch.Tensor],
                            deltas: List[torch.Tensor],
                            strides: Sequence[int],
                            image_shape: Tuple[int, int], num_classes: int,
                            score_thr: float = 0.05, nms_pre: int = 1000,
                            iou_threshold: float = 0.6,
                            max_per_img: int = 75,
                            min_bbox_size: float = 0.0):
    """The head's outputs -> per-view padded detections (boxes [V, P, 4],
    scores, labels, valid [V, P]).  Per level: the nms_pre anchors of the
    highest class score (ties to the lower index, as lax.top_k) ->
    delta decode; then class-agnostic multiclass NMS over the levels'
    union, every class sharing its anchor's box.  Boxes and scores in
    float32."""
    V = scores[0].shape[0]
    K = num_classes
    dev = scores[0].device
    lvl_boxes, lvl_scores = [], []
    for s, d, stride in zip(scores, deltas, strides):
        H, W = s.shape[1], s.shape[2]
        anchors = torch.from_numpy(level_anchors((H, W), stride)).to(dev)
        s = s.float().reshape(V, -1, K)                    # [V, HWA, K]
        d = d.float().reshape(V, -1, 4)
        _, top_i = topk(s.amax(-1), min(nms_pre, s.shape[1]))
        lvl_boxes.append(delta2bbox(anchors[top_i], _take(d, top_i),
                                    max_shape=image_shape))
        lvl_scores.append(_take(s, top_i))
    boxes = torch.cat(lvl_boxes, 1)                        # [V, N, 4]
    probs = torch.sigmoid(torch.cat(lvl_scores, 1))
    wh = boxes[..., 2:4] - boxes[..., 0:2]
    valid = (wh > min_bbox_size).all(-1)
    per_class = boxes[:, :, None, :].expand(-1, -1, K, -1)
    return multiclass_nms_2d(per_class, probs, valid, score_thr,
                             iou_threshold, nms_pre, max_per_img,
                             min_bbox_size=min_bbox_size)
