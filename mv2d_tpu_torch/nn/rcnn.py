"""Second-stage R-CNN box head (mmdet Shared2FCBBoxHead) and decoding.

Port of `mv2d_tpu/nn/rcnn.py`.  The head flattens RoI features in mmdet's
(C, 7, 7) order, so reference weights load unchanged.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as tnn
import torch.nn.functional as F

from .layers import linear
from .rpn import delta2bbox


class Shared2FCBBoxHead(tnn.Module):
    def __init__(self, in_channels: int = 256, fc_out_channels: int = 1024,
                 num_classes: int = 10, roi_size: int = 7,
                 reg_class_agnostic: bool = False):
        super().__init__()
        self.shared_fcs = tnn.ModuleList([
            tnn.Linear(in_channels * roi_size * roi_size, fc_out_channels),
            tnn.Linear(fc_out_channels, fc_out_channels)])
        self.fc_cls = tnn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = tnn.Linear(
            fc_out_channels, 4 if reg_class_agnostic else 4 * num_classes)

    def forward(self, roi_feats: torch.Tensor):
        """roi_feats [R, 7, 7, C] -> (cls_logits [R, K+1], deltas [R, 4K],
        or [R, 4] when class-agnostic)."""
        x = roi_feats.permute(0, 3, 1, 2).flatten(1)
        for fc in self.shared_fcs:
            x = F.relu(linear(x, fc))
        return self.fc_cls(x), self.fc_reg(x)


def decode_detections(proposals: torch.Tensor, cls_logits: torch.Tensor,
                      deltas: torch.Tensor, image_shape: Tuple[int, int],
                      num_classes: int = 10):
    """proposals [..., R, 4], cls_logits [..., R, K+1], deltas [..., R, 4K]
    -> (boxes [..., R, K, 4], scores [..., R, K]), background dropped."""
    scores = torch.softmax(cls_logits, dim=-1)[..., :num_classes]
    d = deltas.reshape(*deltas.shape[:-1], num_classes, 4)
    boxes = delta2bbox(proposals[..., None, :], d, max_shape=image_shape,
                       stds=(0.1, 0.1, 0.2, 0.2))
    return boxes, scores
