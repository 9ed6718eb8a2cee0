"""RPN head, anchors and fixed-shape proposal decoding.

Port of `mv2d_tpu/nn/rpn.py` (mmdet RPNHead / AnchorGenerator /
DeltaXYWHBBoxCoder: scales [8], ratios [0.5, 1, 2], strides 4..64).
Per level: top nms_pre by score -> decode -> clip; NMS per (view, level);
the kept sets merge by one top-k over the masked scores.  Top-k is exact.
The constants made on the host (each level's anchors, the coder's stds,
the level sizes) are built once per shape, dtype and device and kept
there (`_constant`), so a call after the first copies nothing to the
device and waits on nothing: a CUDA graph can hold it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as tnn
import torch.nn.functional as F

from ..core.nms import _NEG, _take, nms_sorted_keep, topk
from ..utils.profiling import counters
from .layers import conv1x1, conv2d_nhwc


def base_anchors(stride: int, scales=(8,), ratios=(0.5, 1.0, 2.0)
                 ) -> np.ndarray:
    out = []
    for r in ratios:
        for s in scales:
            h = stride * s * np.sqrt(r)
            w = stride * s / np.sqrt(r)
            out.append([-w / 2, -h / 2, w / 2, h / 2])
    return np.asarray(out, dtype=np.float32)


def grid_anchors(feat_shape: Tuple[int, int], stride: int, scales=(8,),
                 ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """All anchors of one level: [H*W*A, 4], row-major over (y, x, a)."""
    H, W = feat_shape
    base = base_anchors(stride, scales, ratios)
    xs = np.arange(W, dtype=np.float32) * stride
    ys = np.arange(H, dtype=np.float32) * stride
    shift_x, shift_y = np.meshgrid(xs, ys)
    shifts = np.stack([shift_x, shift_y, shift_x, shift_y], -1).reshape(-1, 4)
    return (shifts[:, None] + base[None]).reshape(-1, 4)


# (what, shape or values, dtype, device) -> the tensor, built once
_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def _constant(key: tuple, build: Callable[[], torch.Tensor]
              ) -> torch.Tensor:
    """build(), kept under key after its first call.  Under a trace
    (torch.export, torch.compile) it is built anew each time: the cache
    holds real tensors only.  It builds outside inference mode, so the
    tensor serves autograd's calls too."""
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return build()
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            # the first tensor kept wins: a CUDA graph may hold its address
            t = _CONSTANTS.setdefault(key, build())
    return t


def _level_anchors(H: int, W: int, stride: int, device) -> torch.Tensor:
    counters['sync.rpn.anchors'] += 1
    return torch.from_numpy(grid_anchors((H, W), stride)).to(device)


def _decode_stds(stds, dtype, device) -> torch.Tensor:
    counters['sync.rpn.decode_stds'] += 1
    return torch.tensor(stds, dtype=dtype, device=device)


def _level_sizes(sizes, device) -> torch.Tensor:
    counters['sync.rpn.level_sizes'] += 1
    return torch.tensor(sizes, device=device)


def delta2bbox(anchors: torch.Tensor, deltas: torch.Tensor,
               max_shape: Tuple[int, int], stds=(1., 1., 1., 1.)
               ) -> torch.Tensor:
    """mmdet DeltaXYWHBBoxCoder.decode on [..., 4] (target means 0,
    wh_ratio_clip 16/1000), clipped to max_shape (h, w)."""
    stds = tuple(float(x) for x in stds)
    d = deltas * _constant(
        ('stds', stds, deltas.dtype, deltas.device),
        lambda: _decode_stds(stds, deltas.dtype, deltas.device))
    dx, dy, dw, dh = d.unbind(-1)
    max_ratio = abs(math.log(16.0 / 1000.0))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    pw = anchors[..., 2] - anchors[..., 0]
    ph = anchors[..., 3] - anchors[..., 1]
    px = (anchors[..., 0] + anchors[..., 2]) * 0.5
    py = (anchors[..., 1] + anchors[..., 3]) * 0.5
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    h, w = max_shape
    x1, x2 = (gx - gw * 0.5).clamp(0, w), (gx + gw * 0.5).clamp(0, w)
    y1, y2 = (gy - gh * 0.5).clamp(0, h), (gy + gh * 0.5).clamp(0, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def bbox2delta(anchors: torch.Tensor, gt: torch.Tensor,
               stds=(1., 1., 1., 1.)) -> torch.Tensor:
    """mmdet DeltaXYWHBBoxCoder.encode (target means 0) on [..., 4]."""
    pw = anchors[..., 2] - anchors[..., 0]
    ph = anchors[..., 3] - anchors[..., 1]
    px = (anchors[..., 0] + anchors[..., 2]) * 0.5
    py = (anchors[..., 1] + anchors[..., 3]) * 0.5
    gw = (gt[..., 2] - gt[..., 0]).clamp(min=1e-6)
    gh = (gt[..., 3] - gt[..., 1]).clamp(min=1e-6)
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    d = torch.stack([(gx - px) / pw, (gy - py) / ph, torch.log(gw / pw),
                     torch.log(gh / ph)], dim=-1)
    counters['sync.rpn.encode_stds'] += 1
    return d / d.new_tensor(stds)


class RPNHead(tnn.Module):
    """3x3 conv + relu, then 1x1 objectness (A) and 1x1 deltas (4A)."""

    def __init__(self, feat_channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.rpn_conv = tnn.Conv2d(feat_channels, feat_channels, 3,
                                   padding=1)
        self.rpn_cls = tnn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = tnn.Conv2d(feat_channels, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        scores, deltas = [], []
        for f in feats:
            x = F.relu(conv2d_nhwc(f, self.rpn_conv.weight,
                                   self.rpn_conv.bias, 1, 1))
            scores.append(conv1x1(x, self.rpn_cls))
            deltas.append(conv1x1(x, self.rpn_reg))
        return scores, deltas


def rpn_proposals(scores: List[torch.Tensor], deltas: List[torch.Tensor],
                  strides: Sequence[int], image_shape: Tuple[int, int],
                  nms_pre: int = 1000, max_per_img: int = 1000,
                  iou_threshold: float = 0.7, min_bbox_size: float = 0.0):
    """scores[l] [V, H, W, A] logits, deltas[l] [V, H, W, 4A] ->
    (boxes [V, max_per_img, 4], scores [V, max_per_img], valid)."""
    V = scores[0].shape[0]
    dev = scores[0].device
    lvl_boxes, lvl_scores = [], []
    for l, (s, d) in enumerate(zip(scores, deltas)):
        H, W, A = s.shape[1:]
        anchors = _constant(('anchors', H, W, strides[l], dev),
                            lambda: _level_anchors(H, W, strides[l], dev))
        s = s.reshape(V, -1)
        top_s, top_i = topk(s, min(nms_pre, s.shape[1]))
        top_d = _take(d.reshape(V, H * W * A, 4), top_i)
        lvl_boxes.append(delta2bbox(anchors[top_i], top_d,
                                    max_shape=image_shape))
        lvl_scores.append(top_s)
    n_max = max(x.shape[1] for x in lvl_boxes)

    def pad_lvl(x):
        p = n_max - x.shape[1]
        return x if p == 0 else torch.cat(
            [x, x.new_zeros(x.shape[0], p, *x.shape[2:])], dim=1)

    b = torch.stack([pad_lvl(x) for x in lvl_boxes], dim=1)   # [V, L, n, 4]
    s = torch.sigmoid(torch.stack([pad_lvl(x) for x in lvl_scores], dim=1))
    wh = b[..., 2:4] - b[..., 0:2]
    sizes = tuple(x.shape[1] for x in lvl_boxes)
    n_lvl = _constant(('level_sizes', sizes, dev),
                      lambda: _level_sizes(sizes, dev))
    valid = (wh > min_bbox_size).all(-1) & \
        (torch.arange(n_max, device=dev)[None, None, :] < n_lvl[None, :, None])
    ob, os_ = nms_sorted_keep(b, s, valid, iou_threshold)
    L = b.shape[1]
    flat_b = ob.reshape(V, L * n_max, 4)
    flat_s = os_.reshape(V, L * n_max)
    top_s, top_i = topk(flat_s, min(max_per_img, L * n_max))
    return _take(flat_b, top_i), top_s, top_s > _NEG / 2
