"""RoIAlign in plain PyTorch, float32 sums (frozen copy of the port's
`ops/roi_align.py` plain versions: the separable form of the 3D head's
aligned cells, and mmdet's multi-level RoIAlign with adaptive sampling).
The kernels' entry points take these plain versions; autograd gives the
training gradients.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _axis_weights(lo: torch.Tensor, extent: torch.Tensor, n_cells: int,
                  output_size: int, adaptive_max: int,
                  sampling_ratio: int = 0) -> torch.Tensor:
    """Per-RoI averaged bilinear hat profile [..., O, n_cells] along one
    axis: W[o, c] = (1/S) sum_s hat(clip(x_s) - c) * 1[-1 < x_s < n], with
    S = ceil(extent / O) capped at adaptive_max sample slots, or
    S = sampling_ratio when that is > 0."""
    O = output_size
    dev, dt = extent.device, extent.dtype
    bin_ = extent / O
    oi = torch.arange(O, device=dev, dtype=dt)
    if sampling_ratio > 0:
        S = sampling_ratio
        sf = torch.full_like(bin_, float(S))
    else:
        S = adaptive_max
        sf = torch.ceil(bin_).clamp(0.0, float(S))
    div = sf.clamp(min=1.0)
    s = torch.arange(S, device=dev, dtype=dt)
    frac = (s + 0.5) / div[..., None]                          # [..., S]
    xs = lo[..., None, None] + \
        (oi[:, None] + frac[..., None, :]) * bin_[..., None, None]
    wt = (s < sf[..., None])[..., None, :].to(dt).expand_as(xs)
    inside = (xs > -1.0) & (xs < n_cells)
    xc = xs.clamp(0.0, n_cells - 1)
    cells = torch.arange(n_cells, device=dev, dtype=dt)
    hat = (1.0 - (xc[..., None] - cells).abs()).clamp(min=0.0)
    hat = hat * (inside * wt)[..., None]
    return hat.sum(-2) / div[..., None, None]                  # [..., O, n]


def separable_roi_align_views(feat: torch.Tensor, boxes: torch.Tensor,
                              spatial_scale: float, output_size: int,
                              adaptive_max) -> torch.Tensor:
    """feat [V, H, W, C]; boxes [V, P, 4] image-pixel RoIs ->
    [V, P, O, O, C]: out = Wy F Wx per RoI (exact roi_align while
    ceil(extent / O) <= adaptive_max = (max_y, max_x) sample slots)."""
    V, H, W, C = feat.shape
    boxes = boxes.float()
    x1 = boxes[..., 0] * spatial_scale - 0.5
    y1 = boxes[..., 1] * spatial_scale - 0.5
    bw = (boxes[..., 2] - boxes[..., 0]) * spatial_scale
    bh = (boxes[..., 3] - boxes[..., 1]) * spatial_scale
    amax_y, amax_x = adaptive_max
    Wx = _axis_weights(x1, bw, W, output_size, amax_x).to(feat.dtype)
    Wy = _axis_weights(y1, bh, H, output_size, amax_y).to(feat.dtype)
    t = torch.einsum('vpjx,vyxc->vpjyc', Wx, feat)
    return torch.einsum('vpiy,vpjyc->vpijc', Wy, t)


def roi_levels(rois: torch.Tensor, num_levels: int = 4,
               finest_scale: float = 56.0) -> torch.Tensor:
    """mmdet SingleRoIExtractor routing: clamp(floor(log2(sqrt(area) /
    finest_scale + 1e-6)), 0, L-1)."""
    area = ((rois[..., 2] - rois[..., 0]) *
            (rois[..., 3] - rois[..., 1])).clamp(min=0.0)
    lvl = torch.floor(torch.log2(torch.sqrt(area) / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def multilevel_roi_align_flat_plain(feats: Sequence[torch.Tensor],
                                    rois: torch.Tensor,
                                    view_idx: torch.Tensor,
                                    strides: Sequence[int],
                                    sampling_ratio: int = 0,
                                    output_size: int = 7,
                                    finest_scale: float = 56.0,
                                    chunk: int = 256) -> torch.Tensor:
    """feats: L maps [V, H_l, W_l, C]; rois [R, 4] image pixels on views
    view_idx [R] -> [R, O, O, C], with adaptive sampling (no cap on S) or
    a fixed S = sampling_ratio > 0.  Runs the separable form per (level,
    view) group, in float32."""
    R = rois.shape[0]
    C = feats[0].shape[-1]
    O = output_size
    rois = rois.float()
    view_idx = view_idx.long()
    lvl = roi_levels(rois, len(feats), finest_scale)
    out = torch.zeros((R, O, O, C), dtype=torch.float32, device=rois.device)
    for l, (f, s) in enumerate(zip(feats, strides)):
        H, W = f.shape[1], f.shape[2]
        sc = 1.0 / s
        for v in range(f.shape[0]):
            idx = torch.nonzero((lvl == l) & (view_idx == v)).flatten()
            for c0 in range(0, idx.numel(), chunk):
                sel = idx[c0:c0 + chunk]
                b = rois[sel]
                x1 = b[:, 0] * sc - 0.5
                y1 = b[:, 1] * sc - 0.5
                bw = (b[:, 2] - b[:, 0]) * sc
                bh = (b[:, 3] - b[:, 1]) * sc
                sx = max(int(torch.ceil(bw / O).max()), 1)
                sy = max(int(torch.ceil(bh / O).max()), 1)
                Wx = _axis_weights(x1, bw, W, O, sx, sampling_ratio)
                Wy = _axis_weights(y1, bh, H, O, sy, sampling_ratio)
                t = torch.einsum('pjx,yxc->pjyc', Wx, f[v].float())
                out[sel] = torch.einsum('piy,pjyc->pijc', Wy, t)
    return out.to(feats[0].dtype)


def multilevel_roi_align_plain(feats: Sequence[torch.Tensor],
                               rois: torch.Tensor, strides: Sequence[int],
                               output_size: int = 7,
                               finest_scale: float = 56.0,
                               chunk: int = 256) -> torch.Tensor:
    """feats: L maps [V, H_l, W_l, C]; rois [V, P, 4] image pixels ->
    [V, P, O, O, C] with adaptive sampling (no cap on S): the flat form on
    the views' RoIs, in float32."""
    V, P = rois.shape[:2]
    view_idx = torch.arange(V, device=rois.device).repeat_interleave(P)
    out = multilevel_roi_align_flat_plain(
        feats, rois.reshape(V * P, 4), view_idx, strides, 0, output_size,
        finest_scale, chunk)
    return out.reshape(V, P, *out.shape[1:])


def roi_align_multilevel(feats, rois, strides):
    return multilevel_roi_align_plain(feats, rois, strides)


roi_align_slab = roi_align_multilevel


def roi_align_flat(feats, rois, view_idx, strides, sampling_ratio=0):
    return multilevel_roi_align_flat_plain(feats, rois, view_idx, strides,
                                           sampling_ratio)


def roi_align_multilevel_train(feats, rois, strides, slab: bool = False):
    return multilevel_roi_align_plain(feats, rois.detach(), strides)
