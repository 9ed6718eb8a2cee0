"""RoIAlign (mmcv aligned=True) for the R-CNN stage and the 3D head.

Port of `mv2d_tpu/ops/roi_align.py`.  Sampling follows mmcv: bin (i, j)
sample (si, sj) sits at x = x1 + (j + (sj + 0.5) / S) * bin_w with
x1 = box_x1 * scale - 0.5, bilinear with border clamping inside and zeros
outside (-1, extent), averaged over S*S samples, with mmcv's adaptive
rule (sampling_ratio 0 / -1, the reference's setting): per RoI and axis
S = ceil(extent / O) (0 -> zero output).

* `roi_align_multilevel` is kernel K3 (`csrc/roi_align.cu`), replacing
  `mv2d_tpu/ops/pallas_roi_align.py: pallas_roi_align_views` for the
  R-CNN stage; its plain version is `multilevel_roi_align_plain`.
* `separable_roi_align_views` (3D head) stays plain torch, as the JAX
  package leaves it to XLA: every RoI row/column becomes a weight vector
  and the view tile is contracted with two matmuls.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .. import kernels


def _axis_weights(lo: torch.Tensor, extent: torch.Tensor, n_cells: int,
                  output_size: int, adaptive_max: int) -> torch.Tensor:
    """Per-RoI averaged bilinear hat profile [..., O, n_cells] along one
    axis: W[o, c] = (1/S) sum_s hat(clip(x_s) - c) * 1[-1 < x_s < n], with
    S = ceil(extent / O) capped at adaptive_max sample slots."""
    O = output_size
    dev, dt = extent.device, extent.dtype
    bin_ = extent / O
    oi = torch.arange(O, device=dev, dtype=dt)
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


def multilevel_roi_align_plain(feats: Sequence[torch.Tensor],
                               rois: torch.Tensor, strides: Sequence[int],
                               output_size: int = 7,
                               finest_scale: float = 56.0,
                               chunk: int = 256) -> torch.Tensor:
    """feats: L maps [V, H_l, W_l, C]; rois [V, P, 4] image pixels ->
    [V, P, O, O, C] with adaptive sampling (no cap on S).  Runs the
    separable form per (level, view) group, in float32."""
    V, P = rois.shape[:2]
    C = feats[0].shape[-1]
    O = output_size
    rois = rois.float()
    lvl = roi_levels(rois, len(feats), finest_scale)
    out = torch.zeros((V, P, O, O, C), dtype=torch.float32,
                      device=rois.device)
    for l, (f, s) in enumerate(zip(feats, strides)):
        H, W = f.shape[1], f.shape[2]
        sc = 1.0 / s
        for v in range(V):
            idx = torch.nonzero(lvl[v] == l).flatten()
            for c0 in range(0, idx.numel(), chunk):
                sel = idx[c0:c0 + chunk]
                b = rois[v, sel]
                x1 = b[:, 0] * sc - 0.5
                y1 = b[:, 1] * sc - 0.5
                bw = (b[:, 2] - b[:, 0]) * sc
                bh = (b[:, 3] - b[:, 1]) * sc
                sx = max(int(torch.ceil(bw / O).max()), 1)
                sy = max(int(torch.ceil(bh / O).max()), 1)
                Wx = _axis_weights(x1, bw, W, O, sx)
                Wy = _axis_weights(y1, bh, H, O, sy)
                t = torch.einsum('pjx,yxc->pjyc', Wx, f[v].float())
                out[v, sel] = torch.einsum('piy,pjyc->pijc', Wy, t)
    return out.to(feats[0].dtype)


def roi_align_multilevel(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int]) -> torch.Tensor:
    """Kernel K3: 7x7 RoIAlign over four FPN levels with in-kernel level
    routing.  feats: 4 maps [V, H_l, W_l, C] (float32 or bfloat16); rois
    [V, P, 4] float32 image pixels -> [V, P, 7, 7, C].  CPU tensors take
    `multilevel_roi_align_plain`."""
    if rois.device.type == 'cpu':
        return multilevel_roi_align_plain(feats, rois, strides)
    if len(feats) != 4 or len(strides) != 4:
        raise ValueError('roi_align kernel takes exactly four levels')
    V, P = rois.shape[:2]
    C = feats[0].shape[-1]
    dt = feats[0].dtype
    if any(f.dtype != dt or f.shape[0] != V or f.shape[-1] != C
           for f in feats) or C % 8:
        raise ValueError('levels must share dtype, views and channels '
                         '(a multiple of 8)')
    feats = [f.contiguous() for f in feats]
    rois = rois.float().contiguous()
    kernels.check_cuda(*feats, rois)
    out = torch.empty((V, P, 7, 7, C), dtype=dt, device=rois.device)
    dims = [d for f in feats for d in (f.shape[1], f.shape[2])]
    kernels.launch('mv2d_roi_align', *(f.data_ptr() for f in feats), *dims,
                   *(1.0 / s for s in strides), rois.data_ptr(),
                   out.data_ptr(), V, P, C, kernels.dtype_code(feats[0]))
    roi_align_multilevel.launches += 1
    return out


roi_align_multilevel.launches = 0
