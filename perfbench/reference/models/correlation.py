"""Epipolar box correlation and the k_max pixel-key gather (fixed shapes).

Port of `mv2d_tpu/models/correlation.py`.  Geometry on
detached inputs: proposals live in [V, P] slots, the correlation is a
[R, 1 + V*topk] table of global RoI ids with validity (R = V*P; under
'all_matched' the full [R, 1 + R] table), and the active attention keys
are a stable gather capped at k_max.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..configs import CorrelationConfig
from ..core.boxes import box_iou_xyxy
from ..core.geometry import lid_depth_bins
from ..core.nms import topk


def _sample_points_in_boxes(boxes: torch.Tensor, n: int) -> torch.Tensor:
    """boxes [R, 4] -> [R, n*n, 2] grid points including the corners."""
    t = torch.linspace(0.0, 1.0, n, device=boxes.device)
    gy, gx = torch.meshgrid(t, t, indexing='ij')
    grid = torch.stack([gx, gy], -1).reshape(-1, 2)
    wh = boxes[:, 2:4] - boxes[:, 0:2]
    return boxes[:, None, 0:2] + wh[:, None] * grid[None]


def epipolar_in_box(boxes: torch.Tensor, valid: torch.Tensor,
                    trans_mats: torch.Tensor, pad_shape: Tuple[int, int],
                    cfg: CorrelationConfig):
    """boxes [V, P, 4]; valid [V, P]; trans_mats [V, V, 4, 4] ->
    (corr_ids [R, 1 + V*topk], corr_mask [R, 1 + V*topk]); column 0 is
    the RoI itself.  Depth bins LID-spaced (cfg.lid) or uniform.  Under
    mode 'all_matched' every RoI whose hull IoU is positive correlates:
    the table is [R, 1 + R], column 1 + j RoI j."""
    V, P = boxes.shape[:2]
    R = V * P
    dev = boxes.device
    S = cfg.sample_size * cfg.sample_size
    D = cfg.num_depth
    flat_boxes = boxes.reshape(R, 4)
    flat_valid = valid.reshape(R)
    view_of_roi = torch.arange(V, device=dev).repeat_interleave(P)
    pts = _sample_points_in_boxes(flat_boxes, cfg.sample_size)   # [R, S, 2]
    if cfg.lid:
        depths = lid_depth_bins(cfg.depth_start, cfg.depth_end, D, dev)
    else:
        depths = torch.linspace(cfg.depth_start, cfg.depth_end, D,
                                device=dev)
    uv = pts[:, :, None, :]
    d = depths[None, None, :, None]
    hom = torch.cat([uv * d, d.expand(R, S, D, 1),
                     torch.ones(R, S, D, 1, device=dev)], -1)
    tm = trans_mats[view_of_roi]                                  # [R, V, 4, 4]
    proj = torch.einsum('rvij,rsdj->rvsdi', tm, hom)
    depth_t = proj[..., 2]
    uv_t = proj[..., :2] / depth_t.clamp(min=1e-2)[..., None]
    H, W = pad_shape
    ok = depth_t >= cfg.depth_start
    ok &= (uv_t[..., 0] >= 0) & (uv_t[..., 0] <= W - 1)
    ok &= (uv_t[..., 1] >= 0) & (uv_t[..., 1] <= H - 1)
    own = view_of_roi[:, None] == torch.arange(V, device=dev)[None]
    ok &= ~own[:, :, None, None]
    ok &= flat_valid[:, None, None, None]

    pts_flat = uv_t.reshape(R, V, S * D, 2)
    ok_flat = ok.reshape(R, V, S * D)
    b = boxes[None, :, :, None]                                   # [1,V,P,1,4]
    px = pts_flat[:, :, None, :, 0]
    py = pts_flat[:, :, None, :, 1]
    inb = (px >= b[..., 0]) & (px <= b[..., 2]) & \
          (py >= b[..., 1]) & (py <= b[..., 3])
    inb &= ok_flat[:, :, None, :]
    in_rois = inb.any(-1) & valid[None]                           # [R, V, P]
    in_view = in_rois.any(-1)                                     # [R, V]

    big = 1e4
    okx = ok_flat[..., None]
    pmax = torch.where(okx, pts_flat, torch.full_like(pts_flat, -big)).amax(2)
    pmin = torch.where(okx, pts_flat, torch.full_like(pts_flat, big)).amin(2)
    hull = torch.cat([pmin, pmax], -1)                            # [R, V, 4]
    iou = box_iou_xyxy(hull[:, :, None], boxes[None])[:, :, 0]    # [R, V, P]
    iou = torch.where(valid[None] & in_view[..., None], iou,
                      torch.zeros_like(iou))

    if cfg.mode == 'all_matched':
        # O(R^2): the roi key mode's per-query keys grow with it
        top_ids = torch.arange(R, device=dev)[None].expand(R, R)
        top_mask = (iou > 0).reshape(R, R)
    else:
        k = min(cfg.topk, P)
        top_iou, top_idx = topk(iou, k)                           # [R, V, k]
        top_ids = torch.arange(V, device=dev)[None, :, None] * P + top_idx
        top_max = top_iou.amax(-1, keepdim=True)
        top_mask = ((top_iou > cfg.ratio * top_max) |
                    (top_iou > cfg.iou_thr)) & (top_iou > 0)
        top_ids = top_ids.reshape(R, V * k)
        top_mask = top_mask.reshape(R, V * k)
    self_ids = torch.arange(R, device=dev)[:, None]
    corr_ids = torch.cat([self_ids, top_ids], dim=1)
    corr_mask = torch.cat([flat_valid[:, None], top_mask], dim=1)
    return corr_ids, corr_mask


def adjacency_from_correlation(corr_ids: torch.Tensor,
                               corr_mask: torch.Tensor,
                               num_rois: int) -> torch.Tensor:
    """[R, C] id/mask table -> dense adjacency [R, num_rois] bool."""
    R = corr_ids.shape[0]
    ids = torch.where(corr_mask, corr_ids,
                      torch.full_like(corr_ids, num_rois))
    A = torch.zeros((R, num_rois + 1), dtype=torch.bool,
                    device=corr_ids.device)
    A.scatter_(1, ids, True)
    return A[:, :num_rois]


def in_roi_pixel_masks(boxes: torch.Tensor, valid: torch.Tensor,
                       feat_hw: Tuple[int, int], stride: float,
                       expand_stride: float) -> torch.Tensor:
    """Per-view in-box pixel masks [V, P, h*w]: pixel (y, x) at image
    coords ((x+0.5)*stride-0.5, ...) is inside iff its
    (expand_stride+0.5)*stride neighbourhood overlaps the box."""
    h, w = feat_hw
    dev, dt = boxes.device, boxes.dtype
    xs = (torch.arange(w, device=dev, dtype=dt) + 0.5) * stride - 0.5
    ys = (torch.arange(h, device=dev, dtype=dt) + 0.5) * stride - 0.5
    m = (expand_stride + 0.5) * stride
    in_x = (xs[None, None] + m >= boxes[..., 0:1]) & \
           (xs[None, None] - m <= boxes[..., 2:3])
    in_y = (ys[None, None] + m >= boxes[..., 1:2]) & \
           (ys[None, None] - m <= boxes[..., 3:4])
    mask = in_y[:, :, :, None] & in_x[:, :, None, :]
    mask &= valid[..., None, None]
    return mask.reshape(*boxes.shape[:2], h * w)


def query_pixel_masks(adjacency: torch.Tensor, in_roi: torch.Tensor
                      ) -> torch.Tensor:
    """adjacency [R, R] (R = V*P), in_roi [V, P, hw] -> [R, V*hw] bool:
    a pixel is allowed for a query iff it lies in a RoI of its view that
    the query correlates to."""
    V, P, hw = in_roi.shape
    R = adjacency.shape[0]
    M = torch.einsum('rvp,vph->rvh', adjacency.reshape(R, V, P).float(),
                     in_roi.float())
    return (M > 0.5).reshape(R, V * hw)


def gather_active_keys(union_mask: torch.Tensor, k_max: int):
    """union_mask [N] bool -> (indices [min(N, k_max)], valid): active
    pixels first in index order; pixels beyond k_max are dropped."""
    order = torch.argsort((~union_mask).to(torch.uint8), stable=True)
    idx = order[:k_max]
    return idx, union_mask[idx]
