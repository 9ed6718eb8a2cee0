"""Box utilities: 3D box codes, axis-aligned IoU, rotated BEV and 3D IoU.

Port of `mv2d_tpu/core/boxes.py`.
3D boxes are (cx, cy, cz, w, l, h, yaw[, vx, vy]); "gravity" boxes have z
at the geometric center, "bottom" boxes at the bottom face.
"""
from __future__ import annotations

import torch


def normalize_bbox(boxes: torch.Tensor) -> torch.Tensor:
    """Gravity-center 3D boxes (..., 9 or 7) -> normalized code
    (cx, cy, log w, log l, cz, log h, sin, cos[, vx, vy])."""
    parts = [boxes[..., 0:1], boxes[..., 1:2], boxes[..., 3:4].log(),
             boxes[..., 4:5].log(), boxes[..., 2:3], boxes[..., 5:6].log(),
             boxes[..., 6:7].sin(), boxes[..., 6:7].cos()]
    if boxes.shape[-1] > 7:
        parts += [boxes[..., 7:8], boxes[..., 8:9]]
    return torch.cat(parts, dim=-1)


def denormalize_bbox(code: torch.Tensor) -> torch.Tensor:
    """Normalized code (..., >=8) -> gravity-center 3D boxes (..., 9 or 7)."""
    rot = torch.atan2(code[..., 6:7], code[..., 7:8])
    parts = [code[..., 0:1], code[..., 1:2], code[..., 4:5],
             code[..., 2:3].exp(), code[..., 3:4].exp(), code[..., 5:6].exp(),
             rot]
    if code.shape[-1] > 8:
        parts += [code[..., 8:9], code[..., 9:10]]
    return torch.cat(parts, dim=-1)


def gravity_to_bottom(boxes: torch.Tensor) -> torch.Tensor:
    out = boxes.clone()
    out[..., 2] = boxes[..., 2] - 0.5 * boxes[..., 5]
    return out


def bottom_to_gravity(boxes: torch.Tensor) -> torch.Tensor:
    out = boxes.clone()
    out[..., 2] = boxes[..., 2] + 0.5 * boxes[..., 5]
    return out


def box_iou_xyxy(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                 eps: float = 1e-4) -> torch.Tensor:
    """Pairwise IoU [..., n, 4] x [..., m, 4] -> [..., n, m] (eps in the
    denominator, as MV2D.box_iou)."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    lt = torch.maximum(a[..., 0:2], b[..., 0:2])
    rb = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + eps)


def bev_corners(boxes_bev: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, l, yaw) [..., 5] -> 4 corners [..., 4, 2], CCW order."""
    cx, cy, w, l, yaw = boxes_bev.unbind(-1)
    dx = 0.5 * torch.stack([w, -w, -w, w], dim=-1)
    dy = 0.5 * torch.stack([l, l, -l, -l], dim=-1)
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    x = cx[..., None] + c * dx - s * dy
    y = cy[..., None] + s * dx + c * dy
    return torch.stack([x, y], dim=-1)


def _polygon_area(poly: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Shoelace area of a padded convex polygon [..., P, 2]."""
    v = torch.where(valid[..., None], poly, torch.zeros_like(poly))
    count = valid.sum(-1)
    idx = torch.arange(poly.shape[-2], device=poly.device)
    nxt = torch.where(idx + 1 < count[..., None], idx + 1, 0)
    pnext = torch.gather(v, -2, nxt[..., None].expand(*nxt.shape, 2))
    cross = v[..., 0] * pnext[..., 1] - v[..., 1] * pnext[..., 0]
    cross = torch.where(valid, cross, torch.zeros_like(cross))
    return 0.5 * cross.sum(-1).abs()


def _clip_polygon_halfplane(poly, count, p0, p1):
    """Sutherland-Hodgman: clip padded polygon [..., P, 2] by the half-plane
    left of p0->p1; returns (poly, count) at the same padded size."""
    P = poly.shape[-2]
    d = p1 - p0
    rel = poly - p0[..., None, :]
    side = d[..., None, 0] * rel[..., 1] - d[..., None, 1] * rel[..., 0]
    idx = torch.arange(P, device=poly.device)
    valid = idx < count[..., None]
    inside = (side >= 0) & valid
    nxt = torch.where(idx + 1 < count[..., None], idx + 1, 0)
    poly_n = torch.gather(poly, -2, nxt[..., None].expand(*nxt.shape, 2))
    side_n = torch.gather(side, -1, nxt)
    inside_n = torch.gather(inside, -1, nxt)
    denom = side - side_n
    t = side / torch.where(denom.abs() < 1e-12,
                           torch.full_like(denom, 1e-12), denom)
    inter_pt = poly + t[..., None] * (poly_n - poly)
    emit_int = valid & (inside ^ inside_n)
    pts = torch.stack([poly, inter_pt], dim=-2).reshape(
        *poly.shape[:-2], 2 * P, 2)
    emit = torch.stack([inside, emit_int], dim=-1).reshape(
        *poly.shape[:-2], 2 * P)
    order = torch.argsort((~emit).to(torch.uint8), dim=-1, stable=True)
    pts = torch.gather(pts, -2, order[..., None].expand(*order.shape, 2))
    new_count = emit.sum(-1)
    return pts[..., :P, :], new_count


def _bev_intersection(boxes_a: torch.Tensor,
                      boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection area of rotated BEV boxes (cx, cy, w, l, yaw):
    [..., n, 5] x [..., m, 5] -> [..., n, m], exact convex clipping."""
    n, m = boxes_a.shape[-2], boxes_b.shape[-2]
    ca = bev_corners(boxes_a)                                # [..., n, 4, 2]
    cb = bev_corners(boxes_b)                                # [..., m, 4, 2]
    P = 16
    lead = torch.broadcast_shapes(ca.shape[:-3], cb.shape[:-3])
    poly = ca[..., :, None, :, :].expand(*lead, n, m, 4, 2)
    poly = torch.cat([poly, poly.new_zeros(*lead, n, m, P - 4, 2)], dim=-2)
    count = torch.full((*lead, n, m), 4, dtype=torch.long,
                       device=boxes_a.device)
    for e in range(4):
        p0 = cb[..., None, :, e, :].expand(*lead, n, m, 2)
        p1 = cb[..., None, :, (e + 1) % 4, :].expand(*lead, n, m, 2)
        poly, count = _clip_polygon_halfplane(poly, count, p0, p1)
    valid = torch.arange(P, device=poly.device) < count[..., None]
    return _polygon_area(poly, valid)


def rotated_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                    eps: float = 1e-8) -> torch.Tensor:
    """Pairwise IoU of rotated BEV boxes (cx, cy, w, l, yaw):
    [..., n, 5] x [..., m, 5] -> [..., n, m], exact convex clipping."""
    inter = _bev_intersection(boxes_a, boxes_b)
    area_a = (boxes_a[..., 2] * boxes_a[..., 3])[..., :, None]
    area_b = (boxes_b[..., 2] * boxes_b[..., 3])[..., None, :]
    return inter / (area_a + area_b - inter).clamp(min=eps)


def iou_3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
           eps: float = 1e-8) -> torch.Tensor:
    """Pairwise 3D IoU of bottom-center boxes (x, y, z, w, l, h, yaw):
    [n, >=7] x [m, >=7] -> [n, m], the BEV polygon intersection times the
    vertical overlap (the reference's mmdet3d iou3d calculators; no path
    of the model calls it)."""
    bev = [0, 1, 3, 4, 6]
    inter_bev = _bev_intersection(boxes_a[:, bev], boxes_b[:, bev])
    z1 = torch.maximum(boxes_a[:, None, 2], boxes_b[None, :, 2])
    z2 = torch.minimum(boxes_a[:, None, 2] + boxes_a[:, None, 5],
                       boxes_b[None, :, 2] + boxes_b[None, :, 5])
    inter = inter_bev * (z2 - z1).clamp(min=0.0)
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return inter / (vol_a + vol_b - inter).clamp(min=eps)
