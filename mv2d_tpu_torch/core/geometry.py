"""Camera geometry: host f64 camera precompute, virtual intrinsics, depth bins.

Port of `mv2d_tpu/core/geometry.py`.  Per-view inverses are computed once
per sample on the host in float64 (`prepare_camera_params`) and handed to
the device as float32 tensors; the per-RoI virtual-intrinsic inverse uses
the analytic form of a projection matrix.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch


@dataclass
class CameraParams:
    """Per-sample camera parameters; all [V, 4, 4] float32 except
    trans_mats [V, V, 4, 4] ([i, j] = lidar2img[j] @ img2lidar[i]) and
    timestamps [V]."""
    intrinsics: torch.Tensor
    extrinsics: torch.Tensor
    lidar2img: torch.Tensor
    img2lidar: torch.Tensor
    ext_t_inv: torch.Tensor
    trans_mats: torch.Tensor
    timestamps: torch.Tensor

    @property
    def num_views(self) -> int:
        return self.intrinsics.shape[0]


def prepare_camera_params(intrinsics: Sequence[np.ndarray],
                          extrinsics: Sequence[np.ndarray],
                          timestamps: Sequence[float] | None = None,
                          device: torch.device | str = 'cuda',
                          dtype: torch.dtype = torch.float32
                          ) -> CameraParams:
    """Host-side (float64) precompute of all per-view inverse matrices."""
    K = np.asarray(intrinsics, dtype=np.float64).reshape(-1, 4, 4)
    E = np.asarray(extrinsics, dtype=np.float64).reshape(-1, 4, 4)
    V = K.shape[0]
    lidar2img = K @ np.transpose(E, (0, 2, 1))
    img2lidar = np.linalg.inv(lidar2img)
    ext_t_inv = np.linalg.inv(np.transpose(E, (0, 2, 1)))
    trans_mats = lidar2img[None] @ img2lidar[:, None]
    if timestamps is None:
        ts = np.zeros((V,), dtype=np.float64)
    else:
        ts = np.asarray(timestamps, dtype=np.float64)
        ts = ts - ts.min()

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return CameraParams(intrinsics=t(K), extrinsics=t(E),
                        lidar2img=t(lidar2img), img2lidar=t(img2lidar),
                        ext_t_inv=t(ext_t_inv), trans_mats=t(trans_mats),
                        timestamps=t(ts))


def lid_depth_bins(depth_start: float, depth_end: float, num: int,
                   device=None) -> torch.Tensor:
    """LID depth bin centers d_i = start + bin * i * (i+1)."""
    index = torch.arange(num, dtype=torch.float32, device=device)
    bin_size = (depth_end - depth_start) / (num * (1 + num))
    return depth_start + bin_size * index * (index + 1)


def virtual_intrinsics(boxes: torch.Tensor, intrinsics: torch.Tensor,
                       roi_size: Sequence[int] = (7, 7)) -> torch.Tensor:
    """Per-RoI virtual camera intrinsics: boxes [R, 4], intrinsics
    [R, 4, 4] -> [R, 4, 4] (principal point moved to the RoI origin with
    the half-pixel `0.5 / scale` offset, then rescaled to the RoI grid)."""
    wh_bbox = boxes[:, 2:4] - boxes[:, 0:2]
    wh_roi = boxes.new_tensor([roi_size[1], roi_size[0]])
    scale = wh_roi[None] / wh_bbox                                   # [R, 2]
    K = intrinsics.clone()
    K[:, :2, 2] = K[:, :2, 2] - boxes[:, 0:2] - 0.5 / scale
    K[:, :2] = K[:, :2] * scale[..., None]
    return K


def invert_projection(K: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of [[A, t, 0], [0,0,1,0], [0,0,0,1]] matrices."""
    a, b = K[..., 0, 0], K[..., 0, 1]
    c, d = K[..., 1, 0], K[..., 1, 1]
    tx, ty = K[..., 0, 2], K[..., 1, 2]
    inv_det = 1.0 / (a * d - b * c)
    ia, ib = d * inv_det, -b * inv_det
    ic, id_ = -c * inv_det, a * inv_det
    out = torch.zeros_like(K)
    out[..., 0, 0] = ia
    out[..., 0, 1] = ib
    out[..., 1, 0] = ic
    out[..., 1, 1] = id_
    out[..., 0, 2] = -(ia * tx + ib * ty)
    out[..., 1, 2] = -(ic * tx + id_ * ty)
    out[..., 2, 2] = 1.0
    out[..., 3, 3] = 1.0
    return out


def center2lidar(center_pred: torch.Tensor, virtual_K: torch.Tensor,
                 ext_t_inv: torch.Tensor) -> torch.Tensor:
    """Unproject (u, v, depth) [R, 3] in the virtual RoI frame to lidar xyz
    [R, 3]: inv(K_virt @ E^T) = inv(E^T) @ inv(K_virt)."""
    uvd = center_pred
    p = torch.cat([uvd[:, :2] * uvd[:, 2:3], uvd[:, 2:3],
                   torch.ones_like(uvd[:, :1])], dim=1)              # [R, 4]
    img2lidar = ext_t_inv @ invert_projection(virtual_K)
    return torch.einsum('rij,rj->ri', img2lidar, p)[:, :3]


def normalize_points(points: torch.Tensor,
                     pc_range: Sequence[float]) -> torch.Tensor:
    lo = points.new_tensor(pc_range[:3])
    hi = points.new_tensor(pc_range[3:])
    return (points - lo) / (hi - lo)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """mmdet inverse_sigmoid: clamp to [0, 1], then eps-guard."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))
