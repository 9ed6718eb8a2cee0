"""PETR-style 3D position embedding (camera-ray frustum -> lidar -> MLP).

Port of `mv2d_tpu/nn/pe.py` with the reference's keys
(position_encoder.{0,2}, adapt_pos3d.{0,2}, fpe.conv_reduce/conv_expand).
The frustum channels are depth-major (d * 3 + xyz) and the sine stack is
parity-blocked, as the converted reference weights read them.  Geometry
runs in float32; the MLPs run in the parameter dtype.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as tnn
import torch.nn.functional as F

from ..core.geometry import inverse_sigmoid, lid_depth_bins
from .layers import conv1x1


def pos2posemb3d(pos: torch.Tensor, num_pos_feats: int = 128,
                 temperature: float = 10000.0) -> torch.Tensor:
    """[..., 3] normalized xyz -> [..., 3 * num_pos_feats], channel order
    (y, x, z), sin/cos interleaved."""
    pos = pos.float() * (2 * math.pi)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=pos.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    def emb(p):
        x = p[..., None] / dim_t
        return torch.stack([x[..., 0::2].sin(), x[..., 1::2].cos()],
                           dim=-1).flatten(-2)

    return torch.cat([emb(pos[..., 1]), emb(pos[..., 0]), emb(pos[..., 2])],
                     dim=-1)


def padding_mask_at_feature_res(img_shapes: torch.Tensor,
                                pad_shape: Tuple[int, int],
                                feat_hw: Tuple[int, int]) -> torch.Tensor:
    """True = padding; img_shapes [V, 2] (h, w) -> [V, H, W] (nearest
    resize of the full-resolution mask)."""
    H, W = feat_hw
    dev = img_shapes.device
    ys = torch.floor(torch.arange(H, device=dev) * (pad_shape[0] / H)).long()
    xs = torch.floor(torch.arange(W, device=dev) * (pad_shape[1] / W)).long()
    inside = (ys[None, :, None] < img_shapes[:, 0, None, None]) & \
             (xs[None, None, :] < img_shapes[:, 1, None, None])
    return ~inside


def sine_positional_encoding_3d(mask: torch.Tensor, num_feats: int = 128,
                                temperature: float = 10000.0,
                                scale: float = 2 * math.pi,
                                eps: float = 1e-6,
                                stride: int = 0) -> torch.Tensor:
    """SinePositionalEncoding3D (normalize=True) on a [V, H, W] padding
    mask -> [V, H, W, 3 * num_feats], channel order (n, y, x), each block
    [sin(even) ..., cos(odd) ...]."""
    not_mask = (~mask).float()
    n_embed = not_mask.cumsum(0)
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    if stride > 0:
        y_embed = (y_embed - 0.5) * stride
        x_embed = (x_embed - 0.5) * stride
    n_embed = n_embed / (n_embed[-1:, :, :] + eps) * scale
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_feats)

    def emb(e):
        p = e[..., None] / dim_t
        return torch.cat([p[..., 0::2].sin(), p[..., 1::2].cos()], dim=-1)

    return torch.cat([emb(n_embed), emb(y_embed), emb(x_embed)], dim=-1)


class LearnedPositionalEncoding3D(tnn.Module):
    """Learned view / row / col embedding (ref models/utils/
    positional_encoding.py:110; no config selects it): mask [V, H, W] ->
    [V, H, W, 3 * num_feats], ordered view, row, col; index i of an axis
    reads row i modulo its table's size."""

    def __init__(self, num_feats: int = 128, row_num_embed: int = 50,
                 col_num_embed: int = 50, view_num_embed: int = 12):
        super().__init__()
        self.row_embed = tnn.Embedding(row_num_embed, num_feats)
        self.col_embed = tnn.Embedding(col_num_embed, num_feats)
        self.view_embed = tnn.Embedding(view_num_embed, num_feats)

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        V, H, W = mask.shape

        def emb(table, n):
            return table(torch.arange(n, device=mask.device)
                         % table.num_embeddings)
        view, row, col = (emb(self.view_embed, V), emb(self.row_embed, H),
                          emb(self.col_embed, W))
        size = (V, H, W, view.shape[-1])
        return torch.cat([view[:, None, None].expand(size),
                          row[None, :, None].expand(size),
                          col[None, None, :].expand(size)], dim=-1)


class SELayer(tnn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv_reduce = tnn.Conv2d(channels, channels, 1)
        self.conv_expand = tnn.Conv2d(channels, channels, 1)

    def forward(self, x, x_se):
        s = conv1x1(F.relu(conv1x1(x_se, self.conv_reduce)),
                    self.conv_expand)
        return x * torch.sigmoid(s)


class PE(tnn.Module):
    """forward(feat [V, H, W, C], img2lidar [V, 4, 4], img_shapes [V, 2],
    pad_shape) -> pos_embed [V, H, W, C].  Depth bins LID-spaced (lid) or
    uniform: start + (range end - start) / depth_num * i."""

    def __init__(self, embed_dims: int = 256, depth_num: int = 64,
                 depth_start: float = 1.0,
                 position_range: Sequence[float] = (-61.2, -61.2, -10.0,
                                                    61.2, 61.2, 10.0),
                 lid: bool = True, with_fpe: bool = True, stride: int = 16,
                 num_sine_feats: int = 128):
        super().__init__()
        assert depth_start >= 1e-3
        self.lid = lid
        self.depth_num = depth_num
        self.depth_start = depth_start
        self.position_range = tuple(position_range)
        self.stride = stride
        self.num_sine_feats = num_sine_feats
        C = embed_dims
        self.position_encoder = tnn.Sequential(
            tnn.Conv2d(depth_num * 3, C * 4, 1), tnn.ReLU(),
            tnn.Conv2d(C * 4, C, 1))
        self.adapt_pos3d = tnn.Sequential(
            tnn.Conv2d(num_sine_feats * 3, C * 4, 1), tnn.ReLU(),
            tnn.Conv2d(C * 4, C, 1))
        self.fpe = SELayer(C) if with_fpe else None

    def forward(self, feat, img2lidar, img_shapes, pad_shape):
        V, H, W, _ = feat.shape
        dev = feat.device
        pr = self.position_range
        coords_h = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) \
            * pad_shape[0] / H - 0.5
        coords_w = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) \
            * pad_shape[1] / W - 0.5
        if self.lid:
            coords_d = lid_depth_bins(self.depth_start, pr[3],
                                      self.depth_num, device=dev)
        else:
            coords_d = self.depth_start + (pr[3] - self.depth_start) \
                / self.depth_num * torch.arange(
                    self.depth_num, dtype=torch.float32, device=dev)
        # frustum point M @ (u*d, v*d, d, 1) = d * (M[:3,:3] @ (u,v,1)) + t
        uv1 = torch.stack([coords_w[None, :].expand(H, W),
                           coords_h[:, None].expand(H, W),
                           torch.ones(H, W, device=dev)], dim=-1)
        m = img2lidar.float()
        ray = torch.einsum('vij,hwj->vhwi', m[:, :3, :3], uv1)
        t = m[:, :3, 3]
        pts = ray[:, :, :, None, :] * coords_d[None, None, None, :, None] \
            + t[:, None, None, None, :]                       # [V,H,W,D,3]
        lo = pts.new_tensor(pr[:3])
        hi = pts.new_tensor(pr[3:])
        pos = inverse_sigmoid((pts - lo) / (hi - lo))
        pos = pos.reshape(V, H, W, self.depth_num * 3)
        x = conv1x1(F.relu(conv1x1(pos, self.position_encoder[0])),
                    self.position_encoder[2])
        if self.fpe is not None:
            x = self.fpe(x, feat)
        mask = padding_mask_at_feature_res(img_shapes, pad_shape, (H, W))
        sin_embed = sine_positional_encoding_3d(mask, self.num_sine_feats,
                                                stride=self.stride)
        s = conv1x1(F.relu(conv1x1(sin_embed, self.adapt_pos3d[0])),
                    self.adapt_pos3d[2])
        return x + s
