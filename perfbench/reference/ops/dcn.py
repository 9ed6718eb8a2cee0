"""Modulated deformable convolution v2 (DCNv2, 3x3, deform_groups=1) in
plain PyTorch (frozen copy of the port's `ops/dcn.py` plain versions): a
regular conv predicts per-tap offsets and sigmoid masks, each tap samples
the input bilinearly (border-clamped inside, zero outside the map), and
the masked samples are contracted with the [9, C, F] tap weights.
Autograd gives the training gradients.
"""
from __future__ import annotations

import torch
import torch.nn as tnn

from ..nn.layers import conv2d_nhwc


def _sample_corners(sy, sx, H: int, W: int):
    """sy, sx [...] -> (inside [...], rows [..., 4], cols [..., 4],
    bilinear weights [..., 4], ly, lx): the clamped corners (y0, x0),
    (y0, x1), (y1, x0), (y1, x1) of each sample and its fractions, as the
    kernels take them (the weights carry the floor-form derivative)."""
    inside = (sx > -1.0) & (sx < W) & (sy > -1.0) & (sy < H)
    yy = sy.clamp(0.0, H - 1)
    xx = sx.clamp(0.0, W - 1)
    y0, x0 = yy.floor(), xx.floor()
    ly, lx = yy - y0, xx - x0
    y0i, x0i = y0.long(), x0.long()
    y1i, x1i = (y0i + 1).clamp(max=H - 1), (x0i + 1).clamp(max=W - 1)
    rows = torch.stack([y0i, y0i, y1i, y1i], -1)
    cols = torch.stack([x0i, x1i, x0i, x1i], -1)
    w = torch.stack([(1 - ly) * (1 - lx), (1 - ly) * lx, ly * (1 - lx),
                     ly * lx], -1)
    return inside, rows, cols, w, ly, lx


def bilinear_zero_outside(x: torch.Tensor, sy: torch.Tensor,
                          sx: torch.Tensor) -> torch.Tensor:
    """x [V, H, W, C]; sy, sx [V, P] -> float32 samples [V, P, C]: zero
    unless -1 < s < extent, coordinates clamped into the map."""
    V, H, W, C = x.shape
    inside, rows, cols, w, _, _ = _sample_corners(sy, sx, H, W)
    flat = x.reshape(V * H * W, C).float()
    at = (torch.arange(V, device=x.device) * (H * W))[:, None, None] \
        + rows * W + cols                                    # [V, P, 4]
    out = w[..., 0, None] * flat[at[..., 0]]
    for q in range(1, 4):
        out = out + w[..., q, None] * flat[at[..., q]]
    return out * inside[..., None]


def dcn_conv_plain(x, sy, sx, mask, w):
    """x [V, H, W, C]; sy, sx, mask [V, Ho, Wo, 9] float32; w [9, C, F]
    -> [V, Ho, Wo, F] in x.dtype (float32 gather + einsum)."""
    V, Ho, Wo, K = sy.shape
    C = x.shape[-1]
    samples = bilinear_zero_outside(x, sy.reshape(V, -1), sx.reshape(V, -1))
    samples = samples.reshape(V, Ho, Wo, K, C) * mask[..., None]
    return torch.einsum('vhwkc,kcf->vhwf', samples,
                        w.float()).to(x.dtype)


def dcn_samples_plain(x, sy, sx, mask):
    """x [V, H, W, C]; sy, sx, mask [V, Ho, Wo, 9] float32 ->
    [V, Ho, Wo, 9, C] masked bilinear samples in x.dtype (float32 gather;
    its autograd is the floor-form derivative B6 computes)."""
    V, Ho, Wo, K = sy.shape
    C = x.shape[-1]
    samples = bilinear_zero_outside(x, sy.reshape(V, -1), sx.reshape(V, -1))
    return (samples.reshape(V, Ho, Wo, K, C) * mask[..., None]).to(x.dtype)


class ModulatedDeformConv(tnn.Module):
    """mmcv ModulatedDeformConv2dPack (bias=False) key layout: weight
    [F, C, 3, 3] and conv_offset (3*9 outputs, zero-init)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = tnn.Parameter(torch.empty(out_channels, in_channels,
                                                3, 3))
        tnn.init.kaiming_normal_(self.weight)
        self.conv_offset = tnn.Conv2d(in_channels, 27, 3, stride, 1)
        tnn.init.zeros_(self.conv_offset.weight)
        tnn.init.zeros_(self.conv_offset.bias)

    def sample_coords(self, x: torch.Tensor):
        """Offset/mask branch -> (sy, sx, mask), each [V, Ho, Wo, 9]
        float32 in input-pixel coordinates."""
        V = x.shape[0]
        om = conv2d_nhwc(x, self.conv_offset.weight, self.conv_offset.bias,
                         self.stride, 1).float()
        Ho, Wo = om.shape[1], om.shape[2]
        off = om[..., :18].reshape(V, Ho, Wo, 9, 2)
        mask = torch.sigmoid(om[..., 18:])
        dev = x.device
        ys = torch.arange(Ho, device=dev, dtype=torch.float32) \
            * self.stride - 1
        xs = torch.arange(Wo, device=dev, dtype=torch.float32) \
            * self.stride - 1
        k = torch.arange(3, device=dev, dtype=torch.float32)
        ky, kx = torch.meshgrid(k, k, indexing='ij')
        base_y = ys[:, None, None] + ky.reshape(-1)[None, None, :]
        base_x = xs[None, :, None] + kx.reshape(-1)[None, None, :]
        return (base_y[None] + off[..., 0], base_x[None] + off[..., 1],
                mask.contiguous())

    def tap_weights(self, dtype: torch.dtype) -> torch.Tensor:
        """[F, C, 3, 3] -> [9, C, F] (tap index = ky * 3 + kx)."""
        F_, C = self.weight.shape[:2]
        return self.weight.permute(2, 3, 1, 0).reshape(-1, C, F_) \
            .to(dtype).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sy, sx, mask = self.sample_coords(x)
        sy, sx = sy.contiguous(), sx.contiguous()
        w = self.tap_weights(x.dtype)
        if not torch.is_grad_enabled():
            return dcn_conv_plain(x, sy, sx, mask, w)
        V, Ho, Wo, _ = sy.shape
        samples = dcn_samples_plain(x, sy, sx, mask)
        y = samples.reshape(V * Ho * Wo, -1) @ w.reshape(-1, w.shape[-1])
        return y.reshape(V, Ho, Wo, -1)
