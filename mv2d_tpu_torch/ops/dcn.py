"""Modulated deformable convolution v2 (DCNv2, 3x3, deform_groups=1).

Port of `mv2d_tpu/ops/dcn.py`.  A regular conv predicts per-tap offsets
((dy, dx) per tap, mmcv channel order) and sigmoid masks; each tap samples
the input bilinearly at its offset position (border-clamped inside, zero
outside the map) and the masked samples are contracted with the [9, C, F]
tap weights.  `dcn_conv` is kernel K2 (`csrc/dcn.cu`), replacing
`mv2d_tpu/ops/pallas_dcn.py: pallas_dcn_conv`.

Sampling coordinates are built in float32 for every activation dtype.
"""
from __future__ import annotations

import torch
import torch.nn as tnn

from .. import kernels
from ..nn.layers import conv2d_nhwc


def bilinear_zero_outside(x: torch.Tensor, sy: torch.Tensor,
                          sx: torch.Tensor) -> torch.Tensor:
    """x [V, H, W, C]; sy, sx [V, P] -> float32 samples [V, P, C]: zero
    unless -1 < s < extent, coordinates clamped into the map."""
    V, H, W, C = x.shape
    inside = (sx > -1.0) & (sx < W) & (sy > -1.0) & (sy < H)
    sx = sx.clamp(0.0, W - 1)
    sy = sy.clamp(0.0, H - 1)
    x0 = sx.floor()
    y0 = sy.floor()
    lx = (sx - x0)[..., None]
    ly = (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    x1i = (x0i + 1).clamp(max=W - 1)
    y1i = (y0i + 1).clamp(max=H - 1)
    flat = x.reshape(V * H * W, C).float()
    base = (torch.arange(V, device=x.device) * (H * W))[:, None]

    def g(yi, xi):
        return flat[base + yi * W + xi]

    out = (1 - ly) * (1 - lx) * g(y0i, x0i) + (1 - ly) * lx * g(y0i, x1i) \
        + ly * (1 - lx) * g(y1i, x0i) + ly * lx * g(y1i, x1i)
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


def dcn_conv(x, sy, sx, mask, w):
    """Kernel K2.  CPU tensors take `dcn_conv_plain`; CUDA tensors launch
    the kernel (x, w float32 or bfloat16; sy, sx, mask float32)."""
    if x.device.type == 'cpu':
        return dcn_conv_plain(x, sy, sx, mask, w)
    V, H, W, C = x.shape
    _, Ho, Wo, K = sy.shape
    F_ = w.shape[-1]
    if K != 9 or w.shape != (9, C, F_) or C % 32 or F_ % 64:
        raise ValueError(f'dcn kernel takes 3x3 taps, C%32==0, F%64==0; '
                         f'got taps={K} w={tuple(w.shape)}')
    if sy.dtype != torch.float32 or sx.dtype != torch.float32 \
            or mask.dtype != torch.float32 or w.dtype != x.dtype:
        raise TypeError('dcn kernel takes float32 sy/sx/mask, w in x.dtype')
    x, sy, sx, mask, w = (t.contiguous() for t in (x, sy, sx, mask, w))
    kernels.check_cuda(x, sy, sx, mask, w)
    out = torch.empty((V, Ho, Wo, F_), dtype=x.dtype, device=x.device)
    kernels.launch('mv2d_dcn_conv', x.data_ptr(), sy.data_ptr(),
                   sx.data_ptr(), mask.data_ptr(), w.data_ptr(),
                   out.data_ptr(), V, H, W, C, Ho, Wo, F_,
                   kernels.dtype_code(x))
    dcn_conv.launches += 1
    return out


dcn_conv.launches = 0


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
        return dcn_conv(x, sy.contiguous(), sx.contiguous(), mask,
                        self.tap_weights(x.dtype))
