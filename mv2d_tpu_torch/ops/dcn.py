"""Modulated deformable convolution v2 (DCNv2, 3x3, deform_groups=1).

Port of `mv2d_tpu/ops/dcn.py`.  A regular conv predicts per-tap offsets
((dy, dx) per tap, mmcv channel order) and sigmoid masks; each tap samples
the input bilinearly at its offset position (border-clamped inside, zero
outside the map) and the masked samples are contracted with the [9, C, F]
tap weights.  `dcn_conv` is kernel K2 (`csrc/dcn.cu`), replacing
`mv2d_tpu/ops/pallas_dcn.py: pallas_dcn_conv`; it runs when no gradient
is recorded.  In bfloat16 K2 gathers each sample once into shared memory
and multiplies it on the tensor cores (wgmma) against every output
channel while the next chunk is gathered, so the [V, Ho, Wo, 9C] samples
never reach device memory.  With gradients on, the training path of the
JAX package (`dcn_modulated_conv_train`) is followed: `dcn_samples` (kernel B5, its
gradient kernel B6 in `DCNSamplesFn`) writes the modulated samples
[V, Ho, Wo, 9, C] and one matmul against the [9C, F] tap weights
contracts them, so dw and dsamples come from the matmul's autograd.
A conv built with `fused_train` (MV2D_DCN_TRAIN_FUSED=1, see `routes`)
follows the JAX package's fused training form instead: `dcn_conv_train`
runs `DCNConvFn`, K2 as the forward and kernel B13 (`dcn_conv_backward`,
replacing `pallas_dcn.py: _run_conv_bwd`) as one combined backward, so the
[V, Ho, Wo, 9C] samples reach memory in neither direction.

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
    the kernel (x, w float32 or bfloat16; sy, sx, mask float32; 3x3 taps,
    C % 32 == 0, F % 64 == 0, any other shape raises)."""
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
    if x.dtype == torch.bfloat16 and x.numel() >= 2 ** 31:
        raise ValueError('dcn kernel addresses x with 32-bit offsets in '
                         f'bfloat16; got {x.numel()} elements')
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


def dcn_samples_plain(x, sy, sx, mask):
    """x [V, H, W, C]; sy, sx, mask [V, Ho, Wo, 9] float32 ->
    [V, Ho, Wo, 9, C] masked bilinear samples in x.dtype (float32 gather;
    its autograd is the floor-form derivative B6 computes)."""
    V, Ho, Wo, K = sy.shape
    C = x.shape[-1]
    samples = bilinear_zero_outside(x, sy.reshape(V, -1), sx.reshape(V, -1))
    return (samples.reshape(V, Ho, Wo, K, C) * mask[..., None]).to(x.dtype)


def _check_samples_args(x, sy, sx, mask):
    V, H, W, C = x.shape
    if sy.shape[-1] != 9 or C % 8:
        raise ValueError(f'dcn samples kernel takes 3x3 taps and C%8==0; '
                         f'got taps={sy.shape[-1]} C={C}')
    if sy.dtype != torch.float32 or sx.dtype != torch.float32 \
            or mask.dtype != torch.float32:
        raise TypeError('dcn samples kernel takes float32 sy/sx/mask')
    if sx.shape != sy.shape or mask.shape != sy.shape \
            or sy.shape[0] != V:
        raise ValueError('sy, sx and mask must be [V, Ho, Wo, 9]')


def dcn_samples_forward(x, sy, sx, mask):
    """Kernel B5 on CUDA tensors: -> [V, Ho, Wo, 9, C] in x.dtype."""
    _check_samples_args(x, sy, sx, mask)
    x, sy, sx, mask = (t.contiguous() for t in (x, sy, sx, mask))
    kernels.check_cuda(x, sy, sx, mask)
    V, H, W, C = x.shape
    _, Ho, Wo, K = sy.shape
    out = torch.empty((V, Ho, Wo, K, C), dtype=x.dtype, device=x.device)
    kernels.launch('mv2d_dcn_samples', x.data_ptr(), sy.data_ptr(),
                   sx.data_ptr(), mask.data_ptr(), out.data_ptr(), V, H, W,
                   C, Ho, Wo, kernels.dtype_code(x))
    dcn_samples_forward.launches += 1
    return out


dcn_samples_forward.launches = 0


def dcn_samples_backward(x, sy, sx, mask, dsamples):
    """Kernel B6 on CUDA tensors: dsamples [V, Ho, Wo, 9, C] (x.dtype) ->
    (dx [V, H, W, C], dsy, dsx, dmask [V, Ho, Wo, 9]), all float32."""
    _check_samples_args(x, sy, sx, mask)
    V, H, W, C = x.shape
    _, Ho, Wo, K = sy.shape
    if dsamples.shape != (V, Ho, Wo, K, C) or dsamples.dtype != x.dtype:
        raise ValueError('dsamples must be [V, Ho, Wo, 9, C] in x.dtype')
    x, sy, sx, mask, dsamples = (t.contiguous() for t in
                                 (x, sy, sx, mask, dsamples))
    kernels.check_cuda(x, sy, sx, mask, dsamples)
    dx = torch.zeros((V, H, W, C), dtype=torch.float32, device=x.device)
    dsy, dsx, dm = (torch.empty_like(sy) for _ in range(3))
    kernels.launch('mv2d_dcn_samples_bwd', x.data_ptr(), sy.data_ptr(),
                   sx.data_ptr(), mask.data_ptr(), dsamples.data_ptr(),
                   dx.data_ptr(), dsy.data_ptr(), dsx.data_ptr(),
                   dm.data_ptr(), V, H, W, C, Ho, Wo, kernels.dtype_code(x))
    dcn_samples_backward.launches += 1
    return dx, dsy, dsx, dm


dcn_samples_backward.launches = 0


class DCNSamplesFn(torch.autograd.Function):
    """B5 forward, B6 backward (gradients to x, sy, sx and mask)."""

    @staticmethod
    def forward(ctx, x, sy, sx, mask):
        ctx.save_for_backward(x, sy, sx, mask)
        return dcn_samples_forward(x, sy, sx, mask)

    @staticmethod
    def backward(ctx, dsamples):
        x, sy, sx, mask = ctx.saved_tensors
        dx, dsy, dsx, dm = dcn_samples_backward(x, sy, sx, mask,
                                                dsamples.to(x.dtype))
        return dx.to(x.dtype), dsy, dsx, dm


def dcn_samples(x, sy, sx, mask):
    """Differentiable masked bilinear samples [V, Ho, Wo, 9, C].  CPU
    tensors take `dcn_samples_plain` (autograd); CUDA tensors run
    `DCNSamplesFn` (kernels B5 / B6)."""
    if x.device.type == 'cpu':
        return dcn_samples_plain(x, sy, sx, mask)
    return DCNSamplesFn.apply(x, sy, sx, mask)


def dcn_conv_backward(x, sy, sx, mask, w, dy):
    """Kernel B13 on CUDA tensors: the VJP of `dcn_conv` at dy
    [V, Ho, Wo, F] (x.dtype) -> (dx [V, H, W, C], dsy, dsx, dmask
    [V, Ho, Wo, 9], dw [9, C, F]), all float32.  The derivatives follow
    B6's conventions (floor form; zero where a coordinate was clamped)."""
    V, H, W, C = x.shape
    _, Ho, Wo, K = sy.shape
    F_ = w.shape[-1]
    if K != 9 or w.shape != (9, C, F_) or C % 64 or F_ % 64 or F_ > 512:
        raise ValueError(f'dcn backward kernel takes 3x3 taps, C%64==0, '
                         f'F%64==0 and F<=512; got taps={K} '
                         f'w={tuple(w.shape)}')
    if sy.dtype != torch.float32 or sx.dtype != torch.float32 \
            or mask.dtype != torch.float32 or w.dtype != x.dtype \
            or dy.dtype != x.dtype:
        raise TypeError('dcn backward kernel takes float32 sy/sx/mask, w '
                        'and dy in x.dtype')
    if sx.shape != sy.shape or mask.shape != sy.shape or sy.shape[0] != V \
            or dy.shape != (V, Ho, Wo, F_):
        raise ValueError('sy, sx, mask must be [V, Ho, Wo, 9], dy '
                         '[V, Ho, Wo, F]')
    x, sy, sx, mask, w, dy = (t.contiguous() for t in
                              (x, sy, sx, mask, w, dy))
    kernels.check_cuda(x, sy, sx, mask, w, dy)
    # split the pixels of the dw product so that its 64 x 64 tiles fill
    # the card about four times over; the splits' partials are summed
    N = V * Ho * Wo
    tiles = (9 * C // 64) * (F_ // 64)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = max(1, min(-(-4 * sms // tiles), -(-N // 512)))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.zeros((V, H, W, C), **f32)
    dsy, dsx, dm = (torch.empty_like(sy) for _ in range(3))
    dw = torch.empty((9, C, F_), **f32)
    part = torch.empty((splits, 9, C, F_) if splits > 1 else (1,), **f32)
    kernels.launch('mv2d_dcn_conv_bwd', x.data_ptr(), sy.data_ptr(),
                   sx.data_ptr(), mask.data_ptr(), w.data_ptr(),
                   dy.data_ptr(), dx.data_ptr(), dsy.data_ptr(),
                   dsx.data_ptr(), dm.data_ptr(), dw.data_ptr(),
                   part.data_ptr(), V, H, W, C, Ho, Wo, F_, splits,
                   kernels.dtype_code(x))
    dcn_conv_backward.launches += 1
    return dx, dsy, dsx, dm, dw


dcn_conv_backward.launches = 0


class DCNConvFn(torch.autograd.Function):
    """K2 forward, B13 backward (gradients to x, sy, sx, mask and w)."""

    @staticmethod
    def forward(ctx, x, sy, sx, mask, w):
        ctx.save_for_backward(x, sy, sx, mask, w)
        return dcn_conv(x, sy, sx, mask, w)

    @staticmethod
    def backward(ctx, dy):
        x, sy, sx, mask, w = ctx.saved_tensors
        dx, dsy, dsx, dm, dw = dcn_conv_backward(x, sy, sx, mask, w,
                                                 dy.to(x.dtype))
        return dx.to(x.dtype), dsy, dsx, dm, dw.to(w.dtype)


def dcn_conv_train(x, sy, sx, mask, w):
    """Differentiable DCN conv, the `fused_train` route.  CPU
    tensors take `dcn_conv_plain` (autograd); CUDA tensors run
    `DCNConvFn` (kernels K2 / B13)."""
    if x.device.type == 'cpu':
        return dcn_conv_plain(x, sy, sx, mask, w)
    return DCNConvFn.apply(x, sy, sx, mask, w)


class ModulatedDeformConv(tnn.Module):
    """mmcv ModulatedDeformConv2dPack (bias=False) key layout: weight
    [F, C, 3, 3] and conv_offset (3*9 outputs, zero-init)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 fused_train: bool = False):
        super().__init__()
        self.stride = stride
        self.fused_train = fused_train
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
            return dcn_conv(x, sy, sx, mask, w)
        if self.fused_train:
            return dcn_conv_train(x, sy, sx, mask, w)
        V, Ho, Wo, _ = sy.shape
        samples = dcn_samples(x, sy, sx, mask)
        y = samples.reshape(V * Ho * Wo, -1) @ w.reshape(-1, w.shape[-1])
        return y.reshape(V, Ho, Wo, -1)
