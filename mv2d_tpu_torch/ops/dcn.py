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
replacing `pallas_dcn.py: _run_conv_bwd`) as one combined backward: the
forward saves no samples, and B13 recomputes them inside its dw product.
B13 forms the sample gradients on the tensor cores into a transient
workspace and hands them to B6's owners' walk inside its own C entry, so
B6's wrapper is not called on that route.

Sampling coordinates are built in float32 for every activation dtype.
"""
from __future__ import annotations

import functools

import torch
import torch.nn as tnn

from .. import kernels
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


# B6's owners: 2 x 2 pixel blocks of dx
OWNER_SIDE = 2


def _sample_views(sy):
    """The view of each flat sample of sy [V, Ho, Wo, 9]."""
    return torch.arange(sy.shape[0], device=sy.device).repeat_interleave(
        sy[0].numel())


def owner_blocks_plain(sy, sx, H: int, W: int):
    """B6's index pass.  sy, sx [V, Ho, Wo, 9] -> (keys [M], samples [M],
    starts [nkeys + 1]): every sample inside the map (-1, extent) has one
    entry for each distinct 2 x 2 owner block among its four clamped
    corners (block key (v * Hb + y // 2) * Wb + x // 2, Hb = ceil(H / 2),
    Wb = ceil(W / 2)), all four corners counted: the coordinate
    derivative reads x at a corner whose dx weight is 0.  Entries are
    sorted by key, ties in sample order (the kernel's stable radix sort);
    block k's entries are [starts[k], starts[k + 1])."""
    V = sy.shape[0]
    Hb, Wb = -(-H // OWNER_SIDE), -(-W // OWNER_SIDE)
    view = _sample_views(sy)
    sy, sx = sy.reshape(-1), sx.reshape(-1)
    NP = sy.numel()
    inside, rows, cols, _, _, _ = _sample_corners(sy, sx, H, W)
    blk = (view[:, None] * Hb + rows // OWNER_SIDE) * Wb \
        + cols // OWNER_SIDE
    first = torch.ones_like(blk, dtype=torch.bool)
    for q in range(1, 4):
        first[:, q] = (blk[:, q:q + 1] != blk[:, :q]).all(-1)
    keep = (first & inside[:, None]).reshape(-1)
    keys = blk.reshape(-1)[keep]
    samples = torch.arange(4 * NP, device=sy.device)[keep] // 4
    order = torch.sort(keys, stable=True).indices
    keys, samples = keys[order], samples[order]
    starts = torch.searchsorted(
        keys, torch.arange(V * Hb * Wb + 1, device=sy.device))
    return keys, samples, starts


def dcn_samples_backward_plain(x, sy, sx, mask, dsamples):
    """B6's function by its owner scheme in plain PyTorch: the entries of
    `owner_blocks_plain` give dx (each entry adds w_q m ds to the corners
    of its sample inside its block) and the corner dots ds . x_q, from
    which dm, dsy and dsx follow.  Returns what `dcn_samples_backward`
    does: dx in x.dtype, dsy, dsx, dm float32."""
    V, H, W, C = x.shape
    NP = sy.numel()
    keys, samples, _ = owner_blocks_plain(sy, sx, H, W)
    fy, fx, fm = sy.reshape(-1), sx.reshape(-1), mask.reshape(-1)
    inside, rows, cols, w, ly, lx = _sample_corners(fy, fx, H, W)
    Hb, Wb = -(-H // OWNER_SIDE), -(-W // OWNER_SIDE)
    view = _sample_views(sy)
    r, c, s = rows[samples], cols[samples], samples
    # which of the entry's sample corners lie in the entry's block
    mine = (view[s, None] * Hb + r // OWNER_SIDE) * Wb \
        + c // OWNER_SIDE == keys[:, None]
    pix = (view[s, None] * H + r) * W + c                       # [M, 4]
    g = dsamples.reshape(NP, C).float()[s]                      # [M, C]
    flat = x.reshape(-1, C).float()
    wgt = w[s] * fm[s, None] * mine
    dx = torch.zeros((V * H * W, C), dtype=torch.float32, device=x.device)
    dx.index_add_(0, pix.reshape(-1),
                  (wgt[..., None] * g[:, None, :]).reshape(-1, C))
    dots = torch.zeros((NP, 4), dtype=torch.float32, device=x.device)
    d = torch.einsum('mc,mqc->mq', g, flat[pix])
    dots.index_put_((s[:, None].expand_as(pix)[mine], torch.arange(
        4, device=x.device).expand_as(pix)[mine]), d[mine])
    d0, d1, d2, d3 = dots.unbind(-1)
    gy = ((fy >= 0) & (fy <= H - 1)).float()
    gx = ((fx >= 0) & (fx <= W - 1)).float()
    dm = (w * dots).sum(-1) * inside
    dsy = ((1 - lx) * (d2 - d0) + lx * (d3 - d1)) * fm * gy * inside
    dsx = ((1 - ly) * (d1 - d0) + ly * (d3 - d2)) * fm * gx * inside
    shape = sy.shape
    return (dx.reshape(V, H, W, C).to(x.dtype), dsy.reshape(shape),
            dsx.reshape(shape), dm.reshape(shape))


def dcn_samples_backward(x, sy, sx, mask, dsamples):
    """Kernel B6: dsamples [V, Ho, Wo, 9, C] (x.dtype) -> (dx [V, H, W, C]
    in x.dtype, dsy, dsx, dmask [V, Ho, Wo, 9] float32).  Every dx element
    is written once, by its owner, from a float32 sum in a fixed order, so
    two runs give equal bits.  CPU tensors take
    `dcn_samples_backward_plain`; CUDA tensors launch the kernels (float32
    or bfloat16, C % 8 == 0, a non-empty map, 36 V Ho Wo below 2^31; any
    other shape raises)."""
    if x.device.type == 'cpu':
        return dcn_samples_backward_plain(x, sy, sx, mask, dsamples)
    _check_samples_args(x, sy, sx, mask)
    V, H, W, C = x.shape
    _, Ho, Wo, K = sy.shape
    if dsamples.shape != (V, Ho, Wo, K, C) or dsamples.dtype != x.dtype:
        raise ValueError('dsamples must be [V, Ho, Wo, 9, C] in x.dtype')
    if H == 0 or W == 0 or 36 * V * Ho * Wo + 512 >= 2 ** 31 \
            or V * H * W * C >= 2 ** 31:
        raise ValueError('dcn samples backward takes a non-empty map and '
                         f'fewer than 2^31 entries; got x {tuple(x.shape)}, '
                         f'{Ho}x{Wo} samples')
    x, sy, sx, mask, dsamples = (t.contiguous() for t in
                                 (x, sy, sx, mask, dsamples))
    kernels.check_cuda(x, sy, sx, mask, dsamples)
    code = kernels.dtype_code(x)
    dx = torch.empty_like(x)
    dsy, dsx, dm = torch.empty((3, *sy.shape), dtype=torch.float32,
                               device=x.device)
    work = torch.empty(_b6_workspace(V, H, W, C, Ho, Wo, code),
                       dtype=torch.uint8, device=x.device)
    kernels.launch('mv2d_dcn_samples_bwd', x.data_ptr(), sy.data_ptr(),
                   sx.data_ptr(), mask.data_ptr(), dsamples.data_ptr(),
                   dx.data_ptr(), dsy.data_ptr(), dsx.data_ptr(),
                   dm.data_ptr(), work.data_ptr(), V, H, W, C, Ho, Wo, code)
    dcn_samples_backward.launches += 1
    return dx, dsy, dsx, dm


dcn_samples_backward.launches = 0


@functools.lru_cache(maxsize=64)
def _b6_workspace(*sizes) -> int:
    """B6's scratch bytes at (V, H, W, C, Ho, Wo, dtype code)."""
    return kernels.workspace_bytes('mv2d_dcn_samples_bwd_workspace', *sizes)


class DCNSamplesFn(torch.autograd.Function):
    """B5 forward, B6 backward (gradients to x, sy, sx and mask)."""

    @staticmethod
    def forward(ctx, x, sy, sx, mask):
        ctx.save_for_backward(x, sy, sx, mask)
        return dcn_samples_forward(x, sy, sx, mask)

    @staticmethod
    def backward(ctx, dsamples):
        x, sy, sx, mask = ctx.saved_tensors
        return dcn_samples_backward(x, sy, sx, mask, dsamples.to(x.dtype))


def dcn_samples(x, sy, sx, mask):
    """Differentiable masked bilinear samples [V, Ho, Wo, 9, C].  CPU
    tensors take `dcn_samples_plain` (autograd); CUDA tensors run
    `DCNSamplesFn` (kernels B5 / B6)."""
    if x.device.type == 'cpu':
        return dcn_samples_plain(x, sy, sx, mask)
    return DCNSamplesFn.apply(x, sy, sx, mask)


def dcn_conv_backward_plain(x, sy, sx, mask, w, dy):
    """B13's function composed as its kernels compose it, in plain
    PyTorch: ds = dy w^T (float32 sums, rounded to x.dtype as the kernel
    writes its workspace), dx / dsy / dsx / dm from ds by B6's owner scheme
    (`dcn_samples_backward_plain`), and dw = samples^T dy from the samples
    rounded as the forward rounds them, summed in float32.  Returns what
    `dcn_conv_backward` does: dx in x.dtype, dsy, dsx, dmask float32, dw in
    w.dtype."""
    V, Ho, Wo, K = sy.shape
    C, F_ = w.shape[1], w.shape[2]
    N = V * Ho * Wo
    g = dy.reshape(N, F_).float()
    ds = (g @ w.reshape(K * C, F_).float().t()).to(x.dtype)
    dx, dsy, dsx, dm = dcn_samples_backward_plain(
        x, sy, sx, mask, ds.reshape(V, Ho, Wo, K, C))
    smp = dcn_samples_plain(x, sy, sx, mask).reshape(N, K * C).float()
    dw = (smp.t() @ g).reshape(K, C, F_).to(w.dtype)
    return dx, dsy, dsx, dm, dw


def dcn_conv_backward(x, sy, sx, mask, w, dy):
    """Kernel B13: the VJP of `dcn_conv` at dy [V, Ho, Wo, F] (x.dtype) ->
    (dx [V, H, W, C] in x.dtype, dsy, dsx, dmask [V, Ho, Wo, 9] float32,
    dw [9, C, F] in w.dtype).  ds = dy w^T and dw run on the tensor cores
    in bfloat16 (FMAs in float32); dx, dsy, dsx and dm come from ds by B6's
    owners' walk inside the same C entry, so every dx and dw element is
    written once, from float32 sums in a fixed order: two runs give equal
    bits.  The derivatives follow B6's conventions (floor form; zero where
    a coordinate was clamped).  CPU tensors take `dcn_conv_backward_plain`;
    CUDA tensors launch the kernels (3x3 taps, C % 64 == 0, F % 64 == 0,
    F <= 512, a non-empty map; any other shape raises)."""
    if x.device.type == 'cpu':
        return dcn_conv_backward_plain(x, sy, sx, mask, w, dy)
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
    if H == 0 or W == 0 or 36 * V * Ho * Wo + 512 >= 2 ** 31 \
            or V * H * W * C >= 2 ** 31:
        raise ValueError('dcn backward kernel takes a non-empty map and '
                         f'fewer than 2^31 entries; got x {tuple(x.shape)}, '
                         f'{Ho}x{Wo} samples')
    x, sy, sx, mask, w, dy = (t.contiguous() for t in
                              (x, sy, sx, mask, w, dy))
    kernels.check_cuda(x, sy, sx, mask, w, dy)
    code = kernels.dtype_code(x)
    dx = torch.empty_like(x)
    dsy, dsx, dm = torch.empty((3, *sy.shape), dtype=torch.float32,
                               device=x.device)
    dw = torch.empty_like(w)
    work = torch.empty(conv_backward_workspace(V, H, W, C, Ho, Wo, F_, code),
                       dtype=torch.uint8, device=x.device)
    kernels.launch('mv2d_dcn_conv_bwd', x.data_ptr(), sy.data_ptr(),
                   sx.data_ptr(), mask.data_ptr(), w.data_ptr(),
                   dy.data_ptr(), dx.data_ptr(), dsy.data_ptr(),
                   dsx.data_ptr(), dm.data_ptr(), dw.data_ptr(),
                   work.data_ptr(), V, H, W, C, Ho, Wo, F_, code)
    dcn_conv_backward.launches += 1
    return dx, dsy, dsx, dm, dw


dcn_conv_backward.launches = 0


@functools.lru_cache(maxsize=64)
def conv_backward_workspace(*sizes) -> int:
    """B13's transient bytes at (V, H, W, C, Ho, Wo, F, dtype code): ds
    [N, 9C] in x's dtype, B6's workspace and dw's split partials."""
    return kernels.workspace_bytes('mv2d_dcn_conv_bwd_workspace', *sizes)


class DCNConvFn(torch.autograd.Function):
    """K2 forward, B13 backward (gradients to x, sy, sx, mask and w, each
    in its input's dtype as B13 returns it)."""

    @staticmethod
    def forward(ctx, x, sy, sx, mask, w):
        ctx.save_for_backward(x, sy, sx, mask, w)
        return dcn_conv(x, sy, sx, mask, w)

    @staticmethod
    def backward(ctx, dy):
        return dcn_conv_backward(*ctx.saved_tensors, dy)


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
