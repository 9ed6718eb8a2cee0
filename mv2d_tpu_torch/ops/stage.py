"""Fused ResNet bottleneck chains with frozen BN folded: kernels K1, B10.

K1 (`fused_stage1`, `csrc/stage1.cu`) runs layer1 (three bottlenecks, width
64, block 0 with its projection) and replaces
`mv2d_tpu/ops/pallas_stage.py: fused_stage1`.  B10
(`fused_identity_chain`, `csrc/stage.cu`) runs the identity tail (blocks
1..n-1, width 128 or 256) of a later DCN-free stage and replaces
`pallas_stage.py: fused_identity_chain`; `nn.resnet` routes to it under
MV2D_FUSED_STAGES=all.  Both TPU kernels ran a whole chain as one
VMEM-resident call; each CUDA kernel runs one launch per bottleneck.

K1 in bfloat16 is a persistent kernel: one block per SM holds all of a
bottleneck's weights in shared memory and walks 8x16-pixel tiles whose
input arrives by TMA in a two-stage ring, with mma.sync products and
both intermediates on chip.  A launch must still read its input and write
its 256-channel output through device memory, so the chain of three is
bound by ~1.45 GB of traffic (0.43 ms on the H100) rather than by its
products (0.23 ms); `csrc/stage1.cu` says more.  It takes block 0 at Cin
64 (with the projection) and identity blocks at Cin 256; the float32
kernel (the parity tests) takes any Cin % 32 == 0.

B10 in bfloat16 carries K1's design over to weights too large to stay
resident (544 KB at width 128, 2.2 MB at 256): a persistent block per SM
walks 8x16 (width 128) or 4x16 (width 256) output tiles, and one TMA ring
brings the input's halo tile and 64-row chunks of the weights, streamed
from L2, in the order the wgmma products take them; both intermediates
stay in shared memory (`identity_block_plan` gives the tile and the
shared memory a block takes).

Block weights come folded (BN affine in the weights, float32), in the
layouts the kernels read: w1 [Cin, P], w2 [9, P, P] (tap-major, (dy, dx)
row-major), w3 [P, 4P], wd [Cin, 4P]; biases [P] or [4P].  `pack_block`
puts them in the kernel's dtypes (weights in the activation dtype, biases
float32); `nn.resnet` keeps layer1's packed blocks between forwards.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from .. import kernels

Block = Dict[str, torch.Tensor]


def _conv(x, w_io, b, k=1):
    """x [V, H, W, Cin] with weight [k*k, Cin, Cout] or [Cin, Cout]."""
    cin, cout = w_io.shape[-2], w_io.shape[-1]
    w = w_io.reshape(k, k, cin, cout).permute(3, 2, 0, 1).to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b.to(x.dtype), 1, k // 2)
    return y.permute(0, 2, 3, 1)


def bottleneck_plain(x: torch.Tensor, blk: Block) -> torch.Tensor:
    """One folded stride-1 bottleneck, unfused (the kernel's oracle)."""
    out = F.relu(_conv(x, blk['w1'], blk['b1']))
    out = F.relu(_conv(out, blk['w2'], blk['b2'], k=3))
    out = _conv(out, blk['w3'], blk['b3'])
    idt = _conv(x, blk['wd'], blk['bd']) if 'wd' in blk else x
    return F.relu(out + idt)


def pack_block(blk: Block, dtype: torch.dtype) -> Block:
    """A folded block in the kernels' dtypes: weights in `dtype` (the
    activations'), biases float32, contiguous.  A packed block packs to
    itself, with no copy."""
    return {k: v.to(dtype if k.startswith('w') else torch.float32)
            .contiguous() for k, v in blk.items()}


def bottleneck_cuda(x: torch.Tensor, blk: Block) -> torch.Tensor:
    V, H, W, cin = x.shape
    planes = blk['w1'].shape[1]
    if planes != 64 or cin % 32:
        raise ValueError(f'stage-1 kernel takes planes=64 and Cin%32==0, '
                         f'got planes={planes} Cin={cin}')
    if 'wd' not in blk and cin != 4 * planes:
        raise ValueError('identity bottleneck needs Cin == 4 * planes')
    if x.dtype == torch.bfloat16 and 'wd' in blk and cin != planes:
        raise ValueError(f'the bfloat16 stage-1 kernel takes its projection '
                         f'block at Cin == {planes}, got Cin={cin}')
    ws = pack_block(blk, x.dtype)
    kernels.check_cuda(x, *ws.values())
    out = torch.empty((V, H, W, 4 * planes), dtype=x.dtype, device=x.device)
    ptr = {k: v.data_ptr() for k, v in ws.items()}
    kernels.launch(
        'mv2d_bottleneck', x.data_ptr(), ptr['w1'], ptr['b1'], ptr['w2'],
        ptr['b2'], ptr['w3'], ptr['b3'], ptr.get('wd'), ptr.get('bd'),
        out.data_ptr(), V, H, W, cin, kernels.dtype_code(x))
    fused_stage1.launches += 1
    return out


def fused_stage1_plain(x: torch.Tensor, blocks: Sequence[Block]):
    for blk in blocks:
        x = bottleneck_plain(x, blk)
    return x


def fused_stage1(x: torch.Tensor, blocks: Sequence[Block]) -> torch.Tensor:
    """x [V, H, W, 64] (post-maxpool) -> [V, H, W, 256] through the layer1
    bottleneck chain (block 0 carries wd/bd).  CPU tensors take
    `fused_stage1_plain`; CUDA tensors take the kernel, one launch per
    bottleneck."""
    if x.device.type == 'cpu':
        return fused_stage1_plain(x, blocks)
    for blk in blocks:
        x = bottleneck_cuda(x.contiguous(), blk)
    return x


fused_stage1.launches = 0


IDENTITY_PLANES = (128, 256)


def identity_block_cuda(x: torch.Tensor, blk: Block) -> torch.Tensor:
    V, H, W, cin = x.shape
    planes = blk['w1'].shape[1]
    if planes not in IDENTITY_PLANES or cin != 4 * planes or 'wd' in blk:
        raise ValueError(f'identity-chain kernel takes planes 128 or 256, '
                         f'Cin == 4 * planes and no projection; got '
                         f'planes={planes} Cin={cin}')
    ws = pack_block(blk, x.dtype)
    kernels.check_cuda(x, *ws.values())
    out = torch.empty_like(x)
    kernels.launch(
        'mv2d_identity_block', x.data_ptr(), ws['w1'].data_ptr(),
        ws['b1'].data_ptr(), ws['w2'].data_ptr(), ws['b2'].data_ptr(),
        ws['w3'].data_ptr(), ws['b3'].data_ptr(), out.data_ptr(), V, H, W,
        planes, kernels.dtype_code(x))
    fused_identity_chain.launches += 1
    return out


def identity_block_plan(planes: int):
    """B10's bfloat16 tiling at width `planes` (128 or 256): (output tile
    rows, output tile columns, shared-memory bytes a block), from the
    kernel's own constants."""
    return (kernels.workspace_bytes('mv2d_identity_block_tile_rows', planes),
            16, kernels.workspace_bytes('mv2d_identity_block_smem', planes))


# B10's oracle is the same unfused chain of folded bottlenecks as K1's
fused_identity_chain_plain = fused_stage1_plain


def fused_identity_chain(x: torch.Tensor,
                         blocks: Sequence[Block]) -> torch.Tensor:
    """x [V, H, W, 4P] -> same shape through stride-1 identity bottlenecks
    (no wd/bd), P = 128 or 256.  CPU tensors take
    `fused_identity_chain_plain`; CUDA tensors take kernel B10, one launch
    per bottleneck."""
    if x.device.type == 'cpu':
        return fused_identity_chain_plain(x, blocks)
    for blk in blocks:
        x = identity_block_cuda(x.contiguous(), blk)
    return x


fused_identity_chain.launches = 0
