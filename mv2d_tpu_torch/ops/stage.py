"""ResNet layer1 (three bottlenecks) with frozen BN folded: kernel K1.

Replaces `mv2d_tpu/ops/pallas_stage.py: fused_stage1` (`_run_chain`,
`_kernel`), which runs layer1 of the backbone as one VMEM-resident chain.
The CUDA kernel (`csrc/stage1.cu`) runs one launch per bottleneck; see the
note there for what bounds it on the H100.

Block weights come folded (BN affine in the weights, float32; the kernel
takes them in the activation dtype), in the layouts the kernel reads: w1 [Cin, P], w2 [9, P, P] (tap-major, (dy, dx)
row-major), w3 [P, 4P], wd [Cin, 4P]; biases [P] or [4P].
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


def bottleneck_cuda(x: torch.Tensor, blk: Block) -> torch.Tensor:
    V, H, W, cin = x.shape
    planes = blk['w1'].shape[1]
    if planes != 64 or cin % 32:
        raise ValueError(f'stage-1 kernel takes planes=64 and Cin%32==0, '
                         f'got planes={planes} Cin={cin}')
    if 'wd' not in blk and cin != 4 * planes:
        raise ValueError('identity bottleneck needs Cin == 4 * planes')
    # biases float32; weights float32, or bfloat16 for the tensor-core path
    ws = {k: v.to(x.dtype if k.startswith('w') else torch.float32)
          .contiguous() for k, v in blk.items()}
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
