"""ResNet-50/101 backbone ('pytorch' style, frozen BN, optional DCNv2).

Port of `mv2d_tpu/nn/resnet.py` with mmdet's state-dict keys (conv1, bn1,
layer{s}.{b}.conv{1,2,3}/bn{1,2,3}/downsample.{0,1}).  Frozen BN folds
into each conv; the DCN conv keeps its separate BN.  Layer1 runs through
`ops.stage.fused_stage1` (kernel K1 on CUDA).  The stem is the plain
7x7/s2 conv.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as tnn
import torch.nn.functional as F

from ..ops.dcn import ModulatedDeformConv
from ..ops.stage import fused_stage1
from .layers import FrozenBatchNorm2d, conv2d_nhwc, max_pool_3x3_s2

STAGE_BLOCKS = {
    10: (1, 1, 1, 1),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}


def _folded_conv(x, conv: tnn.Conv2d, bn: FrozenBatchNorm2d, stride=1):
    s, b = bn.fold()
    k = conv.weight.shape[-1]
    return conv2d_nhwc(x, conv.weight.float() * s[:, None, None, None], b,
                       stride, k // 2)


class Bottleneck(tnn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, use_dcn: bool = False):
        super().__init__()
        self.stride = stride
        self.use_dcn = use_dcn
        self.conv1 = tnn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        if use_dcn:
            self.conv2 = ModulatedDeformConv(planes, planes, stride)
        else:
            self.conv2 = tnn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = tnn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = tnn.Sequential(
            tnn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
            FrozenBatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(_folded_conv(x, self.conv1, self.bn1))
        if self.use_dcn:
            out = self.bn2(self.conv2(out))
        else:
            out = _folded_conv(out, self.conv2, self.bn2, self.stride)
        out = F.relu(out)
        out = _folded_conv(out, self.conv3, self.bn3)
        idt = x if self.downsample is None else _folded_conv(
            x, self.downsample[0], self.downsample[1], self.stride)
        return F.relu(out + idt)

    def folded(self) -> Dict[str, torch.Tensor]:
        """Folded float32 weights in the stage kernel's layouts."""
        def io(conv, bn):
            s, b = bn.fold()
            w = conv.weight.float() * s[:, None, None, None]   # [O, I, k, k]
            return w.permute(2, 3, 1, 0).reshape(-1, w.shape[1],
                                                 w.shape[0]), b
        w1, b1 = io(self.conv1, self.bn1)
        w2, b2 = io(self.conv2, self.bn2)
        w3, b3 = io(self.conv3, self.bn3)
        blk = dict(w1=w1[0], b1=b1, w2=w2, b2=b2, w3=w3[0], b3=b3)
        if self.downsample is not None:
            wd, bd = io(self.downsample[0], self.downsample[1])
            blk.update(wd=wd[0], bd=bd)
        return blk


class ResNet(tnn.Module):
    """[V, H, W, 3] -> the four stage outputs (strides 4, 8, 16, 32)."""

    def __init__(self, depth: int = 50,
                 stage_with_dcn: Tuple[bool, ...] = (False,) * 4):
        super().__init__()
        self.stage_with_dcn = tuple(stage_with_dcn)
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        inplanes, planes = 64, 64
        for s, n in enumerate(STAGE_BLOCKS[depth]):
            stride = 1 if s == 0 else 2
            blocks = [Bottleneck(inplanes if i == 0 else planes * 4, planes,
                                 stride if i == 0 else 1, downsample=(i == 0),
                                 use_dcn=self.stage_with_dcn[s])
                      for i in range(n)]
            setattr(self, f'layer{s + 1}', tnn.Sequential(*blocks))
            inplanes = planes * 4
            planes *= 2

    def forward(self, x: torch.Tensor):
        x = F.relu(_folded_conv(x, self.conv1, self.bn1, stride=2))
        x = max_pool_3x3_s2(x)
        outs = []
        for s in range(4):
            layer = getattr(self, f'layer{s + 1}')
            if s == 0 and not self.stage_with_dcn[0]:
                x = fused_stage1(x, [blk.folded() for blk in layer])
            else:
                x = layer(x)
            outs.append(x)
        return tuple(outs)
