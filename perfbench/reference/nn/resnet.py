"""ResNet-50/101 backbone ('pytorch' style, frozen BN, optional DCNv2).

Port of `mv2d_tpu/nn/resnet.py` with mmdet's state-dict keys (conv1, bn1,
layer{s}.{b}.conv{1,2,3}/bn{1,2,3}/downsample.{0,1}).  Frozen BN folds into
each conv; the DCN conv keeps its separate BN.  The stem is the plain
7x7/s2 conv.  A DCN-free layer1 runs through `ops.stage.fused_stage1`
(kernel K1 on CUDA) on folded blocks kept between forwards, folded again
only when a layer1 tensor changed.  Stage routing follows the JAX package's
MV2D_FUSED_STAGES (`routes.Routes.fused_stages`): with 'all', the identity
tail of a later stage that `fuses_tail` admits runs through
`ops.stage.fused_identity_chain` (kernel B10) while no gradient is recorded
(JAX's fast_inference).  `Routes.dcn_train_fused` goes to each DCN conv.
The stem and layer1 are always frozen: their parameters, like every BN
affine, do not train (the JAX optimizer's rule, whatever frozen_stages
says), and they run without recording gradients.  frozen_stages = k >= 2
(the reference's `_freeze_stages`) also freezes layers 2..k: they run
without recording gradients, so they take the forward-only routes (K2
for a DCN layer, B10 for a tail under 'all'), and their parameters stay
out of the optimizer.  With remat, each trainable Bottleneck's
activations are recomputed in the backward (`layers.rematerialized`).
`out_indices` picks the stage outputs returned.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as tnn
import torch.nn.functional as F

from ..ops.dcn import ModulatedDeformConv
from ..routes import Routes
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
                 downsample: bool = False, use_dcn: bool = False,
                 dcn_train_fused: bool = False):
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


class ResNet(tnn.Module):
    """[V, H, W, 3] -> the stage outputs of `out_indices` (strides 4, 8,
    16, 32)."""

    def __init__(self, depth: int = 50,
                 stage_with_dcn: Tuple[bool, ...] = (False,) * 4,
                 routes: Routes = Routes(), frozen_stages: int = 1,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 remat: bool = False):
        super().__init__()
        self.stage_with_dcn = tuple(stage_with_dcn)
        self.fused_stages = routes.fused_stages
        self.frozen = max(frozen_stages, 1)        # stages under no_grad
        self.out_indices = tuple(out_indices)
        self.remat = remat
        self.out_channels = tuple(c for i, c in enumerate(
            (256, 512, 1024, 2048)) if i in self.out_indices)
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        inplanes, planes = 64, 64
        for s, n in enumerate(STAGE_BLOCKS[depth]):
            stride = 1 if s == 0 else 2
            blocks = [Bottleneck(inplanes if i == 0 else planes * 4, planes,
                                 stride if i == 0 else 1, downsample=(i == 0),
                                 use_dcn=self.stage_with_dcn[s],
                                 dcn_train_fused=routes.dcn_train_fused)
                      for i in range(n)]
            setattr(self, f'layer{s + 1}', tnn.Sequential(*blocks))
            inplanes = planes * 4
            planes *= 2
        for m in (self.conv1, self.bn1,
                  *(getattr(self, f'layer{i + 1}')
                    for i in range(min(self.frozen, 4)))):
            m.requires_grad_(False)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """The 7x7/2 conv with its folded BN and ReLU, then the 3x3/2 max
        pool."""
        return max_pool_3x3_s2(F.relu(_folded_conv(x, self.conv1, self.bn1,
                                                   stride=2)))

    def _stage(self, s: int, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, f'layer{s + 1}')
        return layer(x)

    def forward(self, x: torch.Tensor):
        outs = []
        with torch.no_grad():                      # frozen stem + layer1
            x = self.stem(x)
            x = self.layer1(x)
        if 0 in self.out_indices:
            outs.append(x)
        for s in range(1, max(self.out_indices) + 1):
            if s < self.frozen:
                with torch.no_grad():
                    x = self._stage(s, x)
            else:
                x = self._stage(s, x)
            if s in self.out_indices:
                outs.append(x)
        return tuple(outs)
