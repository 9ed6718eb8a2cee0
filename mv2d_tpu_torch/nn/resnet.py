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

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as tnn
import torch.nn.functional as F

from ..ops.dcn import ModulatedDeformConv
from ..ops.stage import fused_identity_chain, fused_stage1, pack_block
from ..routes import Routes
from .layers import (FrozenBatchNorm2d, conv2d_nhwc, max_pool_3x3_s2,
                     rematerialized)

STAGE_BLOCKS = {
    10: (1, 1, 1, 1),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}


def fuses_tail(stage: int, n_blocks: int, h_in: int, w_in: int,
               with_dcn: bool, mode: str) -> bool:
    """Whether blocks 1..n-1 of `stage` (input map h_in x w_in) run as one
    fused identity chain: `mv2d_tpu/nn/resnet.py`'s can_fuse for a stage
    after layer1 (its stride-2 block 0 stays plain)."""
    return (mode == 'all' and stage > 0 and not with_dcn and n_blocks > 1
            and (h_in // 2) % 32 == 0 and w_in // 2 >= 24)


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
            self.conv2 = ModulatedDeformConv(planes, planes, stride,
                                             fused_train=dcn_train_fused)
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
        self._layer1_packed = None      # (dtype, tensors seen, blocks)

    def layer1_blocks(self, dtype: torch.dtype):
        """layer1's folded blocks in K1's layouts and dtypes (weights in
        `dtype`), folded once and again only after a parameter or buffer of
        layer1 changed: `load_state_dict` and in-place edits bump a tensor's
        version, `.to()` and reassignment replace its storage.  The stored
        views keep the old storages alive, so a new one cannot reuse their
        addresses.  An in-place edit through `.data` (`p.data.mul_(a)`)
        bumps no version PyTorch keeps and moves no storage, so it is not
        seen: edit without `.data` (under `torch.no_grad()`), or load the
        state again (`net.load_state_dict(net.state_dict())`).

        Under `torch.export` the blocks are folded inside the traced graph
        from layer1's parameters and buffers, and the cache is neither read
        nor written (its checks read storage addresses, which a traced
        tensor has not)."""
        if torch.compiler.is_exporting():
            return [pack_block(blk.folded(), dtype) for blk in self.layer1]
        now = [t.detach() for t in (*self.layer1.parameters(),
                                    *self.layer1.buffers())]
        seen = self._layer1_packed
        if seen is None or seen[0] != dtype or len(seen[1]) != len(now) or any(
                t.data_ptr() != s.data_ptr() or t._version != v
                for t, (s, v) in zip(now, seen[1])):
            blocks = [pack_block(blk.folded(), dtype) for blk in self.layer1]
            seen = (dtype, [(t, t._version) for t in now], blocks)
            self._layer1_packed = seen
        return seen[2]

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """The 7x7/2 conv with its folded BN and ReLU, then the 3x3/2 max
        pool."""
        return max_pool_3x3_s2(F.relu(_folded_conv(x, self.conv1, self.bn1,
                                                   stride=2)))

    def _stage(self, s: int, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, f'layer{s + 1}')
        if not torch.is_grad_enabled():
            if fuses_tail(s, len(layer), x.shape[1], x.shape[2],
                          self.stage_with_dcn[s], self.fused_stages):
                return fused_identity_chain(
                    layer[0](x), [blk.folded() for blk in layer[1:]])
            return layer(x)
        for blk in layer:
            x = rematerialized(blk, x) if self.remat else blk(x)
        return x

    def forward(self, x: torch.Tensor):
        outs = []
        with torch.no_grad():                      # frozen stem + layer1
            x = self.stem(x)
            if not self.stage_with_dcn[0]:
                x = fused_stage1(x, self.layer1_blocks(x.dtype))
            else:
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
