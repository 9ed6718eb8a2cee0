"""VoVNetV2 backbone with eSE (VoVNetCP in the reference), channels-last.

Port of `mv2d_tpu/nn/vovnet.py`: a three-conv stem, then four stages of
One-Shot-Aggregation blocks (N successive 3x3 ConvBNs whose outputs are
concatenated with the block's input into a 1x1 ConvBN, gated by the
effective squeeze-excitation, with an identity residual on every block
but a stage's first), a 3x3 stride-2 max pool before stages 3-5.

Module names are the reference's VoVNetCP names, which hold '/'
(torch forbids only '.' in a module's name), so the state dict carries
its keys as they are: 'stem.stem_1/conv.weight',
'stage3.OSA3_2.layers.0.OSA3_2_0/norm.running_mean',
'stage3.OSA3_2.concat.OSA3_2_concat/conv.weight',
'stage3.OSA3_2.ese.fc.bias' (stems and blocks 1-indexed).  BN is frozen
and folds into its conv.  The stem and every BN affine do not train (the
JAX optimizer's rule: backbone leaves under 'stem' or '/bn'); the stem
runs without recording gradients.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as tnn
import torch.nn.functional as F

from .layers import FrozenBatchNorm2d, conv2d_nhwc, max_pool_3x3_s2

# stem chs, stage conv ch, stage out ch, layers/block, blocks/stage
SPECS = {
    19: ((64, 64, 128), (128, 160, 192, 224), (256, 512, 768, 1024), 3,
         (1, 1, 1, 1)),
    39: ((64, 64, 128), (128, 160, 192, 224), (256, 512, 768, 1024), 5,
         (1, 1, 2, 2)),
    57: ((64, 64, 128), (128, 160, 192, 224), (256, 512, 768, 1024), 5,
         (1, 1, 4, 3)),
    99: ((64, 64, 128), (128, 160, 192, 224), (256, 512, 768, 1024), 5,
         (1, 3, 9, 3)),
}


class ConvBNs(tnn.Module):
    """A chain of conv (no bias) -> frozen BN -> relu, each registered as
    the reference's '{name}/conv', '{name}/norm' pair."""

    def __init__(self, specs):
        """specs: (name, cin, cout, kernel, stride) per conv, in order."""
        super().__init__()
        self.specs = [(name, stride, k // 2)
                      for name, _, _, k, stride in specs]
        for name, cin, cout, k, stride in specs:
            self.add_module(f'{name}/conv', tnn.Conv2d(
                cin, cout, k, stride, k // 2, bias=False))
            self.add_module(f'{name}/norm', FrozenBatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name, stride, pad in self.specs:
            s, b = getattr(self, f'{name}/norm').fold()
            w = getattr(self, f'{name}/conv').weight.float() \
                * s[:, None, None, None]
            x = F.relu(conv2d_nhwc(x, w, b, stride, pad))
        return x


def _hsigmoid(x):
    return F.relu6(x + 3.0) / 6.0


class ESE(tnn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.fc = tnn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean((1, 2), keepdim=True).to(x.dtype)
        w = self.fc.weight
        s = F.linear(s, w.reshape(w.shape[0], w.shape[1]).to(x.dtype),
                     self.fc.bias.to(x.dtype))
        return x * _hsigmoid(s)


class OSABlock(tnn.Module):
    def __init__(self, name: str, cin: int, conv_ch: int, out_ch: int,
                 num_layers: int, identity: bool):
        super().__init__()
        self.identity = identity and cin == out_ch
        self.layers = tnn.ModuleList([
            ConvBNs([(f'{name}_{i}', cin if i == 0 else conv_ch, conv_ch,
                      3, 1)]) for i in range(num_layers)])
        self.concat = ConvBNs([(f'{name}_concat',
                                cin + num_layers * conv_ch, out_ch, 1, 1)])
        self.ese = ESE(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        y = x
        for layer in self.layers:
            y = layer(y)
            feats.append(y)
        y = self.ese(self.concat(torch.cat(feats, -1)))
        return y + x if self.identity else y


class VoVNet(tnn.Module):
    """[V, H, W, 3] -> the four stage outputs (strides 4, 8, 16, 32)."""

    def __init__(self, depth: int = 99):
        super().__init__()
        stem_ch, conv_ch, out_ch, n_layers, blocks = SPECS[depth]
        self.out_channels: Tuple[int, ...] = tuple(out_ch)
        self.stem = ConvBNs([
            (f'stem_{i + 1}', cin, c, 3, s) for i, (cin, c, s) in
            enumerate(zip((3,) + stem_ch[:2], stem_ch, (2, 1, 2)))])
        cin = stem_ch[-1]
        for s in range(4):
            st = s + 2
            stage = tnn.Module()
            for b in range(blocks[s]):
                stage.add_module(f'OSA{st}_{b + 1}', OSABlock(
                    f'OSA{st}_{b + 1}', cin, conv_ch[s], out_ch[s],
                    n_layers, identity=b > 0))
                cin = out_ch[s]
            setattr(self, f'stage{st}', stage)
        self.stem.requires_grad_(False)

    def forward(self, x: torch.Tensor):
        with torch.no_grad():                      # the frozen stem
            x = self.stem(x)
        outs = []
        for s in range(4):
            if s > 0:
                x = max_pool_3x3_s2(x)
            for block in getattr(self, f'stage{s + 2}').children():
                x = block(x)
            outs.append(x)
        return tuple(outs)
