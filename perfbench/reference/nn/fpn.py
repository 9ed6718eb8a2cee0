"""Feature Pyramid Network (mmdet semantics, channels-last).

Port of `mv2d_tpu/nn/fpn.py`: the detector FPN (p2..p6, p6 = stride-2
subsample of p5) and the p4-selecting neck (start_level = end_level = 2).
Keys follow mmdet: lateral_convs.{i}.conv, fpn_convs.{i}.conv.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as tnn

from .layers import conv2d_nhwc


class ConvModule(tnn.Module):
    """mmcv ConvModule without norm/activation (key prefix '.conv')."""

    def __init__(self, cin: int, cout: int, k: int, padding: int = 0):
        super().__init__()
        self.conv = tnn.Conv2d(cin, cout, k, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x, self.conv.weight, self.conv.bias, 1,
                           self.conv.padding[0])


def _upsample_nearest_2x(x: torch.Tensor, like: torch.Tensor):
    th, tw = like.shape[1], like.shape[2]
    x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return x[:, :th, :tw]


class FPN(tnn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, start_level: int = 0,
                 end_level: int = -1):
        super().__init__()
        end = end_level if end_level >= 0 else len(in_channels) - 1
        self.used = list(range(start_level, end + 1))
        self.num_outs = num_outs
        self.lateral_convs = tnn.ModuleList(
            [ConvModule(in_channels[i], out_channels, 1) for i in self.used])
        self.fpn_convs = tnn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, 1) for _ in self.used])

    def forward(self, inputs: Sequence[torch.Tensor]):
        lat = [m(inputs[i]) for m, i in zip(self.lateral_convs, self.used)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + _upsample_nearest_2x(lat[i], lat[i - 1])
        outs = [m(x) for m, x in zip(self.fpn_convs, lat)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, ::2, ::2])
        return tuple(outs[:self.num_outs])
