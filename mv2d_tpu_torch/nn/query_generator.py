"""Dynamic 3D query generation from 2D RoI features (center branch).

Port of `mv2d_tpu/nn/query_generator.py` in the shipped configuration:
shared 3x3 conv -> avg-pool -> shared FC -> concat flattened virtual
intrinsics (x0.1) -> 2-layer MLP -> fc_center (u, v, depth) -> analytic
unprojection to a lidar-frame reference point (float32).
"""
from __future__ import annotations

import torch
import torch.nn as tnn
import torch.nn.functional as F

from ..core.geometry import center2lidar
from .fpn import ConvModule
from .layers import linear


class QueryGenerator(tnn.Module):
    def __init__(self, in_channels: int = 256, conv_out_channels: int = 256,
                 fc_out_channels: int = 1024, extra_channels=(512, 256),
                 intrins_feat_scale: float = 0.1, clamp_value: float = 5e3):
        super().__init__()
        self.intrins_feat_scale = intrins_feat_scale
        self.clamp_value = clamp_value
        self.shared_convs = tnn.ModuleList(
            [ConvModule(in_channels, conv_out_channels, 3, 1)])
        self.shared_fcs = tnn.ModuleList(
            [tnn.Linear(conv_out_channels, fc_out_channels)])
        e0, e1 = extra_channels
        self.extra_enc = tnn.Sequential(
            tnn.Linear(fc_out_channels + 16, e0), tnn.ReLU(),
            tnn.Linear(e0, e1), tnn.ReLU())
        self.fc_center = tnn.Linear(e1, 3)
        tnn.init.normal_(self.fc_center.weight, std=0.001)
        tnn.init.zeros_(self.fc_center.bias)

    def forward(self, roi_feats, virtual_K, ext_t_inv, intrins_valid):
        """roi_feats [R, 7, 7, C]; virtual_K, ext_t_inv [R, 4, 4];
        intrins_valid [R] -> reference points [R, 3] (lidar frame)."""
        x = F.relu(self.shared_convs[0](roi_feats))
        x = F.relu(linear(x.mean(dim=(1, 2)), self.shared_fcs[0]))
        intr = virtual_K.reshape(-1, 16) * self.intrins_feat_scale
        intr = torch.where(intrins_valid[:, None], intr,
                           torch.zeros_like(intr))
        x = torch.cat([x, intr.to(x.dtype)], dim=-1)
        x = x.clamp(-self.clamp_value, self.clamp_value)
        x = self.extra_enc(x)
        uvd = self.fc_center(x)
        return center2lidar(uvd.float(), virtual_K.float(), ext_t_inv.float())
