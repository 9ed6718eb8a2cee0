"""Dynamic 3D query generation from 2D RoI features.

Port of `mv2d_tpu/nn/query_generator.py`: shared 3x3 conv -> avg-pool ->
shared FC -> concat flattened virtual intrinsics (x0.1) -> 2-layer MLP ->
per-branch fc stacks -> fc_center (u, v, depth) -> analytic unprojection
to a lidar-frame reference point (float32).  The auxiliary branches (cls,
size, heading, attr) are off in every shipped config; each has its own fc
stack `{branch}_fcs.{i}` and predictor `fc_{branch}`, as the centre
branch has.
"""
from __future__ import annotations

import torch
import torch.nn as tnn
import torch.nn.functional as F

from ..core.geometry import center2lidar
from .fpn import ConvModule
from .layers import linear

BRANCHES = ('cls', 'size', 'heading', 'center', 'attr')


class QueryGenerator(tnn.Module):
    def __init__(self, in_channels: int = 256, conv_out_channels: int = 256,
                 fc_out_channels: int = 1024, extra_channels=(512, 256),
                 intrins_feat_scale: float = 0.1, clamp_value: float = 5e3,
                 num_classes: int = 10, with_cls: bool = False,
                 with_size: bool = False, with_heading: bool = False,
                 with_attr: bool = False, attr_dim: int = 2,
                 reg_class_agnostic: bool = False,
                 num_cls_convs: int = 0, num_cls_fcs: int = 0,
                 num_size_convs: int = 0, num_size_fcs: int = 0,
                 num_heading_convs: int = 0, num_heading_fcs: int = 0,
                 num_center_convs: int = 0, num_center_fcs: int = 0,
                 num_attr_convs: int = 0, num_attr_fcs: int = 0):
        """The JAX module's fields.  A branch's convs would run on the
        flat encoding, which the JAX module refuses ('branch convs need
        spatial features'), so num_*_convs > 0 raises here too."""
        super().__init__()
        convs = dict(cls=num_cls_convs, size=num_size_convs,
                     heading=num_heading_convs, center=num_center_convs,
                     attr=num_attr_convs)
        fcs = dict(cls=num_cls_fcs, size=num_size_fcs,
                   heading=num_heading_fcs, center=num_center_fcs,
                   attr=num_attr_fcs)
        bad = [b for b in BRANCHES if convs[b] > 0]
        if bad:
            raise ValueError(f'branch convs need spatial features: the '
                             f'{bad} branches run on the flat encoding')
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
        size_dim = 3 if reg_class_agnostic else 3 * num_classes
        heads = dict(center=(3, 0.001))
        for branch, on, dim, std in (
                ('cls', with_cls, num_classes + 1, 0.01),
                ('size', with_size, size_dim, 0.001),
                ('heading', with_heading, 2, 0.001),    # (sin ry, cos ry)
                ('attr', with_attr, attr_dim, 0.001)):
            if on:
                heads[branch] = (dim, std)
        self.branches = tuple(b for b in BRANCHES if b in heads)
        for branch in self.branches:
            n = fcs[branch]
            setattr(self, f'{branch}_fcs', tnn.ModuleList([
                tnn.Linear(e1 if i == 0 else fc_out_channels,
                           fc_out_channels) for i in range(n)]))
            dim, std = heads[branch]
            fc = tnn.Linear(fc_out_channels if n else e1, dim)
            tnn.init.normal_(fc.weight, std=std)
            tnn.init.zeros_(fc.bias)
            setattr(self, f'fc_{branch}', fc)

    def forward(self, roi_feats, virtual_K, ext_t_inv, intrins_valid):
        """roi_feats [R, 7, 7, C]; virtual_K, ext_t_inv [R, 4, 4];
        intrins_valid [R] -> (reference points [R, 3] (lidar frame), aux:
        'uvd' and, per enabled branch, 'cls_score' [R, K+1], 'size_pred'
        [R, 3K] or [R, 3], 'heading_pred' [R, 2], 'attr_pred' [R,
        attr_dim])."""
        x = F.relu(self.shared_convs[0](roi_feats))
        x = F.relu(linear(x.mean(dim=(1, 2)), self.shared_fcs[0]))
        intr = virtual_K.reshape(-1, 16) * self.intrins_feat_scale
        intr = torch.where(intrins_valid[:, None], intr,
                           torch.zeros_like(intr))
        x = torch.cat([x, intr.to(x.dtype)], dim=-1)
        x = x.clamp(-self.clamp_value, self.clamp_value)
        x = self.extra_enc(x)
        out = {}
        for branch in self.branches:
            xb = x
            for fc in getattr(self, f'{branch}_fcs'):
                xb = F.relu(fc(xb))
            out[branch] = getattr(self, f'fc_{branch}')(xb)
        uvd = out['center']
        aux = {'uvd': uvd}
        for branch, key in (('cls', 'cls_score'), ('size', 'size_pred'),
                            ('heading', 'heading_pred'),
                            ('attr', 'attr_pred')):
            if branch in out:
                aux[key] = out[branch]
        return center2lidar(uvd.float(), virtual_K.float(),
                            ext_t_inv.float()), aux
