"""Synthetic inputs for runs without a dataset: a camera rig and seeded
random weights under the bench fixture rules.

`camera_rig` is the ring of outward-looking cameras the JAX package's
bench uses (`__graft_entry__._rig`).  `init_random_weights` fills a model
from a torch.Generator: frozen-BN statistics stay at mean 0 / var 1 (a
random variance can go negative and NaN the forward), convolution and
linear weights are N(0, 1/fan_in), the box-delta heads rpn_reg / fc_reg
are zero so proposals are exactly anchor-shaped, and the DCN offset
branches get small random offsets.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as tnn


def camera_rig(n: int, size):
    """n cameras (6 per frame, 60 degrees apart) for an image `size`
    (H, W) -> (intrinsics [n, 4, 4], extrinsics [n, 4, 4]), float64."""
    Ks, Es = [], []
    for i in range(n):
        K = np.eye(4)
        K[0, 0] = K[1, 1] = 0.9 * size[1]
        K[0, 2], K[1, 2] = size[1] / 2, size[0] / 2
        ang = 2 * np.pi * (i % 6) / 6
        Rz = np.array([[np.cos(ang), -np.sin(ang), 0],
                       [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
        R = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]],
                     dtype=np.float64) @ Rz
        E = np.eye(4)
        E[:3, :3] = R
        E[:3, 3] = -R @ np.array([0.5 * np.cos(ang), 0.5 * np.sin(ang), 0.0])
        Ks.append(K)
        Es.append(E.T)
    return np.stack(Ks), np.stack(Es)


@torch.no_grad()
def init_random_weights(model: tnn.Module, seed: int = 0) -> tnn.Module:
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if p.dim() == 1:                      # biases, BN / LN affine
            is_affine = name.endswith('weight')
            val = torch.ones(p.shape) if is_affine else torch.zeros(p.shape)
            if 'conv_offset' in name:
                val = torch.randn(p.shape, generator=g) * 0.5
        else:
            fan_in = p[0].numel()
            std = 0.01 if 'conv_offset' in name else fan_in ** -0.5
            val = torch.randn(p.shape, generator=g) * std
        if 'rpn_reg' in name or 'fc_reg' in name:
            val = torch.zeros(p.shape)
        p.copy_(val)
    return model
