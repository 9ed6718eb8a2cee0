"""Synthetic inputs for runs without a dataset: a camera rig, seeded
random weights under the bench fixture rules, and a seeded training scene.

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


def synthetic_train_batch(cfg, seed: int = 0, device='cuda'):
    """One seeded training scene (numpy draws), the JAX package's train
    bench fixture (`tools/train_bench.py`) at any image size: N(0, 1)
    images, the camera rig with timestamps 0 / 0.5 for the two frames,
    5-20 2D boxes per view (corner ~ U(0, W - 200 s), size ~ U(40 s,
    200 s) with s = W / 1408) in cfg.max_gt2d slots, 25 3D boxes in
    cfg.max_gt slots (x, y ~ U(-40, 40), z = -1.5, sizes ~ U(1, 4)), and
    random labels.  Returns a `train.train_step.TrainBatch`."""
    from .core.geometry import prepare_camera_params
    from .models.mv2d import GroundTruth2D, GroundTruth3D
    from .train.train_step import TrainBatch
    V, (H, W) = cfg.total_views, cfg.image_size
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(V, H, W, 3)).astype(np.float32)
    s = W / 1408.0
    G2, G = cfg.max_gt2d, cfg.max_gt
    g2b = np.zeros((V, G2, 4), np.float32)
    g2v = np.zeros((V, G2), bool)
    for v in range(V):
        n = min(int(rng.integers(5, 20)), G2)
        xy = rng.uniform(0, W - 200 * s, (n, 2))
        g2b[v, :n] = np.concatenate([xy, xy + rng.uniform(40 * s, 200 * s,
                                                          (n, 2))], 1)
        g2v[v, :n] = True
    ngt = min(25, G)
    g3b = np.zeros((G, 9), np.float32)
    g3b[:ngt, :2] = rng.uniform(-40, 40, (ngt, 2))
    g3b[:ngt, 2] = -1.5
    g3b[:ngt, 3:6] = rng.uniform(1, 4, (ngt, 3))
    g3l = rng.integers(0, cfg.num_classes, G)
    g2l = rng.integers(0, cfg.num_classes, (V, G2))
    K, E = camera_rig(V, cfg.image_size)
    ts = [0.0] * cfg.num_views + [0.5] * (V - cfg.num_views)

    def t(a):
        return torch.from_numpy(a).to(device)

    return TrainBatch(
        imgs=t(imgs), cam=prepare_camera_params(K, E, ts, device=device),
        img_shapes=t(np.asarray([[H, W]] * V)),
        gt2d=GroundTruth2D(t(g2b), t(g2l), t(g2v)),
        gt3d=GroundTruth3D(t(g3b), t(g3l), t(np.arange(G) < ngt)))
