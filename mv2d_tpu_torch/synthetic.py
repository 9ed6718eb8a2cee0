"""Synthetic inputs for runs without a dataset: a camera rig, seeded
random weights under the bench fixture rules, a seeded training scene, and
the RoIAlign kernels' seeded levels and RoIs (`roi_inputs`,
`flat_roi_inputs`, `wide_roi_inputs`).

`camera_rig` is the ring of outward-looking cameras the JAX package's
bench uses (`__graft_entry__._rig`).  `init_random_weights` fills a model
from a torch.Generator: frozen-BN statistics stay at mean 0 / var 1 (a
random variance can go negative and NaN the forward), convolution and
linear weights are N(0, 1/fan_in), the box-delta heads rpn_reg / fc_reg
are zero so proposals are exactly anchor-shaped, the DCN offset
branches get small random offsets, and every other bias is zero (the
RetinaHead's class bias too: at its focal prior, -log 99, random weights
leave no anchor above the score threshold).
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


# RoIAlign inputs at the eval path's and the micro-bench's shapes, for the
# kernel checks and timings (chip_smoke.py, tools/align_variants.py)


def roi_inputs(dev, dtype, V=12, P=1000, img=(512, 1408), C=256, seed=0,
               edge=False, sliver=False):
    """p2..p5 maps and anchor-like RoIs over all levels; with `edge`,
    extreme-aspect, zero-area and partly outside RoIs are mixed in; with
    `sliver`, every RoI is a sliver: across the image 8 pixels tall, or
    6 pixels wide from top to bottom, at random places (level 0)."""
    g = torch.Generator().manual_seed(seed)
    feats = [torch.randn(V, img[0] // s, img[1] // s, C, generator=g)
             .to(dev, dtype) for s in (4, 8, 16, 32)]
    side = 32 * 2 ** torch.randint(0, 5, (V, P), generator=g).float() \
        * (0.7 + 0.7 * torch.rand(V, P, generator=g))
    ratio = 2.0 ** torch.randint(-1, 2, (V, P), generator=g).float()
    w, h = side / ratio.sqrt(), side * ratio.sqrt()
    cx = torch.rand(V, P, generator=g) * img[1]
    cy = torch.rand(V, P, generator=g) * img[0]
    rois = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    rois[..., 0::2] = rois[..., 0::2].clamp(0, img[1])
    rois[..., 1::2] = rois[..., 1::2].clamp(0, img[0])
    if sliver:
        across = torch.rand(V, P, generator=g) < 0.5
        rois = torch.where(across[..., None], torch.stack(
            [torch.zeros_like(cy), cy - 4, torch.full_like(cy, img[1]),
             cy + 4], -1), torch.stack(
            [cx - 3, torch.zeros_like(cx), cx + 3,
             torch.full_like(cx, img[0])], -1))
    if edge:
        rois[:, 0] = torch.tensor([0.0, 200.0, img[1], 208.0])   # 1408 x 8
        rois[:, 1] = torch.tensor([700.0, 0.0, 706.0, img[0]])   # 6 x 512
        rois[:, 2] = torch.tensor([300.0, 300.0, 300.0, 300.0])  # empty
        rois[:, 3] = torch.tensor([-40.0, -30.0, 60.0, 50.0])    # outside
        rois[:, 4] = torch.tensor([0.0, 0.0, img[1], img[0]])    # level 3
    return feats, rois.to(dev)


def flat_roi_inputs(dev, dtype, R=12000, V=12, img=(512, 1408), C=256,
                    seed=0, edge=False):
    """The JAX package's micro-bench of its flat RoIAlign
    (tools/micro_bench.py 'palign'): p2..p5 maps, R RoIs with corners
    ~ U(0, 1000) and sides ~ U(100, 400) on random views; with `edge`,
    RoIs outside the image, zero-area, whole-image and > 61-cell slivers
    are mixed in."""
    g = torch.Generator().manual_seed(seed)
    feats = [torch.randn(V, img[0] // s, img[1] // s, C, generator=g)
             .to(dev, dtype) for s in (4, 8, 16, 32)]
    xy = torch.rand(R, 2, generator=g) * 1000
    rois = torch.cat([xy, xy + 100 + 300 * torch.rand(R, 2, generator=g)],
                     1)
    views = torch.randint(0, V, (R,), generator=g, dtype=torch.int32)
    if edge:
        rois[:6] = torch.tensor([
            [-300.0, -200.0, -40.0, -10.0],       # outside the image
            [500.0, 300.0, 500.0, 300.0],         # zero area
            [0.0, 0.0, img[1], img[0]],           # whole image
            [0.0, 100.0, img[1], 110.0],          # 352 x 2.5 cells at p2
            [900.0, 0.0, 907.0, img[0]],          # 1.75 x 128 cells
            [-50.0, 400.0, 300.0, 700.0]])        # across the bottom edge
    return feats, rois.to(dev), views.to(dev)


def wide_roi_inputs(dev, dtype, V=2, P=96, img=(64, 2240), C=256, seed=0):
    """p2..p5 maps whose finest level is wider than 512 cells (560 at an
    image 2240 pixels wide), and RoIs [V, P, 4]: half slivers 4 pixels
    tall across the whole image (560 x 1 cells at p2), half anchor-like
    boxes on every level."""
    g = torch.Generator().manual_seed(seed)
    feats = [torch.randn(V, img[0] // s, img[1] // s, C, generator=g)
             .to(dev, dtype) for s in (4, 8, 16, 32)]
    side = 24 * 2 ** torch.randint(0, 5, (V, P), generator=g).float()
    cx = torch.rand(V, P, generator=g) * img[1]
    cy = torch.rand(V, P, generator=g) * img[0]
    rois = torch.stack([cx - side, cy - side / 4, cx + side, cy + side / 4],
                       -1).clamp(min=0)
    y = torch.rand(V, P, generator=g) * (img[0] - 4)
    across = torch.stack([torch.zeros_like(y), y,
                          torch.full_like(y, img[1]), y + 4], -1)
    rois[:, ::2] = across[:, ::2]
    return feats, rois.to(dev)
