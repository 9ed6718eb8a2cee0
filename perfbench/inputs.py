"""The benchmark's inputs, made from the seed on the device: the weights,
the camera rig and the pools of scenes.  Both sides take them as they
are: the program under test and the float32 reference
(`perfbench.reference`).  Nothing here imports either.

Frozen copies of the port's synthetic rules, so that a change to the port
cannot move the yardstick:

* `weights`: `init_random_weights`' rule (frozen-BN affine 1 / 0, running
  mean 0 / var 1; every tensor of two or more dims N(0, 1 / fan_in), the
  DCN offset branches N(0, 0.01^2) and their biases N(0, 0.5^2); rpn_reg
  and fc_reg zero, so proposals are exactly anchor-shaped; every other
  bias zero), drawn as one normal vector on the device and cut into the
  leaves, in the dtype the traffic serves them in.
* `camera_rig`: the ring of six outward-looking cameras a frame.
* `eval_pool` / `train_pool`: N(0, 1) images; for training the
  `synthetic_train_batch` rule of boxes (5-20 2D boxes a view, corner
  ~ U(0, W - 200 s), side ~ U(40 s, 200 s), s = W / 1408; 25 3D boxes,
  x, y ~ U(-40, 40), z = -1.5, sizes ~ U(1, 4); random labels).  Every
  seed draws the same multiset of 2D box counts, in another order, so
  that the seed changes the values and not the amount of work.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def seed_key(*parts: int) -> int:
    """A 63-bit generator seed from integers of any size (the seed and,
    e.g., a step or a purpose tag)."""
    return int(np.random.SeedSequence([int(p) % 2 ** 64 for p in parts])
               .generate_state(1, np.uint64)[0]) >> 1


def generator(device, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_key(*parts))


# purpose tags of the seed's streams
WEIGHTS, IMAGES, BOXES, STEPS, CHECK = range(5)


def weight_rule(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """(std, constant) of a leaf: its values are N(0, std^2) + constant."""
    if len(shape) <= 1:
        if 'conv_offset' in name:
            return 0.5, 0.0
        if name.endswith('running_var'):
            return 0.0, 1.0
        affine = name.endswith('weight')
        return 0.0, 1.0 if affine else 0.0
    if 'rpn_reg' in name or 'fc_reg' in name:
        return 0.0, 0.0
    fan_in = int(np.prod(shape[1:]))
    return (0.01 if 'conv_offset' in name else fan_in ** -0.5), 0.0


def weights(leaves: Sequence[Tuple[str, Sequence[int]]], seed: int,
            device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """name -> tensor of every leaf (parameters, and the BN statistics),
    from one normal draw of the device's generator, in `dtype`."""
    rules = [weight_rule(n, s) for n, s in leaves]
    sizes = [int(np.prod(s)) if len(s) else 1 for _, s in leaves]
    n = sum(sizes)
    z = torch.randn(n, generator=generator(device, seed, WEIGHTS),
                    device=device)
    std = torch.tensor([r[0] for r in rules], device=device)
    add = torch.tensor([r[1] for r in rules], device=device)
    counts = torch.tensor(sizes, device=device)
    flat = (z * std.repeat_interleave(counts, output_size=n)
            + add.repeat_interleave(counts, output_size=n)).to(dtype)
    return {name: t.view(tuple(shape)) for (name, shape), t in
            zip(leaves, flat.split(sizes))}


def leaves_of(module: torch.nn.Module) -> List[Tuple[str, Tuple[int, ...]]]:
    """The leaves `weights` fills: every floating parameter and BN
    statistic of `module`, in its state dict's order."""
    return [(n, tuple(t.shape)) for n, t in module.state_dict().items()
            if t.is_floating_point() and (
                n.endswith(('running_mean', 'running_var'))
                or n in dict(module.named_parameters()))]


def camera_rig(n: int, size) -> Tuple[np.ndarray, np.ndarray]:
    """n cameras (6 a frame, 60 degrees apart) for an image `size` (H, W)
    -> (intrinsics [n, 4, 4], extrinsics [n, 4, 4]), float64."""
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


class Rig(NamedTuple):
    intrinsics: np.ndarray      # [V, 4, 4]
    extrinsics: np.ndarray      # [V, 4, 4]
    timestamps: List[float]     # [V]
    img_shapes: np.ndarray      # [V, 2]


def rig(model_cfg: dict, traffic: dict) -> Rig:
    V = model_cfg['num_views'] * model_cfg['num_frames']
    H, W = model_cfg['image_size']
    K, E = camera_rig(V, (H, W))
    ts = [float(traffic['timestamps'][v // model_cfg['num_views']])
          for v in range(V)]
    return Rig(K, E, ts, np.asarray([[H, W]] * V))


def images(model_cfg: dict, traffic: dict, seed: int, device,
           dtype) -> torch.Tensor:
    """The pool's images [pool, V, H, W, 3], N(0, image_std^2)."""
    V = model_cfg['num_views'] * model_cfg['num_frames']
    H, W = model_cfg['image_size']
    g = generator(device, seed, IMAGES)
    x = torch.randn(traffic['pool'], V, H, W, 3, generator=g, device=device,
                    dtype=dtype)
    return x.mul_(traffic['image_std'])


class Boxes(NamedTuple):
    """One scene's ground truth (the program's GroundTruth2D / 3D
    fields), on the device."""
    boxes2d: torch.Tensor       # [V, G2, 4]
    labels2d: torch.Tensor      # [V, G2] int64
    valid2d: torch.Tensor       # [V, G2] bool
    boxes3d: torch.Tensor       # [G, 9]
    labels3d: torch.Tensor      # [G] int64
    valid3d: torch.Tensor       # [G] bool


def gt2d_counts(pool: int, V: int, lo: int, hi: int, seed: int):
    """[pool, V] 2D box counts: the same multiset lo..hi-1 for every seed,
    permuted by it."""
    base = lo + np.arange(pool * V) % (hi - lo)
    rng = np.random.default_rng(seed_key(seed, BOXES))
    return rng.permutation(base).reshape(pool, V)


def boxes(model_cfg: dict, traffic: dict, seed: int, device) -> List[Boxes]:
    """The pool's ground truth, drawn on the host (a few hundred numbers)
    from the seed."""
    V = model_cfg['num_views'] * model_cfg['num_frames']
    H, W = model_cfg['image_size']
    G2, G = model_cfg['max_gt2d'], model_cfg['max_gt']
    K = model_cfg['num_classes']
    s = W / 1408.0
    lo, hi = traffic['gt2d_per_view']
    counts = gt2d_counts(traffic['pool'], V, lo, hi, seed)
    rng = np.random.default_rng(seed_key(seed, BOXES, 1))
    smin, smax = traffic['gt2d_size_px']
    zmin, zmax = traffic['gt3d_size']
    out = []
    for i in range(traffic['pool']):
        b2 = np.zeros((V, G2, 4), np.float32)
        v2 = np.zeros((V, G2), bool)
        for v in range(V):
            n = min(int(counts[i, v]), G2)
            xy = rng.uniform(0, W - smax * s, (n, 2))
            b2[v, :n] = np.concatenate(
                [xy, xy + rng.uniform(smin * s, smax * s, (n, 2))], 1)
            v2[v, :n] = True
        n3 = min(int(traffic['gt3d']), G)
        b3 = np.zeros((G, 9), np.float32)
        r = traffic['gt3d_xy']
        b3[:n3, :2] = rng.uniform(-r, r, (n3, 2))
        b3[:n3, 2] = traffic['gt3d_z']
        b3[:n3, 3:6] = rng.uniform(zmin, zmax, (n3, 3))
        l3 = rng.integers(0, K, G)
        l2 = rng.integers(0, K, (V, G2))

        def t(a):
            return torch.from_numpy(a).to(device)
        out.append(Boxes(t(b2), t(l2), t(v2), t(b3), t(l3),
                         t(np.arange(G) < n3)))
    return out
