"""Inference throughput benchmark of the port: the counterpart of the
repository's `tools/benchmark.py` (the reference's
tools/analysis_tools/benchmark.py).

  python -m mv2d_tpu_torch.tools.benchmark <config> [--checkpoint X.pth]
      [--warmup 5] [--iters 50] [--bf16] [--batch B]
      [--cfg-options k=v ...] [--device cuda|cpu]

Times the eval forward (`MV2D.forward`, inference mode) on N(0, 1) images
from `numpy.random.default_rng(0)` on `synthetic.camera_rig`: `--warmup`
steps, then `--iters` steps with one device synchronize at the end, and
prints samples/s and ms a sample.  The model runs in float32 unless
`--bf16` (the serving dtype on the GPU).

The JAX tool vmaps B scenes into one program; the port's forward has no
scene axis, so `--batch B` runs B forwards in turn in each step, as the
server runs a batch, and throughput counts all B.

Weights: the checkpoint (strict=True), or
`synthetic.init_random_weights(seed=0)`.  The JAX tool's N(0, 0.02) draw
over every leaf is not used: it gives the frozen BN running variances
N(0, 0.02) values, half of them negative, whose square roots are NaN.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .common import build_model, device_and_dtype, load_cli_config, \
    load_weights
from .export import rig_camera


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('config')
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--warmup', type=int, default=5)
    p.add_argument('--iters', type=int, default=50)
    p.add_argument('--bf16', action='store_true')
    p.add_argument('--batch', type=int, default=1,
                   help='scenes a step, run one after another (the port '
                        'has no scene axis to vmap); throughput counts all')
    p.add_argument('--cfg-options', nargs='*', default=None)
    p.add_argument('--device', default='cuda')
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the CLI; returns samples/s and ms a sample."""
    args = parse_args(argv)
    device, _ = device_and_dtype(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    cfg = load_cli_config(args.config, args.cfg_options)
    model = load_weights(build_model(cfg), args.checkpoint)
    model = model.eval().to(device, dtype)
    mc = model.cfg
    V, (H, W) = mc.total_views, mc.image_size
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(V, H, W, 3)).astype(np.float32))
    images = imgs.to(device, dtype)
    cam = rig_camera(mc, device)
    shapes = torch.tensor([[H, W]] * V, device=device)
    B = args.batch

    def step():
        for _ in range(B):
            out = model(images, cam, shapes)
        return out

    def force(out):
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        return out

    with torch.inference_mode():
        force(step())
        for _ in range(args.warmup):
            force(step())
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = step()
        force(out)
        dt = time.perf_counter() - t0
    sps = args.iters * B / dt
    where = torch.cuda.get_device_name(device) if device.type == 'cuda' \
        else 'cpu'
    print(f'{sps:.3f} samples/s ({dt / args.iters / B * 1000:.1f} ms/sample, '
          f'batch {B}, {"bf16" if args.bf16 else "f32"}, {where})')
    return dict(samples_per_s=sps, ms_per_sample=dt / args.iters / B * 1e3)


if __name__ == '__main__':
    main()
