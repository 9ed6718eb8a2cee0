"""Training-step throughput of the port (scenes/s on one GPU): the
counterpart of the repository's `tools/train_bench.py`.

  python -m mv2d_tpu_torch.tools.train_bench [--image-h 512 --image-w 1408]
      [--no-dcn] [--no-dn] [--iters 10] [--fixture DIR] [--weights X.pth]
      [--trace DIR] [--flops] [--remat] [--device cuda|cpu]

One full MV2D-T R50 step (`parallel.dist.dp_train_step`: grid mask, the
2D losses, detections without gradients, the GT complement, the DN head,
the Hungarian matching on the host, clip and AdamW; bfloat16 copies of
float32 masters on the card) on one scene: `synthetic_train_batch(seed=0)`
at the image size, or with `--fixture` the first training scene of a
`tools.make_synth_fixture` directory through `data.nuscenes`.  Weights:
`synthetic.bench_rule_weights(seed=0)` (`--init random`:
`init_random_weights(seed=0)`), or a checkpoint of the port
(`tools.train`'s, or a reference-keyed state dict) loaded with
strict=True.  Runs a first step, `--warmup` steps (2), then `--iters`
steps with one synchronize at the end, and prints ms a step, scenes/s,
the NMS fixpoint's rounds a step in those steps (each a host sync) and
the peak device memory.  The reference trains one scene a GPU on 8 GPUs.

  --no-dcn   plain convs in stages 3-4 (the DCN's share of the step);
  --no-dn    no DN queries (the DN's share);
  --trace    a trace of 3 steps (`utils.profiling.trace`) into DIR;
  --flops    the step's FLOPs (forward + backward; FlopCounterMode with
             `tools.get_flops.FORMULAS` for the hand kernels) and bytes,
             beside H100 SXM bf16 peak (989 TFLOP/s), then exits;
  --remat    recompute each trainable backbone Bottleneck in the backward
             (cfg.remat; off by default, as in the JAX tool; --no-remat
             is kept for the JAX tool's command lines and changes
             nothing).
The JAX tool's `--no-auto-layout` is XLA machinery (its AUTO input
layouts) and is not ported; it prints why.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import stage_common as sc

PEAK_BF16 = 989e12          # H100 SXM dense bf16, FLOP/s


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--image-h', type=int, default=None,
                   help="default: the preset's (512)")
    p.add_argument('--image-w', type=int, default=None,
                   help="default: the preset's (1408)")
    p.add_argument('--no-dcn', action='store_true')
    p.add_argument('--no-dn', action='store_true')
    p.add_argument('--fixture', default=None, metavar='DIR')
    p.add_argument('--weights', default=None, metavar='CKPT')
    p.add_argument('--trace', default=None, metavar='DIR')
    p.add_argument('--flops', action='store_true')
    p.add_argument('--remat', action='store_true',
                   help='recompute the backbone blocks in the backward')
    p.add_argument('--no-remat', action='store_true',
                   help='(default; kept for compatibility)')
    p.add_argument('--no-auto-layout', action='store_true',
                   help='not ported (prints why)')
    sc.add_common_args(p)
    sc.add_init_arg(p)
    return p.parse_args(argv)


def fixture_batch(cfg, fixture: str, dev):
    """The first training scene of a make_synth_fixture directory, at
    cfg's image size."""
    from ..data.nuscenes import NuScenesDataset, SampleBuckets, \
        to_train_batch
    from ..data.pipeline import IdaAugConfig
    ds = NuScenesDataset(
        info_path=os.path.join(fixture, 'infos_train.pkl'),
        ann2d_path=os.path.join(fixture, 'coco_train.json'),
        num_frames=cfg.num_frames, final_dim=cfg.image_size,
        ida=IdaAugConfig(final_dim=cfg.image_size),
        buckets=SampleBuckets(max_gt3d=cfg.max_gt, max_gt2d=cfg.max_gt2d))
    return to_train_batch(ds.get_sample(0, np.random.default_rng(0)), dev)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the CLI; returns ms_per_step, scenes_per_s, peak_gib and loss
    (or flops and bytes with --flops)."""
    from ..core.nms import greedy_fixpoint
    from ..models.mv2d import MV2D
    from ..parallel.dist import dp_train_step
    from ..routes import Routes
    from ..synthetic import synthetic_train_batch
    from ..train.optim import make_optimizer
    from .common import load_weights
    args = parse_args(argv)
    dev = sc.device_of(args)
    if args.no_auto_layout:
        sc.refuse('--no-auto-layout', 'XLA-only formulation: XLA\'s AUTO '
                  'input layouts; PyTorch takes the layouts it is given')
    over = {'remat': args.remat}
    if args.image_h or args.image_w:
        base = sc.model_config(args).image_size
        over['image_size'] = (args.image_h or base[0],
                              args.image_w or base[1])
    if args.no_dcn:
        over['stage_with_dcn'] = (False,) * 4
    if args.no_dn:
        over['use_denoise'] = False
    cfg = sc.model_config(args, **over)
    mp = dev.type == 'cuda'
    sc.header('train_bench', dev, torch.bfloat16 if mp else torch.float32,
              cfg)
    model = MV2D(cfg, Routes())
    if args.weights:
        load_weights(model, args.weights)
        print(f'loaded weights from {args.weights}', flush=True)
    else:
        sc.init_weights(model, args.init)
    model = model.to(dev)
    opt = make_optimizer(model)
    batch = fixture_batch(cfg, args.fixture, dev) if args.fixture else \
        synthetic_train_batch(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def step():
        return dp_train_step(model, opt, [batch], [gen],
                             mixed_precision=mp)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    if args.flops:
        from .get_flops import count
        flops, nbytes, ops = count(step)
        print(f'train-step flops:  {flops / 1e9:.1f} GFLOP / scene '
              '(forward + backward)')
        print(f'bytes accessed:    {nbytes / 1e9:.2f} GB / scene (every '
              'dispatched op\'s inputs and outputs: an unfused upper bound)')
        print(f'roofline @ {PEAK_BF16 / 1e12:.0f} TF/s bf16 (H100 SXM): '
              f'{flops / PEAK_BF16 * 1e3:.2f} ms/scene '
              f'({PEAK_BF16 / flops:.2f} scenes/s at 100%)')
        print(f'kernel ops:        {", ".join(ops)}', flush=True)
        return dict(flops=flops, bytes=nbytes, ops=ops)

    t0 = time.perf_counter()
    loss = float(step()['total_loss'])
    print(f'first step {time.perf_counter() - t0:.1f} s (with any kernel '
          f'build) loss={loss:.3f}', flush=True)
    for _ in range(args.warmup):
        step()
    sync()
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    r0 = greedy_fixpoint.rounds
    t0 = time.perf_counter()
    for _ in range(args.iters):
        metrics = step()
    sync()
    dt = (time.perf_counter() - t0) / args.iters
    rounds = (greedy_fixpoint.rounds - r0) / args.iters
    loss = float(metrics['total_loss'])
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if dev.type == 'cuda' else float('nan')
    print(f'train step: {dt * 1e3:.1f} ms/scene ({1 / dt:.3f} scenes/s), '
          f'loss={loss:.3f}, nms rounds {rounds:g} a step, peak {peak:.2f} '
          f'GiB; {sc.card(dev)}', flush=True)
    if args.trace:
        from ..utils.profiling import trace
        with trace(args.trace):
            for _ in range(3):
                step()
        print(f'trace written to {args.trace}', flush=True)
    return dict(ms_per_step=dt * 1e3, scenes_per_s=1 / dt, peak_gib=peak,
                loss=loss, rounds=rounds)


if __name__ == '__main__':
    main()
