"""Training CLI of the port: the counterpart of the repository's
`tools/train.py` (the reference's `tools/train.py` flow), flag for flag.

  python -m mv2d_tpu_torch.tools.train <config> [--work-dir DIR]
      [--resume-from epoch_N.pth | --auto-resume] [--load-from X.pth]
      [--seed 0] [--max-steps N] [--auto-buckets N]
      [--cfg-options k=v ...] [--device cuda|cpu]
  torchrun --nproc_per_node N -m mv2d_tpu_torch.tools.train <config> ...

One process a GPU: under torchrun each rank trains on `order[rank::world]`
of every epoch's permutation, cut to len(dataset) // world scenes, and
the step is `parallel.dist.dp_train_step` (the 3D bbox losses normalised
by the mean num_pos of the global batch, gradients all-reduced).  On the
GPU (the default) the step runs in bfloat16 mixed precision over float32
masters; with `--device cpu` in float32.  Without `--load-from` the
weights are the model's own initialisation under torch.manual_seed(seed).

Each epoch trains on the (epoch + 1)-th permutation of
default_rng(seed), its samples read by `Prefetcher(seed=seed + epoch)`
and taken in the permutation's order; each step draws from a generator
seeded by (seed, global step, scene).  So a run resumed from
`epoch_k.pth` trains on what the uninterrupted run trained on, and the
learning rate goes on from the restored AdamW step count; a checkpoint
of a run cut by --max-steps inside an epoch holds its step, and the
resumed run goes on from the next scene of that epoch's order.

Writes to the work dir: `config.json`; a log line every `log_interval`
steps (every metric of the step, step, epoch, samples/s `sps`) to stdout
and `train_log.jsonl`; `epoch_{e}.pth` after each epoch (rank 0;
`train.checkpoint`: meta, state_dict with the reference's key names,
optimizer), which `tools.test` and `tools.serve` load as they are; and,
every `evaluation.interval` epochs, the eval hook's `val_*` line: the
val split through `eval.runner.run_eval` on a copy of the model in eval
mode and the eval dtype, what `tools.test` computes on the saved file;
in a group every rank evaluates its share of the scenes and rank 0 logs
the metrics of all of them.  `bash mv2d_tpu_torch/tools/dist_train.sh
<config> [args]` launches one process a local GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import pprint
import time
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.nuscenes import Prefetcher, to_train_batch
from ..eval.runner import run_eval
from ..parallel.dist import (barrier, close_distributed, dp_train_step,
                             init_distributed)
from ..train import checkpoint
from ..train.optim import make_optimizer
from ..train.train_step import step_generator
from .common import (build_dataset, build_model, build_model_config,
                     device_and_dtype, load_cli_config)


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('--work-dir', default='work_dirs/default')
    p.add_argument('--resume-from', default=None)
    p.add_argument('--auto-resume', action='store_true',
                   help='resume from the latest epoch_*.pth in --work-dir')
    p.add_argument('--load-from', default=None,
                   help='torch .pth to initialize from')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--max-steps', type=int, default=None,
                   help='cap steps (debug)')
    p.add_argument('--auto-buckets', type=int, default=None, metavar='N',
                   help='scan N train samples and auto-raise the static '
                        'shape buckets (max_gt, k_max) before building '
                        'the model (see data/calibration.py)')
    p.add_argument('--cfg-options', nargs='*', default=None)
    p.add_argument('--device', default='cuda')
    return p.parse_args(argv)


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """Epoch `epoch`'s permutation of the n scenes: the (epoch + 1)-th of
    default_rng(seed), what the JAX CLI draws in an uninterrupted run."""
    rng = np.random.default_rng(seed)
    for _ in range(epoch):
        rng.permutation(n)
    return rng.permutation(n)


def rank_order(order: np.ndarray, rank: int, world: int,
               steps_per_epoch: int) -> list:
    """A rank's scenes of the epoch: order[rank::world], cut to
    steps_per_epoch so that every rank takes as many steps."""
    return order[rank::world][:steps_per_epoch].tolist()


def ordered_samples(dataset, indices: Sequence[int], seed: int,
                    skip: int = 0) -> Iterator[Tuple[int, dict]]:
    """(index, sample) for each of `indices` in their order, from position
    `skip` on: the `Prefetcher`'s workers hand samples over as they
    finish, and a small buffer keyed by position puts them back in order.
    Each sample is the one the JAX CLI's Prefetcher gives at the same
    position.  The first `skip` samples are read and dropped, since each
    worker's generator draws every sample's augmentation in turn."""
    pos = {idx: i for i, idx in enumerate(indices)}
    held, nxt = {}, 0
    pf = Prefetcher(dataset, list(indices), seed=seed)
    try:
        for idx, sample in pf:
            held[pos[idx]] = (idx, sample)
            while nxt in held:
                item = held.pop(nxt)
                if nxt >= skip:
                    yield item
                nxt += 1
    finally:
        pf.close()


def eval_copy(model: torch.nn.Module, cfg: dict, device) -> torch.nn.Module:
    """The model the eval hook runs: a model of the config holding
    `model`'s weights, in eval mode and the device's eval dtype (bfloat16
    on the GPU), as `tools.test` builds it from the saved checkpoint; the
    float32 masters are not cast."""
    dev, dtype = device_and_dtype(str(device))
    with torch.random.fork_rng(devices=[]):
        ev = build_model(cfg)
    ev.load_state_dict(model.state_dict(), strict=True)
    return ev.eval().to(dev, dtype)


def val_line(metrics: dict, epoch: int) -> dict:
    line = {f'val_{k}': round(float(v), 4) for k, v in metrics.items()
            if k in ('mAP', 'NDS') or k.startswith('m')}
    line['epoch'] = epoch
    return line


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the CLI -> {'step': the last global step, 'model_cfg': the
    model's config, 'log': the lines written, 'resumed_from': the
    checkpoint restored or None}."""
    args = parse_args(argv)
    device_and_dtype(args.device)        # raises without CUDA
    info = init_distributed(args.device)
    try:
        return train(args, info)
    finally:
        close_distributed(info)


def train(args, info) -> dict:
    dev = info.device
    lead = info.rank == 0
    cfg = load_cli_config(args.config, args.cfg_options)
    os.makedirs(args.work_dir, exist_ok=True)
    if lead:
        with open(os.path.join(args.work_dir, 'config.json'), 'w') as f:
            json.dump({k: str(v) for k, v in cfg.items()}, f, indent=2)

    if args.auto_buckets:
        from ..data.calibration import apply_to_config, calibrate
        mcfg0 = build_model_config(cfg)
        # scan with a throwaway dataset: the real one is built after the
        # overrides land (build_dataset sizes its GT pad buckets from the
        # model config, and model and dataset buckets must agree)
        rec, stats = calibrate(build_dataset(cfg, 'train'), mcfg0,
                               samples=args.auto_buckets)
        applied = apply_to_config(cfg, rec, mcfg0) or \
            'nothing (current buckets already cover the data)'
        print(f'auto-buckets: scanned {stats["n"]} samples, '
              f'recommended {rec}, applied {applied}')
    torch.manual_seed(args.seed)
    model = build_model(cfg)
    if args.load_from:
        checkpoint.load_from(model, args.load_from)
    model = model.to(dev)
    dataset = build_dataset(cfg, 'train')
    epochs = cfg.get('total_epochs', 24)
    steps_per_epoch = max(1, len(dataset) // info.world)
    total_steps = steps_per_epoch * epochs

    opt_cfg = cfg.get('optimizer', {})
    optimizer = make_optimizer(
        model, base_lr=opt_cfg.get('lr', 2e-4), total_steps=total_steps,
        weight_decay=opt_cfg.get('weight_decay', 0.01),
        backbone_lr_mult=opt_cfg.get('backbone_lr_mult', 0.25),
        clip_norm=opt_cfg.get('clip_norm', 35.0))
    resume_from = args.resume_from
    if resume_from is None and args.auto_resume:
        resume_from = checkpoint.latest_checkpoint(args.work_dir)
    global_step = 0
    if resume_from:
        meta = checkpoint.restore_checkpoint(resume_from, model, optimizer)
        global_step = int(meta['iter'])
        print(f'resumed from {resume_from} at step {global_step}')
    start_epoch = global_step // steps_per_epoch
    # a run cut inside an epoch goes on from the next scene of its order
    skip = global_step - start_epoch * steps_per_epoch

    log_interval = cfg.get('log_interval', 50)
    log_path = os.path.join(args.work_dir, 'train_log.jsonl')
    evaluation = cfg.get('evaluation', {})
    lines = []

    def emit(line):
        lines.append(line)
        if lead:
            print(json.dumps(line), flush=True)
            with open(log_path, 'a') as f:
                f.write(json.dumps(line) + '\n')

    mixed_precision = dev.type == 'cuda'
    done = False
    for epoch in range(start_epoch, epochs):
        order = rank_order(epoch_order(args.seed, epoch, len(dataset)),
                           info.rank, info.world, steps_per_epoch)
        t0 = time.time()
        for _, sample in ordered_samples(dataset, order, args.seed + epoch,
                                         skip):
            batch = to_train_batch(sample, dev)
            gen = step_generator(args.seed, global_step, info.rank, dev)
            metrics = dp_train_step(model, optimizer, [batch], [gen],
                                    info.group, mixed_precision)
            global_step += 1
            if global_step % log_interval == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=global_step, epoch=epoch,
                         sps=info.world * log_interval / (time.time() - t0))
                t0 = time.time()
                emit(m)
            done = bool(args.max_steps and global_step >= args.max_steps)
            if done:
                break
        skip = 0
        if lead:
            checkpoint.save_checkpoint(
                os.path.join(args.work_dir, f'epoch_{epoch + 1}.pth'),
                model, optimizer, meta=dict(
                    epoch=epoch + 1, iter=global_step, seed=args.seed,
                    world_size=info.world, config=pprint.pformat(cfg)))
        barrier(info)
        # the eval hook (the reference's evaluation.interval)
        interval = evaluation.get('interval', 0)
        if interval and (epoch + 1) % interval == 0 and \
                'val' in cfg.get('data', {}):
            # on every rank of the group, each its share of the scenes
            ev = eval_copy(model, cfg, dev)
            val, _ = run_eval(ev, build_dataset(cfg, 'val'), dev,
                              max_samples=evaluation.get('max_samples'),
                              dist_info=info)
            del ev
            if dev.type == 'cuda':
                torch.cuda.empty_cache()
            if lead:
                emit(val_line(val, epoch + 1))
            barrier(info)
        if done:
            break
    peak = ''
    if dev.type == 'cuda':
        peak = f'; peak device memory ' \
            f'{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB'
    print(f'training done, step {global_step}{peak}')
    return dict(step=global_step, model_cfg=model.cfg, log=lines,
                resumed_from=resume_from)


if __name__ == '__main__':
    main()
