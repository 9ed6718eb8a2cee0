"""The MV2D-T R50 training step, part by part, on the card: the
counterpart of the repository's `tools/train_stage_bench.py`.

  python -m mv2d_tpu_torch.tools.train_stage_bench [--stage N] [--no-remat]
      [--iters 8] [--warmup 2] [--device cuda|cpu]

One scene, `synthetic.synthetic_train_batch(seed=0)`, with
`synthetic.bench_rule_weights(seed=0)` (`--init random`:
`init_random_weights(seed=0)`, the weights `chip_smoke.py` trains).
Rows 1-3 take one step's draws (grid mask, DN noise, the samplers'
keys), drawn once from a generator seeded 0, which also draws their
dropout; row 4 draws each step's own from it after them, so it times
other steps than `train_bench` does.  The rows, as the step runs them
(bfloat16 copies of the float32 masters on the card, float32 on the
CPU):
  1. `MV2D.forward_train` alone, without gradients;
  2. the losses with the Hungarian matching (`train_step.step_losses`),
     without gradients;
  3. forward + backward (`parallel.dist.dp_objective`, `.backward()`);
  4. the full step through `parallel.dist.dp_train_step` (forward,
     backward, clip, AdamW), the step that trains.
Each row prints the host ms a call, the NMS fixpoint's rounds a call,
the device's busy ms and the host syncs by site (`stage_common.timed`).
As in the JAX tool, the backbone's trainable Bottlenecks are recomputed
in the backward (cfg.remat) unless `--no-remat` is given.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch
import torch.nn as tnn

from . import stage_common as sc

NAMES = {1: 'model forward_train only', 2: 'losses forward (incl matching)',
         3: 'forward + backward', 4: 'full train step (fwd+bwd+AdamW)'}


class _ForwardTrain(tnn.Module):
    """forward_train as a module call, for `train_step.bf16_call`."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, b, draws, drop):
        return self.model.forward_train(b.imgs, b.cam, b.img_shapes, b.gt2d,
                                        b.gt3d, draws.grid, draws.dn_noise,
                                        drop)


def forward_train(model, batch, draws, drop, mixed_precision: bool):
    """forward_train as `train_step.step_losses` runs it (under mixed
    precision through `train_step.bf16_call`)."""
    from ..train.train_step import bf16_call
    module = _ForwardTrain(model)
    if mixed_precision:
        return bf16_call(module, batch, draws, drop)
    return module(batch, draws, drop)


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--no-remat', action='store_true',
                   help='keep the backbone activations (no recompute)')
    p.add_argument('--stage', type=int, default=-1, choices=(-1, 1, 2, 3, 4),
                   help='run only this row (1-4)')
    sc.add_common_args(p, iters=8)
    sc.add_init_arg(p)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the CLI; returns {'rows': {row number: Row}}."""
    from ..nn.decoder import Dropout
    from ..parallel.dist import dp_objective, dp_train_step
    from ..synthetic import synthetic_train_batch
    from ..train.optim import make_optimizer
    from ..train.train_step import draw_train, step_losses
    args = parse_args(argv)
    dev = sc.device_of(args)
    mp = dev.type == 'cuda'
    cfg = sc.model_config(args, remat=not args.no_remat)
    sc.header('train_stage_bench', dev,
              torch.bfloat16 if mp else torch.float32, cfg)
    from ..models.mv2d import MV2D
    from ..routes import Routes
    model = sc.init_weights(MV2D(cfg, Routes()), args.init).to(dev)
    opt = make_optimizer(model)
    batch = synthetic_train_batch(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = draw_train(cfg, batch.gt2d.boxes.shape[1], gen)
    drop = Dropout(cfg.dropout, gen)
    kw = dict(iters=args.iters, warmup=args.warmup, device=dev)

    def fwd_only():
        with torch.no_grad():
            return forward_train(model, batch, draws, drop, mp)[0]

    def losses():
        with torch.no_grad():
            return step_losses(model, batch, draws, drop, mp)[0]

    def fwd_bwd():
        opt.zero_grad(set_to_none=True)
        local, _ = dp_objective(model, [batch], [draws], [drop],
                                mixed_precision=mp)
        local.backward()
        return local

    def step():
        return dp_train_step(model, opt, [batch], [gen],
                             mixed_precision=mp)['total_loss']

    rows = {}
    for i, fn in ((1, fwd_only), (2, losses), (3, fwd_bwd), (4, step)):
        if args.stage in (-1, i):
            rows[i] = sc.timed(fn, name=NAMES[i], **kw)
    return {'rows': rows}


if __name__ == '__main__':
    main()
