"""Evaluation CLI of the port: the counterpart of the repository's
`tools/test.py` (the reference's `tools/test.py --eval bbox` flow).

  python -m mv2d_tpu_torch.tools.test <config> [checkpoint.pth] [--eval]
      [--out submission.json] [--format-only] [--max-samples N]
      [--cfg-options k=v ...] [--device cuda|cpu]

<config> is a file under configs/mv2d/ whose `data.val` names an infos pkl
and its camera images (`python -m mv2d_tpu_torch.tools.create_data`
writes them from the raw nuScenes tables; `python -m
mv2d_tpu_torch.tools.make_synth_fixture` renders a synthetic set).  The
checkpoint is a torch state dict with the reference's key names (a `.pth`,
optionally under 'state_dict'), loaded with strict=True; without one the
weights are `synthetic.init_random_weights(seed=0)`.  The model runs in
bfloat16 on the GPU (the default) and in float32 with `--device cpu`.
Prints mAP, NDS, the mean TP errors and each class's AP; `--out` writes
the nuScenes submission json.  `--eval` is taken, and is on whether
given or not, as in the JAX CLI: only `--format-only` skips the metrics.
The port runs exact top-k always, so the JAX CLI's MV2D_EXACT_TOPK has
no counterpart.

On N GPUs: `bash mv2d_tpu_torch/tools/dist_test.sh <config> [args]` (or
torchrun ... -m mv2d_tpu_torch.tools.test): with RANK set, each process
joins the group (`parallel.dist.init_distributed`: NCCL on
cuda:LOCAL_RANK, gloo with --device cpu), evaluates every N-th scene, and
rank 0 prints the metrics of all scenes and writes --out; the other ranks
return None.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

from ..eval import nuscenes_eval
from ..eval import results as res
from ..eval.runner import run_eval
from ..parallel.dist import close_distributed, init_distributed
from .common import (build_dataset, build_model, device_and_dtype,
                     load_cli_config, load_weights)


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--eval', action='store_true', default=True)
    p.add_argument('--format-only', action='store_true')
    p.add_argument('--out', default=None, help='submission json path')
    p.add_argument('--max-samples', type=int, default=None)
    p.add_argument('--cfg-options', nargs='*', default=None)
    p.add_argument('--device', default='cuda')
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Optional[Dict[str, float]]:
    """Runs the CLI; returns the metrics (None on a rank other than 0)."""
    args = parse_args(argv)
    device, dtype = device_and_dtype(args.device)
    info = init_distributed(device)
    try:
        return _evaluate(args, info, dtype)
    finally:
        close_distributed(info)


def _evaluate(args, info, dtype) -> Optional[Dict[str, float]]:
    lead = info.rank == 0
    cfg = load_cli_config(args.config, args.cfg_options)
    dataset = build_dataset(cfg, 'val')
    model = load_weights(build_model(cfg), args.checkpoint)
    if lead:
        print(f'loaded {args.checkpoint}' if args.checkpoint else
              'no checkpoint: random weights (init_random_weights, seed 0)')
    model = model.eval().to(info.device, dtype)

    metrics, sub = run_eval(model, dataset, info.device,
                            max_samples=args.max_samples,
                            collect_submission=bool(args.out),
                            dist_info=info)
    if not lead:
        return None
    if args.out:
        res.save_submission(args.out, sub)
        print('wrote', args.out)
    if args.format_only:
        return metrics
    print(json.dumps({k: round(float(v), 4) for k, v in metrics.items()
                      if k in ('mAP', 'NDS') or k.startswith('m')}, indent=2))
    for c in nuscenes_eval.CLASSES:
        print(f'{c:22s} AP: {metrics[f"{c}_AP"]:.4f}')
    return metrics


if __name__ == '__main__':
    main()
