"""Size the model's static shape buckets from dataset statistics: the
port's counterpart of the repository's `tools/calibrate_buckets.py`, with
the same output lines.

Report mode for `mv2d_tpu_torch/data/calibration.py` (the scan and the
recommendation live there; `python -m mv2d_tpu_torch.tools.train
--auto-buckets N` applies the same recommendation itself).  Prints the
per-sample statistics and the `--cfg-options model.overrides.*` line to
copy into a run.

  python -m mv2d_tpu_torch.tools.calibrate_buckets <config> [--samples 200]
      [--percentile 100] [--margin 1.25] [--det-inflation 2.0]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..data.calibration import calibrate
from .common import build_dataset, build_model_config, load_cli_config


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('--split', default='train')
    p.add_argument('--samples', type=int, default=200)
    p.add_argument('--percentile', type=float, default=100.0,
                   help='use this percentile of the per-sample stats')
    p.add_argument('--margin', type=float, default=1.25,
                   help='safety factor applied on top of the percentile')
    p.add_argument('--det-inflation', type=float, default=2.0,
                   help='k_max scale-up for detector boxes beyond GT')
    p.add_argument('--cfg-options', nargs='*', default=None)
    args = p.parse_args(argv)

    cfg = load_cli_config(args.config, args.cfg_options)
    mcfg = build_model_config(cfg)
    ds = build_dataset(cfg, args.split)
    rec, stats = calibrate(ds, mcfg, samples=args.samples,
                           percentile=args.percentile, margin=args.margin,
                           det_inflation=args.det_inflation)

    def pct(a):
        return float(np.percentile(a, args.percentile)) if a else 0.0
    h, w = stats['feat_hw']
    hard_cap = mcfg.total_views * h * w
    print(f'scanned {stats["n"]} samples of {stats["total"]} ({args.split})')
    print(f'  gt3d/scene: max {max(stats["gt3d_counts"])}  '
          f'p{args.percentile:g} {pct(stats["gt3d_counts"]):.0f}')
    print(f'  gt2d/view:  max {max(stats["gt2d_counts"])}  '
          f'p{args.percentile:g} {pct(stats["gt2d_counts"]):.0f}')
    print(f'  key-pixel union/scene (GT boxes): max {max(stats["unions"])}  '
          f'p{args.percentile:g} {pct(stats["unions"]):.0f}  '
          f'(hard cap V*h*w = {hard_cap})')
    print('recommended (margin '
          f'{args.margin:g}, det inflation {args.det_inflation:g}):')
    print(f'  --cfg-options model.overrides.max_gt={rec["max_gt"]} '
          f'model.overrides.k_max={rec["k_max"]}')
    print(f'  dataset bucket: max_gt2d={rec["max_gt2d"]}')
    cur = dict(max_gt=mcfg.max_gt, k_max=mcfg.k_max)
    for k in ('max_gt', 'k_max'):
        if cur[k] < rec[k]:
            print(f'  WARNING: current {k}={cur[k]} < recommended {rec[k]} '
                  f'(silent truncation risk; tools/train.py --auto-buckets '
                  f'applies this automatically)')


if __name__ == '__main__':
    main()
