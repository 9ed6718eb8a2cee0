"""Training-log analysis: the port's counterpart of the repository's
`tools/analyze_logs.py` (the reference's analyze_logs), on the
`train_log.jsonl` that `tools/train.py` writes.

  python -m mv2d_tpu_torch.tools.analyze_logs cal_train_time \
      work_dirs/x/train_log.jsonl
  python -m mv2d_tpu_torch.tools.analyze_logs plot_curve log.jsonl \
      --keys total_loss --out o.png

`plot_curve` needs matplotlib, which only it imports.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np


def load_log(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def cal_train_time(rows):
    if len(rows) < 2:
        print('not enough log rows')
        return
    sps = np.asarray([r['sps'] for r in rows if 'sps' in r])
    print(f'mean throughput: {sps.mean():.3f} samples/s '
          f'(median {np.median(sps):.3f}, p10 {np.percentile(sps, 10):.3f})')


def plot_curve(rows, keys, out):
    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit('plot_curve needs matplotlib, which is not '
                         'installed') from e
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    rows = [r for r in rows if 'step' in r]
    steps = [r['step'] for r in rows]
    for k in keys:
        plt.plot(steps, [r.get(k, np.nan) for r in rows], label=k)
    plt.xlabel('step')
    plt.legend()
    plt.savefig(out, dpi=120)
    print('wrote', out)


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument('task', choices=['cal_train_time', 'plot_curve'])
    p.add_argument('log')
    p.add_argument('--keys', nargs='*', default=['total_loss'])
    p.add_argument('--out', default='curve.png')
    args = p.parse_args(argv)
    rows = load_log(args.log)
    if args.task == 'cal_train_time':
        cal_train_time(rows)
    else:
        plot_curve(rows, args.keys, args.out)


if __name__ == '__main__':
    main()
