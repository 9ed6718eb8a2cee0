"""Micro-probes of the small operations around the 3D head, on the card:
the counterpart of the repository's `tools/misc_bench.py`.

  python -m mv2d_tpu_torch.tools.misc_bench [piece ...] [--iters 20]
      [--warmup 3] [--device cuda|cpu]

Shapes follow the preset (MV2D-T R50: R = 12 x 75 = 900 queries, 10
classes, 300 decoded boxes, a key union over 12 x 32 x 88 = 33792 p4
pixels, 4 x 4 x 8 = 128 epipolar samples a query and view).  pieces
(default: all):
  topk     the port's exact top-k (`core.nms.topk`, a full stable sort of
           the row) at R*10 -> 300, R*10 -> 32 and 33792 -> 300, each
           beside `torch.topk` on the same row as a yardstick;
  argsort  a descending argsort of R*10 floats, and the stable argsort
           of 33792 booleans that `gather_active_keys` runs;
  pe       `pos2posemb3d` of R points;
  corr     the correlation's membership test, [R, V, 75, 128] box
           compares reduced over the samples, in float32 and with bf16
           compares.
bfloat16 where the model computes in it; each row prints the host ms a
call, the device's busy ms and the host syncs by site
(`stage_common.timed`).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from . import stage_common as sc

PIECES = ('topk', 'argsort', 'pe', 'corr')


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('pieces', nargs='*')
    sc.add_common_args(p, iters=20, warmup=3)
    return p.parse_args(argv)


def membership(pts, ok, boxes, dtype=torch.float32):
    """pts [R, V, S, 2], ok [R, V, S], boxes [V, P, 4] -> [R, V, P]: some
    valid sample of the query lies in the box (compares in dtype)."""
    b = boxes.to(dtype)[None, :, :, None]
    q = pts.to(dtype)
    x, y = q[:, :, None, :, 0], q[:, :, None, :, 1]
    inb = (x >= b[..., 0]) & (x <= b[..., 2]) & (y >= b[..., 1]) & \
        (y <= b[..., 3])
    return (inb & ok[:, :, None, :]).any(-1)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the CLI; returns {'rows': {name: Row}}."""
    from ..core.nms import topk
    from ..nn.pe import pos2posemb3d
    args = parse_args(argv)
    dev = sc.device_of(args)
    pieces = sc.want(PIECES, args.pieces)
    cfg = sc.model_config(args)
    sc.header('misc_bench', dev, torch.float32, cfg)
    V, (H, W) = cfg.total_views, cfg.image_size
    P = cfg.proposal_test.max_per_img
    R, K = V * P, cfg.num_classes
    npix = V * (H // cfg.stride) * (W // cfg.stride)
    cc = cfg.correlation
    SD = cc.sample_size ** 2 * cc.num_depth
    rng = np.random.default_rng(0)
    kw = dict(iters=args.iters, warmup=args.warmup, device=dev)
    rows = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    with torch.no_grad():
        if 'topk' in pieces:
            x = t(rng.normal(size=(R * K,)).astype(np.float32))
            y = t(rng.normal(size=(npix,)).astype(np.float32))
            for a, k in ((x, cfg.max_num), (x, 32), (y, cfg.max_num)):
                n = a.shape[0]
                rows[f'topk_{n}_{k}'] = sc.timed(
                    topk, a, k, name=f'core.nms.topk {n} -> {k}', **kw)
                rows[f'torch_topk_{n}_{k}'] = sc.timed(
                    torch.topk, a, k, name=f'torch.topk {n} -> {k}', **kw)
        if 'argsort' in pieces:
            x = t(rng.normal(size=(R * K,)).astype(np.float32))
            rows['argsort'] = sc.timed(
                lambda a: torch.argsort(-a), x, name=f'argsort {R * K}',
                **kw)
            u = t(rng.uniform(size=(npix,)) < 0.3)
            rows['argsort_bool'] = sc.timed(
                lambda a: torch.argsort((~a).to(torch.uint8), stable=True),
                u, name=f'argsort(bool) {npix} (gather_active_keys)', **kw)
        if 'pe' in pieces:
            p = t(rng.uniform(size=(R, 3)).astype(np.float32))
            rows['pe'] = sc.timed(pos2posemb3d, p, name=f'pos2posemb3d {R}',
                                  **kw)
        if 'corr' in pieces:
            pts = t(rng.uniform(0, 1400, (R, V, SD, 2)).astype(np.float32))
            ok = t(rng.uniform(size=(R, V, SD)) < 0.7)
            boxes = t(np.concatenate([rng.uniform(0, 1000, (V, P, 2)),
                                      rng.uniform(1000, 1400, (V, P, 2))],
                                     -1).astype(np.float32))
            rows['corr'] = sc.timed(
                membership, pts, ok, boxes,
                name=f'corr membership [{R},{V},{P},{SD}] any', **kw)
            rows['corr_bf16'] = sc.timed(
                membership, pts, ok, boxes, torch.bfloat16,
                name='corr membership bf16 compares', **kw)
    return {'rows': rows}


if __name__ == '__main__':
    main()
