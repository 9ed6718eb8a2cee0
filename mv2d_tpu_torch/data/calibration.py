"""Static-shape bucket sizing from dataset statistics: the port's copy of
`mv2d_tpu/data/calibration.py` (numpy only, the same rules).

The model replaces the reference's ragged shapes (per-view detection
counts, the valid-pixel key gather, DN pads that are f(num GT)) with fixed
buckets; anything past a bucket is dropped, so buckets must be sized from
the data.  This module scans a dataset and recommends, with a safety
margin:

  * max_gt    (3D GT boxes/scene; also the DN group width)
  * max_gt2d  (2D GT boxes/view)
  * k_max     (attention-key pixel bucket: union of all per-box pixel
               masks at feature stride, expanded by expand_stride - the
               union over queries of own+correlated pixels equals the
               union of all box masks, since every box is itself a query).
               GT boxes stand in for detections; `det_inflation` scales
               for the detector's extra boxes.

Used by `tools/calibrate_buckets.py` (report mode) and `tools/train.py
--auto-buckets` (applies the recommendation to the model config before
the model is built).  Run-time overflow is logged by the training step's
key_active / key_overflow metrics.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def pixel_union(boxes: np.ndarray, valid: np.ndarray, hw: Tuple[int, int],
                stride: int, expand: int) -> int:
    """Active pixels in the union of box masks at feature resolution
    (the semantics of models/correlation.in_roi_pixel_masks)."""
    h, w = hw
    expand = int(np.ceil(expand))   # conservative for fractional expands
    mask = np.zeros((h, w), bool)
    for b, ok in zip(boxes, valid):
        if not ok:
            continue
        x1 = int(np.floor(b[0] / stride)) - expand
        y1 = int(np.floor(b[1] / stride)) - expand
        x2 = int(np.ceil(b[2] / stride)) + expand
        y2 = int(np.ceil(b[3] / stride)) + expand
        mask[max(y1, 0):min(y2 + 1, h), max(x1, 0):min(x2 + 1, w)] = True
    return int(mask.sum())


def round_up(x: float, q: int) -> int:
    return int(-(-x // q) * q)


def scan_dataset(ds, mcfg, samples: int = 200, seed: int = 0) -> Dict:
    """Per-sample bucket statistics over `samples` dataset entries.

    The scan must observe UNCENSORED annotation counts: ds.get_sample
    pads/truncates GT through the very buckets being calibrated, so the
    dataset's buckets are temporarily swapped for effectively unbounded
    ones (otherwise --auto-buckets could only ever recommend ~margin x
    the current bucket while raw annotations still overflow)."""
    from .nuscenes import SampleBuckets
    n = min(samples, len(ds))
    rng = np.random.default_rng(seed)
    h = mcfg.image_size[0] // mcfg.stride
    w = mcfg.image_size[1] // mcfg.stride
    expand = mcfg.correlation.expand_stride

    gt3d_counts, gt2d_counts, unions = [], [], []
    saved_buckets = ds.buckets
    ds.buckets = SampleBuckets(max_gt3d=8192, max_gt2d=8192)
    try:
        for i in range(n):
            s = ds.get_sample(i, rng)
            gt3d_counts.append(int(np.asarray(s['gt3d_valid']).sum()))
            v2 = np.asarray(s.get('gt2d_valid', np.zeros((1, 1), bool)))
            gt2d_counts.append(int(v2.sum(axis=-1).max()))
            total = 0
            boxes = np.asarray(s.get('gt2d_boxes', np.zeros((1, 0, 4))))
            for vi in range(boxes.shape[0]):
                total += pixel_union(boxes[vi], v2[vi], (h, w), mcfg.stride,
                                     expand)
            unions.append(total)
    finally:
        ds.buckets = saved_buckets
    return dict(n=n, total=len(ds), feat_hw=(h, w),
                gt3d_counts=gt3d_counts, gt2d_counts=gt2d_counts,
                unions=unions)


def recommend_buckets(stats: Dict, mcfg, percentile: float = 100.0,
                      margin: float = 1.25,
                      det_inflation: float = 2.0) -> Dict[str, int]:
    """Turn scan statistics into bucket sizes (max_gt, max_gt2d, k_max)."""
    pct = lambda a: float(np.percentile(a, percentile)) if a else 0.0
    max_gt = round_up(max(pct(stats['gt3d_counts']) * margin, 8), 8)
    max_gt2d = round_up(max(pct(stats['gt2d_counts']) * margin, 8), 8)
    k_max = round_up(
        max(pct(stats['unions']) * margin * det_inflation, 1024), 1024)
    h, w = stats['feat_hw']
    hard_cap = mcfg.total_views * h * w
    k_max = min(k_max, round_up(hard_cap, 1024))
    return dict(max_gt=max_gt, max_gt2d=max_gt2d, k_max=k_max)


def calibrate(ds, mcfg, samples: int = 200, percentile: float = 100.0,
              margin: float = 1.25, det_inflation: float = 2.0,
              seed: int = 0):
    """scan + recommend; returns (recommendation dict, raw stats dict)."""
    stats = scan_dataset(ds, mcfg, samples=samples, seed=seed)
    rec = recommend_buckets(stats, mcfg, percentile=percentile,
                            margin=margin, det_inflation=det_inflation)
    return rec, stats


def apply_to_config(cfg: dict, rec: Dict[str, int], mcfg) -> Dict[str, int]:
    """Raise cfg's model bucket overrides to the recommendation (never
    shrinks an explicitly larger setting).  Mutates and returns the
    applied {name: value} mapping."""
    overrides = cfg.setdefault('model', {}).setdefault('overrides', {})
    applied = {}
    for key in ('max_gt', 'max_gt2d', 'k_max'):
        cur = overrides.get(key, getattr(mcfg, key))
        if rec[key] > cur:
            overrides[key] = applied[key] = rec[key]
    return applied
