"""Prediction / GT visualization of the port: the counterpart of the
repository's `tools/visualize.py` (the reference's tools/visualize.py and
visual_nuscenes.py renderers), drawn with OpenCV.

  python -m mv2d_tpu_torch.tools.visualize <config> [--checkpoint X.pth]
      [--index 0] [--out vis.png] [--score-thr 0.3] [--cameras] [--no-gt]
      [--cfg-options k=v ...] [--device cuda|cpu]
  python -m mv2d_tpu_torch.tools.visualize --synthetic --out vis.png

Runs the eval forward on one val scene (the model in bfloat16 on the GPU,
the default; float32 with `--device cpu`) and draws the bird's-eye view of
its boxes (-55..55 m each way), GT in green and the predictions above
`--score-thr` in red; `--cameras` adds the first frame's camera images
with each box's projection.  `--synthetic` renders one val scene of the
port's synthetic fixture (`tools.make_synth_fixture`, 90x160 images) into
a temporary directory and uses the tiny preset, so that no config or data
is needed.  Weights: the checkpoint (strict=True), or
`synthetic.init_random_weights(seed=0)`.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.boxes import bev_corners
from ..data.converter import _box_corners
from ..data.nuscenes import to_eval_inputs
from ..data.pipeline import IMG_MEAN, IMG_STD
from ..eval.results import detections_numpy, gt_dict_from_info
from .common import (build_dataset, build_model, device_and_dtype,
                     load_cli_config, load_weights)

GT_BGR, PRED_BGR = (0, 160, 0), (0, 0, 220)
BEV_RANGE = 55.0            # metres from the ego car, each way
BEV_SIDE = 800              # pixels
EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7)]
SYNTHETIC_OPTIONS = ("model.preset='tiny'",
                     'model.overrides=dict(num_views=6, num_frames=2)',
                     'data.val.final_dim=(64, 96)')


def draw_bev(canvas: np.ndarray, boxes: np.ndarray, color) -> None:
    """Boxes [N, >=7] (x, y, z, w, l, h, yaw, ...) as BEV rectangles, x to
    the right and y up."""
    import cv2
    if len(boxes) == 0:
        return
    bev = torch.from_numpy(np.asarray(boxes, np.float64)[:, [0, 1, 3, 4, 6]])
    scale = canvas.shape[0] / (2 * BEV_RANGE)
    for c in bev_corners(bev).numpy():
        px = np.stack([(c[:, 0] + BEV_RANGE) * scale,
                       (BEV_RANGE - c[:, 1]) * scale], -1)
        cv2.polylines(canvas, [np.round(px).astype(np.int32)], True, color,
                      1, cv2.LINE_AA)


def bev_panel(gt: Optional[np.ndarray], pred: np.ndarray) -> np.ndarray:
    import cv2
    canvas = np.full((BEV_SIDE, BEV_SIDE, 3), 255, np.uint8)
    mid = BEV_SIDE // 2
    cv2.drawMarker(canvas, (mid, mid), (0, 0, 0), cv2.MARKER_CROSS, 12)
    if gt is not None:
        draw_bev(canvas, gt, GT_BGR)
        cv2.putText(canvas, 'GT', (10, 20), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                    GT_BGR, 1, cv2.LINE_AA)
    draw_bev(canvas, pred, PRED_BGR)
    cv2.putText(canvas, 'pred', (10, 42), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                PRED_BGR, 1, cv2.LINE_AA)
    return canvas


def camera_view(img: np.ndarray, l2i: np.ndarray, box_sets) -> np.ndarray:
    """A normalized RGB image [H, W, 3] as BGR uint8 with each box of
    `box_sets` ((boxes [N, >=7], color), ...) projected by l2i [4, 4]."""
    import cv2
    out = np.clip(img * IMG_STD + IMG_MEAN, 0, 255).astype(np.uint8)
    out = np.ascontiguousarray(out[..., ::-1])
    H, W = out.shape[:2]
    for boxes, color in box_sets:
        for b in boxes:
            corners = _box_corners(np.asarray(b, np.float64))
            q = np.concatenate([corners, np.ones((8, 1))], 1) @ l2i.T
            if (q[:, 2] < 0.1).all():
                continue
            uv = q[:, :2] / np.maximum(q[:, 2:3], 0.1)
            if (uv[:, 0].max() < 0 or uv[:, 0].min() > W
                    or uv[:, 1].max() < 0 or uv[:, 1].min() > H):
                continue
            for a, c in EDGES:
                if q[a, 2] > 0.1 and q[c, 2] > 0.1:
                    cv2.line(out, tuple(np.round(uv[a]).astype(int)),
                             tuple(np.round(uv[c]).astype(int)), color, 1,
                             cv2.LINE_AA)
    return out


def render(sample: dict, gt: Optional[np.ndarray], pred: np.ndarray,
           cameras: bool, n_views: int = 6) -> np.ndarray:
    """The BEV panel, with the first `n_views` cameras in a 2 x 3 grid on
    its left when `cameras`."""
    import cv2
    bev = bev_panel(gt, pred)
    if not cameras:
        return bev
    sets = ([] if gt is None else [(gt, GT_BGR)]) + [(pred, PRED_BGR)]
    imgs = np.asarray(sample['imgs'], np.float32)
    l2i = np.asarray(sample['lidar2img'], np.float64)
    views = [camera_view(imgs[v], l2i[v], sets)
             for v in range(min(n_views, imgs.shape[0]))]
    views += [np.zeros_like(views[0])] * (6 - len(views))
    grid = np.concatenate([np.concatenate(views[:3], 1),
                           np.concatenate(views[3:6], 1)], 0)
    h = BEV_SIDE
    grid = cv2.resize(grid, (round(grid.shape[1] * h / grid.shape[0]), h),
                      interpolation=cv2.INTER_AREA)
    return np.concatenate([grid, bev], 1)


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('config', nargs='?', default=None)
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--index', type=int, default=0)
    p.add_argument('--out', default='vis.png')
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--cameras', action='store_true',
                   help='also draw the camera images with the projections')
    p.add_argument('--no-gt', action='store_true',
                   help='predictions only (GT is drawn by default)')
    p.add_argument('--synthetic', action='store_true',
                   help='one scene of the synthetic fixture, tiny preset '
                        '(no config or data needed)')
    p.add_argument('--cfg-options', nargs='*', default=None)
    p.add_argument('--device', default='cuda')
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the CLI; returns the counts drawn and the file written."""
    import cv2
    args = parse_args(argv)
    device, dtype = device_and_dtype(args.device)
    with tempfile.TemporaryDirectory(prefix='mv2d_vis_') as tmp:
        if args.synthetic:
            from .make_synth_fixture import make_fixture
            paths = make_fixture(tmp, scenes=0, val_scenes=1, image_h=90,
                                 image_w=160)
            cfg = load_cli_config(paths['config'],
                                  [*SYNTHETIC_OPTIONS,
                                   *(args.cfg_options or ())])
        elif args.config is None:
            raise SystemExit('give a config, or --synthetic')
        else:
            cfg = load_cli_config(args.config, args.cfg_options)
        dataset = build_dataset(cfg, 'val')
        s = dataset.get_sample(args.index, np.random.default_rng(0))
        info = dataset.get_info(args.index)
    model = load_weights(build_model(cfg), args.checkpoint)
    model = model.eval().to(device, dtype)
    with torch.inference_mode():
        boxes, scores, _, valid = detections_numpy(
            model(*to_eval_inputs(s, device, dtype)))
    keep = valid & (scores > args.score_thr)
    gt = None if args.no_gt else np.asarray(gt_dict_from_info(info)['boxes'])
    img = render(s, gt, boxes[keep], args.cameras,
                 model.cfg.num_views)
    if not cv2.imwrite(args.out, img):
        raise RuntimeError(f'could not write {args.out}')
    n_gt = 0 if gt is None else len(gt)
    print('wrote', args.out, f'({int(keep.sum())} preds, {n_gt} gts)')
    return dict(out=args.out, preds=int(keep.sum()), gts=n_gt)


if __name__ == '__main__':
    main()
