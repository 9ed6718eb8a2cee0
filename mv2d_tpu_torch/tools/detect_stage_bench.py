"""The 2D detection stage of the MV2D-T R50 eval forward, piece by piece,
on the card: the counterpart of the repository's
`tools/detect_stage_bench.py`.

  python -m mv2d_tpu_torch.tools.detect_stage_bench [piece ...]
      [--iters 10] [--warmup 2] [--device cuda|cpu]

pieces (default: all):
  rpn_head   the RPN head's convs on the five FPN levels;
  rpn        RPN head + proposals + NMS (`TwoStageDetector.rpn`);
  align      the R-CNN RoIAlign, kernel K3, on the RPN's V x 1000
             proposals over p2-p5;
  rcnn_head  Shared2FC on V*1000 RoIs of 7x7x256 (N(0, 1) features);
  decode     `decode_detections` + multiclass NMS of each view, batched
             over the views as `TwoStageDetector.detections` runs them
             (N(0, 1) logits and deltas).
bfloat16, `synthetic.bench_rule_weights(seed=0)` (`--init random`:
`init_random_weights(seed=0)`), the JAX bench's scene;
each row prints the host ms a call, the device's busy ms and the host
syncs by site (`stage_common.timed`).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from . import stage_common as sc

PIECES = ('rpn_head', 'rpn', 'align', 'rcnn_head', 'decode')


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('pieces', nargs='*')
    sc.add_common_args(p)
    sc.add_init_arg(p)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the CLI; returns {'rows': {piece: Row}}."""
    from ..core.nms import multiclass_nms_2d
    from ..nn.rcnn import decode_detections
    from ..ops.roi_align import roi_align_multilevel
    args = parse_args(argv)
    dev = sc.device_of(args)
    dtype = torch.bfloat16 if dev.type == 'cuda' else torch.float32
    pieces = sc.want(PIECES, args.pieces)
    cfg = sc.model_config(args)
    sc.header('detect_stage_bench', dev, dtype, cfg)
    model = sc.bench_model(cfg, dev, dtype, args.init)
    imgs, _, _ = sc.rig_inputs(cfg, dev, dtype)
    det = model.base_detector
    pcfg = cfg.proposal_test
    V = cfg.total_views
    kw = dict(iters=args.iters, warmup=args.warmup, device=dev)
    rng = np.random.default_rng(0)
    rows = {}
    with torch.no_grad():
        fpn, _ = model.extract_feats(imgs)
        if 'rpn_head' in pieces:
            rows['rpn_head'] = sc.timed(det.rpn_head, fpn,
                                        name='RPN head convs (5 levels)',
                                        **kw)
        prop_boxes, _, prop_valid = det.rpn(fpn, cfg.image_size, pcfg)
        if 'rpn' in pieces:
            rows['rpn'] = sc.timed(
                det.rpn, fpn, cfg.image_size, pcfg,
                name='RPN head + proposals + NMS', **kw)
        Rp = prop_boxes.shape[1]
        if 'align' in pieces:
            rows['align'] = sc.timed(
                roi_align_multilevel, list(fpn[:4]), prop_boxes,
                det.fpn_strides[:4],
                name=f'R-CNN align (K3, {V * Rp} RoIs)', **kw)
        if 'rcnn_head' in pieces:
            rf = torch.from_numpy(rng.normal(
                size=(V * Rp, 7, 7, cfg.fpn_channels)).astype(np.float32)
            ).to(dev, dtype)
            rows['rcnn_head'] = sc.timed(
                det.roi_head.bbox_head, rf,
                name=f'R-CNN 2FC head ({V * Rp} RoIs)', **kw)
        if 'decode' in pieces:
            K = cfg.num_classes
            logits = torch.from_numpy(rng.normal(
                size=(V, Rp, K + 1)).astype(np.float32)).to(dev)
            deltas = torch.from_numpy(rng.normal(
                size=(V, Rp, 4 * K)).astype(np.float32)).to(dev)

            def decode(props, lg, dl, valid):
                boxes, scores = decode_detections(props, lg, dl,
                                                  cfg.image_size, K)
                return multiclass_nms_2d(
                    boxes, scores, valid, pcfg.score_thr,
                    pcfg.iou_threshold, pcfg.nms_pre, pcfg.max_per_img,
                    min_bbox_size=pcfg.min_bbox_size)
            rows['decode'] = sc.timed(
                decode, prop_boxes, logits, deltas, prop_valid,
                name='R-CNN decode + multiclass NMS', **kw)
    return {'rows': rows}


if __name__ == '__main__':
    main()
