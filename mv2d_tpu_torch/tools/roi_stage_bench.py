"""The 3D head of the MV2D-T R50 eval forward, piece by piece, on the
card: the counterpart of the repository's `tools/roi_stage_bench.py`.

  python -m mv2d_tpu_torch.tools.roi_stage_bench [piece ...]
      [--iters 10] [--warmup 2] [--device cuda|cpu]

The JAX tool's synthetic inputs, from numpy.random.default_rng(0): p4 and
its PE N(0, 1) [V, H/16, W/16, 256], V x 75 proposals with corners ~ U(0,
W - 220 s) x U(0, H - 220 s) and sides ~ U(24 s, 200 s) (s = W / 1408),
80% of them valid.  pieces (default: all):
  align_sep     `separable_roi_align_views` on p4 ++ PE, what the head
                runs (`models/mv2d.py: roi_head_forward`);
  align_pallas  the counterpart of the JAX Pallas slab kernel on the one
                concatenated level: kernel K3 with that level in each of
                its four slots (mmcv's adaptive sampling; JAX samples 2);
  querygen      the query generator on N(0, 1) 7x7x256 RoI features;
  corr          the epipolar correlation (`epipolar_in_box`);
  masks         the pixel masks, the key union and gather, the cross mask
                (`MV2D._pixel_keys`, the deployed key path);
  decoder       the 6-layer decoder on N(0, 1) keys, k_max of them, with a
                5% cross mask: K4 and `mask_bits`;
  decode        the NMS-free decode of N(0, 1) logits and codes.
The JAX tool's `align` (an XLA gather form) has no counterpart, and its
`keys` piece is listed but runs nothing there: both print why.  bfloat16,
`synthetic.bench_rule_weights(seed=0)` for the modules (`--init random`:
`init_random_weights(seed=0)`); each row prints
the host ms a call, the device's busy ms and the host syncs by site
(`stage_common.timed`).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from . import stage_common as sc

PIECES = ('align', 'align_sep', 'align_pallas', 'querygen', 'corr', 'masks',
          'keys', 'decoder', 'decode')
REFUSED = {
    'align': 'XLA-only formulation: the JAX tool times roi_align\'s XLA '
             'gather form; the port has the separable form (align_sep) and '
             'K3 (align_pallas)',
    'keys': 'no branch in JAX: tools/roi_stage_bench.py lists the piece '
            'and runs nothing for it',
}


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('pieces', nargs='*')
    sc.add_common_args(p)
    sc.add_init_arg(p)
    return p.parse_args(argv)


def head_inputs(cfg, dev, dtype, rng):
    """The JAX tool's p4, PE, proposal boxes [V, P, 4] and validity."""
    V, (H, W) = cfg.total_views, cfg.image_size
    h, w, C = H // cfg.stride, W // cfg.stride, cfg.embed_dims
    P = cfg.proposal_test.max_per_img
    s = W / 1408.0

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    p4 = normal(V, h, w, C).to(dev, dtype)
    pos = normal(V, h, w, C).to(dev, dtype)
    bx = rng.uniform(0, W - 220 * s, (V, P, 1))
    by = rng.uniform(0, H - 220 * s, (V, P, 1))
    bw = rng.uniform(24 * s, 200 * s, (V, P, 2))
    boxes = torch.from_numpy(np.concatenate(
        [bx, by, bx + bw[..., :1], by + bw[..., 1:]], -1).astype(
            np.float32)).to(dev)
    valid = torch.from_numpy(rng.uniform(size=(V, P)) < 0.8).to(dev)
    return p4, pos, boxes, valid


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the CLI; returns {'rows': {piece: Row}}."""
    from ..core.coder import nms_free_decode
    from ..core.geometry import virtual_intrinsics
    from ..models.correlation import epipolar_in_box
    from ..ops.roi_align import (roi_align_multilevel,
                                 separable_roi_align_views)
    args = parse_args(argv)
    dev = sc.device_of(args)
    dtype = torch.bfloat16 if dev.type == 'cuda' else torch.float32
    pieces = sc.want(PIECES, args.pieces)
    cfg = sc.model_config(args)
    sc.header('roi_stage_bench', dev, dtype, cfg)
    model = sc.bench_model(cfg, dev, dtype, args.init)
    head = model.roi_head
    _, cam, shapes = sc.rig_inputs(cfg, dev, dtype)
    rng = np.random.default_rng(0)
    p4, pos, boxes, valid = head_inputs(cfg, dev, dtype, rng)
    V, P = boxes.shape[:2]
    R, O, C = V * P, cfg.roi_size, cfg.embed_dims
    h, w = p4.shape[1:3]
    flat_boxes = boxes.reshape(R, 4)
    view_idx = torch.arange(V, device=dev).repeat_interleave(P)
    kw = dict(iters=args.iters, warmup=args.warmup, device=dev)
    rows = {}
    for piece in pieces:
        if piece in REFUSED:
            sc.refuse(piece, REFUSED[piece])
    with torch.no_grad():
        cat = torch.cat([p4, pos], -1)
        if 'align_sep' in pieces:
            amax = (-(-h // O), -(-w // O))
            rows['align_sep'] = sc.timed(
                separable_roi_align_views, cat, boxes, 1.0 / cfg.stride, O,
                amax, name=f'roi head align (separable mm, {R} RoIs)', **kw)
        if 'align_pallas' in pieces:
            rows['align_pallas'] = sc.timed(
                roi_align_multilevel, [cat] * 4, boxes, [cfg.stride] * 4,
                name=f'roi head align (K3, one level, {R} RoIs)', **kw)
        if 'querygen' in pieces:
            bf = torch.from_numpy(rng.normal(size=(R, O, O, C)).astype(
                np.float32)).to(dev, dtype)
            Kv = virtual_intrinsics(flat_boxes, cam.intrinsics[view_idx],
                                    (O, O))
            ok = torch.ones(R, dtype=torch.bool, device=dev)
            rows['querygen'] = sc.timed(
                head.query_generator, bf, Kv, cam.ext_t_inv[view_idx], ok,
                name='query generator', **kw)
        corr = (boxes, valid, cam.trans_mats.float(), cfg.image_size,
                cfg.correlation)
        corr_ids, corr_mask = epipolar_in_box(*corr)
        if 'corr' in pieces:
            rows['corr'] = sc.timed(epipolar_in_box, *corr,
                                    name='epipolar correlation', **kw)
        if 'masks' in pieces:
            rows['masks'] = sc.timed(
                model._pixel_keys, p4, pos, boxes, valid, corr_ids,
                corr_mask, shapes, False, name='pixel masks + key gather',
                **kw)
        if 'decoder' in pieces:
            Kk = cfg.k_max
            refs = torch.from_numpy(rng.uniform(0.1, 0.9, (R, 3)).astype(
                np.float32)).to(dev)
            keys, kpos = (torch.from_numpy(rng.normal(size=(Kk, C)).astype(
                np.float32)).to(dev, dtype) for _ in range(2))
            cross = torch.from_numpy(rng.uniform(size=(R, Kk)) < 0.05).to(
                dev)
            self_allowed = torch.ones(R, R, dtype=torch.bool, device=dev)
            rows['decoder'] = sc.timed(
                head.bbox_head, refs.to(dtype), keys, kpos, self_allowed,
                cross,
                name=f'decoder stack ({cfg.num_decoder_layers} layers)', **kw)
        if 'decode' in pieces:
            cls = torch.from_numpy(rng.normal(
                size=(R, cfg.num_classes)).astype(np.float32)).to(dev)
            bp = torch.from_numpy(rng.normal(size=(R, 10)).astype(
                np.float32)).to(dev)
            qv = torch.ones(R, dtype=torch.bool, device=dev)
            rows['decode'] = sc.timed(
                nms_free_decode, cls, bp, qv, cfg.max_num, cfg.num_classes,
                cfg.position_range, name='NMS-free decode', **kw)
    return {'rows': rows}


if __name__ == '__main__':
    main()
