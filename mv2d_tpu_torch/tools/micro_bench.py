"""Micro-benchmarks of the port's hot operations on the card: the
counterpart of the repository's `tools/micro_bench.py`.

  python -m mv2d_tpu_torch.tools.micro_bench [piece ...] [--iters 10]
      [--warmup 2] [--device cuda|cpu]

Shapes follow the preset (MV2D-T R50: V = 12 views at 512x1408, 256 FPN
channels, 1000 RPN proposals a view).  pieces (default: all):
  gather         a row gather of V*1000 x 196 rows of 256 bf16 from the
                 p2 pixels (the R-CNN RoIAlign's pattern), summed over
                 the 196, with the effective GB/s;
  align          kernel K3 on V x 1000 anchor-like RoIs over p2-p5
                 (`synthetic.roi_inputs`);
  palign         kernel B12 on V*1000 flat RoIs on random views
                 (`synthetic.flat_roi_inputs`), the counterpart of the
                 JAX tool's Pallas piece;
  nms            the port's NMS (`core.nms.nms_padded`, IoU 0.7, 1000
                 kept) on V x 4544 random boxes; and the RPN's NMS as the
                 port runs it, each level's nms_pre boxes of each view
                 (`nms_sorted_keep` on [V, 5, nms_pre]);
  dcn            the DCNv2 3x3 conv 256 -> 256 at V x H/16 x W/16 (kernel
                 K2);
  resnet         the backbone on the images, DCN off and on (K1, K2);
  resnet_stages  the stem with its max pool, layer1 (K1), layer2 (cuDNN),
                 layer3 and layer4 (K2 with MV2D-T's DCN) at their input
                 shapes, and the stage-2-equivalent `torch.matmul`
                 [V*H/8*W/8, 1152] x [1152, 128] as a yardstick;
  bottleneck     one identity bottleneck at each stage's shape: cuDNN (the
                 model's unfused folded block) beside the hand kernel,
                 K1 at width 64, B10 at 128 and 256; no kernel at 512.
The JAX tool's XLA forms of `gather` (DCN) and `align` have no
counterpart.  bfloat16, `synthetic.bench_rule_weights(seed=0)`; each row
prints the host ms a call, the device's busy ms and the host syncs by
site (`stage_common.timed`).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from . import stage_common as sc

PIECES = ('gather', 'align', 'palign', 'nms', 'dcn', 'resnet',
          'resnet_stages', 'bottleneck')
GATHER_TAPS = 196            # 7x7 bins x 2x2 samples
NMS_BOXES = 4544             # the JAX tool's count at nms_pre 1000


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('pieces', nargs='*')
    sc.add_common_args(p)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the CLI; returns {'rows': {name: Row}}."""
    from ..synthetic import bench_rule_weights
    args = parse_args(argv)
    dev = sc.device_of(args)
    dtype = torch.bfloat16 if dev.type == 'cuda' else torch.float32
    pieces = sc.want(PIECES, args.pieces)
    cfg = sc.model_config(args)
    sc.header('micro_bench', dev, dtype, cfg)
    V, (H, W) = cfg.total_views, cfg.image_size
    C, P = cfg.fpn_channels, cfg.proposal_test.rpn_max_per_img
    s = W / 1408.0
    rng = np.random.default_rng(0)
    g = torch.Generator().manual_seed(0)
    kw = dict(iters=args.iters, warmup=args.warmup, device=dev)
    rows = {}

    def normal(*shape):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    with torch.no_grad():
        if 'gather' in pieces:
            n = V * (H // 4) * (W // 4)
            flat = normal(n, C)
            idx = torch.from_numpy(rng.integers(
                0, n, (V * P, GATHER_TAPS))).to(dev)
            r = sc.timed(lambda f, i: f[i].sum(1), flat, idx,
                         name=f'row gather {V * P}x{GATHER_TAPS} x {C}', **kw)
            gb = V * P * GATHER_TAPS * C * flat.element_size() / 1e9
            print(f'    -> effective gather {gb / r.host_ms * 1e3:.1f} GB/s '
                  '(host clock)', flush=True)
            rows['gather'] = r
        if 'align' in pieces:
            from ..ops.roi_align import roi_align_multilevel
            from ..synthetic import roi_inputs
            sc.refuse('align (XLA form)', 'XLA-only formulation: '
                      'multilevel_roi_align\'s gather form')
            feats, rois = roi_inputs(dev, dtype, V=V, P=P, img=(H, W), C=C)
            rows['align'] = sc.timed(
                roi_align_multilevel, feats, rois, (4, 8, 16, 32),
                name=f'K3 roi_align {V * P} rois', **kw)
        if 'palign' in pieces:
            from ..ops.roi_align import roi_align_flat
            from ..synthetic import flat_roi_inputs
            feats, rois, views = flat_roi_inputs(dev, dtype, R=V * P, V=V,
                                                 img=(H, W), C=C)
            rows['palign'] = sc.timed(
                roi_align_flat, feats, rois, views, (4, 8, 16, 32),
                name=f'B12 roi_align_flat {V * P} rois', **kw)
        if 'nms' in pieces:
            from ..core.nms import nms_padded, nms_sorted_keep
            n = NMS_BOXES * cfg.proposal_test.rpn_nms_pre // 1000
            xy = rng.uniform(0, 1300 * s, (V, n, 2))
            boxes = torch.from_numpy(np.concatenate(
                [xy, xy + rng.uniform(20 * s, 200 * s, (V, n, 2))],
                -1).astype(np.float32)).to(dev)
            scores = torch.from_numpy(rng.uniform(0, 1, (V, n)).astype(
                np.float32)).to(dev)
            valid = torch.ones(V, n, dtype=torch.bool, device=dev)
            rows['nms'] = sc.timed(nms_padded, boxes, scores, valid, 0.7,
                                   P, name=f'RPN NMS {V}x{n}', **kw)
            k = cfg.proposal_test.rpn_nms_pre
            lv = (boxes[:, :k].unsqueeze(1).expand(V, 5, k, 4),
                  scores[:, :k].unsqueeze(1).expand(V, 5, k),
                  valid[:, :k].unsqueeze(1).expand(V, 5, k))
            rows['nms_levels'] = sc.timed(
                nms_sorted_keep, *lv, 0.7,
                name=f'RPN NMS as run, {V}x5 levels x {k}', **kw)
        if 'dcn' in pieces:
            from ..ops.dcn import ModulatedDeformConv
            sc.refuse('dcn (gather)', 'XLA-only formulation: the DCN\'s XLA '
                      'gather form')
            mod = bench_rule_weights(ModulatedDeformConv(256, 256)).to(
                dev, dtype)
            x = normal(V, H // 16, W // 16, 256)
            rows['dcn'] = sc.timed(
                mod, x, name=f'DCNv2 3x3 256ch @ {H // 16}x{W // 16} x{V} '
                             '(K2)', **kw)
        if 'resnet' in pieces or 'resnet_stages' in pieces:
            from ..nn.resnet import ResNet
            from ..routes import Routes
            x = normal(V, H, W, 3)
        if 'resnet' in pieces:
            for dcn in (False, True):
                net = bench_rule_weights(ResNet(
                    cfg.depth, (False, False, dcn, dcn), Routes())).to(
                        dev, dtype)
                rows[f'resnet_dcn{int(dcn)}'] = sc.timed(
                    net, x, name=f'ResNet{cfg.depth} {V}x{H}x{W} dcn={dcn}',
                    **kw)
        if 'resnet_stages' in pieces:
            from ..ops.stage import fused_stage1
            net = bench_rule_weights(ResNet(
                cfg.depth, cfg.stage_with_dcn, Routes())).to(dev, dtype)
            y = net.stem(x)
            rows['stem'] = sc.timed(net.stem, x, name='stem 7x7/2 + maxpool',
                                    **kw)
            rows['layer1'] = sc.timed(
                lambda z: fused_stage1(z, net.layer1_blocks(z.dtype)), y,
                name=f'layer1 {len(net.layer1)} blk (K1)', **kw)
            y = net.layer1(y)
            for st in (2, 3, 4):
                layer = getattr(net, f'layer{st}')
                dcn = ' DCN' if cfg.stage_with_dcn[st - 1] else ''
                rows[f'layer{st}'] = sc.timed(
                    layer, y, name=f'layer{st} {len(layer)} blk{dcn}', **kw)
                y = layer(y)
            a = normal(V * (H // 8) * (W // 8), 9 * 128)
            b = normal(9 * 128, 128)
            rows['matmul'] = sc.timed(torch.matmul, a, b,
                                      name='matmul ~stage2 3x3 eq', **kw)
        if 'bottleneck' in pieces:
            rows.update(_bottlenecks(cfg, dev, dtype, normal, kw))
    return {'rows': rows}


def _bottlenecks(cfg, dev, dtype, normal, kw):
    """One identity bottleneck at each stage's shape: the folded module
    (cuDNN) beside its hand kernel."""
    from ..nn.resnet import Bottleneck
    from ..ops.stage import (IDENTITY_PLANES, fused_identity_chain,
                             fused_stage1, pack_block)
    from ..synthetic import bench_rule_weights
    V, (H, W) = cfg.total_views, cfg.image_size
    rows = {}
    for planes, stride in ((64, 4), (128, 8), (256, 16), (512, 32)):
        y = normal(V, H // stride, W // stride, 4 * planes)
        blk = bench_rule_weights(Bottleneck(4 * planes, planes)).to(
            dev, dtype)
        a = sc.timed(blk, y, name=f'bottleneck p{planes} cuDNN', **kw)
        rows[f'bottleneck{planes}_cudnn'] = a
        if planes == 64:
            packed = [pack_block(blk.folded(), dtype)]
            b = sc.timed(fused_stage1, y, packed,
                         name=f'bottleneck p{planes} K1', **kw)
        elif planes in IDENTITY_PLANES:
            b = sc.timed(fused_identity_chain, y, [blk.folded()],
                         name=f'bottleneck p{planes} B10', **kw)
        else:
            sc.refuse(f'bottleneck p{planes} fused', 'no hand kernel at '
                      'this width: B10 takes 128 and 256, K1 64')
            continue
        rows[f'bottleneck{planes}_kernel'] = b
        print(f'    -> {a.host_ms / b.host_ms:.2f}x (host clock)', flush=True)
    return rows


if __name__ == '__main__':
    main()
