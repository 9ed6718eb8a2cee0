"""`perfbench.flops` against torch's FlopCounterMode over the frozen
reference at the tiny size, part by part: each learned layer's products
and the attention's dense products, as the count takes them at its caps
(the reference's RoIAlign and gathers, which only an implementation
adds, are not among the parts)."""
from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import check, flops, inputs, spec

TINY = json.loads((spec.HERE / 'tests' / 'tiny.json').read_text())['model']


def counted(fn, *a):
    with FlopCounterMode(display=False) as fc:
        out = fn(*a)
    return fc.get_total_flops(), out


@pytest.fixture(scope='module')
def model():
    t = spec.traffic('../tests/eval_f32')
    return check.reference_model(TINY, t, 3, 'cpu', False)


def test_parts_equal_the_counter(model):
    c = TINY
    V = c['num_views'] * c['num_frames']
    x = inputs.images(c, spec.traffic('eval'), 3, 'cpu', torch.float32)[0]
    bb = model.base_detector
    with torch.no_grad():
        f_bb, outs = counted(bb.backbone, x)
        part = flops.backbone(c, V)
        assert f_bb == part['frozen'] + part['trained']
        f_fpn, fpn = counted(bb.neck, outs)
        f_neck, p4 = counted(lambda f: model.neck(f)[0], fpn)
        assert f_fpn + f_neck == flops.fpn(c, V) + flops.neck(c, V)
        f_rpn, _ = counted(bb.rpn_head, fpn)
        assert f_rpn == flops.rpn_head(c, V)
        rois = torch.randn(37, 7, 7, c['fpn_channels'])
        f_rcnn, _ = counted(bb.roi_head.bbox_head, rois)
        assert f_rcnn == flops.rcnn_head(c, 37)
        rig = inputs.rig(c, spec.traffic('eval'))
        cam = check.reference_cams(rig, 'cpu')
        shapes = torch.as_tensor(rig.img_shapes)
        f_pe, pos = counted(model.roi_head.position_encoding, p4,
                            cam.img2lidar, shapes, c['image_size'])
        assert f_pe == flops.pe(c, V)
        R = 11
        f_qg, _ = counted(model.roi_head.query_generator,
                          torch.randn(R, 7, 7, c['embed_dims']),
                          torch.eye(4).repeat(R, 1, 1),
                          torch.eye(4).repeat(R, 1, 1),
                          torch.ones(R, dtype=torch.bool))
        assert f_qg == flops.query_generator(c, R)
        Q, K, C = 13, 29, c['embed_dims']
        args = (torch.rand(Q, 3), torch.randn(K, C), torch.randn(K, C),
                torch.rand(Q, Q) > 0.3, torch.rand(Q, K) > 0.3)
        f_dec, _ = counted(model.roi_head.bbox_head, *args)
        assert f_dec == flops.decoder(c, Q, K, False)
        Kq = 49
        args = (torch.rand(Q, 3), torch.randn(Q, Kq, C),
                torch.randn(Q, Kq, C), torch.rand(Q, Q) > 0.3,
                torch.rand(Q, Kq) > 0.3)
        f_pq, _ = counted(model.roi_head.bbox_head, *args)
        assert f_pq == flops.decoder(c, Q, Kq, True)


def test_full_width_counts():
    bench = spec.load_benchmark()
    t = spec.config(bench, 'mv2d_t_r50')
    # the port's tools/get_flops counts 3989.1 GFLOP a scene with its
    # kernels' formulas; this count leaves out what only an
    # implementation adds
    assert 3.5e12 < flops.model_flops(t, 'eval') < 4.5e12
    assert flops.model_flops(t, 'train') > 2.5 * flops.model_flops(t, 'eval')
