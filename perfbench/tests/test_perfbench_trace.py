"""The profiled slice's arithmetic on the CPU: interval unions, busy time
by span, and the roofline bound of each hand-kernel operator from the
shapes the profiler records (the operators run their plain versions on
the CPU: the recorded shapes are the same)."""
from __future__ import annotations

import torch

from mv2d_tpu_torch import synthetic
from mv2d_tpu_torch.ops import attention, dcn, library, roi_align, stage  # noqa: F401
from perfbench import roofline, trace


def test_union_us():
    assert trace.union_us([]) == 0
    assert trace.union_us([(0, 2), (1, 3), (5, 6)]) == 4


def test_blocked_us_counts_syncs_and_device_to_host_copies():
    E = trace.Event
    ev = [E('cudaStreamSynchronize', True, 0, 5, 1, False, 1, (), ()),
          E('cudaMemcpyAsync', True, 10, 12, 2, False, 1, (), ()),
          E('Memcpy DtoH (Device -> Pageable)', False, 10, 11, 2, False,
            -1, (), ()),
          E('cudaMemcpyAsync', True, 20, 29, 3, False, 1, (), ()),
          E('Memcpy HtoD', False, 20, 21, 3, False, -1, (), ())]
    assert trace.blocked_us(ev) == 7


def test_busy_by_span_takes_kernels_by_their_launch():
    E = trace.Event
    ev = [E('cudaLaunchKernel', True, 1, 2, 7, False, 1, (), ()),
          E('k', False, 30, 40, 7, False, -1, (), ()),
          E('cudaLaunchKernel', True, 6, 7, 8, False, 1, (), ()),
          E('k', False, 40, 45, 8, False, -1, (), ())]
    got = trace.busy_by_span(ev, [('a', 0, 5), ('b', 5, 10)])
    assert got == {'a': 10, 'b': 5}


def test_every_operator_has_a_bound_from_recorded_shapes():
    feats, rois = synthetic.roi_inputs('cpu', torch.float32, V=2, P=8,
                                       img=(64, 96), C=32)
    blk = dict(w1=torch.randn(64, 64), b1=torch.randn(64),
               w2=torch.randn(9, 64, 64), b2=torch.randn(64),
               w3=torch.randn(64, 256), b3=torch.randn(256),
               wd=torch.randn(64, 256), bd=torch.randn(256))
    x = torch.randn(2, 8, 8, 32)
    sy = torch.rand(2, 8, 8, 9) * 7
    m = torch.rand(2, 8, 8, 9)
    q, k = torch.randn(70, 32), torch.randn(130, 32)
    allowed = torch.rand(70, 130) > 0.5

    def calls():
        torch.ops.mv2d.roi_align(list(feats), rois, [4, 8, 16, 32])
        roi_align.roi_align_multilevel_backward(
            list(feats), rois, torch.randn(2, 8, 7, 7, 32), [4, 8, 16, 32])
        stage.fused_stage1(torch.randn(2, 8, 8, 64), [blk])
        attention.masked_attention(q, k, k, allowed, 4)
        dcn.dcn_conv(x, sy, sy, m, torch.randn(9, 32, 64))
        dcn.dcn_samples_forward(x, sy, sy, m)
    ev, _ = trace.profile(calls)
    ops = {c.op: roofline.bound_s(c.op, c.shapes, c.dtypes, 'float')
           for c in trace.op_calls(ev)}
    assert set(ops) >= {'roi_align', 'roi_align_bwd', 'bottleneck',
                        'mask_bits', 'masked_attention', 'dcn_conv',
                        'dcn_samples'}
    assert all(v is not None and v > 0 for v in ops.values()), ops
    # RoIAlign: levels, RoIs and the output, float32
    lv = sum(f.numel() for f in feats) * 4
    out = 2 * 8 * 49 * 32 * 4
    assert abs(ops['roi_align'] * roofline.PEAK_BYTES_S
               - (lv + rois.numel() * 4 + out)) < 1
