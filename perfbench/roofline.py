"""The least time each hand-kernel operator call could take on one NVIDIA
H100 SXM (NVIDIA's data sheet, dense: 989 TFLOP/s bf16 on the tensor
cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of HBM), from the
call's input shapes and dtypes: the larger of its operations over the
peak and its bytes over the bandwidth, each input read once and each
output written once (`PERF.md` section 6's Bound column of the port).

Where the work depends on the data (the attention kernels skip masked
tiles; RoIAlign samples adaptively), only the bytes are counted, which
keeps the bound a lower bound.  RoIAlign's forward reads its feature
levels whole (within 3% of the cells its RoIs' footprints cover at this
traffic's 1000 anchor-shaped RoIs a view, PERF.md section 6); its
backward writes them whole.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
PEAK_BYTES_S = 3.35e12

_SIZE = {'c10::BFloat16': 2, 'c10::Half': 2, 'float': 4, 'double': 8,
         'long int': 8, 'long': 8, 'long unsigned int': 8,
         'unsigned long': 8, 'int': 4, 'bool': 1, 'unsigned char': 1,
         'signed char': 1}


def _n(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def _b(shape, dtype) -> int:
    return _n(shape) * _SIZE.get(dtype, 4)


def _tensors(shapes, dtypes, list_dtype, levels) -> List[Tuple[tuple, str]]:
    """Flatten an op's inputs to (shape, dtype) of each tensor; a tensor
    list (the feature levels) comes as a list of shapes, in `list_dtype`
    (the profiler records no dtype for a list).  Where the profiler
    recorded no list shapes, `levels` gives them: [(h, w, C)] of each
    level, on as many views as the RoIs' first dim."""
    out = []
    for i, (s, d) in enumerate(zip(shapes, dtypes)):
        if d == 'TensorList':
            if not s and levels:
                V = shapes[i + 1][0] if i + 1 < len(shapes) and \
                    len(shapes[i + 1]) == 3 else None
                s = [(V, *lv) for lv in levels] if V else []
            out += [(tuple(x), list_dtype) for x in s]
        elif d not in ('Scalar', 'ScalarList', '') and isinstance(
                s, (list, tuple)):
            out.append((tuple(s), d))
    return out


def _bottleneck(ins):
    (x, dx), *w = ins
    cin, p = w[0][0]                    # w1 [Cin, P]
    out_c = 4 * p
    n = _n(x[:3])
    macs = cin * p + 9 * p * p + p * out_c + (cin * out_c if len(w) > 6
                                              else 0)
    by = _b(x, dx) + sum(_b(s, d) for s, d in w) + _b((*x[:3], out_c), dx)
    return 2 * n * macs, by


def _dcn_conv(ins):
    (x, dx), (sy, _), _, _, (w, dw) = ins[:5]
    F = w[-1]
    by = _b(x, dx) + 3 * _b(sy, 'float') + _b(w, dw) + _b((*sy[:3], F), dx)
    return 2 * _n(sy) * x[-1] * F + 9 * _n(sy) * x[-1], by


def _dcn_samples(ins):
    (x, dx), (sy, _) = ins[:2]
    by = _b(x, dx) + 3 * _b(sy, 'float') + _b((*sy, x[-1]), dx)
    return 9 * _n(sy) * x[-1], by


def _dcn_samples_bwd(ins):
    (x, dx), (sy, _), _, _, (ds, dd) = ins[:5]
    by = (_b(x, dx) + 3 * _b(sy, 'float') + _b(ds, dd)     # read
          + _b(x, dx) + 3 * _b(sy, 'float'))               # written
    return 16 * _n(sy) * x[-1], by


def _dcn_conv_bwd(ins):
    (x, dx), (sy, _), _, _, (w, dw), (dy, ddy) = ins[:6]
    C, F = x[-1], w[-1]
    by = (_b(x, dx) + 3 * _b(sy, 'float') + _b(w, dw) + _b(dy, ddy)
          + _b(x, dx) + 3 * _b(sy, 'float') + _b(w, dw))
    return 4 * _n(sy) * C * F + 16 * _n(sy) * C, by


def _roi_align(ins):
    feats = [t for t in ins if len(t[0]) == 4]
    rois = next(t for t in ins if len(t[0]) in (2, 3) and t[0][-1] == 4)
    C, dt = feats[0][0][-1], feats[0][1]
    out = _b((*rois[0][:-1], 7, 7, C), dt)
    return 0, sum(_b(s, d) for s, d in feats) + _b(*rois) + out


def _roi_align_bwd(ins):
    feats = [t for t in ins if len(t[0]) == 4]
    rois = next(t for t in ins if len(t[0]) in (2, 3) and t[0][-1] == 4)
    dout = next(t for t in ins if len(t[0]) == 5)
    return 0, _b(*rois) + _b(*dout) + sum(_b(s, d) for s, d in feats)


def _mask_bits(ins):
    (a, da), = ins[:1]
    Q, K = a
    return 0, _b(a, da) + Q * (-(-K // 64)) * 8


def _attention(ins):
    (q, dq), (k, dk), (v, dv), _, bits, ks, kt = ins[:7]
    by = sum(_b(s, d) for s, d in ((q, dq), (k, dk), (v, dv), bits, ks, kt))
    return 0, by + _b(q, dq) + q[0] * 8 * 4


def _attention_bwd(ins):
    (q, dq), (k, dk), (v, dv) = ins[:3]
    rest = ins[3:]          # allowed may be absent: bits.. dout
    by = sum(_b(s, d) for s, d in ((q, dq), (k, dk), (v, dv)))
    by += sum(_b(s, d) for s, d in rest if len(s) >= 1 and d != 'bool')
    return 0, by + 4 * (_n(q) + _n(k) + _n(v))


FORMULAS: Dict[str, Callable] = {
    'bottleneck': _bottleneck, 'identity_block': _bottleneck,
    'dcn_conv': _dcn_conv, 'dcn_samples': _dcn_samples,
    'dcn_samples_bwd': _dcn_samples_bwd, 'dcn_conv_bwd': _dcn_conv_bwd,
    'roi_align': _roi_align, 'roi_align_slab': _roi_align,
    'roi_align_flat': _roi_align, 'roi_align_bwd': _roi_align_bwd,
    'mask_bits': _mask_bits, 'masked_attention': _attention,
    'masked_attention_bwd': _attention_bwd,
}


def bound_s(op: str, shapes: Sequence, dtypes: Sequence,
            list_dtype: str = 'c10::BFloat16',
            levels: Optional[Sequence[tuple]] = None) -> Optional[float]:
    """The least seconds a call of `mv2d::op` could take, or None where
    the op has no formula or its shapes were not recorded.  `list_dtype`:
    the dtype of a tensor list's tensors (the activations'); `levels`:
    see `_tensors`."""
    f = FORMULAS.get(op)
    ins = _tensors(shapes, dtypes, list_dtype, levels)
    if f is None or not ins:
        return None
    try:
        ops, by = f(ins)
    except (ValueError, IndexError, StopIteration, TypeError):
        return None
    bf16 = any(d == 'c10::BFloat16' for _, d in ins)
    peak = PEAK_FLOPS['bfloat16' if bf16 else 'float32']
    return max(ops / peak, by / PEAK_BYTES_S)


def share(calls, list_dtype: str = 'c10::BFloat16',
          levels: Optional[Sequence[tuple]] = None) -> Optional[float]:
    """Summed bound over summed device time of `trace.OpCall`s with a
    formula and device time, in %; None where there is none."""
    bound = dev = 0.0
    for c in calls:
        b = bound_s(c.op, c.shapes, c.dtypes, list_dtype, levels)
        if b is None or c.device_us <= 0:
            continue
        bound += b
        dev += c.device_us / 1e6
    return None if dev == 0 else 100.0 * bound / dev
