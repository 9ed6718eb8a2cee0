"""The hand-written kernels as `torch.library` operators (namespace `mv2d`).

One operator for each C entry point of `kernels.SIGNATURES`, defined on a
`torch.library.Library('mv2d', 'DEF')` with three implementations:

* CUDA: the kernel's launch (the checks, the allocations and
  `kernels.launch`, in the `*_cuda` functions of `ops.stage`, `ops.dcn`,
  `ops.roi_align`, `ops.attention` and `ops.nms`), which also counts the
  launch on its wrapper (`fused_stage1.launches`, ...);
* CPU: the kernel's plain PyTorch version;
* fake (`register_fake`): the outputs' shapes and dtypes from the inputs',
  so that `torch.export` and `FlopCounterMode` see each kernel as one
  opaque node.

The dispatcher picks the implementation by the inputs' device: a CUDA
tensor never reaches a plain version, a tensor on any other device (meta)
goes to the launch, which refuses it, and a failed build or launch
raises.  The attention operators take the mask twice, as each
implementation reads it: `allowed` [Q, K] for the plain version (None in
the backward: the plain version unpacks the bits), and its `MaskTiles`
for the kernels.
The wrappers of the ops modules are thin calls of these operators; the
training kernels stay under their `autograd.Function`s, which call them.
The operators carry no gradient formula: on the CPU the differentiable
wrappers take the plain versions' autograd.

An exported program (`tools.export`) holds `torch.ops.mv2d.*` nodes, so
loading it needs `import mv2d_tpu_torch.ops.library` and no model code.
The binding is the dispatcher's own (`Library.impl`), without
`torch.library.custom_op`'s Python layer: the eval forward makes 27 of
these calls, and the main path is host-bound.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from . import attention, dcn, nms, roi_align, stage

LIB = torch.library.Library('mv2d', 'DEF')


class Op(NamedTuple):
    entry: str          # the C entry point of kernels.SIGNATURES
    cpu: Callable       # the plain version
    cuda: Callable      # the launch


# operator name (torch.ops.mv2d.<name>) -> its implementations
OPS: Dict[str, Op] = {}


def _op(schema: str, entry: str, cpu, cuda, fake) -> None:
    name = schema.split('(', 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, 'CPU')
    LIB.impl(name, cuda, 'CUDA')
    torch.library.register_fake(f'mv2d::{name}', fake, lib=LIB)
    # a tensor on another device (meta) goes to the kernel, which refuses
    # it (`kernels.check_cuda`); tracing still takes the fake
    LIB.impl(name, cuda, 'Meta', allow_override=True)
    OPS[name] = Op(entry, cpu, cuda)


def _blk(w1, b1, w2, b2, w3, b3, wd=None, bd=None):
    blk = dict(w1=w1, b1=b1, w2=w2, b2=b2, w3=w3, b3=b3)
    if wd is not None:
        blk.update(wd=wd, bd=bd)
    return blk


# ------------------------------------------------------------ K1, B10

_BLOCK = ('Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, '
          'Tensor w3, Tensor b3')
_op(f'bottleneck({_BLOCK}, Tensor? wd, Tensor? bd) -> Tensor',
    'mv2d_bottleneck',
    lambda x, *w: stage.bottleneck_plain(x, _blk(*w)),
    lambda x, *w: stage.bottleneck_cuda(x, _blk(*w)),
    lambda x, w1, *_: x.new_empty((*x.shape[:3], 4 * w1.shape[1])))
_op(f'identity_block({_BLOCK}) -> Tensor', 'mv2d_identity_block',
    lambda x, *w: stage.bottleneck_plain(x, _blk(*w)),
    lambda x, *w: stage.identity_block_cuda(x, _blk(*w)),
    lambda x, *_: torch.empty_like(x))

# ------------------------------------------------- K2, B5, B6, B13

_COORDS = 'Tensor x, Tensor sy, Tensor sx, Tensor mask'


def _f32_like(t):
    return t.new_empty(t.shape, dtype=torch.float32)


_op(f'dcn_conv({_COORDS}, Tensor w) -> Tensor', 'mv2d_dcn_conv',
    dcn.dcn_conv_plain, dcn.dcn_conv_cuda,
    lambda x, sy, sx, mask, w: x.new_empty((*sy.shape[:3], w.shape[-1])))
_op(f'dcn_samples({_COORDS}) -> Tensor', 'mv2d_dcn_samples',
    dcn.dcn_samples_plain, dcn.dcn_samples_cuda,
    lambda x, sy, sx, mask: x.new_empty((*sy.shape, x.shape[-1])))
_op(f'dcn_samples_bwd({_COORDS}, Tensor dsamples) '
    '-> (Tensor, Tensor, Tensor, Tensor)', 'mv2d_dcn_samples_bwd',
    dcn.dcn_samples_backward_plain, dcn.dcn_samples_backward_cuda,
    lambda x, sy, sx, mask, ds: (torch.empty_like(x), _f32_like(sy),
                                 _f32_like(sy), _f32_like(sy)))
_op(f'dcn_conv_bwd({_COORDS}, Tensor w, Tensor dy) '
    '-> (Tensor, Tensor, Tensor, Tensor, Tensor)', 'mv2d_dcn_conv_bwd',
    dcn.dcn_conv_backward_plain, dcn.dcn_conv_backward_cuda,
    lambda x, sy, sx, mask, w, dy: (torch.empty_like(x), _f32_like(sy),
                                    _f32_like(sy), _f32_like(sy),
                                    torch.empty_like(w)))

# ------------------------------------------------- K3, B11, B12, B9


def _roi_out(feats, rois):
    return feats[0].new_empty((*rois.shape[:-1], 7, 7, feats[0].shape[-1]))


_op('roi_align(Tensor[] feats, Tensor rois, int[] strides) -> Tensor',
    'mv2d_roi_align', roi_align.multilevel_roi_align_plain,
    roi_align.roi_align_multilevel_cuda,
    lambda feats, rois, strides: _roi_out(feats, rois))
_op('roi_align_slab(Tensor[] feats, Tensor rois, int[] strides) -> Tensor',
    'mv2d_roi_align_slab', roi_align.multilevel_roi_align_plain,
    roi_align.roi_align_slab_cuda,
    lambda feats, rois, strides: _roi_out(feats, rois))
_op('roi_align_flat(Tensor[] feats, Tensor rois, Tensor view_idx, '
    'int[] strides, int sampling_ratio) -> Tensor', 'mv2d_roi_align_flat',
    roi_align.multilevel_roi_align_flat_plain, roi_align.roi_align_flat_cuda,
    lambda feats, rois, view_idx, strides, s: _roi_out(feats, rois))
_op('roi_align_bwd(Tensor[] feats, Tensor rois, Tensor dout, int[] strides)'
    ' -> Tensor[]', 'mv2d_roi_align_bwd', roi_align.roi_align_backward_plain,
    roi_align.roi_align_multilevel_backward_cuda,
    lambda feats, rois, dout, strides: [torch.empty_like(f) for f in feats])

# ----------------------------------------------- mask_bits, K4, B8


def _bits_fake(allowed):
    Q, K = allowed.shape
    return allowed.new_empty((Q, -(-K // attention.SPARSE_TILE)),
                             dtype=torch.int64)


def _attention_plain(q, k, v, allowed, bits, key_starts, key_tiles,
                     num_heads):
    return (attention.masked_attention_plain(q, k, v, allowed, num_heads),
            attention.attention_lse_plain(q, k, allowed,
                                          num_heads).contiguous())


def _attention_bwd_plain(q, k, v, allowed, bits, key_starts, key_tiles,
                         query_starts, query_tiles, out, lse, dout,
                         num_heads):
    if allowed is None:
        allowed = attention.mask_from_bits(bits, k.shape[0])
    return attention.masked_attention_backward_plain(
        q, k, v, allowed, out, lse, dout, num_heads)


def _f32(t, *shape):
    return t.new_empty(shape, dtype=torch.float32)


_op('mask_bits(Tensor allowed) -> Tensor', 'mv2d_mask_bits',
    lambda allowed: attention.mask_bits_plain(allowed).view(torch.int64),
    attention.mask_bits_cuda, _bits_fake)
_op('masked_attention(Tensor q, Tensor k, Tensor v, Tensor allowed, '
    'Tensor bits, Tensor key_starts, Tensor key_tiles, int num_heads) '
    '-> (Tensor, Tensor)',
    'mv2d_masked_attention', _attention_plain,
    attention.masked_attention_cuda,
    lambda q, k, v, allowed, bits, ks, kt, H: (torch.empty_like(q),
                                               _f32(q, q.shape[0], H)))
_op('masked_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor? allowed, '
    'Tensor bits, Tensor key_starts, Tensor key_tiles, Tensor query_starts, '
    'Tensor query_tiles, Tensor out, Tensor lse, Tensor dout, '
    'int num_heads) -> (Tensor, Tensor, Tensor)',
    'mv2d_masked_attention_bwd', _attention_bwd_plain,
    attention.masked_attention_backward_cuda,
    lambda q, k, v, *tiles_out_lse_dout_h: (_f32(q, *q.shape),
                                            _f32(k, *k.shape),
                                            _f32(v, *v.shape)))

# ------------------------------------------------------------------- NMS

_op('nms_keep(Tensor boxes, Tensor valid, float iou_threshold) -> Tensor',
    'mv2d_nms_keep', nms.nms_keep_plain, nms.nms_keep_cuda,
    lambda boxes, valid, thr: valid.new_empty(valid.shape,
                                              dtype=torch.bool))
