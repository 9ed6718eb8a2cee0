"""Model complexity report of the port: the counterpart of the
repository's `tools/get_flops.py` (which reads XLA's cost analysis; the
reference's tools/analysis_tools/get_flops.py).

  python -m mv2d_tpu_torch.tools.get_flops <config> [--cfg-options k=v ...]
      [--device cuda|cpu]

Runs one eval forward of one scene at the config's full width (bfloat16
on the GPU, the default; float32 with `--device cpu`) on N(0, 1) images
and `synthetic.camera_rig`, with `synthetic.init_random_weights(seed=0)`,
and prints:

* params: the parameters' element count;
* forward GFLOPs: `torch.utils.flop_counter.FlopCounterMode`'s count, with
  a `register_flop_formula` for every `mv2d` operator (`FORMULAS`);
  FlopCounterMode counts the products (matmuls, convolutions, attention)
  and no elementwise op.  The forward raises if it reaches an `mv2d`
  operator that has no formula;
* bytes: the sum over every dispatched operator that is not a view of
  its inputs' and outputs' bytes: an upper bound for an unfused forward,
  since each intermediate is counted once written and once per read.

The formulas see shapes, not data.  Masked attention counts the dense
product, 4 Q K C (Q K^T and P V), whatever the mask allows; its backward
10 Q K C (the scores again, dV, dP, dQ, dK).  RoIAlign's adaptive
sampling depends on each RoI's size, so it is counted at two samples a
bin and axis: 49 bins x 4 samples x 4 corners x 2 (a multiply-add) a RoI
and channel, or the fixed ratio where one is given.  The DCN conv counts
its 9C x F product and 9 interpolation FLOPs a sample and channel (four
corners' multiply-adds and the mask); the bottlenecks count their three
(four with the projection) convolutions; `mask_bits` packs bits and
`nms_keep` compares boxes, and they count none (the NMS's IoU is
elementwise work, which the count leaves out everywhere).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from ..ops import library  # noqa: F401  (the operators FORMULAS names)
from .common import build_model, device_and_dtype, load_cli_config
from .export import ServeForward, example_inputs


def _numel(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def _bottleneck(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None, **_):
    n = _numel(x[:3])
    cin, p = w1
    macs = cin * p + 9 * p * p + p * w3[1] + (cin * wd[1] if wd else 0)
    return 2 * n * macs


def _dcn_sampling(sy, C):
    """9 FLOPs a sample and channel: four corners' multiply-adds and the
    mask."""
    return 9 * _numel(sy) * C


def _dcn_conv(x, sy, sx, mask, w, **_):
    return 2 * _numel(sy) * x[-1] * w[-1] + _dcn_sampling(sy, x[-1])


def _dcn_samples(x, sy, sx, mask, **_):
    return _dcn_sampling(sy, x[-1])


def _dcn_samples_bwd(x, sy, sx, mask, ds, **_):
    """dx (four corners' multiply-adds) and the four corner dots, a sample
    and channel."""
    return 16 * _numel(sy) * x[-1]


def _dcn_conv_bwd(x, sy, sx, mask, w, dy, **_):
    """ds = dy w^T and dw = samples^T dy, the samples again and B6's
    walk."""
    prod = 2 * _numel(sy) * x[-1] * w[-1]
    return 2 * prod + _dcn_sampling(sy, x[-1]) + 16 * _numel(sy) * x[-1]


ROI_SAMPLES = 2          # samples a bin and axis where sampling is adaptive


def _roi(feats, rois, sampling_ratio=0):
    s = sampling_ratio if sampling_ratio > 0 else ROI_SAMPLES
    return _numel(rois[:-1]) * 49 * s * s * 4 * 2 * feats[0][-1]


def _attention(q, k, *rest, **_):
    return 4 * q[0] * k[0] * q[1]


def _attention_bwd(q, k, *rest, **_):
    return 10 * q[0] * k[0] * q[1]


FORMULAS = {
    'bottleneck': _bottleneck,
    'identity_block': _bottleneck,
    'dcn_conv': _dcn_conv,
    'dcn_samples': _dcn_samples,
    'dcn_samples_bwd': _dcn_samples_bwd,
    'dcn_conv_bwd': _dcn_conv_bwd,
    'roi_align': lambda feats, rois, strides, **_: _roi(feats, rois),
    'roi_align_slab': lambda feats, rois, strides, **_: _roi(feats, rois),
    'roi_align_flat': lambda feats, rois, view_idx, strides, s, **_:
        _roi(feats, rois, s),
    'roi_align_bwd': lambda feats, rois, dout, strides, **_:
        _roi(feats, rois),
    'mask_bits': lambda allowed, **_: 0,
    'nms_keep': lambda boxes, valid, iou_threshold, **_: 0,
    'masked_attention': _attention,
    'masked_attention_bwd': _attention_bwd,
}
for _name, _f in FORMULAS.items():
    register_flop_formula(getattr(torch.ops.mv2d, _name))(_f)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class OpTally(TorchDispatchMode):
    """Counts the dispatched operators (`calls`), the bytes of the inputs
    and outputs of each that is not a view, and the `mv2d` operators
    reached.  The NMS's
    `while_loop` runs its dense loop under the tally, so that the ops of
    its rounds are seen one by one (FlopCounterMode takes no higher-order
    operator)."""

    supports_higher_order_operators = True

    def __init__(self):
        super().__init__()
        self.calls = 0
        self.bytes = 0
        self.mv2d = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            if func.name() != 'while_loop':
                return NotImplemented
            from torch._higher_order_ops.while_loop import while_loop_dense
            with self:
                return while_loop_dense(*args, **kwargs)
        out = func(*args, **kwargs)
        self.calls += 1
        if func.namespace == 'mv2d':
            self.mv2d.add(func.overloadpacket)
        if not func.is_view:
            self.bytes += _bytes((args, kwargs)) + _bytes(out)
        return out


def count(fn, *args):
    """Runs fn(*args) under the counters -> (flops, bytes, the `mv2d`
    operators reached).  Raises if one of them has no flop formula."""
    from torch.utils.flop_counter import flop_registry
    with FlopCounterMode(display=False) as fc, OpTally() as tally:
        fn(*args)
    missing = [str(op) for op in tally.mv2d if op not in flop_registry]
    if missing:
        raise RuntimeError(f'no flop formula for {sorted(missing)}')
    return fc.get_total_flops(), tally.bytes, sorted(map(str, tally.mv2d))


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('config')
    p.add_argument('--cfg-options', nargs='*', default=None)
    p.add_argument('--device', default='cuda')
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the CLI; returns params, flops, bytes and the `mv2d` operators
    the forward reached."""
    from ..synthetic import init_random_weights
    args = parse_args(argv)
    device, dtype = device_and_dtype(args.device)
    cfg = load_cli_config(args.config, args.cfg_options)
    model = init_random_weights(build_model(cfg), seed=0)
    model = model.eval().to(device, dtype)
    mc = model.cfg
    V, (H, W) = mc.total_views, mc.image_size
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(V, H, W, 3)).astype(np.float32))
    images, *cam, shapes = example_inputs(mc, device, dtype, imgs)
    fwd = ServeForward(model)
    with torch.inference_mode():
        flops, nbytes, ops = count(fwd, images, *cam, shapes)
    params = sum(p.numel() for p in model.parameters())
    print(f'params:          {params / 1e6:.2f} M')
    print(f'forward flops:   {flops / 1e9:.1f} GFLOPs / sample ({V} views @ '
          f'{(H, W)}, {str(dtype)[6:]})')
    print(f'bytes accessed:  {nbytes / 1e9:.2f} GB (every dispatched op\'s '
          'inputs and outputs: an unfused upper bound)')
    print(f'kernel ops:      {", ".join(ops)}')
    return dict(params=params, flops=flops, bytes=nbytes, ops=ops)


if __name__ == '__main__':
    main()
