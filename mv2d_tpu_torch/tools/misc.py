"""Small utilities of the port: the counterpart of the repository's
`tools/misc.py` (the reference's tools/misc/*), subcommand for subcommand.

  python -m mv2d_tpu_torch.tools.misc print_config <config> [--cfg-options ...]
  python -m mv2d_tpu_torch.tools.misc publish <epoch_N.pth> <out.pth>
  python -m mv2d_tpu_torch.tools.misc browse <config> [--index 0] [--val]
  python -m mv2d_tpu_torch.tools.misc update_data_coords <in.pkl> <out.pkl>
  python -m mv2d_tpu_torch.tools.misc fuse_conv_bn <in.pth> <out.pth>

Checkpoints are the port's torch files (`train.checkpoint`: a state dict
with the reference's key names, optionally under 'state_dict'); what
`publish` and `fuse_conv_bn` write, `tools.test`, `tools.serve` and
`tools.export` load with strict=True.
"""
from __future__ import annotations

import argparse
import json
import pickle
from typing import Optional, Sequence

import numpy as np
import torch

from ..train.checkpoint import load_checkpoint
from .common import build_dataset, load_cli_config

# the frozen BN's eps (FrozenBatchNorm2d, mmdet's BN)
BN_EPS = 1e-5


def print_config(args):
    cfg = load_cli_config(args.config, args.cfg_options)
    print(json.dumps(cfg, indent=2, default=str))


def publish(args):
    """A training checkpoint (meta, state_dict, optimizer) -> a
    weights-only file {'meta', 'state_dict'} without the optimizer state
    (the reference's publish_model.py)."""
    ckpt = load_checkpoint(args.src)
    torch.save({'meta': ckpt['meta'], 'state_dict': ckpt['state_dict']},
               args.dst)
    print(f'published {len(ckpt["state_dict"])} tensors without the '
          f'optimizer state to {args.dst}')


def browse(args):
    cfg = load_cli_config(args.config, args.cfg_options)
    ds = build_dataset(cfg, 'train' if not args.val else 'val')
    s = ds.get_sample(args.index, np.random.default_rng(0))
    for k, v in s.items():
        if isinstance(v, np.ndarray):
            print(f'{k:16s} {v.shape} {v.dtype} '
                  f'[{np.asarray(v, np.float64).min():.3f}, '
                  f'{np.asarray(v, np.float64).max():.3f}]')
        else:
            print(f'{k:16s} {v}')


def update_data_coords(args):
    """Migrate pre-v1.0 mmdet3d infos pkls to the current LiDAR box
    convention (the reference's tools/update_data_coords.py): old boxes are
    (x, y, z, w, l, h, yaw_old) with yaw measured from +x clockwise; the
    v1.0 convention is (x, y, z, l, w, h, yaw) with yaw = -yaw_old - pi/2.
    Current-format pkls (metadata version tag >= 1.0) pass through."""
    with open(args.src, 'rb') as f:
        data = pickle.load(f)
    infos = data['infos'] if isinstance(data, dict) else data
    meta = data.get('metadata', {}) if isinstance(data, dict) else {}
    ver = str(meta.get('version_coords', meta.get('coord_version', '')))
    if ver.startswith('1.'):
        print('already v1.0 coords; copying through')
    else:
        for info in infos:
            gt = np.asarray(info.get('gt_boxes', np.zeros((0, 7))),
                            np.float64)
            if gt.size:
                gt = gt.copy()
                gt[:, [3, 4]] = gt[:, [4, 3]]            # w,l -> l,w
                gt[:, 6] = -gt[:, 6] - np.pi / 2
                info['gt_boxes'] = gt
        meta = dict(meta, coord_version='1.0')
    out = {'infos': infos, 'metadata': meta}
    with open(args.dst, 'wb') as f:
        pickle.dump(out, f)
    print(f'wrote {len(infos)} infos to {args.dst}')


def _conv_of(bn: str) -> Optional[str]:
    """The key prefix of the conv a frozen BN follows: ResNet's convK /
    bnK and downsample.0 / .1, VoVNet's <name>/conv / <name>/norm."""
    head, _, last = bn.rpartition('.')
    if last.startswith('bn') and last[2:].isdigit():
        return f'{head}.conv{last[2:]}'
    if bn.endswith('downsample.1'):
        return bn[:-1] + '0'
    if bn.endswith('/norm'):
        return bn[:-len('norm')] + 'conv'
    return None


def fold_conv_bn(sd: dict) -> int:
    """Folds, in place in the state dict `sd`, each frozen BN into the conv
    before it: w <- w s and the conv's bias (if any) <- bias s, with
    s = gamma / sqrt(var + eps); the BN keeps bias b - mean s, mean 0,
    var 1 and scale sqrt(1 + eps), so that it multiplies by exactly 1 in
    the model (with scale 1 a frozen BN would multiply by 1 / sqrt(1 +
    eps), 5e-6 a layer).  Computed in float32, each tensor kept in its
    dtype.  Returns the number of pairs folded."""
    n = 0
    for key in [k for k in sd if k.endswith('.running_var')]:
        bn = key[:-len('.running_var')]
        conv = _conv_of(bn)
        if conv is None or f'{conv}.weight' not in sd:
            continue
        gamma, beta = sd[f'{bn}.weight'].float(), sd[f'{bn}.bias'].float()
        mean, var = sd[f'{bn}.running_mean'].float(), sd[key].float()
        s = gamma / torch.sqrt(var + BN_EPS)
        w = sd[f'{conv}.weight']
        sd[f'{conv}.weight'] = (w.float() * s.reshape(-1, *[1] * (w.dim() - 1))
                                ).to(w.dtype)
        if f'{conv}.bias' in sd:
            b = sd[f'{conv}.bias']
            sd[f'{conv}.bias'] = (b.float() * s).to(b.dtype)
        one = torch.ones_like(var)
        for name, val in (('weight', torch.sqrt(one + BN_EPS)),
                          ('bias', beta - mean * s),
                          ('running_mean', torch.zeros_like(mean)),
                          ('running_var', one)):
            t = sd[f'{bn}.{name}']
            sd[f'{bn}.{name}'] = val.to(t.dtype)
        n += 1
    return n


def fuse_conv_bn(args):
    """A checkpoint whose frozen BN statistics are folded into the conv
    weights (the reference's tools/misc/fuse_conv_bn.py): the port folds
    frozen BN into its convs at run time (and K1 / B10 take folded blocks),
    so inference is the same either way; the file is for consumers of the
    weights outside the port, and still loads into the unmodified model
    with strict=True."""
    ckpt = load_checkpoint(args.src)
    sd = dict(ckpt['state_dict'])
    n = fold_conv_bn(sd)
    torch.save({'meta': ckpt['meta'], 'state_dict': sd}, args.dst)
    print(f'fused {n} conv+bn pairs -> {args.dst}')


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest='task', required=True)
    pc = sub.add_parser('print_config')
    pc.add_argument('config')
    pc.add_argument('--cfg-options', nargs='*', default=None)
    pub = sub.add_parser('publish')
    pub.add_argument('src')
    pub.add_argument('dst')
    br = sub.add_parser('browse')
    br.add_argument('config')
    br.add_argument('--index', type=int, default=0)
    br.add_argument('--val', action='store_true')
    br.add_argument('--cfg-options', nargs='*', default=None)
    uc = sub.add_parser('update_data_coords')
    uc.add_argument('src')
    uc.add_argument('dst')
    fb = sub.add_parser('fuse_conv_bn')
    fb.add_argument('src')
    fb.add_argument('dst')
    args = p.parse_args(argv)
    dict(print_config=print_config, publish=publish, browse=browse,
         update_data_coords=update_data_coords,
         fuse_conv_bn=fuse_conv_bn)[args.task](args)


if __name__ == '__main__':
    main()
