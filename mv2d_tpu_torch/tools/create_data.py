"""Offline nuScenes data preparation CLI of the port: the counterpart of
the repository's `tools/create_data.py`.

Replaces the reference's tools/create_data.py + tools/generate_sweep_pkl.py
(devkit-based) with the standalone raw-table converter
(`mv2d_tpu_torch.data.converter`): produces the infos pkls (incl.
historical camera sweeps for MV2D-T) and the mono3d 2D COCO json in one
pass.

  python -m mv2d_tpu_torch.tools.create_data nuscenes --root data/nuscenes \\
      --version v1.0-trainval --out-dir data/nuscenes --max-sweeps 25
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from ..data import converter


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument('dataset', choices=['nuscenes'])
    p.add_argument('--root', required=True)
    p.add_argument('--version', default='v1.0-trainval')
    p.add_argument('--out-dir', default=None)
    p.add_argument('--max-sweeps', type=int, default=25)
    p.add_argument('--splits-json', default=None,
                   help='json {"train": [scene names], "val": [...]}; '
                        'without it everything goes to train')
    args = p.parse_args(argv)
    out_dir = args.out_dir or args.root
    os.makedirs(out_dir, exist_ok=True)

    splits = None
    if args.splits_json:
        with open(args.splits_json) as f:
            splits = json.load(f)

    if splits is None:
        infos = converter.create_infos(args.root, args.version,
                                       max_sweeps=args.max_sweeps)
        sets = {'train': infos}
    else:
        sets = {}
        for split, scenes in splits.items():
            sets[split] = converter.create_infos(
                args.root, args.version, scene_names=set(scenes),
                max_sweeps=args.max_sweeps)

    for split, infos in sets.items():
        pkl = os.path.join(out_dir,
                           f'mmdet3d_nuscenes_30f_infos_{split}.pkl')
        converter.save_infos(pkl, infos,
                             metadata=dict(version=args.version))
        print(f'{split}: {len(infos)} samples -> {pkl}')
        coco = converter.export_2d_annotations(infos)
        jpath = os.path.join(out_dir,
                             f'nuscenes_infos_{split}_mono3d.coco.json')
        with open(jpath, 'w') as f:
            json.dump(coco, f)
        print(f'{split}: {len(coco["annotations"])} 2D boxes -> {jpath}')


if __name__ == '__main__':
    main()
