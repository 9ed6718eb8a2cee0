"""End-to-end eval wall clock of the port WITH the host pipeline in the
loop: the counterpart of the repository's `tools/eval_e2e_bench.py`.

It runs the eval loop of `eval.runner.run_eval` (its body,
`eval.runner.eval_scenes`) - Prefetcher threads (JPEG decode + the C++
pool, `data.nuscenes.get_sample`) -> `to_eval_inputs` (host-to-device
copy, cast on the device) -> `MV2D.forward` -> pred dicts - on a
rendered fixture at full width, with a device synchronize after the copy
and after the forward so that each part can be timed, and
prints samples/s (best of --repeat) and the ms of each scene split into
its parts:
  * sample:  `get_sample` in its worker thread (decode + pool), the mean
             over the scenes; it overlaps the other parts;
  * wait:    the loop blocked on the Prefetcher's queue;
  * h2d:     `to_eval_inputs`, ending in a device synchronize;
  * forward: `MV2D.forward`, ending in `torch.cuda.synchronize()`;
  * convert: detections to the host and `boxes_to_pred_dict`.
Then one scene's sample alone, with no other thread running (best of 3):
its JPEG decodes (`decode`) and its C++ pool call (`pool`).

  python -m mv2d_tpu_torch.tools.eval_e2e_bench [--fixture DIR]
      [--config configs/mv2d/mv2d_r50_frcnn_two_frames_1408x512_ep24.py]
      [--checkpoint X.pth] [--samples 24] [--repeat 3] [--device cuda]

Without --fixture, 8 val scenes of `make_synth_fixture` (1600x900 JPEGs,
14 objects a scene) are rendered into a temporary directory, which is
removed at the end.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import pipeline
from ..data.nuscenes import to_eval_inputs
from ..eval.runner import eval_scenes
from .common import (build_dataset, build_model, device_and_dtype,
                     load_cli_config, load_weights)
from .make_synth_fixture import make_fixture

R50 = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                   os.pardir, 'configs', 'mv2d',
                   'mv2d_r50_frcnn_two_frames_1408x512_ep24.py')
PARTS = ('sample', 'wait', 'h2d', 'forward', 'convert')


def sample_parts(dataset, idx: int = 0, repeat: int = 3) -> dict:
    """ms of one test-mode scene's JPEG decodes and C++ pool call, run
    alone (best of `repeat`)."""
    info = dataset.get_info(idx)
    paths = dataset._gather_views(info, np.random.default_rng(0))[0]
    p = pipeline.sample_ida(np.random.default_rng(0), dataset.ida, False)
    decode, pool = [], []
    for _ in range(repeat):
        t0 = time.perf_counter()
        imgs = [dataset._read_image(x) for x in paths]
        t1 = time.perf_counter()
        pipeline.native_preprocess(imgs, p)
        t2 = time.perf_counter()
        decode.append(t1 - t0)
        pool.append(t2 - t1)
    return {'decode': 1e3 * min(decode), 'pool': 1e3 * min(pool)}


def run(model, dataset, device, samples: int = 24, repeat: int = 3,
        verbose: bool = True) -> dict:
    """Times the eval loop (`eval.runner.eval_scenes`, the body that
    `run_eval` runs, with its device synchronizes on) `repeat` times over
    `samples` scenes (the dataset's scenes in turn) after one warm-up
    forward.  Returns {'samples_per_s': best rate, 'ms': {part: mean ms a
    scene in the best repeat}, 'rates': [samples/s of each repeat],
    'alone': sample_parts(dataset)}."""
    device = torch.device(device)
    dtype = next(model.parameters()).dtype
    idxs = [i % len(dataset) for i in range(samples)]
    with torch.inference_mode():
        model(*to_eval_inputs(dataset.get_sample(0), device, dtype))
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    rates, splits = [], []
    for rep in range(repeat):
        t = {}
        t0 = time.perf_counter()
        for _ in eval_scenes(model, dataset, idxs, device, times=t):
            pass
        dt = time.perf_counter() - t0
        rates.append(samples / dt)
        split = {'sample': 1e3 * float(np.mean(t['sample_seconds'])),
                 **{k: 1e3 * t[k] / samples for k in PARTS[1:]}}
        splits.append(split)
        if verbose:
            print(f'rep {rep}: {rates[-1]:.3f} samples/s '
                  f'({dt / samples * 1e3:.1f} ms/scene) incl host '
                  'pipeline; ms/scene '
                  + ', '.join(f'{k} {v:.1f}' for k, v in split.items()),
                  flush=True)
    best = int(np.argmax(rates))
    return {'samples_per_s': rates[best], 'ms': splits[best],
            'rates': rates, 'alone': sample_parts(dataset)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument('--fixture', default=None,
                   help='a make_synth_fixture directory (else one is '
                        'rendered into a temporary directory)')
    p.add_argument('--config', default=R50)
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--samples', type=int, default=24)
    p.add_argument('--repeat', type=int, default=3)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    device, dtype = device_and_dtype(args.device)
    tmp = None
    fixture = args.fixture
    if fixture is None:
        fixture = tmp = tempfile.mkdtemp(prefix='e2e_bench_')
        make_fixture(fixture, scenes=0, val_scenes=8)
    try:
        cfg = load_cli_config(args.config, [
            f'data.val.info_path={os.path.join(fixture, "infos_val.pkl")!r}',
            f'data.val.ann2d_path={os.path.join(fixture, "coco_val.json")!r}'])
        model = load_weights(build_model(cfg), args.checkpoint)
        model = model.eval().to(device, dtype)
        out = run(model, build_dataset(cfg, 'val'), device, args.samples,
                  args.repeat)
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    print(f'e2e eval rate: {out["samples_per_s"]:.3f} samples/s (best of '
          f'{args.repeat}); ms/scene '
          + ', '.join(f'{k} {v:.1f}' for k, v in out['ms'].items())
          + '; one sample alone: '
          + ', '.join(f'{k} {v:.1f} ms' for k, v in out['alone'].items()))
    return out


if __name__ == '__main__':
    main()
