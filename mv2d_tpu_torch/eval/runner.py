"""Evaluation loop: dataset -> predictions -> nuScenes metrics.

The port's counterpart of `mv2d_tpu/eval/runner.py` on one device: the
`Prefetcher`'s threads read and preprocess the scenes, and each scene runs
one eval forward (`MV2D.forward`) in the model's dtype under
`torch.inference_mode()`.  `eval_scenes` is the loop's body; the e2e
bench times the same body.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from ..data.nuscenes import NuScenesDataset, Prefetcher, to_eval_inputs
from . import nuscenes_eval
from . import results as res


def eval_scenes(model, dataset: NuScenesDataset, idxs: Sequence[int],
                device='cuda', times: Optional[dict] = None
                ) -> Iterator[Tuple[int, dict, dict]]:
    """The eval loop's body, which `run_eval` and
    `tools.eval_e2e_bench` share: yields (idx, sample, pred_dict) for each
    scene of `idxs` as the `Prefetcher` hands it over.

    With a `times` dict the loop also synchronizes the device after the
    copy and after the forward, and adds each part's seconds to
    times['wait'] (blocked on the Prefetcher), times['h2d']
    (`to_eval_inputs`), times['forward'] and times['convert'] (detections
    to the host and `boxes_to_pred_dict`); at the end
    times['sample_seconds'] lists each `get_sample` call's seconds in
    its worker thread."""
    dtype = next(model.parameters()).dtype
    sync = times is not None and torch.device(device).type == 'cuda'
    clock = time.perf_counter
    pf = Prefetcher(dataset, list(idxs), seed=0)
    try:
        it = iter(pf)
        while True:
            a = clock()
            try:
                idx, s = next(it)
            except StopIteration:
                break
            b = clock()
            with torch.inference_mode():
                inputs = to_eval_inputs(s, device, dtype)
                if sync:
                    torch.cuda.synchronize(device)
                c = clock()
                det = model(*inputs)
                if sync:
                    torch.cuda.synchronize(device)
                d = clock()
                preds = res.boxes_to_pred_dict(*res.detections_numpy(det),
                                               info=dataset.get_info(idx))
            e = clock()
            if times is not None:
                for k, x, y in (('wait', a, b), ('h2d', b, c),
                                ('forward', c, d), ('convert', d, e)):
                    times[k] = times.get(k, 0.0) + y - x
            yield idx, s, preds
    finally:
        pf.close()
        if times is not None:
            times['sample_seconds'] = list(pf.sample_seconds)


def run_eval(model, dataset: NuScenesDataset, device='cuda',
             max_samples: Optional[int] = None, verbose: bool = True,
             collect_submission: bool = False
             ) -> Tuple[Dict[str, float], Optional[dict]]:
    """Returns (metrics, submission_json_or_None).

    `model` is an `MV2D` already on `device`, in its eval dtype.  The
    scenes arrive out of order; their predictions are keyed by token, and
    the metrics take them in dataset order."""
    n = min(max_samples or len(dataset), len(dataset))
    by_index: Dict[int, tuple] = {}
    t0 = time.time()
    for idx, s, preds in eval_scenes(model, dataset, range(n), device):
        by_index[idx] = (s['token'], preds,
                         res.gt_dict_from_info(dataset.get_info(idx)))
        done = len(by_index)
        if verbose and done % 48 == 0:
            print(f'eval {done}/{n}  '
                  f'{done / (time.time() - t0):.2f} samples/s', flush=True)
    rows = [by_index[i] for i in sorted(by_index)]
    tokens = [r[0] for r in rows]
    preds = [r[1] for r in rows]
    metrics = nuscenes_eval.evaluate(preds, [r[2] for r in rows])
    submission = None
    if collect_submission:
        infos_by_token = {}
        for i in range(n):
            info = dataset.get_info(i)
            infos_by_token[info['token']] = info
        submission = res.to_nuscenes_submission(tokens, preds,
                                                infos_by_token)
    return metrics, submission
