"""Evaluation loop: dataset -> predictions -> nuScenes metrics.

The port's counterpart of `mv2d_tpu/eval/runner.py`: the `Prefetcher`'s
threads read and preprocess the scenes, and each scene runs one eval
forward (`MV2D.forward`) in the model's dtype under
`torch.inference_mode()`.  `eval_scenes` is the loop's body; the e2e
bench times the same body.  In a process group (`parallel.dist.DistInfo`,
one process a GPU under torchrun) rank r evaluates the scenes r, r + N,
... and rank 0 gathers every scene's predictions, as the JAX runner
shards groups of scenes over its devices.
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
             collect_submission: bool = False, dist_info=None
             ) -> Tuple[Optional[Dict[str, float]], Optional[dict]]:
    """Returns (metrics, submission_json_or_None).

    `model` is an `MV2D` already on `device`, in its eval dtype.  The
    scenes arrive out of order; their predictions are keyed by token, and
    the metrics take them in dataset order.  With `dist_info` (a
    `parallel.dist.DistInfo` whose group is set) rank r of N runs the
    scenes r, r + N, ..., their predictions, GT and tokens go to rank 0
    (`gather_object`), and rank 0 computes the metrics and the submission
    over all scenes in dataset order, so they equal a one-process run's;
    every other rank returns (None, None)."""
    n = min(max_samples or len(dataset), len(dataset))
    group = dist_info.group if dist_info is not None else None
    rank, world = (dist_info.rank, dist_info.world) if group is not None \
        else (0, 1)
    verbose = verbose and rank == 0
    rows: Dict[int, tuple] = {}
    t0 = time.time()
    for idx, s, preds in eval_scenes(model, dataset, range(rank, n, world),
                                     device):
        rows[idx] = (s['token'], preds,
                     res.gt_dict_from_info(dataset.get_info(idx)))
        done = len(rows) * world
        if verbose and len(rows) % 48 == 0:
            print(f'eval ~{done}/{n}  '
                  f'{done / (time.time() - t0):.2f} samples/s', flush=True)
    if group is not None:
        import torch.distributed as dist
        parts = [None] * world if rank == 0 else None
        dist.gather_object(rows, parts, dst=0, group=group)
        if rank != 0:
            return None, None
        rows = {i: r for part in parts for i, r in part.items()}
    rows = [rows[i] for i in sorted(rows)]
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
