"""Data parallelism on torch.distributed: the counterpart of
`mv2d_tpu/parallel/mesh.py` (`make_dp_train_step`) and of the
repository's multi-chip dry run (`__graft_entry__.dryrun_multichip`).

One process a GPU, launched by torchrun (or one process, and no group,
without it): the parameters are replicated, each rank trains on its own
scenes, and every collective is explicit.  The step computes the JAX DP
step's function:

  * each scene's losses with the 3D bbox losses deferred
    (`train_step.compute_losses`);
  * each deferred key divided by max(mean over all scenes of all ranks of
    num_pos, 1): E[l] / E[n], the reference's cross-GPU `reduce_mean`,
    with the counts all-reduced without gradient;
  * the total averaged over the global batch: each rank back-propagates
    the mean over its own scenes, and the float32 master gradients are
    all-reduced as one flat bucket, summed, then divided by the world
    size;
  * then the clip and AdamW (`optim.apply_update`), and the logged
    metrics averaged over the global batch.

The mixed-precision forward runs on bfloat16 parameter copies through
`torch.func.functional_call`, so a DistributedDataParallel wrapper's
reducer would never see it; the explicit all-reduce takes its place and
is deterministic for a fixed world size.

One GPU runs the same step with a world of one, so the step that is
measured on one card is the step that trains on many.

  python -c "from mv2d_tpu_torch.parallel.dist import dryrun; dryrun(2)"
      (two GPUs, NCCL; dryrun(2, 'cpu') runs two processes over gloo)
"""
from __future__ import annotations

import os
import socket
import tempfile
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..nn.decoder import NO_DROPOUT, Dropout
from ..train.optim import apply_update
from ..train.train_step import (TrainBatch, TrainDraws, draw_train,
                                step_generator, step_losses)
from ..utils.profiling import span


class DistInfo(NamedTuple):
    rank: int
    world: int
    device: torch.device
    group: Optional[object]     # None: one process, no collectives
    owned: bool                 # init_distributed built the group


def init_distributed(device='cuda') -> DistInfo:
    """Reads torchrun's RANK / WORLD_SIZE / LOCAL_RANK (and MASTER_ADDR /
    MASTER_PORT for the rendezvous).  On the GPU a rank runs on
    cuda:{LOCAL_RANK} over NCCL, on the CPU (device 'cpu') over gloo.
    Without those variables: rank 0 of 1, no group.  A group that the
    caller built already is used as it is."""
    dev = torch.device(device)
    env = os.environ
    if 'RANK' not in env or 'WORLD_SIZE' not in env:
        return DistInfo(0, 1, dev, None, False)
    rank, world = int(env['RANK']), int(env['WORLD_SIZE'])
    local = int(env.get('LOCAL_RANK', rank))
    if dev.type == 'cuda':
        dev = torch.device('cuda', local)
        torch.cuda.set_device(dev)
    owned = not dist.is_initialized()
    if owned:
        dist.init_process_group('nccl' if dev.type == 'cuda' else 'gloo',
                                rank=rank, world_size=world)
    return DistInfo(rank, world, dev, dist.group.WORLD, owned)


def close_distributed(info: DistInfo):
    """Destroys the group if `init_distributed` built it."""
    if info.owned and dist.is_initialized():
        dist.destroy_process_group()


def barrier(info: DistInfo):
    if info.group is not None:
        if info.device.type == 'cuda':
            dist.barrier(info.group, device_ids=[info.device.index])
        else:
            dist.barrier(info.group)


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_reduce_gradients(optimizer: torch.optim.Optimizer, group):
    """Every rank's gradients of the optimizer's parameters summed in one
    flat float32 bucket and divided by the world size.  A parameter that
    has a gradient on no rank keeps none (AdamW then skips it, as on one
    rank); one that has a gradient on some rank gets zeros where it had
    none."""
    if group is None:
        return
    world = _world(group)
    params = [p for grp in optimizer.param_groups for p in grp['params']]
    has = torch.tensor([p.grad is not None for p in params],
                       dtype=torch.int32, device=params[0].device)
    _all_reduce_(has, group)
    live = [p for p, h in zip(params, has.tolist()) if h]
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1).float()
                      for p in live])
    _all_reduce_(flat, group).div_(world)
    off = 0
    for p in live:
        n = p.numel()
        p.grad = flat[off:off + n].view_as(p).to(p.dtype)
        off += n


def dp_objective(model, scenes: Sequence[TrainBatch],
                 draws: Sequence[TrainDraws],
                 drops: Optional[Sequence[Dropout]] = None, group=None,
                 mixed_precision: bool = True):
    """The data-parallel step's losses of this rank's `scenes` (every
    rank holds as many) -> (this rank's share of the global objective, to
    back-propagate; the metrics of the global batch, without gradient:
    the loss terms, rpn_num_pos, rcnn_num_pos, num_queries, key_active,
    key_overflow, total_loss).  The gradients of the shares, summed over
    the ranks and divided by the world size, are the global objective's."""
    world = _world(group)
    n_local = len(scenes)
    drops = drops or [NO_DROPOUT] * n_local
    totals, metrics, deferred = zip(*(
        step_losses(model, b, d, drop, mixed_precision)
        for b, d, drop in zip(scenes, draws, drops)))
    mkeys, dkeys = list(metrics[0]), list(deferred[0])
    with torch.no_grad():
        # one all-reduce of every count and logged sum: [num_pos of each
        # deferred key, its weighted sum, each metric, the total]
        stats = torch.stack([torch.stack(
            [d[k][1].float() for k in dkeys]
            + [d[k][0].detach().float() for k in dkeys]
            + [m[k].detach().float() for k in mkeys] + [t.detach().float()])
            for t, m, d in zip(totals, metrics, deferred)]).sum(0)
        stats = _all_reduce_(stats, group) / (n_local * world)
    K = len(dkeys)
    denom = stats[:K].clamp(min=1.0)
    local = torch.stack(totals).sum() / n_local
    for j, k in enumerate(dkeys):
        local = local + torch.stack(
            [d[k][0] for d in deferred]).sum() / n_local / denom[j]

    out = {k: stats[2 * K + i] for i, k in enumerate(mkeys)}
    total = stats[-1]
    for j, k in enumerate(dkeys):
        out[k] = stats[K + j] / denom[j]
        total = total + out[k]
    out['total_loss'] = total
    return local, out


def dp_train_step(model, optimizer: torch.optim.Optimizer,
                  scenes: Sequence[TrainBatch],
                  generators: Sequence[torch.Generator], group=None,
                  mixed_precision: bool = True) -> Dict[str, torch.Tensor]:
    """One data-parallel update of `model` on this rank's `scenes` (each
    with its generator, which draws its `TrainDraws` and dropout) -> the
    metrics of the global batch (`dp_objective`'s, grad_norm, lr).  A rank
    with several scenes runs their forwards, then one backward."""
    cfg = model.cfg
    with span('train_step'):
        optimizer.zero_grad(set_to_none=True)
        with span('draws'):
            draws = [draw_train(cfg, b.gt2d.boxes.shape[1], g)
                     for b, g in zip(scenes, generators)]
        with span('objective'):
            local, metrics = dp_objective(
                model, scenes, draws,
                [Dropout(cfg.dropout, g) for g in generators], group,
                mixed_precision)
        with span('backward'):
            local.backward()
        all_reduce_gradients(optimizer, group)
        with span('update'):
            norm, lr = apply_update(optimizer)
        metrics.update(grad_norm=norm,
                       lr=torch.tensor(lr, dtype=torch.float64))
        return metrics


# ------------------------------------------------------------- dry run

def dryrun_config():
    """The dry run's model: the tiny preset, two frames."""
    from .. import configs
    return configs.tiny(num_frames=2)


def dryrun_scene(cfg, index: int, device='cpu') -> TrainBatch:
    """Scene `index` of the dry run: `synthetic_train_batch(seed=index)`
    with 1 + index % 3 valid 3D boxes, so that the scenes' num_pos
    differ."""
    from ..synthetic import synthetic_train_batch
    b = synthetic_train_batch(cfg, seed=index, device=device)
    n = 1 + index % 3
    valid = torch.arange(cfg.max_gt, device=b.gt3d.valid.device) < n
    return b._replace(gt3d=b.gt3d._replace(valid=b.gt3d.valid & valid))


def dryrun_step(info: DistInfo, scene_indices: Sequence[int],
                seed: int = 0) -> dict:
    """One dp step of the seeded dry-run model on `scene_indices` (this
    rank's) -> {'metrics': floats, 'grads': name -> the gradient the
    update took (after the all-reduce and the clip)}."""
    from ..models.mv2d import MV2D
    from ..train.optim import make_optimizer
    cfg = dryrun_config()
    torch.manual_seed(seed)
    model = MV2D(cfg).to(info.device)
    opt = make_optimizer(model, base_lr=2e-4, total_steps=10)
    scenes = [dryrun_scene(cfg, i, info.device) for i in scene_indices]
    gens = [step_generator(seed, 0, i, info.device) for i in scene_indices]
    metrics = dp_train_step(model, opt, scenes, gens, info.group,
                            mixed_precision=info.device.type == 'cuda')
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads={n: p.grad.detach().cpu().clone()
                       for n, p in model.named_parameters()
                       if p.grad is not None})


def _dryrun_worker(rank: int, n: int, port: int, device: str, out: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    info = init_distributed(device)
    try:
        res = dryrun_step(info, [rank])
        total = res['metrics']['total_loss']
        assert np.isfinite(total), f'non-finite loss {total}'
        if rank == 0:
            print(f'dryrun({n}): total_loss={total:.4f} step=1', flush=True)
            torch.save(res, out)
    finally:
        close_distributed(info)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def dryrun(n: int, device: str = 'cuda') -> dict:
    """Spawns `n` processes (NCCL on one GPU each; gloo with device
    'cpu') that each take one dp step of the tiny model on a
    scene of their own (`dryrun_scene(cfg, rank)`) -> rank 0's
    `dryrun_step` result."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, 'rank0.pt')
        mp.spawn(_dryrun_worker, args=(n, free_port(), device, out),
                 nprocs=n, join=True)
        return torch.load(out)

