"""Where the time of one full-width training step goes, on one GPU.

    python -m mv2d_tpu_torch.profile_train [--steps 3] [--warmup 2] [--eval]
                                           [--top 30]

Builds the MV2D-T R50 model (`synthetic.init_random_weights(seed=0)`,
the weights of `chip_smoke.py`'s serve and train phases; not the bench
rule of `synthetic.bench_rule_weights`), the seeded synthetic scene and
the optimizer on the card, runs `warmup` steps, then:
  1. `steps` steps timed on the host clock around a synchronised step,
     split into forward + losses (matching included), backward, and
     clip + AdamW, each ended by a synchronisation;
  2. `steps` steps under torch.profiler: the device's busy time per step
     (the union of kernel intervals), and kernel time by name (the `top`
     names that take the most);
  3. the card's name and power limit.
With `--eval`, the same for the bfloat16 eval forward that `chip_smoke.py`
serves (12 views of N(0, 1) images from seed 0): `steps` forwards timed on
the host clock, then `steps` under the profiler.
Numbers are printed; nothing is written.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch


def _step_parts(model, opt, batch, gen):
    """One training step with a synchronisation after each part ->
    (forward + losses ms, backward ms, update ms)."""
    from .nn.decoder import Dropout
    from .parallel.dist import dp_objective
    from .train import train_step as ts
    from .train.optim import apply_update
    cfg = model.cfg
    sync = torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    draws = ts.draw_train(cfg, batch.gt2d.boxes.shape[1], gen)
    opt.zero_grad(set_to_none=True)
    local, _ = dp_objective(model, [batch], [draws],
                            [Dropout(cfg.dropout, gen)])
    sync()
    t1 = time.perf_counter()
    local.backward()
    sync()
    t2 = time.perf_counter()
    apply_update(opt)
    sync()
    t3 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3


def _eval_forward(model, dev='cuda'):
    """A no-argument call of one eval forward of `model` (in its dtype) on
    the scene `chip_smoke.py` serves."""
    from .core.geometry import prepare_camera_params
    from .synthetic import camera_rig
    cfg = model.cfg
    V, (H, W) = cfg.total_views, cfg.image_size
    K, E = camera_rig(V, cfg.image_size)
    ts = [0.0] * cfg.num_views + [0.5] * (V - cfg.num_views)
    cam = prepare_camera_params(K, E, ts, device=dev)
    dt = next(model.parameters()).dtype
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(V, H, W, 3)).astype(np.float32)).to(dev, dt)
    shapes = torch.tensor([[H, W]] * V, device=dev)
    return lambda: model(imgs, cam, shapes)


def _busy_ms(events):
    """Union of the device kernels' [start, end) intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def _short(name: str) -> str:
    """A kernel's name without return type, namespaces and arguments."""
    name = name.replace('(anonymous namespace)::', '')
    name = name.removeprefix('void ').split('<')[0].split('(')[0]
    return name.split('::')[-1][:60]


def main(argv=None):
    from . import configs
    from .models.mv2d import MV2D
    from .synthetic import init_random_weights, synthetic_train_batch
    from .parallel.dist import dp_train_step
    from .train.optim import make_optimizer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=3)
    ap.add_argument('--warmup', type=int, default=2)
    ap.add_argument('--eval', action='store_true',
                    help='profile the bfloat16 eval forward instead')
    ap.add_argument('--top', type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_train: needs a CUDA device')
    dev = 'cuda'
    cfg = configs.mv2d_t_r50()
    model = init_random_weights(MV2D(cfg), seed=0).to(dev)
    unit = 'scene' if args.eval else 'step'
    if args.eval:
        step = _eval_forward(model.eval().to(torch.bfloat16))
    else:
        opt = make_optimizer(model)
        batch = synthetic_train_batch(cfg, seed=0, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)

        def step():
            dp_train_step(model, opt, [batch], [gen])
    for _ in range(args.warmup):
        step()

    for i in range(args.steps):
        if args.eval:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            print(f'forward {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms')
            continue
        f, b, u = _step_parts(model, opt, batch, gen)
        print(f'step {i}: forward+losses {f:.1f} ms  backward {b:.1f} ms  '
              f'update {u:.1f} ms  total {f + b + u:.1f} ms')

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    span = (time.perf_counter() - t0) * 1e3 / args.steps
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)
            and '#' not in e.name]
    busy = _busy_ms(kern) / args.steps
    print(f'profiled: {span:.1f} ms/{unit}, device busy {busy:.1f} '
          f'ms/{unit} ({100 * busy / span:.0f}%)')
    by_name = {}
    for e in kern:
        t, n = by_name.get(_short(e.name), (0.0, 0))
        by_name[_short(e.name)] = (t + e.time_range.elapsed_us() / 1e3,
                                   n + 1)
    total_k = sum(t for t, _ in by_name.values()) / args.steps
    print(f'kernel time {total_k:.1f} ms/{unit}; by name (ms/{unit}, '
          f'launches/{unit}):')
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                               )[:args.top]:
        print(f'  {t / args.steps:8.2f} {n / args.steps:6.0f}  {name}')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(smi)


if __name__ == '__main__':
    main()
