"""Run one cell of the benchmark once.

  python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

The cell (an entry of `workloads` in BENCHMARK.json) names a configuration
(its file, `perfbench/configs/<name>.json`) and a traffic mix
(`perfbench/traffic/<name>.json`, whose `loop` is 'eval' or 'train').
Set-up builds the program's model and the pool of scenes from the seed on
the card and warms up the cell's shapes; the window then runs the closed
loop for `--seconds`; with `--trace 1` a few calls after it run under
the profiler and one under the sync debug mode, and the per-layer
metrics (`perfbench/metrics/<name>.py`) are read.  Once the window has
closed and the program is freed, `perfbench.check` compares what the
window produced with the float32 reference.  The last line of standard
output is one JSON object: correct, attempted, failed, metrics, device
(and breakdown with --trace 1).

Exits non-zero, with no result, without a CUDA device (or fewer than the
cell asks for), and when jax, jaxlib, flax or the JAX package is loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'mv2d_tpu')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split('.', 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_and_limit() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return 'unknown'


def _caches():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port builds its kernels into mv2d_tpu_torch/csrc/build/)."""
    cache = ROOT / 'perfbench' / '.cache'
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['USE_FLAX'] = '0'


def run(args, bench_path=None, device=None, limits=None) -> dict:
    """One run of the cell -> the result dict (printed by `main`).
    Tests pass another BENCHMARK.json (`bench_path`), the check's
    `limits`, and `device` 'cpu', which skips the look for cards."""
    _caches()
    import torch
    from perfbench import check, readers, spec
    bench = spec.load_benchmark(bench_path)
    cell = spec.workload(bench, args.workload)
    model_cfg = spec.config(bench, cell['config'])
    traffic = spec.traffic(cell['traffic'])
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell['chips']:
            raise SystemExit(
                f'{args.workload}: needs {cell["chips"]} CUDA device(s), '
                f'found {torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        device = 'cuda'
    cuda = device == 'cuda'
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the host paces these cells: one process with one intra-op thread
    torch.set_num_threads(1)
    from perfbench.loops import LOOPS
    loop = LOOPS[traffic['loop']](model_cfg, traffic, args.seed, device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # ------------------------------------------------------------ set-up
    loop.setup()
    sync()
    setup_s = time.perf_counter() - T0
    # ------------------------------------------------------------ window
    prog = loop.program
    rec = prog.rec
    rec.spans_on = bool(args.trace)
    c0 = prog.counters()
    lat, n = [], 0
    gc.collect()
    t_start = time.perf_counter()
    deadline = t_start + args.seconds
    while True:
        t = time.perf_counter()
        if t >= deadline and n > 0:
            break
        loop.timed_call(n)
        lat.append(time.perf_counter() - t)
        n += 1
    sync()
    window_s = time.perf_counter() - t_start
    half = max(n // 2, 1)
    print(f'window: {n} calls, first half {half / sum(lat[:half]):.4f}/s, '
          f'second half {(n - half) / max(sum(lat[half:]), 1e-9):.4f}/s, '
          f'median call {statistics.median(lat) * 1e3:.2f} ms',
          file=sys.stderr)
    c1 = prog.counters()
    rec.spans_on = False
    obs = dict(loop=traffic['loop'], calls=n, window_s=window_s,
               latencies_s=lat, setup_s=setup_s,
               counters={k: c1[k] - c0[k] for k in c0},
               spans=list(rec.spans), model_cfg=model_cfg,
               peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0,
               card=card_and_limit() if cuda else 'cpu')
    breakdown = None
    if args.trace:
        obs.update(loop.traced(n))
        breakdown = obs.pop('breakdown', None)
    # ------------------------------------------------------------ check
    rec.spans.clear()
    prog_out = loop.finish()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = check.judge(args.workload, cell, model_cfg, traffic,
                          args.seed, prog_out, device, limits)
    print(f'check: {time.perf_counter() - t_check:.1f} s, window '
          f'{window_s:.1f} s, {n} calls', file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f'forbidden modules loaded: {bad}', file=sys.stderr)
        raise SystemExit(3)
    names = [m['name'] for m in (bench['per_layer'] if args.trace
                                 else bench['end_to_end'])
             if args.workload in m.get('workloads', [args.workload])]
    mets = readers.read(names, bench, obs)
    dev = dict(platform='gpu' if cuda else 'cpu',
               kind=torch.cuda.get_device_name(0) if cuda else 'cpu',
               count=1 if cuda else 0,
               memory_peak_bytes=obs['peak_bytes'])
    if args.trace:
        dev.update(busy_s=obs['busy_s'], window_s=obs['traced_s'])
    result = dict(correct=verdict['correct'], attempted=verdict['attempted'],
                  failed=verdict['failed'], metrics=mets, device=dev)
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['card'] = obs['card']
    result['checked'] = verdict['numbers']
    for line in verdict['lines']:
        print(line, file=sys.stderr)
    return result


def main(argv=None):
    args = parse_args(argv)
    result = run(args)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == '__main__':
    main()
