"""The program's own spans and counters in one cell: the per-layer numbers
that `mv2d_tpu_torch.utils.profiling`'s tracer and counter registry give,
with the arithmetic the benchmark's readers take once `run.py` switches
the program's tracer on.

  python3 perfbench/program_spans.py --workload t_r50.eval --seed <n> \
      --seconds <s> [--rounds 3] [--out FILE]

Set-up as `run.py`'s (the cell's loop, its warm-up); then `rounds` pairs
of windows of `seconds` each with the tracer off and on, in turns (off
on, on off, ...): the two rates give the tracing cost, the windows with
it on the host ms a call by span, and the `sync.*` counters the syncs a
call.  Then the profiled slice (`profiled_calls` calls under
torch.profiler, the tracer on with its profiler ranges): the device's
idle ms a call put to the program span open on the host when each idle
stretch began.  Then, on a card, two calls, each under the sync debug
mode: its warnings by site against its `sync.*` counters.  Prints one
JSON object (and writes it to --out).

Spans are `profiling.Span`s (ns on `time.time_ns()`'s clock, the
profiler's); `calls` is the number of calls or steps they cover.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# metric -> (span name, its parent's name or None, self time only)
EVAL_SPANS = {'host_ms.rpn.eval': ('rpn', None, True),
              'host_ms.nms.eval': ('nms', None, False),
              'host_ms.keys.eval': ('keys', None, False),
              'host_ms.decoder.eval': ('decoder', None, False)}
TRAIN_SPANS = {'host_ms.draws.train': ('draws', None, False),
               'host_ms.forward.train': ('forward', 'objective', False),
               'host_ms.match.train': ('match', None, False),
               'host_ms.backward.train': ('backward', None, False)}
IDLE_SPAN = {'eval': 'detect', 'train': 'objective'}
ROOT_SPAN = {'eval': 'forward', 'train': 'train_step'}


def host_ms(spans: Sequence, calls: int, name: str,
            parent: Optional[str] = None, self_only: bool = False
            ) -> Optional[float]:
    """Host ms a call in the spans named `name` (whose parent is named
    `parent`, where given): their durations, or their self times."""
    from mv2d_tpu_torch.utils.profiling import self_ns
    own = self_ns(spans) if self_only else None
    ns = [own[i] if self_only else s.end - s.start
          for i, s in enumerate(spans) if s.name == name and (
              parent is None or s.parent >= 0
              and spans[s.parent].name == parent)]
    return sum(ns) / 1e6 / calls if ns and calls else None


def children_share(spans: Sequence, root: str) -> Optional[float]:
    """The share of the roots' (spans named `root` with no parent) time
    that their direct children cover."""
    roots = {i for i, s in enumerate(spans) if s.name == root
             and s.parent < 0}
    whole = sum(spans[i].end - spans[i].start for i in roots)
    kids = sum(s.end - s.start for s in spans if s.parent in roots)
    return kids / whole if whole else None


def by_path(spans: Sequence, calls: int) -> Dict[str, List[float]]:
    """path -> [host ms a call, self ms a call] of every span."""
    from mv2d_tpu_torch.utils.profiling import paths, self_ns
    out: Dict[str, List[float]] = {}
    for p, s, own in zip(paths(spans), spans, self_ns(spans)):
        v = out.setdefault(p, [0.0, 0.0])
        v[0] += (s.end - s.start) / 1e6 / calls
        v[1] += own / 1e6 / calls
    return out


def syncs(counts: Dict[str, int], calls: int) -> Optional[float]:
    """The `sync.*` counters' sum a call."""
    n = sum(v for k, v in counts.items() if k.startswith('sync.'))
    return n / calls if calls else None


def idle_stretches(kernels: Iterable[Tuple[float, float]],
                   window: Tuple[float, float]
                   ) -> List[Tuple[float, float]]:
    """The stretches of `window` with no device work, from the kernels'
    [start, end) intervals (us)."""
    out, t = [], window[0]
    for s, e in sorted(kernels):
        if s > t:
            out.append((t, min(s, window[1])))
        t = max(t, e)
    if window[1] > t:
        out.append((t, window[1]))
    return [(a, b) for a, b in out if b > a]


def idle_by_span(stretches: Sequence[Tuple[float, float]],
                 spans: Sequence[Tuple[str, float, float]]
                 ) -> Dict[str, float]:
    """name -> us of the idle stretches that began inside a span of that
    name (spans (name, start us, end us); a stretch counts once for each
    name open at its start, so a parent's figure holds its children's)."""
    out: Dict[str, float] = {}
    for a, b in stretches:
        for n in {n for n, s, e in spans if s <= a < e}:
            out[n] = out.get(n, 0.0) + (b - a)
    return out


def innermost(spans: Sequence, t_us: float) -> str:
    """The path of the innermost program span open at t_us, 'between'
    where none is."""
    from mv2d_tpu_torch.utils.profiling import paths
    best, path = None, 'between'
    for p, s in zip(paths(spans), spans):
        if s.start / 1e3 <= t_us < s.end / 1e3 and (
                best is None or s.start >= best.start):
            best, path = s, p
    return path


def _site(frame) -> Optional[str]:
    """'file:line' under mv2d_tpu_torch/ of the innermost package frame."""
    while frame is not None:
        f = frame.f_code.co_filename.replace('\\', '/')
        i = f.rfind('/mv2d_tpu_torch/')
        if i >= 0:
            return f'{f[i + 16:]}:{frame.f_lineno}'
        frame = frame.f_back
    return None


def sync_check(fn) -> dict:
    """fn() once under the sync debug mode 'warn' -> its warnings by
    site, their count, and the `sync.*` counters it moved."""
    import warnings
    import torch
    from mv2d_tpu_torch.utils.profiling import counters, sync_warning
    sites: Dict[str, int] = {}
    old = warnings.showwarning

    def hook(message, *a, **k):
        if sync_warning(message):
            s = _site(sys._getframe(1)) or '(no mv2d_tpu_torch frame)'
            sites[s] = sites.get(s, 0) + 1
    torch.cuda.synchronize()
    c0 = counters.snapshot()
    with warnings.catch_warnings():
        warnings.simplefilter('always')
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
            warnings.showwarning = old
    torch.cuda.synchronize()
    moved = {k: v - c0.get(k, 0) for k, v in counters.snapshot().items()
             if k.startswith('sync.') and v != c0.get(k, 0)}
    return dict(warned=sum(sites.values()), counted=sum(moved.values()),
                sites=sites, counters=moved)


def measure(args, bench_path=None, device=None) -> dict:
    """One cell: see the module's docstring."""
    from perfbench import run
    run._caches()
    import torch
    from perfbench import spec, trace
    from perfbench.loops import LOOPS
    from mv2d_tpu_torch.utils.profiling import counters, tracer
    bench = spec.load_benchmark(bench_path)
    cell = spec.workload(bench, args.workload)
    model_cfg = spec.config(bench, cell['config'])
    traffic = spec.traffic(cell['traffic'])
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit(f'{args.workload}: needs a CUDA device')
        device = 'cuda'
    cuda = device == 'cuda'
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    mode = traffic['loop']
    loop = LOOPS[mode](model_cfg, traffic, args.seed, device)
    loop.setup()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    n = 0
    rates = {False: [], True: []}
    spans, traced_calls = [], 0
    c_on: Dict[str, int] = {}
    for r in range(args.rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            tracer.on = on
            c0 = counters.snapshot()
            t0 = time.perf_counter()
            k = 0
            while k == 0 or time.perf_counter() - t0 < args.seconds:
                loop.untimed_call(n)
                n += 1
                k += 1
            sync()
            rates[on].append(k / (time.perf_counter() - t0))
            tracer.on = False
            if on:
                off = len(spans)    # a drain's parents index that drain
                spans += [x._replace(parent=x.parent + off)
                          if x.parent >= 0 else x for x in tracer.drain()]
                traced_calls += k
                for key, v in counters.snapshot().items():
                    c_on[key] = c_on.get(key, 0) + v - c0.get(key, 0)
    mets = {m: host_ms(spans, traced_calls, *how) for m, how in
            (EVAL_SPANS if mode == 'eval' else TRAIN_SPANS).items()}
    mets[f'host_syncs.{mode}'] = syncs(c_on, traced_calls)
    mets[f'nms_rounds.{mode}'] = c_on.get('nms_rounds', 0) / traced_calls
    out = dict(workload=args.workload, seed=args.seed, device=device,
               card=run.card_and_limit() if cuda else 'cpu',
               rate_off=rates[False], rate_on=rates[True],
               traced_calls=traced_calls,
               root_children_share=children_share(spans, ROOT_SPAN[mode]),
               host_ms_by_path=by_path(spans, traced_calls),
               counters_per_call={k: v / traced_calls
                                  for k, v in sorted(c_on.items()) if v})
    # ------------------------------------------------ the profiled slice
    k = traffic['profiled_calls']
    mark = {}

    def calls():
        loop.untimed_call(n)
        sync()
        tracer.drain()
        tracer.on = tracer.annotate = True
        mark['t0'] = time.time_ns() / 1e3
        for i in range(k):
            loop.untimed_call(n + 1 + i)
        sync()
        mark['t1'] = time.time_ns() / 1e3
        tracer.on = tracer.annotate = False
    events, _ = trace.profile(calls)
    prof_spans = tracer.drain()
    window = (mark['t0'], mark['t1'])
    ks = [(e.start, e.end) for e in trace.kernels(events)
          if window[0] <= e.start < window[1]]
    if ks:
        idle = idle_stretches(ks, window)
        by = idle_by_span(idle, [(s.name, s.start / 1e3, s.end / 1e3)
                                 for s in prof_spans])
        span = IDLE_SPAN[mode]
        mets[f'idle_ms.{span}.{mode}'] = by.get(span, 0.0) / 1e3 / k
        out['idle_pct'] = 100 * sum(b - a for a, b in idle) / (
            window[1] - window[0])
        out['idle_ms_by_span'] = {s: v / 1e3 / k for s, v in by.items()}
        longest = sorted(idle, key=lambda g: g[0] - g[1])[:10]
        out['idle_gaps'] = [[innermost(prof_spans, a), (b - a) / 1e3]
                            for a, b in longest]
    names = {e.name for e in events if e.annotation}
    out['profiler_ranges'] = sorted(names & {s.name for s in prof_spans})
    # ------------------------------------------------ syncs by site
    if cuda:
        p = loop.program

        def one(i):
            if mode == 'eval':      # the forward alone, not the answer's copy
                j = i % p.imgs.shape[0]
                return lambda: p.model(p.imgs[j], p.cam, p.shapes)
            return lambda: loop.untimed_call(i)
        out['sync'] = [sync_check(one(n + 1 + k + i)) for i in range(2)]
    out['metrics'] = {m: v for m, v in mets.items() if v is not None}
    loop.program.free()
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--rounds', type=int, default=3)
    p.add_argument('--out', default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    out = measure(args)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)


if __name__ == '__main__':
    main()
