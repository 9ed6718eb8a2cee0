"""Profiling and tracing helpers: the counterpart of
`mv2d_tpu/utils/profiling.py`, on `torch.profiler`, and the port's own
spans and counters.

  with trace('/tmp/tb'):             # a Chrome / Perfetto trace file
      model(*inputs)
  with annotate('decoder'):          # a named range in the trace (and NVTX)
      ...
  tracer.on = True                   # the program's spans (off by default)
  model(*inputs)
  spans = tracer.drain()             # [Span(name, parent, call, start, end)]
  counters.snapshot()                # {'nms_rounds': 40, 'sync.nms.round': 40,
                                     #  'keys.active': 51234 (tracer on)}

The program opens a span at each layer boundary (`with span('rpn'):`).
With the tracer off, `span` is one attribute test and returns a shared
no-op context manager: no clock read, no allocation, no profiler range
(`torch.export` of the forward sees only this).  With it on, a span
records its name, the index of the span it opened in (-1 for a root), a
call id shared by every span under one root, and its start and end on
`time.time_ns()`'s clock, the clock of the profiler's events, so spans
lay directly over a device trace; with `tracer.annotate` on as well, a
span is also an `annotate` range under its own name.  Spans are kept in
memory until `drain()`.  The stack of open spans is the process's, not a
thread's: the autograd engine's thread runs a rematerialised forward
while the caller waits in `backward()`, and its spans nest under
`backward`.  So trace one thread of calls at a time.

`counters` counts always, named integers the program increments where
the work happens: `nms_rounds` (the NMS fixpoint's loop tests), and one
`sync.<module>.<what>` a site that synchronises the host with a CUDA
device, by the number of syncs the site makes (each a warning under
`torch.cuda.set_sync_debug_mode('warn')`).  While the tracer is on the
program also adds tensors on the device, with no sync, which
`snapshot()` reads: `keys.active` and `keys.overflow` (the pixel key
mode's active keys and those beyond k_max, summed over calls).
"""
from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict, Iterator, List, NamedTuple, Sequence

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = 'trace.json'


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the block on the host, and on the GPU where CUDA is
    available, and write its trace to log_dir/trace.json (Chrome trace
    format, viewable in Perfetto); yields the profiler, whose
    `key_averages()` sum the block's ops by name.  A CUDA device is
    synchronized before the trace stops, so that the block's kernels are
    in it."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range: a `record_function` span in a trace, and an NVTX
    range on CUDA (seen by NVIDIA's profilers)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class Span(NamedTuple):
    name: str
    parent: int         # index of the enclosing span in the drained list
    call: int           # shared by every span under one root
    start: int          # ns, time.time_ns()
    end: int


class _Open:
    """An open span: its record is appended when it opens, so a parent
    comes before its children, and completed when it closes."""
    __slots__ = ('tracer', 'rec', 'ann')

    def __init__(self, tracer: 'Tracer', name: str):
        self.tracer = tracer
        self.rec = [name, -1, 0, 0, 0]
        self.ann = None

    def __enter__(self):
        t = self.tracer
        rec = self.rec
        if t._stack:
            rec[1] = t._stack[-1]
        else:
            t._calls += 1
        rec[2] = t._calls
        t._stack.append(len(t._records))
        t._records.append(rec)
        rec[3] = time.time_ns()
        if t.annotate:
            self.ann = annotate(rec[0])
            self.ann.__enter__()

    def __exit__(self, *exc):
        if self.ann is not None:
            self.ann.__exit__(*exc)
        self.rec[4] = time.time_ns()
        self.tracer._stack.pop()
        return False


_NULL = contextlib.nullcontext()


class Tracer:
    """The program's spans (see the module's docstring); off by default."""

    def __init__(self):
        self.on = False
        self.annotate = False
        self._records: List[list] = []
        self._stack: List[int] = []
        self._calls = 0

    def drain(self) -> List[Span]:
        """The spans recorded since the last drain, in the order they
        opened; call it with no span open."""
        if self._stack:
            raise RuntimeError(f'drain() inside {len(self._stack)} open '
                               'span(s)')
        out = [Span(*r) for r in self._records]
        self._records = []
        return out


tracer = Tracer()


def span(name: str):
    """A span of the process-wide tracer (a shared no-op while it is
    off)."""
    return _Open(tracer, name) if tracer.on else _NULL


class Counters(collections.Counter):
    """Named counts, always counting (`counters[name] += n`).  A count may
    be an integer tensor, summed on its device with no sync; `snapshot`
    reads it (a sync)."""

    def snapshot(self) -> Dict[str, int]:
        return {k: int(v) for k, v in self.items()}


counters = Counters()


def sync_warning(message) -> bool:
    """A warning of `torch.cuda.set_sync_debug_mode('warn')` for one sync
    (not the notice, on the mode's first use in a process, that the mode
    is a prototype)."""
    text = str(message)
    return 'synchroniz' in text and 'prototype' not in text


def self_ns(spans: Sequence[Span]) -> List[int]:
    """Each span's self time: its duration less the part of its interval
    its children cover."""
    kids: Dict[int, List[Span]] = collections.defaultdict(list)
    for s in spans:
        if s.parent >= 0:
            kids[s.parent].append(s)
    out = []
    for i, s in enumerate(spans):
        covered, reach = 0, s.start
        for k in sorted(kids.get(i, []), key=lambda k: k.start):
            a, b = max(k.start, reach), min(k.end, s.end)
            if b > a:
                covered += b - a
                reach = b
        out.append(s.end - s.start - covered)
    return out


def paths(spans: Sequence[Span]) -> List[str]:
    """Each span's name after its ancestors', '/'-joined
    ('train_step/objective/forward')."""
    out: List[str] = []
    for s in spans:
        out.append(s.name if s.parent < 0 else f'{out[s.parent]}/{s.name}')
    return out
