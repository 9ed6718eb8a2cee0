"""Profiling and tracing helpers: the counterpart of
`mv2d_tpu/utils/profiling.py`, on `torch.profiler`.

  with trace('/tmp/tb'):             # a Chrome / Perfetto trace file
      model(*inputs)
  with annotate('decoder'):          # a named range in the trace (and NVTX)
      ...
  meter = Throughput(warmup=5)       # samples/s after `warmup` ticks
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

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


class Throughput:
    """Steady-state samples/sec meter with warmup skip."""

    def __init__(self, warmup: int = 5):
        self.warmup = warmup
        self.count = -warmup
        self.t0 = None

    def tick(self, n: int = 1) -> float | None:
        if self.count < 0:
            self.count += 1
            if self.count == 0:
                self.t0 = time.perf_counter()
            return None
        self.count += n
        dt = time.perf_counter() - self.t0
        return self.count / dt if dt > 0 else None


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
