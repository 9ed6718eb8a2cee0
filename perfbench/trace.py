"""The reduction of a profiled slice to numbers: the device's busy and idle
time, busy time by the benchmark's spans, the host's time blocked in
syncs, kernel time by hand-kernel operator call (with its input shapes,
for `roofline`), and the breakdown the result line carries.

The arithmetic is copied from the port's stage benches
(`mv2d_tpu_torch/tools/stage_common.py`: `events_of`, `blocked_by_site`'s
sync APIs; `profile_train._busy_ms`: the union of kernel intervals).
Events are read from kineto's records, not torch's event tree.  Times are
in us on `time.time_ns()`'s clock.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Sequence, Tuple

import torch

SYNC_APIS = ('cudaStreamSynchronize', 'cudaEventSynchronize',
             'cudaDeviceSynchronize')
MEMCPY_API = 'cudaMemcpyAsync'
LAUNCH_APIS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
               'cuLaunchKernelEx', 'cudaMemcpyAsync', 'cudaMemsetAsync')


class Event(NamedTuple):
    name: str
    host: bool                  # an op, annotation or runtime call
    start: float                # us
    end: float
    corr: int                   # correlation id (a runtime call's kernels)
    annotation: bool            # a user annotation (record_function)
    thread: int
    shapes: tuple               # a hand-kernel op's input shapes
    dtypes: tuple


def events_of(prof) -> List[Event]:
    """The raw events of a finished torch.profiler.profile."""
    cpu = torch.autograd.DeviceType.CPU
    out = []
    for e in prof.profiler.kineto_results.events():
        host = e.device_type() == cpu
        shapes = dtypes = ()
        if host and e.name().startswith('mv2d::'):
            # structured shapes carry a tensor list's shapes (torch >= 2.12;
            # before, a list's shape comes back empty)
            get = getattr(e, 'structured_input_shapes', e.shapes)
            shapes, dtypes = tuple(get()), tuple(e.dtypes())
        out.append(Event(e.name(), host, e.start_ns() / 1e3,
                         e.end_ns() / 1e3, e.correlation_id(),
                         bool(e.is_user_annotation()),
                         e.start_thread_id() if host else -1,
                         shapes, dtypes))
    return out


def kernels(events: Iterable[Event]) -> List[Event]:
    """Device-side work: kernels, copies and sets (not annotations)."""
    return [e for e in events if not e.host and not e.annotation]


def union_us(spans: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of [start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def launches(events: Sequence[Event]) -> Dict[int, Event]:
    """correlation id -> the host runtime call that enqueued it."""
    return {e.corr: e for e in events
            if e.host and not e.annotation and e.name in LAUNCH_APIS}


def busy_by_span(events: Sequence[Event],
                 spans: Sequence[Tuple[str, float, float]]
                 ) -> Dict[str, float]:
    """name -> us of device work (the union of its intervals) enqueued
    while a span of that name was open on the host; spans in us."""
    calls = launches(events)
    per: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    starts = sorted((s, e, n) for n, s, e in spans)
    keys = [s for s, _, _ in starts]
    for k in kernels(events):
        call = calls.get(k.corr)
        if call is None:
            continue
        i = bisect.bisect_right(keys, call.start) - 1
        while i >= 0:
            s, e, n = starts[i]
            if s <= call.start < e:
                per[n].append((k.start, k.end))
                break
            i -= 1
    return {n: union_us(v) for n, v in per.items()}


def blocked_us(events: Sequence[Event]) -> float:
    """Host us blocked in sync runtime calls and device-to-host copies."""
    d2h = {e.corr for e in events if not e.host and 'DtoH' in e.name}
    return sum(e.end - e.start for e in events
               if e.host and (e.name in SYNC_APIS or (
                   e.name == MEMCPY_API and e.corr in d2h)))


class OpCall(NamedTuple):
    """One call of a hand-kernel operator (`mv2d::<op>`): its input shapes
    and dtypes, and the device us of the work it enqueued."""
    op: str
    shapes: tuple
    dtypes: tuple
    device_us: float


def op_calls(events: Sequence[Event], prefix: str = 'mv2d::'
             ) -> List[OpCall]:
    """Every call of an operator named `prefix...` with the device work
    enqueued on its thread while it ran."""
    calls = launches(events)
    by_thread: Dict[int, List[Event]] = defaultdict(list)
    for e in calls.values():
        by_thread[e.thread].append(e)
    for v in by_thread.values():
        v.sort(key=lambda e: e.start)
    dev = defaultdict(list)
    for k in kernels(events):
        if k.corr in calls:
            dev[k.corr].append((k.start, k.end))
    out = []
    for e in events:
        if not (e.host and e.name.startswith(prefix)):
            continue
        ts = by_thread.get(e.thread, [])
        lo = bisect.bisect_left([c.start for c in ts], e.start)
        spans = []
        for c in ts[lo:]:
            if c.start >= e.end:
                break
            spans += dev.get(c.corr, [])
        out.append(OpCall(e.name[len(prefix):], e.shapes, e.dtypes,
                          union_us(spans)))
    return out


def top_ops(events: Sequence[Event], n: int = 10) -> List[list]:
    """The n device operations by total seconds: [[name, s], ...]."""
    tot: Dict[str, float] = defaultdict(float)
    for k in kernels(events):
        tot[short(k.name)] += (k.end - k.start) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:n]]


def idle_gaps(events: Sequence[Event], spans: Sequence[tuple],
              window: Tuple[float, float], n: int = 10) -> List[list]:
    """The n longest stretches with no device work inside `window` (us),
    each named by the span open on the host when it began and the
    longest host call running then: [[name, s], ...]."""
    ks = sorted((k.start, k.end) for k in kernels(events))
    gaps, t = [], window[0]
    for s, e in ks:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if window[1] > t:
        gaps.append((t, window[1]))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if e.host and not e.annotation]
    out = []
    for s, e in gaps[:n]:
        stage = next((nm for nm, a, b in spans if a <= s < b), 'between')
        running = [h for h in host if h.start <= s < h.end]
        what = max(running, key=lambda h: h.end - h.start).name \
            if running else 'python'
        out.append([f'{stage}: {what}'[:120], (e - s) / 1e6])
    return out


def short(name: str) -> str:
    """A kernel's name without return type, namespaces and arguments."""
    name = name.replace('(anonymous namespace)::', '')
    name = name.removeprefix('void ').split('<')[0].split('(')[0]
    return name.split('::')[-1][:80]


def profile(fn, record_shapes: bool = True):
    """fn() under torch.profiler (CPU and CUDA) -> (events, result)."""
    from torch.profiler import ProfilerActivity, profile as prof_
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with prof_(activities=acts, record_shapes=record_shapes) as p:
        res = fn()
    return events_of(p), res


def sync_debug(fn):
    """fn() under torch.profiler and the sync debug mode 'warn' ->
    (host us blocked in syncs and device-to-host copies that began while
    fn ran, sync warnings)."""
    import time
    import warnings
    n, until = [0], [0.0]
    with warnings.catch_warnings():
        warnings.simplefilter('always')
        old = warnings.showwarning

        def hook(message, *a, **k):
            if 'synchroniz' in str(message):
                n[0] += 1
        warnings.showwarning = hook
        try:
            def run():
                torch.cuda.set_sync_debug_mode('warn')
                try:
                    fn()
                finally:
                    torch.cuda.set_sync_debug_mode('default')
                    until[0] = time.time_ns() / 1e3
                torch.cuda.synchronize()
            ev, _ = profile(run, record_shapes=False)
        finally:
            warnings.showwarning = old
    return blocked_us([e for e in ev if e.start < until[0]]), n[0]
