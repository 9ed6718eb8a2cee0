"""The stage benches' shared harness: time a callable, with the device's
busy time and the host syncs it makes, by site.

`timed(fn, *args, iters, warmup, name)` runs `warmup` calls, then `iters`
calls back to back with one `torch.cuda.synchronize()` at the end, and
gives a `Row` with the host ms a call and the NMS fixpoint's rounds a
call in that loop (`utils.profiling.counters['nms_rounds']`: each round
a host sync, the count depends on the scores).  On a CUDA device it then
makes, outside that loop (each slows the calls it watches):
  * a window of calls (one, or as many as last ~20 ms) under
    `torch.profiler` (CPU and CUDA activities): the device's busy ms a
    call, the union of its kernels' intervals (`profile_train._busy_ms`);
  * one call under `torch.profiler` and
    `torch.cuda.set_sync_debug_mode('warn')`, with the warnings captured:
    the syncs a call makes by site, and the host ms blocked in
    `cudaStreamSynchronize`, device-to-host `cudaMemcpyAsync`,
    `cudaEventSynchronize` and `cudaDeviceSynchronize`, each runtime call
    put to the site of the warning that follows it (torch warns as the
    op that synced returns).
A site is the innermost frame of `mv2d_tpu_torch` below the harness on the
stack at the sync (`core/nms.py:64 greedy_fixpoint`: the lines that
synced), not the line inside torch that made it.  A sync on a thread with
no Python frame (the autograd engine's) raises no warning: its blocked ms
go to NO_FRAME.  The profiles are read from kineto's records
(`events_of`), not torch's event tree, which takes seconds to build for a
training step.  On the CPU only the host ms is measured.
"""
from __future__ import annotations

import argparse
import bisect
import os
import subprocess
import sys
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..profile_train import _busy_ms
from ..utils.profiling import counters, sync_warning

PKG = 'mv2d_tpu_torch'
_HERE = os.path.basename(__file__)
SYNC_APIS = ('cudaStreamSynchronize', 'cudaEventSynchronize',
             'cudaDeviceSynchronize')
MEMCPY_API = 'cudaMemcpyAsync'
TOP_SITES = 3
NO_FRAME = '(no mv2d_tpu_torch frame)'

Site = Tuple[str, str]          # (file under mv2d_tpu_torch/, function)


@dataclass
class SiteStats:
    syncs: int = 0                          # a call, from the warnings
    lines: Set[int] = field(default_factory=set)
    blocked_ms: float = 0.0                 # a call, from the profiler


@dataclass
class Row:
    name: str
    host_ms: float                          # a call, host clock
    rounds: float = 0.0                     # NMS fixpoint rounds a call
    busy_ms: Optional[float] = None         # a call, None on the CPU
    sites: Optional[Dict[Site, SiteStats]] = None    # None on the CPU

    @property
    def syncs(self) -> Optional[int]:
        return None if self.sites is None else sum(
            s.syncs for s in self.sites.values())

    @property
    def blocked_ms(self) -> Optional[float]:
        return None if self.sites is None else sum(
            s.blocked_ms for s in self.sites.values())

    def top(self, n: int = TOP_SITES) -> List[Tuple[Site, SiteStats]]:
        """The n sites that block the host longest (by sync count where
        the profiler saw no blocking)."""
        if not self.sites:
            return []
        return sorted(self.sites.items(),
                      key=lambda kv: (-kv[1].blocked_ms, -kv[1].syncs,
                                      kv[0]))[:n]


def site_name(site: Site, stats: Optional[SiteStats] = None) -> str:
    path, func = site
    lines = ','.join(str(x) for x in sorted(stats.lines)) \
        if stats and stats.lines else ''
    return f'{path}:{lines} {func}' if lines else f'{path}:{func}'


def _pkg_path(filename: str) -> Optional[str]:
    """The path under mv2d_tpu_torch/ of a file in the package, else
    None."""
    f = '/' + filename.replace(os.sep, '/')
    i = f.rfind(f'/{PKG}/')
    if i < 0:
        return None
    return f[i + len(PKG) + 2:]


def frame_site(frames) -> Tuple[Site, Optional[int]]:
    """The innermost frame of the package below this harness in a stack
    of (filename, function, line), innermost first -> (site, its line);
    NO_FRAME where the harness comes first (a sync in torch's own code
    called by the harness, or by a torch function timed as it is)."""
    for filename, func, line in frames:
        p = _pkg_path(filename)
        if p is not None:
            if p.endswith(_HERE):
                break
            return (p, func), line
    return (NO_FRAME, ''), None


def _live_frames(frame):
    """The interpreter's stack from `frame` outwards, as frame_site takes
    it."""
    while frame is not None:
        yield frame.f_code.co_filename, frame.f_code.co_name, frame.f_lineno
        frame = frame.f_back


class _Span(NamedTuple):
    start: float
    end: float


class Event(NamedTuple):
    """One profiler event, read from kineto's records without torch's
    event tree (which takes seconds to build for a training step).
    Times in us on the host's clock (time.time_ns() / 1e3)."""
    name: str
    host: bool                  # an op or a runtime call
    start: float
    end: float
    corr: int                   # correlation id (a runtime call's kernels)
    annotation: bool            # a user annotation, not a kernel

    @property
    def time_range(self):
        return _Span(self.start, self.end)


def events_of(prof) -> List[Event]:
    """The raw events of a finished torch.profiler.profile."""
    cpu = torch.autograd.DeviceType.CPU
    return [Event(e.name(), e.device_type() == cpu, e.start_ns() / 1e3,
                  e.end_ns() / 1e3, e.correlation_id(),
                  bool(e.is_user_annotation()))
            for e in prof.profiler.kineto_results.events()]


# torch raises a sync's warning when the op that synced returns to Python:
# a runtime call belongs to the first warning within this many us after it
MATCH_US = 1000.0


def blocked_by_site(events: Sequence[Event],
                    marks: Sequence[Tuple[float, Site]], until: float
                    ) -> Dict[Site, Tuple[float, int]]:
    """A call's profiler events and its sync warnings (us, site), in
    time order -> site -> (host ms blocked in the sync APIs and
    device-to-host copies, their count).  A runtime call that began
    before `until` (us) goes to the site of the first warning within
    MATCH_US after it ends, else to NO_FRAME (a sync off the Python
    thread, as in the autograd engine's)."""
    d2h = {e.corr for e in events if not e.host and 'DtoH' in e.name}
    times = [t for t, _ in marks]
    out: Dict[Site, Tuple[float, int]] = {}
    for e in events:
        if not e.host or e.start >= until or not (
                e.name in SYNC_APIS or (e.name == MEMCPY_API
                                        and e.corr in d2h)):
            continue
        i = bisect.bisect_left(times, e.end)
        site = marks[i][1] if i < len(marks) and \
            times[i] - e.end <= MATCH_US else (NO_FRAME, '')
        ms, n = out.get(site, (0.0, 0))
        out[site] = (ms + (e.end - e.start) / 1e3, n + 1)
    return out


def sync_sites(fn, args) -> Dict[Site, SiteStats]:
    """One call of fn(*args) under torch.profiler and the sync debug
    mode 'warn': every warning is one sync, put to its site; every sync
    runtime call's host ms to a site by `blocked_by_site`."""
    from torch.profiler import ProfilerActivity, profile
    stats: Dict[Site, SiteStats] = {}
    marks: List[Tuple[float, Site]] = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if not sync_warning(message):
            return
        t = time.time_ns() / 1e3
        site, ln = frame_site(_live_frames(sys._getframe(1)))
        marks.append((t, site))
        st = stats.setdefault(site, SiteStats())
        st.syncs += 1
        if ln is not None:
            st.lines.add(ln)

    torch.cuda.synchronize()
    with warnings.catch_warnings(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter('always')
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode('default')
            until = time.time_ns() / 1e3
        torch.cuda.synchronize()
    for site, (ms, _) in blocked_by_site(events_of(prof), marks,
                                         until).items():
        stats.setdefault(site, SiteStats()).blocked_ms += ms
    return stats


def _profiled(fn, args, n: int = 1) -> List[Event]:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
    return events_of(prof)


# a profiled window of at least this many host ms; a short one has been
# seen to come back without its kernels
BUSY_WINDOW_MS = 20.0
BUSY_TRIES = 3


def device_busy_ms(fn, args, host_ms: float = BUSY_WINDOW_MS
                   ) -> Optional[float]:
    """The device's busy ms a call: a profiled window of n calls (n from
    the host ms a call, so that it lasts about BUSY_WINDOW_MS), over n;
    up to BUSY_TRIES windows until one holds kernels, None when none
    does."""
    n = max(1, min(20, int(np.ceil(BUSY_WINDOW_MS / max(host_ms, 1e-3)))))
    for _ in range(BUSY_TRIES):
        kern = [e for e in _profiled(fn, args, n)
                if not e.host and not e.annotation and '#' not in e.name]
        if kern:
            return _busy_ms(kern) / n
    return None


def timed(fn, *args, iters: int = 10, warmup: int = 2, name: str = '',
          device='cuda') -> Row:
    """Times fn(*args) on `device` (see the module's docstring) and
    prints its row."""
    cuda = torch.device(device).type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for _ in range(1 + warmup):
        fn(*args)
    sync()
    r0 = counters['nms_rounds']
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync()
    row = Row(name, (time.perf_counter() - t0) * 1e3 / iters,
              (counters['nms_rounds'] - r0) / iters)
    if cuda:
        row.busy_ms = device_busy_ms(fn, args, row.host_ms)
        row.sites = sync_sites(fn, args)
    print_row(row)
    return row


def print_row(row: Row, width: int = 40):
    busy = 'busy    n/a' if row.busy_ms is None \
        else f'busy {row.busy_ms:8.3f}'
    if row.sites is None:
        syncs = 'syncs n/a (CPU)'
    else:
        syncs = (f'syncs {row.syncs:4d} blocked {row.blocked_ms:8.3f} ms; '
                 + '; '.join(f'{site_name(s, st)} x{st.syncs} '
                             f'{st.blocked_ms:.3f} ms'
                             for s, st in row.top()))
    print(f'{row.name:{width}s} {row.host_ms:9.3f} ms  {busy} ms  nms rounds '
          f'{row.rounds:g}  {syncs}', flush=True)


def refuse(piece: str, reason: str):
    """Prints why a piece or flag of the JAX tool has no counterpart."""
    print(f'{piece}: not ported ({reason})', flush=True)


# ---------------------------------------------------------------- set-up

def add_common_args(p: argparse.ArgumentParser, iters: int = 10,
                    warmup: int = 2):
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    p.add_argument('--iters', type=int, default=iters)
    p.add_argument('--warmup', type=int, default=warmup)
    p.add_argument('--preset', default='mv2d_t_r50',
                   help='a config of mv2d_tpu_torch.configs (the JAX tools '
                        'fix MV2D-T R50; tests pass tiny)')
    p.add_argument('--num-frames', type=int, default=None,
                   help="override the preset's frames (tiny: 1)")


def add_init_arg(p: argparse.ArgumentParser):
    p.add_argument('--init', choices=('bench', 'random'), default='bench',
                   help="the model's weights: 'bench' (default; "
                        "synthetic.bench_rule_weights, bench.py's rule) or "
                        "'random' (synthetic.init_random_weights, the "
                        "weights chip_smoke.py serves and trains)")


def init_weights(model, init: str = 'bench', seed: int = 0):
    """`model` with `bench_rule_weights(seed)` or, for init 'random',
    `init_random_weights(seed)`."""
    from ..synthetic import bench_rule_weights, init_random_weights
    return {'bench': bench_rule_weights,
            'random': init_random_weights}[init](model, seed=seed)


def device_of(args) -> torch.device:
    """The tool's device; raises where CUDA is asked for and absent."""
    from .common import device_and_dtype
    return device_and_dtype(args.device)[0]


def model_config(args, **overrides):
    from .. import configs
    if args.num_frames is not None:
        overrides.setdefault('num_frames', args.num_frames)
    return getattr(configs, args.preset)(**overrides)


def rig_inputs(cfg, dev, dtype, seed: int = 0):
    """The JAX stage benches' scene: N(0, 1) images from default_rng(seed)
    [V, H, W, 3], the camera rig with timestamps 0 / 0.5 for the two
    frames (`export.rig_camera`), full image shapes."""
    from .export import rig_camera
    V, (H, W) = cfg.total_views, cfg.image_size
    imgs = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(V, H, W, 3)).astype(np.float32)).to(dev, dtype)
    shapes = torch.tensor([[H, W]] * V, device=dev)
    return imgs, rig_camera(cfg, dev), shapes


def bench_model(cfg, dev, dtype, init: str = 'bench', seed: int = 0):
    """MV2D of cfg on the default routes with `init_weights(init, seed)`,
    in eval mode, on dev in dtype."""
    from ..models.mv2d import MV2D
    from ..routes import Routes
    model = init_weights(MV2D(cfg, Routes()), init, seed)
    return model.eval().to(dev, dtype)


def card(dev) -> str:
    """The card's name and power limit (nvidia-smi), or 'cpu'."""
    if dev.type != 'cuda':
        return 'cpu'
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def header(tool: str, dev, dtype, cfg=None):
    what = '' if cfg is None else (
        f' {cfg.total_views} views @ {cfg.image_size[0]}x'
        f'{cfg.image_size[1]}')
    print(f'[{tool}]{what}, {str(dtype)[6:]}, {card(dev)}', flush=True)


def want(pieces: Sequence[str], asked: Sequence[str]) -> List[str]:
    """The pieces asked for (all by default); raises on an unknown one."""
    bad = [p for p in asked if p not in pieces]
    if bad:
        raise SystemExit(f'unknown piece(s) {bad}; choose from {pieces}')
    return list(asked) or list(pieces)
