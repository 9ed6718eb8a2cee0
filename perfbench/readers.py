"""Metric readers: `metrics/<name>.py` holds the reader of the metric
<name>, a function `read(obs)` that returns its value, or None where the
run has nothing to read (the metric is then left out of the line).
`obs` is what a run observed (see `run.run`); the helpers here are the
arithmetic the readers share."""
from __future__ import annotations

import importlib.util
import statistics
from typing import Dict, List, Optional

from . import flops, spec

GIB = 2 ** 30


def _reader(name: str):
    path = spec.HERE / 'metrics' / f'{name}.py'
    s = importlib.util.spec_from_file_location(f'perfbench_metric_{name}',
                                               path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def read(names: List[str], bench: dict, obs: dict) -> Dict[str, dict]:
    units = {m['name']: m['unit'] for m in bench['end_to_end']
             + bench['per_layer']}
    out = {}
    for name in names:
        v = _reader(name)(obs)
        if v is not None:
            out[name] = dict(value=float(v), unit=units[name])
    return out


def rate(obs: dict, loop: str) -> Optional[float]:
    """Calls completed over the window's seconds."""
    if obs['loop'] != loop or obs['window_s'] <= 0:
        return None
    return obs['calls'] / obs['window_s']


def p95_ms(obs: dict, loop: str) -> Optional[float]:
    lat = obs['latencies_s']
    if obs['loop'] != loop or len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20, method='inclusive')[18] * 1e3


def span_ms(obs: dict, span: str, loop: str) -> Optional[float]:
    """Host ms a call inside the window's spans of that name."""
    if obs['loop'] != loop:
        return None
    ms = [(b - a) / 1e6 for n, a, b in obs['spans'] if n == span]
    return sum(ms) / obs['calls'] if ms else None


def traced(obs: dict, key: str, loop: str):
    if obs['loop'] != loop:
        return None
    return obs.get(key)


def busy_ms(obs: dict, span: str, loop: str) -> Optional[float]:
    if obs['loop'] != loop:
        return None
    v = obs.get('busy_ms_by_span', {}).get(span)
    return v if v else None


def idle_pct(obs: dict, loop: str) -> Optional[float]:
    """The device's idle share of the profiled slice: 1 - the union of its
    kernels' intervals over the slice's wall time."""
    if obs['loop'] != loop or not obs.get('busy_s') or \
            not obs.get('traced_s'):
        return None
    return 100.0 * (1.0 - obs['busy_s'] / obs['traced_s'])


def per_call(obs: dict, counter: str, loop: str) -> Optional[float]:
    if obs['loop'] != loop:
        return None
    v = obs['counters'].get(counter, 0) / max(obs['calls'], 1)
    return v if v > 0 else None


def mfu_pct(obs: dict, loop: str) -> Optional[float]:
    """Model FLOPs a call (`flops.model_flops`) times the window's rate,
    over the card's bf16 dense peak."""
    r = rate(obs, loop)
    if r is None or obs.get('card', 'cpu') == 'cpu':
        return None
    f = flops.model_flops(obs['model_cfg'], loop)
    if f is None:
        return None
    return 100.0 * f * r / flops.PEAK_BF16


def peak_gib(obs: dict, loop: str) -> Optional[float]:
    if obs['loop'] != loop or not obs['peak_bytes']:
        return None
    return obs['peak_bytes'] / GIB
