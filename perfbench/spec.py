"""BENCHMARK.json and the data files it names: configurations
(`configs/<name>.json`), traffic mixes (`traffic/<name>.json`) and the
limits of the output check (`limits/<workload>.json`), found by name."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(path: Optional[Path] = None) -> dict:
    return json.loads(Path(path or ROOT / 'BENCHMARK.json').read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench['workloads']:
        if w['name'] == name:
            return w
    raise SystemExit(f'no workload {name!r} in BENCHMARK.json')


def config(bench: dict, name: str) -> dict:
    """The `model` of a configuration's file."""
    for c in bench['configs']:
        if c['name'] == name:
            return json.loads((ROOT / c['file']).read_text())['model']
    raise SystemExit(f'no configuration {name!r} in BENCHMARK.json')


def traffic(name: str) -> dict:
    return json.loads((HERE / 'traffic' / f'{name}.json').read_text())


def limits(workload_name: str) -> dict:
    """number -> limit of the output check of a workload, and under
    'not_compared' the numbers it prints without judging."""
    p = HERE / 'limits' / f'{workload_name}.json'
    if not p.exists():
        return {}
    f = json.loads(p.read_text())
    return dict(f['limits'], not_compared=f.get('not_compared', []))
