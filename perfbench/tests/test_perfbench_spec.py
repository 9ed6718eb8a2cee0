"""BENCHMARK.json and the files it names: every name, unit and text within
the benchmark's rules, every cell's configuration, traffic mix, metric
readers and check limits present, every per-layer metric reported in the
cells it lists beside the end-to-end metric it moves."""
from __future__ import annotations

import json
import re

import pytest

from perfbench import flops, readers, spec

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_.\-/]{1,200}$')
KEYS = {
    'top': {'command', 'paths', 'run_seconds', 'configs', 'workloads',
            'end_to_end', 'per_layer'},
    'config': {'name', 'source', 'file', 'reduced', 'why'},
    'workload': {'name', 'config', 'traffic', 'chips', 'why'},
    'e2e': {'name', 'unit', 'better', 'bound', 'source'},
    'layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}


@pytest.fixture(scope='module')
def bench():
    return spec.load_benchmark()


def text(s):
    assert isinstance(s, str) and 1 <= len(s) <= 200, s
    assert '\n' not in s and '\t' not in s, s


def test_top_level(bench):
    assert set(bench) == KEYS['top']
    assert (spec.ROOT / 'BENCHMARK.json').stat().st_size <= 64 * 1024
    assert 1 <= len(bench['paths']) <= 16
    for p in bench['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
        assert not p.endswith('_torch')
    assert 1 <= len(bench['command']) <= 32
    for w in bench['command']:
        text(w)
        assert not w.startswith('/') and '..' not in w
    assert isinstance(bench['run_seconds'], int)
    assert 1 <= bench['run_seconds'] <= 51
    cells = len(bench['workloads'])
    # a full check of 24 cells (14 runs each, 60 s over the window a run,
    # 180 s a cell to compile, 1200 s spare) fits 43200 s
    assert 2 + 14 * 24 * (bench['run_seconds'] + 60) + 24 * 180 + 1200 \
        <= 43200, cells


def test_configs(bench):
    names = [c['name'] for c in bench['configs']]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w['config'] for w in bench['workloads']}
    for c in bench['configs']:
        assert set(c) == KEYS['config']
        assert NAME.match(c['name']) and c['name'] in used
        text(c['source'])
        text(c['why'])
        assert c['file'].startswith(tuple(p + '/' for p in bench['paths']))
        f = json.loads((spec.ROOT / c['file']).read_text())
        assert f['reduced'] == c['reduced'] and len(c['reduced']) <= 16
        assert f['source'] == c['source']
        for k in c['reduced']:
            assert NAME.match(k)
            assert not k.endswith(('_dim', '_rank', '_dims', '_channels'))


def test_workloads(bench):
    names = [w['name'] for w in bench['workloads']]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = [(w['config'], w['traffic']) for w in bench['workloads']]
    assert len(set(pairs)) == len(pairs)
    assert sum(w['chips'] == 4 for w in bench['workloads']) <= 1
    for w in bench['workloads']:
        assert set(w) == KEYS['workload']
        for k in ('name', 'config', 'traffic'):
            assert NAME.match(w[k]), w[k]
        text(w['why'])
        assert w['chips'] in (1, 4)
        t = spec.traffic(w['traffic'])
        assert t['loop'] in ('eval', 'train')
        lim = spec.limits(w['name'])
        assert lim, f'{w["name"]}: no limits/{w["name"]}.json'
        assert all(v >= 0 for k, v in lim.items() if k != 'not_compared')


def test_metrics(bench):
    e2e, per = bench['end_to_end'], bench['per_layer']
    names = [m['name'] for m in e2e + per]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    assert 'setup_s' in [m['name'] for m in e2e]
    cells = {w['name'] for w in bench['workloads']}
    for m in e2e:
        assert set(m) - {'workloads'} == KEYS['e2e']
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in per:
        assert set(m) - {'workloads'} == KEYS['layer']
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        text(m['layer'])
        assert m['moves'] in [x['name'] for x in e2e]
    layers = {}
    for m in e2e + per:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
        assert set(m.get('workloads', cells)) <= cells
        assert (spec.HERE / 'metrics' / f'{m["name"]}.py').exists()
        if 'layer' in m:
            layers.setdefault(m['layer'].lower(), set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values()), layers
    for m in per:
        if m['name'].endswith(('_roofline', 'mfu_pct.eval', 'mfu_pct.train')):
            assert m['unit'] == '%'
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one; a per-layer metric's cells report what it moves
    for c in cells:
        reports = {m['name'] for m in e2e if c in m.get('workloads', cells)}
        assert 'setup_s' in reports and len(reports) >= 2
        assert any(c in m.get('workloads', cells) for m in per)
    for m in per:
        moved = next(x for x in e2e if x['name'] == m['moves'])
        assert set(m.get('workloads', cells)) <= set(
            moved.get('workloads', cells))


def test_readers_load(bench):
    """Every reader imports and reads nothing from an empty eval run."""
    obs = dict(loop='none', calls=0, window_s=0.0, latencies_s=[],
               setup_s=1.0, counters={}, spans=[], model_cfg={},
               peak_bytes=0, card='cpu')
    for m in bench['end_to_end'] + bench['per_layer']:
        v = readers._reader(m['name'])(obs)
        assert v is None or m['name'] == 'setup_s'


def test_flops_of_each_config(bench):
    for c in bench['configs']:
        model = spec.config(bench, c['name'])
        assert flops.model_flops(model, 'eval') > 0
        assert flops.model_flops(model, 'train') > 2 * flops.model_flops(
            model, 'eval')
