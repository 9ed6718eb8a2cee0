"""`perfbench/program_spans.py` on the CPU: its arithmetic on hand-made
spans and events (host ms and self time by span, the share the root's
children cover, device idle put to the program span open when each idle
stretch began), and one run of each tiny cell that reads every number of
its mode the program's spans and counters give (the device's only,
idle ms, excepted)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from mv2d_tpu_torch.utils.profiling import Span
from perfbench import program_spans as ps

ROOT = Path(__file__).resolve().parents[2]
RUN = '''
import json, torch
torch.set_num_threads(2)
from perfbench import program_spans as ps
args = ps.parse_args({argv!r})
print(json.dumps(ps.measure(args, bench_path={bench!r}, device='cpu')))
'''


def test_idle_by_span_puts_each_stretch_to_the_spans_open_at_its_start():
    kernels = [(10, 20), (30, 40), (35, 38), (50, 60)]
    stretches = ps.idle_stretches(kernels, (0, 70))
    assert stretches == [(0, 10), (20, 30), (40, 50), (60, 70)]
    spans = [('detect', 15, 45), ('rpn', 18, 25), ('objective', 55, 100)]
    assert ps.idle_by_span(stretches, spans) == {
        'detect': 20, 'rpn': 10, 'objective': 10}
    # a stretch that began before the window's first kernel, in no span
    assert ps.idle_by_span([(0, 10)], spans) == {}


def test_host_ms_reads_names_parents_and_self_time():
    ms = 10 ** 6
    spans = [Span('train_step', -1, 1, 0, 100 * ms),
             Span('objective', 0, 1, 5 * ms, 80 * ms),
             Span('forward', 1, 1, 6 * ms, 50 * ms),
             Span('nms', 2, 1, 10 * ms, 20 * ms),
             Span('backward', 0, 1, 80 * ms, 95 * ms),
             Span('forward', -1, 2, 200 * ms, 210 * ms)]
    assert ps.host_ms(spans, 2, 'forward', 'objective') == 22
    assert ps.host_ms(spans, 1, 'forward') == 54
    assert ps.host_ms(spans, 1, 'forward', 'objective', True) == 34
    assert ps.host_ms(spans, 1, 'draws') is None
    assert ps.children_share(spans, 'train_step') == pytest.approx(0.9)
    assert ps.by_path(spans, 1)['train_step/objective/forward'] == \
        [44, 34]
    assert ps.syncs({'sync.a': 6, 'sync.b': 2, 'nms_rounds': 5}, 2) == 4
    assert ps.innermost(spans, 12_000) == \
        'train_step/objective/forward/nms'
    assert ps.innermost(spans, 150_000) == 'between'


@pytest.mark.parametrize('workload', ['tiny.eval', 'tiny.train'])
def test_tiny_cell_reads_every_span_and_counter(workload):
    argv = ['--workload', workload, '--seed', '3000000019', '--seconds',
            '0.5', '--rounds', '1']
    code = RUN.format(argv=argv, bench='perfbench/tests/bench_tiny.json')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    mode = workload.split('.')[1]
    want = {'eval': {'host_ms.rpn.eval', 'host_ms.nms.eval',
                     'host_ms.keys.eval', 'host_ms.decoder.eval',
                     'host_syncs.eval', 'nms_rounds.eval'},
            'train': {'host_ms.draws.train', 'host_ms.forward.train',
                      'host_ms.match.train', 'host_ms.backward.train',
                      'host_syncs.train', 'nms_rounds.train'}}[mode]
    assert set(r['metrics']) == want
    assert all(v > 0 for v in r['metrics'].values())
    # a fixpoint's first test is read twice where its loop runs
    assert r['metrics'][f'nms_rounds.{mode}'] < \
        r['counters_per_call']['sync.nms.round']
    assert r['root_children_share'] > 0.9
    assert len(r['rate_off']) == len(r['rate_on']) == 1
    # the profiled slice's spans are profiler ranges under their names
    assert {'detect', 'rpn', 'nms'} <= set(r['profiler_ranges'])
    assert 'idle_ms_by_span' not in r and 'sync' not in r   # the card's
