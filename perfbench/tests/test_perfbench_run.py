"""The harness end to end on the CPU at the port's tiny size (its
configuration `tiny.json`, the cells of `bench_tiny.json`), each run in a
process of its own: the result line's keys, every end-to-end and
per-layer metric a CPU run can read, `correct` against the real cells'
limits where the program computes in float32 (it then equals the
reference), and the modules the process loaded: no jax, jaxlib, flax or
JAX package by their top-level names, and nothing of the program in a
process that ran only the reference."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = 'perfbench/tests/bench_tiny.json'
RUN = '''
import json, sys, torch
torch.set_num_threads(2)
from perfbench import run, spec
args = run.parse_args({argv!r})
r = run.run(args, bench_path={bench!r}, device='cpu',
            limits=spec.limits({limits!r}))
print(json.dumps(dict(result=r, modules=sorted(
    {{m.split('.', 1)[0] for m in sys.modules}}))))
'''


def run_cell(workload, limits, trace=0, seconds=1.5, seed=3000000019):
    argv = ['--workload', workload, '--seed', str(seed), '--seconds',
            str(seconds), '--trace', str(trace)]
    code = RUN.format(argv=argv, bench=BENCH, limits=limits)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('workload,limits', [('tiny.eval_f32', 't_r50.eval'),
                                             ('tiny.train_f32',
                                              't_r50.train')])
def test_float32_program_is_correct(workload, limits):
    got = run_cell(workload, limits)
    r = got['result']
    assert r['correct'], r['checked']
    # the port's float32 path equals the frozen reference to rounding
    assert all(v <= 1e-5 for v, _ in r['checked'].values()), r['checked']
    assert r['attempted'] > 0 and r['failed'] == 0
    assert set(r) >= {'correct', 'attempted', 'failed', 'metrics', 'device'}
    assert 'setup_s' in r['metrics'] and len(r['metrics']) == 2
    assert not {'jax', 'jaxlib', 'flax', 'mv2d_tpu'} & set(got['modules'])
    assert 'mv2d_tpu_torch' in got['modules']


@pytest.mark.parametrize('workload', ['tiny.eval', 'tiny.train'])
def test_traced_run_reads_per_layer_metrics(workload):
    r = run_cell(workload, workload.replace('tiny', 't_r50'), trace=1,
                 seconds=4)['result']
    mets = r['metrics']
    loop = workload.split('.')[1]
    want = {'eval': {'scene_ms_p95.eval', 'host_ms.backbone.eval',
                     'host_ms.detect.eval', 'host_ms.pe.eval',
                     'host_ms.head.eval', 'host_ms.decode.eval',
                     'nms_rounds.eval'},
            'train': {'host_ms.objective.train', 'host_ms.update.train',
                      'nms_rounds.train'}}[loop]
    assert want <= set(mets), mets
    assert all(m['value'] > 0 for m in mets.values())
    # device metrics are the card's only
    assert not any(k.startswith(('busy_ms', 'mfu', 'roofline', 'device_',
                                 'peak_mem')) for k in mets)


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, 'perfbench/run.py', '--workload', 't_r50.eval',
         '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={'CUDA_VISIBLE_DEVICES': '', 'PATH': '/usr/bin:/bin'})
    assert out.returncode != 0
    assert out.stdout.strip() == ''


def test_reference_loads_nothing_of_the_program():
    code = '''
import json, sys, torch
from perfbench import check, inputs, spec
bench = spec.load_benchmark('perfbench/tests/bench_tiny.json')
cfg = spec.config(bench, 'tiny')
t = spec.traffic('../tests/train_f32')
out = check.train_reference(cfg, t, 5, 'cpu', 1)
assert out['losses'][0] > 0
print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))
'''
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not {'jax', 'jaxlib', 'flax', 'mv2d_tpu', 'mv2d_tpu_torch'} & mods
