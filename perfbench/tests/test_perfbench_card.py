"""On the card only (marked cuda; without a CUDA device each test skips):
the control at each cell's own size on three seeds comes out not correct,
and a short run of each cell comes out correct.  Run from the repository's
root: python3 -m pytest --noconftest -p no:cacheprovider -q -m cuda
perfbench/tests/test_perfbench_card.py"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import spec

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[2]
CELLS = [w['name'] for w in spec.load_benchmark()['workloads']]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the cells run on the card')


@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_on_three_seeds(card, cell):
    out = subprocess.run(
        [sys.executable, 'perfbench/control.py', '--workload', cell,
         '--seeds', '4100000001,4100000002,4100000003'], cwd=ROOT,
        capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(x) for x in out.stdout.splitlines()
            if x.startswith('{')]
    assert len(rows) == 3 and not any(r['correct'] for r in rows), rows


@pytest.mark.parametrize('cell', CELLS)
def test_short_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, 'perfbench/run.py', '--workload', cell, '--seed',
         '4100000009', '--seconds', '5', '--trace', '0'], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r['correct'], r
