"""The output check fails what it must: the control (the reference in the
program's place, its products in fp8) and the faults a cell can have,
planted under a whole run of the harness at the tiny size on the CPU
with the real cells' limits.  The faults: an answer altered where it is
produced (eval); a step that returns its state unchanged (train).  A
cell's step takes one scene and runs on one card, so no half of a batch
and no exchange between cards can be left out."""
from __future__ import annotations

import pytest
import torch

from perfbench import control, run, spec

BENCH = 'perfbench/tests/bench_tiny.json'


def run_cell(workload, limits, seed=3000000029):
    torch.set_num_threads(2)
    args = run.parse_args(['--workload', workload, '--seed', str(seed),
                           '--seconds', '1', '--trace', '0'])
    return run.run(args, bench_path=BENCH, device='cpu',
                   limits=spec.limits(limits))


@pytest.mark.parametrize('workload,limits', [('tiny.eval', 't_r50.eval'),
                                             ('tiny.train', 't_r50.train'),
                                             ('tiny.eval', 's_r50.eval'),
                                             ('tiny.train', 's_r50.train')])
def test_control_fails(workload, limits):
    v = control.control_numbers(workload, 3000000031, bench_path=BENCH,
                                device='cpu', limits=spec.limits(limits))
    assert not v['correct'], v['numbers']


def test_altered_answer_fails(monkeypatch):
    from mv2d_tpu_torch.models import mv2d
    decode = mv2d.MV2D.decode

    def altered(self, out):
        det = decode(self, out)
        return det._replace(boxes=det.boxes + torch.tensor(
            [0.5] + [0.0] * 8, device=det.boxes.device))
    monkeypatch.setattr(mv2d.MV2D, 'decode', altered)
    r = run_cell('tiny.eval_f32', 't_r50.eval')
    assert not r['correct'] and r['failed'] == r['attempted'] > 0
    assert r['checked']['decode'][0] > r['checked']['decode'][1]


def test_unchanged_state_fails(monkeypatch):
    from mv2d_tpu_torch.parallel import dist
    from mv2d_tpu_torch.train import optim

    def no_update(opt):
        norm = optim.clip_by_global_norm(
            [p for g in opt.param_groups for p in g['params']],
            opt.clip_norm)
        return norm, 0.0
    monkeypatch.setattr(dist, 'apply_update', no_update)
    r = run_cell('tiny.train_f32', 't_r50.train')
    assert not r['correct']
    assert r['checked']['change'][0] > 0.9
