"""MV2D-T at depth 101 with every p4 pixel a key, the setting of the
benchmark's `t_r101.eval` cell (`perfbench/configs/mv2d_t_r101.json`),
against the benchmark's float32 reference (`perfbench/reference`) on the
CPU at toy widths: the port's tiny test configuration
(`perfbench/tests/tiny.json`: 2 cameras x 2 frames at 64x96) with
ResNet-101's blocks (3-4-23-3, DCNv2 in stages 3-4) and k_max equal to
V * h * w.  One float32 eval forward of a seeded scene, with the
benchmark's seeded random weights, is held stage by stage to the
reference as the cell's check holds the card's (`perfbench.check`):
feats, the 2D detections and their scores, PE, head and decode, each
within 1e-5 (the float32 program equals the reference to rounding, as
in `perfbench/tests/test_perfbench_run.py`) and within the cell's
limits: a rehearsal of the cell's check.  No active key is dropped.
The same setting is held to the JAX package, stage by stage, in
`tests/test_torch_port_r101.py`.  Nothing here imports JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_r101_cell.py
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip('torch')

from perfbench import check, program, spec              # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELL = 't_r101.eval'
SEED = 2400000017
STAGES = ('feats', 'det2d', 'det2d_score', 'pe', 'head', 'decode')


def _file(rel):
    return json.loads((ROOT / rel).read_text())


def toy_r101() -> dict:
    """The tiny configuration at depth 101, DCN in stages 3-4, every p4
    pixel a key."""
    m = dict(_file('perfbench/tests/tiny.json')['model'])
    full = _file('perfbench/configs/mv2d_t_r101.json')['model']
    for k in ('depth', 'stage_with_dcn', 'num_frames', 'key_mode'):
        m[k] = full[k]
    V = m['num_views'] * m['num_frames']
    h, w = (s // m['stride'] for s in m['image_size'])
    m['k_max'] = V * h * w
    return m


def test_cell_config_attends_every_p4_pixel():
    f = _file('perfbench/configs/mv2d_t_r101.json')
    m = f['model']
    V = m['num_views'] * m['num_frames']
    h, w = (s // m['stride'] for s in m['image_size'])
    assert (V, h, w) == (12, 40, 100)
    assert m['k_max'] == V * h * w == 48000
    assert (m['depth'], m['image_size']) == (101, [640, 1600])
    assert f['reduced'] == []
    # the rest is mv2d_t_r50.json's model as it is
    r50 = _file('perfbench/configs/mv2d_t_r50.json')['model']
    assert {k for k in m if m[k] != r50.get(k)} == {'depth', 'image_size',
                                                    'k_max'}
    assert m.keys() == r50.keys()


@pytest.fixture(scope='module')
def forward():
    """One float32 forward of scene 0 (its stages captured) and its
    diagnostics, then the cell's check of it -> (verdict, diagnostics)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model_cfg = toy_r101()
        traffic = spec.traffic('../tests/eval_f32')
        p = program.EvalProgram(model_cfg, traffic, SEED, 'cpu')
        cap = {}
        p.call(0, capture=cap)
        diag = p.model(p.imgs[0], p.cam, p.shapes).diagnostics
        p.free()
        out = dict(loop='eval', outputs=p.outputs,
                   captures={0: dict(cap, scene=0)})
        bench = spec.load_benchmark()
        verdict = check.judge(CELL, spec.workload(bench, CELL), model_cfg,
                              traffic, SEED, out, 'cpu')
        return verdict, diag
    finally:
        torch.set_num_threads(threads)


def test_no_active_key_is_dropped(forward):
    _, diag = forward
    assert int(diag['key_overflow']) == 0
    assert int(diag['key_active']) > 0


@pytest.mark.parametrize('stage', STAGES)
def test_stage_matches_the_reference(forward, stage):
    verdict, _ = forward
    lines = [ln for ln in verdict['lines'] if ln.startswith(
        f'check {stage} ')]
    assert len(lines) == 1, verdict['lines']
    reading = float(lines[0].split()[2])
    assert reading <= 1e-5, lines[0]
    if stage in verdict['numbers']:             # judged, not only printed
        v, lim = verdict['numbers'][stage]
        assert v <= lim, lines[0]


def test_forward_is_correct_against_the_cell_limits(forward):
    verdict, _ = forward
    assert verdict['correct'], verdict['lines']
    assert verdict['attempted'] == 1 and verdict['failed'] == 0
