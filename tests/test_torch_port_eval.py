"""The port's evaluation path against the JAX package's, on the CPU.

  * `eval.nuscenes_eval.evaluate` on the devkit fixture of
    `tests/test_eval_devkit.py`: every metric exactly JAX's;
  * `eval.results`: pred dicts, the submission and the GT dicts exactly
    JAX's, on infos from the raw-table converter;
  * `eval.runner.run_eval` on the tiny preset (6 views, 3 scenes, 64x96)
    against JAX's `run_eval(data_parallel=False)`, the JAX model's weights
    carried across by `state_dict_from_jax`: per token the same `valid`
    and labels, scores within 1e-4 and boxes within 2e-3 (the slice
    tolerances of `test_torch_port_slice.py`, float32 on both sides); and
    JAX's own predictions scored by the port's `evaluate` give exactly
    JAX's metrics.  The scenes of `tests/test_data.py`'s fake dataset get
    the six yawed cameras of `make_synth_fixture`: its own six cameras are
    one camera (identity rotation, no translation), so every view-to-view
    transform is the identity, the epipolar correlation's sample points
    land on the boxes' edges, and the proposals' float32 differences
    (6e-5 between the two packages) flip which RoIs correlate (both
    packages give equal correlations on equal boxes);
  * `tools.common.build_dataset` against the repository's;
  * `python -m mv2d_tpu_torch.tools.test` as a subprocess (`--device
    cpu`, a `.pth` loaded strictly): the submission's schema; a checkpoint
    with a key missing is refused, and so is the default device where
    there is no card;
  * `tools.create_data` on the raw tables: the converter's files;
  * `tools.eval_e2e_bench.run`: each part of the split.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402

from mv2d_tpu import configs as jcfgs                    # noqa: E402
from mv2d_tpu.data import converter as jcv               # noqa: E402
from mv2d_tpu.data import nuscenes as jnusc              # noqa: E402
from mv2d_tpu.data import pipeline as jpl                # noqa: E402
from mv2d_tpu.eval import nuscenes_eval as jne           # noqa: E402
from mv2d_tpu.eval import results as jres                # noqa: E402
from mv2d_tpu.models.mv2d import MV2D as JMV2D           # noqa: E402
from mv2d_tpu_torch import configs as tcfgs              # noqa: E402
from mv2d_tpu_torch.data import nuscenes as tnusc        # noqa: E402
from mv2d_tpu_torch.data import pipeline as tpl          # noqa: E402
from mv2d_tpu_torch.eval import nuscenes_eval as tne     # noqa: E402
from mv2d_tpu_torch.eval import results as tres          # noqa: E402
from mv2d_tpu_torch.models.mv2d import MV2D as TMV2D     # noqa: E402
from mv2d_tpu_torch.synthetic import init_random_weights  # noqa: E402
from mv2d_tpu_torch.weights import state_dict_from_jax   # noqa: E402
from tests.test_cli import _write_config                 # noqa: E402
from tests.test_converter import _fake_tables            # noqa: E402
from tests.test_data import _fake_nuscenes               # noqa: E402
from tests.test_eval_devkit import CLS_POOL, make_fixture  # noqa: E402
from tests.test_torch_port_data import (assert_deep_equal,  # noqa: E402
                                        jax_pool_ready)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINAL = (64, 96)


# --------------------------------------------------------------- metrics

def assert_metrics_equal(got, want):
    """Equal keys and exactly equal values (NaN where JAX has NaN)."""
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k] == v or (np.isnan(got[k]) and np.isnan(v)), k


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('ties', [False, True])
def test_evaluate_equals_jax(seed, ties):
    preds, gts, _, _ = make_fixture(np.random.default_rng(seed),
                                    score_ties=ties)
    for classes in (CLS_POOL, tne.CLASSES):
        assert_metrics_equal(tne.evaluate(preds, gts, classes=classes),
                             jne.evaluate(preds, gts, classes=classes))


def test_results_equal_jax(tmp_path):
    """boxes_to_pred_dict, to_nuscenes_submission and gt_dict_from_info on
    the converter's infos (lidar2ego and ego2global poses)."""
    infos = jcv.create_infos(_fake_tables(str(tmp_path), n_samples=3),
                             'v1.0-mini', max_sweeps=1)
    rng = np.random.default_rng(0)
    tp, jp, tokens = [], [], []
    for k, info in enumerate(infos):
        n = 12
        boxes = np.zeros((n, 9), np.float32)
        boxes[:, :2] = rng.uniform(-30, 30, (n, 2))
        boxes[:, 3:6] = rng.uniform(1, 4, (n, 3))
        boxes[:, 6:9] = rng.uniform(-3, 3, (n, 3))
        scores = rng.uniform(0, 1, n).astype(np.float32)
        labels = rng.integers(0, 10, n)
        valid = rng.random(n) < 0.7
        tp.append(tres.boxes_to_pred_dict(boxes, scores, labels, valid,
                                          info if k else None))
        jp.append(jres.boxes_to_pred_dict(boxes, scores, labels, valid,
                                          info if k else None))
        assert_deep_equal(tp[-1], jp[-1])
        assert_deep_equal(tres.gt_dict_from_info(info),
                          jres.gt_dict_from_info(info))
        tokens.append(info['token'])
    by_token = {i['token']: i for i in infos}
    t = tres.to_nuscenes_submission(tokens, tp, by_token)
    assert t == jres.to_nuscenes_submission(tokens, jp, by_token)
    tres.save_submission(str(tmp_path / 's.json'), t)
    with open(tmp_path / 's.json') as f:
        assert json.load(f) == json.loads(json.dumps(t))


# ------------------------------------------------------------ run_eval

@pytest.fixture(scope='module')
def fake(tmp_path_factory):
    """`_fake_nuscenes`' three scenes with the synthetic fixture's yawed
    cameras."""
    from mv2d_tpu_torch.tools.make_synth_fixture import make_rig
    d = str(tmp_path_factory.mktemp('eval_fake'))
    info, coco = _fake_nuscenes(d, n_samples=3)
    with open(info, 'rb') as f:
        data = pickle.load(f)
    for item in data['infos']:
        for cam, rig in zip(tnusc.CAM_SENSORS, make_rig(90, 160)):
            item['cams'][cam].update(
                sensor2lidar_rotation=rig['rotation'],
                sensor2lidar_translation=rig['translation'])
    with open(info, 'wb') as f:
        pickle.dump(data, f)
    return d, info, coco


def _recorder(module, seen):
    """Wraps module.boxes_to_pred_dict to record each scene's model
    outputs by token."""
    fn = module.boxes_to_pred_dict

    def rec(boxes, scores, labels, valid, info=None):
        seen[info['token']] = tuple(np.asarray(a) for a in
                                    (boxes, scores, labels, valid))
        return fn(boxes, scores, labels, valid, info=info)
    return rec


def test_run_eval_matches_jax(fake, monkeypatch):
    jax_pool_ready()
    from mv2d_tpu.eval import runner as jrunner
    from mv2d_tpu_torch.eval.runner import run_eval
    _, info, coco = fake
    kw = dict(info_path=info, ann2d_path=coco, num_frames=1,
              final_dim=FINAL, test_mode=True)
    jds = jnusc.NuScenesDataset(ida=jpl.IdaAugConfig(
        final_dim=FINAL, H=90, W=160), **kw)
    tds = tnusc.NuScenesDataset(ida=tpl.IdaAugConfig(
        final_dim=FINAL, H=90, W=160), **kw)
    jmodel = JMV2D(jcfgs.tiny(num_views=6))
    imgs, cam, shapes = jnusc.to_eval_inputs(jds.get_sample(0))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), imgs, cam,
                                     shapes)
    tmodel = TMV2D(tcfgs.tiny(num_views=6))
    sd = state_dict_from_jax(variables['params'], variables['constants'])
    tmodel.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    tmodel.eval()

    jseen, tseen, jargs = {}, {}, {}
    evaluate = jne.evaluate

    def jevaluate(preds, gts):
        jargs['preds'], jargs['gts'] = preds, gts
        return evaluate(preds, gts)
    monkeypatch.setattr(jres, 'boxes_to_pred_dict', _recorder(jres, jseen))
    monkeypatch.setattr(tres, 'boxes_to_pred_dict', _recorder(tres, tseen))
    monkeypatch.setattr(jrunner.nuscenes_eval, 'evaluate', jevaluate)
    torch.set_num_threads(1)
    jm, jsub = jrunner.run_eval(jmodel, variables, jds, verbose=False,
                                collect_submission=True,
                                data_parallel=False)
    tm, tsub = run_eval(tmodel, tds, 'cpu', verbose=False,
                        collect_submission=True)
    assert set(tseen) == set(jseen) == {'tok0', 'tok1', 'tok2'}
    assert set(tsub['results']) == set(jsub['results'])
    for tok, (jb, js, jl, jv) in jseen.items():
        tb, ts, tl, tv = tseen[tok]
        assert tv.dtype == bool and tb.dtype == ts.dtype == np.float32
        assert jv.any()
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tl[jv], jl[jv])
        assert np.abs(ts[jv] - js[jv]).max() < 1e-4
        assert np.abs(tb[jv] - jb[jv]).max() < 2e-3
        assert len(tsub['results'][tok]) == int(jv.sum())
    # JAX's own predictions through the port's evaluate
    assert_metrics_equal(tne.evaluate(jargs['preds'], jargs['gts']), jm)
    assert list(tm) == list(jm)
    assert np.isfinite([tm['mAP'], tm['NDS']]).all()
    # max_samples
    tm2, tsub2 = run_eval(tmodel, tds, 'cpu', max_samples=2, verbose=False,
                          collect_submission=True)
    assert set(tsub2['results']) == {'tok0', 'tok1'}


def test_build_dataset_matches_repository(fake):
    from mv2d_tpu_torch.tools import common
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    try:
        import common as jcommon
    finally:
        sys.path.remove(os.path.join(REPO, 'tools'))
    d, info, coco = fake
    cfg = common.load_cli_config(_write_config(d, info, coco))
    for split in ('train', 'val'):
        t = common.build_dataset(cfg, split)
        j = jcommon.build_dataset(cfg, split)
        for k in ('info_path', 'ann2d_path', 'data_root', 'num_frames',
                  'sweep_range', 'test_mode', 'final_dim', 'use_valid_flag',
                  'load_separate', 'bev_aug'):
            assert getattr(t, k) == getattr(j, k), k
        assert t.ida.__dict__ == j.ida.__dict__
        assert t.buckets.__dict__ == j.buckets.__dict__
        assert t.native and len(t) == 3


# ----------------------------------------------------------------- CLIs

def test_test_cli_on_cpu(fake, tmp_path):
    """The CLI as a user runs it, with a .pth of the tiny model; the same
    file with a key missing is refused (strict=True)."""
    from mv2d_tpu_torch.tools import common
    from mv2d_tpu_torch.tools import test as ttest
    d, info, coco = fake
    cfg_path = _write_config(d, info, coco)
    model = common.build_model(common.load_cli_config(cfg_path))
    sd = init_random_weights(model, seed=1).state_dict()
    pth = str(tmp_path / 'w.pth')
    torch.save({'state_dict': sd}, pth)
    out = str(tmp_path / 'res.json')
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, '-m', 'mv2d_tpu_torch.tools.test', cfg_path, pth,
         '--device', 'cpu', '--max-samples', '2', '--out', out],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert f'loaded {pth}' in r.stdout and 'mAP' in r.stdout
    assert 'car                    AP:' in r.stdout
    with open(out) as f:
        sub = json.load(f)
    assert set(sub) == {'meta', 'results'}
    assert set(sub['results']) == {'tok0', 'tok1'}
    keys = {'sample_token', 'translation', 'size', 'rotation', 'velocity',
            'detection_name', 'detection_score', 'attribute_name'}
    for tok, recs in sub['results'].items():
        assert 0 < len(recs) <= 500
        for rec in recs:
            assert set(rec) == keys and rec['sample_token'] == tok
            assert len(rec['translation']) == len(rec['size']) == 3
            assert len(rec['rotation']) == 4 and len(rec['velocity']) == 2
            assert rec['detection_name'] in tne.CLASSES
            assert np.isfinite(rec['translation'] + rec['size']
                               + rec['rotation'] + rec['velocity']).all()
    bad = dict(sd)
    bad.pop(next(iter(bad)))
    torch.save(bad, pth)
    with pytest.raises(RuntimeError, match='Missing key'):
        ttest.main([cfg_path, pth, '--device', 'cpu', '--max-samples', '1'])
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match='no CUDA device'):
            ttest.main([cfg_path])


def test_test_cli_takes_eval():
    """`--eval` parses, as in the JAX CLI (store_true, default True), so a
    reference-style command line runs; metrics are on either way."""
    from mv2d_tpu_torch.tools import test as ttest
    for argv in (['c.py', 'w.pth', '--eval'], ['c.py', '--eval', '--out',
                                                'r.json'], ['c.py']):
        args = ttest.parse_args(argv)
        assert args.eval is True and not args.format_only


def test_create_data_cli(tmp_path):
    from mv2d_tpu_torch.tools import create_data
    root = _fake_tables(str(tmp_path), n_samples=3)
    splits = tmp_path / 'splits.json'
    splits.write_text(json.dumps({'val': ['scene-0001']}))
    for argv, split in ((['--max-sweeps', '2'], 'train'),
                        (['--splits-json', str(splits)], 'val')):
        out = tmp_path / split
        create_data.main(['nuscenes', '--root', root, '--version',
                          'v1.0-mini', '--out-dir', str(out), *argv])
        with open(out / f'mmdet3d_nuscenes_30f_infos_{split}.pkl',
                  'rb') as f:
            got = pickle.load(f)
        kw = dict(max_sweeps=2) if split == 'train' else dict(
            scene_names={'scene-0001'}, max_sweeps=25)
        want = jcv.create_infos(root, 'v1.0-mini', **kw)
        assert got['metadata'] == {'version': 'v1.0-mini'}
        assert_deep_equal(got['infos'], want)
        with open(out / f'nuscenes_infos_{split}_mono3d.coco.json') as f:
            assert json.load(f) == json.loads(json.dumps(
                jcv.export_2d_annotations(want)))


def test_eval_e2e_bench_split(fake):
    from mv2d_tpu_torch.tools import eval_e2e_bench
    _, info, coco = fake
    ds = tnusc.NuScenesDataset(
        info_path=info, ann2d_path=coco, num_frames=1, final_dim=FINAL,
        test_mode=True, ida=tpl.IdaAugConfig(final_dim=FINAL, H=90, W=160))
    model = init_random_weights(TMV2D(tcfgs.tiny(num_views=6)).eval())
    calls = tpl.native_preprocess.calls
    out = eval_e2e_bench.run(model, ds, 'cpu', samples=4, repeat=2,
                             verbose=False)
    assert tpl.native_preprocess.calls == calls + 12
    assert set(out['alone']) == {'decode', 'pool'}
    assert len(out['rates']) == 2 and out['samples_per_s'] == max(
        out['rates'])
    assert set(out['ms']) == set(eval_e2e_bench.PARTS)
    assert all(v >= 0 for v in out['ms'].values())
    assert out['ms']['forward'] > 0 and out['ms']['sample'] > 0
