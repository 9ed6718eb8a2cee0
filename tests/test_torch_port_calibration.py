"""The port's bucket calibration (`mv2d_tpu_torch/data/calibration.py`,
`tools/calibrate_buckets.py`) against the JAX package's, on one rendered
fixture (`tools.make_synth_fixture`, 3 train scenes at 90x160, 14
objects a scene), each package reading it through its own
`build_dataset`: the scan's statistics, the recommendation and what
`apply_to_config` raises are equal; the scan sees the objects that the
dataset's buckets would cut and leaves the buckets as they were; the
port's CLI prints the lines that `tests/test_cli.py` checks of the
repository's tool.
"""
import copy
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip('torch')

from mv2d_tpu.data import calibration as jcal            # noqa: E402
from mv2d_tpu_torch.data import calibration as tcal      # noqa: E402
from mv2d_tpu_torch.tools import common                  # noqa: E402
from mv2d_tpu_torch.tools.make_synth_fixture import make_fixture  # noqa
from tests.test_torch_port_data import jax_pool_ready    # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTIONS = ["model.preset='tiny'",
           'model.overrides=dict(num_views=6, num_frames=2)',
           'data.train.final_dim=(64, 96)', 'data.val.final_dim=(64, 96)']


@pytest.fixture(scope='module')
def fixture_cfg(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('calib_fixture'))
    paths = make_fixture(out, scenes=3, val_scenes=1, objects=14,
                         image_h=90, image_w=160, seed=1)
    return paths['config']


def jax_common():
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    try:
        import common as jcommon
    finally:
        sys.path.remove(os.path.join(REPO, 'tools'))
    return jcommon


@pytest.mark.parametrize('samples,percentile', [(3, 100.0), (2, 50.0)])
def test_calibration_matches_jax(fixture_cfg, samples, percentile):
    jax_pool_ready()
    jcommon = jax_common()
    cfg = common.load_cli_config(fixture_cfg, OPTIONS)
    tm, jm = common.build_model_config(cfg), jcommon.build_model_config(cfg)
    tds, jds = common.build_dataset(cfg, 'train'), \
        jcommon.build_dataset(cfg, 'train')
    buckets = tds.buckets
    trec, tstats = tcal.calibrate(tds, tm, samples=samples,
                                  percentile=percentile)
    jrec, jstats = jcal.calibrate(jds, jm, samples=samples,
                                  percentile=percentile)
    assert tds.buckets is buckets
    assert tstats == jstats
    assert trec == jrec
    # the dataset's buckets (max_gt 4) would cut the 14 objects: the scan
    # counts them all, and the recommendation covers them
    assert max(tstats['gt3d_counts']) > tm.max_gt
    assert trec['max_gt'] >= max(tstats['gt3d_counts'])
    assert trec['k_max'] > tm.k_max
    assert tcal.recommend_buckets(tstats, tm, margin=1.5) == \
        jcal.recommend_buckets(jstats, jm, margin=1.5)
    tcfg, jcfg = copy.deepcopy(cfg), copy.deepcopy(cfg)
    assert tcal.apply_to_config(tcfg, trec, tm) == \
        jcal.apply_to_config(jcfg, jrec, jm)
    assert tcfg == jcfg
    assert tcfg['model']['overrides']['k_max'] == trec['k_max']


def test_apply_to_config_never_shrinks():
    from mv2d_tpu_torch import configs
    mcfg = configs.tiny()
    rec = dict(max_gt=16, max_gt2d=8, k_max=1024)     # tiny: 4, 64, 64
    cfg = dict(model=dict(overrides=dict(k_max=4096)))
    jc = copy.deepcopy(cfg)
    applied = tcal.apply_to_config(cfg, rec, mcfg)
    assert applied == dict(max_gt=16) == jcal.apply_to_config(jc, rec, mcfg)
    assert cfg['model']['overrides'] == dict(k_max=4096, max_gt=16)
    assert tcal.apply_to_config(cfg, rec, mcfg) == {}


def test_calibrate_buckets_cli(fixture_cfg):
    r = subprocess.run(
        [sys.executable, '-m', 'mv2d_tpu_torch.tools.calibrate_buckets',
         fixture_cfg, '--samples', '2', '--cfg-options', *OPTIONS],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert 'model.overrides.k_max=' in r.stdout
    assert 'model.overrides.max_gt=' in r.stdout
    assert 'key-pixel union' in r.stdout
    assert 'scanned 2 samples of 3 (train)' in r.stdout
    assert 'WARNING: current max_gt=4' in r.stdout
