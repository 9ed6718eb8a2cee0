"""The port's training CLI (`mv2d_tpu_torch/tools/train.py`) with
`--device cpu`, on a rendered fixture (`tools.make_synth_fixture`: 2
train and 2 val scenes at 90x160) and the tiny preset on its six cameras,
one frame, float32:

  * two epochs with the eval hook after each write `config.json`,
    `epoch_{1,2}.pth` and `train_log.jsonl`, whose step lines carry every
    key of the JAX CLI's soak log (`docs/soak/train_log_r5.jsonl`) and
    the scheduled lr;
  * the hook's `val_*` line equals `tools.test` run on the checkpoint;
  * a run cut by `--max-steps` after epoch 1, or inside epoch 2, and
    resumed with `--auto-resume` ends equal bit for bit to the
    uninterrupted run: parameters, AdamW state and epoch 2's log lines
    (but `sps`);
  * each epoch's order and samples equal the JAX CLI's: its permutations
    of default_rng(seed) and its `Prefetcher`'s samples by position;
  * `--auto-buckets` raises max_gt / k_max before the model is built;
  * `analyze_logs` reads the log; without CUDA the default device raises.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from mv2d_tpu.data import nuscenes as jnusc              # noqa: E402
from mv2d_tpu_torch.tools import analyze_logs             # noqa: E402
from mv2d_tpu_torch.tools import common                  # noqa: E402
from mv2d_tpu_torch.tools import test as ttest           # noqa: E402
from mv2d_tpu_torch.tools import train as ttrain         # noqa: E402
from mv2d_tpu_torch.tools.make_synth_fixture import make_fixture  # noqa
from mv2d_tpu_torch.train.optim import cosine_schedule   # noqa: E402
from tests.test_torch_port_calibration import jax_common  # noqa: E402
from tests.test_torch_port_checkpoint import assert_tree_equal  # noqa: E402
from tests.test_torch_port_data import (assert_deep_equal,  # noqa: E402
                                        jax_pool_ready)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTIONS = ["model.preset='tiny'",
           'model.overrides=dict(num_views=6, num_frames=1)',
           'data.train.final_dim=(64, 96)', 'data.val.final_dim=(64, 96)',
           'data.train.num_frames=1', 'data.val.num_frames=1',
           'log_interval=1']
SOAK_LOG = os.path.join(REPO, 'docs', 'soak', 'train_log_r5.jsonl')


@pytest.fixture(scope='module')
def fixture_cfg(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('train_cli_fixture'))
    return make_fixture(out, scenes=2, val_scenes=2, objects=6, image_h=90,
                        image_w=160, seed=2, epochs=2,
                        eval_interval=1)['config']


def run(cfg, work, *extra, options=()):
    torch.set_num_threads(2)
    return ttrain.main([cfg, '--work-dir', work, '--device', 'cpu',
                        *extra, '--cfg-options', *OPTIONS, *options])


def read_log(work):
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope='module')
def runs(fixture_cfg, tmp_path_factory):
    """The uninterrupted two-epoch run, one cut after epoch 1 and one cut
    inside epoch 2 (after step 3 of 4), each then resumed."""
    full = str(tmp_path_factory.mktemp('full'))
    cut = str(tmp_path_factory.mktemp('cut'))
    mid = str(tmp_path_factory.mktemp('mid'))
    res_full = run(fixture_cfg, full)
    res_cut = run(fixture_cfg, cut, '--max-steps', '2')
    res_resumed = run(fixture_cfg, cut, '--auto-resume')
    res_mid = run(fixture_cfg, mid, '--max-steps', '3')
    res_mid_resumed = run(fixture_cfg, mid, '--auto-resume')
    return dict(full=full, cut=cut, res_full=res_full, res_cut=res_cut,
                res_resumed=res_resumed, mid=mid, res_mid=res_mid,
                res_mid_resumed=res_mid_resumed)


def test_train_cli_writes_checkpoints_logs_and_eval(runs):
    full = runs['full']
    assert sorted(os.listdir(full)) == ['config.json', 'epoch_1.pth',
                                        'epoch_2.pth', 'train_log.jsonl']
    with open(os.path.join(full, 'config.json')) as f:
        assert "'preset': 'tiny'" in json.load(f)['model']
    log = read_log(full)
    assert log == runs['res_full']['log']
    steps = [r for r in log if 'step' in r]
    vals = [r for r in log if 'val_mAP' in r]
    assert [r['step'] for r in steps] == [1, 2, 3, 4]
    assert [r['epoch'] for r in steps] == [0, 0, 1, 1]
    assert [r['epoch'] for r in vals] == [1, 2]
    with open(SOAK_LOG) as f:           # its decoder has 6 layers, tiny 2
        jax_keys = {k for k in json.loads(f.readline())
                    if not k[:1] == 'l' or int(k[1]) < 2}
    assert len(jax_keys) == 13 + 4 * 2
    for r in steps:
        assert jax_keys <= set(r), jax_keys - set(r)
        assert all(np.isfinite(v) for v in r.values())
        # 2 epochs x 2 steps; lr 2e-4 from configs/_base_/schedule.py
        assert r['lr'] == cosine_schedule(r['step'] - 1, 2e-4, 4)
    assert {'val_mAP', 'val_NDS', 'val_mtrans_err'} <= set(vals[0])
    meta = torch.load(os.path.join(full, 'epoch_2.pth'),
                      weights_only=True)['meta']
    assert (meta['epoch'], meta['iter'], meta['seed'],
            meta['world_size']) == (2, 4, 0, 1)
    assert "'preset': 'tiny'" in meta['config']


def test_eval_hook_equals_test_cli(runs, fixture_cfg):
    full = runs['full']
    metrics = ttest.main([fixture_cfg, os.path.join(full, 'epoch_2.pth'),
                          '--device', 'cpu', '--cfg-options', *OPTIONS])
    hook = [r for r in read_log(full) if 'val_mAP' in r][-1]
    assert ttrain.val_line(metrics, 2) == hook


def test_resumed_run_equals_uninterrupted(runs):
    cut, full = runs['cut'], runs['full']
    assert runs['res_cut']['step'] == 2 and runs['res_resumed']['step'] == 4
    assert runs['res_resumed']['resumed_from'] == \
        os.path.join(cut, 'epoch_1.pth')
    a = torch.load(os.path.join(full, 'epoch_2.pth'), weights_only=True)
    b = torch.load(os.path.join(cut, 'epoch_2.pth'), weights_only=True)
    assert_tree_equal(b['state_dict'], a['state_dict'])
    assert_tree_equal(b['optimizer'], a['optimizer'])
    assert a['meta'] == b['meta']

    def epoch2(log):            # its steps' epoch is 1, its val line's 2
        return [{k: v for k, v in r.items() if k != 'sps'} for r in log
                if r['epoch'] == (1 if 'step' in r else 2)]
    want = epoch2(read_log(full))
    assert len(want) == 3 and epoch2(runs['res_resumed']['log']) == want
    assert epoch2(read_log(cut)) == want


def test_mid_epoch_resume_equals_uninterrupted(runs):
    """A checkpoint of a run cut inside an epoch holds its step; the
    resumed run trains on the rest of that epoch's order and no more, and
    ends equal bit for bit to the uninterrupted run."""
    mid, full = runs['mid'], runs['full']
    assert runs['res_mid']['step'] == 3
    assert runs['res_mid_resumed']['step'] == 4
    assert runs['res_mid_resumed']['resumed_from'] == \
        os.path.join(mid, 'epoch_2.pth')
    a = torch.load(os.path.join(full, 'epoch_2.pth'), weights_only=True)
    b = torch.load(os.path.join(mid, 'epoch_2.pth'), weights_only=True)
    assert_tree_equal(b['state_dict'], a['state_dict'])
    assert_tree_equal(b['optimizer'], a['optimizer'])
    assert a['meta'] == b['meta']

    def drop_sps(log):
        return [{k: v for k, v in r.items() if k != 'sps'} for r in log]
    want = drop_sps(read_log(full))
    resumed = drop_sps(runs['res_mid_resumed']['log'])
    assert [r.get('step') for r in resumed] == [4, None]
    assert resumed == want[-2:]
    assert drop_sps(runs['res_mid']['log'])[:4] == want[:4]


def test_order_and_samples_equal_jax_cli(fixture_cfg):
    jax_pool_ready()
    cfg = common.load_cli_config(fixture_cfg, OPTIONS)
    tds = common.build_dataset(cfg, 'train')
    jds = jax_common().build_dataset(cfg, 'train')
    seed, n = 3, len(tds)
    rng = np.random.default_rng(seed)       # the JAX CLI's draws
    for epoch in range(3):
        order = rng.permutation(n)
        got = ttrain.epoch_order(seed, epoch, n)
        assert np.array_equal(got, order)
        pf = jnusc.Prefetcher(jds, order.tolist(), seed=seed + epoch)
        want = dict(pf)
        pf.close()
        seen = list(ttrain.ordered_samples(tds, order.tolist(),
                                           seed + epoch))
        assert [i for i, _ in seen] == order.tolist()
        for idx, s in seen:
            assert_deep_equal(s, want[idx], atol=1e-12)
    # a rank's share of an epoch: order[rank::world], cut to len // world
    order = np.arange(7)
    assert [ttrain.rank_order(order, r, 2, 3) for r in (0, 1)] == \
        [[0, 2, 4], [1, 3, 5]]


def test_auto_buckets_raise_before_model(fixture_cfg, tmp_path, capsys):
    from mv2d_tpu_torch.data.calibration import calibrate
    cfg = common.load_cli_config(fixture_cfg, OPTIONS)
    mc0 = common.build_model_config(cfg)
    rec, _ = calibrate(common.build_dataset(cfg, 'train'), mc0, samples=2)
    assert rec['max_gt'] > mc0.max_gt and rec['k_max'] > mc0.k_max
    res = run(fixture_cfg, str(tmp_path), '--auto-buckets', '2',
              '--max-steps', '1', options=['evaluation=dict(interval=0)'])
    assert 'auto-buckets: scanned 2 samples' in capsys.readouterr().out
    mc = res['model_cfg']
    assert (mc.max_gt, mc.k_max, mc.max_gt2d) == \
        (rec['max_gt'], rec['k_max'], max(rec['max_gt2d'], mc0.max_gt2d))
    assert res['step'] == 1 and res['log'][0]['key_overflow'] == 0


def test_analyze_logs_and_device_default(runs, tmp_path, capsys):
    log = os.path.join(runs['full'], 'train_log.jsonl')
    analyze_logs.main(['cal_train_time', log])
    assert 'mean throughput:' in capsys.readouterr().out
    try:
        import matplotlib       # noqa: F401
    except ImportError:
        with pytest.raises(SystemExit, match='matplotlib'):
            analyze_logs.main(['plot_curve', log])
    else:
        out = str(tmp_path / 'c.png')
        analyze_logs.main(['plot_curve', log, '--out', out])
        assert os.path.getsize(out) > 0
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match='no CUDA device'):
            ttrain.main([os.path.join(runs['full'], 'x.py')])
