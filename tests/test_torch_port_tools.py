"""The port's remaining user tools on the CPU, at the tiny config:

  * `tools.get_flops`: each `mv2d` operator's flop formula against a hand
    count at its test shape (`chip_smoke.op_args`), the count
    raising on an operator without a formula, and the CLI's report;
  * `tools.benchmark` with `--device cpu`;
  * `tools.misc`: `publish` round-trips a training checkpoint without its
    optimizer state; `fuse_conv_bn`'s file loads with strict=True and
    gives the unfused forward's outputs within 1e-5 (ResNet with DCN; the
    VoVNet key pairs fold too); `update_data_coords` writes what the JAX
    tool (`tools/misc.py`) writes from the same pkl; `print_config` and
    `browse` print;
  * `tools.visualize --synthetic` writes a PNG;
  * `utils.profiling`: `trace` writes a trace holding `annotate`'s range.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from mv2d_tpu_torch import configs                      # noqa: E402
from mv2d_tpu_torch.models.mv2d import MV2D             # noqa: E402
from mv2d_tpu_torch.nn.layers import FrozenBatchNorm2d  # noqa: E402
from mv2d_tpu_torch.synthetic import init_random_weights  # noqa: E402
from mv2d_tpu_torch.tools import (benchmark, common, get_flops,  # noqa: E402
                                  misc, visualize)
from mv2d_tpu_torch.tools.export import rig_camera     # noqa: E402
from mv2d_tpu_torch.train import checkpoint             # noqa: E402
from mv2d_tpu_torch.train.optim import make_optimizer   # noqa: E402
from mv2d_tpu_torch.utils import profiling              # noqa: E402
import chip_smoke as smoke                              # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R50_FILE = os.path.join(REPO, 'configs', 'mv2d',
                        'mv2d_r50_frcnn_two_frames_1408x512_ep24.py')
DCN = (False, False, True, True)
TINY = ["model.preset='tiny'", f'model.overrides=dict(stage_with_dcn={DCN})']

# flops by hand at chip_smoke.op_args' shapes
HAND = {
    # x [1, 8, 16, 64], 64 planes, the projection: 2 * 128 pixels *
    # (64*64 + 9*64*64 + 64*256 + 64*256) MACs
    'bottleneck': 2 * 128 * (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256),
    # x [1, 8, 16, 512], 128 planes: 2 * 128 * (512*128 + 9*128*128 +
    # 128*512)
    'identity_block': 2 * 128 * (512 * 128 + 9 * 128 * 128 + 128 * 512),
    # 1152 samples (1 x 8 x 16 x 9) of 64 channels into 64: the product
    # and 9 interpolation FLOPs a sample and channel
    'dcn_conv': 2 * 1152 * 64 * 64 + 9 * 1152 * 64,
    'dcn_samples': 9 * 1152 * 64,
    'dcn_samples_bwd': 16 * 1152 * 64,
    'dcn_conv_bwd': 2 * (2 * 1152 * 64 * 64) + 9 * 1152 * 64
    + 16 * 1152 * 64,
    # 8 RoIs x 49 bins x 2 x 2 samples x 4 corners x 2 x 64 channels
    'roi_align': 8 * 49 * 4 * 4 * 2 * 64,
    'roi_align_slab': 8 * 49 * 4 * 4 * 2 * 64,
    'roi_align_flat': 8 * 49 * 4 * 4 * 2 * 64,
    'roi_align_bwd': 8 * 49 * 4 * 4 * 2 * 64,
    'mask_bits': 0,
    # Q 128, K 256, C 256: dense 4 Q K C forward, 10 Q K C backward
    'masked_attention': 4 * 128 * 256 * 256,
    'masked_attention_bwd': 10 * 128 * 256 * 256,
}


@pytest.fixture(scope='module')
def op_args():
    return smoke.op_args('cpu', torch.float32)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize('name', sorted(HAND))
def test_flop_formula_matches_hand_count(name, op_args):
    args = op_args[name]
    op = getattr(torch.ops.mv2d, name)
    flops, nbytes, ops = get_flops.count(lambda: op(*args))
    assert flops == HAND[name]
    assert ops == [f'mv2d.{name}'] and nbytes > 0


def test_count_raises_without_formula(monkeypatch, op_args):
    from torch.utils.flop_counter import flop_registry
    monkeypatch.delitem(flop_registry, torch.ops.mv2d.dcn_conv)
    args = op_args['dcn_conv']
    with pytest.raises(RuntimeError, match='no flop formula'):
        get_flops.count(lambda: torch.ops.mv2d.dcn_conv(*args))


def test_get_flops_cli(capsys):
    r = get_flops.main([R50_FILE, '--device', 'cpu', '--cfg-options',
                        *TINY])
    text = capsys.readouterr().out
    model = MV2D(configs.tiny(stage_with_dcn=DCN))
    assert r['params'] == sum(p.numel() for p in model.parameters())
    assert r['ops'] == ['mv2d.bottleneck', 'mv2d.dcn_conv', 'mv2d.mask_bits',
                        'mv2d.masked_attention', 'mv2d.nms_keep',
                        'mv2d.roi_align']
    assert r['flops'] > 1e8 and r['bytes'] > 1e6
    assert 'GFLOPs' in text and 'unfused upper bound' in text


def test_benchmark_cli(capsys):
    r = benchmark.main([R50_FILE, '--device', 'cpu', '--warmup', '1',
                        '--iters', '2', '--batch', '2', '--cfg-options',
                        "model.preset='tiny'"])
    assert r['samples_per_s'] > 0
    assert 'batch 2, f32, cpu' in capsys.readouterr().out


# ---------------------------------------------------------------- misc

def scene(mc):
    V, (H, W) = mc.total_views, mc.image_size
    imgs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(V, H, W, 3)).astype(np.float32))
    return imgs, rig_camera(mc, 'cpu'), torch.tensor([[H, W]] * V)


def random_bn(model, seed=0):
    """Frozen BN statistics and affines away from the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm2d):
                n = m.weight.shape[0]
                m.weight.copy_(0.5 + torch.rand(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return model


def test_fuse_conv_bn_loads_and_matches(tmp_path):
    cfg = configs.tiny(stage_with_dcn=DCN)
    model = random_bn(init_random_weights(MV2D(cfg), seed=0)).eval()
    src, dst = str(tmp_path / 'epoch_1.pth'), str(tmp_path / 'fused.pth')
    checkpoint.save_checkpoint(src, model, make_optimizer(model),
                               meta=dict(epoch=1))
    misc.main(['fuse_conv_bn', src, dst])
    fused = common.load_weights(MV2D(cfg), dst).eval()    # strict=True
    sd = fused.state_dict()
    bns = [k[:-len('.running_var')] for k in sd if k.endswith('running_var')]
    assert len(bns) == 1 + 4 * 3 + 4          # stem, 4 blocks, 4 projections
    for bn in bns:
        assert torch.equal(sd[f'{bn}.running_var'], torch.ones_like(
            sd[f'{bn}.running_var']))
    with torch.no_grad():
        want = model(*scene(cfg))
        got = fused(*scene(cfg))
    assert torch.equal(got.valid, want.valid) and want.valid.sum() > 0
    v = want.valid
    assert torch.equal(got.labels[v], want.labels[v])
    assert (got.scores[v] - want.scores[v]).abs().max() <= 1e-5
    assert (got.boxes[v] - want.boxes[v]).abs().max() <= 1e-5 * max(
        1.0, float(want.boxes[v].abs().max()))


def test_fold_conv_bn_pairs_vovnet_keys():
    model = MV2D(configs.tiny(backbone_type='vovnet', depth=19))
    sd = {k: v.clone() for k, v in random_bn(model).state_dict().items()}
    n_bn = sum(k.endswith('running_var') for k in sd)
    conv = next(k for k in sd if k.endswith('/conv.weight'))
    bn = conv[:-len('conv.weight')] + 'norm'
    s = sd[f'{bn}.weight'] / torch.sqrt(sd[f'{bn}.running_var'] + 1e-5)
    want = sd[conv] * s[:, None, None, None]
    assert misc.fold_conv_bn(sd) == n_bn > 0
    assert torch.equal(sd[conv], want)


def test_publish_round_trips(tmp_path):
    model = init_random_weights(MV2D(configs.tiny()), seed=3)
    src, dst = str(tmp_path / 'epoch_2.pth'), str(tmp_path / 'pub.pth')
    checkpoint.save_checkpoint(src, model, make_optimizer(model),
                               meta=dict(epoch=2, iter=8))
    misc.main(['publish', src, dst])
    pub = torch.load(dst, weights_only=True)
    assert set(pub) == {'meta', 'state_dict'} and pub['meta']['iter'] == 8
    back = common.load_weights(MV2D(configs.tiny()), dst)   # strict=True
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def old_infos(path):
    rng = np.random.default_rng(0)
    infos = [dict(token=f't{i}', gt_boxes=rng.normal(size=(n, 7)),
                  gt_names=np.array(['car'] * n))
             for i, n in enumerate((3, 0, 5))]
    with open(path, 'wb') as f:
        pickle.dump(dict(infos=infos, metadata=dict(version='v1.0-mini')), f)


def test_update_data_coords_matches_jax_tool(tmp_path):
    src = str(tmp_path / 'old.pkl')
    old_infos(src)
    port, jax_out = str(tmp_path / 'port.pkl'), str(tmp_path / 'jax.pkl')
    misc.main(['update_data_coords', src, port])
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, os.path.join(REPO, 'tools', 'misc.py'),
                        'update_data_coords', src, jax_out], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(port, 'rb') as f:
        got = pickle.load(f)
    with open(jax_out, 'rb') as f:
        want = pickle.load(f)
    assert got['metadata'] == want['metadata'] == dict(
        version='v1.0-mini', coord_version='1.0')
    for g, w in zip(got['infos'], want['infos']):
        assert set(g) == set(w)
        assert np.array_equal(g['gt_boxes'], w['gt_boxes'])
    # a converted file passes through
    again = str(tmp_path / 'again.pkl')
    misc.main(['update_data_coords', port, again])
    with open(again, 'rb') as f:
        assert np.array_equal(pickle.load(f)['infos'][0]['gt_boxes'],
                              got['infos'][0]['gt_boxes'])


def test_print_config_and_browse(tmp_path, capsys):
    from mv2d_tpu_torch.tools.make_synth_fixture import make_fixture
    misc.main(['print_config', R50_FILE, '--cfg-options',
               "model.preset='tiny'"])
    cfg = json.loads(capsys.readouterr().out)
    assert cfg['model']['preset'] == 'tiny'
    paths = make_fixture(str(tmp_path), scenes=0, val_scenes=1, image_h=90,
                         image_w=160)
    misc.main(['browse', paths['config'], '--val', '--cfg-options',
               'data.val.final_dim=(64, 96)'])
    text = capsys.readouterr().out
    assert 'imgs' in text and '(12, 64, 96, 3)' in text


# ------------------------------------------------- visualize, profiling

def test_visualize_synthetic_writes_png(tmp_path, capsys):
    import cv2
    out = str(tmp_path / 'vis.png')
    r = visualize.main(['--synthetic', '--cameras', '--device', 'cpu',
                        '--out', out, '--score-thr', '0.0'])
    img = cv2.imread(out)
    assert img is not None and img.shape == (visualize.BEV_SIDE, 2600, 3)
    assert r['gts'] > 0 and r['preds'] > 0
    assert 'wrote' in capsys.readouterr().out
    # GT in green and predictions in red are drawn in the BEV panel
    bev = img[:, -visualize.BEV_SIDE:]
    assert (bev == visualize.GT_BGR).all(-1).any()
    assert (bev == visualize.PRED_BGR).all(-1).any()


def test_profiling_trace_and_throughput(tmp_path):
    cfg = configs.tiny()
    model = init_random_weights(MV2D(cfg), seed=0).eval()
    with torch.no_grad(), profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate('forward'):
            model(*scene(cfg))
    path = tmp_path / profiling.TRACE_FILE
    with open(path) as f:
        events = json.load(f)['traceEvents']
    names = {e.get('name') for e in events}
    assert 'forward' in names and 'mv2d::bottleneck' in names
    assert any(e.key == 'mv2d::roi_align' for e in prof.key_averages())
