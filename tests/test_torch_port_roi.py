"""The roi key mode (MV2D-S) of the port against the JAX package on the
CPU, at the tiny config (float32, numpy-seeded weights carried by
`state_dict_from_jax`):

  * the eval forward of `tiny(key_mode='roi')`: valid slots and labels
    equal, scores within 1e-4, boxes within 2e-3 (the tolerances of
    `test_torch_port_slice.py`), and only `num_queries` in the
    diagnostics;
  * `roi_head_forward` on the same p4, PE and proposals without DN (each
    query's own keys) and with DN under the same noise (one shared key
    set): every layer's class logits and box codes within 1e-4 of their
    max magnitude;
  * one `tiny(key_mode='roi', use_denoise=True)` training step: every
    loss term within 1e-5 relative, every gradient within 1e-4 of its
    tensor's max magnitude (floored at 1e-5 of the step's largest
    gradient, as in `test_torch_port_train.py`);
  * `query_pixel_masks` equal; the key gather's backward equal to the
    index backward and bit-equal across runs;
  * `tools.train` for two steps (with `--auto-buckets`) then
    `tools.test` on the MV2D-S config file (one frame), on the tiny
    rendered fixture.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu.models import correlation as jcorr         # noqa: E402
from mv2d_tpu.models import mv2d as jmv2d                # noqa: E402
from mv2d_tpu_torch.models import correlation as tcorr   # noqa: E402
from mv2d_tpu_torch.models.detector2d import Proposals   # noqa: E402
from mv2d_tpu_torch.models.mv2d import gather_rows       # noqa: E402
from mv2d_tpu_torch.synthetic import synthetic_train_batch  # noqa: E402
from mv2d_tpu_torch.tools import test as ttest           # noqa: E402
from mv2d_tpu_torch.tools import train as ttrain         # noqa: E402
from mv2d_tpu_torch.tools.make_synth_fixture import make_fixture  # noqa
from tests.test_torch_port_slice import build            # noqa: E402
from tests.test_torch_port_train import train_step_pair  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROI_CFG = os.path.join(REPO, 'configs', 'mv2d',
                       'mv2d_r50_frcnn_single_frame_roi_1408x512_ep24.py')


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


@pytest.fixture(scope='module')
def built():
    torch.set_num_threads(1)
    return build(key_mode='roi', stage_with_dcn=(False,) * 4)


def test_roi_forward_matches_jax(built):
    b = built
    jout = jax.jit(b['jm'].apply)(b['variables'], jnp.asarray(b['imgs']),
                                  b['jcam'], jnp.asarray(b['shapes']))
    jboxes, jscores, jlabels, jvalid = (np.asarray(x) for x in jout)
    with torch.no_grad():
        t = b['tm'](torch.from_numpy(b['imgs']), b['tcam'],
                    torch.from_numpy(b['shapes']))
    assert np.array_equal(t.valid.numpy(), jvalid)
    assert jvalid.sum() > 0
    v = jvalid
    assert np.abs(t.scores.numpy()[v] - jscores[v]).max() < 1e-4
    assert np.array_equal(t.labels.numpy()[v], jlabels[v])
    assert np.abs(t.boxes.numpy()[v] - jboxes[v]).max() < 2e-3
    assert list(t.diagnostics) == ['num_queries']
    assert int(t.diagnostics['num_queries']) > 0


@pytest.fixture(scope='module')
def head_inputs(built):
    """p4, PE and proposals from the JAX model, in both packages' types,
    and a 3D GT set with DN noise."""
    b = built
    jc, jm, var = b['jc'], b['jm'], b['variables']
    imgs, shapes = jnp.asarray(b['imgs']), jnp.asarray(b['shapes'])

    def stem(m, x, cam, sh):
        fpn, p4 = m.extract_feats(x)
        props = m.base_detector.detect(fpn, jc.image_size, jc.proposal_test)
        return p4, m.pe(p4, cam.img2lidar, sh, jc.image_size), props
    p4, pos, props = jax.jit(lambda v, x, c, s: jm.apply(
        v, x, c, s, method=stem))(var, imgs, b['jcam'], shapes)
    tb = synthetic_train_batch(b['tc'], seed=4, device='cpu')
    gt = tb.gt3d
    noise = np.random.default_rng(5).uniform(
        -1, 1, (b['tc'].dn_pad, 3)).astype(np.float32)
    tprops = Proposals(*(torch.from_numpy(np.array(x)) for x in (
        props.boxes, props.scores, props.labels, props.valid)))
    jgt = jmv2d.GroundTruth3D(*(jnp.asarray(x.numpy()) for x in gt))
    return dict(p4=p4, pos=pos, props=props, tprops=tprops, gt=gt, jgt=jgt,
                noise=noise)


@pytest.mark.parametrize('dn', [False, True], ids=['roi', 'roi_dn'])
def test_roi_head_forward_matches_jax(built, head_inputs, dn):
    """Every decoder layer's outputs of the 3D head, without DN (keys
    [R, Cc*49, C], one set per query) and with DN (keys [R*49, C]
    shared, the DN rows first)."""
    b, h = built, head_inputs
    assert bool(h['tprops'].valid.any())
    jc = b['jc']._replace(use_denoise=dn)
    jm = jmv2d.MV2D(jc)
    orig = jmv2d.MV2D._prepare_dn

    def pinned_dn(self, gt, rng_):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, 'uniform',
                       lambda *a, **k: jnp.asarray(h['noise']))
            return orig(self, gt, rng_)

    def head(m, p4, pos, props, cam, shapes, gt):
        return m.roi_head_forward(p4, pos, props, cam, shapes, gt=gt,
                                  dn_rng=jax.random.PRNGKey(0) if dn
                                  else None, deterministic=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmv2d.MV2D, '_prepare_dn', pinned_dn)
        jout = jax.jit(lambda *a: jm.apply(*a, method=head))(
            b['variables'], h['p4'], h['pos'], h['props'], b['jcam'],
            jnp.asarray(b['shapes']), h['jgt'] if dn else None)
    tm = b['tm']
    tm.cfg = b['tc']._replace(use_denoise=dn)
    try:
        with torch.no_grad():
            tout = tm.roi_head_forward(
                torch.from_numpy(np.array(h['p4'])),
                torch.from_numpy(np.array(h['pos'])), h['tprops'],
                b['tcam'], torch.from_numpy(b['shapes']),
                gt=h['gt'] if dn else None,
                dn_noise=torch.from_numpy(h['noise']) if dn else None)
    finally:
        tm.cfg = b['tc']
    pairs = [(tout.all_cls_scores, jout.all_cls_scores),
             (tout.all_bbox_preds, jout.all_bbox_preds)]
    if dn:
        assert tout.dn_cls_scores.shape[1] == b['tc'].dn_pad
        pairs += [(tout.dn_cls_scores, jout.dn_cls_scores),
                  (tout.dn_bbox_preds, jout.dn_bbox_preds)]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape
        for lvl in range(want.shape[0]):
            assert rel_err(got[lvl].numpy(), want[lvl]) < 1e-4, lvl
    assert list(tout.diagnostics) == ['num_queries']


@pytest.fixture(scope='module')
def dn_step():
    return train_step_pair(key_mode='roi', use_denoise=True, dropout=0.0)


def test_roi_dn_train_step_matches_jax(dn_step):
    """Losses within 1e-5 relative, every trainable gradient within 1e-4
    of its max magnitude; the roi key mode logs no key-bucket metric."""
    p = dn_step
    want = {k: float(v) for k, v in p['jmetrics'].items()}
    got = {k: float(v) for k, v in p['metrics'].items()}
    assert sorted(got) == sorted(want)
    assert 'key_active' not in got and 'key_overflow' not in got
    loss_keys = [k for k in want if 'loss' in k]
    assert any('.dn_loss' in k for k in loss_keys)
    for k in loss_keys:
        assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-6), \
            (k, got[k], want[k])
    assert abs(p['total'] - p['jtotal']) <= 1e-5 * abs(p['jtotal'])
    for k in ('rpn_num_pos', 'rcnn_num_pos', 'num_queries'):
        assert got[k] == want[k], k
    floor = 1e-5 * max(np.abs(g).max() for g in p['jgrads'].values())
    n = 0
    for name, prm in p['model'].named_parameters():
        if not prm.requires_grad:
            assert prm.grad is None, name
            continue
        want_g = p['jgrads'][name]
        scale = max(np.abs(want_g).max(), floor)
        err = np.abs(prm.grad.numpy() - want_g).max()
        assert err <= 1e-4 * scale, (name, err, scale)
        n += 1
    assert n > 100


def test_query_pixel_masks_match_jax():
    rng = np.random.default_rng(2)
    V, P, hw = 3, 5, 24
    A = rng.random((V * P, V * P)) < 0.2
    in_roi = rng.random((V, P, hw)) < 0.3
    want = jcorr.query_pixel_masks(jnp.asarray(A), jnp.asarray(in_roi))
    got = tcorr.query_pixel_masks(torch.from_numpy(A),
                                  torch.from_numpy(in_roi))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def test_gather_rows_backward():
    """The correlated-RoI gather: forward is table[ids]; the backward (a
    one-hot matmul) equals the index backward, including a row gathered
    twice by one query, and is the same bits on a second run."""
    g = torch.Generator().manual_seed(0)
    table = torch.randn(9, 6, generator=g, requires_grad=True)
    ids = torch.randint(0, 9, (9, 3), generator=g)
    ids[:, 0] = torch.arange(9)
    ids[2, 1] = 2                                  # the RoI itself, again
    dout = torch.randn(9, 3, 6, generator=g)
    out = gather_rows(table, ids)
    assert torch.equal(out, table.detach()[ids])
    got, = torch.autograd.grad(out, table, dout)
    want, = torch.autograd.grad(table[ids], table, dout)
    assert torch.allclose(got, want, rtol=0, atol=1e-6)
    again, = torch.autograd.grad(gather_rows(table, ids), table, dout)
    assert torch.equal(got, again)


def test_roi_config_trains_and_tests(tmp_path):
    """`tools.train` takes two steps on the MV2D-S file (roi key mode,
    one frame from data.*.num_frames) and `tools.test` evaluates the
    checkpoint, both on the CPU."""
    torch.set_num_threads(2)
    fixture = make_fixture(str(tmp_path / 'fx'), scenes=2, val_scenes=1,
                           objects=6, image_h=90, image_w=160, seed=3,
                           epochs=1, eval_interval=0)
    opts = ["model.preset='tiny'",
            "model.overrides=dict(num_views=6, num_frames=1, "
            "key_mode='roi', use_denoise=True)",
            'data.train.final_dim=(64, 96)', 'data.val.final_dim=(64, 96)',
            'log_interval=1', 'total_epochs=1', 'evaluation=dict()']
    for split in ('train', 'val'):
        opts += [f"data.{split}.info_path={fixture[split + '_info']!r}",
                 f"data.{split}.ann2d_path={fixture[split + '_coco']!r}",
                 f"data.{split}.data_root=''"]
    work = str(tmp_path / 'work')
    res = ttrain.main([ROI_CFG, '--work-dir', work, '--device', 'cpu',
                       '--max-steps', '2', '--auto-buckets', '2',
                       '--cfg-options', *opts])
    mc = res['model_cfg']
    assert res['step'] == 2 and mc.key_mode == 'roi'
    assert mc.num_frames == 1 and mc.use_denoise
    # calibration raised the GT buckets (6 objects a scene > tiny's 4)
    assert mc.max_gt == 8
    steps = [r for r in res['log'] if 'step' in r]
    assert len(steps) == 2 and 'key_active' not in steps[0]
    assert all(np.isfinite(v) for r in steps for v in r.values())
    metrics = ttest.main([ROI_CFG, os.path.join(work, 'epoch_1.pth'),
                          '--device', 'cpu', '--cfg-options', *opts])
    assert np.isfinite(metrics['mAP']) and np.isfinite(metrics['NDS'])
