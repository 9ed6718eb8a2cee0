"""The single-stage (RetinaNet) detector of the port against the JAX
package on the CPU, float32, numpy-seeded inputs and weights:

  * `RetinaHead` on random FPN levels (the JAX head's leaves carried by
    `state_dict_from_jax` onto mmdet RetinaHead's names): logits and
    deltas within 1e-4 of their max magnitude;
  * `single_stage_detections` on those outputs: valid slots and labels
    equal, scores within 1e-4 and boxes within 1e-3 pixels on valid slots;
  * `single_stage_loss` on random outputs and GT: losses within 1e-4
    relative, the positive count equal;
  * the eval forward of `tiny(detector_type='single_stage')` (the
    tolerances of `test_torch_port_slice.py`);
  * one training step of it: every loss term within 1e-4 relative, the
    positive anchors equal, every gradient within 1e-3 of its tensor's
    max magnitude (the tolerances of `test_torch_port_train.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu.nn import retina as jretina                # noqa: E402
from mv2d_tpu.train import detector2d_loss as jd2l       # noqa: E402
from mv2d_tpu_torch.nn import retina as tretina          # noqa: E402
from mv2d_tpu_torch.train import detector2d_loss as td2l  # noqa: E402
from mv2d_tpu_torch.train.train_step import all_anchors  # noqa: E402
from mv2d_tpu_torch import configs as tcfgs              # noqa: E402
from mv2d_tpu_torch.weights import state_dict_from_jax   # noqa: E402
from tests.test_torch_port_slice import build, materialize  # noqa: E402
from tests.test_torch_port_train import train_step_pair  # noqa: E402

STRIDES = (4, 8, 16, 32, 64)
IMG = (64, 96)


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


@pytest.fixture(scope='module')
def head_pair():
    """A JAX RetinaHead and the port's with its weights, and their
    outputs on random levels of a 64x96 image."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    C, K = 16, 10
    feats = [rng.normal(size=(2, -(-IMG[0] // s), -(-IMG[1] // s), C))
             .astype(np.float32) for s in STRIDES]
    jh = jretina.RetinaHead(num_classes=K, feat_channels=C)
    jf = [jnp.asarray(f) for f in feats]
    var = materialize(jax.eval_shape(jh.init, jax.random.PRNGKey(0), jf), 1)
    jout = jh.apply(var, jf)
    sd = state_dict_from_jax({'base_detector': {'retina_head':
                                                var['params']}}, {})
    th = tretina.RetinaHead(K, C)
    prefix = 'base_detector.bbox_head.'
    assert all(k.startswith(prefix) for k in sd)
    th.load_state_dict({k[len(prefix):]: torch.from_numpy(v)
                        for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        tout = th([torch.from_numpy(f) for f in feats])
    return dict(jout=jout, tout=tout, K=K)


def test_retina_head_matches_jax(head_pair):
    (js, jd), (ts, td) = head_pair['jout'], head_pair['tout']
    for a, b in zip(js + jd, ts + td):
        assert rel_err(b.numpy(), a) < 1e-4
    assert ts[0].shape[-1] == 9 * head_pair['K'] and td[0].shape[-1] == 36


def test_single_stage_detections_match_jax(head_pair):
    (js, jd), (ts, td) = head_pair['jout'], head_pair['tout']
    kw = dict(score_thr=0.05, nms_pre=40, iou_threshold=0.6,
              max_per_img=12, min_bbox_size=2.0)
    want = [np.asarray(x) for x in jax.jit(
        lambda s, d: jretina.single_stage_detections(
            s, d, STRIDES, IMG, head_pair['K'], **kw))(js, jd)]
    got = [x.numpy() for x in tretina.single_stage_detections(
        ts, td, STRIDES, IMG, head_pair['K'], **kw)]
    v = want[3]
    assert np.array_equal(got[3], v) and v.sum() > 0
    assert np.array_equal(got[2][v], want[2][v])
    assert np.abs(got[1][v] - want[1][v]).max() < 1e-4
    assert np.abs(got[0][v] - want[0][v]).max() < 1e-3


def test_single_stage_loss_matches_jax():
    rng = np.random.default_rng(1)
    cfg = tcfgs.tiny(detector_type='single_stage')
    anchors = all_anchors(cfg).numpy()
    N, K, G = anchors.shape[0], 10, 6
    scores = rng.normal(-2, 1, (N, K)).astype(np.float32)
    deltas = rng.normal(0, 0.2, (N, 4)).astype(np.float32)
    xy = rng.uniform(0, 60, (G, 2))
    gt = np.concatenate([xy, xy + rng.uniform(8, 40, (G, 2))],
                        1).astype(np.float32)
    labels = rng.integers(0, K, G)
    valid = np.arange(G) < 4
    want = jax.jit(jd2l.single_stage_loss, static_argnums=6)(
        jnp.asarray(scores), jnp.asarray(deltas), jnp.asarray(anchors),
        jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(valid), K)
    got = td2l.single_stage_loss(*(torch.from_numpy(a) for a in (
        scores, deltas, anchors, gt, labels, valid)), K)
    for k in ('loss_cls', 'loss_bbox'):
        assert rel_err(got[k].numpy(), want[k]) < 1e-4, k
    assert int(got['num_pos']) == int(want['num_pos']) > 0


def test_single_stage_forward_matches_jax():
    torch.set_num_threads(1)
    b = build(detector_type='single_stage', stage_with_dcn=(False,) * 4)
    jout = jax.jit(b['jm'].apply)(b['variables'], jnp.asarray(b['imgs']),
                                  b['jcam'], jnp.asarray(b['shapes']))
    jboxes, jscores, jlabels, jvalid = (np.asarray(x) for x in jout)
    with torch.no_grad():
        t = b['tm'](torch.from_numpy(b['imgs']), b['tcam'],
                    torch.from_numpy(b['shapes']))
    assert not any('rpn_head' in k or 'roi_head.bbox_head.shared' in k
                   for k in b['sd'])
    assert np.array_equal(t.valid.numpy(), jvalid) and jvalid.sum() > 0
    v = jvalid
    assert np.abs(t.scores.numpy()[v] - jscores[v]).max() < 1e-4
    assert np.array_equal(t.labels.numpy()[v], jlabels[v])
    assert np.abs(t.boxes.numpy()[v] - jboxes[v]).max() < 2e-3


def test_single_stage_train_step_matches_jax():
    """Weights of seed 1: under seed 0 one pre-activation of the cls
    tower on p2 lies 1.2e-6 from zero, and float32 rounding puts it on
    the other side of its ReLU in the port than in JAX (and in the port
    in float64), which moves the gradients below it by ~1e-3 of their
    max; the function itself is the same."""
    p = train_step_pair(weights_seed=1, detector_type='single_stage',
                        dropout=0.0)
    want = {k: float(v) for k, v in p['jmetrics'].items()}
    got = {k: float(v) for k, v in p['metrics'].items()}
    assert sorted(got) == sorted(want)
    assert 'det_num_pos' in got and 'rpn_num_pos' not in got
    for k in want:
        if 'loss' in k:
            assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-6), \
                (k, got[k], want[k])
        else:
            assert got[k] == want[k], k
    assert got['det_num_pos'] > 0
    floor = 1e-5 * max(np.abs(g).max() for g in p['jgrads'].values())
    n = 0
    for name, prm in p['model'].named_parameters():
        if not prm.requires_grad:
            assert prm.grad is None, name
            continue
        w = p['jgrads'][name]
        err = np.abs(prm.grad.numpy() - w).max()
        assert err <= 1e-3 * max(np.abs(w).max(), floor), (name, err)
        n += 1
    assert n > 100
