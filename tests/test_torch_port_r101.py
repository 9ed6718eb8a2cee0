"""MV2D-T at depth 101 with every p4 pixel a key, the setting of the
benchmark's `t_r101.eval` cell, against the JAX package on the CPU,
stage by stage.  The tiny preset (2 cameras x 2 frames at 64x96) takes
ResNet-101's blocks (3-4-23-3, DCNv2 in stages 3-4) and k_max = V * h *
w = 96; one set of numpy-seeded weights drives both models through
`state_dict_from_jax` (float32; the JAX side runs its XLA paths).  Each
stage of the port runs on the JAX side's inputs to it, so a wrong stage
fails its own case:
  * feats: FPN p2..p6 and the neck's p4 within 1e-4 of their max
    magnitude (`test_torch_port_modules.py`'s tolerance);
  * det2d: the 2D detections' validity equal, and on valid slots the
    same (box, score) pairs to 1e-3 and 1e-5, labels equal;
  * pe: within 1e-4 of max;
  * head: every decoder layer's class scores and boxes within 1e-4 of
    max; the union's active keys equal, none dropped;
  * decode: the port's decode of JAX's head outputs against JAX's
    forward, and the port's whole forward against it: valid slots and
    labels equal, scores within 1e-4, boxes within 2e-3 (the
    tolerances of `test_torch_port_slice.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu_torch.models.detector2d import Proposals   # noqa: E402
from mv2d_tpu_torch.models.mv2d import HeadOutputs       # noqa: E402
from tests.test_torch_port_modules import rel_err, same_sets  # noqa: E402
from tests.test_torch_port_slice import DCN, build       # noqa: E402

REL = 1e-4
STAGES = ('feats', 'det2d', 'pe', 'head', 'decode', 'forward')


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope='module')
def r101():
    """Both models at depth 101 on one scene, and JAX's stages of its
    eval forward (one jit)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    V, h, w = 4, 64 // 16, 96 // 16
    b = build(seed=24, depth=101, stage_with_dcn=DCN, num_frames=2,
              k_max=V * h * w)
    jc = b['jc']
    assert (jc.total_views, jc.k_max) == (V, V * h * w)

    def stages(m, x, cam, shapes):
        fpn, p4 = m.extract_feats(x, fast_inference=True)
        props = m.base_detector.detect(fpn, jc.image_size, jc.proposal_test)
        pos = m.pe(p4, cam.img2lidar, shapes, jc.image_size)
        out = m.roi_head_forward(p4, pos, props, cam, shapes,
                                 mean_time_delta=m._mean_time_delta(cam))
        return fpn, p4, props, pos, out, m(x, cam, shapes)
    j = jax.jit(lambda v, *a: b['jm'].apply(v, *a, method=stages))(
        b['variables'], jnp.asarray(b['imgs']), b['jcam'],
        jnp.asarray(b['shapes']))
    b['j'] = dict(zip(('fpn', 'p4', 'props', 'pos', 'out', 'final'), j))
    yield b
    torch.set_num_threads(threads)


def _props(p):
    return Proposals(*(t(getattr(p, f)) for f in Proposals._fields))


def _same_detections(got, want):
    jboxes, jscores, jlabels, jvalid = (np.asarray(x) for x in want)
    v = jvalid
    assert np.array_equal(got.valid.numpy(), v) and v.sum() > 0
    assert np.abs(got.scores.numpy()[v] - jscores[v]).max() < 1e-4
    assert np.array_equal(got.labels.numpy()[v], jlabels[v])
    assert np.abs(got.boxes.numpy()[v] - jboxes[v]).max() < 2e-3


@pytest.mark.parametrize('stage', STAGES)
def test_stage_matches_jax(r101, stage):
    b, j = r101, r101['j']
    tm, tc, tcam = b['tm'], b['tc'], b['tcam']
    shapes = t(b['shapes'])
    with torch.no_grad():
        if stage == 'feats':
            fpn, p4 = tm.extract_feats(t(b['imgs']))
            assert len(fpn) == len(j['fpn']) == 5
            for g, w in zip((*fpn, p4), (*j['fpn'], j['p4'])):
                assert rel_err(g.numpy(), w) < REL
        elif stage == 'det2d':
            got = tm.base_detector.detect([t(f) for f in j['fpn']],
                                          tc.image_size, tc.proposal_test)
            want = j['props']
            jv = np.asarray(want.valid)
            assert np.array_equal(got.valid.numpy(), jv) and jv.sum() > 0
            for v in range(jv.shape[0]):
                m = jv[v]
                same_sets(got.boxes[v].numpy()[m], got.scores[v].numpy()[m],
                          np.asarray(want.boxes[v])[m],
                          np.asarray(want.scores[v])[m])
                assert sorted(got.labels[v].numpy()[m]) == \
                    sorted(np.asarray(want.labels[v])[m])
        elif stage == 'pe':
            got = tm.roi_head.position_encoding(
                t(j['p4']), tcam.img2lidar, shapes, tc.image_size)
            assert rel_err(got.numpy(), j['pos']) < REL
        elif stage == 'head':
            got = tm.roi_head_forward(t(j['p4']), t(j['pos']),
                                      _props(j['props']), tcam, shapes,
                                      tm._mean_time_delta(tcam))
            want = j['out']
            assert rel_err(got.all_cls_scores.numpy(),
                           want.all_cls_scores) < REL
            assert rel_err(got.all_bbox_preds.numpy(),
                           want.all_bbox_preds) < REL
            assert np.array_equal(got.query_valid.numpy(),
                                  np.asarray(want.query_valid))
            d = {k: int(v) for k, v in got.diagnostics.items()}
            assert d['key_active'] == int(want.diagnostics['key_active']) > 0
            assert d['key_overflow'] == 0 == int(
                want.diagnostics['key_overflow'])
        elif stage == 'decode':
            want = j['out']
            out = HeadOutputs(t(want.all_cls_scores), t(want.all_bbox_preds),
                              t(want.query_valid), {})
            _same_detections(tm.decode(out), j['final'])
        else:
            got = tm(t(b['imgs']), tcam, shapes)
            _same_detections(got, j['final'])
            assert int(got.diagnostics['key_overflow']) == 0
