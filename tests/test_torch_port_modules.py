"""The port's modules against the JAX package, one module at a time.

Weights: the tiny-config MV2D pair of test_torch_port_slice (same numpy
weights on both sides through state_dict_from_jax).  Each module gets the
same inputs on both sides - downstream modules take the JAX upstream
outputs - so an error stays where it starts.  Tolerances (float32, the
frameworks differ in summation order only): dense outputs 1e-4 relative to
their max magnitude; boxes 1e-3 px and scores 1e-5 on valid slots of the
discrete steps (top-k, NMS), which are compared as sets; masks, ids and
key indices exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu.core import coder as jcoder                # noqa: E402
from mv2d_tpu.core import nms as jnms                    # noqa: E402
from mv2d_tpu.core.geometry import virtual_intrinsics as j_vk  # noqa: E402
from mv2d_tpu.models import correlation as jcorr         # noqa: E402
from mv2d_tpu_torch.core import coder, nms               # noqa: E402
from mv2d_tpu_torch.core.geometry import virtual_intrinsics  # noqa: E402
from mv2d_tpu_torch.models import correlation as corr    # noqa: E402
from mv2d_tpu_torch.synthetic import camera_rig          # noqa: E402
from tests.test_torch_port_slice import build            # noqa: E402

REL = 1e-4


@pytest.fixture(scope='module')
def pair():
    torch.set_num_threads(1)
    b = build(seed=5)
    b['japply'] = lambda fn, *args: jax.jit(
        lambda v, *a: b['jm'].apply(v, *a, method=fn))(b['variables'], *args)
    return b


def t(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def same_sets(gb, gs, wb, ws, atol_box=1e-3, atol_s=1e-5):
    """Every wanted (box, score) has exactly one got match."""
    assert len(gb) == len(wb), (len(gb), len(wb))
    used = np.zeros(len(wb), bool)
    for b, s in zip(gb, gs):
        cand = ~used & (np.abs(ws - s) < atol_s) & \
            (np.abs(wb - b).max(-1) < atol_box)
        assert cand.any(), (b, s)
        used[int(np.argmax(cand))] = True


def jax_feats(p):
    return p['japply'](lambda m, x: m.base_detector.extract_feat(x, True),
                       jnp.asarray(p['imgs']))


def test_backbone_and_fpn(pair):
    want = jax_feats(pair)
    with torch.no_grad():
        got = pair['tm'].base_detector.extract_feat(t(pair['imgs']))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) < REL


def test_rpn_proposals(pair):
    jc, tc = pair['jc'], pair['tc']
    feats = jax_feats(pair)
    jb, js, jv = pair['japply'](
        lambda m, f: m.base_detector.rpn(f, jc.image_size, jc.proposal_test),
        feats)
    with torch.no_grad():
        tb, ts, tv = pair['tm'].base_detector.rpn(
            [t(f) for f in feats], tc.image_size, tc.proposal_test)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    for v in range(jb.shape[0]):
        m = np.asarray(jv[v])
        assert m.sum() > 0
        same_sets(tb[v].numpy()[m], ts[v].numpy()[m], np.asarray(jb[v])[m],
                  np.asarray(js[v])[m])


def test_rcnn_detections(pair):
    jc, tc = pair['jc'], pair['tc']
    feats = jax_feats(pair)
    jp = pair['japply'](
        lambda m, f: m.base_detector.detect(f, jc.image_size,
                                            jc.proposal_test), feats)
    with torch.no_grad():
        tp = pair['tm'].base_detector.detect(
            [t(f) for f in feats], tc.image_size, tc.proposal_test)
    jv = np.asarray(jp.valid)
    assert np.array_equal(tp.valid.numpy(), jv) and jv.sum() > 0
    for v in range(jv.shape[0]):
        m = jv[v]
        same_sets(tp.boxes[v].numpy()[m], tp.scores[v].numpy()[m],
                  np.asarray(jp.boxes[v])[m], np.asarray(jp.scores[v])[m])
        assert sorted(tp.labels[v].numpy()[m]) == \
            sorted(np.asarray(jp.labels[v])[m])


def test_position_embedding(pair):
    rng = np.random.default_rng(0)
    jc = pair['jc']
    V = jc.total_views
    p4 = rng.normal(size=(V, 4, 6, jc.embed_dims)).astype(np.float32)
    want = pair['japply'](
        lambda m, x, s: m.pe(x, pair['jcam'].img2lidar, s, jc.image_size),
        jnp.asarray(p4), jnp.asarray(pair['shapes']))
    with torch.no_grad():
        got = pair['tm'].roi_head.position_encoding(
            t(p4), pair['tcam'].img2lidar, t(pair['shapes']), jc.image_size)
    assert rel_err(got.numpy(), want) < REL


def _boxes(rng, V, P, size):
    H, W = size
    xy = rng.uniform(0, 0.7, (V, P, 2)) * [W, H]
    wh = rng.uniform(0.1, 0.3, (V, P, 2)) * [W, H]
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[0, 0] = [10, 10, 12, 40]               # narrower than 4 px
    valid = rng.random((V, P)) < 0.8
    return boxes, valid


def test_query_generator(pair):
    rng = np.random.default_rng(1)
    jc = pair['jc']
    V, C, P = jc.total_views, jc.embed_dims, 6
    boxes, valid = _boxes(rng, V, P, jc.image_size)
    flat = boxes.reshape(-1, 4)
    view = np.repeat(np.arange(V), P)
    feats = rng.normal(size=(V * P, 7, 7, C)).astype(np.float32)
    ok = ((flat[:, 2:] - flat[:, :2]) >= 4).all(1) & valid.reshape(-1)
    Kv = j_vk(jnp.asarray(flat), pair['jcam'].intrinsics[view], (7, 7))
    Kv_t = virtual_intrinsics(t(flat), pair['tcam'].intrinsics[t(view)])
    assert rel_err(Kv_t.numpy(), Kv) < 1e-6
    want = pair['japply'](
        lambda m, f, k, e, o: m.query_generator(f, k, e, o)[0],
        jnp.asarray(feats), Kv, pair['jcam'].ext_t_inv[view],
        jnp.asarray(ok))
    with torch.no_grad():
        got, aux = pair['tm'].roi_head.query_generator(
            t(feats), Kv_t, pair['tcam'].ext_t_inv[t(view)], t(ok))
    assert list(aux) == ['uvd']
    assert rel_err(got.numpy(), want) < REL


def test_correlation_and_key_gather():
    """Two cameras over two frames (views v and v+2 share a pose), so the
    epipolar matching finds cross-view partners."""
    from mv2d_tpu.core.geometry import prepare_camera_params as j_cam
    from mv2d_tpu_torch.configs import CorrelationConfig
    from mv2d_tpu_torch.core.geometry import prepare_camera_params as t_cam
    rng = np.random.default_rng(2)
    size, stride, P = (64, 96), 16, 6
    K, E = camera_rig(2, size)
    K, E = np.concatenate([K, K]), np.concatenate([E, E])
    jcam, tcam = j_cam(K, E), t_cam(K, E, device='cpu')
    boxes, valid = _boxes(rng, 4, P, size)
    cfg = CorrelationConfig(sample_size=2, num_depth=4, topk=2)
    ids_j, mask_j = jax.jit(jcorr.epipolar_in_box, static_argnums=(3, 4))(
        jnp.asarray(boxes), jnp.asarray(valid), jcam.trans_mats, size,
        jcorr.CorrelationConfig(**cfg._asdict()))
    ids_t, mask_t = corr.epipolar_in_box(t(boxes), t(valid), tcam.trans_mats,
                                         size, cfg)
    mask_j = np.asarray(mask_j)
    assert np.array_equal(mask_t.numpy(), mask_j)
    assert mask_j[:, 1:].sum() > 0, 'rig must cross-correlate'
    assert np.array_equal(ids_t.numpy()[mask_j], np.asarray(ids_j)[mask_j])
    R = 4 * P
    A_j = np.asarray(jcorr.adjacency_from_correlation(ids_j, mask_j, R))
    A_t = corr.adjacency_from_correlation(ids_t, mask_t, R)
    assert np.array_equal(A_t.numpy(), A_j)
    hw = (size[0] // stride, size[1] // stride)
    roi_j = np.asarray(jcorr.in_roi_pixel_masks(
        jnp.asarray(boxes), jnp.asarray(valid), hw, stride, 2.0))
    roi_t = corr.in_roi_pixel_masks(t(boxes), t(valid), hw, stride, 2.0)
    assert np.array_equal(roi_t.numpy(), roi_j)
    union = rng.random(4 * hw[0] * hw[1]) < 0.4
    for k_max in (8, 200):                        # cap binds / does not
        ij, aj = jcorr.gather_active_keys(jnp.asarray(union), k_max)
        it, at = corr.gather_active_keys(t(union), k_max)
        assert np.array_equal(it.numpy(), np.asarray(ij))
        assert np.array_equal(at.numpy(), np.asarray(aj))


def test_decoder_head(pair):
    """CrossAttentionBoxHead on shared inputs, through the attention
    wrappers (masked_attention, which takes its plain version on the
    CPU)."""
    rng = np.random.default_rng(3)
    jc = pair['jc']
    Q, K, C = 12, 40, jc.embed_dims
    refs = rng.uniform(0.05, 0.95, (Q, 3)).astype(np.float32)
    keys = rng.normal(size=(K, C)).astype(np.float32)
    kpos = rng.normal(size=(K, C)).astype(np.float32)
    qvalid = rng.random(Q) < 0.7
    self_allowed = qvalid[None] | np.eye(Q, dtype=bool)
    cross = rng.random((Q, K)) < 0.3
    cross[:2] = False                             # fully masked rows
    want = pair['japply'](
        lambda m, *a: m.bbox_head(*a), jnp.asarray(refs), jnp.asarray(keys),
        jnp.asarray(kpos), jnp.asarray(self_allowed), jnp.asarray(cross))
    head = pair['tm'].roi_head.bbox_head
    with torch.no_grad():
        got = head(t(refs), t(keys), t(kpos), t(self_allowed), t(cross))
    assert rel_err(got[0].numpy(), want[0]) < REL
    assert rel_err(got[1].numpy(), want[1]) < REL


def _greedy_nms(boxes, scores, thr):
    order = np.argsort(-scores, kind='stable')
    keep, dead = [], np.zeros(len(boxes), bool)
    for i in order:
        if dead[i]:
            continue
        keep.append(i)
        lt = np.maximum(boxes[i, :2], boxes[:, :2])
        rb = np.minimum(boxes[i, 2:], boxes[:, 2:])
        inter = np.prod(np.clip(rb - lt, 0, None), -1)
        area = np.prod(boxes[:, 2:] - boxes[:, :2], -1)
        iou = inter / (area[i] + area - inter + 1e-4)
        dead |= iou > thr
    return np.asarray(keep)


def test_nms_blocked_scan_is_greedy():
    """Blocked scan (3 blocks of 256, chains across and inside blocks) ==
    naive greedy NMS, == the JAX package's nms_padded."""
    rng = np.random.default_rng(4)
    N = 700
    centers = rng.uniform(0, 200, (40, 2))[rng.integers(0, 40, N)]
    centers += rng.normal(0, 4, (N, 2))
    wh = rng.uniform(10, 30, (N, 2))
    boxes = np.concatenate([centers, centers + wh], -1).astype(np.float32)
    scores = rng.random(N).astype(np.float32)
    valid = rng.random(N) < 0.95
    want = _greedy_nms(boxes[valid], scores[valid], 0.5)
    b, s, idx, v = nms.nms_padded(t(boxes), t(scores), t(valid), 0.5, N)
    kept = idx.numpy()[v.numpy()]
    assert np.array_equal(kept, np.nonzero(valid)[0][want])
    _, _, jidx, jv = jnms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores),
                                     jnp.asarray(valid), 0.5, N)
    assert np.array_equal(kept, np.asarray(jidx)[np.asarray(jv)])


def test_bev_merge_rotated_nms():
    """box3d_multiclass_nms with a suppressing threshold (rotated BEV IoU)
    and at the eval setting 1.0, against JAX."""
    rng = np.random.default_rng(5)
    N, ncls = 40, 2
    boxes = np.zeros((N, 9), np.float32)
    boxes[:, :2] = rng.uniform(-10, 10, (N, 2))
    boxes[:, 3:6] = rng.uniform(1, 4, (N, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, N)
    bev = boxes[:, [0, 1, 3, 4, 6]]
    scores = rng.random((N, ncls + 1)).astype(np.float32)
    valid = rng.random(N) < 0.9
    merge = jax.jit(jnms.box3d_multiclass_nms, static_argnums=(4, 5, 6, 7))
    for thr in (0.2, 1.0):
        jo = merge(jnp.asarray(boxes), jnp.asarray(bev), jnp.asarray(scores),
                   jnp.asarray(valid), 0.3, 30, thr, ncls)
        to = nms.box3d_multiclass_nms(t(boxes), t(bev), t(scores), t(valid),
                                      0.3, 30, thr, ncls)
        jv = np.asarray(jo[3])
        assert np.array_equal(to[3].numpy(), jv)
        assert np.abs(to[0].numpy()[jv] - np.asarray(jo[0])[jv]).max() < 1e-6
        assert np.abs(to[1].numpy() - np.asarray(jo[1])).max() < 1e-6
        assert np.array_equal(to[2].numpy()[jv], np.asarray(jo[2])[jv])


def test_nms_free_decode():
    rng = np.random.default_rng(6)
    Q, ncls = 30, 10
    cls = rng.normal(size=(Q, ncls)).astype(np.float32)
    code = rng.normal(size=(Q, 10)).astype(np.float32)
    code[:, :3] *= 40
    qv = rng.random(Q) < 0.8
    rng_ = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    for max_num in (20, 400):                     # top-k and padded slots
        jb, js, jl, jv = jcoder.nms_free_decode(
            jnp.asarray(cls), jnp.asarray(code), jnp.asarray(qv), max_num,
            ncls, rng_)
        tb, ts, tl, tv = coder.nms_free_decode(t(cls), t(code), t(qv),
                                               max_num, ncls, rng_)
        jv = np.asarray(jv)
        assert np.array_equal(tv.numpy(), jv)
        assert np.abs(tb.numpy()[jv] - np.asarray(jb)[jv]).max() < 1e-5
        assert np.abs(ts.numpy() - np.asarray(js)).max() < 1e-6
        assert np.array_equal(tl.numpy()[jv], np.asarray(jl)[jv])
