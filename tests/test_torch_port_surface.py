"""The JAX package's public functions that no path of the model calls,
against their ports: `core.boxes.iou_3d`, `core.geometry.points_img2cam`,
`denormalize_points` and `project_lidar_to_img`, `core.coder.
nms_free_cls_decode` and `nn.pe.LearnedPositionalEncoding3D` (its tables
carried by `weights.state_dict_from_jax`).

The same numpy inputs on both sides, float32.  Tolerance: 1e-5 relative
to the JAX output's max magnitude (the two frameworks differ in summation
order only); the decoder's labels, validity and slot order exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402

from mv2d_tpu.core import boxes as jboxes                # noqa: E402
from mv2d_tpu.core import coder as jcoder                # noqa: E402
from mv2d_tpu.core import geometry as jgeo               # noqa: E402
from mv2d_tpu.nn import pe as jpe                        # noqa: E402
from mv2d_tpu_torch.core import boxes, coder, geometry  # noqa: E402
from mv2d_tpu_torch.nn import pe                         # noqa: E402
from mv2d_tpu_torch.synthetic import camera_rig          # noqa: E402
from mv2d_tpu_torch.weights import state_dict_from_jax  # noqa: E402

REL = 1e-5
PC_RANGE = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= rel, err


_IOU_3D = jax.jit(jboxes.iou_3d)


def j_iou_3d(a, b, n=8, m=12):
    """JAX's iou_3d, the boxes padded with far boxes to one shape so that
    every case shares one compile."""
    far = np.tile(np.float32([1e3, 1e3, 0, 1, 1, 1, 0, 0, 0]),
                  (max(n, m), 1))[:, :a.shape[1]]
    a_p = np.concatenate([a, far[:n - len(a)]])
    b_p = np.concatenate([b, far[:m - len(b)]])
    return np.asarray(_IOU_3D(a_p, b_p))[:len(a), :len(b)]


def rig(n=6, size=(64, 176)):
    K, E = camera_rig(n, size)
    return K, K @ np.transpose(E, (0, 2, 1))              # intrinsics, l2i


@pytest.mark.parametrize('case', ['rotated', 'disjoint', 'half_height',
                                  'random'])
def test_iou_3d(case):
    rng = np.random.default_rng(0)
    if case == 'rotated':        # the same box at several yaws, and shifted
        a = [[0, 0, 0, 2, 4, 2, 0.3, 0, 0], [1, -1, 0.5, 3, 1, 1, -1.2, 0, 0]]
        b = [[0, 0, 0, 2, 4, 2, 0.3 + y, 0, 0] for y in (0, 0.4, np.pi / 2)]
        b += [[0.7, 0.2, 0.1, 2, 4, 2, 1.0, 1, 2]]
    elif case == 'disjoint':     # apart in BEV, above, or touching in z only
        a = [[0, 0, 0, 2, 4, 2, 0.3, 0, 0]]
        b = [[20, 0, 0, 2, 4, 2, 0.3, 0, 0], [0, 0, 5, 2, 4, 2, 0.3, 0, 0],
             [0, 0, 2, 2, 4, 2, 0.3, 0, 0]]
    elif case == 'half_height':  # equal footprints, z ranges half shared
        a = [[0, 0, 0, 2, 2, 2, 0, 0, 0], [3, 3, -1, 1, 2, 4, 0.7, 0, 0]]
        b = [[0, 0, 1, 2, 2, 2, 0, 0, 0], [3, 3, 1, 1, 2, 4, 0.7, 0, 0]]
    else:
        def draw(n):
            return np.concatenate([rng.uniform(-3, 3, (n, 3)),
                                   rng.uniform(0.5, 4, (n, 3)),
                                   rng.uniform(-np.pi, np.pi, (n, 1)),
                                   np.zeros((n, 2))], 1)
        a, b = draw(7), draw(9)
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    want = j_iou_3d(a, b)
    got = boxes.iou_3d(t(a), t(b))
    close(got, want)
    if case == 'half_height':
        np.testing.assert_allclose(np.diag(got.numpy()), [4 / 12, 4 / 12],
                                   atol=1e-6)
    if case == 'disjoint':
        assert float(got.max()) < 1e-6


@pytest.mark.parametrize('shape', [(3, 3), (3, 4), (4, 4)])
def test_points_img2cam(shape):
    rng = np.random.default_rng(1)
    K = rig()[0][2][:shape[0], :shape[1]].astype(np.float32)
    uvd = np.concatenate([rng.uniform(0, 176, (20, 1)),
                          rng.uniform(0, 64, (20, 1)),
                          rng.uniform(1, 60, (20, 1))], 1).astype(np.float32)
    want = jax.jit(jgeo.points_img2cam)(uvd, K)
    close(geometry.points_img2cam(t(uvd), t(K)), want)


def test_denormalize_points():
    rng = np.random.default_rng(2)
    n = rng.uniform(-0.1, 1.1, (4, 10, 3)).astype(np.float32)
    want = jax.jit(jgeo.denormalize_points, static_argnums=1)(
        n, tuple(PC_RANGE))
    got = geometry.denormalize_points(t(n), PC_RANGE)
    close(got, want)
    close(geometry.normalize_points(got, PC_RANGE), n)


def test_project_lidar_to_img():
    """Every view of the rig; points behind a camera (depth < eps) are
    divided by eps."""
    rng = np.random.default_rng(3)
    l2i = rig()[1].astype(np.float32)                              # [6, 4, 4]
    pts = rng.uniform(-40, 40, (6, 50, 3)).astype(np.float32)
    uv_j, d_j = jax.jit(jgeo.project_lidar_to_img)(pts, l2i[:, None])
    uv, d = geometry.project_lidar_to_img(t(pts), t(l2i[:, None]))
    assert (np.asarray(d_j) < 1e-2).any() and (np.asarray(d_j) > 1).any()
    close(d, d_j)
    close(uv, uv_j)


@pytest.mark.parametrize('case', ['pad', 'threshold', 'range', 'all'])
def test_nms_free_cls_decode(case):
    """Q = 30 queries, 10 classes + background, a third of the queries
    invalid: max_num 40 pads 10 slots; the threshold and the range drop
    slots; 'all' takes max_num 12 (no pad) with both."""
    rng = np.random.default_rng(4)
    Q, C = 30, 10
    cls = rng.normal(0, 2, (Q, C + 1)).astype(np.float32)
    code = np.concatenate([rng.uniform(-70, 70, (Q, 2)),
                           rng.normal(0, 0.5, (Q, 2)),
                           rng.uniform(-6, 4, (Q, 1)),
                           rng.normal(0, 0.5, (Q, 1)),
                           rng.normal(0, 1, (Q, 2)),
                           rng.normal(0, 1, (Q, 2))], 1).astype(np.float32)
    qv = rng.uniform(size=Q) > 0.33
    kw = dict(max_num=40, num_classes=C)
    if case in ('threshold', 'all'):
        kw['score_threshold'] = 0.3
    if case in ('range', 'all'):
        kw['post_center_range'] = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    if case == 'all':
        kw['max_num'] = 12
    want = jax.jit(jcoder.nms_free_cls_decode, static_argnames=tuple(kw))(
        cls, code, qv, **kw)
    got = coder.nms_free_cls_decode(t(cls), t(code), torch.from_numpy(qv),
                                    **kw)
    wb, ws, wl, wv = (np.asarray(x) for x in want)
    gb, gs, gl, gv = (x.numpy() for x in got)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gl, wl)
    close(gs, ws)
    close(gb, wb)
    assert 0 < gv.sum() < gv.size
    if case in ('threshold', 'range'):     # the mask dropped a valid query
        base = coder.nms_free_cls_decode(t(cls), t(code), torch.from_numpy(qv),
                                         max_num=40, num_classes=C)
        assert gv.sum() < base[3].sum()


def test_learned_positional_encoding_3d():
    """Tables smaller than the mask's axes (indices wrap), carried from
    the flax `Embed`s without a transpose."""
    jm = jpe.LearnedPositionalEncoding3D(num_feats=8, row_num_embed=5,
                                         col_num_embed=7, view_num_embed=4)
    mask = np.zeros((6, 9, 11), bool)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), mask)['params']
    want = jax.jit(jm.apply)({'params': params}, mask)
    m = pe.LearnedPositionalEncoding3D(num_feats=8, row_num_embed=5,
                                       col_num_embed=7, view_num_embed=4)
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.array, params), {})
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                      strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(mask))
    assert got.shape == (6, 9, 11, 24)
    close(got, want)
