"""The last two RoIAlign kernels' functions and the routes that reach them,
on the CPU, against the JAX package.

  * B12 (`ops.roi_align.roi_align_flat`; its plain version
    `multilevel_roi_align_flat_plain`, what the wrapper runs on the CPU)
    against `pallas_roi_align.pallas_multilevel_roi_align(interpret=True)`
    and JAX's exact XLA `multilevel_roi_align`: random views with edge
    RoIs (outside the image, zero-area, whole image, slivers), and RoIs of
    each patch pass plus the overflow class (long side > 61 cells), at
    sampling_ratio 2 and 0;
  * `TwoStageDetector.roi_forward` (B12 + Shared2FC) against JAX's
    `Detector2D.roi_forward` on weights carried by `state_dict_from_jax`;
  * B11's function (`multilevel_roi_align_plain`, what `roi_align_slab`
    runs on the CPU) against `pallas_roi_align_views(v2=True,
    interpret=True)`, adaptive, with overflow RoIs inside its bucket;
  * `routes.from_env` on MV2D_ALIGN_V2, and a tiny+DCN forward and
    training step with `align_v2` equal to the default route's (1e-5).

Tolerances: against the Pallas kernels 2e-3 (rtol and atol), as
`tests/test_pallas_roi_align.py` holds them against XLA; against the XLA
module 1e-4 of the max magnitude (float32, summation order only).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu.ops.pallas_roi_align import (  # noqa: E402
    pallas_multilevel_roi_align, pallas_roi_align_views)
from mv2d_tpu.ops.roi_align import multilevel_roi_align  # noqa: E402
from mv2d_tpu_torch import configs, routes               # noqa: E402
from mv2d_tpu_torch.models.mv2d import MV2D              # noqa: E402
from mv2d_tpu_torch.ops import roi_align                 # noqa: E402
from mv2d_tpu_torch.routes import Routes                 # noqa: E402
from mv2d_tpu_torch.synthetic import (camera_rig,        # noqa: E402
                                      init_random_weights,
                                      synthetic_train_batch)
from mv2d_tpu_torch.core.geometry import prepare_camera_params  # noqa
from mv2d_tpu_torch.parallel.dist import dp_objective   # noqa: E402
from mv2d_tpu_torch.train.train_step import draw_train   # noqa: E402
from tests.test_torch_port_slice import build            # noqa: E402

STRIDES = (4, 8, 16, 32)
TOL = 2e-3


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.delenv('MV2D_ALIGN_V2', raising=False)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def levels(rng, V, img, C=8):
    return [rng.normal(size=(V, img[0] // s, img[1] // s, C))
            .astype(np.float32) for s in STRIDES]


def flat_case(name):
    """(levels, rois [R, 4], views [R]) of one B12 case."""
    rng = np.random.default_rng(0)
    if name == 'random_and_edge':
        feats = levels(rng, 2, (256, 384))
        xy = rng.uniform(0, 250, (24, 2))
        wh = rng.uniform(8, 300, (24, 2))
        rois = np.concatenate([np.concatenate([xy, xy + wh], 1), [
            [0., 0., 384., 256.],       # whole image
            [-10., -10., 30., 30.],     # across the top-left corner
            [-60., -40., -20., -8.],    # outside the image
            [100., 50., 100., 50.],     # zero area
            [370., 240., 384., 256.],   # bottom-right sliver
            [0., 60., 384., 68.],       # 96 x 2 cells at p2: overflow
        ]])
        views = rng.integers(0, 2, len(rois))
    else:                               # each patch pass and overflow
        feats = levels(rng, 2, (512, 1408))
        rois = np.asarray([
            [100., 100., 130., 124.],   # tiny -> 16-row pass
            [100., 100., 420., 300.],   # medium -> 32-row pass
            [10., 10., 1398., 500.],    # huge -> 64-row pass
            [0., 200., 1400., 240.],    # wide sliver -> overflow
            [600., 0., 640., 512.],     # tall sliver -> overflow
        ])
        views = np.asarray([0, 1, 0, 1, 0])
    return feats, rois.astype(np.float32), views.astype(np.int32)


def cells(rois):
    """(cols, rows) of each RoI in cells of its routed level."""
    lvl = roi_align.roi_levels(t(rois)).numpy()
    sc = 1.0 / np.asarray(STRIDES, np.float32)[lvl]
    return (rois[:, 2] - rois[:, 0]) * sc, (rois[:, 3] - rois[:, 1]) * sc


def bins(rois):
    """mmcv's adaptive samples a bin, the larger axis of each RoI."""
    return np.ceil(np.maximum(*cells(rois)) / 7)


def pallas_capped(feats, rois):
    """RoIs whose adaptive sample count the Pallas patch kernel caps: its
    exact overflow path (long side > 61 cells) folds at most
    ceil(extent / 7) samples a bin of the largest level's extent on each
    axis, so an overflow RoI reaching past the map on its long axis is
    sampled less than mmcv samples it."""
    cols, rows = cells(rois)
    h_max = max(f.shape[1] for f in feats)
    w_max = -(-max(f.shape[2] for f in feats) // 8) * 8
    over = np.maximum(cols, rows) > 61
    return over & ((np.ceil(rows / 7) > -(-h_max // 7))
                   | (np.ceil(cols / 7) > -(-w_max // 7)))


@pytest.mark.parametrize('case', ['random_and_edge', 'passes_and_overflow'])
@pytest.mark.parametrize('sampling_ratio', [2, 0])
def test_flat_align_matches_pallas(case, sampling_ratio):
    """B12's function: the wrapper on CPU tensors (its plain version)
    against the Pallas patch kernel in interpret mode, and against JAX's
    exact XLA form (adaptive count uncapped).  The Pallas kernel caps the
    adaptive count of an overflow RoI that reaches past the map
    (`pallas_capped`); such a RoI is held against the XLA form only."""
    feats, rois, views = flat_case(case)
    jf = [jnp.asarray(f) for f in feats]
    want = np.asarray(pallas_multilevel_roi_align(
        jf, jnp.asarray(rois), jnp.asarray(views), STRIDES,
        sampling_ratio=sampling_ratio, rois_per_step=4, interpret=True))
    exact = np.asarray(multilevel_roi_align(   # a lattice of every S
        jf, jnp.asarray(rois), jnp.asarray(views), STRIDES, 7,
        sampling_ratio, adaptive_max=int(bins(rois).max())))
    got = roi_align.roi_align_flat([t(f) for f in feats], t(rois), t(views),
                                   STRIDES, sampling_ratio).numpy()
    lvl = roi_align.roi_levels(t(rois))
    assert len(set(lvl.tolist())) >= 3
    assert np.abs(got - exact).max() <= 1e-4 * np.abs(exact).max()
    keep = ~pallas_capped(feats, rois) if sampling_ratio == 0 else \
        np.ones(len(rois), bool)
    assert keep.sum() >= len(rois) - 1
    np.testing.assert_allclose(got[keep], want[keep], rtol=TOL, atol=TOL)


def test_flat_align_zero_area_rois():
    """Adaptive sampling takes no sample on a zero extent (mmcv's empty
    loop); a fixed ratio samples the point."""
    feats, _, _ = flat_case('random_and_edge')
    rois = t(np.asarray([[100., 50., 100., 50.], [10., 20., 60., 20.]],
                        np.float32))
    views = torch.tensor([0, 1])
    tf = [t(f) for f in feats]
    assert roi_align.roi_align_flat(tf, rois, views, STRIDES, 0).abs().max() \
        == 0
    assert roi_align.roi_align_flat(tf, rois, views, STRIDES, 2).abs().max() \
        > 0


def test_roi_forward_matches_jax():
    """The R-CNN head on flat RoIs (B12's function, adaptive sampling, then
    Shared2FC) equal to JAX's Detector2D.roi_forward (its XLA path on the
    CPU) on the same carried weights and FPN levels.  JAX caps the
    adaptive count at ceil(largest level side / 7), exact for RoIs inside
    the image, so the RoIs are clipped to it but one that crosses a
    corner within that cap."""
    b = build()
    tc = b['tc']
    V, (H, W) = tc.total_views, tc.image_size
    rng = np.random.default_rng(3)
    feats = [rng.normal(size=(V, -(-H // s), -(-W // s), tc.fpn_channels))
             .astype(np.float32) for s in (4, 8, 16, 32, 64)]
    xy = rng.uniform(0, 60, (30, 2))
    rois = np.concatenate([xy, xy + rng.uniform(2, 250, (30, 2))], 1)
    rois[:, 0::2] = rois[:, 0::2].clip(0, W)
    rois[:, 1::2] = rois[:, 1::2].clip(0, H)
    rois[0] = [-8., -4., 100., 70.]
    rois[1] = [10., 10., 10., 30.]
    rois = rois.astype(np.float32)
    views = rng.integers(0, V, len(rois)).astype(np.int32)
    want = b['jm'].apply(
        b['variables'], [jnp.asarray(f) for f in feats], jnp.asarray(rois),
        jnp.asarray(views),
        method=lambda m, f, r, v: m.base_detector.roi_forward(f, r, v))
    with torch.no_grad():
        got = b['tm'].base_detector.roi_forward([t(f) for f in feats],
                                                t(rois), t(views))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_slab_align_matches_pallas_v2():
    """B11's function (the plain version the CPU runs for
    `roi_align_slab`) against JAX's MV2D_ALIGN_V2 slab kernel in interpret
    mode, adaptive sampling, overflow RoIs (a wide and a tall sliver)
    inside its bucket, empty, outside and whole-image RoIs."""
    rng = np.random.default_rng(1)
    img, V, P = (128, 352), 2, 8
    feats = levels(rng, V, img)
    side = 32 * 2.0 ** rng.integers(0, 4, (V, P)) * rng.uniform(0.7, 1.4,
                                                                (V, P))
    h = side * rng.uniform(0.5, 1.5, (V, P))
    cx, cy = rng.uniform(0, img[1], (V, P)), rng.uniform(0, img[0], (V, P))
    rois = np.stack([cx - side / 2, cy - h / 2, cx + side / 2, cy + h / 2],
                    -1)
    rois[:, 0] = [0., 60., 352., 68.]           # wide: 88 x 2 cells
    rois[:, 1] = [170., 0., 176., 128.]         # tall: 2 x 32 cells
    rois[:, 2] = [50., 50., 50., 50.]           # empty
    rois[:, 3] = [-40., -30., 60., 50.]         # across the corner
    rois[:, 4] = [0., 0., 352., 128.]           # whole image
    rois = rois.astype(np.float32)
    want = pallas_roi_align_views(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), STRIDES,
        sampling_ratio=0, interpret=True, v2=True)
    got = roi_align.roi_align_slab([t(f) for f in feats], t(rois), STRIDES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


# ------------------------------------------------------------ the route

@pytest.mark.parametrize('value,want', [
    (None, False), ('0', False), ('1', True), ('yes', ValueError)])
def test_align_v2_switch(monkeypatch, value, want):
    if value is not None:
        monkeypatch.setenv('MV2D_ALIGN_V2', value)
    if want is ValueError:
        with pytest.raises(ValueError):
            routes.from_env()
    else:
        assert routes.from_env().align_v2 is want
        assert MV2D(configs.tiny()).base_detector.align_v2 is want


def test_align_v2_forward_and_step_equal_default(monkeypatch):
    """A tiny+DCN eval forward and training step built with align_v2 equal
    to the default route's (the same weights, scene and draws): outputs,
    losses and gradients within 1e-5; the detect pass and the R-CNN RoIs
    go through the slab wrappers."""
    cfg = configs.tiny(stage_with_dcn=(False, False, True, True),
                       num_frames=2, dropout=0.0, use_flash_attention=True)
    calls = []

    def spy(feats, rois, strides):
        calls.append(tuple(rois.shape))
        return roi_align.multilevel_roi_align_plain(feats, rois, strides)
    import mv2d_tpu_torch.models.detector2d as det2d
    monkeypatch.setattr(det2d, 'roi_align_slab', spy)
    V = cfg.total_views
    K, E = camera_rig(V, cfg.image_size)
    cam = prepare_camera_params(K, E, [0.0] * 2 + [0.5] * 2, device='cpu')
    imgs = t(np.random.default_rng(1).normal(
        size=(V, *cfg.image_size, 3)).astype(np.float32))
    shapes = torch.tensor([list(cfg.image_size)] * V)
    batch = synthetic_train_batch(cfg, seed=0, device='cpu')
    draws = draw_train(cfg, batch.gt2d.boxes.shape[1],
                       torch.Generator().manual_seed(1))
    runs = []
    for route in (Routes(), Routes(align_v2=True)):
        m = init_random_weights(MV2D(cfg, route), seed=3)
        with torch.no_grad():
            det = m.eval()(imgs, cam, shapes)
        m.train()
        local, metrics = dp_objective(m, [batch], [draws],
                                      mixed_precision=False)
        local.backward()
        runs.append((det, {k: float(v) for k, v in metrics.items()},
                     {n: p.grad.detach() for n, p in m.named_parameters()
                      if p.grad is not None}))
    # eval detect, training detect (no grad); the R-CNN RoIs take the
    # differentiable form, K3 / B9 or B11 / B9 on CUDA
    assert len(calls) == 2
    (d0, m0, g0), (d1, m1, g1) = runs
    assert torch.equal(d0.valid, d1.valid) and d0.valid.any()
    for a, b in zip(d0[:3], d1[:3]):
        assert (a.float() - b.float()).abs().max() <= 1e-5 * max(
            b.float().abs().max().item(), 1e-6)
    assert m0.keys() == m1.keys() and g0.keys() == g1.keys()
    for k in m0:
        assert abs(m1[k] - m0[k]) <= 1e-5 * max(abs(m0[k]), 1e-6), k
    floor = 1e-5 * max(g.abs().max().item() for g in g0.values())
    for n in g0:
        err = (g1[n] - g0[n]).abs().max().item()
        assert err <= 1e-5 * max(g0[n].abs().max().item(), floor), n
