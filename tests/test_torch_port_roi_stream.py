"""B11 and B12's streamed core in plain PyTorch, on the CPU, against the JAX
package.

  * `ops.roi_align.roi_align_stream_plain` walks each RoI's footprint in
    the producer's boxes (column chunks outer, rows inner, zeros past the
    map's edge) and sums each bin column's cells with its own weights, as
    `csrc/roi_align_stream.cuh` does.  It is held against
    `pallas_roi_align.pallas_multilevel_roi_align(interpret=True)` (2e-3,
    rtol and atol, as `tests/test_torch_port_align.py` holds the flat
    function) and against JAX's exact XLA `multilevel_roi_align` (1e-4 of
    the max magnitude, float32 summation order only), at a fixed S = 2 and
    with mmcv's adaptive count; RoIs outside the image, of zero area, the
    whole image, slivers across a whole level, footprints that are not a
    multiple of the box; a level wider than 512 cells against the XLA form
    alone (the Pallas kernel pads such a level into VMEM-sized patches);
  * `ops.roi_align.slab_worklist_plain` mirrors B11's work list: every RoI
    once, size classes by the long side at the routed level (13 / 29 / 61
    cells), each class's run padded to whole buckets inside
    `slab_slots(P)`;
  * `chip_smoke.roi_read_bytes`, the bytes in the RoIAlign kernels' bound,
    counts each cell of the union of the footprints the plain walk reads
    once per (view, level).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu.ops.pallas_roi_align import (  # noqa: E402
    pallas_multilevel_roi_align)
from mv2d_tpu.ops.roi_align import multilevel_roi_align  # noqa: E402
from mv2d_tpu_torch.ops import roi_align                 # noqa: E402
import chip_smoke                                        # noqa: E402

STRIDES = (4, 8, 16, 32)
TOL = 2e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def levels(rng, V, img, C=8):
    return [rng.normal(size=(V, -(-img[0] // s), -(-img[1] // s), C))
            .astype(np.float32) for s in STRIDES]


def edge_case(img=(256, 832)):
    """(levels, rois [R, 4], views [R]): random RoIs of every level, and
    RoIs outside the image, of zero area,
    the whole image, slivers across a whole level, footprints of 17 x 5
    and 33 x 3 cells (not a multiple of any box tried)."""
    rng = np.random.default_rng(0)
    V = 2
    feats = levels(rng, V, img)
    H, W = img
    xy = rng.uniform(0, W - 40, (16, 2))
    wh = rng.uniform(8, 300, (16, 2))
    rois = np.concatenate([np.concatenate([xy, xy + wh], 1), [
        [0., 0., W, H],                 # whole image, level 3
        [-60., -40., -20., -8.],        # outside the image
        [100., 50., 100., 50.],         # zero area
        [0., 60., W, 64.],              # across level 0, 208 x 1 cells
        [200., 0., 203., H],            # down level 0, 0.75 x 64 cells
        [-20., -12., 30., 40.],         # across the top-left corner
        [W - 30., H - 10., W + 20., H + 6.],   # across the bottom-right
        [40., 40., 108., 60.],          # 17 x 5 cells at level 0
        [20., 100., 152., 112.],        # 33 x 3 cells at level 0
    ]]).astype(np.float32)
    views = rng.integers(0, V, len(rois)).astype(np.int32)
    return feats, rois, views


def cells(rois):
    """(cols, rows) of each RoI in cells of its routed level."""
    lvl = roi_align.roi_levels(t(rois)).numpy()
    sc = 1.0 / np.asarray(STRIDES, np.float32)[lvl]
    return (rois[:, 2] - rois[:, 0]) * sc, (rois[:, 3] - rois[:, 1]) * sc


def pallas_capped(feats, rois):
    """RoIs whose adaptive count the Pallas patch kernel caps (an overflow
    RoI, long side > 61 cells, reaching past the map on its long axis;
    see tests/test_torch_port_align.py): held against the XLA form only."""
    cols, rows = cells(rois)
    h_max = max(f.shape[1] for f in feats)
    w_max = -(-max(f.shape[2] for f in feats) // 8) * 8
    over = np.maximum(cols, rows) > 61
    return over & ((np.ceil(rows / 7) > -(-h_max // 7))
                   | (np.ceil(cols / 7) > -(-w_max // 7)))


def xla(feats, rois, views, S):
    """JAX's exact XLA form, its sample lattice as wide as the largest
    adaptive count."""
    amax = int(np.ceil(np.maximum(*cells(rois)) / 7).max())
    return np.asarray(multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois),
        jnp.asarray(views), STRIDES, 7, S, adaptive_max=max(amax, 1)))


def stream(feats, rois, views, S, box=roi_align.STREAM_BOX):
    return roi_align.roi_align_stream_plain(
        [t(f) for f in feats], t(rois), t(views), STRIDES, S, box).numpy()


@pytest.mark.parametrize('sampling_ratio', [2, 0])
def test_stream_matches_pallas_and_xla(sampling_ratio):
    """The streamed walk against the Pallas flat kernel in interpret mode
    and the exact XLA form, on random and edge RoIs over four levels."""
    feats, rois, views = edge_case()
    got = stream(feats, rois, views, sampling_ratio)
    exact = xla(feats, rois, views, sampling_ratio)
    want = np.asarray(pallas_multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois),
        jnp.asarray(views), STRIDES, sampling_ratio=sampling_ratio,
        rois_per_step=4, interpret=True))
    assert len(set(roi_align.roi_levels(t(rois)).tolist())) == 4
    assert np.abs(got - exact).max() <= 1e-4 * np.abs(exact).max()
    keep = ~pallas_capped(feats, rois) if sampling_ratio == 0 else \
        np.ones(len(rois), bool)
    assert keep.sum() >= len(rois) - 2
    np.testing.assert_allclose(got[keep], want[keep], rtol=TOL, atol=TOL)
    # no sample inside the map: zeros (outside, and adaptive zero area)
    assert np.abs(got[17]).max() == 0
    assert (np.abs(got[18]).max() == 0) == (sampling_ratio == 0)


@pytest.mark.parametrize('box', [(2, 16), (1, 32), (4, 8), (3, 5)])
@pytest.mark.parametrize('sampling_ratio', [2, 0])
def test_stream_box_shapes_agree(box, sampling_ratio):
    """Any box the producer could issue, whether it divides a footprint or
    not, gives the plain flat function (1e-5 of the max: only the order of
    the sums differs)."""
    feats, rois, views = edge_case()
    got = stream(feats, rois, views, sampling_ratio, box)
    want = roi_align.multilevel_roi_align_flat_plain(
        [t(f) for f in feats], t(rois), t(views), STRIDES,
        sampling_ratio).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize('sampling_ratio', [2, 0])
def test_stream_level_wider_than_512(sampling_ratio):
    """A level of 560 cells a side at p2 (an image 2240 pixels wide), with
    slivers across it, against JAX's XLA form, which has no cap on a
    level's side."""
    rng = np.random.default_rng(5)
    img = (48, 2240)
    feats = levels(rng, 1, img)
    assert feats[0].shape[2] == 560
    rois = np.asarray([
        [0., 10., 2240., 14.],          # 560 x 1 cells at p2
        [1000., 0., 1120., 48.],        # 30 x 12 cells at p2
        [2100., 20., 2240., 40.],       # to the right edge, p2
        [10., 4., 1800., 40.],          # level 2, across most of it
        [2180., 30., 2300., 60.],       # past the bottom-right corner
    ], np.float32)
    views = np.zeros(len(rois), np.int32)
    assert int(roi_align.roi_levels(t(rois))[0]) == 0
    got = stream(feats, rois, views, sampling_ratio)
    exact = xla(feats, rois, views, sampling_ratio)
    assert np.abs(got - exact).max() <= 1e-4 * np.abs(exact).max()
    flat = roi_align.roi_align_flat([t(f) for f in feats], t(rois),
                                    t(views), STRIDES, sampling_ratio)
    assert np.abs(flat.numpy() - exact).max() <= 1e-4 * np.abs(exact).max()


@pytest.mark.parametrize('P', [1, 37, 200])
def test_slab_worklist_mirror(P):
    """B11's work list: each view lists each of its RoIs exactly once, the
    classes run smallest first and follow the long-side bounds 13 / 29 /
    61 cells at the routed level, and each class's run is padded to whole
    buckets within slab_slots(P)."""
    rng = np.random.default_rng(P)
    V, img = 3, (512, 1408)
    side = 16 * 2.0 ** rng.integers(0, 6, (V, P)) * rng.uniform(0.7, 1.4,
                                                                (V, P))
    asp = 2.0 ** rng.uniform(-2, 2, (V, P))
    cx, cy = rng.uniform(0, img[1], (V, P)), rng.uniform(0, img[0], (V, P))
    w, h = side / np.sqrt(asp), side * np.sqrt(asp)
    rois = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                    -1).astype(np.float32)
    order = roi_align.slab_worklist_plain(t(rois), STRIDES)
    Pp = roi_align.slab_slots(P)
    nb = roi_align.SLAB_BUCKET
    assert order.shape == (V, Pp) and Pp % nb == 0
    lvl = roi_align.roi_levels(t(rois).reshape(-1, 4)).numpy().reshape(V, P)
    long_side = np.maximum(w, h) / np.asarray(STRIDES)[lvl]
    want_cls = (long_side[..., None] >
                np.asarray(roi_align.SLAB_CLASS_CELLS)).sum(-1)
    for v in range(V):
        o = order[v].numpy()
        live = o[o >= 0]
        assert sorted(live.tolist()) == list(range(P))
        cls = np.full(Pp, -1)
        cls[o >= 0] = want_cls[v, live]
        for b in range(Pp // nb):       # a bucket holds one class
            k = set(cls[b * nb:(b + 1) * nb][o[b * nb:(b + 1) * nb] >= 0])
            assert len(k) <= 1
        runs = [c for c in cls if c >= 0]
        assert runs == sorted(runs)     # classes in order, smallest first
        for k in range(roi_align.SLAB_CLASSES):
            at = np.nonzero(cls == k)[0]
            if at.size:                 # a run starts on a bucket
                assert at[0] % nb == 0
                assert at[-1] - at[0] + 1 == at.size


@pytest.mark.parametrize('sampling_ratio', [2, 0])
def test_read_bytes_count_the_footprints_once(sampling_ratio):
    """The bound's bytes: the cells of each (view, level) that some RoI's
    footprint covers (the rows and columns `roi_align_stream_plain`
    walks), each once, times C and the element size; zero for RoIs with
    no sample inside the map."""
    feats, rois, views = edge_case()
    lvl = roi_align.roi_levels(t(rois)).tolist()
    seen = set()
    for r, b in enumerate(rois.tolist()):
        f = feats[lvl[r]]
        sc = 1.0 / STRIDES[lvl[r]]
        _, ry = roi_align._stream_axis(
            float(torch.tensor(b[1]) * sc - 0.5),
            float(torch.tensor(b[3] - b[1]) * sc), sampling_ratio,
            f.shape[1])
        _, rx = roi_align._stream_axis(
            float(torch.tensor(b[0]) * sc - 0.5),
            float(torch.tensor(b[2] - b[0]) * sc), sampling_ratio,
            f.shape[2])
        seen |= {(lvl[r], int(views[r]), y, x)
                 for y in range(int(ry[:, 0].min()), int(ry[:, 1].max()) + 1)
                 for x in range(int(rx[:, 0].min()), int(rx[:, 1].max()) + 1)}
    got = chip_smoke.roi_read_bytes([t(f) for f in feats], t(rois),
                                    t(views), STRIDES, sampling_ratio)
    assert got == len(seen) * feats[0].shape[-1] * 4
    assert 0 < len(seen) < sum(f[..., 0].size for f in feats)
    outside = chip_smoke.roi_read_bytes([t(f) for f in feats],
                                        t(rois[17:18]), t(views[17:18]),
                                        STRIDES, sampling_ratio)
    assert outside == 0
