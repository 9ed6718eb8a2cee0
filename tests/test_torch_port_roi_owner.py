"""B9's owner scheme (ops/roi_align), in its plain PyTorch form, at toy shapes.

Kernel B9 gives every cell of the four level gradients one owner: each
(view, level) map is cut into OWNER_TILE x OWNER_TILE cell tiles, an index
pass gives each RoI its level and its footprint (the cells its samples
touch), each tile lists the RoIs whose footprint meets it, in RoI order,
and the tile's owner sums their separable contributions.
`roi_footprints_plain` and `roi_owner_lists_plain` are that index pass and
those lists, and `roi_align_multilevel_backward` on CPU tensors runs the
whole scheme in PyTorch.  Checked here:

  * each (RoI, tile) pair whose footprint meets the tile is listed exactly
    once, in RoI order, and nothing else; the footprints come from a numpy
    walk over every sample of every RoI;
  * the gather equals the autograd gradients of `multilevel_roi_align_plain`
    (float32, 1e-5 of each level's max magnitude: the two differ only in
    the order of float32 sums), and comes back in the features' dtype;
  * the gather equals the JAX VJP of `pallas_roi_align_views_train` in
    interpret mode on slivers, an empty RoI, RoIs partly outside the image,
    all four levels and a pile-up (float32, 1e-4 of each level's max
    magnitude, the port's tolerance against JAX).

Inputs are seeded numpy arrays: V=2 views, C=8 channels, a 128x320 image.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu.ops.pallas_roi_align import pallas_roi_align_views_train  # noqa
from mv2d_tpu_torch.ops import roi_align                 # noqa: E402

STRIDES = (4, 8, 16, 32)
IMG = (128, 320)
V, C = 2, 8
REL_PLAIN = 1e-5
REL_JAX = 1e-4


def case(kind, seed=0):
    """Level maps [V, H_l, W_l, C], RoIs [V, P, 4] and a cotangent
    [V, P, 7, 7, C].  'random': 12 RoIs a view of 4-120 pixels a side;
    'edge': those with slivers, an empty RoI, RoIs partly outside the
    image and one on each level; 'pile': 'edge' with 24 RoIs a view, the
    last 18 on one box; 'many': 40 RoIs a view of 2-320 pixels a side."""
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(V, IMG[0] // s, IMG[1] // s, C))
             .astype(np.float32) for s in STRIDES]
    P, top = {'many': (40, 320), 'pile': (24, 120)}.get(kind, (12, 120))
    xy = rng.uniform(0, 200, (V, P, 2))
    wh = rng.uniform(2 if kind == 'many' else 4, top, (V, P, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if kind in ('edge', 'pile'):
        rois[0, 0] = [0, 60, 320, 68]                # 320 x 8
        rois[0, 1] = [100, 0, 104, 128]              # 4 x 128
        rois[1, 2] = [50, 50, 50, 50]                # empty
        rois[1, 3] = [-40, -30, 60, 50]              # partly outside
        rois[1, 4] = [-20, -20, 300, 150]            # level 2
        rois[1, 5] = [10, 10, 150, 150]              # level 1
        rois[0, 5] = [-100, -100, 500, 300]          # level 3, outside
    if kind == 'pile':
        rois[:, 6:] = [20, 10, 180, 130]             # 18 a view, level 1
    cot = rng.normal(size=(V, P, 7, 7, C)).astype(np.float32)
    return feats, rois, cot


def footprint(lo, extent, n):
    """[lo, hi] cells of one axis of a RoI, by walking its samples in
    float32 as the kernel does; None without a sample inside."""
    f32 = np.float32
    bin_ = f32(extent) / f32(7)
    ns = max(int(np.ceil(bin_)), 0)
    div = f32(max(ns, 1))
    cells = []
    for i in range(7):
        for s in range(ns):
            p = f32(lo) + (f32(i) + (f32(s) + f32(0.5)) / div) * bin_
            if not (-1 < p < n):
                continue
            c0 = int(np.floor(min(max(p, f32(0)), f32(n - 1))))
            cells += [c0, min(c0 + 1, n - 1)]
    return (min(cells), max(cells)) if cells else None


def expected_pairs(rois, dims):
    """{(roi, tile key)} from numpy footprints, tiles numbered as B9's
    blocks: coarsest level first, view-major, row-major."""
    T = roi_align.OWNER_TILE
    flat = rois.reshape(-1, 4)
    lvl = roi_align.roi_levels(torch.from_numpy(flat)).numpy()
    tyn = [-(-dims[2 * l] // T) for l in range(4)]
    txn = [-(-dims[2 * l + 1] // T) for l in range(4)]
    first, at = [0] * 4, 0
    for l in (3, 2, 1, 0):
        first[l] = at
        at += V * tyn[l] * txn[l]
    P = rois.shape[1]
    want = set()
    for r, b in enumerate(flat):
        l = int(lvl[r])
        sc = np.float32(1.0) / np.float32(STRIDES[l])
        ys = footprint(b[1] * sc - np.float32(0.5), (b[3] - b[1]) * sc,
                       dims[2 * l])
        xs = footprint(b[0] * sc - np.float32(0.5), (b[2] - b[0]) * sc,
                       dims[2 * l + 1])
        if ys is None or xs is None:
            continue
        for ty in range(ys[0] // T, ys[1] // T + 1):
            for tx in range(xs[0] // T, xs[1] // T + 1):
                want.add((r, first[l] + r // P * tyn[l] * txn[l]
                          + ty * txn[l] + tx))
    return want, at


@pytest.mark.parametrize('kind', ['random', 'edge', 'pile', 'many'])
def test_owner_lists_hold_each_meeting_pair_once(kind):
    feats, rois, _ = case(kind)
    dims = [d for f in feats for d in f.shape[1:3]]
    keys, roi, starts = roi_align.roi_owner_lists_plain(
        torch.from_numpy(rois), dims, STRIDES)
    want, ntiles = expected_pairs(rois, dims)
    # in order: keys ascending, RoIs ascending within a tile
    assert bool((keys[1:] >= keys[:-1]).all())
    same = keys[1:] == keys[:-1]
    assert bool((roi[1:][same] > roi[:-1][same]).all())
    assert starts.numel() == ntiles + 1
    assert starts[0] == 0 and starts[-1] == keys.numel()
    for k in range(ntiles):
        assert bool((keys[starts[k]:starts[k + 1]] == k).all())
    listed = list(zip(roi.tolist(), keys.tolist()))
    assert len(set(listed)) == len(listed)          # no pair twice
    assert set(listed) == want
    if kind == 'pile':                  # a tile lists the 18 of one box
        assert int((starts[1:] - starts[:-1]).max()) >= 18


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


@pytest.mark.parametrize('kind', ['random', 'edge', 'pile', 'many'])
def test_owner_gather_equals_autograd(kind):
    feats, rois, cot = case(kind)
    tf = [torch.from_numpy(f) for f in feats]
    tr = torch.from_numpy(rois)
    leaves = [f.clone().requires_grad_(True) for f in tf]
    out = roi_align.multilevel_roi_align_plain(leaves, tr, STRIDES)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(cot),
                               allow_unused=True)
    got = roi_align.roi_align_multilevel_backward(tf, tr,
                                                  torch.from_numpy(cot),
                                                  STRIDES)
    for f, g, w in zip(tf, got, want):
        assert g.dtype == f.dtype
        w = torch.zeros_like(f) if w is None else w
        assert rel(g, w) <= REL_PLAIN


def test_owner_gather_keeps_the_features_dtype():
    feats, rois, cot = case('edge')
    tf = [torch.from_numpy(f).bfloat16() for f in feats]
    got = roi_align.roi_align_multilevel_backward(
        tf, torch.from_numpy(rois), torch.from_numpy(cot).bfloat16(),
        STRIDES)
    want = roi_align.roi_align_multilevel_backward(
        [f.float() for f in tf], torch.from_numpy(rois),
        torch.from_numpy(cot).bfloat16().float(), STRIDES)
    for f, g, w in zip(tf, got, want):
        assert g.dtype == torch.bfloat16 and g.shape == f.shape
        assert torch.equal(g, w.bfloat16())


@pytest.mark.parametrize('kind', ['edge', 'pile'])
def test_owner_gather_equals_pallas_vjp(kind):
    feats, rois, cot = case(kind)

    def fwd(*fs):
        out, pos = pallas_roi_align_views_train(
            list(fs), jnp.asarray(rois), STRIDES, sampling_ratio=0,
            interpret=True)
        return jnp.take_along_axis(out, pos[:, :, None, None, None], 1)

    _, vjp = jax.vjp(fwd, *map(jnp.asarray, feats))
    want = vjp(jnp.asarray(cot))
    got = roi_align.roi_align_multilevel_backward(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
        torch.from_numpy(cot), STRIDES)
    assert set(roi_align.roi_levels(torch.from_numpy(rois)).flatten()
               .tolist()) == {0, 1, 2, 3}
    for g, w in zip(got, want):
        assert rel(g.numpy(), w) <= REL_JAX
