"""B6's owner scheme (ops/dcn), in its plain PyTorch form, at toy shapes.

Kernel B6 gives every element of the DCN input gradient dx one owner: the
map is cut into 2 x 2 pixel blocks, an index pass lists for each block the
samples with a corner in it (sorted by block, ties in sample order), and
the owner of a block sums their contributions.  `owner_blocks_plain` is
that index pass and `dcn_samples_backward` on CPU tensors runs the whole
scheme in PyTorch.  Checked here:

  * the lists cover each corner of each sample inside the map exactly
    once (every corner, also one whose dx weight is 0: the coordinate
    derivative reads x there), hold no other entry, and are in order;
  * the gather over them equals the autograd gradients of
    `dcn_samples_plain` (dx, dsy, dsx, dm), with far offsets, integer
    coordinates, a pile-up of every sample on one cell and a ragged map.

Inputs are seeded numpy arrays.  Tolerance: float32, 1e-5 of each
output's max magnitude (the two differ only in the order of float32 sums).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from mv2d_tpu_torch.ops import dcn                       # noqa: E402

REL = 1e-5


def samples(V, H, W, C, stride, kind, seed=0):
    """x [V, H, W, C]; sy, sx, m [V, Ho, Wo, 9] around the 3x3 stride grid
    with N(0, 2) offsets; `kind` moves them: 'far' sends 30% well outside,
    'integer' rounds them, 'pile' puts every sample inside the map on the
    cell (5, 7)."""
    rng = np.random.default_rng(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    k = np.arange(3.0)
    by = (np.arange(Ho) * stride - 1.0)[:, None, None] + np.repeat(k, 3)
    bx = (np.arange(Wo) * stride - 1.0)[None, :, None] + np.tile(k, 3)
    sy = by[None] + 2 * rng.standard_normal((V, Ho, Wo, 9))
    sx = bx[None] + 2 * rng.standard_normal((V, Ho, Wo, 9))
    if kind == 'far':
        jump = rng.random(sy.shape) < 0.3
        sy = np.where(jump, sy + (H + 50) * np.sign(rng.standard_normal(
            sy.shape)), sy)
        sx = np.where(jump, sx - (W + 80), sx)
    elif kind == 'integer':
        sy, sx = np.round(sy), np.round(sx)
    elif kind == 'pile':
        inside = (sy > -1) & (sy < H) & (sx > -1) & (sx < W)
        sy = np.where(inside, 5.25, sy)
        sx = np.where(inside, 7.5, sx)
    m = rng.random(sy.shape)
    x = rng.standard_normal((V, H, W, C))
    ds = rng.standard_normal((V, Ho, Wo, 9, C))
    return [torch.tensor(a, dtype=torch.float32) for a in (x, sy, sx, m, ds)]


CASES = [(2, 11, 19, 8, 1, 'normal'), (2, 11, 19, 8, 2, 'normal'),
         (2, 11, 19, 8, 1, 'far'), (2, 11, 19, 8, 1, 'integer'),
         (2, 11, 19, 8, 1, 'pile'), (1, 13, 21, 40, 1, 'normal')]


@pytest.mark.parametrize('V,H,W,C,stride,kind', CASES)
def test_owner_lists_cover_each_corner_once(V, H, W, C, stride, kind):
    _, sy, sx, _, _ = samples(V, H, W, C, stride, kind)
    keys, samp, starts = dcn.owner_blocks_plain(sy, sx, H, W)
    Hb, Wb = -(-H // 2), -(-W // 2)
    # in order: keys ascending, samples ascending within a block
    assert bool((keys[1:] >= keys[:-1]).all())
    same = keys[1:] == keys[:-1]
    assert bool((samp[1:][same] > samp[:-1][same]).all())
    assert starts[0] == 0 and starts[-1] == keys.numel()
    for k in range(V * Hb * Wb):
        assert bool((keys[starts[k]:starts[k + 1]] == k).all())
    listed = set(zip(samp.tolist(), keys.tolist()))
    assert len(listed) == keys.numel()              # no entry twice
    # every corner of every sample inside the map, and nothing else
    fy, fx = sy.reshape(-1), sx.reshape(-1)
    per_view = sy[0].numel()
    want = set()
    for p in range(fy.numel()):
        y, xx = float(fy[p]), float(fx[p])
        if not (-1 < y < H and -1 < xx < W):
            continue
        y0 = int(np.floor(min(max(y, 0.0), H - 1)))
        x0 = int(np.floor(min(max(xx, 0.0), W - 1)))
        for cy in (y0, min(y0 + 1, H - 1)):
            for cx in (x0, min(x0 + 1, W - 1)):
                want.add((p, ((p // per_view) * Hb + cy // 2) * Wb + cx // 2))
    assert listed == want
    if kind == 'pile':                  # a few blocks hold every sample
        longest = int((starts[1:] - starts[:-1]).max())
        assert longest >= len({p for p, _ in want}) // V


@pytest.mark.parametrize('V,H,W,C,stride,kind', CASES)
def test_owner_gather_equals_autograd(V, H, W, C, stride, kind):
    x, sy, sx, m, ds = samples(V, H, W, C, stride, kind)
    leaves = [t.clone().requires_grad_(True) for t in (x, sy, sx, m)]
    out = dcn.dcn_samples_plain(*leaves)
    want = torch.autograd.grad(out, leaves, ds)
    got = dcn.dcn_samples_backward(x, sy, sx, m, ds)
    assert got[0].dtype == x.dtype
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = (g - w).abs().max().item()
        assert err <= REL * max(w.abs().max().item(), 1e-6), err
