"""The training path's kernel modules (plain versions, as run on the CPU)
against the JAX package's Pallas training kernels in interpret mode.

  * ops/dcn `dcn_samples` (kernels B5 / B6 on CUDA) against
    `pallas_dcn.dcn_modulated_samples`: forward and jax.vjp;
  * ops/attention `masked_attention_train` (K4 / B8) against
    `pallas_attention.masked_flash_attention(sparse=False)`;
  * ops/roi_align `roi_align_multilevel_train` (K3 / B9) against
    `pallas_roi_align.pallas_roi_align_views_train`, whose compacted slots
    are put back in [V, P] order through its `pos`.

The same seeded numpy inputs and cotangents go to both; the port's
gradients come from autograd.  Tolerance: float32, 1e-4 of the max
magnitude of each output and gradient.

One known difference (ROADMAP C): a DCN sample coordinate exactly on the
map's first or last row or column (0 or extent - 1) sits on the clamp's
bound, where the packages take different subgradients.  JAX's jnp.clip
splits the tie and halves the derivative, and its parity-block gather
sees a zero pixel beyond the last column.  The port differentiates its
plain version: the clamp passes the derivative, and past the last pixel
there is no neighbour, so at 0 its dsy / dsx are exactly twice JAX's and
at extent - 1 they are 0.  Zero offsets put many samples on the bounds;
the test holds them to those values and every other sample to the
tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu.ops.pallas_attention import masked_flash_attention  # noqa
from mv2d_tpu.ops.pallas_dcn import dcn_modulated_samples  # noqa: E402
from mv2d_tpu.ops.pallas_roi_align import pallas_roi_align_views_train  # noqa
from mv2d_tpu_torch.ops import attention, dcn, roi_align  # noqa: E402

REL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def leaves(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


# ------------------------------------------------------------ B5 / B6

def dcn_case(rng, stride, offsets):
    V, H, W, C = 2, 16, 24, 128
    Ho, Wo = H // stride, W // stride
    x = rng.normal(size=(V, H, W, C)).astype(np.float32)
    ky, kx = np.meshgrid(np.arange(3), np.arange(3), indexing='ij')
    by = (np.arange(Ho) * stride - 1)[:, None, None] + ky.reshape(-1)
    bx = (np.arange(Wo) * stride - 1)[None, :, None] + kx.reshape(-1)
    off = np.zeros((V, Ho, Wo, 9, 2))
    if offsets == 'random':
        off = rng.normal(0, 2.0, off.shape)
    elif offsets == 'far':
        off = rng.normal(0, 2.0, off.shape)
        far = rng.uniform(size=off.shape[:-1]) < 0.2
        off[far] += [40.0, -60.0]
    sy = (by[None] + off[..., 0]).astype(np.float32)
    sx = (bx[None] + off[..., 1]).astype(np.float32)
    m = rng.uniform(size=(V, Ho, Wo, 9)).astype(np.float32)
    g = rng.normal(size=(V, Ho, Wo, 9, C)).astype(np.float32)
    return x, sy, sx, m, g


@pytest.mark.parametrize('stride,offsets', [
    (1, 'random'), (2, 'random'), (1, 'far'), (1, 'zero'), (2, 'zero')])
def test_dcn_samples_matches_pallas(stride, offsets):
    rng = np.random.default_rng(stride + len(offsets))
    x, sy, sx, m, g = dcn_case(rng, stride, offsets)
    V, Ho, Wo, _, C = g.shape

    def fwd(*a):
        return dcn_modulated_samples(*a, stride=stride, interpret=True)

    want, vjp = jax.vjp(fwd, *map(jnp.asarray, (x, sy, sx, m)))
    wgrads = vjp(jnp.asarray(g.reshape(V, Ho, Wo, 9 * C)))
    tx, tsy, tsx, tm = leaves(x, sy, sx, m)
    got = dcn.dcn_samples(tx, tsy, tsx, tm)
    got.backward(torch.from_numpy(g))
    assert rel_err(got.detach().numpy().reshape(V, Ho, Wo, 9 * C),
                   want) < REL
    assert rel_err(tx.grad.numpy(), wgrads[0]) < REL
    assert rel_err(tm.grad.numpy(), wgrads[3]) < REL
    for coord, extent, tg, wg in ((sy, x.shape[1], tsy.grad.numpy(),
                                   wgrads[1]),
                                  (sx, x.shape[2], tsx.grad.numpy(),
                                   wgrads[2])):
        first, last = coord == 0.0, coord == extent - 1.0
        edge = first | last
        wg = np.asarray(wg)
        assert rel_err(np.where(edge, 0, tg), np.where(edge, 0, wg)) < REL
        assert np.abs(tg[first] - 2 * wg[first]).max(initial=0) \
            <= REL * np.abs(wg).max()
        assert np.all(tg[last] == 0)
        assert (offsets == 'zero') == bool(first.any() and last.any())


# ---------------------------------------------------------- K4 / B8

@pytest.mark.parametrize('Q,K,C,H', [(48, 256, 64, 4), (40, 200, 32, 2)])
def test_masked_attention_train_matches_pallas(Q, K, C, H):
    rng = np.random.default_rng(Q)
    q, k, v = (rng.normal(size=(n, C)).astype(np.float32)
               for n in (Q, K, K))
    allowed = rng.uniform(size=(Q, K)) < 0.3
    allowed[:5] = False                          # rows with no key
    allowed[:, :16] = False                      # keys no row may attend
    cot = rng.normal(size=(Q, C)).astype(np.float32)

    def fwd(q_, k_, v_):
        return masked_flash_attention(q_, k_, v_, jnp.asarray(allowed), H,
                                      block_q=16, block_k=64,
                                      interpret=True, sparse=False)

    want, vjp = jax.vjp(fwd, *map(jnp.asarray, (q, k, v)))
    wgrads = vjp(jnp.asarray(cot))
    tq, tk, tv = leaves(q, k, v)
    got = attention.masked_attention_train(tq, tk, tv,
                                           torch.from_numpy(allowed), H)
    got.backward(torch.from_numpy(cot))
    assert rel_err(got.detach().numpy(), want) < REL
    for tg, wg in zip((tq, tk, tv), wgrads):
        assert rel_err(tg.grad.numpy(), wg) < REL
    assert np.all(got.detach().numpy()[:5] == 0)
    assert np.all(tq.grad.numpy()[:5] == 0)
    assert np.all(tk.grad.numpy()[:16] == 0)


def test_attention_lse_plain_is_logsumexp():
    """K4's second output, in its plain form: the row's log-sum-exp of the
    allowed scaled logits, the flag value for an empty row."""
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
            for n in (6, 9))
    allowed = torch.from_numpy(rng.uniform(size=(6, 9)) < 0.5)
    allowed[0] = False
    lse = attention.attention_lse_plain(q, k, allowed, 2)
    s = (q.reshape(6, 2, 8)[:, :, None] * k.reshape(9, 2, 8).transpose(
        0, 1)[None]).sum(-1) / 8 ** 0.5                       # [6, 2, 9]
    for i in range(1, 6):
        for h in range(2):
            want = torch.logsumexp(s[i, h][allowed[i]], 0)
            assert abs(float(lse[i, h] - want)) < 1e-5
    assert torch.all(lse[0] == attention.EMPTY_LSE)


# ---------------------------------------------------------- K3 / B9

def test_roi_align_train_matches_pallas():
    rng = np.random.default_rng(0)
    strides = (4, 8, 16, 32)
    img = (128, 320)
    V, P, C = 2, 12, 8
    feats = [rng.normal(size=(V, img[0] // s, img[1] // s, C))
             .astype(np.float32) for s in strides]
    xy = rng.uniform(0, 200, (V, P, 2))
    wh = rng.uniform(4, 120, (V, P, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[0, 0] = [0, 60, 320, 68]                # 320 x 8
    rois[0, 1] = [100, 0, 104, 128]              # 4 x 128
    rois[1, 2] = [50, 50, 50, 50]                # empty
    rois[1, 3] = [-40, -30, 60, 50]              # partly outside
    rois[1, 4] = [-20, -20, 300, 150]            # level 2
    rois[1, 5] = [10, 10, 150, 150]              # level 1
    rois[0, 5] = [-100, -100, 500, 300]          # level 3, partly outside
    cot = rng.normal(size=(V, P, 7, 7, C)).astype(np.float32)

    def fwd(*fs):
        out, pos = pallas_roi_align_views_train(
            list(fs), jnp.asarray(rois), strides, sampling_ratio=0,
            interpret=True)
        return jnp.take_along_axis(out, pos[:, :, None, None, None], 1)

    want, vjp = jax.vjp(fwd, *map(jnp.asarray, feats))
    wgrads = vjp(jnp.asarray(cot))
    tf = leaves(*feats)
    got = roi_align.roi_align_multilevel_train(tf, torch.from_numpy(rois),
                                               strides)
    got.backward(torch.from_numpy(cot))
    assert rel_err(got.detach().numpy(), want) < REL
    assert set(roi_align.roi_levels(torch.from_numpy(rois)).flatten()
               .tolist()) == {0, 1, 2, 3}
    for tg, wg in zip(tf, wgrads):
        assert rel_err(tg.grad.numpy(), wg) < REL
