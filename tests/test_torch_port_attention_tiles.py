"""The packed mask K4 and B8 read (`ops.attention.mask_tiles`), on the CPU.

  * `mask_bits_plain` (the plain version of the packing kernel) against
    numpy.packbits, and `mask_from_bits` back;
  * the two CSR lists of active 64x64 tiles against JAX's
    `pallas_attention._sparse_blocks` at 64-wide tiles (key tiles per
    query tile, and, on the transposed mask, query tiles per key tile);
  * a tile-walking form of the forward, its log-sum-exp and the backward
    that reads only the bits and visits only the listed tiles, as K4 and
    B8 do (K4: each query tile's key tiles with an online softmax; B8: dK
    / dV per key tile over its query tiles, dQ per query tile over its key
    tiles).  It equals `masked_flash_attention(sparse=True)` in interpret
    mode (5e-3, the Pallas kernel's own test tolerance) and the dense plain
    version with its autograd (1e-5 of the max magnitude), which shows
    that walking the lists skips nothing.

Ragged Q and K, rows with no key, keys that no row may attend, and fully
dense DN-like rows; head dims 8, 16 and 32 (the kernels pad 8 and 16 to
the mma depth).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu.ops.pallas_attention import (_sparse_blocks,  # noqa: E402
                                           masked_flash_attention)
from mv2d_tpu_torch.ops import attention                 # noqa: E402

T = attention.SPARSE_TILE
WALK_REL = 1e-5


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def make_mask(Q, K, seed, density=0.03):
    """Sparse random runs, 6 fully dense DN-like rows over the valid keys,
    3 rows with no key, the last 70 keys attended by no row."""
    rng = np.random.default_rng(seed)
    allowed = rng.uniform(size=(Q, K)) < density
    starts = rng.integers(0, K, size=Q)
    for i, s in enumerate(starts):
        allowed[i, s:s + rng.integers(5, 60)] = True
    allowed[:6] = True                         # dense rows
    allowed[[7, Q // 2, Q - 1]] = False        # rows with no key
    allowed[:, K - 70:] = False                # keys no row may attend
    return allowed


def jax_blocks(allowed):
    """JAX's _sparse_blocks at 64x64 tiles -> (counts, [nQ, nK] lists)."""
    Q, K = allowed.shape
    Qp, Kp = -(-Q // T) * T, -(-K // T) * T
    padded = np.zeros((Qp, Kp), np.int32)
    padded[:Q, :K] = allowed
    counts, idx = _sparse_blocks(jnp.asarray(padded),
                                 (Q, K, 1, 8, T, Qp, Kp), T)
    return np.asarray(counts), np.asarray(idx).reshape(Qp // T, -1)


SHAPES = [(100, 300), (64, 64), (37, 1000), (130, 129)]


@pytest.mark.parametrize('Q,K', SHAPES)
def test_mask_bits_plain_matches_packbits(Q, K):
    allowed = make_mask(Q, K, Q + K)
    bits = attention.mask_bits_plain(torch.from_numpy(allowed))
    nw = -(-K // T)
    assert bits.dtype == torch.uint64 and bits.shape == (Q, nw)
    padded = np.zeros((Q, nw * T), bool)
    padded[:, :K] = allowed
    want = np.packbits(padded, axis=1, bitorder='little').view('<u8')
    assert np.array_equal(bits.view(torch.int64).numpy().view(np.uint64),
                          want)
    back = attention.mask_from_bits(bits, K)
    assert torch.equal(back, torch.from_numpy(allowed))


@pytest.mark.parametrize('Q,K', SHAPES)
def test_mask_tiles_lists_match_jax_blocks(Q, K):
    allowed = make_mask(Q, K, 2 * Q + K)
    allowed[T:2 * T] = False                   # an empty query tile
    tiles = attention.mask_tiles(torch.from_numpy(allowed))
    assert tiles.bits.shape == (Q, -(-K // T))
    for starts, lst, mask in (
            (tiles.key_starts, tiles.key_tiles, allowed),
            (tiles.query_starts, tiles.query_tiles, allowed.T)):
        starts, lst = starts.numpy(), lst.numpy()
        counts, idx = jax_blocks(mask)
        assert starts.dtype == np.int32 and lst.dtype == np.int32
        assert starts[0] == 0 and np.array_equal(np.diff(starts), counts)
        for i, n in enumerate(counts):
            assert np.array_equal(lst[starts[i]:starts[i + 1]], idx[i, :n])


# ---------------------------------------------- the kernels' walk, plain

def tile_mask(bits, qt, kt, Q, K):
    """The [64, 64] mask of tile (qt, kt) from the bits alone (rows and
    keys past Q / K false)."""
    rows = bits.view(torch.int64)[qt * T:(qt + 1) * T, kt]
    m = ((rows[:, None] >> torch.arange(T)) & 1).bool()
    out = torch.zeros(T, T, dtype=torch.bool)
    out[:m.shape[0]] = m
    out[:, max(0, K - kt * T):] = False
    return out


def heads(x, H):
    """[N, H*D] -> [H, Np, D] zero-padded to whole tiles."""
    N, C = x.shape
    Np = -(-N // T) * T
    out = torch.zeros(Np, C, dtype=torch.float64)
    out[:N] = x.double()
    return out.view(Np, H, C // H).transpose(0, 1)


def walk_forward(q, k, v, tiles, H):
    """K4's walk: per query tile, its listed key tiles, online softmax ->
    (out [Q, C], lse [Q, H] with EMPTY_LSE for a row with no key)."""
    Q, C = q.shape
    K = k.shape[0]
    D = C // H
    qh, kh, vh = heads(q, H) / D ** 0.5, heads(k, H), heads(v, H)
    out = torch.zeros_like(qh)
    lse = torch.full((H, qh.shape[1]), attention.EMPTY_LSE,
                     dtype=torch.float64)
    st, lst = tiles.key_starts, tiles.key_tiles
    for qt in range(len(st) - 1):
        rq = slice(qt * T, (qt + 1) * T)
        m = torch.full((H, T, 1), -1e30, dtype=torch.float64)
        acc = torch.zeros(H, T, D, dtype=torch.float64)
        lsum = torch.zeros(H, T, 1, dtype=torch.float64)
        for i in range(int(st[qt]), int(st[qt + 1])):
            kt = int(lst[i])
            rk = slice(kt * T, (kt + 1) * T)
            msk = tile_mask(tiles.bits, qt, kt, Q, K)
            s = (qh[:, rq] @ kh[:, rk].transpose(1, 2)).masked_fill(
                ~msk, float('-inf'))
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            a = torch.exp(m - mn)
            p = torch.exp(s - mn)
            lsum = lsum * a + p.sum(-1, keepdim=True)
            acc = acc * a + p @ vh[:, rk]
            m = mn
        out[:, rq] = acc / lsum.clamp(min=1e-300)
        lse[:, rq] = torch.where(lsum[..., 0] > 0,
                                 m[..., 0] + lsum[..., 0].log(),
                                 lse[:, rq])
    return (out.transpose(0, 1).reshape(-1, C)[:Q],
            lse.transpose(0, 1)[:Q])


def walk_backward(q, k, v, out, lse, dout, tiles, H):
    """B8's walk: dK / dV per key tile over its listed query tiles, dQ per
    query tile over its listed key tiles, P from the lse and the bits."""
    Q, C = q.shape
    K = k.shape[0]
    D = C // H
    s_ = D ** -0.5
    qh, kh, vh, gh = (heads(x, H) for x in (q, k, v, dout))
    lh = torch.zeros(H, qh.shape[1], 1, dtype=torch.float64)
    lh[:, :Q, 0] = lse.double().t()
    dl = torch.zeros_like(lh)
    dl[:, :Q, 0] = (out.double() * dout.double()).view(Q, H, D).sum(-1).t()

    def p_ds(qt, kt):
        rq, rk = slice(qt * T, (qt + 1) * T), slice(kt * T, (kt + 1) * T)
        msk = tile_mask(tiles.bits, qt, kt, Q, K)
        p = torch.exp(qh[:, rq] @ kh[:, rk].transpose(1, 2) * s_ - lh[:, rq])
        p = p.masked_fill(~msk, 0.0)
        ds = p * (gh[:, rq] @ vh[:, rk].transpose(1, 2) - dl[:, rq])
        return rq, rk, p, ds

    dq, dk, dv = (torch.zeros_like(x) for x in (qh, kh, vh))
    qs, ql = tiles.query_starts, tiles.query_tiles
    for kt in range(len(qs) - 1):
        for i in range(int(qs[kt]), int(qs[kt + 1])):
            rq, rk, p, ds = p_ds(int(ql[i]), kt)
            dv[:, rk] += p.transpose(1, 2) @ gh[:, rq]
            dk[:, rk] += ds.transpose(1, 2) @ qh[:, rq] * s_
    ks, kl = tiles.key_starts, tiles.key_tiles
    for qt in range(len(ks) - 1):
        for i in range(int(ks[qt]), int(ks[qt + 1])):
            rq, rk, p, ds = p_ds(qt, int(kl[i]))
            dq[:, rq] += ds @ kh[:, rk] * s_
    return [x.transpose(0, 1).reshape(-1, C)[:n]
            for x, n in ((dq, Q), (dk, K), (dv, K))]


@pytest.mark.parametrize('Q,K,H,D', [(100, 300, 4, 16), (130, 129, 2, 8),
                                     (37, 200, 1, 32)])
def test_tile_walk_equals_pallas_and_plain(Q, K, H, D):
    rng = np.random.default_rng(Q * K + D)
    C = H * D
    q, k, v = (rng.normal(size=(n, C)).astype(np.float32) for n in (Q, K, K))
    cot = rng.normal(size=(Q, C)).astype(np.float32)
    allowed = make_mask(Q, K, Q + 3 * K)
    ta = torch.from_numpy(allowed)
    tiles = attention.mask_tiles(ta)

    out, lse = walk_forward(*map(torch.from_numpy, (q, k, v)), tiles, H)
    grads = walk_backward(*map(torch.from_numpy, (q, k, v)), out, lse,
                          torch.from_numpy(cot), tiles, H)

    # the dense plain version and its autograd
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    plain = attention.masked_attention_plain(*leaves, ta, H)
    plain.backward(torch.from_numpy(cot))
    plse = attention.attention_lse_plain(leaves[0].detach(),
                                         leaves[1].detach(), ta, H)
    assert rel_err(out, plain.detach()) < WALK_REL
    assert rel_err(lse, plse) < WALK_REL
    for g, leaf in zip(grads, leaves):
        assert rel_err(g, leaf.grad) < WALK_REL
    empty = ~allowed.any(1)
    assert empty.any() and np.all(out.numpy()[empty] == 0)
    assert np.all(lse.numpy()[empty] == attention.EMPTY_LSE)
    assert np.all(grads[0].numpy()[empty] == 0)
    assert np.all(grads[1].numpy()[K - 70:] == 0)
    assert np.all(grads[2].numpy()[K - 70:] == 0)

    # the block-sparse Pallas kernel (interpret mode), forward and VJP
    def pallas(q_, k_, v_):
        return masked_flash_attention(q_, k_, v_, jnp.asarray(allowed), H,
                                      block_k=T, interpret=True, sparse=True)

    want, vjp = jax.vjp(pallas, *map(jnp.asarray, (q, k, v)))
    wgrads = vjp(jnp.asarray(cot))
    for g, w in zip([out, *grads], [want, *wgrads]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-3,
                                   atol=5e-3)


def test_wrappers_ignore_tiles_on_cpu():
    """On the CPU the plain version runs and the tiles are not read."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(n, 32)).astype(np.float32))
               for n in (20, 70, 70))
    allowed = torch.from_numpy(make_mask(20, 70, 1, 0.2))
    bogus = attention.MaskTiles(*(torch.zeros(1) for _ in range(5)))
    want = attention.masked_attention_plain(q, k, v, allowed, 4)
    before = attention.mask_bits.launches
    assert torch.equal(attention.masked_attention(q, k, v, allowed, 4, bogus),
                       want)
    assert torch.equal(attention.masked_attention_train(
        q, k, v, allowed, 4, False, bogus), want)
    assert attention.mask_bits.launches == before
    tiles = attention.mask_tiles(allowed)
    assert torch.equal(tiles.bits, attention.mask_bits_plain(allowed))
    assert attention.mask_bits.launches == before
