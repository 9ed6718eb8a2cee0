"""Masked multi-head attention for the sparse decoder.

Port of `mv2d_tpu/ops/attention.py`.  Masks are "allowed" masks (True =
may attend); a query row with no allowed key yields a zero output.
`masked_attention` is kernel K4 (`csrc/attention.cu`), replacing
`mv2d_tpu/ops/pallas_attention.py: masked_flash_attention(sparse=True)`.
With gradients on, `masked_attention_train` runs `MaskedAttentionFn`: K4
with its per-(query, head) log-sum-exp output as the forward (the TPU's
dense training forward `_fwd_call` computes the same function) and
kernel B8 as the backward (`_flash_bwd`).  With `sparse` (a model built
under MV2D_FLASH_SPARSE=1, see `routes`), the JAX package takes its
block-sparse training form: the sparse forward `_sparse_fwd_call` and the
single-pass backward `_flash_sparse_bwd`.  Both compute the functions of
K4 and B8 over the same active tiles, and B8 already walks only the
active tiles, so the port answers that route with `MaskedAttentionFn`
too.

K4 and B8 read the mask as `MaskTiles` (`mask_tiles`): its bits packed 64
keys to a word (by a small CUDA kernel, `mask_bits`) and the CSR lists of
the 64x64 tiles that hold any allowed pair.  The decoder builds one for
each of its two masks per pass and hands it to every layer; a wrapper
called without one builds its own.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels

_NEG = -1e9
# K4's log-sum-exp of a row with no allowed key (kEmptyLse in the source)
EMPTY_LSE = 1e30


def masked_softmax(logits: torch.Tensor, allowed: torch.Tensor
                   ) -> torch.Tensor:
    """Softmax over the last axis; rows with no allowed entry give zeros."""
    logits = torch.where(allowed, logits, torch.full_like(logits, _NEG))
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m) * allowed.to(logits.dtype)
    return e / e.sum(-1, keepdim=True).clamp(min=1e-20)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, allowed: torch.Tensor
                         ) -> torch.Tensor:
    """Projected q [B, Q, C], k/v [B, K, C]; allowed [B, Q, K] ->
    [B, Q, C] (float32 logits and sums)."""
    B, Q, C = q.shape
    K = k.shape[1]
    H = num_heads
    D = C // H
    qh = q.float().reshape(B, Q, H, D).transpose(1, 2)
    kh = k.float().reshape(B, K, H, D).transpose(1, 2)
    vh = v.float().reshape(B, K, H, D).transpose(1, 2)
    logits = qh @ kh.transpose(-1, -2) / D ** 0.5              # [B, H, Q, K]
    attn = masked_softmax(logits, allowed[:, None].expand_as(logits))
    out = attn @ vh
    return out.transpose(1, 2).reshape(B, Q, C).to(q.dtype)


def masked_attention_plain(q, k, v, allowed, num_heads: int):
    return multi_head_attention(q[None], k[None], v[None], num_heads,
                                allowed[None])[0]


def attention_lse_plain(q, k, allowed, num_heads: int) -> torch.Tensor:
    """[Q, H] log-sum-exp of each row's allowed scaled logits (float32);
    EMPTY_LSE for a row with no allowed key (K4's second output)."""
    Q, C = q.shape
    H = num_heads
    D = C // H
    qh = q.float().reshape(Q, H, D).transpose(0, 1)
    kh = k.float().reshape(-1, H, D).transpose(0, 1)
    logits = (qh @ kh.transpose(-1, -2)) / D ** 0.5             # [H, Q, K]
    logits = logits.masked_fill(~allowed[None], float('-inf'))
    lse = torch.logsumexp(logits, -1).transpose(0, 1)
    return torch.where(allowed.any(-1)[:, None], lse,
                       torch.full_like(lse, EMPTY_LSE))


def _check(q, k, v, allowed, num_heads):
    Q, C = q.shape
    K = k.shape[0]
    D = C // num_heads
    if D not in (8, 16, 32) or D * num_heads != C:
        raise ValueError(f'attention kernel takes head dim 8/16/32, '
                         f'got C={C} heads={num_heads}')
    if k.dtype != q.dtype or v.dtype != q.dtype or (
            allowed is not None and allowed.shape != (Q, K)):
        raise ValueError('q/k/v must share a dtype; allowed must be [Q, K]')


SPARSE_TILE = 64          # the query and key tiles of K4 and B8


class MaskTiles(NamedTuple):
    """A mask [Q, K] as K4 and B8 read it: `bits` uint64 [Q, ceil(K/64)],
    bit j of word t = allowed[q, 64t + j]; the CSR list of the key tiles
    that hold any allowed pair, per 64-query tile (`key_starts` [nQ + 1],
    `key_tiles` [nQ * nK + 1] int32: query tile i's tiles are
    key_tiles[key_starts[i]:key_starts[i + 1]], ascending, JAX's
    `_sparse_blocks` at 64-wide tiles); and the transposed list, the query
    tiles of each 64-key tile (`query_starts` [nK + 1], `query_tiles`)."""
    bits: torch.Tensor
    key_starts: torch.Tensor
    key_tiles: torch.Tensor
    query_starts: torch.Tensor
    query_tiles: torch.Tensor


def mask_bits_plain(allowed: torch.Tensor) -> torch.Tensor:
    """allowed [Q, K] bool -> uint64 [Q, ceil(K/64)], bit j of word t =
    allowed[q, 64t + j] (0 past K)."""
    Q, K = allowed.shape
    nw = -(-K // SPARSE_TILE)
    a = torch.zeros(Q, nw * SPARSE_TILE, dtype=torch.int64,
                    device=allowed.device)
    a[:, :K] = allowed
    shifts = torch.arange(SPARSE_TILE, device=allowed.device)
    # distinct powers of two: the int64 sum wraps bit 63 exactly
    words = (a.view(Q, nw, SPARSE_TILE) << shifts).sum(-1)
    return words.view(torch.uint64)


def mask_bits(allowed: torch.Tensor) -> torch.Tensor:
    """`mask_bits_plain` by a CUDA kernel (one warp ballot per 32 keys);
    CPU tensors take the plain version."""
    if allowed.device.type == 'cpu':
        return mask_bits_plain(allowed)
    Q, K = allowed.shape
    mask = allowed.to(torch.bool).contiguous()
    kernels.check_cuda(mask)
    bits = torch.empty((Q, -(-K // SPARSE_TILE)), dtype=torch.int64,
                       device=mask.device)
    kernels.launch('mv2d_mask_bits', mask.data_ptr(), bits.data_ptr(), Q, K)
    mask_bits.launches += 1
    return bits.view(torch.uint64)


mask_bits.launches = 0


def mask_from_bits(bits: torch.Tensor, K: int) -> torch.Tensor:
    """The bool mask [Q, K] that `bits` packs."""
    Q, nw = bits.shape
    shifts = torch.arange(SPARSE_TILE, device=bits.device)
    a = (bits.view(torch.int64)[:, :, None] >> shifts) & 1
    return a.reshape(Q, nw * SPARSE_TILE)[:, :K].to(torch.bool)


def _csr(blk: torch.Tensor):
    """blk [n, m] bool -> (starts [n + 1], idx [n * m + 1]) int32: row i's
    true columns, ascending, are idx[starts[i]:starts[i + 1]]; the rest of
    idx is not read.  No host sync."""
    n, m = blk.shape
    flat = blk.reshape(-1)
    dev = blk.device
    starts = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    starts[1:] = blk.sum(1).cumsum(0)
    # an active pair's place in the list is its rank among active pairs in
    # row-major order; inactive pairs all land in the unread last slot
    slot = torch.where(flat, flat.cumsum(0) - 1, n * m)
    idx = torch.zeros(n * m + 1, dtype=torch.int32, device=dev)
    idx.scatter_(0, slot, torch.arange(m, dtype=torch.int32,
                                       device=dev).repeat(n))
    return starts, idx


def mask_tiles(allowed: torch.Tensor) -> MaskTiles:
    """allowed [Q, K] bool -> its `MaskTiles`, on the mask's device, with
    no host sync: the bits by `mask_bits` (a kernel on CUDA), the lists
    from the bits by torch ops."""
    Q, _ = allowed.shape
    bits = mask_bits(allowed)
    nq, nk = -(-Q // SPARSE_TILE), bits.shape[1]
    w = bits.view(torch.int64)
    w = torch.cat([w, w.new_zeros(nq * SPARSE_TILE - Q, nk)])
    blk = (w.view(nq, SPARSE_TILE, nk) != 0).any(1)           # [nQ, nK]
    return MaskTiles(bits, *_csr(blk), *_csr(blk.t()))


def _tiles_for(q, k, allowed, tiles):
    """`tiles`, checked against q / k, or `mask_tiles(allowed)`."""
    Q, K = q.shape[0], k.shape[0]
    if tiles is None:
        return mask_tiles(allowed.to(torch.bool))
    if tiles.bits.shape != (Q, -(-K // SPARSE_TILE)) \
            or tiles.key_starts.shape != (-(-Q // SPARSE_TILE) + 1,) \
            or tiles.query_starts.shape != (-(-K // SPARSE_TILE) + 1,):
        raise ValueError('tiles must be mask_tiles of a [Q, K] mask')
    return tiles


def _splits(q, K, num_heads):
    """How many parts K4 and B8's dQ kernel cut each query tile's list of
    key tiles into, so that (query tile, head, split) blocks fill the card
    about eight times over; the parts meet in a second kernel."""
    blocks = -(-q.shape[0] // SPARSE_TILE) * num_heads
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return max(1, min(-(-K // SPARSE_TILE), -(-8 * sms // blocks)))


def masked_attention_forward(q, k, v, allowed, num_heads: int, tiles=None):
    """Kernel K4 on CUDA tensors -> (out [Q, C], lse [Q, H] float32).
    `tiles` is `mask_tiles(allowed)`, built here when not given."""
    _check(q, k, v, allowed, num_heads)
    Q, C = q.shape
    K = k.shape[0]
    D = C // num_heads
    q, k, v = (t.contiguous() for t in (q, k, v))
    kernels.check_cuda(q, k, v)
    tiles = _tiles_for(q, k, allowed, tiles)
    kernels.check_cuda(*tiles)
    splits = _splits(q, K, num_heads)
    f32 = dict(dtype=torch.float32, device=q.device)
    po = torch.empty((splits, Q, C), **f32)
    pm = torch.empty((splits, Q, num_heads), **f32)
    pl = torch.empty((splits, Q, num_heads), **f32)
    lse = torch.empty((Q, num_heads), **f32)
    out = torch.empty_like(q)
    kernels.launch('mv2d_masked_attention', q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), tiles.bits.data_ptr(),
                   tiles.key_starts.data_ptr(), tiles.key_tiles.data_ptr(),
                   out.data_ptr(), lse.data_ptr(), po.data_ptr(),
                   pm.data_ptr(), pl.data_ptr(), Q, K, num_heads, D, splits,
                   kernels.dtype_code(q))
    masked_attention.launches += 1
    return out, lse


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     allowed: torch.Tensor, num_heads: int,
                     tiles: MaskTiles | None = None) -> torch.Tensor:
    """Kernel K4: q [Q, C], k/v [K, C] (float32 or bfloat16, one dtype),
    allowed [Q, K] bool -> [Q, C].  `tiles`: `mask_tiles(allowed)`, built
    here when not given.  CPU tensors take `masked_attention_plain` (and
    `tiles` is not read)."""
    if q.device.type == 'cpu':
        return masked_attention_plain(q, k, v, allowed, num_heads)
    return masked_attention_forward(q, k, v, allowed, num_heads, tiles)[0]


masked_attention.launches = 0


def masked_attention_backward(q, k, v, allowed, out, lse, dout,
                              num_heads: int, tiles=None):
    """Kernel B8 on CUDA tensors: -> (dq, dk, dv) float32.  The mask is
    read from `tiles` (`mask_tiles(allowed)`, built here when not given;
    with tiles, `allowed` may be None)."""
    _check(q, k, v, allowed, num_heads)
    Q, C = q.shape
    K = k.shape[0]
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (Q, num_heads) or dout.dtype != q.dtype:
        raise ValueError('out / dout must be [Q, C] in q.dtype, lse [Q, H]')
    q, k, v, out, dout, lse = (t.contiguous() for t in
                               (q, k, v, out, dout, lse))
    kernels.check_cuda(q, k, v, out, dout, lse)
    tiles = _tiles_for(q, k, allowed, tiles)
    kernels.check_cuda(*tiles)
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((Q, num_heads), **f32)
    dq = torch.empty((Q, C), **f32)
    dk = torch.empty((K, C), **f32)
    dv = torch.empty((K, C), **f32)
    # the bfloat16 dQ kernel splits the key-tile lists as K4 does; the
    # float32 body takes no split
    splits = _splits(q, K, num_heads) if q.dtype == torch.bfloat16 else 1
    part = torch.empty((splits, Q, C) if splits > 1 else (0,), **f32)
    kernels.launch('mv2d_masked_attention_bwd', q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), *(t.data_ptr() for t in tiles),
                   out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                   delta.data_ptr(), dq.data_ptr(), part.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), Q, K, num_heads,
                   C // num_heads, splits, kernels.dtype_code(q))
    masked_attention_backward.launches += 1
    return dq, dk, dv


masked_attention_backward.launches = 0


class MaskedAttentionFn(torch.autograd.Function):
    """K4 (with its log-sum-exp) forward, B8 backward, both reading the
    mask's `MaskTiles` (kept for the backward in place of the mask); no
    gradient to the mask."""

    @staticmethod
    def forward(ctx, q, k, v, allowed, num_heads, tiles=None):
        tiles = _tiles_for(q, k, allowed, tiles)
        out, lse = masked_attention_forward(q, k, v, allowed, num_heads,
                                            tiles)
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, out, lse, *tiles)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, *tiles = ctx.saved_tensors
        dq, dk, dv = masked_attention_backward(
            q, k, v, None, out, lse, dout.to(q.dtype), ctx.num_heads,
            MaskTiles(*tiles))
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def masked_attention_train(q, k, v, allowed, num_heads: int,
                           sparse: bool = False,
                           tiles: MaskTiles | None = None):
    """Differentiable masked attention.  CPU tensors take
    `masked_attention_plain` (autograd; `tiles` not read); CUDA tensors run
    `MaskedAttentionFn` (kernels K4 / B8) on `tiles` (`mask_tiles(allowed)`,
    built here when not given).  `sparse` (the MV2D_FLASH_SPARSE route)
    selects the JAX package's block-sparse training form, whose forward
    and backward compute the same functions as K4 and B8 over the same
    active tiles: it takes the same kernels."""
    if q.device.type == 'cpu':
        return masked_attention_plain(q, k, v, allowed, num_heads)
    return MaskedAttentionFn.apply(q, k, v, allowed, num_heads, tiles)
