"""Masked multi-head attention for the sparse decoder.

Port of `mv2d_tpu/ops/attention.py`.  Masks are "allowed" masks (True =
may attend); a query row with no allowed key yields a zero output.
`masked_attention` is kernel K4 (`csrc/attention.cu`), replacing
`mv2d_tpu/ops/pallas_attention.py: masked_flash_attention(sparse=True)`.
With gradients on, `masked_attention_train` runs `MaskedAttentionFn`: K4
with its per-(query, head) log-sum-exp output as the forward (the TPU's
dense training forward `_fwd_call` computes the same function) and
kernel B8 as the backward (`_flash_bwd`).  With `sparse` (a model built
under MV2D_FLASH_SPARSE=1, see `routes`), the JAX package's block-sparse
training form is followed: `SparseMaskedAttentionFn`, K4 forward (the
sparse forward `_sparse_fwd_call` computes the same function) and kernel
B14 as the single-pass backward (`_flash_sparse_bwd`).
"""
from __future__ import annotations

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
    if k.dtype != q.dtype or v.dtype != q.dtype or allowed.shape != (Q, K):
        raise ValueError('q/k/v must share a dtype; allowed must be [Q, K]')


def masked_attention_forward(q, k, v, allowed, num_heads: int):
    """Kernel K4 on CUDA tensors -> (out [Q, C], lse [Q, H] float32)."""
    _check(q, k, v, allowed, num_heads)
    Q, C = q.shape
    K = k.shape[0]
    D = C // num_heads
    q, k, v = (t.contiguous() for t in (q, k, v))
    mask = allowed.to(torch.bool).contiguous()
    kernels.check_cuda(q, k, v, mask)
    # split the keys so that (query tile, head, split) blocks fill the card
    # about four times over; the splits merge in a second kernel
    tiles = -(-K // 64)
    blocks = -(-Q // 64) * num_heads
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    per_split = -(-tiles // max(1, min(tiles, -(-4 * sms // blocks))))
    splits = -(-tiles // per_split)
    f32 = dict(dtype=torch.float32, device=q.device)
    po = torch.empty((splits, Q, C), **f32)
    pm = torch.empty((splits, Q, num_heads), **f32)
    pl = torch.empty((splits, Q, num_heads), **f32)
    lse = torch.empty((Q, num_heads), **f32)
    out = torch.empty_like(q)
    kernels.launch('mv2d_masked_attention', q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                   lse.data_ptr(), po.data_ptr(), pm.data_ptr(),
                   pl.data_ptr(), Q, K, num_heads, D, splits,
                   kernels.dtype_code(q))
    masked_attention.launches += 1
    return out, lse


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     allowed: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Kernel K4: q [Q, C], k/v [K, C] (float32 or bfloat16, one dtype),
    allowed [Q, K] bool -> [Q, C].  CPU tensors take
    `masked_attention_plain`."""
    if q.device.type == 'cpu':
        return masked_attention_plain(q, k, v, allowed, num_heads)
    return masked_attention_forward(q, k, v, allowed, num_heads)[0]


masked_attention.launches = 0


def masked_attention_backward(q, k, v, allowed, out, lse, dout,
                              num_heads: int):
    """Kernel B8 on CUDA tensors: -> (dq, dk, dv) float32."""
    _check(q, k, v, allowed, num_heads)
    Q, C = q.shape
    K = k.shape[0]
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (Q, num_heads) or dout.dtype != q.dtype:
        raise ValueError('out / dout must be [Q, C] in q.dtype, lse [Q, H]')
    q, k, v, out, dout, lse = (t.contiguous() for t in
                               (q, k, v, out, dout, lse))
    mask = allowed.to(torch.bool).contiguous()
    kernels.check_cuda(q, k, v, mask, out, dout, lse)
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((Q, num_heads), **f32)
    dq = torch.zeros((Q, C), **f32)
    dk = torch.zeros((K, C), **f32)
    dv = torch.zeros((K, C), **f32)
    kernels.launch('mv2d_masked_attention_bwd', q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                   dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                   dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), Q, K,
                   num_heads, C // num_heads, kernels.dtype_code(q))
    masked_attention_backward.launches += 1
    return dq, dk, dv


masked_attention_backward.launches = 0


class MaskedAttentionFn(torch.autograd.Function):
    """K4 (with its log-sum-exp) forward, B8 backward; no gradient to the
    mask."""

    @staticmethod
    def forward(ctx, q, k, v, allowed, num_heads):
        out, lse = masked_attention_forward(q, k, v, allowed, num_heads)
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, allowed, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, allowed, out, lse = ctx.saved_tensors
        dq, dk, dv = masked_attention_backward(
            q, k, v, allowed, out, lse, dout.to(q.dtype), ctx.num_heads)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


SPARSE_TILE = 64          # B14's query and key tiles


def sparse_key_tiles(allowed: torch.Tensor, tile: int = SPARSE_TILE):
    """JAX's `_sparse_blocks` in CSR form: the key tiles holding any
    allowed pair, per query tile, ascending.  allowed [Q, K] bool ->
    (starts [nQ + 1], tiles [nQ * nK + 1]), int32: query tile i's key
    tiles are tiles[starts[i]:starts[i + 1]], and the rest of `tiles` is
    not read.  Built on the mask's device with no host sync."""
    Q, K = allowed.shape
    nq, nk = -(-Q // tile), -(-K // tile)
    full = K // tile * tile
    cols = [allowed[:, :full].reshape(Q, K // tile, tile).any(2)]
    if full < K:
        cols.append(allowed[:, full:].any(1, keepdim=True))
    rows = torch.cat(cols, 1)                                    # [Q, nK]
    rows = torch.cat([rows, rows.new_zeros(nq * tile - Q, nk)])
    blk = rows.view(nq, tile, nk).any(1).reshape(-1)             # [nQ * nK]
    dev = allowed.device
    starts = torch.zeros(nq + 1, dtype=torch.int32, device=dev)
    starts[1:] = blk.view(nq, nk).sum(1).cumsum(0)
    # an active pair's place in the list is its rank among active pairs in
    # row-major order; inactive pairs all land in the unread last slot
    slot = torch.where(blk, blk.cumsum(0) - 1, nq * nk)
    tiles = torch.zeros(nq * nk + 1, dtype=torch.int32, device=dev)
    tiles.scatter_(0, slot, torch.arange(nk, dtype=torch.int32,
                                         device=dev).repeat(nq))
    return starts, tiles


def masked_attention_sparse_backward(q, k, v, allowed, out, lse, dout,
                                     num_heads: int, key_tiles=None):
    """Kernel B14 on CUDA tensors: -> (dq, dk, dv) float32, one pass per
    (query tile, head) over its active key tiles.  `key_tiles` is
    `sparse_key_tiles(allowed)`, built here when not given."""
    _check(q, k, v, allowed, num_heads)
    Q, C = q.shape
    K = k.shape[0]
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (Q, num_heads) or dout.dtype != q.dtype:
        raise ValueError('out / dout must be [Q, C] in q.dtype, lse [Q, H]')
    q, k, v, out, dout, lse = (t.contiguous() for t in
                               (q, k, v, out, dout, lse))
    mask = allowed.to(torch.bool).contiguous()
    kernels.check_cuda(q, k, v, mask, out, dout, lse)
    starts, tiles = key_tiles if key_tiles is not None \
        else sparse_key_tiles(mask)
    kernels.check_cuda(starts, tiles)
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((Q, num_heads), **f32)
    dq = torch.empty((Q, C), **f32)
    dk = torch.zeros((K, C), **f32)
    dv = torch.zeros((K, C), **f32)
    kernels.launch('mv2d_masked_attention_sparse_bwd', q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                   out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                   delta.data_ptr(), starts.data_ptr(), tiles.data_ptr(),
                   dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), Q, K,
                   num_heads, C // num_heads, kernels.dtype_code(q))
    masked_attention_sparse_backward.launches += 1
    return dq, dk, dv


masked_attention_sparse_backward.launches = 0


class SparseMaskedAttentionFn(torch.autograd.Function):
    """K4 (with its log-sum-exp) forward, B14 backward; no gradient to the
    mask.  The forward lists the mask's active key tiles for the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, allowed, num_heads):
        out, lse = masked_attention_forward(q, k, v, allowed, num_heads)
        starts, tiles = sparse_key_tiles(allowed.to(torch.bool))
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, allowed, out, lse, starts, tiles)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, allowed, out, lse, starts, tiles = ctx.saved_tensors
        dq, dk, dv = masked_attention_sparse_backward(
            q, k, v, allowed, out, lse, dout.to(q.dtype), ctx.num_heads,
            (starts, tiles))
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def masked_attention_train(q, k, v, allowed, num_heads: int,
                           sparse: bool = False):
    """Differentiable masked attention.  CPU tensors take
    `masked_attention_plain` (autograd); CUDA tensors run
    `SparseMaskedAttentionFn` (kernels K4 / B14) with `sparse`, else
    `MaskedAttentionFn` (kernels K4 / B8)."""
    if q.device.type == 'cpu':
        return masked_attention_plain(q, k, v, allowed, num_heads)
    if sparse:
        return SparseMaskedAttentionFn.apply(q, k, v, allowed, num_heads)
    return MaskedAttentionFn.apply(q, k, v, allowed, num_heads)
