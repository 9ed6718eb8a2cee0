"""Masked multi-head attention for the sparse decoder.

Port of `mv2d_tpu/ops/attention.py`.  Masks are "allowed" masks (True =
may attend); a query row with no allowed key yields a zero output.
`masked_attention` is kernel K4 (`csrc/attention.cu`), replacing
`mv2d_tpu/ops/pallas_attention.py: masked_flash_attention(sparse=True)`.
"""
from __future__ import annotations

import torch

from .. import kernels

_NEG = -1e9


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


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     allowed: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Kernel K4: q [Q, C], k/v [K, C] (float32 or bfloat16, one dtype),
    allowed [Q, K] bool -> [Q, C].  CPU tensors take
    `masked_attention_plain`."""
    if q.device.type == 'cpu':
        return masked_attention_plain(q, k, v, allowed, num_heads)
    Q, C = q.shape
    K = k.shape[0]
    D = C // num_heads
    if D not in (8, 16, 32) or D * num_heads != C:
        raise ValueError(f'attention kernel takes head dim 8/16/32, '
                         f'got C={C} heads={num_heads}')
    if k.dtype != q.dtype or v.dtype != q.dtype or allowed.shape != (Q, K):
        raise ValueError('q/k/v must share a dtype; allowed must be [Q, K]')
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
    out = torch.empty_like(q)
    kernels.launch('mv2d_masked_attention', q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                   po.data_ptr(), pm.data_ptr(), pl.data_ptr(), Q, K,
                   num_heads, D, splits, kernels.dtype_code(q))
    masked_attention.launches += 1
    return out


masked_attention.launches = 0
