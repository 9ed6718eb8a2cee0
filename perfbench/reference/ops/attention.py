"""Masked multi-head attention in plain PyTorch, float32 logits and sums
(frozen copy of the port's `ops/attention.py` plain versions).  The
shared-key entry points the decoder calls take the plain version; autograd
gives the training gradients.
"""
from __future__ import annotations

import torch

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


def per_query_attention(q, k, v, allowed, num_heads: int):
    """Attention over a key set of each query's own (the roi key mode):
    q [Q, C], k/v [Q, Kq, C], allowed [Q, Kq] -> [Q, C];
    `multi_head_attention` with one batch row per query.  The JAX package
    runs this form in XLA (no Pallas kernel), so batched matmuls are its
    port on every device."""
    return multi_head_attention(q[:, None], k, v, num_heads,
                                allowed[:, None])[:, 0]


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


def masked_attention(q, k, v, allowed, num_heads: int, tiles=None):
    return masked_attention_plain(q, k, v, allowed, num_heads)


def masked_attention_train(q, k, v, allowed, num_heads: int,
                           sparse: bool = False, tiles=None):
    return masked_attention_plain(q, k, v, allowed, num_heads)
