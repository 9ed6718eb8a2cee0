"""PETR-style decoder with masked self/cross-attention and the box head.

Port of `mv2d_tpu/nn/decoder.py` with the reference's keys:
transformer.decoder.layers.{i}.attentions.{0,1}.attn (torch
MultiheadAttention layout: packed in_proj, out_proj),
ffns.0.layers.{0.0,1}, norms.{0,1,2}; transformer.decoder.post_norm;
query_embedding.{0,2}; cls_branches / reg_branches.  Post-norm layer order
('self_attn', 'norm', 'cross_attn', 'norm', 'ffn', 'norm').  LayerNorms use
eps 1e-6, the JAX package's value.

Two key layouts, as in the JAX package: a shared key set [K, C] with a
mask [Q, K] (the pixel key mode, and the roi key mode with DN), or a key
set of each query's own [Q, Kq, C] with a mask [Q, Kq] (the roi key
mode).  Attention over shared keys (the self-attention, and the
cross-attention of the first layout) goes through
`ops.attention.masked_attention` (kernel K4 on CUDA), or
`masked_attention_train` (K4 and its backward B8, with or without
flash_sparse) while gradients are recorded, whatever the config's
use_flash_attention (a TPU routing field: the function is the same); on
the GPU the decoder packs each of its shared-key masks once per pass
(`mask_tiles`, the tiles every layer's kernels read).  CPU tensors take
the plain versions.  Per-query keys go through
`ops.attention.per_query_attention` (batched matmuls: XLA in the JAX
package, no kernel there either).  Training applies
the reference's dropout (p = cfg.dropout) after each attention's output
projection and inside the FFN; the masks come from the step's
torch.Generator (`Dropout`).  With remat (cfg.remat_decoder) each layer's
activations are recomputed in the backward (`layers.rematerialized`);
the recompute draws the masks of the first run again (`Dropout.replay`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as tnn
import torch.nn.functional as F

from ..core.geometry import inverse_sigmoid
from ..ops.attention import (MaskTiles, mask_tiles, masked_attention,
                             masked_attention_train, per_query_attention)
from .layers import linear, rematerialized
from .pe import pos2posemb3d

LN_EPS = 1e-6


class Dropout:
    """Inverted dropout with masks drawn from a generator: keep with
    probability 1 - p, scale the kept values by 1 / (1 - p) (flax
    nn.Dropout).  p = 0 or no generator leaves the input as it is."""

    def __init__(self, p: float, generator: Optional[torch.Generator]):
        self.p = p
        self.generator = generator

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.p == 0.0 or self.generator is None:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)

    def replay(self):
        """(start, finish): start() gives a Dropout whose generator is a
        new one at this generator's present state, so each call draws
        the same masks; finish() moves this generator on to where the
        first start()'s Dropout left its own.  A rematerialized layer
        draws from start() in both runs (`torch.utils.checkpoint`'s
        preserve_rng_state restores the global generators only)."""
        if self.p == 0.0 or self.generator is None:
            return (lambda: self), (lambda: None)
        gen = self.generator
        state = gen.get_state()
        first = []

        def start():
            g = torch.Generator(device=gen.device)
            g.set_state(state)
            first.append(g)
            return Dropout(self.p, g)
        return start, lambda: gen.set_state(first[0].get_state())


NO_DROPOUT = Dropout(0.0, None)


class MultiheadAttention(tnn.Module):
    """Parameter layout of torch.nn.MultiheadAttention; the attention
    itself is K4 (with B8 under grad; plain versions on the CPU) over
    shared keys, `per_query_attention` over per-query keys."""

    def __init__(self, embed_dims: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = tnn.Parameter(
            torch.empty(3 * embed_dims, embed_dims))
        self.in_proj_bias = tnn.Parameter(torch.zeros(3 * embed_dims))
        self.out_proj = tnn.Linear(embed_dims, embed_dims)
        tnn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q, k, v, allowed, drop: Dropout = NO_DROPOUT,
                flash_sparse: bool = False,
                tiles: Optional[MaskTiles] = None):
        """q [Q, C], k/v [K, C] with allowed [Q, K] bool, or k/v [Q, Kq, C]
        with allowed [Q, Kq] -> [Q, C]; `tiles`: `mask_tiles(allowed)` of
        a shared-key mask for the kernels (built by them if None)."""
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        dt = wq.dtype
        qp = F.linear(q.to(dt), wq, bq)
        kp = F.linear(k.to(dt), wk, bk)
        vp = F.linear(v.to(dt), wv, bv)
        if kp.dim() == 3:
            out = per_query_attention(qp, kp, vp, allowed, self.num_heads)
        elif torch.is_grad_enabled():
            out = masked_attention_train(qp, kp, vp, allowed, self.num_heads,
                                         flash_sparse, tiles)
        else:
            out = masked_attention(qp, kp, vp, allowed, self.num_heads,
                                   tiles)
        return drop(self.out_proj(out))


class _Attention(tnn.Module):
    def __init__(self, embed_dims: int, num_heads: int):
        super().__init__()
        self.attn = MultiheadAttention(embed_dims, num_heads)


class FFN(tnn.Module):
    def __init__(self, embed_dims: int, feedforward_channels: int):
        super().__init__()
        self.layers = tnn.ModuleList([
            tnn.Sequential(tnn.Linear(embed_dims, feedforward_channels)),
            tnn.Linear(feedforward_channels, embed_dims)])

    def forward(self, x, drop: Dropout = NO_DROPOUT):
        return drop(self.layers[1](drop(F.relu(self.layers[0][0](x)))))


class PETRDecoderLayer(tnn.Module):
    def __init__(self, embed_dims=256, num_heads=8, feedforward_channels=2048,
                 flash_sparse: bool = False):
        super().__init__()
        self.flash_sparse = flash_sparse
        self.attentions = tnn.ModuleList(
            [_Attention(embed_dims, num_heads) for _ in range(2)])
        self.ffns = tnn.ModuleList([FFN(embed_dims, feedforward_channels)])
        self.norms = tnn.ModuleList(
            [tnn.LayerNorm(embed_dims, eps=LN_EPS) for _ in range(3)])

    def forward(self, query, query_pos, keys, key_pos, self_allowed,
                cross_allowed, drop: Dropout = NO_DROPOUT,
                self_tiles: Optional[MaskTiles] = None,
                cross_tiles: Optional[MaskTiles] = None):
        qs = query + query_pos
        sa = self.attentions[0].attn(qs, qs, query, self_allowed, drop,
                                     self.flash_sparse, self_tiles)
        query = self.norms[0](query + sa)
        ca = self.attentions[1].attn(query + query_pos, keys + key_pos, keys,
                                     cross_allowed, drop, self.flash_sparse,
                                     cross_tiles)
        query = self.norms[1](query + ca)
        return self.norms[2](query + self.ffns[0](query, drop))


class PETRDecoder(tnn.Module):
    def __init__(self, num_layers=6, embed_dims=256, num_heads=8,
                 feedforward_channels=2048, flash_sparse: bool = False,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = tnn.ModuleList([
            PETRDecoderLayer(embed_dims, num_heads, feedforward_channels,
                             flash_sparse)
            for _ in range(num_layers)])
        self.post_norm = tnn.LayerNorm(embed_dims, eps=LN_EPS)

    def forward(self, query, query_pos, keys, key_pos, self_allowed,
                cross_allowed, drop: Dropout = NO_DROPOUT):
        outs = []
        # the kernels read each shared-key mask as MaskTiles: packed once
        # per pass (per-query keys take no kernel)
        tiles = (None, None)
        if query.device.type != 'cpu':
            tiles = (mask_tiles(self_allowed), None if keys.dim() == 3
                     else mask_tiles(cross_allowed))
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            args = (query, query_pos, keys, key_pos, self_allowed,
                    cross_allowed)
            if remat:
                start, finish = drop.replay()
                query = rematerialized(
                    layer, *args, kwargs=lambda start=start: dict(
                        drop=start(), self_tiles=tiles[0],
                        cross_tiles=tiles[1]))
                finish()
            else:
                query = layer(*args, drop, *tiles)
            outs.append(self.post_norm(query))
        return torch.stack(outs)                            # [L, Q, C]


class _Transformer(tnn.Module):
    def __init__(self, decoder: PETRDecoder):
        super().__init__()
        self.decoder = decoder


class CrossAttentionBoxHead(tnn.Module):
    """Query embedding -> decoder -> per-layer class logits and box codes
    with sigmoid-space centers decoded into the pc_range frame."""

    def __init__(self, num_classes=10, embed_dims=256, code_size=10,
                 num_layers=6, num_heads=8, feedforward_channels=2048,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 flash_sparse: bool = False, remat: bool = False):
        super().__init__()
        C = embed_dims
        self.embed_dims = C
        self.pc_range = tuple(pc_range)
        self.query_embedding = tnn.Sequential(
            tnn.Linear(C * 3 // 2, C), tnn.ReLU(), tnn.Linear(C, C))
        self.transformer = _Transformer(PETRDecoder(
            num_layers, C, num_heads, feedforward_channels, flash_sparse,
            remat))
        self.cls_branches = tnn.ModuleList([tnn.Sequential(
            tnn.Linear(C, C), tnn.LayerNorm(C, eps=LN_EPS), tnn.ReLU(),
            tnn.Linear(C, C), tnn.LayerNorm(C, eps=LN_EPS), tnn.ReLU(),
            tnn.Linear(C, num_classes)) for _ in range(num_layers)])
        for branch in self.cls_branches:      # the focal-loss prior, p 0.01
            tnn.init.constant_(branch[-1].bias, -4.595)
        self.reg_branches = tnn.ModuleList([tnn.Sequential(
            tnn.Linear(C, C), tnn.ReLU(), tnn.Linear(C, C), tnn.ReLU(),
            tnn.Linear(C, code_size)) for _ in range(num_layers)])

    def forward(self, reference_points, keys, key_pos, self_allowed,
                cross_allowed, drop: Dropout = NO_DROPOUT):
        """reference_points [Q, 3] normalized to pc_range; keys/key_pos
        [K, C] shared by every query with cross_allowed [Q, K] (the pixel
        key mode; the roi key mode with DN), or [Q, Kq, C], a key set per
        query, with cross_allowed [Q, Kq] (the roi key mode);
        self_allowed [Q, Q]."""
        emb = pos2posemb3d(reference_points, self.embed_dims // 2)
        query_pos = linear(emb, self.query_embedding[0])
        query_pos = self.query_embedding[2](F.relu(query_pos))
        query = torch.zeros_like(query_pos)
        outs = self.transformer.decoder(query, query_pos, keys, key_pos,
                                        self_allowed, cross_allowed, drop)
        reference = inverse_sigmoid(reference_points.float())
        pr = self.pc_range
        span_xy = reference.new_tensor([pr[3] - pr[0], pr[4] - pr[1]])
        lo_xy = reference.new_tensor([pr[0], pr[1]])
        all_cls, all_box = [], []
        for lvl in range(len(self.cls_branches)):
            cls = self.cls_branches[lvl](outs[lvl])
            reg = self.reg_branches[lvl](outs[lvl]).float()
            xy = torch.sigmoid(reg[..., 0:2] + reference[..., 0:2])
            z = torch.sigmoid(reg[..., 4:5] + reference[..., 2:3])
            xy = xy * span_xy + lo_xy
            z = z * (pr[5] - pr[2]) + pr[2]
            all_cls.append(cls)
            all_box.append(torch.cat([xy, reg[..., 2:4], z, reg[..., 5:]],
                                     dim=-1))
        return torch.stack(all_cls), torch.stack(all_box)
