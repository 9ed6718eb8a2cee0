"""GridMask image augmentation (training only).

Port of `mv2d_tpu/ops/grid_mask.py` (the reference's CustomGridMask) for
the shipped MV2D-T settings: use_h and use_w, rotate=1 (no rotation),
ratio 0.4-0.6, mode=1 (keep the band union), prob 0.7, interv_ratio 0.8.
The random draws are explicit (`GridMaskDraws`), so a test can hand both
packages the same numbers:

  * one Bernoulli(prob) gate for the whole multi-view batch,
  * per view: an integer grid period d in [2, max(int(H*0.8), 3)), a
    ratio ~ U(0.4, 0.6) giving the band length clip(int(d*ratio + 0.5),
    1, d-1), and band offsets st = floor(u * d) with u ~ U(0, 1), on a
    1.5x canvas whose centre crop is the image.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class GridMaskDraws(NamedTuple):
    apply: torch.Tensor     # [] bool: the batch gate
    d: torch.Tensor         # [V] int64 grid period
    ratio: torch.Tensor     # [V] float32 band ratio
    u_h: torch.Tensor       # [V] float32 U(0, 1) for the row band offset
    u_w: torch.Tensor       # [V] float32 U(0, 1) for the column offset


def draw_grid_mask(num_views: int, hw: Tuple[int, int],
                   generator: torch.Generator, prob: float = 0.7,
                   ratio_range=(0.4, 0.6), interv_ratio: float = 0.8
                   ) -> GridMaskDraws:
    """The augmentation's draws, on the generator's device."""
    H = hw[0]
    dmax = max(int(H * interv_ratio), 3)
    kw = dict(generator=generator, device=generator.device)
    apply = torch.rand((), **kw) < prob
    d = torch.randint(2, dmax, (num_views,), **kw)
    lo, hi = ratio_range
    ratio = lo + (hi - lo) * torch.rand(num_views, **kw)
    return GridMaskDraws(apply, d, ratio, torch.rand(num_views, **kw),
                         torch.rand(num_views, **kw))


def _bands(coord, st, d, length, n_periods):
    """Band i covers [d*i + st, d*i + st + length) for i < n_periods."""
    rel = coord - st
    return (rel >= 0) & (rel % d < length) & (rel // d < n_periods)


def grid_keep_mask(draws: GridMaskDraws, hw: Tuple[int, int]
                   ) -> torch.Tensor:
    """keep [V, H, W] bool (mode 1: the union of row and column bands;
    everything when the gate is off)."""
    H, W = hw
    d = draws.d.long()
    length = (d.float() * draws.ratio.float() + 0.5).long()
    length = torch.minimum(length.clamp(min=1), d - 1)
    st_h = torch.floor(draws.u_h.float() * d).long()
    st_w = torch.floor(draws.u_w.float() * d).long()
    hh, ww = int(1.5 * H), int(1.5 * W)
    oy, ox = (hh - H) // 2, (ww - W) // 2
    dev = d.device
    ys = (torch.arange(H, device=dev) + oy)[None]
    xs = (torch.arange(W, device=dev) + ox)[None]
    dv, lv = d[:, None], length[:, None]
    on_y = _bands(ys, st_h[:, None], dv, lv, (hh // d)[:, None])
    on_x = _bands(xs, st_w[:, None], dv, lv, (ww // d)[:, None])
    keep = on_y[:, :, None] | on_x[:, None, :]
    return keep | ~draws.apply.to(dev)


def grid_mask(imgs: torch.Tensor, draws: GridMaskDraws) -> torch.Tensor:
    """imgs [V, H, W, 3] -> imgs with the grid's dropped cells zeroed."""
    keep = grid_keep_mask(draws, imgs.shape[1:3])
    return imgs * keep[..., None].to(imgs.dtype)
