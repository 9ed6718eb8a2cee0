"""RoIAlign (mmcv aligned=True) for the R-CNN stage and the 3D head.

Port of `mv2d_tpu/ops/roi_align.py`.  Sampling follows mmcv: bin (i, j)
sample (si, sj) sits at x = x1 + (j + (sj + 0.5) / S) * bin_w with
x1 = box_x1 * scale - 0.5, bilinear with border clamping inside and zeros
outside (-1, extent), averaged over S*S samples, with mmcv's adaptive
rule (sampling_ratio 0 / -1, the reference's setting): per RoI and axis
S = ceil(extent / O) (0 -> zero output), or a fixed S (sampling_ratio > 0).
The multi-level forms route each RoI to one of four FPN levels by mmdet's
rule (`roi_levels`).  Four kernels compute the multi-level function:

* `roi_align_multilevel` is kernel K3 (`csrc/roi_align.cu`), replacing
  `mv2d_tpu/ops/pallas_roi_align.py: pallas_roi_align_views` for the
  R-CNN stage; its plain version is `multilevel_roi_align_plain`.
  `roi_align_multilevel_train` is its differentiable form for the R-CNN
  loss (`RoIAlignMultilevelFn`: K3 forward, kernel B9 backward, replacing
  `pallas_roi_align_views_train`), with gradients to the features only.
* `roi_align_slab` is kernel B11 (`csrc/roi_align_slab.cu`), the same
  function through a per-view work list of size-class buckets (the JAX
  package's `MV2D_ALIGN_V2` slab kernel; `slab_worklist_plain` mirrors
  the list); `roi_align_multilevel_train` with `slab` is its
  differentiable form (B11 forward, B9 backward).
* `roi_align_flat` is kernel B12 (`csrc/roi_align_patch.cu`) for flat
  RoIs [R, 4] with a view index, with a fixed or adaptive S (the JAX
  package's `pallas_multilevel_roi_align`); its plain version is
  `multilevel_roi_align_flat_plain`.
  B11 and B12 run one streamed core (`csrc/roi_align_stream.cuh`: each
  RoI's footprint comes on chip in TMA boxes, warps own its bin columns)
  on levels of any side; `roi_align_stream_plain` walks its boxes in
  plain PyTorch, for the tests.
* `separable_roi_align_views` (3D head) stays plain torch, as the JAX
  package leaves it to XLA: every RoI row/column becomes a weight vector
  and the view tile is contracted with two matmuls.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .. import kernels


def _axis_weights(lo: torch.Tensor, extent: torch.Tensor, n_cells: int,
                  output_size: int, adaptive_max: int,
                  sampling_ratio: int = 0) -> torch.Tensor:
    """Per-RoI averaged bilinear hat profile [..., O, n_cells] along one
    axis: W[o, c] = (1/S) sum_s hat(clip(x_s) - c) * 1[-1 < x_s < n], with
    S = ceil(extent / O) capped at adaptive_max sample slots, or
    S = sampling_ratio when that is > 0."""
    O = output_size
    dev, dt = extent.device, extent.dtype
    bin_ = extent / O
    oi = torch.arange(O, device=dev, dtype=dt)
    if sampling_ratio > 0:
        S = sampling_ratio
        sf = torch.full_like(bin_, float(S))
    else:
        S = adaptive_max
        sf = torch.ceil(bin_).clamp(0.0, float(S))
    div = sf.clamp(min=1.0)
    s = torch.arange(S, device=dev, dtype=dt)
    frac = (s + 0.5) / div[..., None]                          # [..., S]
    xs = lo[..., None, None] + \
        (oi[:, None] + frac[..., None, :]) * bin_[..., None, None]
    wt = (s < sf[..., None])[..., None, :].to(dt).expand_as(xs)
    inside = (xs > -1.0) & (xs < n_cells)
    xc = xs.clamp(0.0, n_cells - 1)
    cells = torch.arange(n_cells, device=dev, dtype=dt)
    hat = (1.0 - (xc[..., None] - cells).abs()).clamp(min=0.0)
    hat = hat * (inside * wt)[..., None]
    return hat.sum(-2) / div[..., None, None]                  # [..., O, n]


def separable_roi_align_views(feat: torch.Tensor, boxes: torch.Tensor,
                              spatial_scale: float, output_size: int,
                              adaptive_max) -> torch.Tensor:
    """feat [V, H, W, C]; boxes [V, P, 4] image-pixel RoIs ->
    [V, P, O, O, C]: out = Wy F Wx per RoI (exact roi_align while
    ceil(extent / O) <= adaptive_max = (max_y, max_x) sample slots)."""
    V, H, W, C = feat.shape
    boxes = boxes.float()
    x1 = boxes[..., 0] * spatial_scale - 0.5
    y1 = boxes[..., 1] * spatial_scale - 0.5
    bw = (boxes[..., 2] - boxes[..., 0]) * spatial_scale
    bh = (boxes[..., 3] - boxes[..., 1]) * spatial_scale
    amax_y, amax_x = adaptive_max
    Wx = _axis_weights(x1, bw, W, output_size, amax_x).to(feat.dtype)
    Wy = _axis_weights(y1, bh, H, output_size, amax_y).to(feat.dtype)
    t = torch.einsum('vpjx,vyxc->vpjyc', Wx, feat)
    return torch.einsum('vpiy,vpjyc->vpijc', Wy, t)


def roi_levels(rois: torch.Tensor, num_levels: int = 4,
               finest_scale: float = 56.0) -> torch.Tensor:
    """mmdet SingleRoIExtractor routing: clamp(floor(log2(sqrt(area) /
    finest_scale + 1e-6)), 0, L-1)."""
    area = ((rois[..., 2] - rois[..., 0]) *
            (rois[..., 3] - rois[..., 1])).clamp(min=0.0)
    lvl = torch.floor(torch.log2(torch.sqrt(area) / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def multilevel_roi_align_flat_plain(feats: Sequence[torch.Tensor],
                                    rois: torch.Tensor,
                                    view_idx: torch.Tensor,
                                    strides: Sequence[int],
                                    sampling_ratio: int = 0,
                                    output_size: int = 7,
                                    finest_scale: float = 56.0,
                                    chunk: int = 256) -> torch.Tensor:
    """feats: L maps [V, H_l, W_l, C]; rois [R, 4] image pixels on views
    view_idx [R] -> [R, O, O, C], with adaptive sampling (no cap on S) or
    a fixed S = sampling_ratio > 0.  Runs the separable form per (level,
    view) group, in float32."""
    R = rois.shape[0]
    C = feats[0].shape[-1]
    O = output_size
    rois = rois.float()
    view_idx = view_idx.long()
    lvl = roi_levels(rois, len(feats), finest_scale)
    out = torch.zeros((R, O, O, C), dtype=torch.float32, device=rois.device)
    for l, (f, s) in enumerate(zip(feats, strides)):
        H, W = f.shape[1], f.shape[2]
        sc = 1.0 / s
        for v in range(f.shape[0]):
            idx = torch.nonzero((lvl == l) & (view_idx == v)).flatten()
            for c0 in range(0, idx.numel(), chunk):
                sel = idx[c0:c0 + chunk]
                b = rois[sel]
                x1 = b[:, 0] * sc - 0.5
                y1 = b[:, 1] * sc - 0.5
                bw = (b[:, 2] - b[:, 0]) * sc
                bh = (b[:, 3] - b[:, 1]) * sc
                sx = max(int(torch.ceil(bw / O).max()), 1)
                sy = max(int(torch.ceil(bh / O).max()), 1)
                Wx = _axis_weights(x1, bw, W, O, sx, sampling_ratio)
                Wy = _axis_weights(y1, bh, H, O, sy, sampling_ratio)
                t = torch.einsum('pjx,yxc->pjyc', Wx, f[v].float())
                out[sel] = torch.einsum('piy,pjyc->pijc', Wy, t)
    return out.to(feats[0].dtype)


def multilevel_roi_align_plain(feats: Sequence[torch.Tensor],
                               rois: torch.Tensor, strides: Sequence[int],
                               output_size: int = 7,
                               finest_scale: float = 56.0,
                               chunk: int = 256) -> torch.Tensor:
    """feats: L maps [V, H_l, W_l, C]; rois [V, P, 4] image pixels ->
    [V, P, O, O, C] with adaptive sampling (no cap on S): the flat form on
    the views' RoIs, in float32."""
    V, P = rois.shape[:2]
    view_idx = torch.arange(V, device=rois.device).repeat_interleave(P)
    out = multilevel_roi_align_flat_plain(
        feats, rois.reshape(V * P, 4), view_idx, strides, 0, output_size,
        finest_scale, chunk)
    return out.reshape(V, P, *out.shape[1:])


def _levels(feats: Sequence[torch.Tensor], strides: Sequence[int], V: int):
    """The four levels, contiguous and checked, and their kernel arguments
    (H_l, W_l pairs, 1 / stride_l)."""
    if len(feats) != 4 or len(strides) != 4:
        raise ValueError('roi_align kernel takes exactly four levels')
    C = feats[0].shape[-1]
    dt = feats[0].dtype
    if any(f.dtype != dt or f.shape[0] != V or f.shape[-1] != C
           for f in feats) or C % 8:
        raise ValueError('levels must share dtype, views and channels '
                         '(a multiple of 8)')
    feats = [f.contiguous() for f in feats]
    dims = [d for f in feats for d in (f.shape[1], f.shape[2])]
    return feats, dims, [1.0 / s for s in strides]


def roi_align_multilevel(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int]) -> torch.Tensor:
    """Kernel K3: 7x7 RoIAlign over four FPN levels with in-kernel level
    routing.  feats: 4 maps [V, H_l, W_l, C] (float32 or bfloat16); rois
    [V, P, 4] float32 image pixels -> [V, P, 7, 7, C], through
    `mv2d::roi_align`.  CPU tensors take `multilevel_roi_align_plain`."""
    return torch.ops.mv2d.roi_align(list(feats), rois, _ints(strides))


def _ints(strides: Sequence[int]):
    return [int(s) for s in strides]


def roi_align_multilevel_cuda(feats, rois, strides):
    """`mv2d::roi_align` on CUDA tensors: kernel K3."""
    V, P = rois.shape[:2]
    feats, dims, scales = _levels(feats, strides, V)
    C = feats[0].shape[-1]
    rois = rois.float().contiguous()
    kernels.check_cuda(*feats, rois)
    out = torch.empty((V, P, 7, 7, C), dtype=feats[0].dtype,
                      device=rois.device)
    kernels.launch('mv2d_roi_align', *(f.data_ptr() for f in feats), *dims,
                   *scales, rois.data_ptr(),
                   out.data_ptr(), V, P, C, kernels.dtype_code(feats[0]))
    roi_align_multilevel.launches += 1
    return out


roi_align_multilevel.launches = 0

# B11's work list: RoIs a bucket, size classes and their long-side bounds
# in cells of the routed level
SLAB_BUCKET, SLAB_CLASSES = 8, 4
SLAB_CLASS_CELLS = (13.0, 29.0, 61.0)
# the streamed core's slot (rows, columns) of a RoI's footprint: two rows of
# 32 columns, which the kernel fills with TMA boxes of one row x 8 columns
STREAM_BOX = (2, 32)


def roi_align_flat(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                   view_idx: torch.Tensor, strides: Sequence[int],
                   sampling_ratio: int = 0) -> torch.Tensor:
    """Kernel B12: 7x7 RoIAlign over four FPN levels for flat RoIs.
    feats: 4 maps [V, H_l, W_l, C] (float32 or bfloat16, C a multiple of
    8, any side); rois [R, 4] float32 image pixels; view_idx [R] ints in
    [0, V) -> [R, 7, 7, C].  sampling_ratio > 0 takes that many samples a
    bin and axis, 0 mmcv's adaptive ceil(bin).  Computes no gradient.
    Runs `mv2d::roi_align_flat`; CPU tensors take
    `multilevel_roi_align_flat_plain`."""
    return torch.ops.mv2d.roi_align_flat(list(feats), rois, view_idx,
                                         _ints(strides), int(sampling_ratio))


def roi_align_flat_cuda(feats, rois, view_idx, strides, sampling_ratio):
    """`mv2d::roi_align_flat` on CUDA tensors: kernel B12."""
    out = launch_flat(feats, rois, view_idx, strides, sampling_ratio)
    roi_align_flat.launches += 1
    return out


roi_align_flat.launches = 0


def launch_flat(feats, rois, view_idx, strides, sampling_ratio=0,
                handle=None):
    """B12's launch, counted nowhere: CUDA tensors, the port's library or
    `handle`, a build of a variant of its sources."""
    R = rois.shape[0]
    if rois.shape != (R, 4) or view_idx.shape != (R,):
        raise ValueError('rois must be [R, 4] and view_idx [R]')
    V = feats[0].shape[0]
    feats, dims, scales = _levels(feats, strides, V)
    C = feats[0].shape[-1]
    rois = rois.detach().float().contiguous()
    view_idx = view_idx.to(torch.int32).contiguous()
    kernels.check_cuda(*feats, rois, view_idx)
    out = torch.empty((R, 7, 7, C), dtype=feats[0].dtype, device=rois.device)
    kernels.launch('mv2d_roi_align_flat', *(f.data_ptr() for f in feats),
                   *dims, *scales, rois.data_ptr(), view_idx.data_ptr(),
                   out.data_ptr(), R, C, max(int(sampling_ratio), 0), V,
                   kernels.dtype_code(feats[0]), handle=handle)
    return out


def slab_slots(P: int) -> int:
    """Slots of a view's work list in B11: P RoIs, each size class's run
    padded to whole buckets."""
    nb = SLAB_BUCKET
    return -(-(P + SLAB_CLASSES * (nb - 1)) // nb) * nb


def roi_align_slab(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                   strides: Sequence[int]) -> torch.Tensor:
    """Kernel B11: K3's function (rois [V, P, 4] -> [V, P, 7, 7, C],
    adaptive sampling) through a per-view work list of size-class buckets,
    the blocks view-major.  Levels as `roi_align_flat`.  Runs
    `mv2d::roi_align_slab`; CPU tensors take `multilevel_roi_align_plain`."""
    return torch.ops.mv2d.roi_align_slab(list(feats), rois, _ints(strides))


def roi_align_slab_cuda(feats, rois, strides):
    """`mv2d::roi_align_slab` on CUDA tensors: kernel B11."""
    out, _ = launch_slab(feats, rois, strides)
    roi_align_slab.launches += 1
    return out


roi_align_slab.launches = 0


def launch_slab(feats, rois, strides, handle=None):
    """B11's launch, counted nowhere: CUDA tensors, the port's library or
    `handle`, a build of a variant of its sources -> (out, the work list
    `order` [V, slab_slots(P)] the kernel built)."""
    V, P = rois.shape[:2]
    feats, dims, scales = _levels(feats, strides, V)
    C = feats[0].shape[-1]
    rois = rois.detach().float().contiguous()
    kernels.check_cuda(*feats, rois)
    Pp = slab_slots(P)
    order = torch.empty((V, Pp), dtype=torch.int32, device=rois.device)
    out = torch.empty((V, P, 7, 7, C), dtype=feats[0].dtype,
                      device=rois.device)
    kernels.launch('mv2d_roi_align_slab', *(f.data_ptr() for f in feats),
                   *dims, *scales, rois.data_ptr(), order.data_ptr(),
                   out.data_ptr(), V, P, Pp, C, kernels.dtype_code(feats[0]),
                   handle=handle)
    return out, order


def stream_plan(dtype: torch.dtype) -> dict:
    """The streamed core's plan on the card for `dtype` (float32 or
    bfloat16), from the kernel's own constants and attributes: a TMA box's
    columns (a box is one row), a ring slot's columns and rows, ring slots,
    dynamic shared memory a block in bytes, registers a thread, blocks an
    SM."""
    code = kernels.DTYPE_CODES[dtype]
    f = [kernels.workspace_bytes('mv2d_roi_align_stream_plan', code, k)
         for k in range(7)]
    return dict(box_columns=f[0], slot_columns=f[1], slot_rows=f[2],
                stages=f[3], smem=f[4], registers=f[5], blocks_per_sm=f[6])


def slab_worklist_plain(rois: torch.Tensor, strides: Sequence[int]):
    """B11's work list in plain PyTorch.  rois [V, P, 4] image pixels ->
    order [V, slab_slots(P)]: per view, the RoIs grouped by size class (long
    side in cells of the routed level above each of SLAB_CLASS_CELLS),
    smallest class first, each class's run in RoI order and padded with -1
    to whole buckets of SLAB_BUCKET slots (the kernel orders a class's run
    by its threads' timing; every RoI appears once either way)."""
    V, P = rois.shape[:2]
    flat = rois.reshape(-1, 4).float()
    scale = (1.0 / torch.tensor([float(s) for s in strides]))[
        roi_levels(flat)]
    cells = torch.maximum(flat[:, 2] - flat[:, 0],
                          flat[:, 3] - flat[:, 1]) * scale
    cls = sum((cells > b).long() for b in SLAB_CLASS_CELLS).reshape(V, P)
    nb = SLAB_BUCKET
    order = torch.full((V, slab_slots(P)), -1, dtype=torch.long)
    for v in range(V):
        off = 0
        for k in range(SLAB_CLASSES):
            idx = torch.nonzero(cls[v] == k).flatten()
            order[v, off:off + idx.numel()] = idx
            off += -(-idx.numel() // nb) * nb
    return order


def _stream_axis(lo: float, extent: float, S: int, n: int):
    """One axis of one RoI as the streamed core computes it (Axis in
    csrc/roi_axis.cuh), in float32: (W [7, n], cells [7, 2]): bin i's
    weight on each cell of the map (the bilinear hats of its samples inside
    (-1, n), clamped to [0, n - 1], summed over the samples, over div), and
    the cells [lo, hi] its samples touch (lo > hi without a sample
    inside)."""
    f32 = torch.float32
    lo = torch.tensor(lo, dtype=f32)
    bin_ = torch.tensor(extent, dtype=f32) / 7
    ns = S if S > 0 else max(int(torch.ceil(bin_)), 0)
    div = torch.tensor(float(max(ns, 1)), dtype=f32)
    s = torch.arange(ns, dtype=f32)
    p = lo + (torch.arange(7, dtype=f32)[:, None] + (s + 0.5) / div) * bin_
    inside = (p > -1.0) & (p < n)
    pc = p.clamp(0.0, n - 1)
    c0 = pc.floor()
    c1 = (c0 + 1).clamp(max=n - 1)
    frac = pc - c0
    w = torch.zeros(7, n, dtype=f32)
    w.scatter_add_(1, c0.long(), (1.0 - frac) * inside)
    w.scatter_add_(1, c1.long(), frac * inside)
    cells = torch.tensor([[1 << 30, -1]] * 7)
    for i in range(7):
        q = p[i][inside[i]]
        if q.numel():
            a, b = q.min().clamp(0.0, n - 1), q.max().clamp(0.0, n - 1)
            cells[i] = torch.stack([a.floor().long(),
                                    (b.floor().long() + 1).clamp(max=n - 1)])
    return w / div, cells


def roi_align_stream_plain(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                           view_idx: torch.Tensor, strides: Sequence[int],
                           sampling_ratio: int = 0,
                           box=STREAM_BOX) -> torch.Tensor:
    """B11 / B12's streamed core in plain PyTorch, for the tests: rois
    [R, 4] image pixels on views view_idx [R] -> [R, 7, 7, C] (levels'
    dtype).  Each RoI's footprint on its routed level (the cells its bins'
    samples touch) is walked as the producer issues it, in ring slots of
    box = (YB rows, XB columns), column chunks outer and rows inner, zeros
    past the map's right or bottom edge; bin column j takes only its cells
    of each slot, contracted with its weights Wx[j, .], and each row then
    feeds the bins whose samples come within one cell of it, in float32.
    Never on the main path."""
    YB, XB = box
    C = feats[0].shape[-1]
    rois = rois.float()
    lvl = roi_levels(rois, len(feats))
    out = torch.zeros((rois.shape[0], 7, 7, C), dtype=torch.float32)
    for r in range(rois.shape[0]):
        b = rois[r].tolist()
        f = feats[int(lvl[r])][int(view_idx[r])].float()
        H, W = f.shape[:2]
        sc = 1.0 / strides[int(lvl[r])]
        y1 = float(torch.tensor(b[1]) * sc - 0.5)
        x1 = float(torch.tensor(b[0]) * sc - 0.5)
        wy, ry = _stream_axis(y1, float(torch.tensor(b[3] - b[1]) * sc),
                              sampling_ratio, H)
        wx, rx = _stream_axis(x1, float(torch.tensor(b[2] - b[0]) * sc),
                              sampling_ratio, W)
        ylo, yhi = int(ry[:, 0].min()), int(ry[:, 1].max())
        xlo, xhi = int(rx[:, 0].min()), int(rx[:, 1].max())
        if ylo > yhi or xlo > xhi:      # no sample inside the map
            continue
        for x0 in range(xlo, xhi + 1, XB):
            for y0 in range(ylo, yhi + 1, YB):
                tile = torch.zeros(YB, XB, C)
                h, w = min(YB, H - y0), min(XB, W - x0)
                tile[:h, :w] = f[y0:y0 + h, x0:x0 + w]
                rows = min(YB, yhi - y0 + 1)
                for j in range(7):
                    ca, cb = max(int(rx[j, 0]), x0), min(int(rx[j, 1]),
                                                          x0 + XB - 1)
                    if ca > cb:
                        continue
                    t = torch.einsum('x,yxc->yc', wx[j, ca:cb + 1],
                                     tile[:rows, ca - x0:cb - x0 + 1])
                    out[r, :, j] += wy[:, y0:y0 + rows] @ t
    return out.to(feats[0].dtype)


# B9's owners: tiles of OWNER_TILE x OWNER_TILE cells of each (view, level)
# map
OWNER_TILE = 8


def _roi_axes(rois: torch.Tensor, scale: torch.Tensor):
    """K3's axes of each RoI on its level: (y1, bh, x1, bw), the first
    sample's offset and the RoI's extent in cells (scale [R] = 1 / the
    level's stride)."""
    x1 = rois[:, 0] * scale - 0.5
    y1 = rois[:, 1] * scale - 0.5
    bw = (rois[:, 2] - rois[:, 0]) * scale
    bh = (rois[:, 3] - rois[:, 1]) * scale
    return y1, bh, x1, bw


def _axis_footprint(lo, extent, n):
    """[lo, hi] per RoI [R]: the cells the samples of its 7 bins touch
    along one axis (floor and floor + 1 of each clamped sample inside
    (-1, n)), lo > hi without a sample inside."""
    O = 7
    bin_ = extent / O
    ns = torch.ceil(bin_).clamp(min=0.0)
    div = ns.clamp(min=1.0)
    S = max(int(ns.max()) if ns.numel() else 0, 1)
    s = torch.arange(S, dtype=lo.dtype)
    oi = torch.arange(O, dtype=lo.dtype)
    xs = lo[:, None, None] + (oi[:, None] + (s + 0.5) / div[:, None, None]) \
        * bin_[:, None, None]                                  # [R, O, S]
    ok = (s < ns[:, None, None]) & (xs > -1.0) & (xs < n[:, None, None])
    top = (n - 1).to(lo.dtype)[:, None, None]
    c0 = torch.minimum(torch.maximum(xs, torch.zeros_like(xs)), top).floor()
    c1 = torch.minimum(c0 + 1, top)
    big = torch.full_like(xs, float(1 << 30))
    lo_c = torch.where(ok, c0, big).amin((1, 2))
    hi_c = torch.where(ok, c1, -torch.ones_like(xs)).amax((1, 2))
    return lo_c.long(), hi_c.long()


def roi_footprints_plain(rois: torch.Tensor, dims: Sequence[int],
                         strides: Sequence[int]):
    """B9's index pass.  rois [R, 4] image pixels, dims the four levels'
    (H_l, W_l) pairs -> (level [R], box [R, 4] = (ylo, yhi, xlo, xhi)):
    the cells of its level that the RoI's samples touch (K3's routing and
    adaptive ceil(bin) sampling), (2^30, -1, 2^30, -1) without a sample
    inside the map."""
    rois = rois.float()
    lvl = roi_levels(rois)
    H = torch.tensor(dims[0::2])[lvl]
    W = torch.tensor(dims[1::2])[lvl]
    scale = (1.0 / torch.tensor([float(s) for s in strides]))[lvl]
    y1, bh, x1, bw = _roi_axes(rois, scale)
    ylo, yhi = _axis_footprint(y1, bh, H)
    xlo, xhi = _axis_footprint(x1, bw, W)
    box = torch.stack([ylo, yhi, xlo, xhi], -1)
    empty = (ylo > yhi) | (xlo > xhi)
    box[empty] = torch.tensor([1 << 30, -1, 1 << 30, -1])
    return lvl, box


def _owner_tiles(dims: Sequence[int], V: int):
    """B9's tiles, numbered as its blocks are: from the coarsest level
    down, view-major within a level, row-major within a map.  -> (tyn [4],
    txn [4], first [4], total): the tiles a level spans along y and x, and
    the number of the first tile of each level's view 0."""
    T = OWNER_TILE
    tyn = torch.tensor([-(-h // T) for h in dims[0::2]])
    txn = torch.tensor([-(-w // T) for w in dims[1::2]])
    n = V * tyn * txn
    first = torch.flip(torch.cumsum(torch.flip(n, (0,)), 0), (0,)) - n
    return tyn, txn, first, int(n.sum())


def roi_owner_lists_plain(rois: torch.Tensor, dims: Sequence[int],
                          strides: Sequence[int]):
    """B9's tile lists.  rois [V, P, 4] -> (keys [M], roi [M], starts
    [ntiles + 1]): one entry for each (RoI, owner tile) pair whose
    footprint (`roi_footprints_plain`) meets the tile, keyed by the tile
    (`_owner_tiles`: first[l] + v * tiles of level l + ty * txn[l] + tx,
    tiles of OWNER_TILE cells), sorted by key, ties in RoI order (roi =
    v * P + p); tile k's entries are [starts[k], starts[k + 1])."""
    V, P = rois.shape[:2]
    T = OWNER_TILE
    lvl, box = roi_footprints_plain(rois.reshape(-1, 4), dims, strides)
    tyn, txn, first, total = _owner_tiles(dims, V)
    live = box[:, 0] <= box[:, 1]
    t0y, t1y = box[:, 0] // T, box[:, 1] // T
    t0x, t1x = box[:, 2] // T, box[:, 3] // T
    nty = torch.where(live, t1y - t0y + 1, 0)
    ntx = torch.where(live, t1x - t0x + 1, 0)
    cnt = nty * ntx
    roi = torch.repeat_interleave(torch.arange(V * P), cnt)
    local = torch.arange(int(cnt.sum())) - torch.repeat_interleave(
        torch.cumsum(cnt, 0) - cnt, cnt)
    ty = t0y[roi] + local // ntx[roi]
    tx = t0x[roi] + local % ntx[roi]
    lr = lvl[roi]
    keys = first[lr] + roi // P * tyn[lr] * txn[lr] + ty * txn[lr] + tx
    order = torch.sort(keys, stable=True).indices
    keys, roi = keys[order], roi[order]
    starts = torch.searchsorted(keys, torch.arange(total + 1))
    return keys, roi, starts


def roi_align_backward_plain(feats: Sequence[torch.Tensor],
                             rois: torch.Tensor, dout: torch.Tensor,
                             strides: Sequence[int]):
    """B9's function by its owner scheme in plain PyTorch: each entry of
    `roi_owner_lists_plain` adds Wy[i, y] Wx[j, x] dOut[r, i, j] to the
    cells of its tile (the RoI's profiles, as `_axis_weights` gives them,
    on the tile's rows and columns), and each tile's sum, in float32, goes
    to its cells of the level gradient.  Returns what
    `roi_align_multilevel_backward` does: the four levels' gradients in
    the features' dtype."""
    V, P = rois.shape[:2]
    C = feats[0].shape[-1]
    T = OWNER_TILE
    dims = [d for f in feats for d in (f.shape[1], f.shape[2])]
    keys, roi, _ = roi_owner_lists_plain(rois, dims, strides)
    tyn, txn, first, total = _owner_tiles(dims, V)
    flat = rois.reshape(-1, 4).float()
    lvl = roi_levels(flat)
    d = dout.reshape(V * P, 7, 7, C).float()
    tiles = torch.zeros((total, T, T, C))
    for l, s in enumerate(strides):
        H, W = dims[2 * l], dims[2 * l + 1]
        at = lvl[roi] == l
        if not bool(at.any()):
            continue
        e_roi, e_key = roi[at], keys[at]
        t = (e_key - first[l]) % (tyn[l] * txn[l])
        ty, tx = t // txn[l], t % txn[l]
        y1, bh, x1, bw = _roi_axes(flat[e_roi], torch.full((e_roi.numel(),),
                                                           1.0 / s))
        amax = (max(int(torch.ceil(bh / 7).max()), 1),
                max(int(torch.ceil(bw / 7).max()), 1))
        Hp, Wp = int(tyn[l]) * T, int(txn[l]) * T
        # the profiles over the level, padded to whole tiles, on the tiles'
        # rows and columns: [E, 7, T]
        wy = torch.nn.functional.pad(_axis_weights(y1, bh, H, 7, amax[0]),
                                     (0, Hp - H))
        wx = torch.nn.functional.pad(_axis_weights(x1, bw, W, 7, amax[1]),
                                     (0, Wp - W))
        ar = torch.arange(T)
        wy = wy.gather(2, (ty[:, None] * T + ar)[:, None].expand(-1, 7, -1))
        wx = wx.gather(2, (tx[:, None] * T + ar)[:, None].expand(-1, 7, -1))
        tiles.index_add_(0, e_key, torch.einsum('eiy,ejx,eijc->eyxc', wy,
                                                wx, d[e_roi]))
    grads = []
    for l, f in enumerate(feats):
        H, W = dims[2 * l], dims[2 * l + 1]
        ny, nx = int(tyn[l]), int(txn[l])
        t = tiles[int(first[l]):int(first[l]) + V * ny * nx]
        g = t.reshape(V, ny, nx, T, T, C).permute(0, 1, 3, 2, 4, 5) \
            .reshape(V, ny * T, nx * T, C)[:, :H, :W]
        grads.append(g.to(f.dtype).contiguous())
    return grads


def roi_align_multilevel_backward(feats: Sequence[torch.Tensor],
                                  rois: torch.Tensor, dout: torch.Tensor,
                                  strides: Sequence[int]):
    """Kernel B9: dOut [V, P, 7, 7, C] (feats' dtype) -> the four levels'
    gradients [V, H_l, W_l, C] in the features' dtype (K3's routing and
    sampling transposed, in separable form).  Every element is written
    once, by the owner of its tile, from a float32 sum over the RoIs that
    reach it in RoI order, so two runs give equal bits.  It is the
    backward of K3 and of B11, which compute the same function.  CPU
    tensors take `roi_align_backward_plain`; CUDA tensors launch the
    kernels (float32 or bfloat16, C % 8 == 0, levels of any side; any
    other input raises), through `mv2d::roi_align_bwd`."""
    return torch.ops.mv2d.roi_align_bwd(list(feats), rois, dout,
                                        _ints(strides))


def roi_align_multilevel_backward_cuda(feats, rois, dout, strides):
    """`mv2d::roi_align_bwd` on CUDA tensors: kernel B9."""
    V, P = rois.shape[:2]
    feats, dims, scales = _levels(feats, strides, V)
    C = feats[0].shape[-1]
    if dout.shape != (V, P, 7, 7, C) or dout.dtype != feats[0].dtype:
        raise ValueError('dout must be [V, P, 7, 7, C] in the levels\' '
                         'dtype')
    rois = rois.float().contiguous()
    dout = dout.contiguous()
    kernels.check_cuda(rois, dout)
    grads = [torch.empty_like(f) for f in feats]
    box = torch.empty((V * P, 4), dtype=torch.int32, device=rois.device)
    lvl = torch.empty((V * P,), dtype=torch.int32, device=rois.device)
    kernels.launch('mv2d_roi_align_bwd', *(g.data_ptr() for g in grads),
                   *dims, *scales, rois.data_ptr(), dout.data_ptr(),
                   box.data_ptr(), lvl.data_ptr(), V, P, C,
                   kernels.dtype_code(dout))
    roi_align_multilevel_backward.launches += 1
    return grads


roi_align_multilevel_backward.launches = 0


class RoIAlignMultilevelFn(torch.autograd.Function):
    """K3 forward, or B11 with `slab` (JAX's v2 route: the v2 forward and
    the slab backward's pallas_call); B9 backward, whose level gradients
    come back in the features' dtype as the kernel writes them.  The RoIs
    get no gradient."""

    @staticmethod
    def forward(ctx, rois, strides, slab, *feats):
        ctx.strides = strides
        ctx.save_for_backward(rois, *feats)
        fwd = roi_align_slab if slab else roi_align_multilevel
        return fwd(list(feats), rois, strides)

    @staticmethod
    def backward(ctx, dout):
        rois, *feats = ctx.saved_tensors
        return (None, None, None,
                *roi_align_multilevel_backward(feats, rois, dout,
                                               ctx.strides))


def roi_align_multilevel_train(feats: Sequence[torch.Tensor],
                               rois: torch.Tensor, strides: Sequence[int],
                               slab: bool = False) -> torch.Tensor:
    """Differentiable 7x7 multi-level RoIAlign [V, P, 7, 7, C] with the
    gradient to the features.  CPU tensors take
    `multilevel_roi_align_plain` (autograd); CUDA tensors run
    `RoIAlignMultilevelFn`: kernels K3 / B9, or with `slab` B11 / B9."""
    rois = rois.detach()
    if rois.device.type == 'cpu':
        return multilevel_roi_align_plain(feats, rois, strides)
    return RoIAlignMultilevelFn.apply(rois, tuple(strides), slab, *feats)
