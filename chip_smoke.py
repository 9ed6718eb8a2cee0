"""Smoke run of the PyTorch/CUDA port (mv2d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure exits non-zero without the final line:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from mv2d_tpu_torch/csrc (nvcc, sm_90a, one
     nvcc per source, all started together);
  3. kernels: each kernel against its plain PyTorch version (a backward
     kernel against the plain version's autograd) at the shapes of the
     eval path (12 views at 512x1408), of the training step and, for B12,
     of the JAX package's micro-bench (12000 RoIs on random views), plus
     edge cases: float32 with TF32 off (max error <= 1e-4 of the reference's
     max magnitude) and bfloat16 (<= 3e-2).  The main-path cases are
     timed (kernel, plain version, and for attention the masked
     F.scaled_dot_product_attention, timed only) beside their bound: the
     larger of the bytes the function moves over 3.35 TB/s and its
     operations over 989 TFLOP/s (H100 SXM bf16 peaks), and the bound's
     share of the kernel's time.  K2's cases also time B5 plus one
     torch.matmul on the same inputs (`b5_matmul_ms`, a yardstick the port
     never runs) and name their shape's launches per eval forward.  K1's
     case also times block 0 and an identity block alone and gives the
     chain's share of its three-launch floor (each launch reads its input
     and writes its output once: 1.45 GB at [12,128,352,64]) beside its
     share of the bound; K1 is also checked at R101's layer1 shape.  The
     attention kernels read the mask as
     the decoder hands it to them, packed once a pass (`mask_tiles`); the
     packing kernel has cases of its own, equal bit for bit, timed beside
     the whole per-pass build (the bits and both tile lists).  B5 and B6
     are timed at all four DCN stage shapes as the step calls them (every
     launch and allocation; B6's bound counts dx in the input's dtype, and
     its log line also gives the bound with a float32 dx, its first
     form's); B5 is also checked on ragged pixel tiles [1,13,21,40], B6 on
     a pile-up of every sample on one cell and a ragged [1,13,21,40].  B9
     is timed at the training RoIs [6,512] on R50's and R101's levels (its
     bound counts the level gradients in the features' dtype, and its log
     line also gives the bound with float32 ones, its first form's), and
     checked on a finest level 560 cells wide, on a pile-up of 512
     identical RoIs a view and for equal bits in two runs; the bound of
     the forward RoIAlign kernels (K3, B11, B12) counts the levels' cells
     that their RoIs' footprints cover, once per (view, level), and their
     log line also gives the bound with every level read whole; K3 is also
     timed at R101's levels and on 64 of the channels of its main case
     (`c64_ms`), and checked on slivers only.
     B13 is timed at its three stage shapes beside the route's forward +
     backward a layer (`route_fwd_bwd_ms`) and the default route's
     (`default_route_fwd_bwd_ms`), logs its transient workspace, and is
     checked on a pile-up of every sample on one cell and for equal bits in
     two runs; B10's cases time the cuDNN chain it replaces as `library`,
     log its bf16 tile and the shared memory a block takes, and are checked
     on ragged tiles at both widths and for equal bits in two runs; B11
     and B12 are timed beside K3 on the same RoIs (`k3_ms`), log their
     plan (box, ring slots, blocks an SM, registers, shared memory), and
     are checked on a finest level 560 cells wide and for equal bits in
     two runs;
  4. tiny: the tiny config with DCN, eval forward, GPU (kernels) against
     CPU (plain versions), same seeded weights;
  5. tiny_train: one tiny+DCN training step (float32, TF32 off, dropout
     0), GPU against CPU with the same weights and draws: every loss and
     every parameter's gradient;
  6. serve: three full-width MV2D-T R50 forwards (12 x 512 x 1408, k_max
     16384) in bfloat16 with seeded weights (bench fixture rules): finite
     outputs of the expected shapes, the eval kernels' launch counters
     above zero, ms per forward, and the inputs each kernel saw first
     replayed through its plain version;
  7. http: the port's HTTP server (`mv2d_tpu_torch.tools.serve`) in
     process on 127.0.0.1, built from the R50 file of configs/mv2d/ with
     align_v2 (the JAX package's MV2D_ALIGN_V2=1: kernel B11), max
     batch 2: one request, then three at once, each response equal to a
     direct forward of the same model on the same arrays, B11 launched
     once a forward and K3 never, the /metrics counts, a bad request
     answered 400; then `roi_forward` (kernel B12) on that scene's FPN
     levels and flattened proposals, its RoI features against K3's and
     B11's; then one request to a server built from the R101 1600x640
     file (k_max 24576);
  8. train: four full-width MV2D-T R50 training steps (bf16 mixed
     precision, synthetic_train_batch(seed=0), seeded weights; the first
     is warm-up): finite losses, total and grad norm, trained parameters
     moved and frozen ones not, each training kernel's launches per step,
     ms per step and peak memory, and the inputs each training kernel saw
     first replayed through its plain version;
  9. routes_tiny: the routes that the JAX package's switches select
     (`mv2d_tpu_torch.routes.Routes`), float32 with TF32 off, GPU against
     CPU: a ResNet-50 backbone with MV2D-T's DCN layout on 2 views at
     256x704 with fused_stages='all' (MV2D_FUSED_STAGES=all; B10 on
     layer2's tail, and not while gradients are recorded), one tiny+DCN
     training step with dcn_train_fused and flash_sparse
     (MV2D_DCN_TRAIN_FUSED=1, MV2D_FLASH_SPARSE=1; K2, B13 and B8, which
     answers the sparse route; B5 and B6's wrappers not called: B13 runs
     B6's walk inside its own C entry), and one with align_v2
     (MV2D_ALIGN_V2=1; B11 and B9, K3 not launched), every loss and
     gradient;
  10. routes: at full width, two bf16 eval forwards with fused_stages='all'
     and three training steps with the three training routes (B13, B8
     on the sparse attention route, and B11 with B9 for the R-CNN RoIAlign): finite outputs,
     launches, ms and peak memory beside the default route's from phases
     6 and 8, and the first inputs of each new kernel replayed through its
     plain version.
The default phases (3-6, 8) build their models with the default routes
(`Routes()`), whatever the environment holds; phase 7 sets align_v2 for
its R50 server and the default routes for its R101 server.  Each path's launch
counters are set to 0 just before it and read just after.  Then one JSON
line with the kernels' results, the card's name and power limit, and the
last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np

F32_TOL = 1e-4
BF16_TOL = 3e-2

KERNELS = {
    'fused_stage1': dict(
        source='mv2d_tpu_torch/csrc/stage1.cu',
        replaces='mv2d_tpu/ops/pallas_stage.py:201'),
    'dcn_conv': dict(
        source='mv2d_tpu_torch/csrc/dcn.cu',
        replaces='mv2d_tpu/ops/pallas_dcn.py:607'),
    'roi_align_multilevel': dict(
        source='mv2d_tpu_torch/csrc/roi_align.cu',
        replaces='mv2d_tpu/ops/pallas_roi_align.py:1263'),
    'masked_attention': dict(
        source='mv2d_tpu_torch/csrc/attention.cu',
        replaces='mv2d_tpu/ops/pallas_attention.py:179 and :78'),
    'dcn_samples': dict(
        source='mv2d_tpu_torch/csrc/dcn.cu',
        replaces='mv2d_tpu/ops/pallas_dcn.py:575'),
    'dcn_samples_backward': dict(
        source='mv2d_tpu_torch/csrc/dcn.cu',
        replaces='mv2d_tpu/ops/pallas_dcn.py:378'),
    'masked_attention_backward': dict(
        source='mv2d_tpu_torch/csrc/attention.cu',
        replaces='mv2d_tpu/ops/pallas_attention.py:328 and :491'),
    'roi_align_multilevel_backward': dict(
        source='mv2d_tpu_torch/csrc/roi_align.cu',
        replaces='mv2d_tpu/ops/pallas_roi_align.py:1524'),
    'fused_identity_chain': dict(
        source='mv2d_tpu_torch/csrc/stage.cu',
        replaces='mv2d_tpu/ops/pallas_stage.py:201 (fused_identity_chain '
                 ':253)'),
    'dcn_conv_backward': dict(
        source='mv2d_tpu_torch/csrc/dcn.cu',
        replaces='mv2d_tpu/ops/pallas_dcn.py:306'),
    'roi_align_slab': dict(
        source='mv2d_tpu_torch/csrc/roi_align_slab.cu',
        replaces='mv2d_tpu/ops/pallas_roi_align.py:1219'),
    'roi_align_flat': dict(
        source='mv2d_tpu_torch/csrc/roi_align_patch.cu',
        replaces='mv2d_tpu/ops/pallas_roi_align.py:456'),
    'mask_bits': dict(
        source='mv2d_tpu_torch/csrc/attention.cu',
        replaces='none: packs the mask that K4 and B8 read (the TPU kernels '
                 'take a bf16 mask and per-tile lists, '
                 'mv2d_tpu/ops/pallas_attention.py:192 _sparse_blocks)'),
}
# kernels that only the routing switches and other entry points reach:
# none on the default paths
ROUTED_KERNELS = ('fused_identity_chain', 'dcn_conv_backward',
                  'roi_align_slab', 'roi_align_flat')
SERVE_KERNELS = ('fused_stage1', 'dcn_conv', 'roi_align_multilevel',
                 'masked_attention', 'mask_bits')
# the decoder packs its self- and cross-attention masks once a pass
MASKS_PER_PASS = 2
# launches per training step (K1: 3 bottlenecks; K3: at least the no-grad
# detect pass and the R-CNN RoIs)
TRAIN_PER_STEP = {'fused_stage1': 3, 'dcn_samples': 9,
                  'dcn_samples_backward': 9, 'masked_attention': 12,
                  'masked_attention_backward': 12,
                  'roi_align_multilevel_backward': 1,
                  'mask_bits': MASKS_PER_PASS,
                  **{n: 0 for n in ROUTED_KERNELS}}
# launches per training step with the dcn_train_fused, flash_sparse and
# align_v2 routes (K2: the nine DCN convs' forwards; B13 their backwards,
# with B6's walk inside its own C entry, so B6's wrapper counts none; B8
# answers the sparse attention's backward; B11: the detect pass and the
# R-CNN RoIs)
ROUTED_TRAIN_PER_STEP = {'fused_stage1': 3, 'dcn_conv': 9,
                         'dcn_conv_backward': 9, 'dcn_samples': 0,
                         'dcn_samples_backward': 0, 'masked_attention': 12,
                         'masked_attention_backward': 12,
                         'roi_align_multilevel': 0, 'roi_align_slab': 2,
                         'roi_align_multilevel_backward': 1,
                         'fused_identity_chain': 0, 'roi_align_flat': 0,
                         'mask_bits': MASKS_PER_PASS}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM
BF16_OPS_PER_S = 989e12


def counters():
    """Kernel name -> the wrapper that holds its launch counter."""
    from mv2d_tpu_torch.ops import attention, dcn, roi_align, stage
    return {'fused_stage1': stage.fused_stage1, 'dcn_conv': dcn.dcn_conv,
            'roi_align_multilevel': roi_align.roi_align_multilevel,
            'masked_attention': attention.masked_attention,
            'dcn_samples': dcn.dcn_samples_forward,
            'dcn_samples_backward': dcn.dcn_samples_backward,
            'masked_attention_backward':
                attention.masked_attention_backward,
            'roi_align_multilevel_backward':
                roi_align.roi_align_multilevel_backward,
            'fused_identity_chain': stage.fused_identity_chain,
            'dcn_conv_backward': dcn.dcn_conv_backward,
            'roi_align_slab': roi_align.roi_align_slab,
            'roi_align_flat': roi_align.roi_align_flat,
            'mask_bits': attention.mask_bits}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, n=5):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def compare(kernel_out, plain_out):
    """(max abs error, max abs error / max |plain|, finite)."""
    k = kernel_out.float()
    p = plain_out.float()
    err = (k - p).abs().max().item()
    scale = max(p.abs().max().item(), 1e-6)
    return err, err / scale, bool(torch_isfinite(k))


def torch_isfinite(t):
    import torch
    return torch.isfinite(t).all().item()


def compare_all(kernel_outs, plain_outs):
    """compare() over paired tensors: (worst abs error, worst relative
    error, all finite, shapes equal)."""
    errs = [compare(k, p) for k, p in zip(kernel_outs, plain_outs)]
    same = len(kernel_outs) == len(plain_outs) and all(
        k.shape == p.shape for k, p in zip(kernel_outs, plain_outs))
    return (max(e[0] for e in errs), max(e[1] for e in errs),
            all(e[2] for e in errs), same)


def cotangent(like, seed=7):
    """A seeded N(0, 1) cotangent of `like`'s shape, dtype and device."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randn(like.shape, generator=g).to(like.device, like.dtype)


def plain_grads(fn, args, diff, cot):
    """(output, gradients of <output, cot> w.r.t. args[i] for i in diff)
    through fn's autograd; the other args pass through unchanged."""
    import torch
    leaves = list(args)
    for i in diff:
        leaves[i] = args[i].detach().clone().requires_grad_(True)
    with torch.enable_grad():
        out = fn(*leaves)
        grads = torch.autograd.grad(out, [leaves[i] for i in diff], cot,
                                    allow_unused=True)
    # an input the function never read (a RoIAlign level no RoI routes
    # to) has a zero gradient
    return out.detach(), [torch.zeros_like(leaves[i]) if g is None
                          else g.detach() for i, g in zip(diff, grads)]


# ----------------------------------------------------------- kernel inputs

def stage1_inputs(dev, dtype, V=12, H=128, W=352, seed=0):
    import torch
    from mv2d_tpu_torch.nn.resnet import ResNet
    from mv2d_tpu_torch.synthetic import init_random_weights
    g = torch.Generator().manual_seed(seed)
    net = init_random_weights(ResNet(50), seed)
    with torch.no_grad():
        for m in net.layer1.modules():     # random frozen-BN statistics
            if hasattr(m, 'running_var'):
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.running_mean.normal_(0, 0.1, generator=g)
        blocks = [{k: v.to(dev) for k, v in blk.folded().items()}
                  for blk in net.layer1]
    x = torch.randn(V, H, W, 64, generator=g).relu().to(dev, dtype)
    return x, blocks


def identity_chain_inputs(dev, dtype, V=12, H=64, W=176, stage=1,
                          seed=0):
    """x [V, H, W, 4P] and the folded identity blocks 1..n-1 of stage
    `stage` (P = 64 * 2**stage) of a seeded ResNet-50 with random frozen-BN
    statistics."""
    import torch
    from mv2d_tpu_torch.nn.resnet import ResNet
    from mv2d_tpu_torch.synthetic import init_random_weights
    g = torch.Generator().manual_seed(seed)
    layer = getattr(init_random_weights(ResNet(50), seed), f'layer{stage + 1}')
    with torch.no_grad():
        for m in layer.modules():
            if hasattr(m, 'running_var'):
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.running_mean.normal_(0, 0.1, generator=g)
        blocks = [{k: v.to(dev) for k, v in blk.folded().items()}
                  for blk in layer[1:]]
    x = torch.randn(V, H, W, blocks[0]['w1'].shape[0],
                    generator=g).relu().to(dev, dtype)
    return x, blocks


def dcn_inputs(dev, dtype, V, H, W, C, F, stride, seed=0, far=0.0):
    """Sample coordinates around the 3x3 stride grid with N(0, 2) offsets;
    a `far` share of them moved well outside the map."""
    import torch
    g = torch.Generator().manual_seed(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    ys = torch.arange(Ho) * stride - 1.0
    xs = torch.arange(Wo) * stride - 1.0
    k = torch.arange(3.0)
    by = (ys[:, None, None] + k.repeat_interleave(3)[None, None]) \
        .expand(Ho, Wo, 9)
    bx = (xs[None, :, None] + k.repeat(3)[None, None]).expand(Ho, Wo, 9)
    sy = by[None] + 2 * torch.randn(V, Ho, Wo, 9, generator=g)
    sx = bx[None] + 2 * torch.randn(V, Ho, Wo, 9, generator=g)
    if far:
        jump = torch.rand(V, Ho, Wo, 9, generator=g) < far
        sy = torch.where(jump, sy + (H + 50) * torch.sign(
            torch.randn(V, Ho, Wo, 9, generator=g)), sy)
        sx = torch.where(jump, sx - (W + 80), sx)
    mask = torch.rand(V, Ho, Wo, 9, generator=g)
    x = torch.randn(V, H, W, C, generator=g)
    w = torch.randn(9, C, F, generator=g) * (9 * C) ** -0.5
    return (x.to(dev, dtype), sy.to(dev).contiguous(),
            sx.to(dev).contiguous(), mask.to(dev), w.to(dev, dtype))


def attention_inputs(dev, dtype, Q=900, K=16384, C=256, seed=0,
                     self_attn=False):
    """Projected q/k/v and a correlation-like mask: each query sees a few
    contiguous key runs (~3% of keys); 10% of the rows see nothing."""
    import torch
    g = torch.Generator().manual_seed(seed)
    if self_attn:
        K = Q
        valid = torch.rand(K, generator=g) < 0.8
        allowed = valid[None, :] | torch.eye(Q, dtype=torch.bool)
    else:
        allowed = torch.zeros(Q, K, dtype=torch.bool)
        starts = torch.randint(0, K - 600, (Q, 3), generator=g)
        lens = torch.randint(50, 300, (Q, 3), generator=g)
        ar = torch.arange(K)
        for j in range(3):
            allowed |= (ar[None] >= starts[:, j:j + 1]) & \
                (ar[None] < starts[:, j:j + 1] + lens[:, j:j + 1])
        allowed[torch.rand(Q, generator=g) < 0.1] = False
    q = torch.randn(Q, C, generator=g)
    k = torch.randn(K, C, generator=g)
    v = torch.randn(K, C, generator=g)
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            allowed.to(dev))




def train_attention_inputs(dev, dtype, self_attn=False, Q=2628, K=16384,
                           C=256, dn=960, G=96, seed=0):
    """The training decoder's attention at full width: Q = 960 DN rows +
    12 * (75 + 64) queries.  Cross: DN rows see every valid key (85%; the
    rest are keys no row may attend), the others a few correlated runs,
    10% of them none.  Self: the DN block mask (DN groups of 96 see
    themselves, match queries no DN row, 80% of slots valid)."""
    import torch
    from types import SimpleNamespace
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.models.mv2d import MV2D
    g = torch.Generator().manual_seed(seed)
    if self_attn:
        K = Q
        cfg = configs.mv2d_t_r50()
        host = SimpleNamespace(cfg=cfg)
        valid = torch.rand(Q, generator=g) < 0.8
        allowed = MV2D._dn_self_mask(host, valid[dn:], valid[:dn])
    else:
        key_ok = torch.rand(K, generator=g) < 0.85
        _, _, _, runs = attention_inputs('cpu', torch.float32, Q=Q - dn, K=K,
                                         C=8, seed=seed)
        allowed = torch.cat([key_ok[None].expand(dn, K), runs & key_ok])
    q = torch.randn(Q, C, generator=g)
    k = torch.randn(K, C, generator=g)
    v = torch.randn(K, C, generator=g)
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            allowed.to(dev))


# ------------------------------------------------------------ kernel cases

class Case:
    """One kernel case: `kernel()` and `plain()` give the results to
    compare (a tensor or a sequence of tensors), `work` = (bytes, ops) of
    the function for its bound, `library()` one PyTorch call computing the
    same function (timed only), or None; `extra` names further calls timed
    beside them (the default route's kernels for the same work, the
    per-pass build around a kernel, single launches of a chain, or a
    yardstick the port never runs); an `exact` case must equal its plain
    version bit for bit; `note` ends its line: a string, or a function of
    the kernel's measured ms (None where the case is not timed)."""

    def __init__(self, kernel, plain, work, library=None, extra=None,
                 exact=False, note=''):
        self.kernel, self.plain = kernel, plain
        self.work, self.library = work, library
        self.extra = extra or {}
        self.exact = exact
        self.note = note


def nbytes(*tensors):
    return float(sum(t.numel() * t.element_size() for t in tensors))


def bound(work):
    """(bound_ms, bound_by) of (bytes, operations) at the H100's peaks."""
    b, ops = work
    t_b, t_o = b / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_b, t_o) * 1e3, ('bytes' if t_b >= t_o else 'operations')


def as_list(x):
    import torch
    return [x] if torch.is_tensor(x) else list(x)


def roi_samples(rois, feats, strides, sampling_ratio=0):
    """Bilinear samples RoIAlign takes for these RoIs (adaptive ceil(bin),
    or a fixed ratio)."""
    import torch
    from mv2d_tpu_torch.ops.roi_align import roi_levels
    if sampling_ratio > 0:
        return float(rois[..., 0].numel()) * 49 * sampling_ratio ** 2
    lvl = roi_levels(rois.float())
    scale = 1.0 / torch.tensor(strides, device=rois.device)[lvl]
    ext = (rois[..., 2:] - rois[..., :2]).float() * scale[..., None] / 7
    n = torch.ceil(ext).clamp(min=0)
    return float((n[..., 0] * n[..., 1]).sum()) * 49


def _axis_cells(lo, extent, sampling_ratio, n):
    """One axis of each RoI as the RoIAlign kernels read it (`Axis` in
    csrc/roi_axis.cuh): lo, extent [N] in cells of a level n cells long ->
    (first, last) [N] cells its samples inside (-1, n) touch, each sample
    clamped to [0, n - 1] and taking its cell and the next; first > last
    where no sample lies inside."""
    import torch
    bin_ = extent / 7
    if sampling_ratio > 0:
        ns = torch.full_like(bin_, float(sampling_ratio))
    else:
        ns = torch.ceil(bin_).clamp(min=0)
    m = max(int(ns.max()), 1)           # at least one slot (masked off)
    s = torch.arange(m, device=lo.device, dtype=torch.float32)
    i = torch.arange(7, device=lo.device, dtype=torch.float32)
    div = ns.clamp(min=1)[:, None, None]
    p = (lo[:, None, None] + (i[None, :, None] + (s + 0.5) / div) *
         bin_[:, None, None]).flatten(1)
    ok = (s < ns[:, None, None]).expand(-1, 7, -1).flatten(1) & \
        (p > -1.0) & (p < n)
    inf = torch.tensor(float('inf'), device=lo.device)
    first = torch.where(ok, p, inf).amin(1).clamp(0, n - 1)
    last = torch.where(ok, p, -inf).amax(1).clamp(0, n - 1)
    first, last = first.floor().long(), (last.floor().long() + 1).clamp(
        max=n - 1)
    empty = ~ok.any(1)
    return first.masked_fill(empty, 1), last.masked_fill(empty, 0)


def roi_read_bytes(feats, rois, views, strides, sampling_ratio=0):
    """The bytes of the levels RoIAlign must read for these RoIs: per
    (view, level), the union of the footprints (the cells their samples
    touch) of the RoIs routed there, each cell once."""
    import torch
    from mv2d_tpu_torch.ops.roi_align import roi_levels
    rois = rois.reshape(-1, 4).float()
    views = views.reshape(-1).long()
    lvl = roi_levels(rois, len(feats))
    cells = 0
    for l, f in enumerate(feats):
        V, H, W = f.shape[:3]
        b = rois[lvl == l] / strides[l]
        if not b.numel():
            continue
        y0, y1 = _axis_cells(b[:, 1] - 0.5, b[:, 3] - b[:, 1],
                             sampling_ratio, H)
        x0, x1 = _axis_cells(b[:, 0] - 0.5, b[:, 2] - b[:, 0],
                             sampling_ratio, W)
        keep = (y0 <= y1) & (x0 <= x1)
        v = views[lvl == l][keep]
        y0, y1, x0, x1 = y0[keep], y1[keep] + 1, x0[keep], x1[keep] + 1
        # each footprint +1 on a difference grid, summed up both axes
        d = torch.zeros((V, H + 1, W + 1), dtype=torch.int32,
                        device=rois.device)
        for yy, xx, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                             (y1, x1, 1)):
            d.index_put_((v, yy, xx), torch.full_like(v, sign,
                                                      dtype=torch.int32),
                         accumulate=True)
        cells += int((d.cumsum(1).cumsum(2)[:, :H, :W] > 0).sum())
    return float(cells * feats[0].shape[-1] * feats[0].element_size())


def kernel_cases():
    """(kernel name, case label, main-path shape?, build(dev, dtype) ->
    Case)."""
    import torch
    import torch.nn.functional as F
    from mv2d_tpu_torch import synthetic
    from mv2d_tpu_torch.ops import attention, dcn, roi_align, stage

    def stage1(V=12, H=128, W=352):
        def build(dev, dt):
            x, blocks = stage1_inputs(dev, dt, V, H, W)
            # packed as nn.resnet hands them to the kernel
            blocks = [stage.pack_block(b, dt) for b in blocks]
            N = x.shape[0] * x.shape[1] * x.shape[2]
            macs = sum(w.numel() for blk in blocks for k, w in blk.items()
                       if k.startswith('w'))
            y = stage.bottleneck_plain(x, blocks[0])
            # the chain's form, one launch per bottleneck, must read each
            # launch's input and write its output: x + 5 x 256-channel maps
            floor = bound((nbytes(x) * 21 + macs * 2, 2.0 * N * macs))[0]

            def note(ms):
                return f'  three-launch floor {floor:.3f} ms' + (
                    f' ({floor / ms:.1%} of the kernel)' if ms else '')
            return Case(lambda: stage.fused_stage1(x, blocks),
                        lambda: stage.fused_stage1_plain(x, blocks),
                        (nbytes(x) * 5 + macs * 2, 2.0 * N * macs),
                        extra={'block0_ms': lambda: stage.bottleneck_cuda(
                                   x, blocks[0]),
                               'identity_ms': lambda: stage.bottleneck_cuda(
                                   y, blocks[1])},
                        note=note)
        return build

    def identity_chain(V, H, W, stage_index, repeat=False):
        def build(dev, dt):
            x, blocks = identity_chain_inputs(dev, dt, V, H, W, stage_index)
            N = x.shape[0] * x.shape[1] * x.shape[2]
            macs = sum(w.numel() for blk in blocks for k, w in blk.items()
                       if k.startswith('w'))
            planes = blocks[0]['w1'].shape[1]
            th, tw, smem = stage.identity_block_plan(planes)
            tiles = V * -(-H // th) * -(-W // tw)
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            note = (f'  bf16 tile {th}x{tw}, {smem / 1024:.1f} KB shared a '
                    f'block, {tiles} tiles on {min(tiles, sms)} blocks')

            def kernel():
                return stage.fused_identity_chain(x, blocks)

            def cudnn():            # the unfused chain B10 replaces
                return stage.fused_identity_chain_plain(x, blocks)
            # `repeat`: a second run of the kernel, to be equal bit for bit
            return Case(kernel, kernel if repeat else cudnn,
                        (nbytes(x) * 2 + macs * x.element_size(),
                         2.0 * N * macs), library=cudnn, exact=repeat,
                        note=note)
        return build

    def dcn_conv(V, H, W, C, F_, s, far=0.0, integer=False, per_forward=0):
        def build(dev, dt):
            x, sy, sx, m, w = dcn_inputs(dev, dt, V, H, W, C, F_, s, far=far)
            if integer:                 # zero offsets: integer coordinates
                sy, sx = sy.round(), sx.round()
            args = (x, sy, sx, m, w)
            N = sy.numel() // 9

            def b5_matmul():            # a yardstick the port never runs
                smp = dcn.dcn_samples_forward(x, sy, sx, m)
                return smp.reshape(N, -1) @ w.reshape(-1, F_)
            return Case(lambda: dcn.dcn_conv(*args),
                        lambda: dcn.dcn_conv_plain(*args),
                        (nbytes(x, sy, sx, m, w) + N * F_ * x.element_size(),
                         2.0 * N * 9 * C * F_),
                        extra={'b5_matmul_ms': b5_matmul} if per_forward
                        else None,
                        note=f'  {per_forward} a forward' if per_forward
                        else '')
        return build

    def samples_args(dev, dt, V, H, W, C, s, far, integer, pile=False):
        x, sy, sx, m, _ = dcn_inputs(dev, dt, V, H, W, C, 64, s, far=far)
        if integer:                     # zero offsets: integer coordinates
            sy, sx = sy.round(), sx.round()
        if pile:                        # every in-map sample on one cell
            inside = (sy > -1) & (sy < H) & (sx > -1) & (sx < W)
            sy = torch.where(inside, torch.full_like(sy, 5.25), sy)
            sx = torch.where(inside, torch.full_like(sx, 7.5), sx)
        return x, sy.contiguous(), sx.contiguous(), m

    def dcn_fwd(V, H, W, C, s, far=0.0, integer=False, per_step=0):
        def build(dev, dt):
            x, sy, sx, m = samples_args(dev, dt, V, H, W, C, s, far, integer)
            out_bytes = sy.numel() * C * x.element_size()
            return Case(lambda: dcn.dcn_samples_forward(x, sy, sx, m),
                        lambda: dcn.dcn_samples_plain(x, sy, sx, m),
                        (nbytes(x, sy, sx, m) + out_bytes,
                         8.0 * sy.numel() * C),
                        note=f'  {per_step} a step' if per_step else '')
        return build

    def dcn_bwd(V, H, W, C, s, far=0.0, integer=False, pile=False,
                per_step=0):
        def build(dev, dt):
            x, sy, sx, m = samples_args(dev, dt, V, H, W, C, s, far, integer,
                                        pile)
            leaves = [t.clone().requires_grad_(True) for t in (x, sy, sx, m)]
            with torch.enable_grad():
                out = dcn.dcn_samples_plain(*leaves)
            g = cotangent(out)
            # dx in x.dtype, as B6 writes it; B6's first form wrote a
            # float32 dx, and its bound counted that
            moved = nbytes(x, sy, sx, m, g) + 3 * nbytes(sy)
            old = bound((moved + x.numel() * 4, 20.0 * sy.numel() * C))[0]
            note = (f'  {per_step} a step;' if per_step else '') + \
                f'  bound with a float32 dx (B6\'s first form) {old:.3f} ms'
            return Case(
                lambda: dcn.dcn_samples_backward(x, sy, sx, m, g),
                lambda: torch.autograd.grad(out, leaves, g,
                                            retain_graph=True),
                (moved + nbytes(x), 20.0 * sy.numel() * C), note=note)
        return build

    def dcn_conv_bwd(V, H, W, C, F_, s, far=0.0, integer=False, pile=False,
                     repeat=False):
        def build(dev, dt):
            x, sy, sx, m, w = dcn_inputs(dev, dt, V, H, W, C, F_, s, far=far)
            if integer:                 # zero offsets: integer coordinates
                sy, sx = sy.round(), sx.round()
            if pile:                    # every in-map sample on one cell
                inside = (sy > -1) & (sy < H) & (sx > -1) & (sx < W)
                sy = torch.where(inside, torch.full_like(sy, 5.25), sy)
                sx = torch.where(inside, torch.full_like(sx, 7.5), sx)
            args = (x, sy.contiguous(), sx.contiguous(), m, w)
            leaves = [t.clone().requires_grad_(True) for t in args]
            with torch.enable_grad():
                out = dcn.dcn_conv_plain(*leaves)
            g = cotangent(out)
            N = sy.numel() // 9
            Ho, Wo = sy.shape[1:3]
            work = dcn.conv_backward_workspace(
                V, H, W, C, Ho, Wo, F_, 0 if dt == torch.float32 else 1)

            def kernel():
                return dcn.dcn_conv_backward(*args, g)

            def fwd_bwd(fn):            # a route's forward and backward
                with torch.enable_grad():
                    return torch.autograd.grad(fn(*leaves), leaves, g)

            def default_route(x_, sy_, sx_, m_, w_):   # B5 + matmul
                smp = dcn.dcn_samples(x_, sy_, sx_, m_)
                return (smp.reshape(N, -1) @ w_.reshape(-1, F_)).reshape(
                    out.shape)
            # dx and dw in the inputs' dtypes, as B13 writes them; `repeat`:
            # a second run of the kernel, to be equal bit for bit
            return Case(
                kernel, kernel if repeat else lambda: torch.autograd.grad(
                    out, leaves, g, retain_graph=True),
                (nbytes(x, sy, sx, m, w, g) + nbytes(x, w) + 3 * nbytes(sy),
                 4.0 * N * 9 * C * F_),
                extra={'route_fwd_bwd_ms':
                       lambda: fwd_bwd(dcn.dcn_conv_train),
                       'default_route_fwd_bwd_ms':
                       lambda: fwd_bwd(default_route)},
                exact=repeat,
                note=f'  workspace {work / 2 ** 20:.1f} MiB (ds, B6\'s '
                     f'lists, dw\'s split partials)')
        return build

    def roi(edge, V=12, P=1000, img=(512, 1408), sliver=False, c64=False):
        def build(dev, dt):
            feats, rois = synthetic.roi_inputs(dev, dt, V=V, P=P, img=img,
                                               edge=edge, sliver=sliver)
            strides = (4, 8, 16, 32)
            work, whole = roi_work(feats, rois, slot_views(rois))
            # the same RoIs on 64 of the channels: a time that barely
            # moves with C says the bytes are not what paces the kernel
            f64 = [f[..., :64].contiguous() for f in feats] if c64 else None
            return Case(
                lambda: roi_align.roi_align_multilevel(feats, rois, strides),
                lambda: roi_align.multilevel_roi_align_plain(feats, rois,
                                                             strides),
                work,
                extra={'c64_ms': lambda: roi_align.roi_align_multilevel(
                    f64, rois, strides)} if c64 else None,
                note=whole_note('', whole))
        return build

    def slot_views(rois):
        """The view of each RoI of rois [V, P, 4], flattened."""
        V, P = rois.shape[:2]
        return torch.arange(V, device=rois.device).repeat_interleave(P)

    def roi_work(feats, rois, views, S=0, inputs=()):
        """((bytes, ops), whole) of a forward RoIAlign over these RoIs: the
        levels' cells their footprints cover, read once per (view, level),
        the RoIs and `inputs` read and the output written once; `whole` is
        the bound in ms with every level read whole, the count these cases
        first used."""
        strides = (4, 8, 16, 32)
        C = feats[0].shape[-1]
        moved = nbytes(rois, *inputs) + \
            rois[..., 0].numel() * 49 * C * feats[0].element_size()
        ops = 8.0 * C * roi_samples(rois, feats, strides, S)
        whole = bound((moved + nbytes(*feats), ops))[0]
        return (moved + roi_read_bytes(feats, rois, views, strides, S),
                ops), whole

    def whole_note(note, whole):
        """`note`, and where the case is timed, its whole-level bound."""
        return lambda ms: note + ('' if ms is None else
                                  f'  bound with the levels read whole '
                                  f'{whole:.3f} ms')

    def stream_note(dt):
        """B11 / B12's plan: the core's boxes, ring, blocks an SM,
        registers and shared memory, as the kernel reports them."""
        p = roi_align.stream_plan(dt)
        return (f'  plan: TMA boxes of 1 row x {p["box_columns"]} columns '
                f'into {p["stages"]} slots of {p["slot_rows"]} rows x '
                f'{p["slot_columns"]} columns, {p["blocks_per_sm"]} blocks '
                f'an SM, {p["registers"]} registers a thread, {p["smem"]} '
                f'bytes of dynamic shared memory a block')

    def slab(edge, V=12, P=1000, repeat=False, wide=False):
        def build(dev, dt):
            if wide:
                feats, rois = synthetic.wide_roi_inputs(dev, dt)
            else:
                feats, rois = synthetic.roi_inputs(dev, dt, V=V, P=P,
                                                   edge=edge)
            strides = (4, 8, 16, 32)
            work, whole = roi_work(feats, rois, slot_views(rois))

            def kernel():
                return roi_align.roi_align_slab(feats, rois, strides)
            # `repeat`: a second run of the kernel, to be equal bit for bit
            return Case(
                kernel, kernel if repeat else
                lambda: roi_align.multilevel_roi_align_plain(feats, rois,
                                                             strides),
                work,
                extra={'k3_ms': lambda: roi_align.roi_align_multilevel(
                    feats, rois, strides)},
                exact=repeat,
                note=whole_note(stream_note(dt) if not (
                    edge or repeat or wide) and P == 1000 else '', whole))
        return build

    def flat(S, edge=False, repeat=False, wide=False):
        def build(dev, dt):
            if wide:
                feats, vp = synthetic.wide_roi_inputs(dev, dt)
                rois = vp.reshape(-1, 4)
                views = torch.arange(vp.shape[0], device=dev,
                                     dtype=torch.int32).repeat_interleave(
                                         vp.shape[1])
            else:
                feats, rois, views = synthetic.flat_roi_inputs(dev, dt,
                                                               edge=edge)
                # context: K3 on the same RoIs, 1000 a view
                vp = rois.reshape(feats[0].shape[0], -1, 4)
            strides = (4, 8, 16, 32)
            work, whole = roi_work(feats, rois, views, S, inputs=(views,))

            def kernel():
                return roi_align.roi_align_flat(feats, rois, views, strides,
                                                S)
            return Case(
                kernel, kernel if repeat else
                lambda: roi_align.multilevel_roi_align_flat_plain(
                    feats, rois, views, strides, S),
                work,
                extra={'k3_ms': lambda: roi_align.roi_align_multilevel(
                    feats, vp, strides)},
                exact=repeat,
                note=whole_note(stream_note(dt) if not (
                    edge or repeat or wide) and S == 0 else '', whole))
        return build

    def roi_bwd(edge, V=6, P=512, img=(512, 1408), pile=False,
                repeat=False, wide=False):
        def build(dev, dt):
            if wide:
                feats, rois = synthetic.wide_roi_inputs(dev, dt)
            else:
                feats, rois = synthetic.roi_inputs(dev, dt, V=V, P=P,
                                                   img=img, edge=edge)
            if pile:                    # every RoI the same box (level 1)
                rois[:] = torch.tensor([300.0, 100.0, 420.0, 230.0],
                                       device=rois.device)
            strides = (4, 8, 16, 32)
            C = feats[0].shape[-1]
            leaves = [f.clone().requires_grad_(True) for f in feats]
            with torch.enable_grad():
                out = roi_align.multilevel_roi_align_plain(leaves, rois,
                                                           strides)
            g = cotangent(out)
            ops = 8.0 * C * roi_samples(rois, feats, strides)
            # the level gradients in the features' dtype, as B9 writes
            # them; B9's first form wrote float32 ones, and its bound
            # counted that
            old = bound((nbytes(g, rois) + sum(f.numel() for f in feats) * 4,
                         ops))[0]

            def kernel():
                return roi_align.roi_align_multilevel_backward(
                    feats, rois, g, strides)

            def autograd():             # zeros for a level no RoI reads
                return [torch.zeros_like(f) if d is None else d
                        for f, d in zip(feats, torch.autograd.grad(
                            out, leaves, g, retain_graph=True,
                            allow_unused=True))]
            # `repeat`: a second run of the kernel, to be equal bit for bit
            plain = kernel if repeat else autograd
            # the owners' lists: RoIs a tile, mean and max, p2..p5
            dims = [d for f in feats for d in f.shape[1:3]]
            keys, _, starts = roi_align.roi_owner_lists_plain(
                rois.cpu(), dims, strides)
            n = (starts[1:] - starts[:-1]).float()
            tyn, txn, first, _ = roi_align._owner_tiles(dims, V)
            lists = ', '.join(
                f'{float(p.mean()):.1f}/{int(p.max())}' for p in (
                    n[int(first[l]):int(first[l] + V * tyn[l] * txn[l])]
                    for l in range(4)))
            return Case(kernel, plain, (nbytes(g, rois, *feats), ops),
                        exact=repeat,
                        note=f'  bound with float32 level gradients (B9\'s '
                             f'first form) {old:.3f} ms; {keys.numel()} '
                             f'(RoI, tile) pairs, RoIs a tile p2..p5 '
                             f'mean/max {lists}')
        return build

    def sdpa_args(q, k, v, a, H):
        Q, C = q.shape
        D = C // H

        def heads(t):
            return t.reshape(t.shape[0], H, D).transpose(0, 1)[None]
        return heads(q), heads(k), heads(v), a[None, None]

    def attn(inputs, train=False):
        def build(dev, dt):
            q, k, v, a = inputs(dev, dt)
            # the decoder packs each mask once a pass (mask_bits' own cases)
            # and every layer's K4 reads the packed form
            tl = attention.mask_tiles(a)
            nnz = float(a.sum())
            note = f'  {int(tl.key_starts[-1])} active 64x64 tile pairs'
            C = q.shape[1]
            work = (nbytes(q, k, v, *tl) + nbytes(q)
                    + q.shape[0] * 8 * 4, 4.0 * C * nnz)
            sq, sk, sv, sm = sdpa_args(q, k, v, a, 8)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                sq, sk, sv, attn_mask=sm)
            if train:        # K4 with its log-sum-exp, the training forward
                return Case(
                    lambda: attention.masked_attention_forward(q, k, v, a,
                                                               8, tl),
                    lambda: (attention.masked_attention_plain(q, k, v, a, 8),
                             attention.attention_lse_plain(q, k, a, 8)),
                    work, lib, note=note)
            return Case(lambda: attention.masked_attention(q, k, v, a, 8,
                                                           tl),
                        lambda: attention.masked_attention_plain(q, k, v, a,
                                                                 8),
                        work, lib, note=note)
        return build

    def attn_bwd(inputs, sparse=False):
        def build(dev, dt):
            q, k, v, a = inputs(dev, dt)
            tl = attention.mask_tiles(a)
            out, lse = attention.masked_attention_forward(q, k, v, a, 8, tl)
            g = cotangent(out)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            sl = [t.requires_grad_(True) for t in
                  (x.detach().clone() for x in sdpa_args(q, k, v, a, 8)[:3])]
            with torch.enable_grad():
                pout = attention.masked_attention_plain(*leaves, a, 8)
                lout = F.scaled_dot_product_attention(
                    *sl, attn_mask=a[None, None])
            lg = sdpa_args(g, g, g, a, 8)[0]
            nnz = float(a.sum())
            b8 = (lambda: attention.masked_attention_backward(  # noqa: E731
                q, k, v, a, out, lse, g, 8, tl))
            if sparse:       # the MV2D_FLASH_SPARSE route's backward: B8
                rl = [t.clone().requires_grad_(True) for t in (q, k, v)]
                with torch.enable_grad():
                    rout = attention.masked_attention_train(
                        *rl, a, 8, sparse=True, tiles=tl)
                kernel = (lambda: torch.autograd.grad(  # noqa: E731
                    rout, rl, g, retain_graph=True))
            return Case(
                kernel if sparse else b8,
                lambda: torch.autograd.grad(pout, leaves, g,
                                            retain_graph=True),
                (nbytes(q, k, v, out, g, lse, *tl)
                 + 4.0 * (q.numel() + 2 * k.numel()),
                 10.0 * q.shape[1] * nnz),
                lambda: torch.autograd.grad(lout, sl, lg,
                                            retain_graph=True))
        return build

    def eval_attn(self_attn):
        return lambda dev, dt: attention_inputs(dev, dt, self_attn=self_attn)

    def train_attn(self_attn):
        return lambda dev, dt: train_attention_inputs(dev, dt, self_attn)

    def full_attn(dev, dt):             # every pair allowed
        q, k, v, a = attention_inputs(dev, dt, Q=300, K=2048)
        return q, k, v, torch.ones_like(a)

    def no_attn(dev, dt):               # no pair allowed
        q, k, v, a = attention_inputs(dev, dt, Q=300, K=2048)
        return q, k, v, torch.zeros_like(a)

    def ragged_attn(dev, dt):           # ragged tiles, K < 64 in the last
        return attention_inputs(dev, dt, Q=101, K=1000, C=256)

    def bits(inputs):
        def build(dev, dt):
            a = inputs(dev, dt)[3]
            Q, K = a.shape
            # mask_tiles_ms: the whole per-pass build, the bits and both
            # tile lists, that K4 and B8's times leave out
            return Case(lambda: attention.mask_bits(a).view(torch.uint8),
                        lambda: attention.mask_bits_plain(a).view(
                            torch.uint8),
                        (nbytes(a) + Q * -(-K // 64) * 8.0, 0.0),
                        exact=True,
                        extra={'mask_tiles_ms':
                               lambda: attention.mask_tiles(a)})
        return build

    return [
        ('fused_stage1', 'layer1 [12,128,352,64]', True, stage1()),
        ('fused_stage1', 'R101 layer1 [12,160,400,64]', False,
         stage1(12, 160, 400)),
        ('fused_stage1', 'edge: ragged tiles [3,13,70,64]', False,
         stage1(3, 13, 70)),
        ('fused_stage1', 'edge: under one tile [1,5,7,64]', False,
         stage1(1, 5, 7)),
        ('dcn_conv', 'stage3 s2 [12,64,176,256]', True,
         dcn_conv(12, 64, 176, 256, 256, 2, per_forward=1)),
        ('dcn_conv', 'stage3 s1 [12,32,88,256]', True,
         dcn_conv(12, 32, 88, 256, 256, 1, per_forward=5)),
        ('dcn_conv', 'stage4 s2 [12,32,88,512]', True,
         dcn_conv(12, 32, 88, 512, 512, 2, per_forward=1)),
        ('dcn_conv', 'stage4 s1 [12,16,44,512]', True,
         dcn_conv(12, 16, 44, 512, 512, 1, per_forward=2)),
        ('dcn_conv', 'edge: 20% offsets far outside', False,
         dcn_conv(12, 16, 44, 512, 512, 1, far=0.2)),
        ('dcn_conv', 'edge: integer coordinates', False,
         dcn_conv(12, 16, 44, 512, 512, 1, integer=True)),
        ('dcn_conv', 'edge: ragged N, C 96, F 192 [1,13,21,96]', False,
         dcn_conv(1, 13, 21, 96, 192, 1)),
        ('roi_align_multilevel', 'p2-p5, rois [12,1000,4]', True,
         roi(False, c64=True)),
        ('roi_align_multilevel', 'train rois [6,512,4]', True,
         roi(False, 6, 512)),
        ('roi_align_multilevel', 'edge: extreme aspect/empty/outside',
         False, roi(True)),
        ('roi_align_multilevel', 'R101 p2-p5 1600x640, rois [12,1000,4]',
         True, roi(False, img=(640, 1600))),
        ('roi_align_multilevel', 'edge: slivers 1408x8 and 6x512 [12,200]',
         False, roi(False, P=200, sliver=True)),
        ('masked_attention', 'cross q900 k16384 (10% rows empty)', True,
         attn(eval_attn(False))),
        ('masked_attention', 'self q900 k900', False, attn(eval_attn(True))),
        ('masked_attention', 'train cross q2628 k16384 +lse', True,
         attn(train_attn(False), train=True)),
        ('masked_attention', 'train self q2628 DN mask +lse', False,
         attn(train_attn(True), train=True)),
        ('masked_attention', 'edge: every pair allowed +lse', False,
         attn(full_attn, train=True)),
        ('masked_attention', 'edge: no pair allowed +lse', False,
         attn(no_attn, train=True)),
        ('masked_attention', 'edge: ragged q101 k1000', False,
         attn(ragged_attn)),
        ('dcn_samples', 'stage3 s2 [12,64,176,256]', True,
         dcn_fwd(12, 64, 176, 256, 2, per_step=1)),
        ('dcn_samples', 'stage3 s1 [12,32,88,256]', True,
         dcn_fwd(12, 32, 88, 256, 1, per_step=5)),
        ('dcn_samples', 'stage4 s2 [12,32,88,512]', True,
         dcn_fwd(12, 32, 88, 512, 2, per_step=1)),
        ('dcn_samples', 'stage4 s1 [12,16,44,512]', True,
         dcn_fwd(12, 16, 44, 512, 1, per_step=2)),
        ('dcn_samples', 'edge: 20% offsets far outside', False,
         dcn_fwd(12, 16, 44, 512, 1, far=0.2)),
        ('dcn_samples', 'edge: integer coordinates', False,
         dcn_fwd(12, 16, 44, 512, 1, integer=True)),
        ('dcn_samples', 'edge: ragged tiles [1,13,21,40]', False,
         dcn_fwd(1, 13, 21, 40, 1)),
        ('dcn_samples_backward', 'stage3 s2 [12,64,176,256]', True,
         dcn_bwd(12, 64, 176, 256, 2, per_step=1)),
        ('dcn_samples_backward', 'stage3 s1 [12,32,88,256]', True,
         dcn_bwd(12, 32, 88, 256, 1, per_step=5)),
        ('dcn_samples_backward', 'stage4 s2 [12,32,88,512]', True,
         dcn_bwd(12, 32, 88, 512, 2, per_step=1)),
        ('dcn_samples_backward', 'stage4 s1 [12,16,44,512]', True,
         dcn_bwd(12, 16, 44, 512, 1, per_step=2)),
        ('dcn_samples_backward', 'edge: 20% offsets far outside', False,
         dcn_bwd(12, 16, 44, 512, 1, far=0.2)),
        ('dcn_samples_backward', 'edge: integer coordinates', False,
         dcn_bwd(12, 16, 44, 512, 1, integer=True)),
        ('dcn_samples_backward', 'edge: pile-up, every sample on one cell',
         False, dcn_bwd(12, 16, 44, 512, 1, far=0.2, pile=True)),
        ('dcn_samples_backward', 'edge: ragged [1,13,21,40]', False,
         dcn_bwd(1, 13, 21, 40, 1)),
        ('masked_attention_backward', 'train cross q2628 k16384', True,
         attn_bwd(train_attn(False))),
        ('masked_attention_backward', 'train self q2628 DN mask', False,
         attn_bwd(train_attn(True))),
        ('masked_attention_backward', 'edge: every pair allowed', False,
         attn_bwd(full_attn)),
        ('masked_attention_backward', 'edge: no pair allowed', False,
         attn_bwd(no_attn)),
        ('masked_attention_backward', 'edge: ragged q101 k1000', False,
         attn_bwd(ragged_attn)),
        ('roi_align_multilevel_backward', 'train rois [6,512,4]', True,
         roi_bwd(False)),
        ('roi_align_multilevel_backward',
         'R101 p2-p5 1600x640, rois [6,512,4]', True,
         roi_bwd(False, img=(640, 1600))),
        ('roi_align_multilevel_backward',
         'edge: 1408x8, 6x512, empty, outside', False, roi_bwd(True)),
        ('roi_align_multilevel_backward',
         'edge: p2 560 cells wide, slivers across it', False,
         roi_bwd(False, wide=True)),
        ('roi_align_multilevel_backward',
         'edge: pile-up, 512 identical rois a view', False,
         roi_bwd(False, pile=True)),
        ('roi_align_multilevel_backward',
         'run to run: two kernel runs, bit for bit', False,
         roi_bwd(False, repeat=True)),
        ('fused_identity_chain', 'layer2 tail P128 [12,64,176,512] x3',
         True, identity_chain(12, 64, 176, 1)),
        ('fused_identity_chain', 'layer3 tail P256 [12,32,88,1024] x5',
         True, identity_chain(12, 32, 88, 2)),
        ('fused_identity_chain', 'edge: ragged tiles P128 [2,13,37,512]',
         False, identity_chain(2, 13, 37, 1)),
        ('fused_identity_chain', 'edge: ragged tiles P256 [2,13,37,1024]',
         False, identity_chain(2, 13, 37, 2)),
        ('fused_identity_chain', 'run to run: two kernel runs, bit for bit',
         False, identity_chain(12, 32, 88, 2, repeat=True)),
        ('dcn_conv_backward', 'stage3 s2 [12,64,176,256]', True,
         dcn_conv_bwd(12, 64, 176, 256, 256, 2)),
        ('dcn_conv_backward', 'stage3 s1 [12,32,88,256]', True,
         dcn_conv_bwd(12, 32, 88, 256, 256, 1)),
        ('dcn_conv_backward', 'stage4 s1 [12,16,44,512]', True,
         dcn_conv_bwd(12, 16, 44, 512, 512, 1)),
        ('dcn_conv_backward', 'edge: 20% offsets far outside', False,
         dcn_conv_bwd(12, 16, 44, 512, 512, 1, far=0.2)),
        ('dcn_conv_backward', 'edge: integer coordinates', False,
         dcn_conv_bwd(12, 16, 44, 512, 512, 1, integer=True)),
        ('dcn_conv_backward', 'edge: pile-up, every sample on one cell',
         False, dcn_conv_bwd(12, 16, 44, 512, 512, 1, far=0.2, pile=True)),
        ('dcn_conv_backward', 'run to run: two kernel runs, bit for bit',
         False, dcn_conv_bwd(12, 32, 88, 256, 256, 1, repeat=True)),
        ('masked_attention_backward', 'sparse route: cross q2628 k16384',
         True, attn_bwd(train_attn(False), sparse=True)),
        ('masked_attention_backward', 'sparse route: self q2628 DN mask',
         True, attn_bwd(train_attn(True), sparse=True)),
        ('masked_attention_backward', 'sparse route: every pair allowed',
         False, attn_bwd(full_attn, sparse=True)),
        ('roi_align_slab', 'p2-p5, rois [12,1000,4]', True, slab(False)),
        ('roi_align_slab', 'train rois [6,512,4]', True,
         slab(False, 6, 512)),
        ('roi_align_slab', 'edge: extreme aspect/empty/outside', False,
         slab(True)),
        ('roi_align_slab', 'edge: p2 560 cells wide, slivers across it',
         False, slab(False, wide=True)),
        ('roi_align_slab', 'run to run: two kernel runs, bit for bit', False,
         slab(False, repeat=True)),
        ('roi_align_flat', '12000 rois, random views, adaptive', True,
         flat(0)),
        ('roi_align_flat', '12000 rois, random views, S=2', True, flat(2)),
        ('roi_align_flat', 'edge: outside/empty/whole/slivers, adaptive',
         False, flat(0, edge=True)),
        ('roi_align_flat', 'edge: outside/empty/whole/slivers, S=2', False,
         flat(2, edge=True)),
        ('roi_align_flat', 'edge: p2 560 cells wide, slivers, adaptive',
         False, flat(0, wide=True)),
        ('roi_align_flat', 'edge: p2 560 cells wide, slivers, S=2', False,
         flat(2, wide=True)),
        ('roi_align_flat', 'run to run: two kernel runs, bit for bit', False,
         flat(0, repeat=True)),
        ('mask_bits', 'train cross [2628,16384]', True,
         bits(train_attn(False))),
        ('mask_bits', 'eval cross [900,16384]', True,
         bits(eval_attn(False))),
        ('mask_bits', 'train self [2628,2628]', True,
         bits(train_attn(True))),
        ('mask_bits', 'edge: ragged [101,1000]', False, bits(ragged_attn)),
        ('mask_bits', 'edge: every pair allowed [300,2048]', False,
         bits(full_attn)),
    ]


def phase_kernels(dev, results):
    import torch
    ok = True
    for name, label, main, build in kernel_cases():
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            case = build(dev, dt)
            out_k, out_p = as_list(case.kernel()), as_list(case.plain())
            torch.cuda.synchronize()
            err, rel, finite, same = compare_all(out_k, out_p)
            good = finite and same and rel <= (0.0 if case.exact else tol)
            ok &= good
            line = (f'  {name:<30} {label:<38} {str(dt)[6:]:<9} '
                    f'max_abs_err={err:.3e} rel={rel:.2e} tol={tol:.0e} '
                    f'{"ok" if good else "FAIL"}')
            ms = None
            if main and dt == torch.bfloat16:
                p1 = time_ms(case.plain)
                k1 = time_ms(case.kernel)
                k2 = time_ms(case.kernel)
                p2 = time_ms(case.plain)
                lib = time_ms(case.library) if case.library else None
                b_ms, b_by = bound(case.work)
                timing = dict(label=label, max_abs_err=err, ms=(k1 + k2) / 2,
                              plain_ms=(p1 + p2) / 2, bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib)
                for key, fn in case.extra.items():
                    timing[key] = time_ms(fn)
                    line += f'  {key} {timing[key]:.3f}'
                r = results[name]
                if r['ms'] is None:
                    r.update(timing)
                else:
                    r.setdefault('other_shapes', []).append(timing)
                line += (f'  kernel {timing["ms"]:.3f} ms  plain '
                         f'{timing["plain_ms"]:.3f} ms  bound {b_ms:.3f} ms '
                         f'({b_by}, {b_ms / timing["ms"]:.1%} of it)')
                if lib is not None:
                    line += f'  library {lib:.3f} ms'
                ms = timing['ms']
            log(line + (case.note if isinstance(case.note, str)
                        else case.note(ms)))
            del case, out_k, out_p
            torch.cuda.empty_cache()
    return ok


def phase_tiny_parity(dev):
    """Tiny config with DCN: GPU (kernels, float32) vs CPU (plain)."""
    import torch
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.core.geometry import prepare_camera_params
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import camera_rig, init_random_weights
    cfg = configs.tiny(stage_with_dcn=(False, False, True, True),
                       num_frames=2, k_max=48)
    V = cfg.total_views
    K, E = camera_rig(V, cfg.image_size)
    ts = [0.0] * cfg.num_views + [0.5] * cfg.num_views
    imgs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(V, *cfg.image_size, 3)).astype(np.float32))
    shapes = torch.tensor([list(cfg.image_size)] * V)
    model = init_random_weights(MV2D(cfg, Routes()).eval(), seed=3)
    outs = {}
    for d in ('cpu', dev):
        m = model.to(d)
        cam = prepare_camera_params(K, E, ts, device=d)
        outs[d] = [t.cpu() if torch.is_tensor(t) else t
                   for t in m(imgs.to(d), cam, shapes.to(d))]
    c, g = outs['cpu'], outs[dev]
    valid_same = torch.equal(c[3], g[3])
    v = c[3]
    n = int(v.sum())
    box_err = (c[0][v] - g[0][v]).abs().max().item() if n else 0.0
    score_err = (c[1][v] - g[1][v]).abs().max().item() if n else 0.0
    labels_same = torch.equal(c[2][v], g[2][v])
    ok = valid_same and labels_same and box_err < 1e-3 and \
        score_err < 1e-4 and n > 0
    log(f'  tiny+DCN GPU vs CPU: valid={n} same_valid={valid_same} '
        f'same_labels={labels_same} box_err={box_err:.3e} '
        f'score_err={score_err:.3e} {"ok" if ok else "FAIL"}')
    return ok


def to_device(obj, dev):
    """Tensors inside NamedTuples, dataclasses and sequences, moved."""
    import dataclasses
    import torch
    if torch.is_tensor(obj):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, '_fields'):
        return type(obj)(*(to_device(x, dev) for x in obj))
    return obj


DEFAULT_TRAIN_NEED = ('dcn_samples', 'dcn_samples_backward',
                      'masked_attention', 'masked_attention_backward',
                      'roi_align_multilevel', 'roi_align_multilevel_backward',
                      'mask_bits')


def phase_tiny_train(dev, need=DEFAULT_TRAIN_NEED, absent=ROUTED_KERNELS,
                     routes=None):
    """One tiny+DCN training step (float32, dropout 0) on the GPU (kernels)
    and on the CPU (plain versions), same weights and draws, the model
    built with `routes` (default: `Routes()`): every loss term within 1e-4
    relative, every parameter's gradient within 1e-3 of its max magnitude
    (floored at 1e-5 of the largest gradient), the discrete counts equal;
    the kernels in `need` launched on the GPU, those in `absent` not."""
    import copy
    import torch
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import (init_random_weights,
                                          synthetic_train_batch)
    from mv2d_tpu_torch.train.train_step import draw_train, forward_backward
    cfg = configs.tiny(stage_with_dcn=(False, False, True, True),
                       num_frames=2, dropout=0.0, use_flash_attention=True)
    batch = synthetic_train_batch(cfg, seed=0, device='cpu')
    draws = draw_train(cfg, batch.gt2d.boxes.shape[1],
                       torch.Generator().manual_seed(1))
    model = init_random_weights(MV2D(cfg, routes or Routes()), seed=3)
    fns = counters()
    runs = {}
    for d in ('cpu', dev):
        m = copy.deepcopy(model).to(d)
        for fn in fns.values():
            fn.launches = 0
        _, metrics = forward_backward(m, to_device(batch, d),
                                      to_device(draws, d),
                                      mixed_precision=False)
        runs[d] = ({k: float(v) for k, v in metrics.items()},
                   {n: p.grad.detach().cpu() for n, p in
                    m.named_parameters() if p.grad is not None})
    launched = {n: fn.launches for n, fn in fns.items()}
    (mc, gc), (mg, gg) = runs['cpu'], runs[dev]
    loss_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6)
                   for k in mc if 'loss' in k)
    counts_same = all(mg[k] == mc[k] for k in mc if 'loss' not in k)
    floor = 1e-5 * max(g.abs().max().item() for g in gc.values())
    grad_err = max((gg[n] - gc[n]).abs().max().item()
                   / max(gc[n].abs().max().item(), floor) for n in gc)
    ok = (loss_err <= 1e-4 and grad_err <= 1e-3 and counts_same
          and set(gg) == set(gc) and all(launched[n] > 0 for n in need)
          and all(launched[n] == 0 for n in absent))
    log(f'  tiny+DCN train step GPU vs CPU: {len(gc)} gradients, '
        f'worst loss rel err {loss_err:.2e} (tol 1e-4), worst grad err '
        f'{grad_err:.2e} of max (tol 1e-3), counts_same={counts_same}, '
        f'GPU launches {launched} {"ok" if ok else "FAIL"}')
    return ok


def _clone(a):
    import torch
    if torch.is_tensor(a):
        return a.detach().clone()
    if isinstance(a, tuple) and hasattr(a, '_fields'):
        return type(a)(*(_clone(x) for x in a))
    if isinstance(a, (list, tuple)):
        return type(a)(_clone(x) for x in a)
    if isinstance(a, dict):
        return {k: _clone(v) for k, v in a.items()}
    return a


class _Recorder:
    """Stands in for a module function: keeps the first call's (filtered)
    arguments in `seen`, calls the function, and passes its `launches`
    counter through (a wrapper counts its launches under its own module
    name, which the recorder then holds)."""

    def __init__(self, fn, seen, key, want):
        self.fn, self.seen, self.key, self.want = fn, seen, key, want

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args):
        if self.key not in self.seen and self.want(args):
            self.seen[self.key] = _clone(args)
        return self.fn(*args)


def _record_first(seen, patches):
    """Put a _Recorder in place of each (module, name); returns the
    originals to restore."""
    originals = {}
    for mod, name, key, want in patches:
        fn = getattr(mod, name)
        originals[(mod, name)] = fn
        setattr(mod, name, _Recorder(fn, seen, key, want))
    return originals


def _replay(seen, plain, kernels, label):
    """Each recorded call through kernel and plain version (bf16 tol)."""
    ok = True
    for name, args in seen.items():
        err, rel, fin, same = compare_all(as_list(kernels[name](*args)),
                                          as_list(plain[name](*args)))
        good = fin and same and rel <= BF16_TOL
        ok &= good
        log(f'  replay {label} {name:<30} max_abs_err={err:.3e} '
            f'rel={rel:.2e} {"ok" if good else "FAIL"}')
    missing = set(kernels) - set(seen)
    if missing:
        log(f'  kernels never reached: {sorted(missing)}')
        ok = False
    return ok


def phase_serve(dev, results, n_requests=3, cfg=None):
    import torch
    import mv2d_tpu_torch.models.detector2d as det2d
    import mv2d_tpu_torch.nn.decoder as decoder
    import mv2d_tpu_torch.nn.resnet as resnet
    import mv2d_tpu_torch.ops.dcn as dcn
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.core.geometry import prepare_camera_params
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.ops import attention, roi_align, stage
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import camera_rig, init_random_weights

    cfg = cfg or configs.mv2d_t_r50()
    V, (H, W) = cfg.total_views, cfg.image_size
    K, E = camera_rig(V, cfg.image_size)
    cam = prepare_camera_params(K, E, [0.0] * 6 + [0.5] * 6, device=dev)
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(V, H, W, 3)).astype(np.float32)).to(dev, torch.bfloat16)
    shapes = torch.tensor([[H, W]] * V, device=dev)
    model = init_random_weights(MV2D(cfg, Routes()).eval(), seed=0).to(
        dev, torch.bfloat16)

    # record the inputs each kernel wrapper sees first on the main path:
    # wrap the callers' references (a wrapper's own module stays as it is,
    # its launch counter lives there); attention records a cross-attention
    # call (layer 0's self-attention has all-zero values); the DCN
    # wrapper's caller is in its own module, so the first DCN module's
    # input is recorded by a hook and the kernel's inputs derived from it
    seen = {}
    originals = _record_first(seen, [
        (resnet, 'fused_stage1', 'fused_stage1', lambda a: True),
        (det2d, 'roi_align_multilevel', 'roi_align_multilevel',
         lambda a: True),
        (decoder, 'masked_attention', 'masked_attention',
         lambda a: a[1].shape[0] != a[0].shape[0])])
    first_dcn = next(m for m in model.modules()
                     if isinstance(m, dcn.ModulatedDeformConv))

    def dcn_hook(m, inputs):
        if 'dcn_conv' not in seen:
            x = inputs[0].detach().clone()
            sy, sx, mask = m.sample_coords(x)
            seen['dcn_conv'] = (x, sy.contiguous(), sx.contiguous(), mask,
                                m.tap_weights(x.dtype))
    handle = first_dcn.register_forward_pre_hook(dcn_hook)

    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ms, out = [], None
    try:
        for _ in range(n_requests):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(imgs, cam, shapes)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        handle.remove()
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    launches = {n: fn.launches for n, fn in fns.items()}
    for name, n in launches.items():
        results[name]['launches_by_path']['serve'] = n
    boxes, scores, labels, valid, diag = out
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (boxes, scores))
    shapes_ok = (tuple(boxes.shape) == (cfg.max_per_scene, 9)
                 and tuple(scores.shape) == (cfg.max_per_scene,))
    ok = finite and shapes_ok and all(
        launches[n] > 0 for n in SERVE_KERNELS) and all(
        launches[n] == 0 for n in ROUTED_KERNELS) and \
        launches['mask_bits'] == MASKS_PER_PASS * n_requests
    log(f'  forward ms (bf16, {H}x{W} x {V} views): '
        + ', '.join(f'{t:.1f}' for t in ms))
    log(f'  valid detections={int(valid.sum())} '
        f'key_active={int(diag["key_active"])} '
        f'key_overflow={int(diag["key_overflow"])} '
        f'num_queries={int(diag["num_queries"])} finite={finite} '
        f'shapes_ok={shapes_ok}')
    log(f'  launches per {n_requests} forwards: {launches}')
    results['_forward_ms'] = ms
    results['_serve_peak_gb'] = torch.cuda.max_memory_allocated() / 2 ** 30

    def attn_plain(q, k, v, a, H, tiles=None):
        return attention.masked_attention_plain(q, k, v, a, H)

    plain = {'fused_stage1': stage.fused_stage1_plain,
             'dcn_conv': dcn.dcn_conv_plain,
             'roi_align_multilevel': roi_align.multilevel_roi_align_plain,
             'masked_attention': attn_plain}
    return _replay(seen, plain, {n: fns[n] for n in plain}, 'serve') and ok


def _scene(mc, seed=0):
    """A request's arrays for a config: N(0, 1) images, the camera rig,
    timestamps 0 / 0.5 for the two frames."""
    from mv2d_tpu_torch.synthetic import camera_rig
    V = mc.total_views
    K, E = camera_rig(V, mc.image_size)
    return dict(images=np.random.default_rng(seed).normal(
        size=(V, *mc.image_size, 3)).astype(np.float32),
        intrinsics=K, extrinsics=E,
        timestamps=np.asarray([0.0] * mc.num_views
                              + [0.5] * (V - mc.num_views)))


def _post(url, arrays):
    """POST /predict -> (status, response arrays or error, client ms)."""
    import io
    import urllib.error
    import urllib.request
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url + '/predict', data=buf.getvalue(),
                                 method='POST')
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            body = dict(np.load(io.BytesIO(r.read())))
            code = r.status
    except urllib.error.HTTPError as e:
        code, body = e.code, json.load(e)
    return code, body, (time.perf_counter() - t0) * 1e3


class _Server:
    """The port's HTTP server on 127.0.0.1 (a free port) in a thread."""

    def __init__(self, path, routes, max_batch, timeout_ms, dev,
                 options=None):
        import threading
        from http.server import ThreadingHTTPServer
        from mv2d_tpu_torch.tools.common import load_cli_config
        from mv2d_tpu_torch.tools.serve import (ModelRunner, make_handler,
                                                metadata)
        cfg = load_cli_config(path, options)
        self.runner = ModelRunner(cfg, None, max_batch, timeout_ms,
                                  device=dev, routes=routes)
        self.srv = ThreadingHTTPServer(
            ('127.0.0.1', 0), make_handler(self.runner,
                                           metadata(cfg, self.runner)))
        self.url = f'http://127.0.0.1:{self.srv.server_address[1]}'
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def get(self, route):
        import urllib.request
        with urllib.request.urlopen(self.url + route, timeout=60) as r:
            return json.load(r)

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join()
        self.runner.close()


def _response_ok(out, mc):
    n = mc.max_per_scene
    v = out['valid'].astype(bool)
    return (out['boxes_3d'].shape == (n, 9) and out['scores_3d'].shape == (n,)
            and out['labels_3d'].shape == (n,) and out['valid'].shape == (n,)
            and bool(v.any()) and bool(np.isfinite(out['boxes_3d'][v]).all())
            and bool(np.isfinite(out['scores_3d'][v]).all()))


def phase_http(dev, results, options=(), options_r101=()):
    """The port's server, as a user reaches the eval forward: the R50
    config file with align_v2 (B11), max batch 2, batch timeout 200 ms;
    then roi_forward (B12) on one scene's proposals; then the R101 file.
    `options` (--cfg-options) shrink the configs for a rehearsal."""
    import threading
    import torch
    from mv2d_tpu_torch.ops import roi_align
    from mv2d_tpu_torch.routes import Routes

    fns = counters()
    srv = _Server('configs/mv2d/mv2d_r50_frcnn_two_frames_1408x512_ep24.py',
                  Routes(align_v2=True), 2, 200.0, dev, list(options))
    runner, mc = srv.runner, srv.runner.mc
    ok = srv.get('/health') == {'status': 'ok'}
    meta = srv.get('/metadata')
    ok &= meta['views'] == 12 and meta['image_size'] == list(mc.image_size)
    scenes = [_scene(mc, seed) for seed in range(4)]
    for fn in fns.values():
        fn.launches = 0
    answers = [_post(srv.url, scenes[0])] + [None] * 3

    def ask(i):
        answers[i] = _post(srv.url, scenes[i])
    threads = [threading.Thread(target=ask, args=(i,)) for i in (1, 2, 3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in fns.items()}
    for name, n in launches.items():
        results[name]['launches_by_path']['http'] = n
    metrics = srv.get('/metrics')
    codes = [a[0] for a in answers]
    shapes_ok = codes == [200] * 4 and all(_response_ok(a[1], mc)
                                           for a in answers)
    launch_ok = (launches['roi_align_slab'] == 4
                 and launches['mask_bits'] == MASKS_PER_PASS * 4
                 and launches['roi_align_multilevel'] == 0
                 and launches['roi_align_flat'] == 0
                 and all(launches[n] > 0 for n in SERVE_KERNELS
                         if n != 'roi_align_multilevel'))
    metrics_ok = (metrics['requests'] == 4 and metrics['errors'] == 0
                  and metrics['batches'] < 4)
    log(f'  R50 align_v2: statuses {codes}; client ms '
        + ', '.join(f'{a[2]:.1f}' for a in answers)
        + f' (the first alone, then three at once); /metrics {metrics}')
    log(f'  launches for the 4 requests: {launches} '
        f'(B11 4, K3 0) {"ok" if launch_ok else "FAIL"}')
    results['_http'] = dict(client_ms=[a[2] for a in answers], **metrics)

    # each answer against a direct forward of the same model and arrays
    match_ok = True
    for (code, out, _), arrays in zip(answers, scenes):
        with torch.inference_mode():
            det = runner.model(*runner.inputs(arrays))
        same = code == 200 and np.array_equal(det.valid.cpu().numpy(),
                                              out['valid'])
        err = float('nan')
        if same:
            v = out['valid'].astype(bool)
            err = max(compare(torch.from_numpy(out[k][v]),
                              getattr(det, a).float().cpu()[v])[1]
                      for k, a in (('scores_3d', 'scores'),
                                   ('boxes_3d', 'boxes')))
        match_ok &= same and err <= BF16_TOL
        log(f'  answer vs direct forward: same valid {same}, worst score / '
            f'box error {err:.2e} of max (tol {BF16_TOL:.0e})')

    code, body, _ = _post(srv.url, dict(images=np.zeros((2, 8, 8, 3),
                                                        np.float32),
                                        intrinsics=np.eye(4)[None],
                                        extrinsics=np.eye(4)[None]))
    bad_ok = code == 400
    log(f'  bad request: status {code} {body} {"ok" if bad_ok else "FAIL"}')

    # roi_forward (B12) on the first scene's FPN levels and proposals
    model = runner.model
    det2d = model.base_detector
    strides = (4, 8, 16, 32)
    with torch.inference_mode():
        fpn = det2d.extract_feat(runner.inputs(scenes[0])[0])
        boxes, _, _ = det2d.rpn(fpn, mc.image_size, mc.proposal_test)
        V, P = boxes.shape[:2]
        rois = boxes.reshape(V * P, 4)
        views = torch.arange(V, device=dev).repeat_interleave(P)
        for fn in fns.values():
            fn.launches = 0
        cls, reg = det2d.roi_forward(fpn, rois, views)
        torch.cuda.synchronize()
        rf = {n: fn.launches for n, fn in fns.items()}
        for name, n in rf.items():
            results[name]['launches_by_path']['roi_forward'] = n
        feats = list(fpn[:4])
        f12 = roi_align.roi_align_flat(feats, rois, views, strides)
        f3 = roi_align.roi_align_multilevel(feats, boxes, strides)
        f11 = roi_align.roi_align_slab(feats, boxes, strides)
        torch.cuda.synchronize()
        e3 = compare(f12.reshape(f3.shape), f3)
        e11 = compare(f12.reshape(f3.shape), f11)
        head = det2d.roi_head.bbox_head(f3.reshape(V * P, *f3.shape[2:]))
        eh = compare_all([cls, reg], head)
    rf_ok = (rf['roi_align_flat'] == 1 and rf['roi_align_slab'] == 0
             and rf['roi_align_multilevel'] == 0 and e3[1] <= BF16_TOL
             and e11[1] <= BF16_TOL and e3[2] and e11[2]
             and eh[1] <= BF16_TOL)
    log(f'  roi_forward on {V * P} proposals: launches B12 '
        f'{rf["roi_align_flat"]}, B11 {rf["roi_align_slab"]}, K3 '
        f'{rf["roi_align_multilevel"]}; features vs K3 rel {e3[1]:.2e}, vs '
        f'B11 rel {e11[1]:.2e}; head vs head on K3 rel {eh[1]:.2e} (tol '
        f'{BF16_TOL:.0e}) {"ok" if rf_ok else "FAIL"}')
    srv.close()
    del srv, runner, model, det2d, fpn, feats, f12, f3, f11
    torch.cuda.empty_cache()

    # one request to the R101 1600x640 server (default routes)
    srv = _Server('configs/mv2d/mv2d_r101_frcnn_two_frames_1600x640_ep24.py',
                  Routes(), 1, 8.0, dev, list(options_r101))
    mc101 = srv.runner.mc
    for fn in fns.values():
        fn.launches = 0
    code, out, ms = _post(srv.url, _scene(mc101, 7))
    torch.cuda.synchronize()
    l101 = {n: fn.launches for n, fn in fns.items()}
    for name, n in l101.items():
        results[name]['launches_by_path']['http_r101'] = n
    r101_ok = (code == 200 and _response_ok(out, mc101)
               and (mc101.depth, mc101.k_max) == (101, 24576)
               and all(l101[n] > 0 for n in SERVE_KERNELS)
               and l101['mask_bits'] == MASKS_PER_PASS)
    log(f'  R101 {mc101.image_size[1]}x{mc101.image_size[0]} k_max '
        f'{mc101.k_max}: status {code}, client ms '
        f'{ms:.1f}, valid {int(out["valid"].sum()) if code == 200 else 0}, '
        f'launches {l101} {"ok" if r101_ok else "FAIL"}')
    results['_http_r101_ms'] = ms
    srv.close()
    del srv
    torch.cuda.empty_cache()
    return (ok and shapes_ok and launch_ok and metrics_ok and match_ok
            and bad_ok and rf_ok and r101_ok)


def phase_train(dev, results, n_steps=4, cfg=None):
    """Full-width training steps (bf16 mixed precision) on the synthetic
    scene; the first step is warm-up."""
    import torch
    import mv2d_tpu_torch.ops.attention as attention
    import mv2d_tpu_torch.ops.dcn as dcn
    import mv2d_tpu_torch.ops.roi_align as roi_align
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import (init_random_weights,
                                          synthetic_train_batch)
    from mv2d_tpu_torch.train.optim import make_optimizer
    from mv2d_tpu_torch.train.train_step import train_step

    cfg = cfg or configs.mv2d_t_r50()
    model = init_random_weights(MV2D(cfg, Routes()), seed=0).to(dev)
    opt = make_optimizer(model)
    batch = synthetic_train_batch(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    def cross(args):
        return args[1].shape[0] != args[0].shape[0]
    fns = counters()          # the wrappers themselves, before recording
    seen = {}
    originals = _record_first(seen, [
        (dcn, 'dcn_samples_forward', 'dcn_samples', lambda a: True),
        (dcn, 'dcn_samples_backward', 'dcn_samples_backward',
         lambda a: True),
        (attention, 'masked_attention_forward', 'masked_attention', cross),
        (attention, 'masked_attention_backward',
         'masked_attention_backward', cross),
        (roi_align, 'roi_align_multilevel', 'roi_align_multilevel',
         lambda a: True),
        (roi_align, 'roi_align_multilevel_backward',
         'roi_align_multilevel_backward', lambda a: True)])
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ms, steps = [], []
    try:
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = train_step(model, opt, batch, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            steps.append({k: float(v) for k, v in metrics.items()})
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    launches = {n: fn.launches for n, fn in fns.items()}
    for name, n in launches.items():
        results[name]['launches_by_path']['train'] = n
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = all(np.isfinite(v) for s in steps for v in s.values())
    frozen_still, moved, trainable = True, 0, 0
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if p.requires_grad:
            trainable += 1
            moved += not same
        else:
            frozen_still &= same
    per_step_ok = all(launches[n] == k * n_steps
                      for n, k in TRAIN_PER_STEP.items()) and \
        launches['roi_align_multilevel'] >= 2 * n_steps
    ok = finite and frozen_still and moved >= 0.9 * trainable and \
        per_step_ok
    log(f'  train ms/step (bf16 mixed precision, {cfg.total_views} views '
        f'{cfg.image_size[0]}x{cfg.image_size[1]}; first is warm-up): '
        + ', '.join(f'{t:.1f}' for t in ms))
    log(f'  peak memory {peak_gb:.2f} GiB; finite={finite} '
        f'frozen_unchanged={frozen_still} trained_moved={moved}/{trainable}')
    for i, s in enumerate(steps):
        log(f'  step {i}: total_loss={s["total_loss"]:.4f} '
            f'grad_norm={s["grad_norm"]:.4f} lr={s["lr"]:.3e} '
            f'rpn_num_pos={s["rpn_num_pos"]:.0f} '
            f'rcnn_num_pos={s["rcnn_num_pos"]:.0f} '
            f'num_queries={s["num_queries"]:.0f} '
            f'key_active={s["key_active"]:.0f} '
            f'key_overflow={s["key_overflow"]:.0f}')
    log('  step 0 losses: ' + ', '.join(
        f'{k}={v:.4f}' for k, v in steps[0].items() if 'loss' in k))
    log(f'  launches per {n_steps} steps: {launches} '
        f'(per step expected {TRAIN_PER_STEP}, K3 >= 2) '
        f'{"ok" if per_step_ok else "FAIL"}')
    results['_train_ms'] = ms
    results['_train_peak_gb'] = peak_gb

    def attn_bwd_plain(q, k, v, a, out, lse, dout, H, tiles=None):
        if a is None:         # the autograd Function keeps MaskTiles only
            a = attention.mask_from_bits(tiles.bits, k.shape[0])
        return plain_grads(attention.masked_attention_plain, (q, k, v, a, H),
                           range(3), dout)[1]

    def dcn_bwd_plain(x, sy, sx, m, ds):
        return plain_grads(dcn.dcn_samples_plain, (x, sy, sx, m), range(4),
                           ds)[1]

    def roi_bwd_plain(feats, rois, dout, strides):
        def fwd(*fs):
            return roi_align.multilevel_roi_align_plain(fs, rois, strides)
        return plain_grads(fwd, feats, range(len(feats)), dout)[1]

    def attn_fwd_plain(q, k, v, a, H, tiles=None):
        return (attention.masked_attention_plain(q, k, v, a, H),
                attention.attention_lse_plain(q, k, a, H))

    plain = {'dcn_samples': dcn.dcn_samples_plain,
             'dcn_samples_backward': dcn_bwd_plain,
             'masked_attention': attn_fwd_plain,
             'masked_attention_backward': attn_bwd_plain,
             'roi_align_multilevel': roi_align.multilevel_roi_align_plain,
             'roi_align_multilevel_backward': roi_bwd_plain}
    kern = {'dcn_samples': dcn.dcn_samples_forward,
            'dcn_samples_backward': dcn.dcn_samples_backward,
            'masked_attention': attention.masked_attention_forward,
            'masked_attention_backward': attention.masked_attention_backward,
            'roi_align_multilevel': roi_align.roi_align_multilevel,
            'roi_align_multilevel_backward':
                roi_align.roi_align_multilevel_backward}
    return _replay(seen, plain, kern, 'train') and ok


def phase_routes_tiny(dev):
    """The optional routes at a small size, float32 with TF32 off, GPU
    (kernels) against CPU (plain versions): a ResNet-50 backbone with
    MV2D-T's DCN layout on 2 views at 256x704 built with
    fused_stages='all' (layer2's three tail blocks through B10; every
    stage output within 1e-4 of its max magnitude; with gradients on, no
    B10 and a gradient in layer2's tail), then one tiny+DCN training step
    with dcn_train_fused and flash_sparse (phase_tiny_train's checks, with
    K2, B13 and B8 launched and B5 and B6's wrappers not called: B13 runs
    B6's walk inside its own C entry), and one with align_v2 (B11 and B9
    launched, K3 not)."""
    import torch
    from mv2d_tpu_torch.nn.resnet import ResNet
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import init_random_weights
    net = init_random_weights(ResNet(50, (False, False, True, True),
                                     Routes(fused_stages='all')),
                              seed=3).eval()
    imgs = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 256, 704, 3)).astype(np.float32))
    fns = counters()
    outs, launched = {}, {}
    with torch.no_grad():
        for d in ('cpu', dev):
            for fn in fns.values():
                fn.launches = 0
            outs[d] = [o.float().cpu() for o in net.to(d)(imgs.to(d))]
            launched[d] = {n: fn.launches for n, fn in fns.items()}
    err, rel, finite, same = compare_all(outs[dev], outs['cpu'])
    want = {'fused_stage1': 3, 'fused_identity_chain': 3, 'dcn_conv': 9}
    got = {n: launched[dev][n] for n in want}
    ok = finite and same and rel <= F32_TOL and got == want
    log(f'  backbone R50 (DCN in stages 3-4) 2 x 256x704 with '
        f'fused_stages=all, GPU vs CPU: max_abs_err={err:.3e} '
        f'rel={rel:.2e} (tol {F32_TOL:.0e}), GPU launches {got} '
        f'(expected {want}) {"ok" if ok else "FAIL"}')
    fns['fused_identity_chain'].launches = 0
    with torch.enable_grad():
        sum(o.float().sum() for o in net(imgs.to(dev))).backward()
    b10 = fns['fused_identity_chain'].launches
    g = net.layer2[1].conv1.weight.grad
    grad_ok = b10 == 0 and g is not None and bool(
        torch.isfinite(g).all()) and g.abs().max().item() > 0
    log(f'  the same with gradients on: B10 launches {b10} (expected 0), '
        f'layer2 block 1 conv1 grad max '
        f'{float("nan") if g is None else g.abs().max().item():.3e} '
        f'{"ok" if grad_ok else "FAIL"}')
    ok_train = phase_tiny_train(
        dev, need=('dcn_conv', 'dcn_conv_backward', 'masked_attention',
                   'masked_attention_backward', 'mask_bits',
                   'roi_align_multilevel', 'roi_align_multilevel_backward'),
        absent=('dcn_samples', 'dcn_samples_backward',
                'fused_identity_chain', 'roi_align_slab', 'roi_align_flat'),
        routes=Routes(dcn_train_fused=True, flash_sparse=True))
    ok_v2 = phase_tiny_train(
        dev, need=('dcn_samples', 'dcn_samples_backward', 'masked_attention',
                   'masked_attention_backward', 'roi_align_slab',
                   'roi_align_multilevel_backward', 'mask_bits'),
        absent=('roi_align_multilevel', 'roi_align_flat',
                'fused_identity_chain', 'dcn_conv_backward'),
        routes=Routes(align_v2=True))
    return ok and grad_ok and ok_train and ok_v2


def phase_routes(dev, results, n_requests=2, n_steps=3, cfg=None):
    """Full width on the optional routes: bf16 eval forwards with
    fused_stages='all' (B10 on layer2's tail), then training steps with
    dcn_train_fused, flash_sparse and align_v2 (B13, B8, B11 / B9), each
    beside the default route's ms and peak memory from this run.  B13 runs
    B6's walk inside its own C entry, so B5 and B6's wrappers count no
    launch on the routed step (ROUTED_TRAIN_PER_STEP)."""
    import torch
    import mv2d_tpu_torch.nn.resnet as resnet
    import mv2d_tpu_torch.ops.attention as attention
    import mv2d_tpu_torch.ops.dcn as dcn
    import mv2d_tpu_torch.ops.roi_align as roi_align
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.core.geometry import prepare_camera_params
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.ops import stage
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import (camera_rig, init_random_weights,
                                          synthetic_train_batch)
    from mv2d_tpu_torch.train.optim import make_optimizer
    from mv2d_tpu_torch.train.train_step import train_step

    cfg = cfg or configs.mv2d_t_r50()
    V, (H, W) = cfg.total_views, cfg.image_size
    fns = counters()
    seen = {}

    def run(paths, n, call, label):
        """n host-timed calls with every counter at 0 first;
        -> (ms list, launches, peak GiB, last result)."""
        originals = _record_first(seen, paths)
        for fn in fns.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        ms, res = [], None
        try:
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = call()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            for (mod, name), fn in originals.items():
                setattr(mod, name, fn)
        launches = {name: fn.launches for name, fn in fns.items()}
        for name, k in launches.items():
            results[name]['launches_by_path'][label] = k
        return ms, launches, torch.cuda.max_memory_allocated() / 2 ** 30, res

    # ---- eval forwards, fused_stages='all' (MV2D_FUSED_STAGES=all)
    K, E = camera_rig(V, cfg.image_size)
    cam = prepare_camera_params(K, E, [0.0] * 6 + [0.5] * 6, device=dev)
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(V, H, W, 3)).astype(np.float32)).to(dev, torch.bfloat16)
    shapes = torch.tensor([[H, W]] * V, device=dev)
    model = init_random_weights(
        MV2D(cfg, Routes(fused_stages='all')).eval(), seed=0).to(
            dev, torch.bfloat16)
    ms, launches, peak, out = run(
        [(resnet, 'fused_identity_chain', 'fused_identity_chain',
          lambda a: True)], n_requests,
        lambda: model(imgs, cam, shapes), 'routes_serve')
    boxes, scores = out[0], out[1]
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (boxes, scores))
    serve_ok = finite and tuple(boxes.shape) == (cfg.max_per_scene, 9) \
        and launches['fused_identity_chain'] == 3 * n_requests \
        and launches['mask_bits'] == MASKS_PER_PASS * n_requests
    log(f'  fused_stages=all: forward ms (bf16) '
        + ', '.join(f'{t:.1f}' for t in ms) + ' (default route '
        + ', '.join(f'{t:.1f}' for t in results.get('_forward_ms', []))
        + f'); peak memory {peak:.2f} GiB (default '
        f'{results.get("_serve_peak_gb", float("nan")):.2f}); B10 launches '
        f'per forward {launches["fused_identity_chain"] / n_requests:g} '
        f'(expected 3); finite={finite} {"ok" if serve_ok else "FAIL"}')
    log(f'  launches per {n_requests} forwards: {launches}')
    results['_routes_forward_ms'] = ms
    del model, out, boxes, scores
    torch.cuda.empty_cache()

    # ---- training steps, dcn_train_fused, flash_sparse and align_v2
    # (MV2D_DCN_TRAIN_FUSED=1, MV2D_FLASH_SPARSE=1, MV2D_ALIGN_V2=1)
    model = init_random_weights(
        MV2D(cfg, Routes(dcn_train_fused=True, flash_sparse=True,
                         align_v2=True)), seed=0).to(dev)
    opt = make_optimizer(model)
    batch = synthetic_train_batch(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    steps = []

    def step():
        metrics = train_step(model, opt, batch, gen)
        steps.append({k: float(v) for k, v in metrics.items()})

    def cross(args):
        return args[1].shape[0] != args[0].shape[0]
    ms, launches, peak, _ = run(
        [(dcn, 'dcn_conv_backward', 'dcn_conv_backward', lambda a: True),
         (attention, 'masked_attention_backward',
          'masked_attention_backward', cross),
         (roi_align, 'roi_align_slab', 'roi_align_slab', lambda a: True)],
        n_steps, step, 'routes_train')
    finite = all(np.isfinite(v) for s in steps for v in s.values())
    per_step_ok = all(launches[n] == k * n_steps
                      for n, k in ROUTED_TRAIN_PER_STEP.items())
    train_ok = finite and per_step_ok
    log(f'  dcn_train_fused, flash_sparse, align_v2: train ms/step '
        + ', '.join(f'{t:.1f}' for t in ms) + ' (default route '
        + ', '.join(f'{t:.1f}' for t in results.get('_train_ms', []))
        + f'); peak memory {peak:.2f} GiB (default '
        f'{results.get("_train_peak_gb", float("nan")):.2f}); '
        f'finite={finite}')
    for i, s in enumerate(steps):
        log(f'  step {i}: total_loss={s["total_loss"]:.4f} '
            f'grad_norm={s["grad_norm"]:.4f}')
    log(f'  launches per {n_steps} steps: {launches} (per step expected '
        f'{ROUTED_TRAIN_PER_STEP}) '
        f'{"ok" if per_step_ok else "FAIL"}')
    results['_routes_train_ms'] = ms
    results['_routes_train_peak_gb'] = peak
    del model, opt, batch
    torch.cuda.empty_cache()

    def dcn_bwd_plain(x, sy, sx, m, w, dy):
        return plain_grads(dcn.dcn_conv_plain, (x, sy, sx, m, w), range(5),
                           dy)[1]

    def attn_bwd_plain(q, k, v, a, out, lse, dout, H, tiles=None):
        if a is None:         # the autograd Function keeps MaskTiles only
            a = attention.mask_from_bits(tiles.bits, k.shape[0])
        return plain_grads(attention.masked_attention_plain, (q, k, v, a, H),
                           range(3), dout)[1]

    plain = {'fused_identity_chain': stage.fused_identity_chain_plain,
             'dcn_conv_backward': dcn_bwd_plain,
             'masked_attention_backward': attn_bwd_plain,
             'roi_align_slab': roi_align.multilevel_roi_align_plain}
    kern = {'fused_identity_chain': stage.fused_identity_chain,
            'dcn_conv_backward': dcn.dcn_conv_backward,
            'masked_attention_backward': attention.masked_attention_backward,
            'roi_align_slab': roi_align.roi_align_slab}
    return _replay(seen, plain, kern, 'routes') and serve_ok and train_ok


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: torch.cuda.is_available() is False')
    from mv2d_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = 'cuda'
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f'python {sys.version.split()[0]} torch {torch.__version__} '
        f'cuda {torch.version.cuda}; {smi}')
    results = {name: dict(name=name, route='cuda', **info, launches=0,
                          launches_by_path={}, max_abs_err=None, ms=None,
                          plain_ms=None, bound_ms=None, bound_by=None,
                          library_ms=None)
               for name, info in KERNELS.items()}

    failed = []
    t0 = time.perf_counter()
    log('[build]')
    lib = kernels.build(verbose=True)
    kernels.lib()
    log(f'  built {lib.name} in {time.perf_counter() - t0:.1f} s')
    for phase, fn in (
            ('kernels', lambda: phase_kernels(dev, results)),
            ('tiny', lambda: phase_tiny_parity(dev)),
            ('tiny_train', lambda: phase_tiny_train(dev)),
            ('serve', lambda: phase_serve(dev, results)),
            ('http', lambda: phase_http(dev, results)),
            ('train', lambda: phase_train(dev, results)),
            ('routes_tiny', lambda: phase_routes_tiny(dev)),
            ('routes', lambda: phase_routes(dev, results))):
        log(f'[{phase}]')
        t1 = time.perf_counter()
        try:
            good = fn()
        except Exception as e:          # a phase that raises has failed
            import traceback
            traceback.print_exc()
            log(f'  {phase} raised {type(e).__name__}: {e}')
            good = False
        log(f'  {phase}: {"ok" if good else "FAILED"} '
            f'({time.perf_counter() - t1:.1f} s)')
        if not good:
            failed.append(phase)
    log(f'total {time.perf_counter() - t0:.1f} s')
    if failed:
        log(f'chip_smoke: failed phases {failed}')
        sys.exit(1)
    for r in results.values():
        if isinstance(r, dict) and 'launches_by_path' in r:
            r['launches'] = sum(r['launches_by_path'].values())
    log(json.dumps({'kernels': [results[n] for n in KERNELS]}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
