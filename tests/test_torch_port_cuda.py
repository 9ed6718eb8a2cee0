"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked `cuda`; without a CUDA device every test skips (a hand-written
kernel has no CPU mode).  The tests import nothing of JAX, so on a machine
without it they run with the JAX-side conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Small, ragged shapes (tile edges) plus the edge cases; `chip_smoke.py`
repeats the check at the eval path's shapes.  Tolerances, relative to the
plain output's max magnitude: float32 (TF32 off) 1e-4, bfloat16 3e-2.
"""
import pytest

torch = pytest.importorskip('torch')

import chip_smoke as smoke                               # noqa: E402
from mv2d_tpu_torch import synthetic                    # noqa: E402

pytestmark = pytest.mark.cuda

DTYPES = [('float32', 1e-4), ('bfloat16', 3e-2)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the GPU')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return 'cuda'


def check(kernel_out, plain_out, tol):
    torch.cuda.synchronize()
    assert kernel_out.shape == plain_out.shape
    err, rel, finite = smoke.compare(kernel_out, plain_out)
    assert finite and rel <= tol, (err, rel)


@pytest.mark.parametrize('dtype,tol', DTYPES)
def test_stage1_kernel(dev, dtype, tol):
    from mv2d_tpu_torch.ops import stage
    dt = getattr(torch, dtype)
    x, blocks = smoke.stage1_inputs(dev, dt, V=2, H=20, W=37)
    want = stage.fused_stage1_plain(x, blocks)
    before = stage.fused_stage1.launches
    got = stage.fused_stage1(x, blocks)
    assert stage.fused_stage1.launches == before + 3
    check(got, want, tol)


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('V,H,W', [(3, 13, 70), (1, 5, 7), (1, 8, 16),
                                   (12, 20, 37)])
def test_stage1_kernel_shapes(dev, dtype, tol, V, H, W):
    """K1's chain with ragged tiles on every side (H % 8, W % 16), a map
    under one tile, exactly one tile, and 12 views (persistent blocks
    walking several tiles each)."""
    from mv2d_tpu_torch.ops import stage
    x, blocks = smoke.stage1_inputs(dev, getattr(torch, dtype), V, H, W)
    check(stage.fused_stage1(x, blocks), stage.fused_stage1_plain(x, blocks),
          tol)


@pytest.mark.parametrize('dtype,tol', DTYPES)
def test_stage1_identity_block_alone(dev, dtype, tol):
    """One identity bottleneck at Cin 256 (no projection)."""
    from mv2d_tpu_torch.ops import stage
    x, blocks = smoke.stage1_inputs(dev, getattr(torch, dtype), 2, 11, 45)
    y = stage.bottleneck_plain(x, blocks[0])
    check(stage.bottleneck_cuda(y, blocks[1]),
          stage.bottleneck_plain(y, blocks[1]), tol)


def test_stage1_bf16_runs_are_bit_equal(dev):
    from mv2d_tpu_torch.ops import stage
    x, blocks = smoke.stage1_inputs(dev, torch.bfloat16, 12, 24, 40)
    blocks = [stage.pack_block(b, torch.bfloat16) for b in blocks]
    a = stage.fused_stage1(x, blocks)
    b = stage.fused_stage1(x, blocks)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_stage1_kernel_refuses_what_it_does_not_take(dev):
    """bfloat16 takes the projection block at Cin 64 only; every dtype
    needs Cin % 32 == 0 and an identity block Cin == 256."""
    from mv2d_tpu_torch.ops import stage
    x, blocks = smoke.stage1_inputs(dev, torch.bfloat16, 1, 8, 8)
    y = stage.bottleneck_plain(x, blocks[0])
    with pytest.raises(ValueError):           # projection at Cin 256
        stage.bottleneck_cuda(y, {**blocks[1], 'wd': blocks[0]['wd'].repeat(
            4, 1), 'bd': blocks[0]['bd']})
    with pytest.raises(ValueError):           # identity at Cin 64
        stage.bottleneck_cuda(x, blocks[1])
    with pytest.raises(ValueError):           # Cin % 32
        stage.bottleneck_cuda(x[..., :48].contiguous(), blocks[0])


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('stride,far', [(1, 0.0), (2, 0.0), (1, 0.3)])
def test_dcn_kernel(dev, dtype, tol, stride, far):
    from mv2d_tpu_torch.ops import dcn
    args = smoke.dcn_inputs(dev, getattr(torch, dtype), 2, 11, 19, 64, 128,
                            stride, far=far)
    check(dcn.dcn_conv(*args), dcn.dcn_conv_plain(*args), tol)


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('V,H,W,C,F,stride,far,integer', [
    (1, 13, 21, 64, 256, 1, 0.0, False),     # ragged N (273 pixels)
    (2, 9, 14, 32, 64, 1, 0.0, False),       # C 32, F 64
    (1, 12, 17, 96, 512, 2, 0.0, False),     # F 512 (two slices), C 96
    (2, 11, 19, 64, 128, 1, 0.2, False),     # 20% far outside the map
    (2, 11, 19, 64, 192, 1, 0.0, True),      # integer coordinates, F 192
])
def test_dcn_kernel_shapes(dev, dtype, tol, V, H, W, C, F, stride, far,
                           integer):
    """K2 at the edges of its tiling: a last pixel tile partly empty,
    the narrow instantiations (C 32, F 64 / 128 / 192), F 512 in two
    slices, far offsets and integer coordinates; one launch each, and a
    second run bit-equal to the first (no atomics)."""
    from mv2d_tpu_torch.ops import dcn
    x, sy, sx, m, w = smoke.dcn_inputs(dev, getattr(torch, dtype), V, H, W,
                                       C, F, stride, far=far)
    if integer:
        sy, sx = sy.round(), sx.round()
    args = (x, sy, sx, m, w)
    before = dcn.dcn_conv.launches
    got = dcn.dcn_conv(*args)
    assert dcn.dcn_conv.launches == before + 1
    check(got, dcn.dcn_conv_plain(*args), tol)
    assert torch.equal(dcn.dcn_conv(*args), got)


@pytest.mark.parametrize('dtype,tol', DTYPES)
def test_roi_align_kernel(dev, dtype, tol):
    from mv2d_tpu_torch.ops import roi_align
    feats, rois = synthetic.roi_inputs(dev, getattr(torch, dtype), V=2, P=60,
                                       img=(256, 512), C=32, edge=True)
    strides = (4, 8, 16, 32)
    check(roi_align.roi_align_multilevel(feats, rois, strides),
          roi_align.multilevel_roi_align_plain(feats, rois, strides), tol)


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('img,C,P,kind', [
    ((512, 1408), 64, 40, 'edge'),     # 1408x8, 6x512, empty, outside,
                                       # whole image (level 3)
    ((640, 1600), 64, 60, 'normal'),   # R101's levels p2..p5
    ((512, 1408), 64, 30, 'sliver'),   # slivers only: 353 columns a RoI
    ((256, 512), 40, 50, 'normal'),    # C 40: part of a channel slice
])
def test_roi_align_kernel_shapes(dev, dtype, tol, img, C, P, kind):
    """K3 against its plain version at the edge RoIs, R101's level sizes
    and slivers; one launch a call."""
    from mv2d_tpu_torch.ops import roi_align
    feats, rois = synthetic.roi_inputs(dev, getattr(torch, dtype), V=2, P=P,
                                       img=img, C=C, edge=kind == 'edge',
                                       sliver=kind == 'sliver')
    strides = (4, 8, 16, 32)
    n3 = roi_align.roi_align_multilevel.launches
    got = roi_align.roi_align_multilevel(feats, rois, strides)
    assert roi_align.roi_align_multilevel.launches == n3 + 1
    check(got, roi_align.multilevel_roi_align_plain(feats, rois, strides),
          tol)


def test_roi_align_bf16_runs_are_bit_equal(dev):
    from mv2d_tpu_torch.ops import roi_align
    feats, rois = synthetic.roi_inputs(dev, torch.bfloat16, V=12, P=300,
                                       edge=True)
    a = roi_align.roi_align_multilevel(feats, rois, (4, 8, 16, 32))
    b = roi_align.roi_align_multilevel(feats, rois, (4, 8, 16, 32))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_roi_align_kernel_refuses_what_it_does_not_take(dev):
    """C % 8, three levels, float16: ValueError or TypeError."""
    from mv2d_tpu_torch.ops import roi_align
    feats, rois = synthetic.roi_inputs(dev, torch.bfloat16, V=1, P=5,
                                       img=(64, 128), C=16)
    strides = (4, 8, 16, 32)
    with pytest.raises(ValueError):
        roi_align.roi_align_multilevel([f[..., :12].contiguous()
                                        for f in feats], rois, strides)
    with pytest.raises(ValueError):
        roi_align.roi_align_multilevel(feats[:3], rois, strides[:3])
    with pytest.raises(TypeError):
        roi_align.roi_align_multilevel([f.half() for f in feats], rois,
                                       strides)


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('self_attn', [False, True])
def test_attention_kernel(dev, dtype, tol, self_attn):
    from mv2d_tpu_torch.ops import attention
    q, k, v, a = smoke.attention_inputs(dev, getattr(torch, dtype), Q=100,
                                        K=1000, C=64, self_attn=self_attn)
    got = attention.masked_attention(q, k, v, a, 2)
    check(got, attention.masked_attention_plain(q, k, v, a, 2), tol)
    empty = ~a.any(-1)
    assert bool((got[empty] == 0).all())


def check_all(kernel_outs, plain_outs, tol):
    torch.cuda.synchronize()
    err, rel, finite, same = smoke.compare_all(kernel_outs, plain_outs)
    assert same and finite and rel <= tol, (err, rel)


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('stride,far,integer', [
    (1, 0.0, False), (2, 0.0, False), (1, 0.3, False), (1, 0.0, True)])
def test_dcn_samples_kernels(dev, dtype, tol, stride, far, integer):
    """B5 forward and B6 backward against autograd of the plain samples;
    `integer` puts every sample on integer coordinates (zero offsets)."""
    from mv2d_tpu_torch.ops import dcn
    x, sy, sx, m, _ = smoke.dcn_inputs(dev, getattr(torch, dtype), 2, 11,
                                       19, 64, 64, stride, far=far)
    if integer:
        sy, sx = sy.round(), sx.round()
    args = (x, sy, sx, m)
    out, grads = smoke.plain_grads(dcn.dcn_samples_plain, args, range(4),
                                   smoke.cotangent(dcn.dcn_samples_plain(
                                       *args)))
    n5, n6 = dcn.dcn_samples_forward.launches, \
        dcn.dcn_samples_backward.launches
    got, ggot = smoke.plain_grads(dcn.dcn_samples, args, range(4),
                                  smoke.cotangent(out))
    assert dcn.dcn_samples_forward.launches == n5 + 1
    assert dcn.dcn_samples_backward.launches == n6 + 1
    check_all([got, *ggot], [out, *grads], tol)


def b6_inputs(dev, dt, V, H, W, C, stride, kind):
    """B6's inputs and a cotangent; `kind`: 'far' (20% of the samples well
    outside the map), 'integer' (integer coordinates), 'pile' (every
    sample inside the map on one cell, 20% outside) or 'normal'."""
    x, sy, sx, m, _ = smoke.dcn_inputs(dev, dt, V, H, W, C, 64, stride,
                                       far=0.2 if kind in ('far', 'pile')
                                       else 0.0)
    if kind == 'integer':
        sy, sx = sy.round(), sx.round()
    if kind == 'pile':
        inside = (sy > -1) & (sy < H) & (sx > -1) & (sx < W)
        sy = torch.where(inside, torch.full_like(sy, 5.25), sy).contiguous()
        sx = torch.where(inside, torch.full_like(sx, 7.5), sx).contiguous()
    g = smoke.cotangent(dcn_samples_plain(x, sy, sx, m))
    return x, sy, sx, m, g


def dcn_samples_plain(*args):
    from mv2d_tpu_torch.ops import dcn
    return dcn.dcn_samples_plain(*args)


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('V,H,W,C,stride,kind', [
    (12, 16, 44, 64, 1, 'pile'),      # lists far beyond one piece
    (2, 11, 19, 64, 1, 'far'),
    (2, 11, 19, 64, 1, 'integer'),
    (1, 13, 21, 40, 1, 'normal'),     # ragged: odd sides, C 40
    (2, 12, 16, 512, 2, 'normal'),    # two channel slices
])
def test_dcn_samples_backward_owner_cases(dev, dtype, tol, V, H, W, C,
                                          stride, kind):
    """B6 against the plain version's autograd at the edges of its owner
    scheme; dx comes back in x.dtype, one launch a call."""
    from mv2d_tpu_torch.ops import dcn
    x, sy, sx, m, g = b6_inputs(dev, getattr(torch, dtype), V, H, W, C,
                                stride, kind)
    _, want = smoke.plain_grads(dcn.dcn_samples_plain, (x, sy, sx, m),
                                range(4), g)
    n6 = dcn.dcn_samples_backward.launches
    got = dcn.dcn_samples_backward(x, sy, sx, m, g)
    assert dcn.dcn_samples_backward.launches == n6 + 1
    assert got[0].dtype == x.dtype
    check_all(list(got), want, tol)


def test_dcn_samples_backward_bf16_runs_are_bit_equal(dev):
    """No float atomics: two runs of B6 give equal bits, at a normal and a
    pile-up input."""
    from mv2d_tpu_torch.ops import dcn
    for kind in ('normal', 'pile'):
        args = b6_inputs(dev, torch.bfloat16, 12, 32, 88, 256, 1, kind)
        a = dcn.dcn_samples_backward(*args)
        b = dcn.dcn_samples_backward(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_dcn_samples_backward_refuses_what_it_does_not_take(dev):
    """C % 8, float16, dsamples in another dtype or shape: ValueError or
    TypeError, never a fallback."""
    from mv2d_tpu_torch.ops import dcn
    x, sy, sx, m, g = b6_inputs(dev, torch.bfloat16, 1, 8, 8, 16, 1,
                                'normal')
    with pytest.raises(ValueError):                       # C % 8
        dcn.dcn_samples_backward(x[..., :12].contiguous(), sy, sx, m,
                                 g[..., :12].contiguous())
    with pytest.raises(ValueError):                       # dsamples dtype
        dcn.dcn_samples_backward(x, sy, sx, m, g.float())
    with pytest.raises(ValueError):                       # dsamples shape
        dcn.dcn_samples_backward(x, sy, sx, m, g[:, :4].contiguous())
    with pytest.raises(TypeError):                        # float16
        dcn.dcn_samples_backward(x.half(), sy, sx, m, g.half())


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('self_attn', [False, True])
def test_attention_lse_and_backward_kernels(dev, dtype, tol, self_attn):
    """K4's log-sum-exp output and B8 against the plain version's
    logsumexp and autograd; rows with no allowed key get zero dq."""
    from mv2d_tpu_torch.ops import attention
    q, k, v, a = smoke.attention_inputs(dev, getattr(torch, dtype), Q=100,
                                        K=1000, C=64, self_attn=self_attn)
    a[:, :64] = False                         # keys no row may attend
    _, lse = attention.masked_attention_forward(q, k, v, a, 2)
    check_all([lse], [attention.attention_lse_plain(q, k, a, 2)], tol)
    args = (q, k, v, a, 2)
    out, grads = smoke.plain_grads(attention.masked_attention_plain, args,
                                   range(3), smoke.cotangent(q))
    n8 = attention.masked_attention_backward.launches
    got, ggot = smoke.plain_grads(attention.masked_attention_train, args,
                                  range(3), smoke.cotangent(q))
    assert attention.masked_attention_backward.launches == n8 + 1
    check_all([got, *ggot], [out, *grads], tol)
    empty = ~a.any(-1)
    assert bool((ggot[0][empty] == 0).all())
    assert bool((ggot[1][:64] == 0).all() and (ggot[2][:64] == 0).all())


@pytest.mark.parametrize('dtype,tol', DTYPES)
def test_roi_align_backward_kernel(dev, dtype, tol):
    from mv2d_tpu_torch.ops import roi_align
    feats, rois = synthetic.roi_inputs(dev, getattr(torch, dtype), V=2, P=60,
                                       img=(256, 512), C=32, edge=True)
    strides = (4, 8, 16, 32)

    def plain(*fs):
        return roi_align.multilevel_roi_align_plain(fs, rois, strides)

    def train(*fs):
        return roi_align.roi_align_multilevel_train(fs, rois, strides)

    out, grads = smoke.plain_grads(plain, feats, range(4),
                                   smoke.cotangent(plain(*feats)))
    ggot_levels = roi_align.roi_align_multilevel_backward(
        feats, rois, smoke.cotangent(out), strides)
    check_all(ggot_levels, grads, tol)
    n9 = roi_align.roi_align_multilevel_backward.launches
    got, ggot = smoke.plain_grads(train, feats, range(4),
                                  smoke.cotangent(out))
    assert roi_align.roi_align_multilevel_backward.launches == n9 + 1
    check_all([got, *ggot], [out, *grads], tol)


def b9_case(dev, dt, V=2, P=60, img=(256, 512), C=32, edge=True,
            pile=False, wide=False):
    """B9's inputs, the plain version's autograd and a cotangent; `pile`
    puts every RoI on one box; `wide` takes `wide_roi_inputs` (a finest
    level 560 cells wide, slivers across it) instead."""
    from mv2d_tpu_torch.ops import roi_align
    if wide:
        feats, rois = synthetic.wide_roi_inputs(dev, dt, V=V, P=P, C=C)
    else:
        feats, rois = synthetic.roi_inputs(dev, dt, V=V, P=P, img=img, C=C,
                                           edge=edge)
    if pile:
        rois[:] = torch.tensor([100.0, 50.0, 220.0, 170.0], device=dev)
    strides = (4, 8, 16, 32)

    def plain(*fs):
        return roi_align.multilevel_roi_align_plain(fs, rois, strides)
    g = smoke.cotangent(plain(*feats))
    _, want = smoke.plain_grads(plain, feats, range(4), g)
    return feats, rois, strides, g, want


def test_roi_align_backward_bf16_runs_are_bit_equal(dev):
    """No float atomics: two runs of B9 give equal bits, at the training
    RoIs' shape and on a pile-up."""
    from mv2d_tpu_torch.ops import roi_align
    for pile in (False, True):
        feats, rois, strides, g, _ = b9_case(dev, torch.bfloat16, V=6,
                                             P=512, img=(512, 1408), C=64,
                                             edge=False, pile=pile)
        a = roi_align.roi_align_multilevel_backward(feats, rois, g, strides)
        b = roi_align.roi_align_multilevel_backward(feats, rois, g, strides)
        torch.cuda.synchronize()
        assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize('dtype,tol', DTYPES)
def test_roi_align_backward_dtype_and_zeros(dev, dtype, tol):
    """B9 returns each level in the features' dtype, written in full: zero
    exactly where no RoI's footprint reaches (the plain index pass's
    boxes), the plain version's autograd elsewhere."""
    from mv2d_tpu_torch.ops import roi_align
    dt = getattr(torch, dtype)
    feats, rois, strides, g, want = b9_case(dev, dt)
    got = roi_align.roi_align_multilevel_backward(feats, rois, g, strides)
    check_all(got, want, tol)
    dims = [d for f in feats for d in (f.shape[1], f.shape[2])]
    lvl, box = roi_align.roi_footprints_plain(rois.reshape(-1, 4).cpu(),
                                              dims, strides)
    P = rois.shape[1]
    for l, (f, gl) in enumerate(zip(feats, got)):
        assert gl.dtype == f.dtype and gl.shape == f.shape
        cover = torch.zeros(f.shape[:3], dtype=torch.bool)
        for r in torch.nonzero(lvl == l).flatten().tolist():
            y0, y1, x0, x1 = box[r].tolist()
            cover[r // P, y0:y1 + 1, x0:x1 + 1] = True
        assert bool((gl.cpu()[~cover] == 0).all())
        assert bool(cover.any()) == bool((gl != 0).any())


@pytest.mark.parametrize('dtype,tol', DTYPES)
def test_roi_align_backward_on_a_wide_level(dev, dtype, tol):
    """B9 takes levels of any side: on a finest level 560 cells wide, with
    slivers across all of it, against the plain version's autograd and its
    owner scheme in plain PyTorch (`roi_align_backward_plain`)."""
    from mv2d_tpu_torch.ops import roi_align
    feats, rois, strides, g, want = b9_case(
        dev, getattr(torch, dtype), V=2, P=40, C=72, wide=True)
    assert feats[0].shape[2] == 560
    got = roi_align.roi_align_multilevel_backward(feats, rois, g, strides)
    check_all(got, want, tol)
    owners = roi_align.roi_align_backward_plain(
        [f.cpu() for f in feats], rois.cpu(), g.cpu(), strides)
    check_all([x.cpu() for x in got], owners, tol)


@pytest.mark.parametrize('dtype,tol', DTYPES)
def test_roi_align_backward_pile_up(dev, dtype, tol):
    """512 identical RoIs on a view: each tile they cover walks a list of
    512 RoIs."""
    from mv2d_tpu_torch.ops import roi_align
    feats, rois, strides, g, want = b9_case(
        dev, getattr(torch, dtype), V=2, P=512, C=64, edge=False, pile=True)
    n9 = roi_align.roi_align_multilevel_backward.launches
    got = roi_align.roi_align_multilevel_backward(feats, rois, g, strides)
    assert roi_align.roi_align_multilevel_backward.launches == n9 + 1
    check_all(got, want, tol)


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('V,H,W,C,stride', [
    (12, 64, 176, 256, 2), (12, 32, 88, 256, 1),     # the stage shapes
    (12, 32, 88, 512, 2), (12, 16, 44, 512, 1),
    (1, 13, 21, 40, 1), (2, 9, 15, 64, 2)])           # ragged pixel tiles
def test_dcn_samples_forward_shapes(dev, dtype, tol, V, H, W, C, stride):
    """B5 at the four DCN stage shapes and where Ho, Wo are not multiples
    of its pixel tile; one launch a call."""
    from mv2d_tpu_torch.ops import dcn
    x, sy, sx, m, _ = smoke.dcn_inputs(dev, getattr(torch, dtype), V, H, W,
                                       C, 64, stride)
    n5 = dcn.dcn_samples_forward.launches
    got = dcn.dcn_samples_forward(x, sy, sx, m)
    assert dcn.dcn_samples_forward.launches == n5 + 1
    assert got.dtype == x.dtype
    check(got, dcn.dcn_samples_plain(x, sy, sx, m), tol)


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('kind', ['far', 'integer'])
def test_dcn_samples_forward_far_and_integer(dev, dtype, tol, kind):
    """B5 with half the samples far outside the map (no corner loads),
    and on integer coordinates (three corners of weight 0)."""
    from mv2d_tpu_torch.ops import dcn
    x, sy, sx, m, _ = smoke.dcn_inputs(dev, getattr(torch, dtype), 2, 13,
                                       21, 64, 64, 1,
                                       far=0.5 if kind == 'far' else 0.0)
    if kind == 'integer':
        sy, sx = sy.round(), sx.round()
    check(dcn.dcn_samples_forward(x, sy, sx, m),
          dcn.dcn_samples_plain(x, sy, sx, m), tol)


def test_kernels_refuse_cpu_fallback(dev):
    """On CUDA tensors a wrapper launches or raises; bad input raises."""
    from mv2d_tpu_torch.ops import attention, dcn
    q = torch.zeros(4, 48, device=dev)
    with pytest.raises(ValueError):
        attention.masked_attention(q, q, q, torch.ones(4, 4, dtype=torch.bool,
                                                       device=dev), 1)
    for C, F in ((48, 64), (64, 96)):         # K2: C % 32, F % 64
        args = smoke.dcn_inputs(dev, torch.bfloat16, 1, 8, 8, C, F, 1)
        with pytest.raises(ValueError):
            dcn.dcn_conv(*args)


# ------------------------------------------------ kernels of the routes

@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('stage_index', [1, 2])
def test_identity_chain_kernel(dev, dtype, tol, stage_index):
    """B10 at planes 128 (layer2's tail) and 256 (layer3's), ragged
    tiles."""
    from mv2d_tpu_torch.ops import stage
    x, blocks = smoke.identity_chain_inputs(dev, getattr(torch, dtype), V=2,
                                            H=13, W=37, stage=stage_index)
    want = stage.fused_identity_chain_plain(x, blocks)
    before = stage.fused_identity_chain.launches
    got = stage.fused_identity_chain(x, blocks)
    assert stage.fused_identity_chain.launches == before + len(blocks)
    check(got, want, tol)


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('stride,far,integer', [
    (1, 0.0, False), (2, 0.0, False), (1, 0.3, False), (1, 0.0, True)])
def test_dcn_conv_backward_kernel(dev, dtype, tol, stride, far, integer):
    """K2 forward and B13 backward (DCNConvFn) against autograd of the
    plain conv: the output and all five gradients."""
    from mv2d_tpu_torch.ops import dcn
    x, sy, sx, m, w = smoke.dcn_inputs(dev, getattr(torch, dtype), 2, 11, 19,
                                       64, 128, stride, far=far)
    if integer:
        sy, sx = sy.round(), sx.round()
    args = (x, sy, sx, m, w)
    out, grads = smoke.plain_grads(dcn.dcn_conv_plain, args, range(5),
                                   smoke.cotangent(dcn.dcn_conv_plain(*args)))
    n13 = dcn.dcn_conv_backward.launches
    got, ggot = smoke.plain_grads(dcn.dcn_conv_train, args, range(5),
                                  smoke.cotangent(out))
    assert dcn.dcn_conv_backward.launches == n13 + 1
    check_all([got, *ggot], [out, *grads], tol)


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('mask', ['cross', 'self', 'full'])
def test_attention_sparse_backward_kernel(dev, dtype, tol, mask):
    """The flash_sparse route (masked_attention_train with sparse), whose
    backward is B8, against the plain version's autograd: rows with no
    allowed key, keys no row may attend, every pair allowed; one B8
    launch a backward and no other backward kernel."""
    from mv2d_tpu_torch.ops import attention
    q, k, v, a = smoke.attention_inputs(dev, getattr(torch, dtype), Q=100,
                                        K=1000, C=64,
                                        self_attn=mask == 'self')
    if mask == 'full':
        a = torch.ones_like(a)
    else:
        a[:, :64] = False                     # keys no row may attend
    args = (q, k, v, a, 2)
    out, grads = smoke.plain_grads(attention.masked_attention_plain, args,
                                   range(3), smoke.cotangent(q))
    fns = smoke.counters()
    before = {n: fn.launches for n, fn in fns.items()}
    got, ggot = smoke.plain_grads(attention.masked_attention_train,
                                  args + (True,), range(3),
                                  smoke.cotangent(q))
    launched = {n: fn.launches - before[n] for n, fn in fns.items()}
    assert launched['masked_attention_backward'] == 1
    assert all(launched[n] == 0 for n in launched if 'backward' in n
               and n != 'masked_attention_backward')
    check_all([got, *ggot], [out, *grads], tol)
    empty = ~a.any(-1)
    assert bool((ggot[0][empty] == 0).all())
    if mask != 'full':
        assert bool((ggot[1][:64] == 0).all() and (ggot[2][:64] == 0).all())


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('stage_index,V,H,W', [
    (1, 2, 64, 176),      # 176 tiles of 8x16: more than the SMs
    (2, 4, 32, 88),       # 192 tiles of 4x16 (88 = 5.5 tiles wide)
    (1, 1, 8, 16),        # one tile
    (2, 1, 3, 11)])       # one tile, under its size
def test_identity_chain_kernel_tile_counts(dev, dtype, tol, stage_index, V,
                                           H, W):
    """B10's persistent walk: a tile count that is not a multiple of the
    SM count, and a map of one tile, at planes 128 and 256."""
    from mv2d_tpu_torch.ops import stage
    x, blocks = smoke.identity_chain_inputs(dev, getattr(torch, dtype), V=V,
                                            H=H, W=W, stage=stage_index)
    want = stage.fused_identity_chain_plain(x, blocks)
    got = stage.fused_identity_chain(x, blocks)
    check(got, want, tol)


def test_identity_chain_bf16_runs_are_bit_equal(dev):
    """No atomics in B10: two runs give equal bits."""
    from mv2d_tpu_torch.ops import stage
    for stage_index in (1, 2):
        x, blocks = smoke.identity_chain_inputs(dev, torch.bfloat16, V=2,
                                                H=21, W=40, stage=stage_index)
        a = stage.fused_identity_chain(x, blocks)
        b = stage.fused_identity_chain(x, blocks)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def b13_inputs(dev, dt, V, H, W, C, F, stride, kind):
    """B13's inputs and a cotangent; `kind` as b6_inputs takes it."""
    x, sy, sx, m, w = smoke.dcn_inputs(dev, dt, V, H, W, C, F, stride,
                                       far=0.2 if kind in ('far', 'pile')
                                       else 0.0)
    if kind == 'pile':
        inside = (sy > -1) & (sy < H) & (sx > -1) & (sx < W)
        sy = torch.where(inside, torch.full_like(sy, 5.25), sy).contiguous()
        sx = torch.where(inside, torch.full_like(sx, 7.5), sx).contiguous()
    from mv2d_tpu_torch.ops import dcn
    g = smoke.cotangent(dcn.dcn_conv_plain(x, sy, sx, m, w))
    return x, sy, sx, m, w, g


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_dcn_conv_backward_runs_are_bit_equal(dev, dtype):
    """No float atomics in B13: two runs give equal bits, at a normal and a
    pile-up input, with C 256 and F 256 (the stage-3 tiles) and C 512,
    F 512 (stage 4's)."""
    from mv2d_tpu_torch.ops import dcn
    for C, kind in ((256, 'normal'), (512, 'pile')):
        args = b13_inputs(dev, getattr(torch, dtype), 2, 16, 44, C, C, 1,
                          kind)
        a = dcn.dcn_conv_backward(*args)
        b = dcn.dcn_conv_backward(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('V,H,W,C,F,stride,kind', [
    (12, 16, 44, 64, 128, 1, 'pile'),    # every sample on one cell
    (2, 13, 21, 128, 64, 1, 'normal'),   # ragged N, F 64 (one warpgroup)
    (2, 12, 16, 512, 512, 2, 'far'),     # stage 4's tiles
    (1, 9, 30, 192, 384, 1, 'normal')])  # C 192, F 384
def test_dcn_conv_backward_kernel_cases(dev, dtype, tol, V, H, W, C, F,
                                        stride, kind):
    """B13 alone against the plain conv's autograd: dx in x.dtype, dw in
    w.dtype, one launch a call and no launch of B6's own wrapper."""
    from mv2d_tpu_torch.ops import dcn
    x, sy, sx, m, w, g = b13_inputs(dev, getattr(torch, dtype), V, H, W, C,
                                    F, stride, kind)
    _, want = smoke.plain_grads(dcn.dcn_conv_plain, (x, sy, sx, m, w),
                                range(5), g)
    n13 = dcn.dcn_conv_backward.launches
    n6 = dcn.dcn_samples_backward.launches
    got = dcn.dcn_conv_backward(x, sy, sx, m, w, g)
    assert dcn.dcn_conv_backward.launches == n13 + 1
    assert dcn.dcn_samples_backward.launches == n6
    assert got[0].dtype == x.dtype and got[4].dtype == w.dtype
    check_all(list(got), want, tol)


def test_routed_kernels_refuse_what_they_do_not_take(dev):
    """On CUDA tensors the new wrappers launch or raise."""
    from mv2d_tpu_torch.ops import dcn, stage
    x, blocks = smoke.stage1_inputs(dev, torch.float32, V=1, H=8, W=8)
    with pytest.raises(ValueError):           # planes 64: K1's width
        stage.fused_identity_chain(torch.zeros(1, 8, 8, 256, device=dev),
                                   blocks[1:])
    args = smoke.dcn_inputs(dev, torch.float32, 1, 8, 8, 32, 64, 1)
    with pytest.raises(ValueError):           # C % 64 != 0
        dcn.dcn_conv_backward(*args, torch.zeros(1, 8, 8, 64, device=dev))


# ------------------------------------- the serving paths' RoIAlign kernels

@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('sampling_ratio', [0, 2])
def test_roi_align_flat_kernel(dev, dtype, tol, sampling_ratio):
    """B12 on random views with the edge RoIs (outside, empty, whole
    image, slivers), C 40: a ragged channel chunk."""
    from mv2d_tpu_torch.ops import roi_align
    feats, rois, views = synthetic.flat_roi_inputs(
        dev, getattr(torch, dtype), R=300, V=3, img=(256, 512), C=40,
        edge=True)
    strides = (4, 8, 16, 32)
    want = roi_align.multilevel_roi_align_flat_plain(feats, rois, views,
                                                     strides, sampling_ratio)
    n12 = roi_align.roi_align_flat.launches
    got = roi_align.roi_align_flat(feats, rois, views, strides,
                                   sampling_ratio)
    assert roi_align.roi_align_flat.launches == n12 + 1
    check(got, want, tol)


@pytest.mark.parametrize('dtype,tol', DTYPES)
def test_roi_align_slab_kernels(dev, dtype, tol):
    """B11 against the plain version, and B11 forward with B9 backward
    (roi_align_multilevel_train with slab) against the plain version's
    autograd; K3 not launched."""
    from mv2d_tpu_torch.ops import roi_align
    feats, rois = synthetic.roi_inputs(dev, getattr(torch, dtype), V=2, P=60,
                                       img=(256, 512), C=40, edge=True)
    strides = (4, 8, 16, 32)
    n3, n11 = roi_align.roi_align_multilevel.launches, \
        roi_align.roi_align_slab.launches
    check(roi_align.roi_align_slab(feats, rois, strides),
          roi_align.multilevel_roi_align_plain(feats, rois, strides), tol)

    def plain(*fs):
        return roi_align.multilevel_roi_align_plain(fs, rois, strides)

    def train(*fs):
        return roi_align.roi_align_multilevel_train(fs, rois, strides, True)

    out, grads = smoke.plain_grads(plain, feats, range(4),
                                   smoke.cotangent(plain(*feats)))
    n9 = roi_align.roi_align_multilevel_backward.launches
    got, ggot = smoke.plain_grads(train, feats, range(4),
                                  smoke.cotangent(out))
    assert roi_align.roi_align_slab.launches == n11 + 2
    assert roi_align.roi_align_multilevel_backward.launches == n9 + 1
    assert roi_align.roi_align_multilevel.launches == n3
    check_all([got, *ggot], [out, *grads], tol)


def test_separable_roi_kernels_refuse_what_they_do_not_take(dev):
    """B11 and B12 launch or raise: a level over 512 cells a side launches
    (the streamed core has no limit on a level's side) and matches the
    plain version; a view index of another length and channels not a
    multiple of 8 raise."""
    from mv2d_tpu_torch.ops import roi_align
    strides = (4, 8, 16, 32)
    rois = torch.tensor([[0.0, 0.0, 64.0, 64.0]], device=dev)
    g = torch.Generator().manual_seed(0)
    wide = [torch.randn(1, 8, 520, 8, generator=g).to(dev)] * 4
    views = torch.zeros(1, device=dev)
    n12 = roi_align.roi_align_flat.launches
    got = roi_align.roi_align_flat(wide, rois, views, strides)
    assert roi_align.roi_align_flat.launches == n12 + 1
    check(got, roi_align.multilevel_roi_align_flat_plain(wide, rois, views,
                                                         strides), 1e-4)
    ok = [torch.zeros(1, 8, 8, 8, device=dev)] * 4
    with pytest.raises(ValueError):
        roi_align.roi_align_flat(ok, rois, torch.zeros(2, device=dev),
                                 strides)
    with pytest.raises(ValueError):
        roi_align.roi_align_slab([torch.zeros(1, 8, 8, 12, device=dev)] * 4,
                                 rois[None], strides)


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('sampling_ratio', [0, 2])
def test_roi_align_stream_kernels_on_a_wide_level(dev, dtype, tol,
                                                  sampling_ratio):
    """B11 (adaptive) and B12 on a finest level 560 cells wide, with
    slivers across all of it, against their plain versions."""
    from mv2d_tpu_torch.ops import roi_align
    feats, rois = synthetic.wide_roi_inputs(dev, getattr(torch, dtype), V=2,
                                            P=40, C=72)
    strides = (4, 8, 16, 32)
    assert feats[0].shape[2] == 560
    flat = rois.reshape(-1, 4)
    views = torch.arange(2, device=dev).repeat_interleave(40)
    check(roi_align.roi_align_flat(feats, flat, views, strides,
                                   sampling_ratio),
          roi_align.multilevel_roi_align_flat_plain(feats, flat, views,
                                                    strides, sampling_ratio),
          tol)
    if sampling_ratio == 0:
        check(roi_align.roi_align_slab(feats, rois, strides),
              roi_align.multilevel_roi_align_plain(feats, rois, strides), tol)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_roi_align_stream_runs_are_bit_equal(dev, dtype):
    """Two runs of B11 and of B12 give equal bits (sums in a fixed order,
    nothing atomic), at C 256: one channel pass in bfloat16, two in
    float32."""
    from mv2d_tpu_torch.ops import roi_align
    dt = getattr(torch, dtype)
    strides = (4, 8, 16, 32)
    feats, rois = synthetic.roi_inputs(dev, dt, V=2, P=200, img=(256, 512),
                                       edge=True)
    a = roi_align.roi_align_slab(feats, rois, strides)
    b = roi_align.roi_align_slab(feats, rois, strides)
    feats, flat, views = synthetic.flat_roi_inputs(dev, dt, R=600, V=3,
                                                   img=(256, 512), edge=True)
    c = roi_align.roi_align_flat(feats, flat, views, strides, 2)
    d = roi_align.roi_align_flat(feats, flat, views, strides, 2)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_stream_plan_is_the_plain_mirror_box(dev, dtype):
    """The slot `roi_align_stream_plain` walks by default (STREAM_BOX) is the
    one the kernel reports, a whole number of its boxes wide."""
    from mv2d_tpu_torch.ops import roi_align
    plan = roi_align.stream_plan(getattr(torch, dtype))
    assert (plan['slot_rows'], plan['slot_columns']) == roi_align.STREAM_BOX
    assert plan['slot_columns'] % plan['box_columns'] == 0
    assert plan['blocks_per_sm'] >= 1


@pytest.mark.parametrize('P', [37, 1000])
def test_slab_worklist_kernel_is_the_plain_mirror(dev, P):
    """B11's device work list against `slab_worklist_plain`: per view, each
    size class's run holds the same RoIs (the kernel orders a run by its
    threads' timing) and the same padding, so the class bounds
    (SLAB_CLASS_CELLS) are the kernel's; the output is B11's."""
    from mv2d_tpu_torch.ops import roi_align
    feats, rois = synthetic.roi_inputs(dev, torch.bfloat16, V=3, P=P,
                                       img=(256, 704), C=8, edge=True)
    strides = (4, 8, 16, 32)
    out, order = roi_align.launch_slab(feats, rois, strides)
    want = roi_align.slab_worklist_plain(rois.cpu(), strides)
    order = order.long().cpu()
    assert order.shape == want.shape
    nb = roi_align.SLAB_BUCKET
    for v in range(rois.shape[0]):
        # each class's run: its RoIs in the mirror, padded to whole buckets
        b = rois[v].cpu().float()
        sc = 1.0 / torch.tensor([float(s) for s in strides])[
            roi_align.roi_levels(b)]
        cells = torch.maximum(b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]) * sc
        cls = sum((cells > c).long() for c in roi_align.SLAB_CLASS_CELLS)
        off = 0
        for k in range(roi_align.SLAB_CLASSES):
            run = slice(off, off + -(-int((cls == k).sum()) // nb) * nb)
            assert sorted(order[v, run].tolist()) == \
                sorted(want[v, run].tolist())
            off = run.stop
        assert bool((order[v, off:] == -1).all())
    check(out, roi_align.multilevel_roi_align_plain(feats, rois, strides),
          3e-2)


# --------------------- K4 and B8 on the packed mask, and the packing kernel

def attention_case(dev, dt, D, mask, Q=101, K=1000, H=4):
    """Ragged query and key tiles (Q 101, K 1000); `mask` 'runs' (the
    correlation-like runs, 10% of the rows empty, the first 64 keys
    attended by no row), 'full' (every pair) or 'none' (no pair)."""
    q, k, v, a = smoke.attention_inputs(dev, dt, Q=Q, K=K, C=H * D)
    if mask == 'full':
        a = torch.ones_like(a)
    elif mask == 'none':
        a = torch.zeros_like(a)
    else:
        a[:, :64] = False
    return q, k, v, a


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('D', [8, 16, 32])
@pytest.mark.parametrize('mask', ['runs', 'full', 'none'])
def test_attention_kernels_on_packed_mask(dev, dtype, tol, D, mask):
    """K4 (out, lse) and B8 (dq, dk, dv) against the plain version and its
    autograd at head dims 8, 16 and 32 (8 and 16 padded to the mma depth
    in bf16); rows with no key: zero out and dq, lse EMPTY_LSE; keys no row
    may attend: zero dk and dv; two B8 runs bit-equal (no atomics)."""
    from mv2d_tpu_torch.ops import attention
    q, k, v, a = attention_case(dev, getattr(torch, dtype), D, mask)
    H = 4
    tiles = attention.mask_tiles(a)
    n4 = attention.masked_attention.launches
    out, lse = attention.masked_attention_forward(q, k, v, a, H, tiles)
    assert attention.masked_attention.launches == n4 + 1
    torch.cuda.synchronize()
    full = a.any(-1)
    check(out, attention.masked_attention_plain(q, k, v, a, H), tol)
    plse = attention.attention_lse_plain(q, k, a, H)
    if full.any():
        check(lse[full], plse[full], tol)
    assert bool((lse[~full] == attention.EMPTY_LSE).all())
    assert bool((out[~full] == 0).all())

    g = smoke.cotangent(q)
    _, grads = smoke.plain_grads(attention.masked_attention_plain,
                                 (q, k, v, a, H), range(3), g)
    n8 = attention.masked_attention_backward.launches
    got = attention.masked_attention_backward(q, k, v, a, out, lse, g, H,
                                              tiles)
    again = attention.masked_attention_backward(q, k, v, None, out, lse, g,
                                                H, tiles)
    assert attention.masked_attention_backward.launches == n8 + 2
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    for x, y in zip(got, grads):
        check(x, y, tol)
    assert bool((got[0][~full] == 0).all())
    keyless = ~a.any(0)
    assert bool((got[1][keyless] == 0).all() and (got[2][keyless] == 0).all())


@pytest.mark.parametrize('Q,K,mask', [(101, 1000, 'runs'), (37, 37, 'full'),
                                      (300, 2048, 'none'),
                                      (2628, 2628, 'runs')])
def test_mask_bits_kernel(dev, Q, K, mask):
    """The packing kernel equals its plain version bit for bit, and the
    tile lists built from its bits equal those built on the CPU."""
    from mv2d_tpu_torch.ops import attention
    a = attention_case(dev, torch.float32, 8, mask, Q=Q, K=max(K, 700))[3]
    a = a[:, :K].contiguous()
    n = attention.mask_bits.launches
    tiles = attention.mask_tiles(a)
    assert attention.mask_bits.launches == n + 1
    want = attention.mask_tiles(a.cpu())
    torch.cuda.synchronize()
    assert tiles.bits.shape == want.bits.shape
    assert torch.equal(tiles.bits.view(torch.int64).cpu(),
                       want.bits.view(torch.int64))
    for st, lst, wst, wlst in ((tiles.key_starts, tiles.key_tiles,
                                want.key_starts, want.key_tiles),
                               (tiles.query_starts, tiles.query_tiles,
                                want.query_starts, want.query_tiles)):
        n = int(wst[-1])                  # the rest of a list is not read
        assert torch.equal(st.cpu(), wst)
        assert torch.equal(lst[:n].cpu(), wlst[:n])


def test_decoder_packs_each_mask_once_a_pass(dev):
    """A 3-layer decoder on the GPU packs its self- and cross-attention
    masks once a pass (2 launches of the packing kernel), for 6 K4
    launches, and with gradients 6 B8 launches in the backward."""
    from mv2d_tpu_torch.nn.decoder import PETRDecoder
    from mv2d_tpu_torch.ops import attention
    torch.manual_seed(0)
    dec = PETRDecoder(3, 32, 4, 64).to(dev)
    Q, K = 70, 300
    query, qpos = torch.randn(Q, 32, device=dev), torch.randn(Q, 32,
                                                              device=dev)
    keys, kpos = torch.randn(K, 32, device=dev), torch.randn(K, 32,
                                                             device=dev)
    self_a = torch.rand(Q, Q, device=dev) < 0.5
    cross_a = torch.rand(Q, K, device=dev) < 0.1
    fns = (attention.mask_bits, attention.masked_attention,
           attention.masked_attention_backward)
    for fn in fns:
        fn.launches = 0
    with torch.no_grad():
        dec(query, qpos, keys, kpos, self_a, cross_a)
    assert [fn.launches for fn in fns] == [2, 6, 0]
    for fn in fns:
        fn.launches = 0
    dec(query, qpos, keys, kpos, self_a, cross_a).sum().backward()
    assert [fn.launches for fn in fns] == [2, 6, 6]


def test_tiny_dcn_training_step_equals_cpu(dev):
    """One tiny+DCN training step (float32) on the GPU, through B5 / B6 and
    the other training kernels, against the same step on the CPU (plain
    versions): every loss and every gradient (`chip_smoke.phase_tiny_train`
    states the tolerances)."""
    assert smoke.phase_tiny_train(dev)


# --------------------------------------------- data pipeline and eval loop

@pytest.fixture(scope='module')
def rendered(tmp_path_factory):
    """Three scenes of the synthetic fixture at 160x90, with its tiny
    dataset (6 views, 64x96, one frame)."""
    from mv2d_tpu_torch.data import nuscenes, pipeline
    from mv2d_tpu_torch.tools.make_synth_fixture import make_fixture
    paths = make_fixture(str(tmp_path_factory.mktemp('rendered')),
                         scenes=0, val_scenes=3, objects=8, image_h=90,
                         image_w=160)
    return nuscenes.NuScenesDataset(
        info_path=paths['val_info'], ann2d_path=paths['val_coco'],
        num_frames=1, test_mode=True, final_dim=(64, 96),
        ida=pipeline.IdaAugConfig(final_dim=(64, 96), H=90, W=160))


def test_eval_inputs_on_the_card_equal_the_cpu_copy(dev, rendered):
    from mv2d_tpu_torch.data.nuscenes import to_eval_inputs
    s = rendered.get_sample(0)
    ci, cc, cs = to_eval_inputs(s, 'cpu')
    gi, gc, gs = to_eval_inputs(s, dev, torch.bfloat16)
    assert gi.is_cuda and gi.dtype == torch.bfloat16
    assert torch.equal(gi.cpu(), ci.to(torch.bfloat16))
    assert torch.equal(gs.cpu(), cs)
    for name in ('intrinsics', 'extrinsics', 'lidar2img', 'img2lidar',
                 'ext_t_inv', 'trans_mats', 'timestamps'):
        assert torch.equal(getattr(gc, name).cpu(), getattr(cc, name))


def test_run_eval_on_the_card_matches_the_cpu(dev, rendered, monkeypatch):
    """run_eval of the tiny+DCN model (float32) on the GPU, through the
    kernels, against the CPU (plain versions): per scene the same valid
    slots and labels and scores within 1e-4.  Boxes: the GPU's within
    1e-3 (the tiny phase's tolerance of chip_smoke.py) of a float64
    forward of the same scene on the CPU, and within 1e-3 of the CPU's
    float32 boxes plus twice the CPU's own error against that float64
    forward, the widening at most 1e-4 of the scene's largest box value
    (one rendered scene's box moves 1.7e-3 between float32 and float64 on
    the CPU; the largest widening is printed).  The metrics within
    1e-3."""
    import dataclasses
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.data.nuscenes import to_eval_inputs
    from mv2d_tpu_torch.eval import results
    from mv2d_tpu_torch.eval.runner import run_eval
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.routes import Routes
    cfg = configs.tiny(num_views=6, stage_with_dcn=(False, False, True,
                                                    True))
    model = synthetic.init_random_weights(MV2D(cfg, Routes()).eval(),
                                          seed=3)
    fn = results.boxes_to_pred_dict
    seen = {}
    out = {}
    for d in ('cpu', dev):
        seen[d] = {}

        def rec(boxes, scores, labels, valid, info=None, _d=d):
            seen[_d][info['token']] = (boxes, scores, labels, valid)
            return fn(boxes, scores, labels, valid, info=info)
        monkeypatch.setattr(results, 'boxes_to_pred_dict', rec)
        out[d] = run_eval(model.to(d), rendered, d, verbose=False,
                          collect_submission=True)
    model64 = model.to('cpu', torch.float64)
    f64 = {}
    for i in range(len(rendered)):
        imgs, cam, shapes = to_eval_inputs(rendered.get_sample(i), 'cpu',
                                           torch.float64)
        cam = dataclasses.replace(cam, **{
            f.name: getattr(cam, f.name).double()
            for f in dataclasses.fields(cam)})
        with torch.no_grad():
            f64[rendered.get_info(i)['token']] = model64(
                imgs, cam, shapes).boxes.numpy()
    assert set(seen['cpu']) == set(seen[dev]) == set(f64)
    widest = 0.0
    for tok, (cb, cs, cl, cv) in seen['cpu'].items():
        gb, gs, gl, gv = seen[dev][tok]
        assert cv.any() and (cv == gv).all()
        assert (cl[cv] == gl[cv]).all()
        ref = f64[tok][cv]
        assert (abs(gb[cv] - ref) <= 1e-3).all(), abs(gb[cv] - ref).max()
        widen = (2 * abs(cb[cv] - ref)).clip(max=1e-4 * abs(ref).max())
        widest = max(widest, float(widen.max()))
        assert (abs(cb[cv] - gb[cv]) <= 1e-3 + widen).all(), \
            abs(cb[cv] - gb[cv]).max()
        assert abs(cs[cv] - gs[cv]).max() < 1e-4
    print(f'largest widening of the 1e-3 box tolerance: {widest:.3e}')
    (cm, csub), (gm, gsub) = out['cpu'], out[dev]
    assert list(cm) == list(gm)
    for k in cm:
        assert cm[k] == pytest.approx(gm[k], abs=1e-3, nan_ok=True), k
    assert set(csub['results']) == set(gsub['results'])


# ------------------------------------------- the operators, the export

OP_NAMES = sorted(smoke.KERNELS[k]['op'][len('mv2d::'):]
                  for k in smoke.KERNELS)


@pytest.mark.parametrize('name', OP_NAMES)
def test_opcheck_on_the_card(dev, name):
    """`torch.library.opcheck` of each `mv2d` operator on CUDA tensors
    (bfloat16, `chip_smoke.op_args`): its CUDA implementation, the kernel,
    against its fake one, and the schema's aliasing."""
    args = smoke.op_args(dev)[name]
    torch.library.opcheck(getattr(torch.ops.mv2d, name).default, args)


def test_exported_tiny_program_on_the_card(dev, tmp_path):
    """The tiny+DCN eval forward exported on the GPU (float32), saved,
    loaded and run: equal to the direct forward of its signature, and its
    launches those of one forward."""
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.tools import export
    cfg = configs.tiny(num_frames=2, stage_with_dcn=(False, False, True,
                                                     True))
    model = synthetic.init_random_weights(MV2D(cfg).eval(), seed=0).to(dev)
    V, (H, W) = cfg.total_views, cfg.image_size
    imgs = torch.randn((V, H, W, 3), generator=torch.Generator().manual_seed(
        0))
    args = export.example_inputs(cfg, dev, torch.float32, imgs)
    path = str(tmp_path / export.PROGRAM)
    torch.export.save(export.export_model(model, args), path)
    program = torch.export.load(path).module()
    fns = smoke.counters()
    for fn in fns.values():
        fn.launches = 0
    with torch.no_grad():
        got = program(*args)
    launched = {n: fn.launches for n, fn in fns.items()}
    with torch.no_grad():
        want = export.ServeForward(model)(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    need, masks = smoke.path_kernels(cfg)
    assert smoke._launch_check(launched, need)
    assert launched['mask_bits'] == masks


# ------------------------- the public functions that no model path calls

def _surface_calls():
    """name -> fn(device) -> outputs, on inputs drawn once with numpy."""
    import numpy as np
    from mv2d_tpu_torch.core import boxes, coder, geometry
    from mv2d_tpu_torch.nn import pe
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.uniform(-3, 3, (7, 3)), rng.uniform(0.5, 4, (
        7, 3)), rng.uniform(-3, 3, (7, 1))], 1).astype(np.float32)
    K, E = synthetic.camera_rig(6, (64, 176))
    l2i = (K @ np.transpose(E, (0, 2, 1))).astype(np.float32)
    uvd = rng.uniform(1, 60, (20, 3)).astype(np.float32)
    pts = rng.uniform(-40, 40, (6, 50, 3)).astype(np.float32)
    cls = rng.normal(0, 2, (30, 11)).astype(np.float32)
    code = rng.normal(0, 1, (30, 10)).astype(np.float32) * 20
    qv = rng.uniform(size=30) > 0.33
    lpe = pe.LearnedPositionalEncoding3D(8, 5, 7, 4)

    def on(d, x):
        return torch.from_numpy(x).to(d)
    return {
        'iou_3d': lambda d: (boxes.iou_3d(on(d, a), on(d, a[::-1].copy())),),
        'points_img2cam': lambda d: (geometry.points_img2cam(
            on(d, uvd), on(d, K[0, :3, :3].astype(np.float32))),),
        'denormalize_points': lambda d: (geometry.denormalize_points(
            on(d, pts / 80 + 0.5), [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]),),
        'project_lidar_to_img': lambda d: geometry.project_lidar_to_img(
            on(d, pts), on(d, l2i[:, None])),
        'nms_free_cls_decode': lambda d: coder.nms_free_cls_decode(
            on(d, cls), on(d, code), on(d, qv), 40, 10,
            (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0), 0.2),
        'LearnedPositionalEncoding3D': lambda d: (lpe.to(d)(
            torch.zeros((6, 9, 11), dtype=torch.bool, device=d)),)}


@pytest.mark.parametrize('name', ['iou_3d', 'points_img2cam',
                                  'denormalize_points',
                                  'project_lidar_to_img',
                                  'nms_free_cls_decode',
                                  'LearnedPositionalEncoding3D'])
def test_public_function_on_the_card_equals_the_cpu(dev, name):
    """Each of the six on CUDA tensors against the same call on the CPU,
    float32: floats within 1e-5 of the CPU's max, the rest equal."""
    fn = _surface_calls()[name]
    with torch.no_grad():
        want, got = fn('cpu'), fn(dev)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == 'cuda' and g.shape == w.shape
        if w.is_floating_point():
            err = float((g.cpu() - w).abs().max())
            assert err <= 1e-5 * max(float(w.abs().max()), 1e-6), err
        else:
            assert torch.equal(g.cpu(), w)
