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
@pytest.mark.parametrize('stride,far', [(1, 0.0), (2, 0.0), (1, 0.3)])
def test_dcn_kernel(dev, dtype, tol, stride, far):
    from mv2d_tpu_torch.ops import dcn
    args = smoke.dcn_inputs(dev, getattr(torch, dtype), 2, 11, 19, 64, 128,
                            stride, far=far)
    check(dcn.dcn_conv(*args), dcn.dcn_conv_plain(*args), tol)


@pytest.mark.parametrize('dtype,tol', DTYPES)
def test_roi_align_kernel(dev, dtype, tol):
    from mv2d_tpu_torch.ops import roi_align
    feats, rois = smoke.roi_inputs(dev, getattr(torch, dtype), V=2, P=60,
                                   img=(256, 512), C=32, edge=True)
    strides = (4, 8, 16, 32)
    check(roi_align.roi_align_multilevel(feats, rois, strides),
          roi_align.multilevel_roi_align_plain(feats, rois, strides), tol)


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
    feats, rois = smoke.roi_inputs(dev, getattr(torch, dtype), V=2, P=60,
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


def test_kernels_refuse_cpu_fallback(dev):
    """On CUDA tensors a wrapper launches or raises; bad input raises."""
    from mv2d_tpu_torch.ops import attention
    q = torch.zeros(4, 48, device=dev)
    with pytest.raises(ValueError):
        attention.masked_attention(q, q, q, torch.ones(4, 4, dtype=torch.bool,
                                                       device=dev), 1)


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
    """B14 (masked_attention_train with sparse) against the plain
    version's autograd: rows with no allowed key, keys no row may attend,
    every pair allowed."""
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
    n8 = attention.masked_attention_backward.launches
    n14 = attention.masked_attention_sparse_backward.launches
    got, ggot = smoke.plain_grads(attention.masked_attention_train,
                                  args + (True,), range(3),
                                  smoke.cotangent(q))
    assert attention.masked_attention_sparse_backward.launches == n14 + 1
    assert attention.masked_attention_backward.launches == n8
    check_all([got, *ggot], [out, *grads], tol)
    empty = ~a.any(-1)
    assert bool((ggot[0][empty] == 0).all())
    if mask != 'full':
        assert bool((ggot[1][:64] == 0).all() and (ggot[2][:64] == 0).all())


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
