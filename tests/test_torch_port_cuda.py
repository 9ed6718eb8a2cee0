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


def test_kernels_refuse_cpu_fallback(dev):
    """On CUDA tensors a wrapper launches or raises; bad input raises."""
    from mv2d_tpu_torch.ops import attention
    q = torch.zeros(4, 48, device=dev)
    with pytest.raises(ValueError):
        attention.masked_attention(q, q, q, torch.ones(4, 4, dtype=torch.bool,
                                                       device=dev), 1)
