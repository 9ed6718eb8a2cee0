"""The port's kernel modules (plain versions, as run on the CPU) against
the JAX package's CPU paths.

For each module that holds a CUDA kernel - ops/stage (K1), ops/dcn (K2),
ops/roi_align (K3), ops/attention (K4) - the same numpy inputs go
through the JAX function (its XLA path, what JAX runs on the CPU) and the
port's wrapper on CPU tensors (its plain version).  Tolerances are
float32 ones: 1e-4 relative to the output's max magnitude, as the two
sides differ only in summation order; attention also holds against the
Pallas kernel in interpret mode on one small case.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu.nn.resnet import Bottleneck as JBottleneck  # noqa: E402
from mv2d_tpu.ops import attention as jattn              # noqa: E402
from mv2d_tpu.ops import roi_align as jroi               # noqa: E402
from mv2d_tpu.ops.dcn import ModulatedDeformConv as JDCN  # noqa: E402
from mv2d_tpu.train.checkpoint import convert_torch_state_dict  # noqa: E402
from mv2d_tpu_torch.nn.resnet import ResNet              # noqa: E402
from mv2d_tpu_torch.ops import attention, roi_align      # noqa: E402
from mv2d_tpu_torch.ops.dcn import ModulatedDeformConv   # noqa: E402
from mv2d_tpu_torch.ops.stage import (fused_identity_chain,  # noqa: E402
                                      fused_stage1)

REL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ K1

def test_stage1_chain_matches_jax_bottlenecks():
    """fused_stage1 (plain chain of folded bottlenecks) == three JAX
    Bottleneck modules with random frozen-BN statistics."""
    rng = np.random.default_rng(0)
    net = ResNet(50)
    with torch.no_grad():
        for name, p in net.layer1.named_parameters():
            p.copy_(t(rng.normal(0, 0.1, p.shape).astype(np.float32)))
        for m in net.layer1.modules():
            if hasattr(m, 'running_var'):
                m.weight.copy_(t(rng.uniform(0.5, 1.5, m.weight.shape)
                                 .astype(np.float32)))
                m.running_var.copy_(t(rng.uniform(0.5, 1.5, m.weight.shape)
                                      .astype(np.float32)))
                m.running_mean.copy_(t(rng.normal(0, 0.1, m.weight.shape)
                                       .astype(np.float32)))
    sd = {'base_detector.backbone.' + k: v.numpy()
          for k, v in net.state_dict().items() if k.startswith('layer1.')}
    params, consts = convert_torch_state_dict(sd)
    P = params['base_detector']['backbone']
    C = consts['base_detector']['backbone']
    x = np.maximum(rng.normal(size=(2, 12, 20, 64)), 0).astype(np.float32)

    want = jnp.asarray(x)
    for i in range(3):
        blk = JBottleneck(64, stride=1, downsample=(i == 0))
        want = blk.apply({'params': P[f'layer1_{i}'],
                          'constants': C[f'layer1_{i}']}, want)
    with torch.no_grad():
        got = fused_stage1(t(x), [b.folded() for b in net.layer1])
    assert rel_err(got.numpy(), want) < REL


# ------------------------------------------------------------------ K2

@pytest.mark.parametrize('stride,far', [(1, False), (2, False), (1, True)])
def test_dcn_matches_jax(stride, far):
    """ModulatedDeformConv (plain gather + einsum) == the JAX module's XLA
    path; `far` pushes some taps' offsets far outside the map."""
    rng = np.random.default_rng(stride + 2 * far)
    V, H, W, C, F = 2, 9, 13, 32, 64
    x = rng.normal(size=(V, H, W, C)).astype(np.float32)
    k_off = rng.normal(0, 0.05, (3, 3, C, 27)).astype(np.float32)
    b_off = rng.normal(0, 1.5, (27,)).astype(np.float32)
    if far:
        b_off[0:18:4] += 40.0            # dy of taps 0, 2, 4, 6, 8
        b_off[1:18:6] -= 60.0            # dx of taps 0, 3, 6
    w9 = rng.normal(0, 0.1, (9, C, F)).astype(np.float32)
    want = JDCN(F, 3, stride).apply(
        {'params': {'conv_offset': {'kernel': k_off, 'bias': b_off},
                    'kernel': w9}}, jnp.asarray(x))
    m = ModulatedDeformConv(C, F, stride)
    with torch.no_grad():
        m.weight.copy_(t(w9.reshape(3, 3, C, F).transpose(3, 2, 0, 1)))
        m.conv_offset.weight.copy_(t(k_off.transpose(3, 2, 0, 1)))
        m.conv_offset.bias.copy_(t(b_off))
        got = m(t(x))
    assert rel_err(got.numpy(), want) < REL


# ------------------------------------------------------------------ K3

def _roi_case(rng, V=2, P=40, img=(512, 640)):
    """Anchor-like RoIs over all four levels plus edge cases."""
    side = 32 * 2.0 ** rng.integers(0, 5, (V, P)) * rng.uniform(0.7, 1.4,
                                                                 (V, P))
    ratio = 2.0 ** rng.integers(-1, 2, (V, P))
    w, h = side / np.sqrt(ratio), side * np.sqrt(ratio)
    cx, cy = rng.uniform(0, img[1], (V, P)), rng.uniform(0, img[0], (V, P))
    rois = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    rois[..., 0::2] = rois[..., 0::2].clip(0, img[1])
    rois[..., 1::2] = rois[..., 1::2].clip(0, img[0])
    rois[:, 0] = [0, 100, img[1], 108]           # extreme aspect, wide
    rois[:, 1] = [300, 0, 305, img[0]]           # extreme aspect, tall
    rois[:, 2] = [200, 200, 200, 200]            # empty
    rois[:, 3] = [-40, -30, 60, 50]              # partly outside
    rois[:, 4] = [0, 0, img[1], img[0]]          # whole image
    return rois.astype(np.float32)


def test_multilevel_roi_align_matches_jax():
    rng = np.random.default_rng(0)
    img, strides, C = (512, 640), (4, 8, 16, 32), 8
    feats = [rng.normal(size=(2, img[0] // s, img[1] // s, C))
             .astype(np.float32) for s in strides]
    rois = _roi_case(rng, img=img)
    V, P = rois.shape[:2]
    lvls = roi_align.roi_levels(t(rois))
    assert set(lvls.flatten().tolist()) == {0, 1, 2, 3}
    # JAX's lattice needs adaptive_max >= every RoI's ceil(extent / 7)
    scale = 1.0 / np.asarray(strides)[lvls.numpy()]
    extent = (rois[..., 2:] - rois[..., :2]) * scale[..., None]
    amax = int(np.ceil(extent / 7).max())
    want = jroi.multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois.reshape(-1, 4)),
        jnp.repeat(jnp.arange(V), P), strides, 7, sampling_ratio=0,
        adaptive_max=amax)
    got = roi_align.roi_align_multilevel([t(f) for f in feats], t(rois),
                                         strides)
    assert rel_err(got.numpy().reshape(V * P, 7, 7, C), want) < REL


def test_separable_roi_align_matches_jax():
    """The 3D head's separable RoIAlign (plain torch on every device)."""
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(2, 8, 12, 16)).astype(np.float32)
    boxes = _roi_case(rng, P=10, img=(128, 192))
    amax = (-(-8 // 7), -(-12 // 7))
    want = jroi.separable_roi_align_views(
        jnp.asarray(feat), jnp.asarray(boxes), 1 / 16, 7, sampling_ratio=-1,
        adaptive_max=amax)
    got = roi_align.separable_roi_align_views(t(feat), t(boxes), 1 / 16, 7,
                                              amax)
    assert rel_err(got.numpy(), want) < REL


# ------------------------------------------------------------------ K4

def _attn_case(rng, Q, K, C):
    q, k, v = (rng.normal(size=(n, C)).astype(np.float32)
               for n in (Q, K, K))
    allowed = rng.random((Q, K)) < 0.05
    allowed[: Q // 8] = False                    # fully masked rows
    return q, k, v, allowed


def test_masked_attention_matches_jax():
    rng = np.random.default_rng(0)
    q, k, v, allowed = _attn_case(rng, 72, 300, 64)
    want = jattn.multi_head_attention(
        jnp.asarray(q)[None], jnp.asarray(k)[None], jnp.asarray(v)[None], 8,
        jnp.asarray(allowed)[None])[0]
    got = attention.masked_attention(t(q), t(k), t(v), t(allowed), 8)
    assert rel_err(got.numpy(), want) < REL
    assert np.all(got.numpy()[: 72 // 8] == 0.0)   # rows with no key: zeros


def test_masked_attention_matches_pallas_interpret():
    from mv2d_tpu.ops.pallas_attention import masked_flash_attention
    rng = np.random.default_rng(1)
    q, k, v, allowed = _attn_case(rng, 64, 256, 32)
    want = masked_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(allowed),
        4, block_k=128, interpret=True, sparse=True)
    got = attention.masked_attention(t(q), t(k), t(v), t(allowed), 4)
    assert rel_err(got.numpy(), want) < REL


def test_wrappers_take_plain_path_only_on_cpu():
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper goes to its kernel, which refuses a non-CUDA tensor."""
    from mv2d_tpu_torch.ops import dcn
    meta = dict(device='meta')
    x = torch.empty(1, 4, 4, 32, **meta)
    c = torch.empty(1, 4, 4, 9, **meta)
    x64, w64 = torch.empty(1, 4, 4, 64, **meta), torch.empty(9, 64, 64, **meta)
    calls = [
        lambda: fused_stage1(torch.empty(1, 4, 4, 64, **meta), [
            dict(w1=torch.empty(64, 64, **meta))]),
        lambda: dcn.dcn_conv(x, c, c, c, torch.empty(9, 32, 64, **meta)),
        lambda: roi_align.roi_align_multilevel(
            [x] * 4, torch.empty(1, 3, 4, **meta), (4, 8, 16, 32)),
        lambda: attention.masked_attention(
            torch.empty(5, 32, **meta), torch.empty(7, 32, **meta),
            torch.empty(7, 32, **meta),
            torch.empty(5, 7, dtype=torch.bool, **meta), 4),
        # the training path's wrappers and their backward kernels
        lambda: dcn.dcn_samples(x, c, c, c),
        lambda: dcn.dcn_samples_backward(
            x, c, c, c, torch.empty(1, 4, 4, 9, 32, **meta)),
        lambda: attention.masked_attention_train(
            torch.empty(5, 32, **meta), torch.empty(7, 32, **meta),
            torch.empty(7, 32, **meta),
            torch.empty(5, 7, dtype=torch.bool, **meta), 4),
        lambda: attention.masked_attention_backward(
            *(torch.empty(n, 32, **meta) for n in (5, 7, 7)),
            torch.empty(5, 7, dtype=torch.bool, **meta),
            torch.empty(5, 32, **meta), torch.empty(5, 4, **meta),
            torch.empty(5, 32, **meta), 4),
        lambda: roi_align.roi_align_multilevel_train(
            [x] * 4, torch.empty(1, 3, 4, **meta), (4, 8, 16, 32)),
        lambda: roi_align.roi_align_multilevel_backward(
            [x] * 4, torch.empty(1, 3, 4, **meta),
            torch.empty(1, 3, 7, 7, 32, **meta), (4, 8, 16, 32)),
        # the wrappers that the routing switches reach
        lambda: fused_identity_chain(torch.empty(1, 4, 4, 512, **meta), [
            dict(w1=torch.empty(512, 128, **meta),
                 b1=torch.empty(128, **meta),
                 w2=torch.empty(9, 128, 128, **meta),
                 b2=torch.empty(128, **meta),
                 w3=torch.empty(128, 512, **meta),
                 b3=torch.empty(512, **meta))]),
        lambda: dcn.dcn_conv_train(x64, c, c, c, w64),
        lambda: dcn.dcn_conv_backward(x64, c, c, c, w64, x64),
        lambda: attention.SparseMaskedAttentionFn.apply(
            torch.empty(5, 32, **meta), torch.empty(7, 32, **meta),
            torch.empty(7, 32, **meta),
            torch.empty(5, 7, dtype=torch.bool, **meta), 4),
        lambda: attention.masked_attention_sparse_backward(
            *(torch.empty(n, 32, **meta) for n in (5, 7, 7)),
            torch.empty(5, 7, dtype=torch.bool, **meta),
            torch.empty(5, 32, **meta), torch.empty(5, 4, **meta),
            torch.empty(5, 32, **meta), 4),
        # the RoIAlign kernels of the serving paths (B11, B12)
        lambda: roi_align.roi_align_slab(
            [x] * 4, torch.empty(1, 3, 4, **meta), (4, 8, 16, 32)),
        lambda: roi_align.roi_align_multilevel_train(
            [x] * 4, torch.empty(1, 3, 4, **meta), (4, 8, 16, 32), True),
        lambda: roi_align.roi_align_flat(
            [x] * 4, torch.empty(3, 4, **meta),
            torch.empty(3, dtype=torch.int32, **meta), (4, 8, 16, 32)),
    ]
    for call in calls:
        with pytest.raises((ValueError, KeyError)):
            call()
