"""B13's composition (ops/dcn), in its plain PyTorch form, at toy shapes.

Kernel B13, the backward of the fused training DCN conv
(MV2D_DCN_TRAIN_FUSED=1), forms the sample gradients ds = dy w^T on the
tensor cores into a workspace in x's dtype, turns them into dx, dsy, dsx
and dm by B6's owners' walk, and forms dw = samples^T dy from the samples
recomputed and rounded as the forward (K2) rounds them.
`dcn_conv_backward_plain` composes the same steps in plain PyTorch, and
`dcn_conv_backward` on CPU tensors runs it.  Checked here, on seeded numpy
inputs (V=2, 16x24, C=8, F=16, strides 1 and 2, one sample far outside the
map):

  * the mirror equals autograd of `dcn_conv_plain` (float32, 1e-5 of each
    output's max magnitude: the two differ only in the order of float32
    sums);
  * it matches the VJP of the JAX package's fused training conv,
    `pallas_dcn.dcn_modulated_conv_train(interpret=True)` with
    MV2D_DCN_TRAIN_FUSED=1 (the Pallas backward kernel in interpret mode),
    at 3e-2 (rtol and atol), the tolerance the routes test holds the
    port's plain version to there;
  * the wrapper on CPU tensors is the mirror, and it returns dx in x's
    dtype and dw in w's.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax.numpy as jnp                                  # noqa: E402
import jax                                               # noqa: E402

from mv2d_tpu.ops.pallas_dcn import dcn_modulated_conv_train  # noqa: E402
from mv2d_tpu_torch.ops import dcn                       # noqa: E402

REL = 1e-5
NAMES = ('x', 'sy', 'sx', 'm', 'w')


def case(stride, seed):
    """(x, sy, sx, m, w), dy as float32 numpy arrays: sample coordinates
    around the 3x3 stride grid with N(0, 2) offsets, one sample far
    outside the map."""
    rng = np.random.default_rng(seed)
    V, H, W, C, F = 2, 16, 24, 8, 16
    Ho, Wo = H // stride, W // stride
    x = rng.normal(size=(V, H, W, C)).astype(np.float32)
    ky, kx = np.meshgrid(np.arange(3), np.arange(3), indexing='ij')
    by = (np.arange(Ho) * stride - 1)[:, None, None] + ky.reshape(-1)
    bx = (np.arange(Wo) * stride - 1)[None, :, None] + kx.reshape(-1)
    off = rng.normal(0, 2.0, (V, Ho, Wo, 9, 2))
    off[1, 2, 5, 7] = (-30.0, 41.5)      # far outside the map
    sy = (by[None] + off[..., 0]).astype(np.float32)
    sx = (bx[None] + off[..., 1]).astype(np.float32)
    m = rng.uniform(0.2, 1.0, (V, Ho, Wo, 9)).astype(np.float32)
    w = rng.normal(size=(9, C, F)).astype(np.float32)
    dy = rng.normal(size=(V, Ho, Wo, F)).astype(np.float32)
    return (x, sy, sx, m, w), dy


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize('stride', [1, 2])
def test_mirror_equals_autograd_of_plain_conv(stride):
    args, dy = case(stride, 20 + stride)
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = dcn.dcn_conv_plain(*leaves)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(dy))
    got = dcn.dcn_conv_backward_plain(*map(torch.from_numpy, args),
                                      torch.from_numpy(dy))
    for g, wv, nm in zip(got, want, NAMES):
        assert g.shape == wv.shape, nm
        assert rel_err(g.numpy(), wv.numpy()) < REL, nm


@pytest.mark.parametrize('stride', [1, 2])
def test_mirror_matches_pallas_fused_train_vjp(stride, monkeypatch):
    args, dy = case(stride, 30 + stride)
    monkeypatch.setenv('MV2D_DCN_TRAIN_FUSED', '1')

    def fused(*a):
        return dcn_modulated_conv_train(*a, stride=stride, interpret=True)

    _, vjp = jax.vjp(fused, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dy))
    got = dcn.dcn_conv_backward_plain(*map(torch.from_numpy, args),
                                      torch.from_numpy(dy))
    for g, wv, nm in zip(got, want, NAMES):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=3e-2,
                                   atol=3e-2, err_msg=nm)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_runs_the_mirror(dtype):
    args, dy = case(1, 40)
    t = [torch.from_numpy(a) for a in args]
    x, w, g = t[0].to(dtype), t[4].to(dtype), torch.from_numpy(dy).to(dtype)
    before = dcn.dcn_conv_backward.launches
    got = dcn.dcn_conv_backward(x, t[1], t[2], t[3], w, g)
    want = dcn.dcn_conv_backward_plain(x, t[1], t[2], t[3], w, g)
    assert dcn.dcn_conv_backward.launches == before      # no kernel on CPU
    assert got[0].dtype == dtype and got[4].dtype == dtype
    assert all(a.dtype == torch.float32 for a in got[1:4])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
