"""The JAX package's kernel-routing switches in the port, on the CPU.

Under JAX_PLATFORMS=cpu the switches change nothing in the JAX package
(its Pallas routes are off there), so the functions of the kernels they
route to are held against the Pallas kernels in interpret mode, as
`tests/test_pallas_*.py` run them, and against the package's XLA modules:

  * the switch parsing (`routes.from_env`), the model reading it once
    when built, and the stage-routing predicate (`nn.resnet.fuses_tail`)
    at MV2D-T's, a DCN-free R50's and the tiny config's sizes;
  * B10's plain version `ops.stage.fused_identity_chain_plain` against the
    JAX `Bottleneck` chain (1e-4 of the max magnitude) and against
    `pallas_stage.fused_identity_chain(interpret=True)` (5e-2 of the max:
    the Pallas kernel rounds its products to bf16);
  * B13's plain version, autograd of `ops.dcn.dcn_conv_plain` (what
    `dcn_conv_train` runs on the CPU), against
    `pallas_dcn.dcn_modulated_conv_train(interpret=True)` with
    MV2D_DCN_TRAIN_FUSED=1 (values and all five gradients at that test's
    3e-2) and against the dense XLA reference (1e-4, no coordinate on a
    border);
  * the flash_sparse route's function (on the card: K4 and B8), whose
    plain version is autograd of `masked_attention_plain` (what
    `masked_attention_train` runs on the CPU), against
    `pallas_attention._flash_sparse(interpret=True)` (5e-3) and the XLA
    attention (1e-4), with an empty and a full row; the list of active
    key tiles that K4 and B8 walk against JAX's `_sparse_blocks`;
  * one tiny+DCN training step of the port with the dcn_train_fused and
    flash_sparse routes equal to the default route's step: every loss and
    gradient within 1e-5.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402
from flax import linen as nn                             # noqa: E402

from mv2d_tpu.nn.resnet import Bottleneck as JBottleneck  # noqa: E402
from mv2d_tpu.ops import attention as xla_attn           # noqa: E402
from mv2d_tpu.ops.dcn import _dense_bilinear             # noqa: E402
from mv2d_tpu.ops.pallas_attention import (_flash_sparse,  # noqa: E402
                                            _sparse_blocks)
from mv2d_tpu.ops.pallas_dcn import dcn_modulated_conv_train  # noqa: E402
from mv2d_tpu.ops.pallas_stage import fused_identity_chain as j_chain  # noqa
from mv2d_tpu_torch import configs, routes               # noqa: E402
from mv2d_tpu_torch.routes import Routes                 # noqa: E402
from mv2d_tpu_torch.models.mv2d import MV2D              # noqa: E402
from mv2d_tpu_torch.nn import resnet                     # noqa: E402
from mv2d_tpu_torch.ops import attention, dcn, stage     # noqa: E402
from mv2d_tpu_torch.synthetic import (init_random_weights,  # noqa: E402
                                      synthetic_train_batch)
from mv2d_tpu_torch.parallel.dist import dp_objective   # noqa: E402
from mv2d_tpu_torch.train.train_step import draw_train   # noqa: E402

REL = 1e-4
SWITCHES = ('MV2D_FUSED_STAGES', 'MV2D_DCN_TRAIN_FUSED', 'MV2D_FLASH_SPARSE',
            'MV2D_ALIGN_V2')


@pytest.fixture(autouse=True)
def _one_thread_no_switches(monkeypatch):
    torch.set_num_threads(1)
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


# ------------------------------------------------------------ switches

@pytest.mark.parametrize('var,value,want', [
    ('MV2D_FUSED_STAGES', None, '1'), ('MV2D_FUSED_STAGES', '1', '1'),
    ('MV2D_FUSED_STAGES', 'all', 'all'),
    ('MV2D_FUSED_STAGES', '0', ValueError),
    ('MV2D_DCN_TRAIN_FUSED', None, False),
    ('MV2D_DCN_TRAIN_FUSED', '0', False),
    ('MV2D_DCN_TRAIN_FUSED', '1', True),
    ('MV2D_FLASH_SPARSE', None, False), ('MV2D_FLASH_SPARSE', '1', True),
    ('MV2D_FLASH_SPARSE', '0', False),
    ('MV2D_FLASH_SPARSE', 'mixed', False)])
def test_switch_values(monkeypatch, var, value, want):
    """The JAX names and defaults; JAX's MV2D_FUSED_STAGES=0 (layer1 off
    its kernel) raises, since the port keeps K1 on every CUDA path."""
    if value is not None:
        monkeypatch.setenv(var, value)
    field = {'MV2D_FUSED_STAGES': 'fused_stages',
             'MV2D_DCN_TRAIN_FUSED': 'dcn_train_fused',
             'MV2D_FLASH_SPARSE': 'flash_sparse'}[var]
    if want is ValueError:
        with pytest.raises(ValueError):
            routes.from_env()
    else:
        assert getattr(routes.from_env(), field) == want


def test_bad_flash_sparse_value_raises(monkeypatch):
    """An unknown MV2D_FLASH_SPARSE raises, as JAX's dict lookup does, and
    so does building a model, which reads it."""
    monkeypatch.setenv('MV2D_FLASH_SPARSE', 'yes')
    with pytest.raises(ValueError):
        routes.from_env()
    with pytest.raises(ValueError):
        MV2D(configs.tiny())


def test_model_reads_switches_once_when_built(monkeypatch):
    """MV2D(cfg) takes its routes from the switches when it is built and
    hands them to the backbone, the DCN convs, the decoder layers and the
    2D detector; a switch set later changes nothing in it."""
    cfg = configs.tiny(stage_with_dcn=(False, False, True, True),
                       use_flash_attention=True)
    monkeypatch.setenv('MV2D_FUSED_STAGES', 'all')
    monkeypatch.setenv('MV2D_DCN_TRAIN_FUSED', '1')
    monkeypatch.setenv('MV2D_FLASH_SPARSE', '1')
    monkeypatch.setenv('MV2D_ALIGN_V2', '1')
    m = MV2D(cfg)
    for k in SWITCHES:
        monkeypatch.delenv(k)
    want = Routes('all', True, True, True)
    assert m.routes == want and MV2D(cfg, want).routes == want
    assert MV2D(cfg).routes == Routes()
    assert m.base_detector.backbone.fused_stages == 'all'
    convs = [mod for mod in m.modules()
             if isinstance(mod, dcn.ModulatedDeformConv)]
    layers = m.roi_head.bbox_head.transformer.decoder.layers
    assert len(convs) == 2 and all(c.fused_train for c in convs)
    assert all(layer.flash_sparse for layer in layers)
    assert m.base_detector.align_v2


# ---------------------------------------------------- routing predicate

def tail_fused_stages(cfg, mode='all'):
    """Stages whose identity tail `fuses_tail` routes to B10 for cfg's
    image size: layer s (s >= 1) sees the map of layer s - 1's output
    (stride 4 after the stem and pool, then halved per stage)."""
    h, w = cfg.image_size
    h, w = math.ceil(math.ceil(h / 2) / 2), math.ceil(math.ceil(w / 2) / 2)
    fused = []
    for s, n in enumerate(resnet.STAGE_BLOCKS[cfg.depth]):
        if resnet.fuses_tail(s, n, h, w, cfg.stage_with_dcn[s], mode):
            fused.append(s)
        if s > 0:
            h, w = math.ceil(h / 2), math.ceil(w / 2)
    return fused


def test_fuses_tail_predicate():
    mv2d_t = configs.mv2d_t_r50()
    assert tail_fused_stages(mv2d_t) == [1]               # layer2 only
    no_dcn = mv2d_t._replace(stage_with_dcn=(False,) * 4)
    assert tail_fused_stages(no_dcn) == [1, 2]            # layers 2-3
    assert tail_fused_stages(configs.tiny()) == []
    assert tail_fused_stages(configs.tiny(
        stage_with_dcn=(False, False, True, True))) == []
    assert tail_fused_stages(no_dcn, '1') == []


def test_resnet_routes_tail_only_without_grad(monkeypatch):
    """With fused_stages='all', layer2's tail goes through
    fused_identity_chain when no gradient is recorded, with the same
    result as the blocks; with gradients on (at the same size, where the
    predicate admits it) or on the default route it does not, and the
    tail's parameters get their gradients."""
    net = init_random_weights(resnet.ResNet(50), seed=1).eval()
    fused = init_random_weights(
        resnet.ResNet(50, routes=Routes(fused_stages='all')), seed=1).eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 256, 192, 3)).astype(np.float32))
    calls = []

    def spy(x_, blocks):
        calls.append(len(blocks))
        return stage.fused_identity_chain(x_, blocks)
    monkeypatch.setattr(resnet, 'fused_identity_chain', spy)
    with torch.no_grad():
        want = net(x)
        assert calls == []
        got = fused(x)
    assert calls == [3]                 # 256x192: layer2 (64x48) only
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w.numpy()) < REL
    with torch.enable_grad():           # gradients on: the blocks
        sum(o.sum() for o in fused(x)).backward()
    assert calls == [3]
    for blk in fused.layer2[1:]:
        assert blk.conv1.weight.grad.abs().max() > 0


# ---------------------------------------------------------------- B10

class _Chain(nn.Module):
    n: int = 3

    @nn.compact
    def __call__(self, x):
        for i in range(self.n):
            x = JBottleneck(32, stride=1, downsample=False,
                            name=f'layer2_{i + 1}')(x)
        return x


def test_identity_chain_plain_matches_jax():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 32, 48, 128)), jnp.float32)
    m = _Chain()
    variables = m.init(jax.random.PRNGKey(0), x)
    constants = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype),
        variables['constants'])
    variables = {'params': variables['params'], 'constants': constants}
    ref = np.asarray(m.apply(variables, x))

    def fold(p, c, conv, bn):
        s = p[bn]['scale'] / jnp.sqrt(c[bn]['var'] + 1e-5)
        return p[conv]['kernel'] * s, p[bn]['bias'] - c[bn]['mean'] * s

    jblocks, tblocks = [], []
    for i in range(3):
        p = variables['params'][f'layer2_{i + 1}']
        c = variables['constants'][f'layer2_{i + 1}']
        (k1, b1), (k2, b2), (k3, b3) = (fold(p, c, f'conv{j}', f'bn{j}')
                                        for j in (1, 2, 3))
        jblocks.append(dict(w1=k1[0, 0], b1=b1, w2=k2, b2=b2, w3=k3[0, 0],
                            b3=b3))
        tblocks.append({k: torch.from_numpy(np.array(v)) for k, v in
                        dict(w1=k1[0, 0], b1=b1, w2=k2.reshape(9, 32, 32),
                             b2=b2, w3=k3[0, 0], b3=b3).items()})
    got = stage.fused_identity_chain(torch.from_numpy(np.asarray(x)),
                                     tblocks).numpy()
    assert rel_err(got, ref) < REL
    pallas = np.asarray(j_chain(x, jblocks, 32, interpret=True),
                        np.float32)
    assert np.abs(got - pallas).max() < 0.05 * np.abs(pallas).max()


# ---------------------------------------------------------------- B13

def dcn_case(rng, stride):
    V, H, W, C, F = 2, 16, 24, 8, 16
    Ho, Wo = H // stride, W // stride
    x = rng.normal(size=(V, H, W, C)).astype(np.float32)
    ky, kx = np.meshgrid(np.arange(3), np.arange(3), indexing='ij')
    by = (np.arange(Ho) * stride - 1)[:, None, None] + ky.reshape(-1)
    bx = (np.arange(Wo) * stride - 1)[None, :, None] + kx.reshape(-1)
    off = rng.normal(0, 2.0, (V, Ho, Wo, 9, 2))
    off[0, 3, 4, 2] = (25.0, -9.5)       # far outside the band and the map
    sy = (by[None] + off[..., 0]).astype(np.float32)
    sx = (bx[None] + off[..., 1]).astype(np.float32)
    m = rng.uniform(0.2, 1.0, (V, Ho, Wo, 9)).astype(np.float32)
    w = rng.normal(size=(9, C, F)).astype(np.float32)
    cot = rng.normal(size=(V, Ho, Wo, F)).astype(np.float32)
    return (x, sy, sx, m, w), cot


@pytest.mark.parametrize('stride', [1, 2])
def test_dcn_conv_train_plain_matches_jax(stride, monkeypatch):
    rng = np.random.default_rng(10 + stride)
    args, cot = dcn_case(rng, stride)
    x, sy, sx, m, w = args
    V, Ho, Wo, _ = sy.shape
    C = x.shape[-1]
    monkeypatch.setenv('MV2D_DCN_TRAIN_FUSED', '1')

    def fused(*a):
        return dcn_modulated_conv_train(*a, stride=stride, interpret=True)

    def dense(x_, sy_, sx_, m_, w_):
        s = _dense_bilinear(x_, sx_.reshape(V, -1), sy_.reshape(V, -1))
        s = s.reshape(V, Ho, Wo, 9, C) * m_[..., None]
        return jnp.einsum('vhwkc,kcf->vhwf', s, w_)

    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    got = dcn.dcn_conv_train(*leaves)
    got.backward(torch.from_numpy(cot))
    tgrads = [t.grad.numpy() for t in leaves]
    for fn, tol in ((fused, None), (dense, REL)):
        want, vjp = jax.vjp(fn, *map(jnp.asarray, args))
        wgrads = vjp(jnp.asarray(cot))
        for g, wv, nm in zip([got.detach().numpy(), *tgrads],
                             [want, *wgrads], 'y x sy sx m w'.split()):
            if tol is None:         # the Pallas kernel's own test tolerance
                np.testing.assert_allclose(g, np.asarray(wv), rtol=3e-2,
                                           atol=3e-2, err_msg=nm)
            else:
                assert rel_err(g, wv) < tol, nm
    on_border = np.isin(sy, (0.0, x.shape[1] - 1.0)) | \
        np.isin(sx, (0.0, x.shape[2] - 1.0))
    assert not on_border.any()


# ------------------------------------------- the flash_sparse route

def test_attention_train_plain_matches_jax_sparse():
    rng = np.random.default_rng(4)
    Q, K, C, H = 32, 256, 64, 4
    q, k, v = (rng.normal(size=(n, C)).astype(np.float32) for n in (Q, K, K))
    allowed = rng.uniform(size=(Q, K)) > 0.8
    allowed[0] = False                           # a row with no key
    allowed[1] = True                            # a row with every key
    cot = rng.normal(size=(Q, C)).astype(np.float32)

    def sparse(q_, k_, v_):
        return _flash_sparse(q_, k_, v_, jnp.asarray(allowed), H, 16, 64,
                             True)

    def xla(q_, k_, v_):
        return xla_attn.multi_head_attention(
            q_[None], k_[None], v_[None], H, jnp.asarray(allowed)[None])[0]

    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = attention.masked_attention_train(
        *leaves, torch.from_numpy(allowed), H, sparse=True)
    got.backward(torch.from_numpy(cot))
    tgrads = [t.grad.numpy() for t in leaves]
    for fn, tol in ((sparse, None), (xla, REL)):
        want, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
        wgrads = vjp(jnp.asarray(cot))
        for g, wv, nm in zip([got.detach().numpy(), *tgrads],
                             [want, *wgrads], 'out q k v'.split()):
            if tol is None:         # the Pallas kernel's own test tolerance
                np.testing.assert_allclose(g, np.asarray(wv), rtol=5e-3,
                                           atol=5e-3, err_msg=nm)
            else:
                assert rel_err(g, wv) < tol, nm
    assert np.all(got.detach().numpy()[0] == 0) and np.all(tgrads[0][0] == 0)


@pytest.mark.parametrize('Q,K', [(100, 300), (128, 256), (40, 50)])
def test_sparse_key_tiles_match_jax_blocks(Q, K):
    """The CSR list of active key tiles (`mask_tiles`' key-tile list,
    built with no host sync) holds the tiles of JAX's `_sparse_blocks`,
    in its order, per query tile; ragged tiles, an empty row, an empty
    query tile and a full row."""
    rng = np.random.default_rng(Q + K)
    allowed = rng.uniform(size=(Q, K)) > 0.97
    allowed[0] = False
    allowed[1] = True
    allowed[64:min(Q, 128)] = False
    T = attention.SPARSE_TILE
    Qp, Kp = -(-Q // T) * T, -(-K // T) * T
    padded = np.zeros((Qp, Kp), np.int32)
    padded[:Q, :K] = allowed
    counts, idx = _sparse_blocks(jnp.asarray(padded),
                                 (Q, K, 1, 8, T, Qp, Kp), T)
    counts, idx = np.asarray(counts), np.asarray(idx).reshape(Qp // T, -1)
    starts, tiles = (t.numpy() for t in
                     attention.mask_tiles(torch.from_numpy(allowed))[1:3])
    assert starts[0] == 0 and np.array_equal(np.diff(starts), counts)
    for i, n in enumerate(counts):
        assert np.array_equal(tiles[starts[i]:starts[i + 1]], idx[i, :n])


# ------------------------------------------------- the routed tiny step

def test_routed_train_step_equals_default(monkeypatch):
    """One tiny+DCN step (float32, dropout 0) with the dcn_train_fused and
    flash_sparse routes against the default route's step on the CPU:
    same weights, scene and draws; every loss and every gradient within
    1e-5 of its max magnitude (floored at 1e-5 of the largest gradient);
    the DCN convs go through dcn_conv_train."""
    cfg = configs.tiny(stage_with_dcn=(False, False, True, True),
                       num_frames=2, dropout=0.0, use_flash_attention=True)
    batch = synthetic_train_batch(cfg, seed=0, device='cpu')
    draws = draw_train(cfg, batch.gt2d.boxes.shape[1],
                       torch.Generator().manual_seed(1))
    conv_calls = []

    def spy(*a):
        conv_calls.append(a[0].shape)
        return dcn.dcn_conv_plain(*a)
    monkeypatch.setattr(dcn, 'dcn_conv_train', spy)
    runs = []
    for route in (Routes(), Routes(dcn_train_fused=True, flash_sparse=True)):
        m = init_random_weights(MV2D(cfg, route), seed=3)
        local, metrics = dp_objective(m, [batch], [draws],
                                      mixed_precision=False)
        local.backward()
        runs.append(({k: float(val) for k, val in metrics.items()},
                     {n: p.grad.detach() for n, p in m.named_parameters()
                      if p.grad is not None}))
    assert len(conv_calls) == 2           # one DCN block each in stages 3-4
    (m0, g0), (m1, g1) = runs
    assert m0.keys() == m1.keys() and g0.keys() == g1.keys()
    for k in m0:
        assert abs(m1[k] - m0[k]) <= 1e-5 * max(abs(m0[k]), 1e-6), k
    floor = 1e-5 * max(g.abs().max().item() for g in g0.values())
    for n in g0:
        err = (g1[n] - g0[n]).abs().max().item()
        assert err <= 1e-5 * max(g0[n].abs().max().item(), floor), n
