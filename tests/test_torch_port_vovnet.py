"""The VoVNet backbone of the port against the JAX package on the CPU,
float32, numpy-seeded inputs and weights:

  * VoVNet-19's four stage outputs within 1e-4 of their max magnitude;
  * the VoVNetCP key table: a JAX tree of `tiny(backbone_type='vovnet',
    depth=19)` carried by `state_dict_from_jax` loads strictly into the
    port's model under the reference's names and comes back exactly
    through the JAX package's `convert_torch_state_dict`;
  * the eval forward of that config: valid slots, labels and scores as
    in `test_torch_port_slice.py`; each box within 2e-3 of the JAX box of
    the same label and score (two queries whose scores tie within
    float32 rounding may take each other's slots);
  * VoVNet-99's names and shapes against the JAX tree's, and the full
    width `mv2d_t_v99` model built;
  * one training step: the backbone parameters that move are exactly
    the ones the JAX optimizer does not freeze (its rule: 'stem' or
    '/bn' in the path), at the backbone learning rate.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu.nn import vovnet as jvovnet                # noqa: E402
from mv2d_tpu.train import optim as joptim               # noqa: E402
from mv2d_tpu.train.checkpoint import convert_torch_state_dict  # noqa
from mv2d_tpu_torch import configs as tcfgs              # noqa: E402
from mv2d_tpu_torch.models.mv2d import MV2D as TMV2D     # noqa: E402
from mv2d_tpu_torch.nn.vovnet import VoVNet              # noqa: E402
from mv2d_tpu_torch.parallel.dist import dp_train_step   # noqa: E402
from mv2d_tpu_torch.synthetic import synthetic_train_batch  # noqa: E402
from mv2d_tpu_torch.train.optim import make_optimizer    # noqa: E402
from mv2d_tpu_torch.weights import state_dict_from_jax, torch_key  # noqa
from tests.test_torch_port_slice import build, materialize  # noqa: E402

V19 = dict(backbone_type='vovnet', depth=19)


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def test_vovnet19_stages_match_jax():
    torch.set_num_threads(1)
    x = np.random.default_rng(0).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    jnet = jvovnet.VoVNet(depth=19)
    var = materialize(jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                                     jnp.asarray(x)), 2)
    want = jax.jit(jnet.apply)(var, jnp.asarray(x))
    sd = state_dict_from_jax(
        {'base_detector': {'backbone': var['params']}},
        {'base_detector': {'backbone': var['constants']}})
    net = VoVNet(19)
    pre = 'base_detector.backbone.'
    net.load_state_dict({k[len(pre):]: torch.from_numpy(v)
                         for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert [g.shape[-1] for g in got] == list(net.out_channels) \
        == [256, 512, 768, 1024]
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) < 1e-4


def test_vovnet99_names_and_shapes_match_jax():
    """VoVNet-99's state dict (1 / 3 / 9 / 3 blocks, identity blocks in
    stages 3-5) is the JAX tree's, leaf for leaf, under the VoVNetCP
    names, and `mv2d_t_v99` builds at full width with the FPN taking the
    backbone's widths."""
    struct = jax.eval_shape(jvovnet.VoVNet(depth=99).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    want = {}
    for coll in ('params', 'constants'):
        for path, leaf in jax.tree_util.tree_leaves_with_path(struct[coll]):
            p = '/'.join(str(getattr(k, 'key', k)) for k in path)
            key, fn = torch_key(f'base_detector/backbone/{p}', {},
                                np.zeros(leaf.shape, np.float32))
            want[key] = fn(np.zeros(leaf.shape, np.float32)).shape
    model = TMV2D(tcfgs.mv2d_t_v99())
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if k.startswith('base_detector.backbone.')
           and not k.endswith('num_batches_tracked')}
    assert got == want
    assert 'base_detector.backbone.stage4.OSA4_9.ese.fc.weight' in got
    assert model.base_detector.neck.lateral_convs[3].conv.in_channels \
        == 1024


@pytest.fixture(scope='module')
def built():
    torch.set_num_threads(1)
    return build(**V19)


def test_vovnet_key_table_round_trip(built):
    sd = built['sd']
    for key in ('base_detector.backbone.stem.stem_1/conv.weight',
                'base_detector.backbone.stem.stem_3/norm.running_var',
                'base_detector.backbone.stage2.OSA2_1.layers.0.'
                'OSA2_1_0/conv.weight',
                'base_detector.backbone.stage5.OSA5_1.concat.'
                'OSA5_1_concat/norm.bias',
                'base_detector.backbone.stage4.OSA4_1.ese.fc.bias'):
        assert key in sd, key
    assert set(sd) == set(built['tm'].state_dict())
    params, constants = convert_torch_state_dict(sd)
    assert params.pop('_unmatched') == 0, params['_unmatched_keys']
    params.pop('_unmatched_keys')
    want = {'params': built['variables']['params'],
            'constants': built['variables']['constants']}
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(
        {'params': params, 'constants': constants}))
    extra = set(flat_g) - {p for p, _ in flat_w}
    assert all(p[-1].key == 'num_batches_tracked' for p in extra), extra
    for path, w in flat_w:
        assert np.array_equal(np.asarray(flat_g[path]), np.asarray(w)), path


def test_vovnet_forward_matches_jax(built):
    b = built
    jout = jax.jit(b['jm'].apply)(b['variables'], jnp.asarray(b['imgs']),
                                  b['jcam'], jnp.asarray(b['shapes']))
    jboxes, jscores, jlabels, jvalid = (np.asarray(x) for x in jout)
    with torch.no_grad():
        t = b['tm'](torch.from_numpy(b['imgs']), b['tcam'],
                    torch.from_numpy(b['shapes']))
    assert np.array_equal(t.valid.numpy(), jvalid) and jvalid.sum() > 0
    v = jvalid
    assert np.abs(t.scores.numpy()[v] - jscores[v]).max() < 1e-4
    assert np.array_equal(t.labels.numpy()[v], jlabels[v])
    boxes = t.boxes.numpy()
    for i in np.flatnonzero(v):
        same = v & (jlabels == jlabels[i]) & \
            (np.abs(jscores - jscores[i]) < 1e-4)
        err = np.abs(jboxes[same] - boxes[i]).max(-1).min()
        assert err < 2e-3, (i, err)


def test_vovnet_frozen_leaves_match_jax_optimizer(built):
    """One step of the tiny VoVNet-19 model: the backbone names that move
    are those the JAX optimizer labels 'backbone' (the stem's and every
    BN's leaves are 'frozen' and have no gradient in the port), and they
    train at the backbone lr."""
    labels = joptim._label_params(built['variables']['params'])
    flat = jax.tree_util.tree_leaves_with_path(labels)
    want = {}
    for path, lab in flat:
        p = '/'.join(str(getattr(k, 'key', k)) for k in path)
        if p.startswith('base_detector/backbone/'):
            want[torch_key(p, {}, np.zeros(1))[0]] = lab
    assert set(want.values()) == {'frozen', 'backbone'}
    torch.manual_seed(0)
    cfg = tcfgs.tiny(dropout=0.0, **V19)
    model = TMV2D(cfg)
    model.load_state_dict(built['tm'].state_dict(), strict=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(model, total_steps=10)
    dp_train_step(model, opt, [synthetic_train_batch(cfg, 0, 'cpu')],
                  [torch.Generator().manual_seed(0)], mixed_precision=False)
    backbone_group = {id(p) for p in opt.param_groups[1]['params']}
    got = {}
    for n, p in model.named_parameters():
        if n.startswith('base_detector.backbone.'):
            moved = not torch.equal(p.detach(), before[n])
            assert moved == p.requires_grad, n
            assert (id(p) in backbone_group) == p.requires_grad, n
            got[n] = 'backbone' if moved else 'frozen'
    assert got == want
