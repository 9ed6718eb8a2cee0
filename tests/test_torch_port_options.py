"""Model options of the JAX package that the port honours, held against
the JAX package on the CPU (float32; numpy-seeded weights carried by
`state_dict_from_jax`; the JAX side runs its XLA paths):

  * the correlation's 'all_matched' mode (the full [R, 1 + R] table) and
    uniform depth bins (lid=False): `epipolar_in_box`'s id / mask tables
    equal; the tiny eval forward in the pixel and roi key modes (valid
    slots and labels equal, scores within 1e-4, boxes within 2e-3, the
    tolerances of `test_torch_port_slice.py`); the roi head with DN
    (every layer's outputs within 1e-4 of their max magnitude); one roi
    key mode training step (each query's keys from all 1 + R RoIs) with
    frozen_stages=2 over DCN stages 3-4, remat, remat_decoder and dropout
    0.1: every loss within 1e-4 relative, every trainable gradient within
    1e-3 of its max magnitude (floored at 1e-5 of the step's largest;
    `test_torch_port_train.py`'s tolerances), JAX's flax Dropout applying
    the port's masks; the port's step bit-equal to the same step without
    remat (one thread: the CPU's convolutions sum in one order);
  * PE(lid=False), the query generator with every branch (its aux
    outputs too) and class-agnostic, the class-agnostic R-CNN head,
    ResNet / VoVNet out_indices: outputs within 1e-4 of max;
  * frozen_stages -1, 0, 2, 3 (with remat on and off) on a ResNet-10 with
    DCN in stages 3-4: outputs within 1e-4 of max, every gradient the
    port computes within 1e-4 of max of JAX's, JAX's exactly zero on the
    stages the port freezes beyond stem and layer1; the optimizer's one
    known difference pinned (JAX's AdamW decays a stopped stage's
    weights, the port leaves them out of the optimizer);
  * the decoder's remat with dropout: the generator moves on as without
    remat, and the backward's recompute does not move it;
  * the weight bridge for the new parameters: the branch stacks and
    heads and the 4-wide fc_reg.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu import configs as jcfgs                    # noqa: E402
from mv2d_tpu.core.geometry import prepare_camera_params as j_cam  # noqa
from mv2d_tpu.models import correlation as jcorr         # noqa: E402
from mv2d_tpu.models import mv2d as jmv2d                # noqa: E402
from mv2d_tpu.nn.pe import PE as JPE                     # noqa: E402
from mv2d_tpu.nn.query_generator import QueryGenerator as JQG  # noqa: E402
from mv2d_tpu.nn.rcnn import Shared2FCBBoxHead as JRCNN  # noqa: E402
from mv2d_tpu.nn.resnet import ResNet as JResNet         # noqa: E402
from mv2d_tpu.nn.vovnet import VoVNet as JVoVNet         # noqa: E402
from mv2d_tpu.train import optim as joptim               # noqa: E402
from mv2d_tpu.train.checkpoint import convert_torch_state_dict  # noqa: E402
from mv2d_tpu_torch import configs as tcfgs              # noqa: E402
from mv2d_tpu_torch.core.geometry import prepare_camera_params as t_cam  # noqa
from mv2d_tpu_torch.models import correlation as tcorr   # noqa: E402
from mv2d_tpu_torch.models.detector2d import Proposals   # noqa: E402
from mv2d_tpu_torch.models.mv2d import MV2D as TMV2D     # noqa: E402
from mv2d_tpu_torch.nn.pe import PE                      # noqa: E402
from mv2d_tpu_torch.nn.query_generator import QueryGenerator  # noqa: E402
from mv2d_tpu_torch.nn.rcnn import Shared2FCBBoxHead     # noqa: E402
from mv2d_tpu_torch.nn.resnet import ResNet              # noqa: E402
from mv2d_tpu_torch.nn.vovnet import VoVNet              # noqa: E402
from mv2d_tpu_torch.synthetic import camera_rig, synthetic_train_batch  # noqa
from mv2d_tpu_torch.train.optim import make_optimizer    # noqa: E402
from mv2d_tpu_torch.weights import state_dict_from_jax, torch_key  # noqa
from tests.test_torch_port_slice import DCN, build, materialize  # noqa
from tests.test_torch_port_train import train_step_pair  # noqa: E402

REL = 1e-4
KEY = jax.random.PRNGKey(0)
# correlation fields of each case (over the tiny preset's)
CORR = {'all_matched': dict(mode='all_matched'),
        'uniform_depth': dict(lid=False),
        'all_matched_uniform_depth': dict(mode='all_matched', lid=False)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def bridged(prefix, jtree, jconst=None):
    """A JAX module's variables -> the port's state dict of the module
    that `prefix` names in the model (`state_dict_from_jax` on a model
    tree holding only it)."""
    top = prefix.split('/')

    def nest(tree):
        for k in reversed(top):
            tree = {k: tree}
        return tree
    sd = state_dict_from_jax(nest(jtree), nest(jconst or {}))
    name = '.'.join({'pe': ['roi_head', 'position_encoding'],
                     'query_generator': ['roi_head', 'query_generator'],
                     'base_detector': ['base_detector']}[top[0]]
                    + {'bbox_head': ['roi_head', 'bbox_head'],
                       'backbone': ['backbone']}.get(top[-1], [])) + '.'
    return {k[len(name):]: t(v) for k, v in sd.items()}


# ------------------------------------------------------------ correlation

def _rig_boxes(rng, V, P, size):
    H, W = size
    xy = rng.uniform(0, 0.6, (V, P, 2)) * [W, H]
    wh = rng.uniform(0.1, 0.4, (V, P, 2)) * [W, H]
    return (np.concatenate([xy, xy + wh], -1).astype(np.float32),
            rng.random((V, P)) < 0.85)


@pytest.mark.parametrize('case', list(CORR))
def test_epipolar_tables_match_jax(case):
    """Two cameras over two frames (views v and v + 2 share a pose), six
    boxes a view: the id and mask tables equal JAX's everywhere; under
    'all_matched' the table is [R, 1 + R] and some RoI correlates with
    more boxes of one view than topk (2) would keep."""
    rng = np.random.default_rng(7)
    size, P = (64, 96), 6
    K, E = camera_rig(2, size)
    K, E = np.concatenate([K, K]), np.concatenate([E, E])
    jcam, tcam = j_cam(K, E), t_cam(K, E, device='cpu')
    boxes, valid = _rig_boxes(rng, 4, P, size)
    cfg = tcfgs.CorrelationConfig(sample_size=2, num_depth=4, topk=2,
                                  **CORR[case])
    ids_j, mask_j = jax.jit(jcorr.epipolar_in_box, static_argnums=(3, 4))(
        jnp.asarray(boxes), jnp.asarray(valid), jcam.trans_mats, size,
        jcorr.CorrelationConfig(**cfg._asdict()))
    ids_t, mask_t = tcorr.epipolar_in_box(t(boxes), t(valid),
                                          tcam.trans_mats, size, cfg)
    assert np.array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert np.array_equal(mask_t.numpy(), np.asarray(mask_j))
    R = 4 * P
    if cfg.mode == 'all_matched':
        assert ids_t.shape == (R, 1 + R)
        per_view = mask_t[:, 1:].reshape(R, 4, P).sum(-1)
        assert int(per_view.max()) > cfg.topk
    else:
        assert ids_t.shape == (R, 1 + 4 * cfg.topk)
        assert bool(mask_t[:, 1:].any())


def test_mode_string_all_matched():
    """`from_mode_string('all_matched')` gives JAX's config, and the port
    builds and runs it (it no longer refuses a mode)."""
    want = jcorr.CorrelationConfig.from_mode_string('all_matched',
                                                    expand_stride=2.0)
    got = tcfgs.CorrelationConfig.from_mode_string('all_matched',
                                                   expand_stride=2.0)
    assert got._asdict() == want._asdict() and got.mode == 'all_matched'


# ------------------------------------------------------- tiny forwards

@pytest.fixture(scope='module')
def built():
    return build(k_max=40)


def _cfgs(b, key_mode, case):
    jc = b['jc']._replace(key_mode=key_mode, correlation=b[
        'jc'].correlation._replace(**CORR[case]))
    tc = b['tc']._replace(key_mode=key_mode, correlation=b[
        'tc'].correlation._replace(**CORR[case]))
    return jc, tc


@pytest.mark.parametrize('key_mode,case', [
    ('pixel', 'all_matched'), ('pixel', 'uniform_depth'),
    ('roi', 'all_matched_uniform_depth')])
def test_forward_matches_jax(built, key_mode, case):
    """The tiny+DCN two-view eval forward, its config's correlation and
    key mode replaced on both sides (the weights do not depend on
    them)."""
    b = built
    jc, tc = _cfgs(b, key_mode, case)
    jout = jax.jit(jmv2d.MV2D(jc).apply)(
        b['variables'], jnp.asarray(b['imgs']), b['jcam'],
        jnp.asarray(b['shapes']))
    jboxes, jscores, jlabels, jvalid = (np.asarray(x) for x in jout)
    tm = b['tm']
    tm.cfg = tc
    try:
        with torch.no_grad():
            out = tm(torch.from_numpy(b['imgs']), b['tcam'],
                     torch.from_numpy(b['shapes']))
    finally:
        tm.cfg = b['tc']
    v = jvalid
    assert np.array_equal(out.valid.numpy(), v) and v.sum() > 0
    assert np.abs(out.scores.numpy()[v] - jscores[v]).max() < 1e-4
    assert np.array_equal(out.labels.numpy()[v], jlabels[v])
    assert np.abs(out.boxes.numpy()[v] - jboxes[v]).max() < 2e-3


def test_roi_dn_head_all_matched_matches_jax(built):
    """roi_head_forward in the roi key mode with DN (the keys: every
    RoI's cells, shared; each query sees its correlated RoIs' cells)
    under 'all_matched', on the JAX model's p4, PE and proposals, the DN
    noise pinned."""
    b = built
    jc, tc = _cfgs(b, 'roi', 'all_matched')
    jm = jmv2d.MV2D(jc)
    imgs, shapes = jnp.asarray(b['imgs']), jnp.asarray(b['shapes'])

    def stem(m, x, cam, sh):
        fpn, p4 = m.extract_feats(x)
        props = m.base_detector.detect(fpn, jc.image_size, jc.proposal_test)
        return p4, m.pe(p4, cam.img2lidar, sh, jc.image_size), props
    p4, pos, props = jax.jit(lambda v, x, c, s: jm.apply(
        v, x, c, s, method=stem))(b['variables'], imgs, b['jcam'], shapes)
    gt = synthetic_train_batch(tc, seed=4, device='cpu').gt3d
    noise = np.random.default_rng(5).uniform(
        -1, 1, (tc.dn_pad, 3)).astype(np.float32)
    orig = jmv2d.MV2D._prepare_dn

    def pinned_dn(self, gt_, rng_):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, 'uniform',
                       lambda *a, **k: jnp.asarray(noise))
            return orig(self, gt_, rng_)

    def head(m, *a):
        return m.roi_head_forward(*a, dn_rng=KEY, deterministic=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmv2d.MV2D, '_prepare_dn', pinned_dn)
        jout = jax.jit(lambda *a: jm.apply(*a, method=head))(
            b['variables'], p4, pos, props, b['jcam'], shapes,
            jmv2d.GroundTruth3D(*(jnp.asarray(x.numpy()) for x in gt)))
    tprops = Proposals(*(t(x) for x in (props.boxes, props.scores,
                                        props.labels, props.valid)))
    tm = b['tm']
    tm.cfg = tc
    try:
        with torch.no_grad():
            tout = tm.roi_head_forward(
                t(p4), t(pos), tprops, b['tcam'], t(b['shapes']), gt=gt,
                dn_noise=t(noise))
    finally:
        tm.cfg = b['tc']
    assert tout.dn_cls_scores.shape[1] == tc.dn_pad
    for got, want in ((tout.all_cls_scores, jout.all_cls_scores),
                      (tout.all_bbox_preds, jout.all_bbox_preds),
                      (tout.dn_cls_scores, jout.dn_cls_scores),
                      (tout.dn_bbox_preds, jout.dn_bbox_preds)):
        want = np.asarray(want)
        for lvl in range(want.shape[0]):
            assert rel_err(got[lvl].numpy(), want[lvl]) < REL, lvl


# ----------------------------------------------------------- the steps

def check_step(p, frozen=()):
    """Every loss within 1e-4 relative, the discrete counts equal, every
    trainable gradient within 1e-3 of its max magnitude (floored at 1e-5
    of the step's largest); the parameters under `frozen` prefixes take
    no gradient in the port and exactly zero in JAX."""
    want = {k: float(v) for k, v in p['jmetrics'].items()}
    got = {k: float(v) for k, v in p['metrics'].items()}
    assert sorted(got) == sorted(want)
    for k in want:
        if 'loss' in k:
            assert abs(got[k] - want[k]) <= REL * max(abs(want[k]), 1e-6), \
                (k, got[k], want[k])
    for k in ('rpn_num_pos', 'rcnn_num_pos', 'num_queries', 'key_active',
              'key_overflow'):
        assert got.get(k) == want.get(k), (k, got.get(k), want.get(k))
    assert abs(p['total'] - p['jtotal']) <= REL * abs(p['jtotal'])
    floor = 1e-5 * max(np.abs(g).max() for g in p['jgrads'].values())
    n = 0
    for name, prm in p['model'].named_parameters():
        if any(name.startswith(f) for f in frozen):
            assert not prm.requires_grad and prm.grad is None, name
            assert not np.abs(p['jgrads'][name]).any(), name
            continue
        if not prm.requires_grad:
            continue
        want_g = p['jgrads'][name]
        scale = max(np.abs(want_g).max(), floor)
        err = np.abs(prm.grad.numpy() - want_g).max()
        assert err <= 1e-3 * scale, (name, err, scale)
        n += 1
    assert n > 100


def test_roi_all_matched_remat_step_matches_jax():
    """One roi key mode step without DN under 'all_matched' (each query's
    keys: the cells of all 1 + R RoIs, gathered with `gather_rows`'
    one-hot backward, [R * (1 + R), R] = [19740, 140] here), DCN in stages
    3-4 with frozen_stages=2 (layer2 runs without gradients), remat and
    remat_decoder, dropout 0.1: losses and trainable gradients within the
    step tolerances of JAX's (its flax Dropout applying the port's
    masks); the port's step equals the same step without remat bit for
    bit (the recompute draws the first run's masks); a dropout-free step
    differs (the masks took effect)."""
    corr = tcfgs.CorrelationConfig(sample_size=2, num_depth=4, topk=2,
                                   mode='all_matched')
    # the port's CorrelationConfig serves both packages' configs: JAX
    # reads its fields by name
    p = train_step_pair(key_mode='roi', use_denoise=False, correlation=corr,
                        frozen_stages=2, stage_with_dcn=DCN, remat=True,
                        remat_decoder=True, dropout=0.1)
    assert len(p['masks']) == 4 * jcfgs.tiny().num_decoder_layers
    check_step(p, frozen=('base_detector.backbone.layer2.',))
    assert 'key_active' not in p['metrics']
    total, metrics, model = p['port_step'](remat=False,
                                           remat_decoder=False)
    assert total == p['total']
    assert {k: float(v) for k, v in metrics.items()} == \
        {k: float(v) for k, v in p['metrics'].items()}
    grads = dict(model.named_parameters())
    for name, prm in p['model'].named_parameters():
        if prm.grad is None:
            assert grads[name].grad is None, name
            continue
        assert torch.equal(prm.grad, grads[name].grad), name
    total0, _, _ = p['port_step'](dropout=0.0)
    assert total0 != total


def test_remat_decoder_moves_the_generator_on():
    """After a rematerialized decoder pass the dropout generator is where
    the plain pass leaves it, and the recompute in the backward does not
    move it."""
    from mv2d_tpu_torch.nn.decoder import CrossAttentionBoxHead, Dropout
    torch.manual_seed(0)
    head = CrossAttentionBoxHead(embed_dims=32, num_layers=2, num_heads=4,
                                 feedforward_channels=64)
    g = torch.Generator().manual_seed(0)
    refs = torch.rand(6, 3, generator=g) * 0.8 + 0.1
    keys = torch.randn(10, 32, generator=g)
    self_allowed = torch.ones(6, 6, dtype=torch.bool)
    cross = torch.rand(6, 10, generator=g) < 0.5
    ends = {}
    for remat in (False, True):
        head.transformer.decoder.remat = remat
        gen = torch.Generator().manual_seed(3)
        cls, box = head(refs, keys, keys * 0.5, self_allowed, cross,
                        Dropout(0.1, gen))
        after_forward = gen.get_state()
        (cls.sum() + box.sum()).backward()
        assert torch.equal(gen.get_state(), after_forward)
        ends[remat] = (after_forward, cls.detach(), [
            prm.grad.clone() for prm in head.parameters()
            if prm.grad is not None])
        head.zero_grad(set_to_none=True)
    assert torch.equal(ends[False][0], ends[True][0])
    assert torch.equal(ends[False][1], ends[True][1])
    assert all(torch.equal(a, b) for a, b in zip(ends[False][2],
                                                 ends[True][2]))


# -------------------------------------------------------------- modules

def test_pe_uniform_depth_matches_jax():
    rng = np.random.default_rng(1)
    V, H, W, C = 2, 4, 6, 32
    feat = rng.normal(size=(V, H, W, C)).astype(np.float32)
    K, E = camera_rig(V, (64, 96))
    img2lidar = np.asarray(j_cam(K, E).img2lidar)
    shapes = np.asarray([[64, 96], [56, 80]])
    jpe = JPE(embed_dims=C, depth_num=8, lid=False, num_sine_feats=C // 2)
    var = materialize(jax.eval_shape(
        lambda *a: jpe.init(KEY, *a, (64, 96)), jnp.asarray(feat),
        jnp.asarray(img2lidar), jnp.asarray(shapes)), seed=2)
    want = jax.jit(lambda v, *a: jpe.apply(v, *a, (64, 96)))(
        var, jnp.asarray(feat), jnp.asarray(img2lidar), jnp.asarray(shapes))
    pe = PE(embed_dims=C, depth_num=8, lid=False, num_sine_feats=C // 2)
    pe.load_state_dict(bridged('pe', var['params']), strict=True)
    with torch.no_grad():
        got = pe(t(feat), t(img2lidar), t(shapes), (64, 96))
        lid = PE(embed_dims=C, depth_num=8, num_sine_feats=C // 2)
        lid.load_state_dict(pe.state_dict())
        other = lid(t(feat), t(img2lidar), t(shapes), (64, 96))
    assert rel_err(got.numpy(), want) < REL
    assert rel_err(other.numpy(), want) > 1e-3       # the bins differ


QG_KW = dict(in_channels=16, conv_out_channels=16, fc_out_channels=32,
             extra_channels=(16, 8))


def _qg_inputs(R=5, C=16):
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(R, 7, 7, C)).astype(np.float32)
    K = np.tile(np.eye(4, dtype=np.float32), (R, 1, 1))
    K[:, 0, 0] = K[:, 1, 1] = 100.0
    K[:, 0, 2], K[:, 1, 2] = 3.0, 4.0
    ext = np.tile(np.eye(4, dtype=np.float32), (R, 1, 1))
    ext[:, :3, 3] = rng.normal(size=(R, 3))
    ok = np.array([True, True, False, True, True])
    return feats, K, ext, ok


@pytest.mark.parametrize('kw', [
    dict(num_classes=10, with_cls=True, with_size=True, with_heading=True,
         with_attr=True, attr_dim=2, num_cls_fcs=1, num_size_fcs=2),
    dict(with_size=True, reg_class_agnostic=True, num_center_fcs=1,
         num_heading_fcs=1, with_heading=True)],
    ids=['every_branch', 'class_agnostic'])
def test_query_generator_branches_match_jax(kw):
    """The settings of `tests/test_nn.py`'s branch test (and a
    class-agnostic size head with centre and heading fc stacks): the
    reference points and every aux output; the JAX leaves carried into
    the branch stacks' names exactly."""
    feats, K, ext, ok = _qg_inputs()
    args = tuple(jnp.asarray(x) for x in (feats, K, ext, ok))
    jqg = JQG(**QG_KW, **kw)
    var = materialize(jax.eval_shape(jqg.init, KEY, *args), seed=4)
    ref_j, aux_j = jqg.apply(var, *args)
    qg = QueryGenerator(**QG_KW, **kw)
    sd = bridged('query_generator', var['params'])
    qg.load_state_dict(sd, strict=True)
    with torch.no_grad():
        ref_t, aux_t = qg(*(t(x) for x in (feats, K, ext, ok)))
    assert sorted(aux_t) == sorted(aux_j)
    assert rel_err(ref_t.numpy(), ref_j) < REL
    for k in aux_j:
        assert rel_err(aux_t[k].numpy(), aux_j[k]) < REL, k
    if kw.get('reg_class_agnostic'):
        assert aux_t['size_pred'].shape == (5, 3)
    # the bridge: each JAX leaf lands in the port's key, transposed back
    flat = {'/'.join(str(getattr(k, 'key', k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(
                var['params'])}
    assert len(flat) == len(qg.state_dict())
    for path, leaf in flat.items():
        key, fn = torch_key(f'query_generator/{path}', {}, leaf)
        key = key[len('roi_head.query_generator.'):]
        assert np.array_equal(np.asarray(fn(leaf)), sd[key].numpy()), path
    assert any(k.startswith(('cls_fcs.', 'size_fcs.', 'center_fcs.'))
               for k in sd)


def test_query_generator_branch_convs_refused():
    """A branch conv would run on the flat encoding: JAX's module asserts
    at init, the port's constructor raises."""
    feats, K, ext, ok = _qg_inputs()
    args = tuple(jnp.asarray(x) for x in (feats, K, ext, ok))
    with pytest.raises(AssertionError, match='spatial features'):
        JQG(**QG_KW, with_cls=True, num_cls_convs=1).init(KEY, *args)
    with pytest.raises(ValueError, match='spatial features'):
        QueryGenerator(**QG_KW, with_cls=True, num_cls_convs=1)


def test_rcnn_class_agnostic_matches_jax_and_round_trips():
    """Shared2FCBBoxHead(reg_class_agnostic=True): fc_reg 4 wide; the
    outputs; the bridge and JAX's own converter carry every leaf back
    exactly."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 7, 7, 16)).astype(np.float32)
    jh = JRCNN(num_classes=10, fc_out_channels=32, reg_class_agnostic=True)
    var = materialize(jax.eval_shape(jh.init, KEY, jnp.asarray(x)), seed=6)
    var = jax.tree.map(lambda a: a + 0.01, var)       # a nonzero fc_reg
    cls_j, reg_j = jh.apply(var, jnp.asarray(x))
    head = Shared2FCBBoxHead(16, 32, 10, reg_class_agnostic=True)
    sd = bridged('base_detector/bbox_head', var['params'])
    head.load_state_dict(sd, strict=True)
    with torch.no_grad():
        cls_t, reg_t = head(t(x))
    assert reg_t.shape == (6, 4) and head.fc_reg.weight.shape == (4, 32)
    assert rel_err(cls_t.numpy(), cls_j) < REL
    assert rel_err(reg_t.numpy(), reg_j) < REL
    params, _ = convert_torch_state_dict(
        {f'base_detector.roi_head.bbox_head.{k}': v.numpy()
         for k, v in sd.items()})
    assert params.pop('_unmatched') == 0
    back = params['base_detector']['bbox_head']
    for name, leaves in var['params'].items():
        for leaf, w in leaves.items():
            assert np.array_equal(np.asarray(back[name][leaf]),
                                  np.asarray(w)), (name, leaf)


@pytest.mark.parametrize('backbone', ['resnet', 'vovnet'])
def test_out_indices_match_jax(backbone):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, 32, 64, 3)).astype(np.float32)
    idx = (1, 3)
    if backbone == 'resnet':
        jnet = JResNet(depth=10, out_indices=idx)
        net = ResNet(10, out_indices=idx)
    else:
        jnet = JVoVNet(depth=19, out_indices=idx)
        net = VoVNet(19, out_indices=idx)
    var = materialize(jax.eval_shape(jnet.init, KEY, jnp.asarray(x)), seed=9)
    want = jax.jit(jnet.apply)(var, jnp.asarray(x))
    net.load_state_dict(bridged('base_detector/backbone', var['params'],
                                var['constants']), strict=True)
    with torch.no_grad():
        got = net(t(x))
    assert len(got) == len(want) == 2
    assert net.out_channels == tuple(o.shape[-1] for o in want)
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) < REL


# -------------------------------------------------------- frozen stages

@pytest.fixture(scope='module')
def resnet_case():
    x = np.random.default_rng(10).normal(size=(1, 32, 64, 3)).astype(
        np.float32)
    var = materialize(jax.eval_shape(
        JResNet(depth=10, stage_with_dcn=DCN).init, KEY, jnp.asarray(x)),
        seed=11)
    return dict(x=x, var=var)


@pytest.mark.parametrize('frozen,remat', [
    (-1, False), (0, False), (2, False), (3, False), (2, True)],
    ids=['-1', '0', '2', '3', '2-remat'])
def test_frozen_stages_match_jax(resnet_case, frozen, remat):
    """ResNet-10 with DCN in stages 3-4: the outputs, and the gradients of
    sum(out * cotangent) over all four stages.  The port computes a
    gradient exactly for its trainable parameters: JAX's equal them; on
    the stages it freezes beyond stem and layer1 (2..frozen_stages) JAX's
    are exactly zero.  With remat the port's gradients are those without
    it, bit for bit."""
    c = resnet_case
    x, var = c['x'], c['var']
    jnet = JResNet(depth=10, stage_with_dcn=DCN, frozen_stages=frozen,
                   remat=remat)
    outs = jax.jit(jnet.apply)(var, jnp.asarray(x))
    rng = np.random.default_rng(12)
    cots = [rng.normal(size=o.shape).astype(np.float32) for o in outs]

    def loss(params):
        o = jnet.apply({'params': params, 'constants': var['constants']},
                       jnp.asarray(x))
        return sum((a * jnp.asarray(b)).sum() for a, b in zip(o, cots))
    jgrads = jax.jit(jax.grad(loss))(var['params'])
    zeros = jax.tree.map(np.zeros_like, var['constants'])
    jg = bridged('base_detector/backbone', jax.tree.map(np.asarray, jgrads),
                 zeros)

    def port(remat_):
        net = ResNet(10, DCN, frozen_stages=frozen, remat=remat_)
        net.load_state_dict(bridged('base_detector/backbone', var['params'],
                                    var['constants']), strict=True)
        o = net(t(x))
        sum((a * t(b)).sum() for a, b in zip(o, cots)).backward()
        return net, o
    net, got = port(remat)
    for g, w in zip(got, outs):
        assert rel_err(g.detach().numpy(), w) < REL
    n = 0
    for name, prm in net.named_parameters():
        if prm.requires_grad:
            assert rel_err(prm.grad.numpy(), jg[name].numpy()) < REL, name
            n += 1
        else:
            assert prm.grad is None
            stage = name.split('.')[0]
            if stage in [f'layer{s}' for s in range(2, frozen + 1)]:
                assert not jg[name].any(), name
    trained = {name.split('.')[0] for name, prm in net.named_parameters()
               if prm.requires_grad}
    assert trained == {f'layer{s}' for s in range(max(frozen, 1) + 1, 5)}
    assert n > 0
    if remat:
        plain, _ = port(False)
        for (name, a), b in zip(net.named_parameters(), plain.parameters()):
            if a.requires_grad:
                assert torch.equal(a.grad, b.grad), name


def test_frozen_stage_weight_decay_difference():
    """The one known difference: JAX stops the gradient of layer2 under
    frozen_stages=2 but its AdamW (label 'backbone') still decays the
    weights, p -> p * (1 - lr * wd); the port leaves layer2 out of the
    optimizer, so a step moves none of it."""
    w = np.random.default_rng(13).normal(size=(3, 3)).astype(np.float32)
    params = {'base_detector': {'backbone': {
        'layer2_0': {'conv1': {'kernel': jnp.asarray(w)}},
        'layer3_0': {'conv1': {'kernel': jnp.asarray(w)}}}}}
    grads = jax.tree.map(jnp.zeros_like, params)
    grads['base_detector']['backbone']['layer3_0']['conv1']['kernel'] = \
        jnp.ones_like(w)
    tx = joptim.make_optimizer(params, total_steps=50)
    upd, _ = tx.update(grads, tx.init(params), params)
    lr = 2e-4 * 0.25 / 3                      # step 0: warmup from lr / 3
    layer2 = np.asarray(params['base_detector']['backbone']['layer2_0'][
        'conv1']['kernel'] + upd['base_detector']['backbone']['layer2_0'][
        'conv1']['kernel'])
    np.testing.assert_allclose(layer2, w * (1 - lr * 0.01), rtol=1e-6)
    assert not np.array_equal(layer2, w)

    cfg = tcfgs.tiny(frozen_stages=2)
    model = TMV2D(cfg)
    opt = make_optimizer(model, total_steps=50)
    in_opt = {id(p) for g in opt.param_groups for p in g['params']}
    bb = model.base_detector.backbone
    assert all(not p.requires_grad and id(p) not in in_opt
               for p in bb.layer2.parameters())
    trained = [p for p in bb.layer3.parameters() if p.requires_grad]
    assert trained and all(id(p) in in_opt for p in trained)
    before = [p.detach().clone() for p in bb.layer2.parameters()]
    for g in opt.param_groups:
        for p in g['params']:
            p.grad = torch.ones_like(p)
    opt.step()
    assert all(torch.equal(a, b) for a, b in
               zip(before, bb.layer2.parameters()))
