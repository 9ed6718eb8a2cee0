"""The port's training slice against the JAX package on the CPU.

Module tests: grid mask, focal / L1 / CE losses, Hungarian matching, the
head and DN losses, RPN / R-CNN assignment, sampling and losses, the DN
queries and masks, the missed-GT complement and the optimizer.  Then one
whole training step of the tiny config with DCN in stages 3-4 (two
frames), float32, dropout 0: the same numpy weights (through
`state_dict_from_jax`), the same scene and the same draws go through
`mv2d_tpu.train.train_step.compute_losses` (its XLA paths, what JAX runs
on the CPU) and `mv2d_tpu_torch.train.train_step.compute_losses`.

The JAX draws are pinned here, by monkeypatching its draw points (the
grid mask, `MV2D._prepare_dn`'s uniform noise, `random_sample`'s uniform
keys); nothing in `mv2d_tpu` changes.

Tolerances: float32 on both sides, which differ in summation order only.
Module outputs 1e-4 of their max magnitude (losses 1e-4 relative);
discrete results (assignments, samples, proposals, counts) exactly.  The
whole step: every loss term 1e-4 relative, every parameter's gradient
1e-3 of the tensor's max magnitude (float32 sums in another order through
many layers).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402
from flax import linen as flax_nn                        # noqa: E402

from mv2d_tpu import configs as jcfgs                    # noqa: E402
from mv2d_tpu.core import matching as jmatch             # noqa: E402
from mv2d_tpu.core.geometry import prepare_camera_params as j_cam  # noqa
from mv2d_tpu.models import mv2d as jmv2d                # noqa: E402
from mv2d_tpu.ops import focal_loss as jfl               # noqa: E402
from mv2d_tpu.ops import grid_mask as jgm                # noqa: E402
from mv2d_tpu.train import detector2d_loss as jd2l       # noqa: E402
from mv2d_tpu.train import losses as jlosses             # noqa: E402
from mv2d_tpu.train import optim as joptim               # noqa: E402
from mv2d_tpu.train import train_step as jts             # noqa: E402
from mv2d_tpu_torch import configs as tcfgs              # noqa: E402
from mv2d_tpu_torch.core import matching as tmatch       # noqa: E402
from mv2d_tpu_torch.models.mv2d import MV2D as TMV2D     # noqa: E402
from mv2d_tpu_torch.nn.decoder import Dropout as TDropout  # noqa: E402
from mv2d_tpu_torch.ops import focal_loss as tfl         # noqa: E402
from mv2d_tpu_torch.ops import grid_mask as tgm          # noqa: E402
from mv2d_tpu_torch.parallel import dist as tdist        # noqa: E402
from mv2d_tpu_torch.synthetic import camera_rig, synthetic_train_batch  # noqa
from mv2d_tpu_torch.train import detector2d_loss as td2l  # noqa: E402
from mv2d_tpu_torch.train import losses as tlosses       # noqa: E402
from mv2d_tpu_torch.train import optim as toptim         # noqa: E402
from mv2d_tpu_torch.train import train_step as tts       # noqa: E402
from mv2d_tpu_torch.weights import state_dict_from_jax   # noqa: E402
from tests.test_torch_port_slice import materialize      # noqa: E402

REL = 1e-4
DCN = (False, False, True, True)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ grid mask

def grid_draws(rng, V, H):
    d = rng.integers(2, max(int(H * 0.8), 3), V)
    return dict(apply=np.bool_(True), d=d,
                ratio=rng.uniform(0.4, 0.6, V).astype(np.float32),
                u_h=rng.uniform(size=V).astype(np.float32),
                u_w=rng.uniform(size=V).astype(np.float32))


def jax_grid_mask(draws):
    """The JAX package's grid_mask with its draws replaced by `draws`
    (its own mask algebra, lines of `ops/grid_mask.grid_mask`)."""
    def pinned(rng, imgs):
        V, H, W, _ = imgs.shape
        d = jnp.asarray(draws['d'], jnp.int32)
        length = jnp.clip((d * jnp.asarray(draws['ratio']) + 0.5)
                          .astype(jnp.int32), 1, d - 1)
        st_h = jnp.floor(jnp.asarray(draws['u_h']) * d).astype(jnp.int32)
        st_w = jnp.floor(jnp.asarray(draws['u_w']) * d).astype(jnp.int32)
        keep = jgm.grid_keep_mask(d, length, st_h, st_w,
                                  jnp.zeros_like(d), (H, W))
        keep = keep | ~jnp.asarray(draws['apply'])
        return imgs * keep[..., None].astype(imgs.dtype)
    return pinned


def torch_grid_draws(draws):
    return tgm.GridMaskDraws(t(np.asarray(draws['apply'])), t(draws['d']),
                             t(draws['ratio']), t(draws['u_h']),
                             t(draws['u_w']))


@pytest.mark.parametrize('apply', [True, False])
def test_grid_mask_matches_jax(apply):
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(4, 40, 56, 3)).astype(np.float32)
    draws = grid_draws(rng, 4, 40)
    draws['apply'] = np.bool_(apply)
    want = jax_grid_mask(draws)(None, jnp.asarray(imgs))
    got = tgm.grid_mask(t(imgs), torch_grid_draws(draws))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert apply == bool((got.numpy() == 0).any())


# ----------------------------------------------------------- loss helpers

def test_loss_helpers_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (50, 10)).astype(np.float32)
    labels = rng.integers(0, 11, 50)
    w = rng.uniform(size=50).astype(np.float32)
    pred, tgt = rng.normal(size=(2, 50, 4)).astype(np.float32)
    w4 = rng.uniform(size=(50, 4)).astype(np.float32)
    pairs = [
        (jfl.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(w), 10, avg_factor=7.0,
                                loss_weight=2.0),
         tfl.sigmoid_focal_loss(t(logits), t(labels), t(w), 10,
                                avg_factor=7.0, loss_weight=2.0)),
        (jfl.weighted_l1_loss(jnp.asarray(pred), jnp.asarray(tgt),
                              jnp.asarray(w4), 3.0, 0.25),
         tfl.weighted_l1_loss(t(pred), t(tgt), t(w4), 3.0, 0.25)),
        (jfl.optax_sigmoid_ce(jnp.asarray(logits), jnp.asarray(
            (labels[:, None] == np.arange(10)).astype(np.float32))),
         tfl.sigmoid_ce(t(logits), t((labels[:, None] == np.arange(10))
                                      .astype(np.float32)))),
        (jfl.softmax_cross_entropy(jnp.asarray(logits),
                                   jnp.asarray(labels % 10), jnp.asarray(w),
                                   0.5),
         tfl.softmax_cross_entropy(t(logits), t(labels % 10), t(w), 0.5)),
    ]
    for want, got in pairs:
        assert rel_err(got.numpy(), want) < REL


# ------------------------------------------------------------- matching

def head_case(rng, L=3, Q=40, G=12, n_valid_gt=9):
    cls = rng.normal(0, 2, (L, Q, 10)).astype(np.float32)
    box = rng.normal(0, 1, (L, Q, 10)).astype(np.float32)
    qv = rng.uniform(size=Q) < 0.8
    gt = np.zeros((G, 9), np.float32)
    gt[:, :2] = rng.uniform(-40, 40, (G, 2))
    gt[:, 2] = -1.5
    gt[:, 3:6] = rng.uniform(1, 4, (G, 3))
    gt[:, 6] = rng.uniform(-3, 3, G)
    gt[:, 7:] = rng.normal(size=(G, 2))
    gt[n_valid_gt:] = 0.0
    labels = rng.integers(0, 10, G)
    gv = np.arange(G) < n_valid_gt
    return cls, box, qv, gt, labels, gv


def test_matching_matches_jax():
    """Costs within 1e-4; the exact host assignment is the same."""
    rng = np.random.default_rng(2)
    cls, box, qv, gt, labels, gv = head_case(rng)
    from mv2d_tpu.core.boxes import bottom_to_gravity, normalize_bbox
    code = np.asarray(normalize_bbox(bottom_to_gravity(jnp.asarray(gt))))
    for lvl in range(cls.shape[0]):
        jc = jmatch.focal_loss_cost(jnp.asarray(cls[lvl]),
                                    jnp.asarray(labels)) + \
            jmatch.bbox3d_l1_cost(jnp.asarray(box[lvl]), jnp.asarray(code))
        tc = tmatch.match_cost(t(cls[lvl]), t(box[lvl]), t(code), t(labels))
        ok = qv[:, None] & gv[None]
        assert rel_err(tc.numpy()[ok], np.asarray(jc)[ok]) < REL
        ja, jp = jmatch.hungarian_assign(jc, jnp.asarray(qv),
                                         jnp.asarray(gv), method='callback')
        ta, tp = tmatch.hungarian_assign(tc, t(qv), t(gv))
        assert np.array_equal(ta.numpy(), np.asarray(ja))
        assert np.array_equal(tp.numpy(), np.asarray(jp))
        assert tp.sum() == gv.sum()


def test_head_and_dn_losses_match_jax():
    rng = np.random.default_rng(3)
    jc, tc = jcfgs.tiny(), tcfgs.tiny()
    L, G, S = 2, jc.max_gt, jc.denoise_scalar
    cls, box, qv, gt, labels, gv = head_case(rng, L=L, G=G, n_valid_gt=3)
    dn_cls = rng.normal(0, 2, (L, S * G, 10)).astype(np.float32)
    dn_box = rng.normal(0, 1, (L, S * G, 10)).astype(np.float32)
    noise = rng.uniform(-1, 1, (S * G, 3)).astype(np.float32)
    # DN info through both packages' _prepare_dn with the same noise
    jm = jmv2d.MV2D(jc)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, 'uniform',
                   lambda *a, **k: jnp.asarray(noise))
        _, jinfo = jm._prepare_dn(jmv2d.GroundTruth3D(
            jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(gv)), None)
    tm = TMV2D(tc)
    tgt3 = tts.GroundTruth3D(t(gt), t(labels), t(gv))
    noisy, tinfo = tm._prepare_dn(tgt3, t(noise))
    assert np.array_equal(tinfo.known_labels.numpy(),
                          np.asarray(jinfo.known_labels))
    jout = jmv2d.ForwardOutputs(
        all_cls_scores=jnp.asarray(cls), all_bbox_preds=jnp.asarray(box),
        dn_cls_scores=jnp.asarray(dn_cls), dn_bbox_preds=jnp.asarray(dn_box),
        dn_info=jinfo, query_valid=jnp.asarray(qv), proposals=None)
    want = jlosses.mv2d_head_loss(jout, jmv2d.GroundTruth3D(
        jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(gv)), jc)
    from mv2d_tpu_torch.models.mv2d import HeadOutputs
    tout = HeadOutputs(t(cls), t(box), t(qv), {}, t(dn_cls), t(dn_box),
                       tinfo)
    got = tlosses.mv2d_head_loss(tout, tgt3, tc)
    assert sorted(got) == sorted(want)
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) < REL, k


# ------------------------------------------------------- DN and masks

def test_dn_queries_and_masks_match_jax():
    rng = np.random.default_rng(4)
    jc, tc = jcfgs.tiny(), tcfgs.tiny()
    G, S = jc.max_gt, jc.denoise_scalar
    _, _, _, gt, labels, gv = head_case(rng, G=G, n_valid_gt=3)
    noise = rng.uniform(-1, 1, (S * G, 3)).astype(np.float32)
    jm, tm = jmv2d.MV2D(jc), TMV2D(tc)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, 'uniform',
                   lambda *a, **k: jnp.asarray(noise))
        jnoisy, jinfo = jm._prepare_dn(jmv2d.GroundTruth3D(
            jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(gv)), None)
    noisy, info = tm._prepare_dn(tts.GroundTruth3D(t(gt), t(labels), t(gv)),
                                 t(noise))
    assert rel_err(noisy.numpy(), jnoisy) < REL
    assert rel_err(info.known_boxes.numpy(), jinfo.known_boxes) < REL
    assert np.array_equal(info.valid.numpy(), np.asarray(jinfo.valid))
    assert int(info.num_gt) == int(jinfo.num_gt)
    mv = rng.uniform(size=10) < 0.7
    want = jm._dn_self_mask(jnp.asarray(mv), jinfo.valid)
    got = tm._dn_self_mask(t(mv), info.valid)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_complement_2d_gt_matches_jax():
    rng = np.random.default_rng(5)
    jc, tc = jcfgs.tiny(), tcfgs.tiny()
    V, P, G2 = 2, 6, 5
    xy = rng.uniform(0, 60, (V, P + G2, 2))
    wh = rng.uniform(2, 30, (V, P + G2, 2))
    b = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    b[0, P] = b[0, 1]                               # one GT already found
    pv = rng.uniform(size=(V, P)) < 0.8
    gv = rng.uniform(size=(V, G2)) < 0.8
    props = dict(boxes=b[:, :P], scores=rng.uniform(size=(V, P)).astype(
        np.float32), labels=rng.integers(0, 10, (V, P)), valid=pv)
    gt2 = dict(boxes=b[:, P:], labels=rng.integers(0, 10, (V, G2)), valid=gv)
    jp = jmv2d.MV2D(jc).complement_2d_gt(
        jmv2d.Proposals(**{k: jnp.asarray(v) for k, v in props.items()}),
        jmv2d.GroundTruth2D(**{k: jnp.asarray(v) for k, v in gt2.items()}))
    from mv2d_tpu_torch.models.detector2d import Proposals
    tp = TMV2D(tc).complement_2d_gt(
        Proposals(**{k: t(v) for k, v in props.items()}),
        tts.GroundTruth2D(**{k: t(v) for k, v in gt2.items()}))
    for f in ('boxes', 'scores', 'labels', 'valid'):
        assert np.array_equal(getattr(tp, f).numpy(),
                              np.asarray(getattr(jp, f))), f
    assert not tp.valid[0, P]


# ------------------------------------------------------ 2D detector loss

def det_case(rng, V=2, N=300, G=6):
    xy = rng.uniform(0, 200, (N, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(8, 60, (N, 2))], 1)
    gxy = rng.uniform(0, 200, (V, G, 2))
    gt = np.concatenate([gxy, gxy + rng.uniform(8, 60, (V, G, 2))], -1)
    gv = np.arange(G)[None].repeat(V, 0) < np.array([[4], [6]])[:V]
    return anchors.astype(np.float32), gt.astype(np.float32), gv


def test_assign_sample_and_rpn_loss_match_jax():
    rng = np.random.default_rng(6)
    anchors, gt, gv = det_case(rng)
    V, N = gt.shape[0], anchors.shape[0]
    scores = rng.normal(size=(V, N)).astype(np.float32)
    deltas = rng.normal(size=(V, N, 4)).astype(np.float32)
    u = rng.uniform(size=(2, V, N)).astype(np.float32)
    for v in range(V):
        ja = jd2l.max_iou_assign(jnp.asarray(anchors), jnp.asarray(gt[v]),
                                 jnp.asarray(gv[v]), 0.7, 0.3, 0.3)
        ta = td2l.max_iou_assign(t(anchors), t(gt[v]), t(gv[v]), 0.7, 0.3,
                                 0.3)
        for f in ('assigned_gt', 'is_pos', 'is_neg'):
            assert np.array_equal(getattr(ta, f).numpy(),
                                  np.asarray(getattr(ja, f))), f
    with pytest.MonkeyPatch.context() as mp:
        jres = []
        for v in range(V):
            uv = iter([jnp.asarray(u[0, v]), jnp.asarray(u[1, v])])
            mp.setattr(jax.random, 'uniform', lambda *a, **k: next(uv))
            jres.append(jd2l.rpn_loss(jax.random.PRNGKey(0),
                                      jnp.asarray(scores[v]),
                                      jnp.asarray(deltas[v]),
                                      jnp.asarray(anchors),
                                      jnp.asarray(gt[v]),
                                      jnp.asarray(gv[v]), num_sample=64))
    got = td2l.rpn_loss(t(scores), t(deltas), t(anchors), t(gt), t(gv),
                        t(u[0]), t(u[1]), num_sample=64)
    for k in ('loss_rpn_cls', 'loss_rpn_bbox', 'rpn_num_pos'):
        want = np.stack([np.asarray(r[k]) for r in jres])
        assert rel_err(got[k].numpy(), want) < REL, k
    assert got['rpn_num_pos'].sum() > 0


def test_rcnn_sample_and_loss_match_jax():
    rng = np.random.default_rng(7)
    props, gt, gv = det_case(rng, N=40)
    V, P, G = gt.shape[0], props.shape[0], gt.shape[1]
    props = np.broadcast_to(props, (V, P, 4)).copy()
    props[:, :5] = gt[:, :5] + rng.normal(0, 2, (V, 5, 4))   # positives
    pv = rng.uniform(size=(V, P)) < 0.9
    labels = rng.integers(0, 10, (V, G))
    u = rng.uniform(size=(2, V, P + G)).astype(np.float32)
    jsamp = []
    with pytest.MonkeyPatch.context() as mp:
        for v in range(V):
            uv = iter([jnp.asarray(u[0, v]), jnp.asarray(u[1, v])])
            mp.setattr(jax.random, 'uniform', lambda *a, **k: next(uv))
            jsamp.append(jd2l.rcnn_sample(
                jax.random.PRNGKey(0), jnp.asarray(props[v]),
                jnp.asarray(pv[v]), jnp.asarray(gt[v]),
                jnp.asarray(labels[v]), jnp.asarray(gv[v]), 10,
                num_sample=32))
    ts_ = td2l.rcnn_sample(t(props), t(pv), t(gt), t(labels), t(gv),
                           t(u[0]), t(u[1]), 10, num_sample=32)
    for f in ('rois', 'labels', 'is_pos', 'weight'):
        want = np.stack([np.asarray(getattr(s, f)) for s in jsamp])
        assert np.array_equal(getattr(ts_, f).numpy(), want), f
    want = np.stack([np.asarray(s.reg_targets) for s in jsamp])
    assert rel_err(ts_.reg_targets.numpy(), want) < REL
    assert ts_.is_pos.sum() > 0
    S = ts_.rois.shape[1]
    cls = rng.normal(size=(V * S, 11)).astype(np.float32)
    reg = rng.normal(size=(V * S, 40)).astype(np.float32)
    flat = jd2l.RCNNSamples(*(jnp.concatenate(
        [jnp.asarray(getattr(s, f)) for s in jsamp]) for f in
        ('rois', 'labels', 'reg_targets', 'is_pos', 'weight')))
    want = jd2l.rcnn_loss(jnp.asarray(cls), jnp.asarray(reg), flat, 10)
    got = td2l.rcnn_loss(t(cls), t(reg), ts_, 10)
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) < REL, k


# ------------------------------------------------------------ optimizer

def test_optimizer_matches_optax():
    """Three updates from the same numpy gradients: make_optimizer's optax
    chain and the port's AdamW give the same parameters (1e-6), with the
    clip binding on the first step, the schedule in its warmup, the
    backbone at lr x 0.25 and frozen parameters unmoved."""
    import optax
    rng = np.random.default_rng(8)
    model = torch.nn.Module()
    model.base_detector = torch.nn.Module()
    model.base_detector.backbone = torch.nn.Module()
    bb = model.base_detector.backbone
    bb.conv = torch.nn.Linear(4, 3)
    bb.bn = torch.nn.Linear(3, 1)
    bb.bn.requires_grad_(False)                # a frozen BN affine
    model.head = torch.nn.Linear(3, 2)
    names = [n for n, _ in model.named_parameters()]
    init = {n: rng.normal(size=p.shape).astype(np.float32)
            for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(t(init[n]))
    # the JAX tree, with labels from its own rule: '/bn' is frozen
    jtree = {'base_detector': {'backbone': {
        'conv': {'kernel': init['base_detector.backbone.conv.weight'],
                 'bias': init['base_detector.backbone.conv.bias']},
        'bn': {'scale': init['base_detector.backbone.bn.weight'],
               'bias': init['base_detector.backbone.bn.bias']}}},
        'head': {'kernel': init['head.weight'], 'bias': init['head.bias']}}
    jpath = {'base_detector.backbone.conv.weight': ('base_detector',
                                                    'backbone', 'conv',
                                                    'kernel'),
             'base_detector.backbone.conv.bias': ('base_detector',
                                                  'backbone', 'conv', 'bias'),
             'base_detector.backbone.bn.weight': ('base_detector',
                                                  'backbone', 'bn', 'scale'),
             'base_detector.backbone.bn.bias': ('base_detector', 'backbone',
                                                'bn', 'bias'),
             'head.weight': ('head', 'kernel'), 'head.bias': ('head', 'bias')}

    def get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def put(tree, path, val):
        for k in path[:-1]:
            tree = tree[k]
        tree[path[-1]] = val

    params = jax.tree.map(jnp.asarray, jtree)
    tx = joptim.make_optimizer(params, total_steps=50)
    state = tx.init(params)
    opt = toptim.make_optimizer(model, total_steps=50)
    for step in range(3):
        grads = {n: rng.normal(0, 30 if step == 0 else 0.5,
                               init[n].shape).astype(np.float32)
                 for n in names}
        for n in names:                     # frozen: the port has none
            if 'bn' in n:
                grads[n][:] = 0.0
        jg = jax.tree.map(np.zeros_like, jtree)
        for n in names:
            put(jg, jpath[n], jnp.asarray(grads[n]))
        upd, state = tx.update(jg, state, params)
        params = optax.apply_updates(params, upd)
        opt.zero_grad()
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.grad = t(grads[n]).clone()
        norm, lr = toptim.apply_update(opt)
        assert (float(norm) > opt.clip_norm) == (step == 0)
        assert lr == pytest.approx(toptim.cosine_schedule(step, 2e-4, 50))
        for n, p in model.named_parameters():
            want = np.asarray(get(params, jpath[n]))
            assert np.abs(p.detach().numpy() - want).max() < 1e-6, (step, n)
    for n, p in model.named_parameters():
        if 'bn' in n:
            assert np.array_equal(p.detach().numpy(), init[n])
    assert opt.param_groups[1]['lr'] == pytest.approx(
        0.25 * toptim.cosine_schedule(2, 2e-4, 50))
    assert toptim.cosine_schedule(0, 2e-4, 50) == pytest.approx(2e-4 / 3)


# ----------------------------------------------------- the whole step

def pinned_jax_losses(jm, variables, batch, draws, rng):
    """JAX compute_losses + the train step's deferred normalisation, with
    its draws replaced by `draws` (test-local monkeypatches)."""
    cfg = jm.cfg
    Vc = cfg.num_views
    _, _, _, r_rpn, r_rcnn = jax.random.split(rng, 5)
    tables = {}
    for key, u in ((r_rpn, draws['rpn_u']), (r_rcnn, draws['rcnn_u'])):
        keys, rows = [], []
        for v, kv in enumerate(jax.random.split(key, Vc)):
            kp, kn = jax.random.split(kv)
            keys += [np.asarray(kp), np.asarray(kn)]
            rows += [u[0, v], u[1, v]]
        tables[u.shape[-1]] = (jnp.asarray(np.stack(keys)),
                               jnp.asarray(np.stack(rows)))
    orig_sample = jd2l.random_sample

    def lookup(key, shape, *a, **k):
        keys, rows = tables[shape[0]]
        return rows[jnp.argmax(jnp.all(key[None] == keys, -1))]

    def pinned_sample(rng_, is_pos, is_neg, num, pos_fraction):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, 'uniform', lookup)
            return orig_sample(rng_, is_pos, is_neg, num, pos_fraction)

    orig_dn = jmv2d.MV2D._prepare_dn

    def pinned_dn(self, gt, rng_):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, 'uniform',
                       lambda *a, **k: jnp.asarray(draws['dn_noise']))
            return orig_dn(self, gt, rng_)

    def loss_fn(params):
        total, metrics, deferred = jts.compute_losses(
            jm, {'params': params, 'constants': variables['constants']},
            batch, rng, mixed_precision=False, sync_bbox_norm=True)
        for k, (s, f) in deferred.items():
            v = s / jnp.maximum(f, 1.0)
            total = total + v
            metrics[k] = v
        return total, metrics

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgm, 'grid_mask', jax_grid_mask(draws['grid']))
        mp.setattr(jd2l, 'random_sample', pinned_sample)
        mp.setattr(jmv2d.MV2D, '_prepare_dn', pinned_dn)
        (total, metrics), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables['params'])
    return total, metrics, grads


@pytest.fixture(scope='module')
def step_pair():
    """One tiny+DCN two-frame training step through both packages."""
    return train_step_pair(stage_with_dcn=DCN, num_frames=2, dropout=0.0)


def replaying_dropout(masks):
    """A stand-in for flax's `nn.Dropout.__call__` that applies `masks`
    (keep masks, in the order the port drew them) instead of drawing:
    each Dropout module (by scope path) takes the next unused mask the
    first time it is traced, and the same one when traced again."""
    by_path = {}

    def call(self, inputs, deterministic=None, rng=None):
        deterministic = self.deterministic if deterministic is None \
            else deterministic
        if self.rate == 0.0 or deterministic:
            return inputs
        path = tuple(self.scope.path)
        if path not in by_path:
            by_path[path] = masks[len(by_path)]
        keep = by_path[path]              # the port's [Q, C], JAX's [1, Q, C]
        assert keep.size == inputs.size, (path, keep.shape, inputs.shape)
        keep = jnp.asarray(keep.reshape(inputs.shape))
        return jnp.where(keep, inputs / (1.0 - self.rate),
                         jnp.zeros_like(inputs))
    call.by_path = by_path
    return call


def train_step_pair(weights_seed=0, **kw):
    """One training step of `tiny(**kw)` through both packages, on the
    same weights (`materialize(., weights_seed)`), scene and draws: JAX's
    losses and gradients (in port names), the port's losses after
    `dp_objective` and its model with its gradients.  With dropout on
    (kw dropout > 0) the port draws its masks from a generator seeded 11
    and JAX's flax Dropout applies the same masks (`replaying_dropout`).
    `port_step(**over)` runs the port's step again on the same weights,
    scene, draws and dropout seed, with the config's fields `over`
    replaced -> (total, metrics, model)."""
    torch.set_num_threads(1)
    jc, tc = jcfgs.tiny(**kw), tcfgs.tiny(**kw)
    batch = synthetic_train_batch(tc, seed=0, device='cpu')
    V, (H, W) = tc.total_views, tc.image_size
    K, E = camera_rig(V, tc.image_size)
    ts = [0.0] * tc.num_views + [0.5] * (V - tc.num_views)
    jbatch = jts.TrainBatch(
        imgs=jnp.asarray(batch.imgs.numpy()),
        cam=j_cam(K, E, timestamps=ts),
        img_shapes=jnp.asarray(batch.img_shapes.numpy()),
        gt2d=jmv2d.GroundTruth2D(*(jnp.asarray(x.numpy())
                                   for x in batch.gt2d)),
        gt3d=jmv2d.GroundTruth3D(*(jnp.asarray(x.numpy())
                                   for x in batch.gt3d)))
    jm = jmv2d.MV2D(jc)
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jbatch.imgs,
                            jbatch.cam, jbatch.img_shapes)
    variables = materialize(struct, seed=weights_seed)
    # a nonzero R-CNN box head: with zero deltas and the GT-as-proposal
    # positives' zero targets the L1 residual is exactly 0, where the two
    # frameworks' |x| subgradients differ (JAX 1, torch 0)
    rng = np.random.default_rng(9)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, x: rng.normal(0, 0.01, x.shape).astype(np.float32)
        if 'fc_reg' in jax.tree_util.keystr(path) else x, variables)
    Vc = tc.num_views
    n_anchor = tts.all_anchors(tc).shape[0]
    draws = dict(
        grid=grid_draws(rng, V, H),
        dn_noise=rng.uniform(-1, 1, (tc.dn_pad, 3)).astype(np.float32),
        rpn_u=rng.uniform(size=(2, Vc, n_anchor)).astype(np.float32),
        rcnn_u=rng.uniform(size=(2, Vc, tc.proposal_train.rpn_max_per_img
                                 + tc.max_gt2d)).astype(np.float32))
    sd = state_dict_from_jax(variables['params'], variables['constants'])
    tdraws = tts.TrainDraws(torch_grid_draws(draws['grid']),
                            t(draws['dn_noise']), t(draws['rpn_u']),
                            t(draws['rcnn_u']))
    masks = []

    def port_step(record=False, **over):
        c = tc._replace(**over)
        tm = TMV2D(c)
        tm.load_state_dict({k: t(v) for k, v in sd.items()}, strict=True)
        drop = TDropout(c.dropout, torch.Generator().manual_seed(11))
        with pytest.MonkeyPatch.context() as mp:
            if record:        # the forward's keep masks (U >= p), in order
                draw = TDropout.__call__

                def recorded(self, x):
                    if self.p > 0.0 and self.generator is not None:
                        peek = torch.Generator()
                        peek.set_state(self.generator.get_state())
                        masks.append((torch.rand(x.shape, generator=peek)
                                      >= self.p).numpy())
                    return draw(self, x)
                mp.setattr(TDropout, '__call__', recorded)
            local, metrics = tdist.dp_objective(
                tm, [batch], [tdraws], [drop], mixed_precision=False)
        local.backward()
        return float(metrics.pop('total_loss')), metrics, tm

    total, metrics, tm = port_step(record=tc.dropout > 0)
    with pytest.MonkeyPatch.context() as mp:
        if masks:
            mp.setattr(flax_nn.Dropout, '__call__', replaying_dropout(masks))
        jtotal, jmetrics, jgrads = pinned_jax_losses(
            jm, variables, jbatch, draws, jax.random.PRNGKey(5))
    zeros = jax.tree.map(np.zeros_like, variables['constants'])
    jgrad_sd = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), zeros)
    return dict(jtotal=float(jtotal), jmetrics=jmetrics, jgrads=jgrad_sd,
                total=total, metrics=metrics, model=tm, masks=masks,
                port_step=port_step)


def test_train_step_losses_match_jax(step_pair):
    p = step_pair
    want = {k: float(v) for k, v in p['jmetrics'].items()}
    got = {k: float(v) for k, v in p['metrics'].items()}
    loss_keys = [k for k in want if 'loss' in k]
    assert sorted(k for k in got if 'loss' in k) == sorted(loss_keys)
    assert len(loss_keys) == 4 * 2 + 4
    for k in loss_keys:
        assert abs(got[k] - want[k]) <= REL * max(abs(want[k]), 1e-6), \
            (k, got[k], want[k])
    assert abs(p['total'] - p['jtotal']) <= REL * abs(p['jtotal'])
    # discrete results: sampled positives, valid queries, the key union
    for k in ('rpn_num_pos', 'rcnn_num_pos', 'num_queries', 'key_active',
              'key_overflow'):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got['rcnn_num_pos'] > 0 and got['num_queries'] > 0


def test_train_step_grads_match_jax(step_pair):
    """Every trainable parameter's gradient, carried into port names by
    state_dict_from_jax, within 1e-3 of the tensor's max magnitude; the
    frozen ones (stem, layer1, BN affines) get none.  The global norm of
    the trainable gradients (the clip's input) within 1e-4."""
    p = step_pair
    # a tensor whose gradient is zero in exact arithmetic (layer 0's
    # self-attention projections: its values are all zero) carries float32
    # noise of ~1e-8, so the scale is floored at 1e-5 of the step's
    # largest gradient (float32's resolution of it times a sum's depth)
    floor = 1e-5 * max(np.abs(g).max() for g in p['jgrads'].values())
    n = 0
    for name, prm in p['model'].named_parameters():
        if not prm.requires_grad:
            assert prm.grad is None, name
            continue
        want = p['jgrads'][name]
        got = prm.grad.numpy()
        scale = max(np.abs(want).max(), floor)
        assert np.abs(got - want).max() <= 1e-3 * scale, \
            (name, np.abs(got - want).max(), scale)
        n += 1
    assert n > 100
    sq = sum(float((p['jgrads'][k].astype(np.float64) ** 2).sum())
             for k, v in p['model'].named_parameters() if v.requires_grad)
    norm = toptim.clip_by_global_norm(
        [v for v in p['model'].parameters() if v.requires_grad], 1e30)
    assert abs(float(norm) - sq ** 0.5) <= REL * sq ** 0.5
    frozen = [k for k, v in p['model'].named_parameters()
              if not v.requires_grad]
    assert any('layer1.' in k for k in frozen) and any(
        k.endswith('conv1.weight') and 'layer' not in k for k in frozen)
