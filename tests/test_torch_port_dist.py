"""The port's data-parallel step (`mv2d_tpu_torch/parallel/dist.py`) on
the CPU, against the JAX package's DP step semantics
(`mv2d_tpu/parallel/mesh.py`, `tests/test_dp_parity.py`):

  * `compute_losses`: the deferred (weighted sum, num_pos) pairs and
    every other loss equal JAX's `sync_bbox_norm=True` on one tiny+DCN
    two-frame scene with pinned draws (float32, 1e-4 of max; the counts
    exactly);
  * at world size 1, `dp_train_step` on one scene equals a step on the
    per-scene losses;
  * `dp_train_step` with two scenes on one rank against JAX's
    `make_dp_train_step` on a two-device mesh, on pinned draws;
  * dp2 over gloo (`dryrun(2, 'cpu')`: two processes, one scene each)
    against dp1 with the same two scenes on one rank, at `test_dp_parity.py`'s
    tolerances: metrics rtol 1e-4 / atol 1e-7, each gradient's cosine
    > 1 - 1e-6 and norm ratio within 1e-4;
  * the synced normaliser is E[l] / E[n] over the global batch, not the
    per-scene E[l / n].
"""
import contextlib
import copy

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu import configs as jcfgs                    # noqa: E402
from mv2d_tpu.core.geometry import prepare_camera_params as j_cam  # noqa
from mv2d_tpu.models import mv2d as jmv2d                # noqa: E402
from mv2d_tpu.ops import grid_mask as jgm                # noqa: E402
from mv2d_tpu.train import detector2d_loss as jd2l       # noqa: E402
from mv2d_tpu.train import train_step as jts             # noqa: E402
from mv2d_tpu_torch import configs as tcfgs              # noqa: E402
from mv2d_tpu_torch.models.mv2d import MV2D as TMV2D     # noqa: E402
from mv2d_tpu_torch.nn.decoder import Dropout            # noqa: E402
from mv2d_tpu_torch.parallel import dist as tdist        # noqa: E402
from mv2d_tpu_torch.synthetic import camera_rig, synthetic_train_batch  # noqa
from mv2d_tpu_torch.train import losses as tlosses       # noqa: E402
from mv2d_tpu_torch.train import train_step as tts       # noqa: E402
from mv2d_tpu_torch.train.optim import apply_update, make_optimizer  # noqa
from mv2d_tpu_torch.weights import state_dict_from_jax   # noqa: E402
from tests.test_torch_port_slice import materialize      # noqa: E402
from tests.test_torch_port_train import (DCN, grid_draws,  # noqa: E402
                                         jax_grid_mask, t,
                                         torch_grid_draws)

REL = 1e-4
CPU = tdist.DistInfo(0, 1, torch.device('cpu'), None, False)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@contextlib.contextmanager
def jax_draws_pinned(Vc, scenes):
    """JAX's random draws replaced inside `compute_losses` (the
    monkeypatches of `test_torch_port_train.pinned_jax_losses`): the grid
    mask and the DN noise by scenes[0]'s draws, the same for every scene
    (a data-parallel step traces one scene's program); the samplers'
    uniforms by each scene's rows, looked up by the keys that
    compute_losses derives from that scene's rng.  scenes: [(rng, draws)]."""
    tables = {}
    for rng, draws in scenes:
        _, _, _, r_rpn, r_rcnn = jax.random.split(rng, 5)
        for key, u in ((r_rpn, draws['rpn_u']), (r_rcnn, draws['rcnn_u'])):
            keys, rows = tables.setdefault(u.shape[-1], ([], []))
            for v, kv in enumerate(jax.random.split(key, Vc)):
                kp, kn = jax.random.split(kv)
                keys += [np.asarray(kp), np.asarray(kn)]
                rows += [u[0, v], u[1, v]]
    tables = {n: (jnp.asarray(np.stack(k)), jnp.asarray(np.stack(r)))
              for n, (k, r) in tables.items()}
    draws = scenes[0][1]
    orig_sample = jd2l.random_sample
    orig_dn = jmv2d.MV2D._prepare_dn

    def lookup(key, shape, *a, **k):
        keys, rows = tables[shape[0]]
        return rows[jnp.argmax(jnp.all(key[None] == keys, -1))]

    def pinned_sample(rng_, is_pos, is_neg, num, pos_fraction):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, 'uniform', lookup)
            return orig_sample(rng_, is_pos, is_neg, num, pos_fraction)

    def pinned_dn(self, gt, rng_):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, 'uniform',
                       lambda *a, **k: jnp.asarray(draws['dn_noise']))
            return orig_dn(self, gt, rng_)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgm, 'grid_mask', jax_grid_mask(draws['grid']))
        mp.setattr(jd2l, 'random_sample', pinned_sample)
        mp.setattr(jmv2d.MV2D, '_prepare_dn', pinned_dn)
        yield


def pinned_jax_deferred(jm, variables, batch, draws, rng):
    """JAX compute_losses(..., sync_bbox_norm=True), forward only, with
    its draws replaced by `draws`."""
    with jax_draws_pinned(jm.cfg.num_views, [(rng, draws)]):
        return jax.jit(lambda v: jts.compute_losses(
            jm, v, batch, rng, mixed_precision=False,
            sync_bbox_norm=True))(variables)


def numpy_draws(rng, cfg):
    """A scene's draws for both packages, made with numpy."""
    Vc = cfg.num_views
    return dict(
        grid=grid_draws(rng, cfg.total_views, cfg.image_size[0]),
        dn_noise=rng.uniform(-1, 1, (cfg.dn_pad, 3)).astype(np.float32),
        rpn_u=rng.uniform(size=(2, Vc, tts.all_anchors(cfg).shape[0])
                          ).astype(np.float32),
        rcnn_u=rng.uniform(size=(2, Vc, cfg.proposal_train.rpn_max_per_img
                                 + cfg.max_gt2d)).astype(np.float32))


def torch_draws(draws):
    return tts.TrainDraws(torch_grid_draws(draws['grid']),
                          t(draws['dn_noise']), t(draws['rpn_u']),
                          t(draws['rcnn_u']))


def jax_batch(batch, cfg):
    """The port's TrainBatch of one scene as the JAX package's."""
    V = cfg.total_views
    K, E = camera_rig(V, cfg.image_size)
    ts = [0.0] * cfg.num_views + [0.5] * (V - cfg.num_views)
    return jts.TrainBatch(
        imgs=jnp.asarray(batch.imgs.numpy()),
        cam=j_cam(K, E, timestamps=ts),
        img_shapes=jnp.asarray(batch.img_shapes.numpy()),
        gt2d=jmv2d.GroundTruth2D(*(jnp.asarray(x.numpy())
                                   for x in batch.gt2d)),
        gt3d=jmv2d.GroundTruth3D(*(jnp.asarray(x.numpy())
                                   for x in batch.gt3d)))


def test_sync_bbox_norm_matches_jax():
    kw = dict(stage_with_dcn=DCN, num_frames=2, dropout=0.0)
    jc, tc = jcfgs.tiny(**kw), tcfgs.tiny(**kw)
    batch = synthetic_train_batch(tc, seed=1, device='cpu')
    jbatch = jax_batch(batch, tc)
    jm = jmv2d.MV2D(jc)
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jbatch.imgs,
                            jbatch.cam, jbatch.img_shapes)
    variables = materialize(struct, seed=1)
    draws = numpy_draws(np.random.default_rng(10), tc)
    jtotal, jmetrics, jdeferred = pinned_jax_deferred(
        jm, variables, jbatch, draws, jax.random.PRNGKey(5))

    sd = state_dict_from_jax(variables['params'], variables['constants'])
    tm = TMV2D(tc)
    tm.load_state_dict({k: t(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        total, metrics, deferred = tts.compute_losses(tm, batch,
                                                      torch_draws(draws))
    assert sorted(deferred) == sorted(jdeferred) == sorted(
        f'l{i}.{k}' for i in range(2) for k in ('loss_bbox', 'dn_loss_bbox'))
    assert not any(k in metrics for k in deferred)
    sums = {k: float(jdeferred[k][0]) for k in jdeferred}
    scale = max(abs(v) for v in sums.values())
    for k, (s, n) in deferred.items():
        assert abs(float(s) - sums[k]) <= REL * scale, (k, float(s), sums[k])
        assert float(n) == float(jdeferred[k][1]) > 0, k
    want = {k: float(v) for k, v in jmetrics.items() if 'loss' in k}
    assert sorted(k for k in metrics if 'loss' in k) == sorted(want)
    scale = max(abs(v) for v in want.values())
    for k, v in want.items():
        assert abs(float(metrics[k]) - v) <= REL * scale, (k, v)
    assert abs(float(total) - float(jtotal)) <= REL * abs(float(jtotal))


def test_dp_step_at_world_one_equals_train_step(monkeypatch):
    """At world size 1 with one scene the synced normaliser E[l] / E[n] is
    the scene's own l / max(n, 1): `dp_train_step` equals a step on the
    per-scene losses (`mv2d_head_loss` without sync_bbox_norm, the form
    `test_torch_port_train` holds against JAX), update included."""
    cfg = tdist.dryrun_config()
    torch.manual_seed(0)
    a = TMV2D(cfg)
    b = copy.deepcopy(a)
    oa = make_optimizer(a, total_steps=10)
    ob = make_optimizer(b, total_steps=10)
    scene = tdist.dryrun_scene(cfg, 2)
    got = tdist.dp_train_step(b, ob, [scene],
                              [tts.step_generator(0, 0, 0, 'cpu')], None,
                              mixed_precision=False)

    monkeypatch.setattr(tts, 'mv2d_head_loss',
                        lambda out, gt, c, sync_bbox_norm:
                        (tlosses.mv2d_head_loss(out, gt, c), {}))
    g = tts.step_generator(0, 0, 0, 'cpu')
    draws = tts.draw_train(cfg, scene.gt2d.boxes.shape[1], g)
    oa.zero_grad(set_to_none=True)
    total, want, deferred = tts.compute_losses(a, scene, draws,
                                               Dropout(cfg.dropout, g))
    assert deferred == {}
    total.backward()
    norm, lr = apply_update(oa)
    want.update(total_loss=total, grad_norm=norm, lr=lr)
    want = {k: float(torch.as_tensor(v).detach()) for k, v in want.items()}
    assert sorted(got) == sorted(want)
    assert sum('bbox' in k and k[0] == 'l' for k in got) == 4
    for k, v in want.items():
        assert abs(float(got[k]) - v) <= 1e-6 * max(abs(v), 1e-6), k
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert (p.grad is None) == (q.grad is None), n
        if p.grad is not None:
            assert (p.grad - q.grad).abs().max() <= \
                1e-6 * p.grad.abs().max(), n
        assert (p - q).abs().max() <= 1e-7, n


def test_dp_step_matches_jax_dp_step(monkeypatch):
    """`dp_train_step` with one rank holding two scenes against JAX's
    `make_dp_train_step` on a two-device CPU mesh (a scene a device), on
    the same scenes (their num_pos differ), weights and draws, in float32:
    every metric at `test_dp_parity.py`'s tolerances (rtol 1e-4, atol
    1e-7); the gradient the update took (all-reduced and clipped) within
    1e-3 of each tensor's max, `test_torch_port_train`'s tolerance between
    the two frameworks, and over all tensors `test_dp_parity.py`'s cosine
    > 1 - 1e-6 and norm ratio within 1e-4; grad_norm, the clip's input,
    within 1e-4.  JAX's update keeps the gradient in its state before and
    after the clip.  It zeroes the frozen leaves first: JAX's
    make_optimizer zeroes them after its clip, so their gradients count in
    its norm, where the port's (and the reference's requires_grad=False)
    have none."""
    import optax
    from mv2d_tpu.parallel.mesh import (make_dp_train_step, make_mesh,
                                        shard_batch)
    from mv2d_tpu.train.optim import _label_params
    kw = dict(num_frames=2, dropout=0.0)
    jc, tc = jcfgs.tiny(**kw), tcfgs.tiny(**kw)
    scenes = [tdist.dryrun_scene(tc, i) for i in (0, 1)]
    jscenes = [jax_batch(s, tc) for s in scenes]
    jm = jmv2d.MV2D(jc)
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jscenes[0].imgs,
                            jscenes[0].cam, jscenes[0].img_shapes)
    variables = materialize(struct, seed=2)
    rng = np.random.default_rng(11)
    # a nonzero R-CNN box head (see test_torch_port_train.step_pair)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, x: rng.normal(0, 0.01, x.shape).astype(np.float32)
        if 'fc_reg' in jax.tree_util.keystr(path) else x, variables)
    first, second = numpy_draws(rng, tc), numpy_draws(rng, tc)
    # one grid mask and DN noise for both scenes (JAX traces one scene's
    # program), each its own sampler draws
    draws = [first, dict(first, rpn_u=second['rpn_u'],
                         rcnn_u=second['rcnn_u'])]

    key = jax.random.PRNGKey(7)
    keep = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    tx = optax.chain(
        optax.multi_transform(
            {'frozen': optax.set_to_zero(), 'backbone': optax.identity(),
             'default': optax.identity()}, _label_params),
        keep, optax.clip_by_global_norm(35.0), keep, optax.set_to_zero())
    mesh = make_mesh(n_devices=2)
    state = jts.init_train_state(jm, jax.tree.map(jnp.array, variables), tx)
    batch = shard_batch(mesh, jax.tree.map(lambda *xs: jnp.stack(xs),
                                           *jscenes))
    with jax_draws_pinned(tc.num_views,
                          list(zip(jax.random.split(key, 2), draws))):
        step = make_dp_train_step(jm, tx, mesh, mixed_precision=False)
        state, jmetrics = step(state, batch, key)
    jmetrics = {k: float(v) for k, v in jmetrics.items()}
    zeros = jax.tree.map(np.zeros_like, variables['constants'])
    raw_sd, step_sd = (state_dict_from_jax(
        jax.tree.map(np.asarray, jax.device_get(state.opt_state[i])), zeros)
        for i in (1, 3))

    sd = state_dict_from_jax(variables['params'], variables['constants'])
    tm = TMV2D(tc)
    tm.load_state_dict({k: t(v) for k, v in sd.items()}, strict=True)
    opt = make_optimizer(tm, total_steps=10, clip_norm=35.0)
    gens = [torch.Generator().manual_seed(i) for i in (0, 1)]
    pinned = {id(g): torch_draws(d) for g, d in zip(gens, draws)}
    monkeypatch.setattr(tdist, 'draw_train', lambda c, n, g: pinned[id(g)])
    got = {k: float(v) for k, v in tdist.dp_train_step(
        tm, opt, scenes, gens, None, mixed_precision=False).items()}

    assert sorted(got) == sorted([*jmetrics, 'grad_norm', 'lr'])
    for k, v in jmetrics.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert jmetrics['rcnn_num_pos'] > 0 and jmetrics['num_queries'] > 0
    floor = 1e-5 * max(np.abs(g).max() for g in step_sd.values())
    gp, gj = [], []
    for name, prm in tm.named_parameters():
        if not prm.requires_grad:
            assert prm.grad is None and not step_sd[name].any(), name
            continue
        want, g = step_sd[name], prm.grad.numpy()
        scale = max(np.abs(want).max(), floor)
        assert np.abs(g - want).max() <= 1e-3 * scale, \
            (name, np.abs(g - want).max(), scale)
        gp.append(g.ravel().astype(np.float64))
        gj.append(want.ravel().astype(np.float64))
    gp, gj = np.concatenate(gp), np.concatenate(gj)
    assert len(gp) > 10000
    assert float(gp @ gj) / (np.linalg.norm(gp) * np.linalg.norm(gj)) > \
        1 - 1e-6
    assert 1 - 1e-4 < np.linalg.norm(gp) / np.linalg.norm(gj) < 1 + 1e-4
    raw = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                      for g in raw_sd.values()))
    assert raw > 35.0 and abs(got['grad_norm'] - raw) <= 1e-4 * raw


@pytest.fixture(scope='module')
def dp1():
    torch.set_num_threads(1)
    return tdist.dryrun_step(CPU, [0, 1])


def test_dp2_over_gloo_matches_dp1(dp1):
    dp2 = tdist.dryrun(2, 'cpu')
    m1, m2 = dp1['metrics'], dp2['metrics']
    assert sorted(m1) == sorted(m2)
    for k in m1:
        np.testing.assert_allclose(m2[k], m1[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert sorted(dp1['grads']) == sorted(dp2['grads'])
    all1, all2 = [], []
    for name, g in dp1['grads'].items():
        g1 = g.double().ravel()
        g2 = dp2['grads'][name].double().ravel()
        n1, n2 = float(g1.norm()), float(g2.norm())
        if max(n1, n2) < 1e-6:          # untouched in both runs
            continue
        assert min(n1, n2) > 0, name
        assert float(g1 @ g2) / (n1 * n2) > 1 - 1e-6, name
        assert 1 - 1e-4 < n2 / n1 < 1 + 1e-4, name
        all1.append(g1)
        all2.append(g2)
    g1, g2 = torch.cat(all1), torch.cat(all2)
    assert len(all1) > 100
    assert float(g1 @ g2) / float(g1.norm() * g2.norm()) > 1 - 1e-6
    assert 1 - 1e-4 < float(g2.norm() / g1.norm()) < 1 + 1e-4


def test_synced_normalizer_is_global_mean(dp1):
    """The dp step's bbox loss is mean(sum) / max(mean(num_pos), 1) over
    the global batch, and not the mean of the per-scene normalised losses;
    the two scenes' counts differ."""
    cfg = tdist.dryrun_config()
    torch.manual_seed(0)
    model = TMV2D(cfg)
    sums, factors = [], []
    for i in (0, 1):
        scene = tdist.dryrun_scene(cfg, i)
        g = tts.step_generator(0, 0, i, 'cpu')
        draws = tts.draw_train(cfg, scene.gt2d.boxes.shape[1], g)
        with torch.no_grad():
            _, _, d = tts.compute_losses(model, scene, draws,
                                         Dropout(cfg.dropout, g))
        sums.append({k: float(v[0]) for k, v in d.items()})
        factors.append({k: float(v[1]) for k, v in d.items()})
    gaps = []
    for k in sums[0]:
        s = [x[k] for x in sums]
        f = [x[k] for x in factors]
        want = np.mean(s) / max(np.mean(f), 1.0)
        per_scene = np.mean([a / max(b, 1.0) for a, b in zip(s, f)])
        got = dp1['metrics'][k]
        assert abs(got - want) <= 1e-6 * want, (k, got, want)
        # E[l / n] sits 0.9-4.3% away here, 1e4 times the tolerance
        assert abs(got - want) <= 1e-3 * abs(got - per_scene), k
        assert f[0] != f[1], k
        gaps.append(abs(want - per_scene) / want)
    assert min(gaps) > 1e-3, gaps
