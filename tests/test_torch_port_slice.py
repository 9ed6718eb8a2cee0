"""The port's eval slice against the JAX package on the CPU.

One set of random weights (made with numpy from a seed, bench fixture
rules: positive BN variances, zeroed rpn_reg / fc_reg so proposals are
anchor-shaped) drives both `mv2d_tpu.models.mv2d.MV2D` and
`mv2d_tpu_torch.models.mv2d.MV2D` through `state_dict_from_jax`, at the
tiny config with DCN in stages 3-4.  Everything runs in float32; the JAX
side runs its XLA paths (what it runs on the CPU).

Tolerances: float32 end to end, where the two frameworks differ only in
summation order (measured ~2e-5 on the merged boxes): scores to 1e-4,
decoded 3D boxes to 2e-3 absolute on valid slots, labels and validity
exact.  k_max is cut to 40 so the key cap binds.  Discrete
steps (top-k, NMS, the key gather) are compared on valid slots only.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu import configs as jcfgs                    # noqa: E402
from mv2d_tpu.core.geometry import prepare_camera_params as j_cam  # noqa
from mv2d_tpu.models.mv2d import MV2D as JMV2D           # noqa: E402
from mv2d_tpu.train.checkpoint import convert_torch_state_dict  # noqa: E402
from mv2d_tpu_torch import configs as tcfgs              # noqa: E402
from mv2d_tpu_torch.core.geometry import prepare_camera_params as t_cam  # noqa
from mv2d_tpu_torch.models.mv2d import MV2D as TMV2D     # noqa: E402
from mv2d_tpu_torch.synthetic import camera_rig          # noqa: E402
from mv2d_tpu_torch.weights import state_dict_from_jax   # noqa: E402

DCN = (False, False, True, True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfgs(**kw):
    """(jax cfg, torch cfg) of the tiny config, by default with DCN in
    stages 3-4."""
    kw.setdefault('stage_with_dcn', DCN)
    return jcfgs.tiny(**kw), tcfgs.tiny(**kw)


def materialize(struct, seed=0):
    """Numpy random weights over a JAX variable structure."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        p = '/'.join(str(getattr(k, 'key', k)) for k in path)
        name = p.rsplit('/', 1)[-1]
        if name == 'var':
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == 'mean':
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        if 'rpn_reg' in p or 'fc_reg' in p:
            return np.zeros(s.shape, np.float32)
        if name == 'scale':
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == 'bias':
            std = 0.3 if 'conv_offset' in p else 0.05
            return rng.normal(0, std, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        std = 0.01 if 'conv_offset' in p else 1.0 / np.sqrt(fan_in)
        return rng.normal(0, std, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, struct)


def build(seed=0, **cfg_kw):
    """JAX and torch MV2D with the same weights, plus one scene's inputs."""
    jc, tc = tiny_cfgs(**cfg_kw)
    V = jc.total_views
    K, E = camera_rig(V, jc.image_size)
    ts = [0.0] * jc.num_views + [0.5] * (V - jc.num_views)
    jcam = j_cam(K, E, timestamps=ts)
    tcam = t_cam(K, E, timestamps=ts, device='cpu')
    rng = np.random.default_rng(seed + 1)
    imgs = rng.normal(size=(V, *jc.image_size, 3)).astype(np.float32)
    shapes = np.asarray([[*jc.image_size]] * V)
    shapes[-1] = [jc.image_size[0] - 8, jc.image_size[1] - 16]
    jm = JMV2D(jc)
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.asarray(imgs), jcam, jnp.asarray(shapes))
    variables = materialize(struct, seed)
    sd = state_dict_from_jax(variables['params'], variables['constants'])
    tm = TMV2D(tc).eval()
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                       strict=True)
    return dict(jc=jc, tc=tc, jm=jm, tm=tm, variables=variables, sd=sd,
                jcam=jcam, tcam=tcam, imgs=imgs, shapes=shapes)


@pytest.fixture(scope='module')
def built():
    torch.set_num_threads(1)
    return build(k_max=40)


def test_configs_mirror_jax():
    for name in ('mv2d_t_r50', 'mv2d_t_r101', 'mv2d_s_r50', 'mv2d_t_v99',
                 'tiny'):
        j = getattr(jcfgs, name)()._asdict()
        t = getattr(tcfgs, name)()._asdict()
        assert list(j) == list(t)
        for k in j:
            jv, tv = j[k], t[k]
            if hasattr(jv, '_asdict'):
                jv, tv = jv._asdict(), tv._asdict()
            assert jv == tv, (name, k, jv, tv)


def test_state_dict_round_trip(built):
    """convert_torch_state_dict(state_dict_from_jax(p, c)) gives back
    every JAX leaf exactly, with no unmatched key."""
    params, constants = convert_torch_state_dict(built['sd'])
    assert params.pop('_unmatched') == 0, params['_unmatched_keys']
    params.pop('_unmatched_keys')
    want = {'params': built['variables']['params'],
            'constants': built['variables']['constants']}
    got = {'params': params, 'constants': constants}
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    # the converter files the BN counters (num_batches_tracked, which the
    # port's state dict carries for strict loading) as extra leaves
    extra = set(flat_g) - {p for p, _ in flat_w}
    assert all(p[-1].key == 'num_batches_tracked' for p in extra), extra
    for path, w in flat_w:
        g = np.asarray(flat_g[path])
        w = np.asarray(w)
        # the converter hands the DCN tap kernel back as HWIO [3, 3, C, F];
        # the JAX parameter is [9, C, F] (the same array, reshaped)
        if g.shape != w.shape:
            assert g.ndim == 4 and w.ndim == 3, path
            g = g.reshape(w.shape)
        assert np.array_equal(g, w), path


def test_mv2d_forward_matches_jax(built):
    b = built
    jout = jax.jit(b['jm'].apply)(b['variables'], jnp.asarray(b['imgs']),
                                  b['jcam'], jnp.asarray(b['shapes']))
    jboxes, jscores, jlabels, jvalid = (np.asarray(x) for x in jout)
    with torch.no_grad():
        t = b['tm'](torch.from_numpy(b['imgs']), b['tcam'],
                    torch.from_numpy(b['shapes']))
    assert np.array_equal(t.valid.numpy(), jvalid)
    assert jvalid.sum() > 0
    v = jvalid
    assert np.abs(t.scores.numpy()[v] - jscores[v]).max() < 1e-4
    assert np.array_equal(t.labels.numpy()[v], jlabels[v])
    assert np.abs(t.boxes.numpy()[v] - jboxes[v]).max() < 2e-3
    # k_max=40 < the 48 feature pixels: the cap binds and is counted
    d = {k: int(v) for k, v in t.diagnostics.items()}
    assert d['key_overflow'] == max(d['key_active'] - 40, 0) > 0, d


def test_port_imports_without_jax():
    """Every mv2d_tpu_torch module imports with jax and flax blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import mv2d_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    mv2d_tpu_torch.__path__, 'mv2d_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "assert not any(m.startswith('mv2d_tpu.') for m in sys.modules)\n"
        "print(' '.join(names))\n")
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    assert len(names) >= 15
    for m in ('train.train_step', 'train.optim', 'train.losses',
              'train.detector2d_loss', 'core.matching', 'ops.grid_mask',
              'ops.focal_loss', 'tools.common', 'tools.serve',
              'utils.config', 'data.padding', 'data.pipeline',
              'data.nuscenes', 'data.converter', 'eval.runner',
              'eval.nuscenes_eval', 'eval.results', 'tools.test',
              'tools.create_data', 'tools.make_synth_fixture',
              'tools.eval_e2e_bench', 'utils.native_build',
              'tools.stage_common', 'tools.stage_bench',
              'tools.detect_stage_bench', 'tools.roi_stage_bench',
              'tools.train_stage_bench', 'tools.train_bench',
              'tools.micro_bench', 'tools.misc_bench'):
        assert f'mv2d_tpu_torch.{m}' in names, m
