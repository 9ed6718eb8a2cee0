"""The port's data pipeline against the JAX package's, on the CPU.

The same seeded numpy inputs (and the same `np.random.Generator` state)
go through `mv2d_tpu.data.*` and `mv2d_tpu_torch.data.*`:
  * the host transforms (`pipeline`): equal exactly, both being numpy;
  * the C++ pool: the port's `[V, H, W, 3]` images equal the JAX pool's
    space-to-depth images unfolded, exactly (the same arithmetic), and
    within the JAX package's own 0.05 mean of the numpy path
    (`tests/test_data.py`); a failed build raises;
  * `NuScenesDataset.get_sample`, train and test mode, one and two frames,
    with and without sweeps, every key: images exact (test mode against
    the JAX images unfolded), matrices and GT within 1e-12;
  * `to_train_batch` / `to_eval_inputs` against JAX's `s2d=False` forms:
    `CameraParams` within 1e-6 in float32, images and GT exact;
  * the converter (`create_infos`, `export_2d_annotations`) on the raw
    tables of `tests/test_converter.py`, deeply equal;
  * the synthetic fixture tool against the repository's, byte for byte.
"""
import json
import os
import pickle
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from mv2d_tpu.data import converter as jcv                # noqa: E402
from mv2d_tpu.data import nuscenes as jnusc               # noqa: E402
from mv2d_tpu.data import pipeline as jpl                 # noqa: E402
from mv2d_tpu.data.padding import s2d_unfold_images       # noqa: E402
from mv2d_tpu.utils import native_build as jnb            # noqa: E402
from mv2d_tpu_torch.data import converter as tcv          # noqa: E402
from mv2d_tpu_torch.data import nuscenes as tnusc         # noqa: E402
from mv2d_tpu_torch.data import padding as tpad           # noqa: E402
from mv2d_tpu_torch.data import pipeline as tpl           # noqa: E402
from mv2d_tpu_torch.utils import native_build as tnb      # noqa: E402
from tests.test_converter import _fake_tables             # noqa: E402
from tests.test_data import _fake_nuscenes                # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINAL = (64, 96)


def jax_pool_ready():
    """Loads the JAX package's C++ pool.  Its build step has no file lock, so
    another test process may be linking the library right now: retry
    until it loads."""
    for _ in range(60):
        if jpl._load_native():
            return
        jpl._native = None
        jnb._attempted = False
        time.sleep(1)
    pytest.fail("the JAX package's C++ pool did not build")


def assert_deep_equal(a, b, path='', atol=0.0):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_deep_equal(a[k], b[k], f'{path}.{k}', atol)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_deep_equal(x, y, f'{path}[{i}]', atol)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if atol and a.dtype.kind == 'f':
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


# ------------------------------------------------------------ transforms

IDA = dict(final_dim=FINAL, H=90, W=160, resize_lim=(0.7, 1.1),
           bot_pct_lim=(0.0, 0.2), rot_lim=(-5.0, 5.0))


@pytest.mark.parametrize('training', [False, True])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_ida_and_boxes_match_jax(training, seed):
    """sample_ida (the same draws), ida_matrix, apply_ida_image /
    _intrinsics and transform_boxes_2d (with flips and rotations) equal
    exactly."""
    jp = jpl.sample_ida(np.random.default_rng(seed),
                        jpl.IdaAugConfig(**IDA), training)
    tp = tpl.sample_ida(np.random.default_rng(seed),
                        tpl.IdaAugConfig(**IDA), training)
    assert jp.__dict__ == tp.__dict__
    np.testing.assert_array_equal(tpl.ida_matrix(tp), jpl.ida_matrix(jp))
    rng = np.random.default_rng(10 + seed)
    img = rng.uniform(0, 255, (90, 160, 3)).astype(np.float32)
    np.testing.assert_array_equal(tpl.apply_ida_image(img, tp),
                                  jpl.apply_ida_image(img, jp))
    K = np.eye(4)
    K[:3, :3] = [[100.0, 0, 80], [0, 100.0, 45], [0, 0, 1]]
    np.testing.assert_array_equal(tpl.apply_ida_intrinsics(K, tp),
                                  jpl.apply_ida_intrinsics(K, jp))
    xy = rng.uniform(0, 140, (12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 60, (12, 2))], 1)
    for flip in (False, True):
        tp.flip = jp.flip = flip
        tb, tk = tpl.transform_boxes_2d(boxes, tp)
        jb, jk = jpl.transform_boxes_2d(boxes, jp)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tk, jk)


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_photometric_and_bev_aug_match_jax(seed):
    """photometric_distortion and global_rot_scale from the same generator
    state: equal outputs and the generators left in the same state."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (30, 40, 3)).astype(np.float32)
    l2i = rng.normal(size=(4, 4, 4))
    ext = rng.normal(size=(4, 4, 4))
    gt = rng.normal(size=(5, 9)).astype(np.float32)
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        np.testing.assert_array_equal(
            tpl.photometric_distortion(tr, img),
            jpl.photometric_distortion(jr, img))
    for t, j in zip(tpl.global_rot_scale(tr, l2i, ext, gt),
                    jpl.global_rot_scale(jr, l2i, ext, gt)):
        np.testing.assert_array_equal(t, j)
    assert tr.random() == jr.random()


def test_small_transforms_match_jax():
    """normalize_image, pad_to_divisor, pad_to (pad, truncate, equal) and
    the multi-scale center crops."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (45, 70, 3)).astype(np.float32)
    np.testing.assert_array_equal(tpl.normalize_image(img),
                                  jpl.normalize_image(img))
    np.testing.assert_array_equal(tpl.pad_to_divisor(img, 32),
                                  jpl.pad_to_divisor(img, 32))
    from mv2d_tpu.data.padding import pad_to
    a = rng.normal(size=(5, 3))
    for size, axis, value in ((8, 0, -1), (3, 0, 0), (5, 0, 0), (6, 1, 2)):
        for t, j in zip(tpad.pad_to(a, size, axis, value),
                        pad_to(a, size, axis, value)):
            np.testing.assert_array_equal(t, j)
    cfg = dict(final_dim=(32, 48), H=45, W=70)
    jp = jpl.ms_center_crop_params(0.6, jpl.IdaAugConfig(**cfg))
    tp = tpl.ms_center_crop_params(0.6, tpl.IdaAugConfig(**cfg))
    assert jp.__dict__ == tp.__dict__
    K = [np.eye(4)] * 2
    out_t = tpl.ms_resize_crop_flip([img, img], K, K, [0.0, 0.1], tp,
                                    tpl.IdaAugConfig(**cfg))
    out_j = jpl.ms_resize_crop_flip([img, img], K, K, [0.0, 0.1], jp,
                                    jpl.IdaAugConfig(**cfg))
    for t, j in zip(out_t, out_j):
        assert len(t) == len(j) == 3
        for x, y in zip(t, j):
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------- the pool

@pytest.mark.parametrize('flip', [False, True])
@pytest.mark.parametrize('geom', [(0.5, (80, 45), (2, 0, 66, 40)),
                                  (0.8, (128, 72), (10, 7, 106, 71))])
def test_pool_equals_jax_pool_unfolded(flip, geom):
    jax_pool_ready()
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (90, 160, 3)).astype(np.uint8)
            for _ in range(3)]
    p = tpl.IdaParams(geom[0], geom[1], geom[2], flip, 0.0)
    calls = tpl.native_preprocess.calls
    got = tpl.native_preprocess(imgs, p)
    assert tpl.native_preprocess.calls == calls + 1
    want = jpl.native_preprocess(imgs, jpl.IdaParams(*p.__dict__.values()),
                                 s2d=True)
    np.testing.assert_array_equal(got, s2d_unfold_images(want))
    ref = tpl.normalize_image(tpl.apply_ida_image(
        imgs[0].astype(np.float32), p))
    assert got.shape == (3, *ref.shape)
    assert np.abs(got[0] - ref).mean() < 0.05


def test_pool_refuses_rotation_and_failed_build_raises(tmp_path,
                                                       monkeypatch):
    img = np.zeros((90, 160, 3), np.uint8)
    with pytest.raises(ValueError):
        tpl.native_preprocess([img], tpl.IdaParams(0.5, (80, 45),
                                                   (0, 0, 64, 40), False,
                                                   3.0))
    monkeypatch.setattr(tnb, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(tnb, 'CXX_FLAGS', ['-no-such-flag'])
    with pytest.raises(RuntimeError, match='failed'):
        tnb.ensure_built()


# -------------------------------------------------------------- dataset

def _with_sweeps(info_path, n_sweeps=5, explicit=False):
    """The fake infos with `n_sweeps` historical camera frames a sample
    (yawed 0.05 rad a frame; with `explicit` their matrices given as
    intrinsics / extrinsics, as the converter writes them)."""
    with open(info_path, 'rb') as f:
        data = pickle.load(f)
    for info in data['infos']:
        sweeps = []
        for k in range(n_sweeps):
            a = 0.05 * (k + 1)
            R = np.asarray([[np.cos(a), -np.sin(a), 0],
                            [np.sin(a), np.cos(a), 0], [0, 0, 1]])
            sweep = {}
            for cam, ci in info['cams'].items():
                s = dict(ci, timestamp=ci['timestamp'] - 0.1e6 * (k + 1),
                         sensor2lidar_rotation=R,
                         sensor2lidar_translation=np.asarray([0.1 * k, 0,
                                                              0]))
                if explicit:
                    Kp, E = jnusc.build_view_matrices(s)
                    s['intrinsics'], s['extrinsics'] = Kp, E
                sweep[cam] = s
            sweeps.append(sweep)
        info['sweeps'] = sweeps
    out = info_path.replace('.pkl', f'_sweeps{int(explicit)}.pkl')
    with open(out, 'wb') as f:
        pickle.dump(data, f)
    return out


@pytest.fixture(scope='module')
def fake(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('fake_nusc'))
    info, coco = _fake_nuscenes(d, n_samples=2, n_gt=3)
    return dict(none=info, sweeps=_with_sweeps(info),
                explicit=_with_sweeps(info, explicit=True), coco=coco)


def _datasets(fake, sweeps, frames, test_mode, native=True):
    args = dict(info_path=fake[sweeps], ann2d_path=fake['coco'],
                num_frames=frames, sweep_range=(1, 4), test_mode=test_mode,
                final_dim=FINAL)
    return (jnusc.NuScenesDataset(ida=jpl.IdaAugConfig(
                final_dim=FINAL, H=90, W=160), **args),
            tnusc.NuScenesDataset(ida=tpl.IdaAugConfig(
                final_dim=FINAL, H=90, W=160), native=native, **args))


CASES = [('none', 1, False), ('none', 1, True), ('none', 2, False),
         ('none', 2, True), ('sweeps', 2, False), ('sweeps', 2, True),
         ('explicit', 2, False), ('explicit', 2, True)]


@pytest.mark.parametrize('sweeps,frames,test_mode', CASES)
def test_get_sample_matches_jax(fake, sweeps, frames, test_mode):
    jax_pool_ready()
    jds, tds = _datasets(fake, sweeps, frames, test_mode)
    for idx in range(len(jds)):
        jr, tr = np.random.default_rng(idx), np.random.default_rng(idx)
        j, t = jds.get_sample(idx, jr), tds.get_sample(idx, tr)
        assert set(j) == set(t)
        V = 6 * frames
        assert t['imgs'].shape == (V, *FINAL, 3)
        want = j['imgs']
        if test_mode:       # the JAX pool writes space-to-depth images
            assert want.shape == (V, FINAL[0] // 2, FINAL[1] // 2, 12)
            want = s2d_unfold_images(want)
        np.testing.assert_array_equal(t['imgs'], want)
        assert t['token'] == j['token']
        for k in set(j) - {'imgs', 'token'}:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-12,
                                       err_msg=k)
        assert tr.random() == jr.random()
        if not test_mode:
            assert t['gt3d_valid'].sum() == 3 and t['gt2d_valid'].any()


def test_numpy_path_is_chosen_explicitly(tmp_path):
    """native=False runs the pool's plain version: on a rendered scene
    (source 800x450, resized by 0.88 as 1600x900 is to 1408 wide), within
    the JAX package's 0.05 mean of the pool; the pool counts only its own
    calls."""
    from mv2d_tpu_torch.tools.make_synth_fixture import make_fixture
    paths = make_fixture(str(tmp_path), scenes=0, val_scenes=1, objects=6,
                         image_h=450, image_w=800)
    final = (220, 704)
    ds = [tnusc.NuScenesDataset(
        info_path=paths['val_info'], ann2d_path=paths['val_coco'],
        num_frames=2, test_mode=True, final_dim=final, native=native,
        ida=tpl.IdaAugConfig(final_dim=final, H=450, W=800))
        for native in (True, False)]
    calls = tpl.native_preprocess.calls
    a = ds[0].get_sample(0)['imgs']
    assert tpl.native_preprocess.calls == calls + 1
    b = ds[1].get_sample(0)['imgs']
    assert tpl.native_preprocess.calls == calls + 1
    assert a.shape == b.shape == (12, *final, 3)
    assert np.abs(a - b).mean() < 0.05


@pytest.mark.parametrize('frames', [1, 2])
def test_collation_matches_jax(fake, frames):
    """to_eval_inputs and to_train_batch against JAX's s2d=False forms."""
    jax_pool_ready()
    _, tds = _datasets(fake, 'sweeps', frames, True)
    s = tds.get_sample(1)
    j_imgs, j_cam, j_shapes = jnusc.to_eval_inputs(s, s2d=False)
    t_imgs, t_cam, t_shapes = tnusc.to_eval_inputs(s, 'cpu')
    np.testing.assert_array_equal(t_imgs.numpy(), np.asarray(j_imgs))
    np.testing.assert_array_equal(t_shapes.numpy(), np.asarray(j_shapes))

    def same_cam(t, j):
        for name in ('intrinsics', 'extrinsics', 'lidar2img', 'img2lidar',
                     'ext_t_inv', 'trans_mats', 'timestamps'):
            a, b = getattr(t, name), np.asarray(getattr(j, name))
            assert a.dtype == torch.float32 and a.shape == b.shape, name
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    same_cam(t_cam, j_cam)
    bf = tnusc.to_eval_inputs(s, 'cpu', torch.bfloat16)[0]
    assert torch.equal(bf, t_imgs.to(torch.bfloat16))

    _, tds = _datasets(fake, 'sweeps', frames, False)
    s = tds.get_sample(0, np.random.default_rng(3))
    jb = jnusc.to_train_batch(s, s2d=False)
    tb = tnusc.to_train_batch(s, 'cpu')
    np.testing.assert_array_equal(tb.imgs.numpy(), np.asarray(jb.imgs))
    same_cam(tb.cam, jb.cam)
    for part in ('gt2d', 'gt3d'):
        for name in ('boxes', 'labels', 'valid'):
            a = getattr(getattr(tb, part), name)
            b = np.asarray(getattr(getattr(jb, part), name))
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert tb.gt3d.labels.dtype == tb.gt2d.labels.dtype == torch.int64


def test_infos_coco_and_helpers_match_jax(fake, tmp_path):
    """load_infos (also spilled to one pkl a sample), Coco2D,
    center_match and build_view_matrices."""
    for sep in (False, True):
        info = str(tmp_path / f'infos{int(sep)}.pkl')
        with open(fake['sweeps'], 'rb') as f:
            data = f.read()
        with open(info, 'wb') as f:
            f.write(data)
        t = tnusc.load_infos(info, load_separate=sep)
        j = jnusc.load_infos(info, load_separate=sep)
        assert_deep_equal(t, j)
    tc, jc = tnusc.Coco2D(fake['coco']), jnusc.Coco2D(fake['coco'])
    assert tc.cat_to_label == jc.cat_to_label
    for name in list(jc.img_by_file)[:3] + ['missing.jpg']:
        for a, b in zip(tc.anns_for_image(name), jc.anns_for_image(name)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 3))
    b = np.concatenate([a[[2, 0]] + 1e-4, rng.normal(size=(3, 3))])
    np.testing.assert_array_equal(tnusc.center_match(a, b),
                                  jnusc.center_match(a, b))
    ci = tnusc.load_infos(fake['none'])[0]['cams']['CAM_BACK']
    for x, y in zip(tnusc.build_view_matrices(ci),
                    jnusc.build_view_matrices(ci)):
        np.testing.assert_array_equal(x, y)


def test_prefetcher_yields_every_scene_and_raises(fake):
    _, tds = _datasets(fake, 'none', 1, True)
    pf = tnusc.Prefetcher(tds, [0, 1, 0, 1, 1], num_threads=2)
    got = sorted(idx for idx, _ in pf)
    pf.close()
    assert got == [0, 0, 1, 1, 1] and len(pf.sample_seconds) == 5

    class Broken:
        def get_sample(self, idx, rng):
            raise KeyError(idx)
    pf = tnusc.Prefetcher(Broken(), [0, 1, 2], num_threads=2)
    with pytest.raises(KeyError):
        list(pf)
    assert not any(t.is_alive() for t in pf.threads)


# ------------------------------------------------------------ converter

def test_converter_matches_jax(tmp_path):
    root = _fake_tables(str(tmp_path), n_samples=3)
    for kw in (dict(max_sweeps=2), dict(max_sweeps=1, sweep_cam_stride=2),
               dict(scene_names={'scene-0001'})):
        t = tcv.create_infos(root, 'v1.0-mini', **kw)
        j = jcv.create_infos(root, 'v1.0-mini', **kw)
        assert len(t) == 3
        assert_deep_equal(t, j)
        assert_deep_equal(tcv.export_2d_annotations(t),
                          jcv.export_2d_annotations(j))
    tcv.save_infos(str(tmp_path / 't.pkl'), t, metadata=dict(version='x'))
    jcv.save_infos(str(tmp_path / 'j.pkl'), j, metadata=dict(version='x'))
    with open(tmp_path / 't.pkl', 'rb') as f, \
            open(tmp_path / 'j.pkl', 'rb') as g:
        assert_deep_equal(pickle.load(f), pickle.load(g))


# ---------------------------------------------------------- the fixture

def test_synth_fixture_matches_repository_tool(tmp_path):
    """The port's make_synth_fixture writes the same infos, COCO json and
    JPEG bytes as the repository's tool for one seed."""
    from mv2d_tpu_torch.tools.make_synth_fixture import make_fixture
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    try:
        import make_synth_fixture as jfix
    finally:
        sys.path.remove(os.path.join(REPO, 'tools'))
    paths = {}
    for name in ('t', 'j'):
        out = str(tmp_path / name)
        os.makedirs(out)
        rng = np.random.default_rng(3)
        if name == 't':
            paths[name] = make_fixture(out, scenes=1, val_scenes=2,
                                       objects=5, image_h=90, image_w=160,
                                       seed=3)
            continue
        rigs = jfix.make_rig(90, 160)
        ti, tc = jfix.write_split(out, 'train', 1, 5, 90, 160, rigs, rng)
        vi, vc = jfix.write_split(out, 'val', 2, 5, 90, 160, rigs, rng)
        paths[name] = dict(train_info=ti, train_coco=tc, val_info=vi,
                           val_coco=vc)
    for key in ('train_info', 'val_info'):
        with open(paths['t'][key], 'rb') as f:
            t = pickle.load(f)['infos']
        with open(paths['j'][key], 'rb') as f:
            j = pickle.load(f)['infos']
        for a, b in zip(t, j):
            for cam in a['cams'].values():
                cam['data_path'] = os.path.basename(cam['data_path'])
            for cam in b['cams'].values():
                cam['data_path'] = os.path.basename(cam['data_path'])
        assert_deep_equal(t, j)
    for key in ('train_coco', 'val_coco'):
        with open(paths['t'][key]) as f, open(paths['j'][key]) as g:
            assert json.load(f) == json.load(g)
    names = sorted(os.listdir(tmp_path / 't' / 'imgs'))
    assert len(names) == 18
    assert names == sorted(os.listdir(tmp_path / 'j' / 'imgs'))
    for n in names:
        with open(tmp_path / 't' / 'imgs' / n, 'rb') as f, \
                open(tmp_path / 'j' / 'imgs' / n, 'rb') as g:
            assert f.read() == g.read(), n
    from mv2d_tpu_torch.utils.config import load_config
    cfg = load_config(paths['t']['config'])
    assert cfg['data']['val']['info_path'] == paths['t']['val_info']
    assert cfg['model']['preset'] == 'mv2d_t_r50'
