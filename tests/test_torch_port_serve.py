"""The port's serving entry point and config plumbing, on the CPU.

  * `mv2d_tpu_torch.utils.config` (`load_config`, `apply_overrides`)
    equal to the JAX package's on every file under configs/mv2d/, and
    `mv2d_tpu_torch.tools.common.build_model_config` equal field by field
    to the repository's `tools/common.py`;
  * the repository's `tests/test_serve.py` cases on the port's server
    (`mv2d_tpu_torch.tools.serve`, device='cpu'): health, metadata, an
    HTTP round trip, concurrent requests batched, a bad shape answered
    400, the metrics;
  * the JAX server's `ModelRunner` against the port's on one npz request
    of the tiny config, with the JAX runner's weights carried across by
    `state_dict_from_jax`, saved to a `.pth` and loaded by the port's
    runner as its checkpoint: the same `valid` and labels, scores within
    1e-4, boxes within 2e-3 (float32 on both sides; the forward's
    tolerances in `test_torch_port_slice.py`).
"""
import glob
import io
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402,F401

from mv2d_tpu.utils import config as jconfig             # noqa: E402
from mv2d_tpu_torch.synthetic import camera_rig          # noqa: E402
from mv2d_tpu_torch.tools import common                  # noqa: E402
from mv2d_tpu_torch.tools.serve import (ModelRunner,     # noqa: E402
                                        make_handler, metadata)
from mv2d_tpu_torch.utils import config                  # noqa: E402
from mv2d_tpu_torch.weights import state_dict_from_jax   # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CONFIGS = sorted(glob.glob(os.path.join(REPO, 'configs', 'mv2d', '*.py')))
TINY = {'model': {'preset': 'tiny', 'overrides': {'num_views': 6}}}


def jax_tools():
    """The repository's tools/ (JAX) importable as top-level modules."""
    path = os.path.join(REPO, 'tools')
    if path not in sys.path:
        sys.path.insert(0, path)


# ------------------------------------------------------------- configs

@pytest.mark.parametrize('path', CONFIGS, ids=os.path.basename)
def test_config_files_match_jax(path):
    """_base_ merging and --cfg-options overrides (a nested key, a tuple,
    a dict(...) call) as the JAX package's; the model config field by
    field as the repository's tools/common.py builds it."""
    jax_tools()
    import common as jcommon
    got, want = config.load_config(path), jconfig.load_config(path)
    assert got == want
    opts = ['model.overrides.k_max=64', 'data.val.final_dim=(256, 704)',
            'evaluation=dict(interval=1)', 'optimizer.lr=1e-4']
    got = config.apply_overrides(got, opts)
    assert got == jconfig.apply_overrides(want, opts)
    assert got['evaluation'] == {'interval': 1}
    t = common.build_model_config(got)._asdict()
    j = jcommon.build_model_config(got)._asdict()
    assert list(t) == list(j)
    for k in j:
        jv, tv = j[k], t[k]
        if hasattr(jv, '_asdict'):
            jv, tv = jv._asdict(), tv._asdict()
        assert jv == tv, (k, jv, tv)


def test_roi_key_mode_config_serves():
    """The MV2D-S file (roi key mode) builds a model whose server answers
    a request (on the CPU, at 64x96, the 3D head cut to one layer 64
    wide, the R-CNN's fcs to 64) with a direct forward's detections; the
    R101 file builds its model."""
    roi = [p for p in CONFIGS if 'single_frame_roi' in p]
    assert roi
    torch.set_num_threads(1)
    cfg = common.load_cli_config(roi[0], [
        'model.overrides.image_size=(64, 96)',
        'model.overrides.num_decoder_layers=1',
        'model.overrides.embed_dims=64',
        'model.overrides.rcnn_fc_channels=64'])
    runner = ModelRunner(cfg, checkpoint=None, max_batch=1,
                         batch_timeout_ms=1.0, warmup=False, device='cpu')
    try:
        mc = runner.mc
        assert (mc.key_mode, mc.num_frames, mc.total_views) == ('roi', 1, 6)
        arrays = dict(np.load(io.BytesIO(payload(mc, seed=3))))
        got = runner.predict(arrays)
        with torch.no_grad():
            det = runner.model(*runner.inputs(arrays))
    finally:
        runner.close()
    assert list(det.diagnostics) == ['num_queries']
    assert got['valid'].any()
    for k, t in (('boxes_3d', det.boxes), ('scores_3d', det.scores),
                 ('labels_3d', det.labels), ('valid', det.valid)):
        np.testing.assert_array_equal(got[k], t.numpy())
    cfg = common.load_cli_config(
        os.path.join(REPO, 'configs', 'mv2d',
                     'mv2d_r101_frcnn_two_frames_1600x640_ep24.py'),
        ['model.overrides.image_size=(64, 96)'])
    m = common.build_model(cfg).cfg
    assert (m.depth, m.k_max, m.image_size) == (101, 24576, (64, 96))


# -------------------------------------------------------------- server

@pytest.fixture(scope='module')
def served():
    from http.server import ThreadingHTTPServer
    torch.set_num_threads(1)
    runner = ModelRunner(TINY, checkpoint=None, max_batch=2,
                         batch_timeout_ms=200.0, warmup=False, device='cpu')
    srv = ThreadingHTTPServer(('127.0.0.1', 0),
                              make_handler(runner, metadata(TINY, runner)))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield runner, f'http://127.0.0.1:{srv.server_address[1]}'
    srv.shutdown()
    runner.close()


def payload(mc, seed=0):
    V = mc.total_views
    K, E = camera_rig(V, mc.image_size)
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    np.savez(buf,
             images=rng.normal(size=(V, *mc.image_size, 3)).astype(
                 np.float32),
             intrinsics=K, extrinsics=E, timestamps=np.zeros(V))
    return buf.getvalue()


def post(url, body, timeout=300):
    req = urllib.request.Request(url + '/predict', data=body, method='POST')
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return dict(np.load(io.BytesIO(r.read())))


def test_health_and_metadata(served):
    runner, url = served
    with urllib.request.urlopen(url + '/health') as r:
        assert json.load(r)['status'] == 'ok'
    with urllib.request.urlopen(url + '/metadata') as r:
        meta = json.load(r)
    assert meta['preset'] == 'tiny' and meta['views'] == 6
    assert meta['image_size'] == list(runner.mc.image_size)
    assert meta['max_batch'] == 2


def test_predict_http_roundtrip(served):
    runner, url = served
    out = post(url, payload(runner.mc))
    n = runner.mc.max_per_scene
    assert out['boxes_3d'].shape == (n, 9)
    assert out['scores_3d'].shape == (n,)
    assert out['labels_3d'].shape == (n,)
    assert out['valid'].shape == (n,)
    assert out['valid'].any()
    assert np.isfinite(out['boxes_3d'][out['valid'].astype(bool)]).all()


def test_concurrent_requests_batch(served):
    runner, url = served
    body = payload(runner.mc)
    before = runner.snapshot_metrics()
    results, errors = [], []

    def go():
        try:
            results.append(post(url, body))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=go) for _ in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors and len(results) == 3
    # identical inputs -> identical outputs whatever the batch packing
    for out in results[1:]:
        for k in out:
            np.testing.assert_array_equal(out[k], results[0][k])
    m = runner.snapshot_metrics()
    assert m['requests'] - before['requests'] == 3
    assert m['batches'] - before['batches'] < 3        # some were batched


def test_bad_request(served):
    runner, url = served
    buf = io.BytesIO()
    np.savez(buf, images=np.zeros((2, 8, 8, 3), np.float32),
             intrinsics=np.eye(4)[None], extrinsics=np.eye(4)[None])
    with pytest.raises(urllib.error.HTTPError) as ei:
        post(url, buf.getvalue(), timeout=60)
    assert ei.value.code == 400
    assert 'images must be' in json.load(ei.value)['error']


def test_metrics(served):
    runner, url = served
    post(url, payload(runner.mc, seed=1))
    with urllib.request.urlopen(url + '/metrics') as r:
        m = json.load(r)
    assert set(m) == {'requests', 'errors', 'batches', 'latency_ms_p50',
                      'latency_ms_p90', 'latency_ms_p99'}
    assert m['requests'] >= 1 and m['batches'] >= 1
    assert m['requests'] >= m['errors']
    assert 0 < m['latency_ms_p50'] <= m['latency_ms_p90'] \
        <= m['latency_ms_p99']


def test_runner_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError):
        ModelRunner(TINY, None, 1, 1.0, warmup=False)


# ------------------------------------------------- against the JAX server

def test_runner_matches_jax_runner(tmp_path):
    """One npz request through the JAX ModelRunner and through the port's,
    the port loading the JAX runner's weights as a .pth checkpoint."""
    jax_tools()
    from serve import ModelRunner as JaxRunner
    torch.set_num_threads(1)
    jr = JaxRunner(TINY, checkpoint=None, max_batch=1, batch_timeout_ms=1.0,
                   warmup=False)
    sd = state_dict_from_jax(jr.variables['params'],
                             jr.variables['constants'])
    path = tmp_path / 'weights.pth'
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in sd.items()}, path)
    tr = ModelRunner(TINY, checkpoint=str(path), max_batch=1,
                     batch_timeout_ms=1.0, warmup=False, device='cpu')
    arrays = dict(np.load(io.BytesIO(payload(tr.mc, seed=2))))
    want = jr.predict(arrays)
    got = tr.predict(arrays)
    tr.close()
    v = want['valid'].astype(bool)
    assert v.any()
    np.testing.assert_array_equal(got['valid'], want['valid'])
    np.testing.assert_array_equal(got['labels_3d'][v], want['labels_3d'][v])
    assert np.abs(got['scores_3d'][v] - want['scores_3d'][v]).max() < 1e-4
    assert np.abs(got['boxes_3d'][v] - want['boxes_3d'][v]).max() < 2e-3
