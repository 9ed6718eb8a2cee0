"""Online serving harness of the port: the counterpart of the repository's
`tools/serve.py`, on PyTorch.

Requests are queued and dispatched in dynamically formed batches of up to
--max-batch scenes; each scene of a batch runs the one eval forward
(`MV2D.forward`) in turn.  The model runs in bfloat16 on the GPU and in
float32 on the CPU, in inference mode.

  python -m mv2d_tpu_torch.tools.serve <config> [--checkpoint X.pth]
      [--host 127.0.0.1] [--port 8300] [--max-batch 4]
      [--batch-timeout-ms 8] [--no-warmup] [--cfg-options k=v ...]

<config> is a file under configs/mv2d/ (MV2D-T: the R50 1408x512 and R101
1600x640 files).  --checkpoint is a torch state dict with the reference's
key names (a `.pth`, optionally under 'state_dict'), loaded with
strict=True; without one the weights are `synthetic.init_random_weights`
(seed 0).  The kernel routes are read from the environment as `MV2D`
reads them (`routes.from_env`), e.g. MV2D_ALIGN_V2=1 for kernel B11.
The command serves from the GPU; `ModelRunner(..., device='cpu')` serves
from the CPU.

Protocol (stdlib only):
  GET  /health    -> {"status": "ok"}
  GET  /metadata  -> model/preset info
  GET  /metrics   -> request counts + latency stats (ms)
  POST /predict   -> body: .npz with arrays
        images      [V, H, W, 3] float  (normalized, view-major)
        intrinsics  [V, 4, 4]
        extrinsics  [V, 4, 4]  (lidar->cam)
        timestamps  [V]        (optional, zeros if absent)
      response: .npz with boxes_3d [N, 9], scores_3d [N], labels_3d [N],
      valid [N]  (fixed N = cfg.max_per_scene slots; filter by `valid`).
  A request that fails (a bad shape, an error in its batch) gets 400.
"""
from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..core.geometry import prepare_camera_params
from ..routes import Routes
from ..synthetic import camera_rig
from .common import (build_model, device_and_dtype, load_cli_config,
                     load_weights)


class _Request:
    __slots__ = ('arrays', 'event', 'result', 'error', 't_enqueue')

    def __init__(self, arrays):
        self.arrays = arrays
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t_enqueue = time.perf_counter()


class ModelRunner:
    """Owns the model and the batching dispatcher thread."""

    def __init__(self, cfg: dict, checkpoint: Optional[str], max_batch: int,
                 batch_timeout_ms: float, warmup: bool = True,
                 device: str = 'cuda', routes: Optional[Routes] = None):
        self.device, self.dtype = device_and_dtype(device)
        model = load_weights(build_model(cfg, routes), checkpoint)
        self.model = model.eval().to(self.device, self.dtype)
        mc = self.mc = model.cfg
        V = mc.total_views
        self.max_batch = max(1, max_batch)
        self.batch_timeout = batch_timeout_ms / 1e3
        self.queue: queue.Queue[Optional[_Request]] = queue.Queue()
        self.metrics = {'requests': 0, 'errors': 0, 'batches': 0,
                        'latency_ms': []}
        self._metrics_lock = threading.Lock()
        if warmup:
            K, E = camera_rig(V, mc.image_size)
            ts = [0.0] * mc.num_views + [0.5] * (V - mc.num_views)
            zeros = np.zeros((V, *mc.image_size, 3), np.float32)
            with torch.inference_mode():
                self._run_batch([self.inputs(dict(
                    images=zeros, intrinsics=K, extrinsics=E,
                    timestamps=np.asarray(ts)))])
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._dispatcher.start()

    # ------------------------------------------------------------ batching

    def _run_batch(self, samples):
        outs = []
        for imgs, cam, shapes in samples:
            det = self.model(imgs, cam, shapes)
            outs.append(dict(
                boxes_3d=det.boxes.float().cpu().numpy(),
                scores_3d=det.scores.float().cpu().numpy(),
                labels_3d=det.labels.cpu().numpy(),
                valid=det.valid.cpu().numpy()))
        return outs

    def _dispatch_loop(self):
        # grad mode is per thread: this thread enters inference mode itself
        with torch.inference_mode():
            while True:
                first = self.queue.get()
                if first is None:
                    return
                batch = [first]
                deadline = time.perf_counter() + self.batch_timeout
                while len(batch) < self.max_batch:
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    try:
                        nxt = self.queue.get(timeout=left)
                    except queue.Empty:
                        break
                    if nxt is None:
                        self.queue.put(None)
                        break
                    batch.append(nxt)
                self._serve(batch)

    def _serve(self, batch):
        try:
            samples = [self.inputs(r.arrays) for r in batch]
            outs = self._run_batch(samples)
            now = time.perf_counter()
            for r, out in zip(batch, outs):
                r.result = out
                r.event.set()
            with self._metrics_lock:
                self.metrics['batches'] += 1
                self.metrics['latency_ms'].extend(
                    (now - r.t_enqueue) * 1e3 for r in batch)
                del self.metrics['latency_ms'][:-1000]
        except Exception as e:  # noqa: BLE001 - report to every client
            for r in batch:
                r.error = f'{type(e).__name__}: {e}'
                r.event.set()
            with self._metrics_lock:
                self.metrics['errors'] += len(batch)

    def inputs(self, arrays):
        """A request's arrays -> (images, cameras, image shapes) on the
        model's device, as the forward takes them; a bad shape raises."""
        mc = self.mc
        V = mc.total_views
        imgs = np.asarray(arrays['images'], np.float32)
        if imgs.shape != (V, *mc.image_size, 3):
            raise ValueError(
                f'images must be [{V}, {mc.image_size[0]}, '
                f'{mc.image_size[1]}, 3], got {list(imgs.shape)}')
        intr = np.asarray(arrays['intrinsics'], np.float64)
        extr = np.asarray(arrays['extrinsics'], np.float64)
        ts = np.asarray(arrays.get('timestamps', np.zeros(V)), np.float64)
        cam = prepare_camera_params(intr, extr, timestamps=list(ts),
                                    device=self.device)
        shapes = torch.tensor([[*mc.image_size]] * V, device=self.device)
        return (torch.from_numpy(imgs).to(self.device, self.dtype), cam,
                shapes)

    # ------------------------------------------------------------- client

    def predict(self, arrays, timeout=120.0):
        req = _Request(arrays)
        with self._metrics_lock:
            self.metrics['requests'] += 1
        self.queue.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError('inference timed out')
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    def snapshot_metrics(self):
        with self._metrics_lock:
            lat = sorted(self.metrics['latency_ms'])
            pct = (lambda p: round(lat[min(len(lat) - 1,
                                           int(p * len(lat)))], 2)
                   if lat else None)
            return {
                'requests': self.metrics['requests'],
                'errors': self.metrics['errors'],
                'batches': self.metrics['batches'],
                'latency_ms_p50': pct(0.50),
                'latency_ms_p90': pct(0.90),
                'latency_ms_p99': pct(0.99),
            }

    def close(self):
        """Stop the dispatcher thread after the requests queued before."""
        self.queue.put(None)
        self._dispatcher.join()


def make_handler(runner: ModelRunner, meta: dict):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body: bytes, ctype='application/json'):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, obj):
            self._send(code, json.dumps(obj).encode())

        def do_GET(self):
            if self.path == '/health':
                self._json(200, {'status': 'ok'})
            elif self.path == '/metadata':
                self._json(200, meta)
            elif self.path == '/metrics':
                self._json(200, runner.snapshot_metrics())
            else:
                self._json(404, {'error': 'not found'})

        def do_POST(self):
            if self.path != '/predict':
                self._json(404, {'error': 'not found'})
                return
            try:
                n = int(self.headers.get('Content-Length', 0))
                arrays = dict(np.load(io.BytesIO(self.rfile.read(n)),
                                      allow_pickle=False))
                out = runner.predict(arrays)
            except Exception as e:  # noqa: BLE001
                self._json(400, {'error': f'{type(e).__name__}: {e}'})
                return
            buf = io.BytesIO()
            np.savez(buf, **out)
            self._send(200, buf.getvalue(), 'application/x-npz')

    return Handler


def metadata(cfg: dict, runner: ModelRunner) -> dict:
    mc = runner.mc
    return {'preset': cfg['model'].get('preset'),
            'views': mc.total_views, 'image_size': list(mc.image_size),
            'classes': mc.num_classes, 'max_per_scene': mc.max_per_scene,
            'max_batch': runner.max_batch}


def main():
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=8300)
    p.add_argument('--max-batch', type=int, default=4)
    p.add_argument('--batch-timeout-ms', type=float, default=8.0)
    p.add_argument('--no-warmup', action='store_true')
    p.add_argument('--cfg-options', nargs='*', default=None)
    args = p.parse_args()

    cfg = load_cli_config(args.config, args.cfg_options)
    runner = ModelRunner(cfg, args.checkpoint, args.max_batch,
                         args.batch_timeout_ms, warmup=not args.no_warmup)
    from http.server import ThreadingHTTPServer
    srv = ThreadingHTTPServer((args.host, args.port),
                              make_handler(runner, metadata(cfg, runner)))
    print(f'serving on http://{args.host}:{srv.server_address[1]} '
          f'(max batch {runner.max_batch}, {runner.device})', flush=True)
    srv.serve_forever()


if __name__ == '__main__':
    main()
