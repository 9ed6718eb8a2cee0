"""The program under test, `mv2d_tpu_torch`, as the benchmark drives it:
its model built from a configuration file, the inputs of `perfbench.inputs`
handed to its own entry points (`MV2D.forward`, `parallel.dist.
dp_train_step`), and the benchmark's spans and captures around the calls
into its layers.

The spans and captures wrap attributes of the model instance
(`extract_feats`, `base_detector.detect`, `roi_head_forward`, `decode`;
hooks on `roi_head.position_encoding`) and the module globals that
`dp_train_step` looks up (`dist.dp_objective`, `dist.apply_update`); no
program file is edited.  A span is (name, start ns, end ns) on
`time.time_ns()`'s clock, the clock of the profiler's events; while a
profiler runs, each span is also a `record_function` annotation.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import torch

from . import inputs


def build_config(model_cfg: dict):
    """The program's MV2DConfig from a configuration file's `model`."""
    from mv2d_tpu_torch.configs import (CorrelationConfig,
                                        DetectionProposalCfg, MV2DConfig)
    nested = {'correlation': CorrelationConfig,
              'proposal_train': DetectionProposalCfg,
              'proposal_test': DetectionProposalCfg}
    kw = {}
    for k, v in model_cfg.items():
        if k in nested:
            v = nested[k](**v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return MV2DConfig(**kw)


class Recorder:
    """What the wrappers record: spans (when `spans_on`), the current
    call's captures (when `capture` is a dict), and profiler annotations
    (when `annotate`)."""

    def __init__(self):
        self.spans: List[tuple] = []
        self.spans_on = False
        self.annotate = False
        self.capture: Optional[dict] = None

    @contextmanager
    def span(self, name: str):
        ann = torch.profiler.record_function(f'pb.{name}') \
            if self.annotate else nullcontext()
        t0 = time.time_ns()
        with ann:
            yield
        if self.spans_on:
            self.spans.append((name, t0, time.time_ns()))

    def wrap(self, name: str, fn, keep=None):
        """fn with a span; keep(capture dict, output) on captured calls."""
        def wrapped(*a, **k):
            with self.span(name):
                out = fn(*a, **k)
            if keep is not None and self.capture is not None:
                keep(self.capture, out)
            return out
        return wrapped

    def hook_module(self, name: str, module: torch.nn.Module, keep=None):
        """Span and capture of a submodule's calls by forward hooks."""
        state = {}

        def pre(mod, args):
            ann = torch.profiler.record_function(f'pb.{name}') \
                if self.annotate else None
            if ann is not None:
                ann.__enter__()
            state['t0'], state['ann'] = time.time_ns(), ann

        def post(mod, args, out):
            if state['ann'] is not None:
                state['ann'].__exit__(None, None, None)
            if self.spans_on:
                self.spans.append((name, state['t0'], time.time_ns()))
            if keep is not None and self.capture is not None:
                keep(self.capture, out)
        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)


def _host(t):
    return t.detach().to('cpu', copy=True)


def _cams(rig: inputs.Rig, device):
    from mv2d_tpu_torch.core.geometry import prepare_camera_params
    return prepare_camera_params(rig.intrinsics, rig.extrinsics,
                                 rig.timestamps, device=device)


def _model(cfg, device, dtype, seed):
    from mv2d_tpu_torch.models.mv2d import MV2D
    with torch.device(device):
        model = MV2D(cfg)
    model = model.to(device)
    w = inputs.weights(inputs.leaves_of(model), seed, device)
    model.load_state_dict(w, strict=False)
    return model.to(dtype)


class _Program:
    def counters(self) -> Dict[str, int]:
        """The program's counters (read before and after the window)."""
        from mv2d_tpu_torch.core.nms import greedy_fixpoint
        return {'nms_rounds': greedy_fixpoint.rounds}


class EvalProgram(_Program):
    """The bf16 eval forward of a pool of scenes, one at a time, each
    call ending with the scene's detections on the host."""

    def __init__(self, model_cfg: dict, traffic: dict, seed: int, device,
                 model=None, cam=None):
        """`model` and `cam` put another model (the check's control) in
        the program's place; its images are upcast to float32."""
        dtype = inputs.DTYPES[traffic['weights_dtype']]
        self.rig = inputs.rig(model_cfg, traffic)
        if model is None:
            self.model = _model(build_config(model_cfg), device, dtype,
                                seed).eval()
            self.cam = _cams(self.rig, device)
        else:
            self.model, self.cam = model, cam
        self.cfg = self.model.cfg
        self.shapes = torch.as_tensor(self.rig.img_shapes, device=device)
        self.imgs = inputs.images(model_cfg, traffic, seed, device, dtype)
        if model is not None:
            self.imgs = self.imgs.float()
        self.rec = Recorder()
        self.outputs: List[dict] = []      # every call's answer
        self._instrument()

    def _instrument(self):
        m, rec = self.model, self.rec

        def feats(c, out):
            fpn, p4 = out
            c['fpn'] = [_host(f) for f in fpn]
            c['p4'] = _host(p4)

        def detect(c, out):
            c['proposals'] = {k: _host(v) for k, v in out._asdict().items()}

        def pe(c, out):
            c['pos'] = _host(out)

        def head(c, out):
            c['cls'] = _host(out.all_cls_scores)
            c['box'] = _host(out.all_bbox_preds)
            c['query_valid'] = _host(out.query_valid)

        def head_last(out):
            self._last = (out.all_cls_scores[-1].clone(),
                          out.all_bbox_preds[-1].clone(),
                          out.query_valid.clone())
            return out

        m.extract_feats = rec.wrap('backbone', m.extract_feats, feats)
        m.base_detector.detect = rec.wrap('detect', m.base_detector.detect,
                                          detect)
        rec.hook_module('pe', m.roi_head.position_encoding, pe)
        hf = rec.wrap('head', m.roi_head_forward, head)
        m.roi_head_forward = lambda *a, **k: head_last(hf(*a, **k))
        m.decode = rec.wrap('decode', m.decode)

    def call(self, i: int, capture: Optional[dict] = None,
             keep: bool = True) -> torch.Tensor:
        """Scene i of the pool through `MV2D.forward`; its detections
        [max_per_scene, 12] (box 9, score, label, valid) on the host."""
        self.rec.capture = capture
        j = i % self.imgs.shape[0]
        det = self.model(self.imgs[j], self.cam, self.shapes)
        ans = torch.cat([det.boxes.float(), det.scores.float()[:, None],
                         det.labels.float()[:, None],
                         det.valid.float()[:, None]], 1).cpu()
        self.rec.capture = None
        if keep:
            cls, box, qv = self._last
            self.outputs.append(dict(scene=j, answer=ans, cls=cls, box=box,
                                     query_valid=qv))
        return ans

    def free(self):
        self.outputs = [{k: (v.cpu() if torch.is_tensor(v) else v)
                         for k, v in o.items()} for o in self.outputs]
        del self.model, self.imgs


class TrainProgram(_Program):
    """`dp_train_step` on one scene a step (group None, mixed precision),
    the model and its AdamW built once; the first `check_steps` steps are
    set-up and are what the reference follows."""
    _keep_step = None           # set while `discrete` is open

    def __init__(self, model_cfg: dict, traffic: dict, seed: int, device):
        from mv2d_tpu_torch.models.mv2d import GroundTruth2D, GroundTruth3D
        from mv2d_tpu_torch.train.optim import make_optimizer
        from mv2d_tpu_torch.train.train_step import TrainBatch
        self.cfg = build_config(model_cfg)
        self.seed, self.device = seed, device
        self.mixed = traffic.get('mixed_precision', True)
        self.model = _model(self.cfg, device, torch.float32, seed).train()
        o = traffic['optimizer']
        self.opt = make_optimizer(
            self.model, base_lr=o['base_lr'], total_steps=o['total_steps'],
            weight_decay=o['weight_decay'],
            backbone_lr_mult=o['backbone_lr_mult'],
            clip_norm=o['clip_norm'])
        self.rig = inputs.rig(model_cfg, traffic)
        cam = _cams(self.rig, device)
        shapes = torch.as_tensor(self.rig.img_shapes, device=device)
        imgs = inputs.images(model_cfg, traffic, seed, device,
                             torch.float32)
        self.scenes = [TrainBatch(
            imgs=imgs[i], cam=cam, img_shapes=shapes,
            gt2d=GroundTruth2D(b.boxes2d, b.labels2d, b.valid2d),
            gt3d=GroundTruth3D(b.boxes3d, b.labels3d, b.valid3d))
            for i, b in enumerate(inputs.boxes(model_cfg, traffic, seed,
                                               device))]
        self.rec = Recorder()
        self.step_no = 0
        self._instrument()

    def _instrument(self):
        from mv2d_tpu_torch.parallel import dist
        rec = self.rec
        self._dist = dist
        self._saved = (dist.dp_objective, dist.apply_update)
        dist.dp_objective = rec.wrap('objective', dist.dp_objective)
        dist.apply_update = rec.wrap('update', dist.apply_update)

    @contextmanager
    def discrete(self, into: List[dict]):
        """While open, each step's discrete decisions are kept in `into`
        (a dict a step, on the host): the 2D detections the 3D head takes
        (`base_detector.detect`), the RPN proposals the R-CNN samples from
        (`train_step.rpn_proposals`), and the Hungarian assignment of
        every decoder layer (`matching.hungarian_assign`)."""
        from mv2d_tpu_torch.core import matching
        from mv2d_tpu_torch.train import train_step
        det = self.model.base_detector
        saved = (det.detect, train_step.rpn_proposals,
                 matching.hungarian_assign)

        def keep(key, fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                into[-1][key] = tuple(_host(t) for t in out)
                if key == 'match':
                    into[-1]['match_in'] = tuple(_host(t) for t in a)
                return out
            return wrapped
        self._keep_step = lambda: into.append({})
        det.detect = keep('detect', saved[0])
        train_step.rpn_proposals = keep('rpn', saved[1])
        matching.hungarian_assign = keep('match', saved[2])
        try:
            yield
        finally:
            self._keep_step = None
            del det.detect
            train_step.rpn_proposals, matching.hungarian_assign = saved[1:]

    def call(self, i: int):
        """Step `self.step_no` on scene i of the pool -> its metrics (on
        the device)."""
        from mv2d_tpu_torch.parallel.dist import dp_train_step
        g = inputs.generator(self.device, self.seed, inputs.STEPS,
                             self.step_no)
        self.step_no += 1
        scene = self.scenes[i % len(self.scenes)]
        if self._keep_step is not None:
            self._keep_step()
        return dp_train_step(self.model, self.opt, [scene], [g],
                             mixed_precision=self.mixed)

    def trained(self):
        """(name, parameter) of every leaf the optimizer holds."""
        ids = {id(p) for g in self.opt.param_groups for p in g['params']}
        return [(n, p) for n, p in self.model.named_parameters()
                if id(p) in ids]

    def first_gradients(self) -> Dict[str, torch.Tensor]:
        """The gradient the optimizer took in its first step, from its
        state: AdamW's first moment after one step is (1 - beta1) g."""
        out = {}
        for n, p in self.trained():
            st = self.opt.state.get(p, {})
            if 'exp_avg' in st:
                grp = next(g for g in self.opt.param_groups
                           if any(q is p for q in g['params']))
                out[n] = st['exp_avg'].detach().float() / (
                    1 - grp['betas'][0])
        return out

    def free(self):
        dist = self._dist
        dist.dp_objective, dist.apply_update = self._saved
        del self.model, self.opt, self.scenes
