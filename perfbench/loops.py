"""The two closed loops a traffic mix's `loop` names: 'eval' (the bf16
eval forward, one client, the next scene sent when the last one's
detections are on the host) and 'train' (one scene a step through
`dp_train_step`).  Each builds the program (`perfbench.program`), warms
up in `setup`, makes one timed call in `timed_call`, reads the profiled
slice in `traced`, and hands what the check needs to `finish`.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from . import check, flops, inputs, program, roofline, trace


def _sampled(seed: int, k: int, among: int) -> List[int]:
    rng = np.random.default_rng(inputs.seed_key(seed, inputs.CHECK))
    return sorted(int(i) for i in rng.choice(among, size=min(k, among),
                                             replace=False))


class _Loop:
    program = None

    def __init__(self, model_cfg: dict, traffic: dict, seed: int, device):
        self.model_cfg, self.traffic = model_cfg, traffic
        self.seed, self.device = seed, device
        self.cuda = torch.device(device).type == 'cuda'

    def activation_dtype(self) -> str:
        """The profiler's name of the program's activation dtype."""
        bf16 = self.traffic['weights_dtype'] == 'bfloat16' or \
            self.traffic.get('mixed_precision', True) and self.loop == 'train'
        return 'c10::BFloat16' if bf16 else 'float'

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def traced(self, n: int) -> dict:
        """The profiled slice: one call to start the profiler's device
        tracing, then `profiled_calls` calls whose events are read; then
        one call under the sync debug mode."""
        rec = self.program.rec
        k = self.traffic['profiled_calls']
        mark = {}

        def calls():
            self.untimed_call(n)
            self._sync()
            rec.spans.clear()
            rec.spans_on = rec.annotate = True
            mark['t0'] = time.time_ns() / 1e3
            for i in range(k):
                self.untimed_call(n + 1 + i)
            self._sync()
            mark['t1'] = time.time_ns() / 1e3
            rec.spans_on = rec.annotate = False
        events, _ = trace.profile(calls)
        t0, t1 = mark['t0'], mark['t1']
        events = [e for e in events if t0 <= e.start < t1]
        spans_us = [(nm, a / 1e3, b / 1e3) for nm, a, b in rec.spans]
        rec.spans.clear()
        ks = trace.kernels(events)
        by_span = trace.busy_by_span(events, spans_us)
        if self.loop == 'train':
            # the backward: what the host enqueued between the objective's
            # end and the update's start
            obj = [s for s in spans_us if s[0] == 'objective']
            upd = [s for s in spans_us if s[0] == 'update']
            bw = [('backward', o[2], u[1]) for o, u in zip(obj, upd)]
            by_span.update(trace.busy_by_span(events, bw))
        blocked_ms = syncs = None                   # the card's only
        if self.cuda:
            blocked_us, syncs = trace.sync_debug(
                lambda: self.untimed_call(n + 1 + k))
            blocked_ms = blocked_us / 1e3
        return dict(
            busy_s=trace.union_us((e.start, e.end) for e in ks) / 1e6,
            traced_s=(t1 - t0) / 1e6,
            busy_ms_by_span={s: v / 1e3 / k for s, v in by_span.items()},
            roofline_pct=roofline.share(
                trace.op_calls(events), self.activation_dtype(),
                [(h, w, self.model_cfg['fpn_channels']) for h, w in
                 flops.level_sizes(self.model_cfg)[:4]]),
            blocked_ms=blocked_ms, syncs=syncs,
            breakdown=dict(device_ops=trace.top_ops(events),
                           idle_gaps=trace.idle_gaps(
                               events, spans_us, (t0, t1))) if ks else None)


class EvalLoop(_Loop):
    loop = 'eval'

    def setup(self):
        self.program = program.EvalProgram(self.model_cfg, self.traffic,
                                           self.seed, self.device)
        for i in range(self.traffic['warmup_calls']):
            self.program.call(i, keep=False)
        self.sample = set(_sampled(self.seed, self.traffic['check_calls'],
                                   self.traffic['check_among_first']))
        self.captures: Dict[int, dict] = {}

    def timed_call(self, n: int):
        cap = None
        if n in self.sample:
            cap = self.captures[n] = {}
        self.program.call(n, capture=cap)

    def untimed_call(self, n: int):
        self.program.call(n, keep=False)

    def finish(self) -> dict:
        p = self.program
        p.free()
        return dict(loop='eval', outputs=p.outputs, captures={
            n: dict(c, scene=n % self.traffic['pool'])
            for n, c in self.captures.items()})


class TrainLoop(_Loop):
    loop = 'train'

    def setup(self):
        p = self.program = program.TrainProgram(
            self.model_cfg, self.traffic, self.seed, self.device)
        k = self.traffic['check_steps']
        p0 = {n: t.detach().clone() for n, t in p.trained()}
        self.losses: List[Dict[str, float]] = []
        self.first_grads: Dict[str, torch.Tensor] = {}
        self.decisions: List[dict] = []
        with p.discrete(self.decisions):
            for i in range(k):
                m = p.call(i)
                self.losses.append({key: float(v) for key, v in m.items()
                                    if 'loss' in key})
                if i == 0:
                    self.first_grads = {n: g.cpu() for n, g in
                                        p.first_gradients().items()}
        # on the host, for the check once the program is freed
        self.changes = {n: (t.detach() - p0[n]).cpu()
                        for n, t in p.trained()}
        del p0
        self._sync()

    def timed_call(self, n: int):
        self.program.call(self.traffic['check_steps'] + n)

    def untimed_call(self, n: int):
        self.program.call(self.traffic['check_steps'] + n)

    def finish(self) -> dict:
        p = self.program
        p.free()
        return dict(loop='train', losses=self.losses,
                    grad_norms=check.norms(self.first_grads),
                    first_grads=self.first_grads,
                    change_norms=check.norms(self.changes),
                    changes=self.changes, decisions=self.decisions)


LOOPS = {'eval': EvalLoop, 'train': TrainLoop}
