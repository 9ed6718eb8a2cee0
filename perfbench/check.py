"""The output check that decides `correct`: what the window's timed path
produced, compared with the float32 reference (`perfbench.reference`)
after the window has closed and the program is freed.

Eval (`MV2D.forward`).  Every scene's answer of the window is checked,
and on `check_calls` calls drawn from the seed each stage too.  A stage
is fed the program's own input of that stage, since the 2D detector's
top-k and NMS are discrete: the reference follows the program step by
step from its state, and each stage is judged by itself.
  * feats: the FPN's p2-p6 and the neck's p4 from the scene's images,
    norm(program - reference) over norm(reference), worst level (the max
    share, printed beside it, of the DCN stages' bf16 rounding sits within
    3x of the control's, PERF.md);
  * det2d: the share of the program's 2D detections (box and label) that
    the reference's detector, run on the program's FPN levels, does not
    keep;
  * det2d_score: the scores of the detections both keep, max |program -
    reference| over max |reference| (1 where none is kept by both);
  * pe: the position embedding of the program's p4, max |program -
    reference| over max |reference|;
  * head: each decoder layer's class logits and box codes of the
    program's p4, PE and detections, as pe, worst layer and output;
  * decode: every answer of the window against the reference's decode
    and BEV merge of the program's last decoder layer, as feats over the
    boxes and scores; a label or a kept slot that differs counts 1.
Train (`dp_train_step`).  The reference follows the first `check_steps`
steps from the same weights, scenes and step generators:
  * loss: each step's logged total, |program - reference| over
    |reference|, worst step;
  * grad: the gradient the optimizer took in step 1 (from its first
    moment), by leaf: |norm(program) - norm(reference)| over the larger
    of the reference's norm and the median leaf's, worst leaf;
  * change: the parameters' change over the steps, by leaf, as grad,
    worst leaf; change_median: the median leaf's.  Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of
    grad and change.  For the leaves that change most apart, a look line
    gives what sets them apart element by element (`look`);
  * match: the Hungarian assignment by itself: the program's costs of
    each step solved again by the reference, against the program's
    assignment (exact).
  The reference follows the program's discrete decisions (`following`):
  its 2D detections (the eval forward's detector under no gradient,
  checked by itself in the eval cells), the RPN proposals the R-CNN
  samples from, and the assignment.
Each number is held to its limit in `limits/<workload>.json`; a number
without a limit fails, but for those the file names `not_compared`
(printed, not judged: PERF.md gives their readings).
"""
from __future__ import annotations

import contextlib
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from . import inputs, reference, spec

SMALL_LEAF = 1e-3


def share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|, in float32."""
    g, r = got.float(), ref.float().to(got.device)
    scale = float(r.abs().max())
    return float((g - r).abs().max()) / max(scale, 1e-30)


def rms_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """norm(got - ref) over norm(ref), in float32."""
    g, r = got.float(), ref.float().to(got.device)
    return float(torch.linalg.vector_norm(g - r)) / max(
        float(torch.linalg.vector_norm(r)), 1e-30)


@contextlib.contextmanager
def float32_exact():
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def reference_model(model_cfg: dict, traffic: dict, seed: int, device,
                    train: bool):
    """The reference model with the benchmark's weights of this seed (the
    values the program was given, in float32)."""
    model = reference.build_model(model_cfg, device)
    dtype = inputs.DTYPES[traffic['weights_dtype']]
    w = inputs.weights(inputs.leaves_of(model), seed, device, dtype)
    model.load_state_dict({k: v.float() for k, v in w.items()}, strict=False)
    return model.train() if train else model.eval()


def reference_cams(rig: inputs.Rig, device):
    from .reference.core.geometry import prepare_camera_params
    return prepare_camera_params(rig.intrinsics, rig.extrinsics,
                                 rig.timestamps, device=device)


# ------------------------------------------------------------------ eval

def det2d_compare(prog: dict, ref) -> tuple:
    """(det2d, det2d_score): the share of the program's valid 2D
    detections with no reference detection of the same label within 0.01
    px on every coordinate; and over those with one, the scores' max
    |program - reference| over max |reference| (1 where there is none)."""
    pv = prog['valid'].bool()
    rb, rl, rv = ref.boxes.float(), ref.labels, ref.valid.bool()
    pb = prog['boxes'].float().to(rb.device)
    pl = prog['labels'].to(rl.device)
    pv = pv.to(rb.device)
    d = (pb[:, :, None, :] - rb[:, None, :, :]).abs().amax(-1)   # [V, P, P]
    hit = (d < 1e-2) & (pl[:, :, None] == rl[:, None, :]) & rv[:, None, :]
    found = pv & hit.any(-1)
    miss = float((pv & ~found).sum()) / max(int(pv.sum()), 1)
    if not found.any():
        return miss, 1.0
    rs = torch.gather(ref.scores.float(), 1, hit.int().argmax(-1))
    ps = prog['scores'].float().to(rs.device)
    return miss, share(ps[found], rs[found])


def pack(det) -> torch.Tensor:
    return torch.cat([det.boxes.float(), det.scores.float()[:, None],
                      det.labels.float()[:, None],
                      det.valid.float()[:, None]], 1)


def decode_gap(answer: torch.Tensor, ref: torch.Tensor) -> float:
    """An answer [S, 12] against the reference's: 1 where a kept slot or
    a label differs, else the share of boxes and scores."""
    a, r = answer.float().cpu(), ref.float().cpu()
    if not torch.equal(a[:, 11], r[:, 11]) or \
            not torch.equal(a[:, 10][a[:, 11] > 0], r[:, 10][r[:, 11] > 0]):
        return 1.0
    keep = r[:, 11] > 0
    if not keep.any():
        return 0.0
    return share(a[keep][:, :10], r[keep][:, :10])


def eval_numbers(model_cfg: dict, traffic: dict, seed: int, out: dict,
                 device) -> Dict[str, float]:
    """The eval numbers of a run's answers and captures (`EvalLoop.
    finish`) -> {number: reading}, and the answers compared."""
    from .reference.models.mv2d import HeadOutputs
    from .reference.models.detector2d import Proposals
    model = reference_model(model_cfg, traffic, seed, device, False)
    c = model.cfg
    rig = inputs.rig(model_cfg, traffic)
    cam = reference_cams(rig, device)
    shapes = torch.as_tensor(rig.img_shapes, device=device)
    mtd = model._mean_time_delta(cam)
    nums = {'feats': 0.0, 'det2d': 0.0, 'det2d_score': 0.0, 'pe': 0.0,
            'head': 0.0, 'decode': 0.0}
    per_answer: List[float] = []
    rms: Dict[str, float] = {}
    with torch.no_grad(), float32_exact():
        imgs = None
        for cap in out['captures'].values():
            if 'fpn' not in cap:
                continue
            if imgs is None:
                imgs = inputs.images(model_cfg, traffic, seed, device,
                                     inputs.DTYPES[traffic['weights_dtype']])
            x = imgs[cap['scene']].float()
            fpn, p4 = model.extract_feats(x)
            nums['feats'] = max([nums['feats'], rms_share(cap['p4'], p4)]
                                + [rms_share(a, b)
                                   for a, b in zip(cap['fpn'], fpn)])
            rms['feats_max_share'] = max(
                [rms.get('feats_max_share', 0), share(cap['p4'], p4)]
                + [share(a, b) for a, b in zip(cap['fpn'], fpn)])
            del fpn, p4
            pf = [f.to(device).float() for f in cap['fpn']]
            det = model.base_detector.detect(pf, c.image_size,
                                             c.proposal_test)
            for k, v in zip(('det2d', 'det2d_score'),
                            det2d_compare(cap['proposals'], det)):
                nums[k] = max(nums[k], v)
            del pf, det
            p4 = cap['p4'].to(device).float()
            pos = model.roi_head.position_encoding(p4, cam.img2lidar, shapes,
                                                   c.image_size)
            nums['pe'] = max(nums['pe'], share(cap['pos'], pos))
            rms['pe'] = max(rms.get('pe', 0), rms_share(cap['pos'], pos))
            pr = {k: v.to(device) for k, v in cap['proposals'].items()}
            props = Proposals(boxes=pr['boxes'].float(),
                              scores=pr['scores'].float(),
                              labels=pr['labels'], valid=pr['valid'])
            head = model.roi_head_forward(p4, cap['pos'].to(device).float(),
                                          props, cam, shapes, mtd)
            nums['head'] = max(nums['head'], max(
                max(share(cap['cls'][i], head.all_cls_scores[i]),
                    share(cap['box'][i], head.all_bbox_preds[i]))
                for i in range(head.all_cls_scores.shape[0])))
            rms['head'] = max([rms.get('head', 0)] + [
                max(rms_share(cap['cls'][i], head.all_cls_scores[i]),
                    rms_share(cap['box'][i], head.all_bbox_preds[i]))
                for i in range(head.all_cls_scores.shape[0])])
            del head, p4, pos
        for o in out['outputs']:
            ho = HeadOutputs(o['cls'][None].to(device).float(),
                             o['box'][None].to(device).float(),
                             o['query_valid'].to(device), {})
            per_answer.append(decode_gap(o['answer'], pack(model.decode(ho))))
    nums['decode'] = max(per_answer, default=1.0)
    print('check beside: ' + ', '.join(f'{k} {v:.4g}'
                                       for k, v in rms.items()),
          file=sys.stderr)
    return nums, per_answer


# ----------------------------------------------------------------- train

@contextlib.contextmanager
def following(model, replay: Optional[List[dict]], own: List[dict],
              own_in: List[tuple]):
    """While open, each step of the reference records its own discrete
    decisions in `own` (a dict a step) and, given `replay` (the program's,
    a dict a step), takes those in their place: the 2D detections of the
    3D head, the RPN proposals the R-CNN samples from, the Hungarian
    assignment.  So a step's continuous work follows the program's
    decisions, and each decision is compared by itself."""
    from .reference.core import matching
    from .reference.train import train_step
    det = model.base_detector
    saved = (det.detect, train_step.rpn_proposals, matching.hungarian_assign)

    def step():
        return len(own) - 1

    def take(key, fn, convert):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            own[step()][key] = out
            if key == 'match':
                own_in[step()] = tuple(t.detach().cpu() for t in a)
            if replay is None:
                return out
            return convert(out, replay[step()][key])
        return wrapped

    def like(out, got):
        ts = [g.to(o.device, o.dtype if o.is_floating_point() else g.dtype)
              for o, g in zip(out, got)]
        return type(out)(*ts) if hasattr(out, '_fields') else tuple(ts)
    det.detect = take('detect', saved[0], like)
    train_step.rpn_proposals = take('rpn', saved[1], like)
    matching.hungarian_assign = take('match', saved[2], like)
    try:
        yield
    finally:
        del det.detect
        train_step.rpn_proposals, matching.hungarian_assign = saved[1:]


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float()))
            for n, t in leaves.items()}


def train_reference(model_cfg: dict, traffic: dict, seed: int, device,
                    steps: int, operands=None,
                    replay: Optional[List[dict]] = None) -> dict:
    """The reference's first `steps` steps on the pool's scenes 0, 1, ...
    with the program's step generators -> losses, first gradients and
    changes by leaf (and their norms), and its own discrete decisions a
    step (on the host).  With `replay` it takes those decisions from it (`following`).
    `operands` is a dispatch mode to run under (the control's fp8
    products)."""
    from .reference.models.mv2d import GroundTruth2D, GroundTruth3D
    from .reference.step import AdamW, train_step
    from .reference.train.train_step import TrainBatch
    model = reference_model(model_cfg, traffic, seed, device, True)
    opt = AdamW(model, traffic['optimizer'])
    rig = inputs.rig(model_cfg, traffic)
    cam = reference_cams(rig, device)
    shapes = torch.as_tensor(rig.img_shapes, device=device)
    imgs = inputs.images(model_cfg, traffic, seed, device, torch.float32)
    gts = inputs.boxes(model_cfg, traffic, seed, device)
    p0 = {n: p.detach().clone() for n, p, _ in opt.params}
    losses, grads, own, own_in = [], None, [], []
    ctx = operands if operands is not None else contextlib.nullcontext()
    with float32_exact(), following(model, replay, own, own_in):
        for i in range(steps):
            b = gts[i % len(gts)]
            batch = TrainBatch(imgs[i % len(gts)], cam, shapes,
                               GroundTruth2D(b.boxes2d, b.labels2d,
                                             b.valid2d),
                               GroundTruth3D(b.boxes3d, b.labels3d,
                                             b.valid3d))
            g = inputs.generator(device, seed, inputs.STEPS, i)
            own.append({})
            own_in.append(())
            with ctx:
                losses.append(train_step(model, opt, batch, g))
            if i == 0:
                grads = opt.first_gradient()
    changes = {n: p.detach() - p0[n] for n, p, _ in opt.params}
    decisions = [{k: tuple(t.detach().cpu() for t in v)
                  for k, v in d.items()} for d in own]
    for d, c in zip(decisions, own_in):
        d['match_in'] = c
    return dict(losses=losses, grad_norms=norms(grads), first_grads=grads,
                change_norms=norms(changes), changes=changes,
                decisions=decisions)


def match_resolved(decision: dict) -> float:
    """The matching stage by itself: the reference's assignment of the
    program's own costs against the program's, as the share of the
    program's positive (query, GT) pairs, over every decoder layer, that
    it does not make (exact: 0)."""
    from .reference.core.matching import hungarian_assign
    costs, qv, gv = decision['match_in']
    pa, pp = decision['match']
    ra, rp = hungarian_assign(costs, qv, gv)
    pp = pp.bool()
    same = (pa == ra) & rp.bool()
    return float((pp & ~same).sum() + (rp.bool() & ~pp).sum()) / max(
        int(pp.sum()), 1)


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> Dict[str, float]:
    """leaf -> |norm(got) - norm(ref)| over the larger of the reference's
    norm and the median leaf's."""
    med = float(np.median([ref[n] for n in keep])) if keep else 0.0
    return {n: abs(got.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
            for n in keep}


def _worst(gaps: Dict[str, float]):
    return max(gaps.items(), key=lambda kv: kv[1], default=('', 1.0))


def look(name: str, prog: dict, ref: dict, med: float) -> str:
    """What sets one leaf's change apart, element by element: its
    reference gradient against the median leaf's (`med`); how far the
    first gradients lie apart, and the share of elements whose reference
    gradient is under that gap (at noise); how far the changes lie apart,
    the share of that gap on the elements at noise, and the share of
    elements moved the other way."""
    gp, gr = prog['first_grads'][name].float().cpu(), \
        ref['first_grads'][name].float().cpu()
    dp, dr = prog['changes'][name].float().cpu(), \
        ref['changes'][name].float().cpu()
    gap = (gp - gr).abs()
    noise = gr.abs() < gap
    dd = (dp - dr) ** 2
    return (f'check look {name}: reference gradient '
            f'{float(gr.norm()) / max(med, 1e-30):.3g} of the median '
            f'leaf\'s; first gradient {rms_share(gp, gr):.3g} apart, '
            f'{float(noise.float().mean()):.3g} of the elements at noise; '
            f'change {rms_share(dp, dr):.3g} apart, '
            f'{float(dd[noise].sum() / dd.sum().clamp(min=1e-30)):.3g} of '
            f'it on those elements, '
            f'{float((dp.sign() != dr.sign()).float().mean()):.3g} of the '
            f'elements moved the other way')


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """loss, grad, change, change_median, match of a run (`TrainLoop.
    finish`, or the control's `train_reference`) against the
    reference's."""
    rl = ref['losses']
    pl = [d['total_loss'] if isinstance(d, dict) else d
          for d in prog['losses']]
    loss = max((abs(a - b) / max(abs(b), 1e-30) for a, b in zip(pl, rl)),
               default=1.0)
    if len(pl) != len(rl):
        loss = 1.0
    g = ref['grad_norms']
    med = float(np.median(list(g.values())))
    keep = [n for n, v in g.items() if v >= SMALL_LEAF * med]
    gg = leaf_gaps(prog['grad_norms'], g, keep)
    cg = leaf_gaps(prog['change_norms'], ref['change_norms'], keep)
    grad, change = _worst(gg), _worst(cg)

    def ranked(gaps):
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:5]

    def top(gaps, a, b):
        return '; '.join(f'{n} {v:.3g} ({a.get(n, 0):.3g} vs {b[n]:.3g})'
                         for n, v in ranked(gaps))
    match = max((match_resolved(p) for p in prog['decisions']),
                default=1.0)
    median_change = float(np.median(list(cg.values()))) if cg else 1.0
    looks = [look(n, prog, ref, med) for n, _ in ranked(cg)[:3]
             if n in prog.get('first_grads', {})
             and n in prog.get('changes', {})]
    return dict(loss=loss, grad=grad[1], change=change[1],
                change_median=median_change, match=match), dict(
        grad=grad[0], change=change[0], left_out=len(g) - len(keep),
        detail=[f'check losses {pl} vs {rl}; first step '
                f'{abs(pl[0] - rl[0]) / max(abs(rl[0]), 1e-30):.4g}'
                if pl and rl else 'check losses: none',
                f'check median leaf gaps: grad '
                f'{float(np.median(list(gg.values()))):.3g}, change '
                f'{median_change:.3g}',
                'check worst grad leaves: ' + top(gg, prog['grad_norms'], g),
                'check worst change leaves: ' + top(
                    cg, prog['change_norms'], ref['change_norms'])] + looks)


# ----------------------------------------------------------------- judge

def judge(workload: str, cell: dict, model_cfg: dict, traffic: dict,
          seed: int, prog_out: dict, device, limits: Optional[dict] = None
          ) -> dict:
    """-> dict(correct, attempted, failed, numbers {name: [reading,
    limit]}, lines: one a number, 'name reading limit')."""
    limits = spec.limits(workload) if limits is None else limits
    if prog_out['loop'] == 'eval':
        nums, per_answer = eval_numbers(model_cfg, traffic, seed, prog_out,
                                        device)
        attempted = len(per_answer)
        lim = limits.get('decode')
        failed = sum(1 for v in per_answer if lim is None or v > lim)
    else:
        ref = train_reference(model_cfg, traffic, seed, device,
                              traffic['check_steps'],
                              replay=prog_out['decisions'])
        nums, where = train_numbers(prog_out, ref)
        attempted, failed = traffic['check_steps'], 0
    ok = attempted > 0
    numbers, lines = {}, []
    if prog_out['loop'] == 'train':
        lines.append(f"check worst leaves: grad {where['grad']}, change "
                     f"{where['change']}; {where['left_out']} leaves left "
                     f"out (reference gradient under {SMALL_LEAF:g} of the "
                     f"median leaf's)")
        lines += where['detail']
    skip = set(limits.get('not_compared', ()))
    for name, v in nums.items():
        if name in skip:
            lines.append(f'check {name} {v:.6g} not compared')
            continue
        lim = limits.get(name)
        good = lim is not None and np.isfinite(v) and v <= lim
        ok &= good
        numbers[name] = [v, lim]
        lines.append(f'check {name} {v:.6g} limit {lim}')
    if prog_out['loop'] == 'train':
        failed = 0 if ok else attempted
    return dict(correct=bool(ok), attempted=attempted, failed=failed,
                numbers=numbers, lines=lines)
