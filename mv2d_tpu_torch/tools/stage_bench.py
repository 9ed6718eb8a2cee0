"""Stage-wise timing of the full-width MV2D-T R50 eval forward on the card:
the counterpart of the repository's `tools/stage_bench.py`.

  python -m mv2d_tpu_torch.tools.stage_bench [piece ...] [--f32]
      [--iters 10] [--warmup 2] [--check] [--device cuda|cpu]

pieces: feats, detect, pe, head, decode, full (default: all).  Each row
calls the port's own stage methods, in the order `MV2D.forward` calls
them, on the output of the one before: `extract_feats` (backbone, FPN,
neck), `base_detector.detect` (RPN, RoIAlign, R-CNN, NMS),
`roi_head.position_encoding`, `roi_head_forward` (the 3D head: align,
query generator, correlation, keys, decoder), `decode` (NMS-free decode
and the BEV merge); then the whole forward.  The rows chained compute
what the forward computes (`forward_by_stages`).  Each row prints the
host ms a call, the device's busy ms and the host syncs by site
(`stage_common.timed`); the sum of the stage rows is printed beside the
full row, and each row's NMS fixpoint rounds a call.  bfloat16 on the
card (`--f32`: float32), with `synthetic.bench_rule_weights(seed=0)`
(`--init random`: `init_random_weights(seed=0)`, the weights
`chip_smoke.py` serves) and the JAX bench's scene
(`stage_common.rig_inputs`).

`--check` runs the full-width numeric check instead: each stage of the
forward on the card (bfloat16, hand kernels) against the port's float32
plain path on the host, both sides fed the same inputs, so that a row
measures that stage alone, and a witness that reruns the bf16 path with
K2's and K4's plain versions in their place (`numeric_check`).

The JAX tool's `--flash` is not ported: it routes the TPU's attention,
and the port runs K4 for every shared-key attention on the card whatever
`use_flash_attention` says.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import stage_common as sc

PIECES = ('feats', 'detect', 'pe', 'head', 'decode', 'full')
NAMES = {'feats': 'backbone+FPN+neck', 'detect': 'RPN+RCNN detect',
         'pe': '3D position embedding', 'head': 'roi head (corr+decoder)',
         'decode': 'decode + BEV merge', 'full': 'FULL forward'}
# the bf16 rule (PERF.md section 2): max |card - host| within this share of
# the host's max |value|
CHECK_TOL = 3e-2


def stage_fns(model, cam, shapes):
    """The forward's stages as callables, each taking the last one's
    output: feats(imgs) -> (fpn, p4); detect(fpn) -> Proposals;
    pe(p4) -> pos; head(p4, pos, proposals) -> HeadOutputs;
    decode(out) -> Detections."""
    c = model.cfg
    return dict(
        feats=model.extract_feats,
        detect=lambda fpn: model.base_detector.detect(
            fpn, c.image_size, c.proposal_test),
        pe=lambda p4: model.roi_head.position_encoding(
            p4, cam.img2lidar, shapes, c.image_size),
        head=lambda p4, pos, props: model.roi_head_forward(
            p4, pos, props, cam, shapes, model._mean_time_delta(cam)),
        decode=model.decode)


@torch.no_grad()
def forward_by_stages(model, imgs, cam, shapes):
    """`MV2D.forward` as the chain of `stage_fns`."""
    f = stage_fns(model, cam, shapes)
    fpn, p4 = f['feats'](imgs)
    props = f['detect'](fpn)
    pos = f['pe'](p4)
    return f['decode'](f['head'](p4, pos, props))


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('pieces', nargs='*')
    p.add_argument('--f32', action='store_true')
    p.add_argument('--flash', action='store_true',
                   help='not ported (prints why)')
    p.add_argument('--check', action='store_true',
                   help='the full-width numeric check instead of timings')
    p.add_argument('--check-views', default=None,
                   help='comma-separated views for the per-view stages of '
                        "--check (e.g. '0,6'; default all)")
    sc.add_common_args(p)
    sc.add_init_arg(p)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the CLI; returns {'rows': {piece: Row}} (and 'check')."""
    args = parse_args(argv)
    dev = sc.device_of(args)
    if args.flash:
        sc.refuse('--flash', 'TPU-only machinery: it routes the TPU\'s '
                  'attention; the port runs K4 for every shared-key '
                  'attention on the card')
    cfg = sc.model_config(args)
    if args.check:
        views = None if args.check_views is None else [
            int(v) for v in args.check_views.split(',')]
        return {'check': numeric_check(cfg, dev, views=views)}
    dtype = torch.float32 if args.f32 or dev.type == 'cpu' \
        else torch.bfloat16
    pieces = sc.want(PIECES, args.pieces)
    sc.header('stage_bench', dev, dtype, cfg)
    model = sc.bench_model(cfg, dev, dtype, args.init)
    imgs, cam, shapes = sc.rig_inputs(cfg, dev, dtype)
    f = stage_fns(model, cam, shapes)
    kw = dict(iters=args.iters, warmup=args.warmup, device=dev)
    rows: Dict[str, sc.Row] = {}
    with torch.no_grad():
        fpn, p4 = f['feats'](imgs)
        props = f['detect'](fpn)
        pos = f['pe'](p4)
        out = f['head'](p4, pos, props)
        inputs = dict(feats=(imgs,), detect=(fpn,), pe=(p4,),
                      head=(p4, pos, props), decode=(out,),
                      full=(imgs, cam, shapes))
        for piece in pieces:
            fn = model if piece == 'full' else f[piece]
            name = NAMES[piece] + (f' ({cfg.total_views} views)'
                                   if piece == 'detect' else '')
            rows[piece] = sc.timed(fn, *inputs[piece], name=name, **kw)
    stages = [p for p in PIECES[:-1] if p in rows]
    if stages and 'full' in rows:
        total = sum(rows[p].host_ms for p in stages)
        full = rows['full'].host_ms
        busy = '' if rows['full'].busy_ms is None else (
            f'; busy {sum(rows[p].busy_ms for p in stages):.3f} ms against '
            f'{rows["full"].busy_ms:.3f} ms')
        print(f'sum of the {len(stages)} stage rows {total:.3f} ms = '
              f'{100 * total / full:.1f}% of the full row {full:.3f} ms'
              f'{busy}', flush=True)
    return {'rows': rows}


# ---------------------------------------------------------- numeric check

def _err(got, ref):
    """(max |got - ref|, max |ref|) in float32 on the host."""
    g = got.detach().float().cpu()
    r = ref.detach().float().cpu()
    return float((g - r).abs().max()), float(r.abs().max())


def _share(got, ref) -> float:
    err, scale = _err(got, ref)
    return err / max(scale, 1e-30)


def _delta_heads(model, seed: int = 1):
    """rpn_reg / fc_reg N(0, 1 / fan_in) weights, so that the delta rows
    compare something (`init_random_weights` zeroes them)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ('rpn_reg' in name or 'fc_reg' in name) and p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g) * p[0].numel()
                        ** -0.5)
    return model


def _head_rows(out):
    """The 3D head's last layer by check row."""
    box = out.all_bbox_preds[-1]
    return {'head cls': out.all_cls_scores[-1], 'head box': box[:, :8],
            'head velocity': box[:, 8:10]}


def _rows(cfg, C, fpn, p4, rs, rd, cls, dl, pos, out, sv=None):
    """A chain's stage outputs by check row (views sv of the per-view
    stages, all by default)."""
    def v(t):
        return t if sv is None else t[sv]
    rows = {}
    for i in range(4):
        rows[f'backbone C{i + 2}'] = v(C[i])
    for i in range(5):
        rows[f'fpn p{i + 2}'] = v(fpn[i])
    rows['neck p4'] = v(p4)
    for i in range(5):
        rows[f'rpn cls p{i + 2}'] = v(rs[i])
        rows[f'rpn reg p{i + 2}'] = v(rd[i])
    rows['rcnn cls'], rows['rcnn deltas'] = v(cls), v(dl)
    Vc = cfg.num_views
    for f in range(cfg.num_frames):
        rows[f'pe views {f * Vc}-{(f + 1) * Vc - 1}'] = \
            pos[f * Vc:(f + 1) * Vc]
    return {**rows, **_head_rows(out)}


def _head(model, dt, dev, head_in, cam, shapes):
    """The 3D head of `model` (on dev, in dt) on (p4, PE, detections)."""
    p4, pos, props = head_in
    props = type(props)(*(t.to(dev) for t in props))
    return model.roi_head_forward(p4.to(dev, dt), pos.to(dev, dt), props,
                                  cam, shapes, model._mean_time_delta(cam))


def _stage_rows(model, dt, dev, imgs, C, fpn, pb, pe_in, head_in, cam,
                shapes):
    """Each stage of `model` (on dev, in dt) fed the same inputs as the
    host's, cast -> its outputs by check row."""
    c = model.cfg
    md = model.base_detector

    def to_d(xs):
        return [x.to(dev, dt) for x in xs]
    rs, rd = md.rpn_head(to_d(fpn))
    cls, dl = md.rcnn(to_d(fpn), pb.to(dev))
    pos = model.roi_head.position_encoding(pe_in.to(dev, dt), cam.img2lidar,
                                           shapes, c.image_size)
    return _rows(c, md.backbone(imgs.to(dev, dt)), md.neck(to_d(C)),
                 model.neck(to_d(fpn))[0], rs, rd, cls, dl, pos,
                 _head(model, dt, dev, head_in, cam, shapes))


@contextlib.contextmanager
def _no_tf32():
    """float32 products in float32 on the card (TF32 off)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


@contextlib.contextmanager
def _plain(kernel: str):
    """Kernel K2 ('dcn') or K4 ('attention') replaced, where the eval
    forward calls it, by its plain version, which then runs on the card
    in the inputs' dtype; the kernel's wrapper must launch nothing
    meanwhile."""
    from unittest import mock
    from ..nn import decoder
    from ..ops import attention, dcn
    if kernel == 'dcn':
        where, name, wrapper = dcn, 'dcn_conv', dcn.dcn_conv
        plain = dcn.dcn_conv_plain
    else:
        where, name, wrapper = decoder, 'masked_attention', \
            attention.masked_attention

        def plain(q, k, v, allowed, num_heads, tiles=None):
            return attention.masked_attention_plain(q, k, v, allowed,
                                                    num_heads)
    n = wrapper.launches
    with mock.patch.object(where, name, plain):
        yield
    assert wrapper.launches == n, f'{kernel}: its kernel launched'


def _witness(card, dt, dev, C, head_in, cam, shapes, ref) -> dict:
    """Where the bf16 rows' error comes from: the card's bf16 path, and
    the same path with a kernel's plain version in the kernel's place.
    The backbone's layers 2-4 alone, each fed the host's input of that
    layer (layers with DCN: K2, then K2's plain version); the 3D head
    (K4, then K4's plain version).  -> {piece: dict(kernel, plain,
    apart)}: max |card - host| as a share of max |host| with the kernel
    and with its plain version (None: no such kernel in the piece), and
    max |kernel path - plain path| as that share.  Where `plain` is near
    `kernel`, the piece's error is the bf16 path's, not the kernel's."""
    bb = card.base_detector.backbone
    res = {}

    def put(piece, k, p, r):
        scale = max(float(r.detach().float().abs().max()), 1e-30)
        res[piece] = dict(
            kernel=_share(k, r), plain=None if p is None else _share(p, r),
            apart=None if p is None else _err(k, p)[0] / scale)

    with torch.no_grad(), _no_tf32():
        for i in range(1, 4):
            layer = getattr(bb, f'layer{i + 1}')
            x = C[i - 1].to(dev, dt)
            p = None
            if bb.stage_with_dcn[i]:
                with _plain('dcn'):
                    p = layer(x)
            put(f'layer{i + 1}', layer(x), p, C[i])
        with _plain('attention'):
            out_p = _head_rows(_head(card, dt, dev, head_in, cam, shapes))
        out_k = _head_rows(_head(card, dt, dev, head_in, cam, shapes))
    for name, r in out_k.items():
        put(name, r, out_p[name], ref[name])
    for piece, r in res.items():
        if piece.startswith('layer'):
            what, kern = f'backbone {piece} alone, from the host\'s ' \
                f'C{piece[-1]}', 'K2'
        else:
            what, kern = piece, 'K4'
        plain = ' (no DCN)' if r['plain'] is None else (
            f' with {kern}, {r["plain"]:.2e} with its plain version in '
            f'bf16; the two apart {r["apart"]:.2e}')
        print(f'check (witness) {what}: share {r["kernel"]:.2e}{plain}',
              flush=True)
    return res


def numeric_check(cfg, dev, tol: float = CHECK_TOL,
                  views: Optional[Sequence[int]] = None) -> dict:
    """Each stage of the forward on `dev` (bfloat16 on the card: the hand
    kernels) against the port's float32 plain path on the host, on
    `init_random_weights(seed=0)` with rpn_reg / fc_reg drawn too
    (`_delta_heads`), the float32 weights cast for the card.  Each stage
    is fed the same inputs on both sides, so that a row measures that
    stage alone:
      backbone C2-C5 (images); FPN p2-p6 and the neck's p4 (the host's
      C2-C5 / p2-p6); the RPN's objectness and deltas of each level,
      dense, before top-k and NMS (p2-p6); the R-CNN's cls and deltas on
      the host's RPN proposals; the PE of each frame's views and the 3D
      head on all views of both frames (the card's own chain's p4, PE and
      detections, upcast: the PE's sine channels number the views, so it
      takes all of them), the head with `_mean_time_delta`'s velocity
      scaling: its last layer's classes, boxes (code dims 0-7) and
      velocities (8-9).
    `views` (e.g. (0, 6), one a frame) limits the stages of the backbone,
    the FPN, the RPN and the R-CNN to those views, to shorten the host's
    run.  A row passes with max |card - host| <= tol x max |host|.
    Printed beside each row and not gated: the chained error (the card's
    own forward stage by stage against the host's; past the RPN the two
    chains may keep other proposals; the PE and head rows equal theirs),
    and the float32 control (the same stages on the card in float32 with
    TF32 off).  Then `_witness`: the bf16 error of the backbone's layers
    and of the head with K2 / K4 and with their plain versions.
    -> {row: dict(err, scale, ok, chained, f32)}, '_ok', '_witness',
    '_host_s' (the host's seconds by stage)."""
    from ..models.mv2d import MV2D
    from ..routes import Routes
    from ..synthetic import init_random_weights
    dt = torch.bfloat16 if dev.type == 'cuda' else torch.float32
    sc.header('stage_bench --check', dev, dt, cfg)
    host = _delta_heads(init_random_weights(MV2D(cfg, Routes()), seed=0))
    host = host.eval()
    card = copy.deepcopy(host).to(dev, dt)
    imgs, cam, shapes = sc.rig_inputs(cfg, 'cpu', torch.float32)
    _, cam_d, shapes_d = sc.rig_inputs(cfg, dev, dt)
    c, V = cfg, cfg.total_views
    sv = list(range(V)) if views is None else sorted(views)
    bd, cd = host.base_detector, card.base_detector
    pcfg, size = c.proposal_test, c.image_size
    clock = {}

    def timed_host(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        clock[name] = time.perf_counter() - t0
        return out

    def detect(det, fpn):
        pb, _, pv = det.rpn(fpn, size, pcfg)
        cls, dl = det.rcnn(fpn, pb)
        return pb, pv, cls, dl, det.detections(pb, pv, cls, dl, size, pcfg)

    with torch.no_grad():
        # the card's own chain, every view
        C_c = cd.backbone(imgs.to(dev, dt))
        fpn_c = cd.neck(C_c)
        p4_c = card.neck(fpn_c)[0]
        rs_c, rd_c = cd.rpn_head(fpn_c)
        pb_c, _, cls_c, dl_c, props_c = detect(cd, fpn_c)
        pos_c = card.roi_head.position_encoding(p4_c, cam_d.img2lidar,
                                                shapes_d, size)
        out_c = card.roi_head_forward(p4_c, pos_c, props_c, cam_d,
                                      shapes_d, card._mean_time_delta(cam_d))
        # the host's float32 chain on the checked views
        C = timed_host('backbone', bd.backbone, imgs[sv])
        fpn = timed_host('fpn', bd.neck, C)
        p4 = timed_host('neck', lambda f: host.neck(f)[0], fpn)
        rs, rd = timed_host('rpn_head', bd.rpn_head, fpn)
        pb, pv, cls, dl, props = timed_host('detect', detect, bd, fpn)
        # the PE and the head: the card chain's inputs, upcast, both sides
        pe_in = p4_c.float().cpu()
        pos = timed_host('pe', host.roi_head.position_encoding, pe_in,
                         cam.img2lidar, shapes, size)
        pc = type(props_c)(*(t.cpu() for t in props_c))
        head_in = (pe_in, pos_c.float().cpu(), pc._replace(
            boxes=pc.boxes.float(), scores=pc.scores.float()))
        out = timed_host('head', host.roi_head_forward, *head_in, cam,
                         shapes, host._mean_time_delta(cam))
        stage = _stage_rows(card, dt, dev, imgs[sv], C, fpn, pb, pe_in,
                            head_in, cam_d, shapes_d)
        if dev.type == 'cuda':        # the kernels in float32, TF32 off
            with _no_tf32():
                control = _stage_rows(copy.deepcopy(host).to(dev),
                                      torch.float32, dev, imgs[sv], C, fpn,
                                      pb, pe_in, head_in, cam_d, shapes_d)
        else:
            control = stage
    chained = _rows(cfg, C_c, fpn_c, p4_c, rs_c, rd_c, cls_c, dl_c, pos_c,
                    out_c, sv)
    ref = _rows(cfg, C, fpn, p4, rs, rd, cls, dl, pos, out)
    same_props = bool(torch.equal(props_c.valid[sv].cpu(), props.valid)) \
        and float((props_c.boxes[sv].float().cpu() - props.boxes).abs()
                  .max()) < 1.0
    result, ok_all = {}, True
    for name, r in ref.items():
        err, scale = _err(stage[name], r)
        cerr, _ = _err(chained[name], r)
        ferr, _ = _err(control[name], r)
        ok = bool(np.isfinite(err)) and err <= tol * max(scale, 1e-30)
        ok_all &= ok
        result[name] = dict(err=err, scale=scale, ok=ok, chained=cerr,
                            f32=ferr)
        print(f'check {name:22s} max|err| {err:.4e}  max|ref| {scale:.4e}  '
              f'share {err / max(scale, 1e-30):.2e}  '
              f'{"ok" if ok else "FAIL"}  (float32 {ferr:.4e}, chained '
              f'{cerr:.4e})', flush=True)
    result['_witness'] = _witness(card, dt, dev, C, head_in, cam_d,
                                  shapes_d, ref)
    where = 'all views' if views is None else \
        f'views {sv} (the PE and the head on all)'
    print(f'check on {where}: {len(ref)} rows within {tol:.0e} of max '
          f'|ref|: {ok_all}; the chains kept the same detections: '
          f'{same_props}; {int(props.valid.sum())} detections, key_overflow '
          f'{int(out.diagnostics["key_overflow"])}; the host\'s float32 run '
          f'{sum(clock.values()):.1f} s (' + ', '.join(
              f'{k} {v:.1f}' for k, v in clock.items()) + ')', flush=True)
    result['_ok'] = ok_all
    result['_host_s'] = clock
    return result


if __name__ == '__main__':
    main()
