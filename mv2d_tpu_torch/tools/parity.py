"""One-command acceptance harness of the port: the counterpart of the
repository's `tools/parity.py`.

  python -m mv2d_tpu_torch.tools.parity <config> [checkpoint.pth]
      [--data-root D] [--max-samples N] [--synthetic] [--skip-eval]
      [--skip-golden] [--golden-proposals 8]
      [--matmul-precision default|high|highest]
      [--cfg-options k=v ...] [--device cuda|cpu]

It chains three acceptance checks against the reference (tusen-ai/MV2D,
README.md:49-53: mAP 0.453 / NDS 0.543 for the shipped two-frame R50
recipe):

(a) LOAD     load the reference-key state dict into `MV2D(cfg)` over
             `init_random_weights(seed=0)` and report the keys the port
             takes, the ones it does not (UNMATCHED) and the port's keys
             the file does not give;
(b) GOLDEN   run ONE sample through the port's 2D detector and 3D head,
             on the device in its eval dtype, and through a float32 torch
             transcription of the reference RoI head on the host
             (`reference_head`, the same p4 and proposals, the same
             state dict), and print the per-stage max error: pe,
             virtual_intrinsics, roi_align, decoder_cls, decoder_box;
(c) EVAL     run the val split through `eval/runner.run_eval` and print
             mAP / NDS next to the reference numbers.

With --synthetic (no checkpoint, no data) every stage runs on stand-ins:
a generated reference-key state dict of the RoI head (the JAX tool's
draw, key for key and value for value) feeds (a) and (b), random images
on the synthetic camera rig feed (b), and two val scenes rendered by
`make_synth_fixture` at the config's image size feed (c).  So the
harness runs today, and the real run needs no new code.

The model runs in bfloat16 on the GPU (the default) and in float32 with
`--device cpu`.  `--matmul-precision P` re-runs the pe and roi_align
rows in float32 from the same p4 under
`torch.set_float32_matmul_precision(P)`: with "highest" a drift from
reduced-precision arithmetic collapses, a layout or weight-order bug does
not.  The port's top-k is always exact, so the JAX tool's
MV2D_EXACT_TOPK has no counterpart.
"""
from __future__ import annotations

import argparse
import copy
import tempfile
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import MV2DConfig
from ..core.geometry import prepare_camera_params, virtual_intrinsics
from ..data.nuscenes import NuScenesDataset, SampleBuckets
from ..data.pipeline import IdaAugConfig
from ..eval.runner import run_eval
from ..models.mv2d import MV2D
from ..ops.roi_align import separable_roi_align_views
from ..synthetic import camera_rig, init_random_weights
from .common import (build_dataset, build_model_config, device_and_dtype,
                     load_cli_config)
from .make_synth_fixture import make_fixture
from .reference_head import (HeadDims, TBoxHead, TPE, TQueryGenerator,
                             dims_from_config, np_roi_align_concat,
                             t_epipolar, t_get_box_params, t_pixel_masks)

REF_TARGETS = {'mAP': 0.453, 'NDS': 0.543}   # reference README.md:49-53
HEAD_PREFIXES = ('roi_head.position_encoding.', 'roi_head.query_generator.',
                 'roi_head.bbox_head.')


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--data-root', default=None)
    p.add_argument('--max-samples', type=int, default=None)
    p.add_argument('--synthetic', action='store_true',
                   help='run every stage on synthetic stand-ins')
    p.add_argument('--skip-eval', action='store_true')
    p.add_argument('--skip-golden', action='store_true')
    p.add_argument('--golden-proposals', type=int, default=8,
                   help='proposal slots per view for the golden sample '
                        '(the reference transcription is python loops)')
    p.add_argument('--matmul-precision', default=None,
                   choices=('default', 'high', 'highest'),
                   help='re-run the pe and roi_align rows in float32 under '
                        'torch.set_float32_matmul_precision (default: the '
                        'current setting): the control for their drift')
    p.add_argument('--cfg-options', nargs='*', default=None)
    p.add_argument('--device', default='cuda')
    return p.parse_args(argv)


# ------------------------------------------------------------ (a) loading

def _oracle_modules(dims: HeadDims):
    return TPE(dims), TQueryGenerator(dims), TBoxHead(dims)


def synthetic_state_dict(cfg: MV2DConfig) -> Dict[str, torch.Tensor]:
    """Stand-in reference checkpoint: the RoI-head transcription at the
    config's dimensions, reference key names, parameters drawn from
    N(0, 0.02) by `default_rng(3)` in the transcription's parameter order
    (the JAX tool's `_synthetic_state_dict`)."""
    dims = dims_from_config(cfg)
    torch.manual_seed(3)
    rng = np.random.default_rng(3)
    sd = {}
    for prefix, m in zip(HEAD_PREFIXES, _oracle_modules(dims)):
        with torch.no_grad():
            for prm in m.parameters():
                prm.copy_(torch.tensor(
                    rng.normal(0, 0.02, tuple(prm.shape)),
                    dtype=torch.float32))
        sd.update({prefix + k: v for k, v in m.state_dict().items()})
    return sd


def load_report(cfg: MV2DConfig, sd: Dict[str, torch.Tensor]
                ) -> Tuple[MV2D, List[str]]:
    """`MV2D(cfg)` under `init_random_weights(seed=0)` with every key of
    `sd` that it takes (name and shape) loaded over it; prints the
    matched count, the UNMATCHED keys and the count of the port's keys
    the file does not give.  -> (model on the CPU, unmatched keys)."""
    model = init_random_weights(MV2D(cfg), seed=0)
    own = model.state_dict()
    taken = {k: v for k, v in sd.items()
             if k in own and tuple(own[k].shape) == tuple(v.shape)}
    unmatched = [k for k in sd if k not in taken]
    model.load_state_dict(taken, strict=False)
    print(f'[convert] {len(taken)}/{len(sd)} torch keys matched')
    if unmatched:
        print('[convert] UNMATCHED:')
        for k in unmatched:
            print('   ', k)
    missing = sum(k not in taken for k in own)
    print(f'[convert] {missing}/{len(own)} of the port\'s keys not in the '
          f'file: they keep init_random_weights(seed=0)')
    return model, unmatched


# ------------------------------------------------------------- (b) golden

class Golden(NamedTuple):
    rows: Dict[str, float]     # stage -> max |port - reference|
    scale: Dict[str, float]    # stage -> max |reference|
    proposals: int             # valid proposals compared
    key_active: int            # pixel keys the port's head selected
    key_overflow: int          # of them dropped at k_max (0 = all kept)


def golden_config(cfg: MV2DConfig, n_prop: int) -> MV2DConfig:
    """The golden's config: the current frame alone, no DN, no dropout,
    k_max at most every pixel, `n_prop` proposal slots a view."""
    V = cfg.num_views
    pad = tuple(cfg.image_size)
    return cfg._replace(
        num_frames=1, use_denoise=False, dropout=0.0,
        k_max=min(cfg.k_max, V * (pad[0] // cfg.stride)
                  * (pad[1] // cfg.stride)),
        proposal_test=cfg.proposal_test._replace(max_per_img=n_prop))


def rig_sample(cfg: MV2DConfig, seed: int = 0) -> dict:
    """One frame on the synthetic camera rig: images N(0, 0.5) from
    `default_rng(seed)`, full image shapes."""
    V = cfg.num_views
    rng = np.random.default_rng(seed)
    K, E = camera_rig(V, cfg.image_size)
    return dict(imgs=rng.normal(0, 0.5, (V, *cfg.image_size, 3)
                                ).astype(np.float32),
                intrinsics=K, extrinsics=E,
                img_shapes=np.asarray([[*cfg.image_size]] * V))


def _load_head_torch(sd, tpe, tqg, thead) -> bool:
    """Load the reference-named state dict (the one the port loaded) into
    the transcription modules, so both sides run the file's weights."""
    def sub(prefix, module):
        want = module.state_dict()
        got = {k[len(prefix):]: torch.as_tensor(np.asarray(v))
               for k, v in sd.items() if k.startswith(prefix)}
        missing = [k for k in want if k not in got]
        if missing:
            print(f'[golden] {prefix}* missing {len(missing)} keys '
                  f'(e.g. {missing[:3]})')
            return False
        module.load_state_dict(got, strict=False)
        return True

    ok = True
    for prefix, m in zip(HEAD_PREFIXES, (tpe, tqg, thead)):
        ok &= sub(prefix, m)
        m.eval()
    return bool(ok)


def _max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def run_golden(cfg: MV2DConfig, weights: Dict[str, torch.Tensor],
               sd_raw: Optional[Dict[str, torch.Tensor]], sample: dict,
               n_prop: int, device: str = 'cuda',
               matmul_precision: Optional[str] = None) -> Optional[Golden]:
    """Per-stage error of the port's head against the reference
    transcription on one sample.

    The port runs `golden_config(cfg)` with `weights` (a state dict of
    `MV2D(cfg)`) on `device` in its eval dtype: extract_feats, detect,
    the PE, roi_head_forward.  The transcription runs in float32 on the
    host on the port's p4 and proposals, with `sd_raw` (reference keys).
    Returns None, after printing why, when there is no state dict, a head
    key is missing or the detector gave no proposal.  The decoder rows
    are skipped in roi key mode: the transcription builds pixel keys."""
    if sd_raw is None:
        print('[golden] no torch state dict (pass a checkpoint or '
              '--synthetic); skipping the golden table')
        return None
    dims = dims_from_config(cfg)
    tpe, tqg, thead = _oracle_modules(dims)
    if not _load_head_torch(sd_raw, tpe, tqg, thead):
        return None

    dev, dtype = device_and_dtype(device)
    V = cfg.num_views
    O, FH, FW = cfg.roi_size, dims.FH, dims.FW
    cfg1 = golden_config(cfg, n_prop)
    model = MV2D(cfg1)
    model.load_state_dict(weights)
    model = model.eval().to(dev, dtype)

    K = np.asarray(sample['intrinsics'], np.float64)[:V]
    E = np.asarray(sample['extrinsics'], np.float64)[:V]
    lidar2img = K @ np.transpose(E, (0, 2, 1))
    img_shapes = np.asarray(sample['img_shapes'])[:V]
    imgs = torch.from_numpy(np.ascontiguousarray(
        np.asarray(sample['imgs'], np.float32)[:V])).to(dev).to(dtype)
    shapes = torch.as_tensor(img_shapes).to(dev)
    cam = prepare_camera_params(K, E, device=dev)
    amax = (-(-FH // O), -(-FW // O))

    with torch.inference_mode():
        fpn, p4 = model.extract_feats(imgs)
        proposals = model.base_detector.detect(fpn, cfg1.image_size,
                                               cfg1.proposal_test)
        pos = model.roi_head.position_encoding(p4, cam.img2lidar, shapes,
                                               cfg1.image_size)
        out = model.roi_head_forward(p4, pos, proposals, cam, shapes)
        boxes_d = proposals.boxes.float()
        P = boxes_d.shape[1]
        view_idx = torch.arange(V, device=dev).repeat_interleave(P)
        Kv_p = virtual_intrinsics(boxes_d.reshape(-1, 4),
                                  cam.intrinsics[view_idx], (O, O))

        def port_roi(p4_, pos_):
            cat = torch.cat([p4_, pos_.to(p4_.dtype)], dim=-1)
            return separable_roi_align_views(
                cat, boxes_d, 1.0 / cfg.stride, O, amax).reshape(
                    V * P, O, O, -1)

        roi_p = port_roi(p4, pos)
        if matmul_precision:
            # the control: only the pe and roi_align rows, in float32 from
            # the same p4, under the precision asked for ('default': the
            # process's setting); the PE's float32 weights are the state
            # dict's, not the model's rounded copy
            pe32 = copy.deepcopy(model.roi_head.position_encoding).float()
            pe32.load_state_dict({k[len(HEAD_PREFIXES[0]):]: v
                                  for k, v in weights.items()
                                  if k.startswith(HEAD_PREFIXES[0])})
            before = torch.get_float32_matmul_precision()
            if matmul_precision != 'default':
                torch.set_float32_matmul_precision(matmul_precision)
            try:
                pos = pe32(p4.float(), cam.img2lidar, shapes,
                           cfg1.image_size)
                roi_p = port_roi(p4.float(), pos)
            finally:
                torch.set_float32_matmul_precision(before)
            print(f'[golden] pe + roi_align rows re-run in float32 under '
                  f'matmul precision {matmul_precision!r}')
        p4n = p4.float().cpu().numpy()
        pos_p = pos.float().cpu().numpy()
        roi_p = roi_p.float().cpu().numpy()
        Kv_p = Kv_p.float().cpu().numpy()
        boxes = boxes_d.cpu().numpy()
        valid = proposals.valid.cpu().numpy()
        cls_p = out.all_cls_scores.float().cpu().numpy()
        box_p = out.all_bbox_preds.float().cpu().numpy()
        key_active = int(out.diagnostics.get('key_active', 0))
        key_overflow = int(out.diagnostics.get('key_overflow', 0))
    del model

    vmask = valid.reshape(-1)
    if not vmask.any():
        print('[golden] detector produced no proposals on this sample; '
              'nothing to compare')
        return None
    rows, scale = {}, {}

    with torch.no_grad():
        pos_t = tpe(torch.tensor(p4n).permute(0, 3, 1, 2), lidar2img,
                    img_shapes)
    pos_t = pos_t.permute(0, 2, 3, 1).numpy()
    rows['pe'], scale['pe'] = _max_abs(pos_p, pos_t), float(
        np.abs(pos_t).max())

    tb = [torch.tensor(boxes[v][valid[v]]) for v in range(V)]
    Kv_t, Ev_t = t_get_box_params(tb, K, E, dims)
    rows['virtual_intrinsics'] = _max_abs(Kv_p[vmask], Kv_t.numpy())
    scale['virtual_intrinsics'] = float(Kv_t.abs().max())

    cat_t = torch.cat([torch.tensor(p4n).permute(0, 3, 1, 2),
                       torch.tensor(pos_t).permute(0, 3, 1, 2)], dim=1)
    roi_t = np.zeros(roi_p.shape, np.float32)
    for r in np.nonzero(vmask)[0]:
        roi_t[r] = np_roi_align_concat(cat_t[r // P],
                                       boxes.reshape(-1, 4)[r], dims)
    rows['roi_align'] = _max_abs(roi_p[vmask], roi_t[vmask])
    scale['roi_align'] = float(np.abs(roi_t[vmask]).max())

    if cfg.key_mode == 'roi':
        print('[golden] decoder rows skipped: key_mode roi (the reference '
              'transcription builds pixel keys)')
    else:
        _decoder_rows(dims, tqg, thead, boxes, valid, K, lidar2img,
                      img_shapes, Kv_t, Ev_t, roi_t, p4n, pos_t,
                      cls_p[:, vmask], box_p[:, vmask], rows, scale)
    return Golden(rows, scale, int(vmask.sum()), key_active, key_overflow)


def _decoder_rows(dims, tqg, thead, boxes, valid, K, lidar2img, img_shapes,
                  Kv_t, Ev_t, roi_t, p4n, pos_t, cls_p, box_p, rows, scale):
    """The transcription's query generator, epipolar pixel keys and
    decoder on the valid proposals; the rows compare the queries that
    keep at least one key."""
    V, FH, FW, C, pad = dims.V, dims.FH, dims.FW, dims.C, dims.PAD
    vmask = valid.reshape(-1)
    rois5 = []
    for v in range(V):
        for b in boxes[v][valid[v]]:
            rois5.append([v, *b])
    rois5 = torch.tensor(np.asarray(rois5, np.float32))
    matched = t_epipolar(rois5, [int(valid[v].sum()) for v in range(V)],
                         lidar2img, 'topk', dims)
    pix_t = t_pixel_masks(rois5, matched, dims).numpy()
    feat_t = torch.tensor(roi_t[vmask][..., :C]).permute(0, 3, 1, 2)
    intr_feat = (Kv_t.reshape(-1, 16).float() * 0.1)
    wh_t = rois5[:, 3:5] - rois5[:, 1:3]
    intr_feat[(wh_t < 4).any(1)] = 0
    with torch.no_grad():
        refs_t, _ = tqg(feat_t, Kv_t, Ev_t, intr_feat)
    pr = np.asarray(dims.PC_RANGE)
    refs_t = ((refs_t.numpy() - pr[:3]) / (pr[3:] - pr[:3])
              ).astype(np.float32)
    with torch.no_grad():
        masks = torch.ones((1, V, pad[0], pad[1]))
        for i in range(V):
            masks[0, i, :int(img_shapes[i][0]), :int(img_shapes[i][1])] = 0
        pad_t = F.interpolate(masks, size=(FH, FW)).to(torch.bool)[0].numpy()
    kidx = np.nonzero(pix_t.any(0).reshape(-1))[0]
    keys_t = torch.tensor(p4n.reshape(-1, C)[kidx])
    kpos_t = torch.tensor(pos_t.reshape(-1, C)[kidx])
    blocked = ~pix_t.reshape(-1, V * FH * FW)[:, kidx]
    blocked |= pad_t.reshape(-1)[kidx][None]
    keep = ~blocked.all(1)
    with torch.no_grad():
        cls_t, box_t = thead(torch.tensor(refs_t), keys_t, kpos_t,
                             torch.tensor(blocked))
    cls_t, box_t = cls_t.numpy()[:, keep], box_t.numpy()[:, keep]
    rows['decoder_cls'] = _max_abs(cls_p[:, keep], cls_t)
    rows['decoder_box'] = _max_abs(box_p[:, keep], box_t)
    scale['decoder_cls'] = float(np.abs(cls_t).max())
    scale['decoder_box'] = float(np.abs(box_t).max())


def print_golden(g: Golden, cfg: MV2DConfig, device: str):
    print(f'[golden] per-stage max |err| port ({device}) vs the reference '
          f'transcription (float32, host) ({g.proposals} proposals, '
          f'{cfg.num_views} views @ {tuple(cfg.image_size)}; key_active '
          f'{g.key_active}, key_overflow {g.key_overflow}):')
    for k, v in g.rows.items():
        print(f'    {k:20s} {v:.3e}   (max |ref| {g.scale[k]:.3e})')


def golden_table(cfg: MV2DConfig, weights, sd_raw, sample, n_prop: int,
                 device: str = 'cuda', matmul_precision: Optional[str] = None
                 ) -> Optional[Dict[str, float]]:
    """`run_golden`, printed; -> the rows, or None where it compared
    nothing."""
    g = run_golden(cfg, weights, sd_raw, sample, n_prop, device,
                   matmul_precision)
    if g is None:
        return None
    print_golden(g, cfg, device)
    return g.rows


# --------------------------------------------------------------- (c) eval

def synthetic_dataset(cfg: MV2DConfig, out_dir: str, n_scenes: int = 2
                      ) -> NuScenesDataset:
    """`n_scenes` val scenes of `make_synth_fixture` rendered under
    `out_dir` at the config's image size, read in test mode.  A frame
    smaller than 90x160 (the fixture's clutter needs that much) is
    rendered at 90x160 and resized by the test-mode pipeline."""
    final = tuple(cfg.image_size)
    H, W = max(final[0], 90), max(final[1], 160)
    paths = make_fixture(out_dir, scenes=0, val_scenes=n_scenes,
                         image_h=H, image_w=W)
    return NuScenesDataset(
        info_path=paths['val_info'], ann2d_path=paths['val_coco'],
        num_frames=cfg.num_frames, test_mode=True, final_dim=final,
        ida=IdaAugConfig(final_dim=final, H=H, W=W),
        buckets=SampleBuckets(max_gt3d=cfg.max_gt, max_gt2d=cfg.max_gt2d))


def run_val_eval(model: MV2D, dataset: NuScenesDataset,
                 max_samples: Optional[int], synthetic: bool,
                 device: str = 'cuda') -> Dict[str, float]:
    """`run_eval` of `model` (moved to the device in its eval dtype) on
    `dataset`; prints mAP / NDS beside REF_TARGETS."""
    dev, dtype = device_and_dtype(device)
    model = model.eval().to(dev, dtype)
    metrics, _ = run_eval(model, dataset, dev, max_samples=max_samples)
    print('[eval] metric     ours      reference   delta')
    for k, ref in REF_TARGETS.items():
        v = float(metrics.get(k, float('nan')))
        print(f'[eval] {k:8s} {v:9.4f} {ref:9.4f}   {v - ref:+.4f}')
    ok = all(float(metrics.get(k, 0.0)) >= ref - 0.003
             for k, ref in REF_TARGETS.items())
    print('[eval] PARITY', 'PASS (within 0.3 pt)' if ok else
          'FAIL' if not synthetic else 'n/a (synthetic stand-in)')
    return metrics


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the CLI; returns {'unmatched', 'golden' (rows or None),
    'metrics' (or None)}."""
    args = parse_args(argv)
    device_and_dtype(args.device)
    cfg = load_cli_config(args.config, args.cfg_options)
    if args.data_root:
        for split in cfg.get('data', {}):
            if isinstance(cfg['data'][split], dict):
                cfg['data'][split]['data_root'] = args.data_root
    mcfg = build_model_config(cfg)

    sd_raw = None
    if args.checkpoint:
        sd = torch.load(args.checkpoint, map_location='cpu')
        sd_raw = sd.get('state_dict', sd)
    elif args.synthetic:
        print('[convert] no checkpoint: loading a synthetic reference-key '
              'state dict (RoI-head subtree at config scale)')
        sd_raw = synthetic_state_dict(mcfg)
    unmatched: List[str] = []
    if sd_raw is None:
        model = init_random_weights(MV2D(mcfg), seed=0)
    else:
        model, unmatched = load_report(mcfg, sd_raw)
        if args.synthetic and not args.checkpoint and unmatched:
            raise RuntimeError('the synthetic stand-in must load fully; '
                               f'unmatched: {unmatched}')

    golden = None
    if not args.skip_golden:
        if args.synthetic or not args.data_root:
            sample = rig_sample(mcfg)
        else:
            sample = build_dataset(cfg, 'val').get_sample(
                0, np.random.default_rng(0))
        golden = golden_table(mcfg, model.state_dict(), sd_raw, sample,
                              args.golden_proposals, args.device,
                              args.matmul_precision)

    metrics = None
    if not args.skip_eval:
        if args.synthetic:
            with tempfile.TemporaryDirectory(prefix='parity_synth_') as tmp:
                metrics = run_val_eval(
                    model, synthetic_dataset(mcfg, tmp), args.max_samples,
                    True, args.device)
        else:
            metrics = run_val_eval(model, build_dataset(cfg, 'val'),
                                   args.max_samples, False, args.device)
    return dict(unmatched=unmatched, golden=golden, metrics=metrics)


if __name__ == '__main__':
    main()
