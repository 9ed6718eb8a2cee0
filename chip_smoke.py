"""Smoke run of the PyTorch/CUDA port (mv2d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure exits non-zero without the final line:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from mv2d_tpu_torch/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version at the eval path's
     shapes (12 views at 512x1408) plus edge cases: float32 with TF32 off
     (max error <= 1e-4 of the reference's max magnitude) and bfloat16
     (<= 3e-2), with both times;
  4. the tiny config with DCN, GPU (kernels) against CPU (plain versions),
     same seeded weights: valid slots, labels, scores and boxes;
  5. three full-width MV2D-T R50 forwards (12 x 512 x 1408, k_max 16384)
     in bfloat16 with seeded weights (bench fixture rules): finite outputs
     of the expected shapes, every kernel's launch counter above zero,
     ms per forward, key_active / key_overflow, and the inputs each kernel
     saw first replayed through its plain version.
Then one JSON line with the kernels' results, and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np

F32_TOL = 1e-4
BF16_TOL = 3e-2

KERNELS = {
    'fused_stage1': dict(
        source='mv2d_tpu_torch/csrc/stage1.cu',
        replaces='mv2d_tpu/ops/pallas_stage.py:201'),
    'dcn_conv': dict(
        source='mv2d_tpu_torch/csrc/dcn.cu',
        replaces='mv2d_tpu/ops/pallas_dcn.py:607'),
    'roi_align_multilevel': dict(
        source='mv2d_tpu_torch/csrc/roi_align.cu',
        replaces='mv2d_tpu/ops/pallas_roi_align.py:1263'),
    'masked_attention': dict(
        source='mv2d_tpu_torch/csrc/attention.cu',
        replaces='mv2d_tpu/ops/pallas_attention.py:179'),
}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, n=5):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def compare(kernel_out, plain_out):
    """(max abs error, max abs error / max |plain|, finite)."""
    k = kernel_out.float()
    p = plain_out.float()
    err = (k - p).abs().max().item()
    scale = max(p.abs().max().item(), 1e-6)
    return err, err / scale, bool(torch_isfinite(k))


def torch_isfinite(t):
    import torch
    return torch.isfinite(t).all().item()


# ----------------------------------------------------------- kernel inputs

def stage1_inputs(dev, dtype, V=12, H=128, W=352, seed=0):
    import torch
    from mv2d_tpu_torch.nn.resnet import ResNet
    from mv2d_tpu_torch.synthetic import init_random_weights
    g = torch.Generator().manual_seed(seed)
    net = init_random_weights(ResNet(50), seed)
    with torch.no_grad():
        for m in net.layer1.modules():     # random frozen-BN statistics
            if hasattr(m, 'running_var'):
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.running_mean.normal_(0, 0.1, generator=g)
        blocks = [{k: v.to(dev) for k, v in blk.folded().items()}
                  for blk in net.layer1]
    x = torch.randn(V, H, W, 64, generator=g).relu().to(dev, dtype)
    return x, blocks


def dcn_inputs(dev, dtype, V, H, W, C, F, stride, seed=0, far=0.0):
    """Sample coordinates around the 3x3 stride grid with N(0, 2) offsets;
    a `far` share of them moved well outside the map."""
    import torch
    g = torch.Generator().manual_seed(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    ys = torch.arange(Ho) * stride - 1.0
    xs = torch.arange(Wo) * stride - 1.0
    k = torch.arange(3.0)
    by = (ys[:, None, None] + k.repeat_interleave(3)[None, None]) \
        .expand(Ho, Wo, 9)
    bx = (xs[None, :, None] + k.repeat(3)[None, None]).expand(Ho, Wo, 9)
    sy = by[None] + 2 * torch.randn(V, Ho, Wo, 9, generator=g)
    sx = bx[None] + 2 * torch.randn(V, Ho, Wo, 9, generator=g)
    if far:
        jump = torch.rand(V, Ho, Wo, 9, generator=g) < far
        sy = torch.where(jump, sy + (H + 50) * torch.sign(
            torch.randn(V, Ho, Wo, 9, generator=g)), sy)
        sx = torch.where(jump, sx - (W + 80), sx)
    mask = torch.rand(V, Ho, Wo, 9, generator=g)
    x = torch.randn(V, H, W, C, generator=g)
    w = torch.randn(9, C, F, generator=g) * (9 * C) ** -0.5
    return (x.to(dev, dtype), sy.to(dev).contiguous(),
            sx.to(dev).contiguous(), mask.to(dev), w.to(dev, dtype))


def roi_inputs(dev, dtype, V=12, P=1000, img=(512, 1408), C=256, seed=0,
               edge=False):
    """p2..p5 maps and anchor-like RoIs over all levels; with `edge`,
    extreme-aspect, zero-area and partly outside RoIs are mixed in."""
    import torch
    g = torch.Generator().manual_seed(seed)
    feats = [torch.randn(V, img[0] // s, img[1] // s, C, generator=g)
             .to(dev, dtype) for s in (4, 8, 16, 32)]
    side = 32 * 2 ** torch.randint(0, 5, (V, P), generator=g).float() \
        * (0.7 + 0.7 * torch.rand(V, P, generator=g))
    ratio = 2.0 ** torch.randint(-1, 2, (V, P), generator=g).float()
    w, h = side / ratio.sqrt(), side * ratio.sqrt()
    cx = torch.rand(V, P, generator=g) * img[1]
    cy = torch.rand(V, P, generator=g) * img[0]
    rois = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    rois[..., 0::2] = rois[..., 0::2].clamp(0, img[1])
    rois[..., 1::2] = rois[..., 1::2].clamp(0, img[0])
    if edge:
        rois[:, 0] = torch.tensor([0.0, 200.0, img[1], 208.0])   # 1408 x 8
        rois[:, 1] = torch.tensor([700.0, 0.0, 706.0, img[0]])   # 6 x 512
        rois[:, 2] = torch.tensor([300.0, 300.0, 300.0, 300.0])  # empty
        rois[:, 3] = torch.tensor([-40.0, -30.0, 60.0, 50.0])    # outside
        rois[:, 4] = torch.tensor([0.0, 0.0, img[1], img[0]])    # level 3
    return feats, rois.to(dev)


def attention_inputs(dev, dtype, Q=900, K=16384, C=256, seed=0,
                     self_attn=False):
    """Projected q/k/v and a correlation-like mask: each query sees a few
    contiguous key runs (~3% of keys); 10% of the rows see nothing."""
    import torch
    g = torch.Generator().manual_seed(seed)
    if self_attn:
        K = Q
        valid = torch.rand(K, generator=g) < 0.8
        allowed = valid[None, :] | torch.eye(Q, dtype=torch.bool)
    else:
        allowed = torch.zeros(Q, K, dtype=torch.bool)
        starts = torch.randint(0, K - 600, (Q, 3), generator=g)
        lens = torch.randint(50, 300, (Q, 3), generator=g)
        ar = torch.arange(K)
        for j in range(3):
            allowed |= (ar[None] >= starts[:, j:j + 1]) & \
                (ar[None] < starts[:, j:j + 1] + lens[:, j:j + 1])
        allowed[torch.rand(Q, generator=g) < 0.1] = False
    q = torch.randn(Q, C, generator=g)
    k = torch.randn(K, C, generator=g)
    v = torch.randn(K, C, generator=g)
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            allowed.to(dev))


# ------------------------------------------------------------------ phases

def kernel_cases():
    """(kernel name, case label, main-path shape?, make(dev, dtype) ->
    (kernel fn, plain fn, args))."""
    from mv2d_tpu_torch.ops import attention, dcn, roi_align, stage

    def stage1(dev, dt):
        return (stage.fused_stage1, stage.fused_stage1_plain,
                stage1_inputs(dev, dt))

    def dcn_case(V, H, W, C, F, s, far=0.0):
        def build(dev, dt):
            return dcn.dcn_conv, dcn.dcn_conv_plain, dcn_inputs(
                dev, dt, V, H, W, C, F, s, far=far)
        return build

    def roi(edge):
        def build(dev, dt):
            feats, rois = roi_inputs(dev, dt, edge=edge)
            strides = (4, 8, 16, 32)
            return (roi_align.roi_align_multilevel,
                    roi_align.multilevel_roi_align_plain,
                    (feats, rois, strides))
        return build

    def attn(self_attn):
        def build(dev, dt):
            return (attention.masked_attention,
                    attention.masked_attention_plain,
                    (*attention_inputs(dev, dt, self_attn=self_attn), 8))
        return build

    return [
        ('fused_stage1', 'layer1 [12,128,352,64]', True, stage1),
        ('dcn_conv', 'stage3 s2 [12,64,176,256]', True,
         dcn_case(12, 64, 176, 256, 256, 2)),
        ('dcn_conv', 'stage3 s1 [12,32,88,256]', False,
         dcn_case(12, 32, 88, 256, 256, 1)),
        ('dcn_conv', 'stage4 s2 [12,32,88,512]', False,
         dcn_case(12, 32, 88, 512, 512, 2)),
        ('dcn_conv', 'stage4 s1 [12,16,44,512]', False,
         dcn_case(12, 16, 44, 512, 512, 1)),
        ('dcn_conv', 'edge: 20% offsets far outside', False,
         dcn_case(12, 16, 44, 512, 512, 1, far=0.2)),
        ('roi_align_multilevel', 'p2-p5, rois [12,1000,4]', True, roi(False)),
        ('roi_align_multilevel', 'edge: extreme aspect/empty/outside',
         False, roi(True)),
        ('masked_attention', 'cross q900 k16384 (10% rows empty)', True,
         attn(False)),
        ('masked_attention', 'self q900 k900', False, attn(True)),
    ]


def phase_kernels(dev, results):
    import torch
    ok = True
    for name, label, main, build in kernel_cases():
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            kern, plain, args = build(dev, dt)
            out_k = kern(*args)
            out_p = plain(*args)
            torch.cuda.synchronize()
            err, rel, finite = compare(out_k, out_p)
            good = finite and rel <= tol and out_k.shape == out_p.shape
            ok &= good
            line = (f'  {name:<22} {label:<38} {str(dt)[6:]:<9} '
                    f'max_abs_err={err:.3e} rel={rel:.2e} tol={tol:.0e} '
                    f'{"ok" if good else "FAIL"}')
            if main and dt == torch.bfloat16:
                p1 = time_ms(lambda: plain(*args))
                k1 = time_ms(lambda: kern(*args))
                k2 = time_ms(lambda: kern(*args))
                p2 = time_ms(lambda: plain(*args))
                r = results[name]
                r.update(max_abs_err=err, ms=(k1 + k2) / 2,
                         plain_ms=(p1 + p2) / 2)
                line += f'  kernel {r["ms"]:.3f} ms  plain {r["plain_ms"]:.3f} ms'
            log(line)
            del out_k, out_p, args
            torch.cuda.empty_cache()
    return ok


def phase_tiny_parity(dev):
    """Tiny config with DCN: GPU (kernels, float32) vs CPU (plain)."""
    import torch
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.core.geometry import prepare_camera_params
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.synthetic import camera_rig, init_random_weights
    cfg = configs.tiny(stage_with_dcn=(False, False, True, True),
                       num_frames=2, k_max=48)
    V = cfg.total_views
    K, E = camera_rig(V, cfg.image_size)
    ts = [0.0] * cfg.num_views + [0.5] * cfg.num_views
    imgs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(V, *cfg.image_size, 3)).astype(np.float32))
    shapes = torch.tensor([list(cfg.image_size)] * V)
    model = init_random_weights(MV2D(cfg).eval(), seed=3)
    outs = {}
    for d in ('cpu', dev):
        m = model.to(d)
        cam = prepare_camera_params(K, E, ts, device=d)
        outs[d] = [t.cpu() if torch.is_tensor(t) else t
                   for t in m(imgs.to(d), cam, shapes.to(d))]
    c, g = outs['cpu'], outs[dev]
    valid_same = torch.equal(c[3], g[3])
    v = c[3]
    n = int(v.sum())
    box_err = (c[0][v] - g[0][v]).abs().max().item() if n else 0.0
    score_err = (c[1][v] - g[1][v]).abs().max().item() if n else 0.0
    labels_same = torch.equal(c[2][v], g[2][v])
    ok = valid_same and labels_same and box_err < 1e-3 and \
        score_err < 1e-4 and n > 0
    log(f'  tiny+DCN GPU vs CPU: valid={n} same_valid={valid_same} '
        f'same_labels={labels_same} box_err={box_err:.3e} '
        f'score_err={score_err:.3e} {"ok" if ok else "FAIL"}')
    return ok


def _clone(a):
    import torch
    if torch.is_tensor(a):
        return a.detach().clone()
    if isinstance(a, (list, tuple)):
        return type(a)(_clone(x) for x in a)
    if isinstance(a, dict):
        return {k: _clone(v) for k, v in a.items()}
    return a


def phase_serve(dev, results, n_requests=3, cfg=None):
    import torch
    import mv2d_tpu_torch.models.detector2d as det2d
    import mv2d_tpu_torch.nn.decoder as decoder
    import mv2d_tpu_torch.nn.resnet as resnet
    import mv2d_tpu_torch.ops.dcn as dcn
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.core.geometry import prepare_camera_params
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.ops import attention, roi_align, stage
    from mv2d_tpu_torch.synthetic import camera_rig, init_random_weights

    cfg = cfg or configs.mv2d_t_r50()
    V, (H, W) = cfg.total_views, cfg.image_size
    K, E = camera_rig(V, cfg.image_size)
    cam = prepare_camera_params(K, E, [0.0] * 6 + [0.5] * 6, device=dev)
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(V, H, W, 3)).astype(np.float32)).to(dev, torch.bfloat16)
    shapes = torch.tensor([[H, W]] * V, device=dev)
    model = init_random_weights(MV2D(cfg).eval(), seed=0).to(
        dev, torch.bfloat16)

    counted = (stage.fused_stage1, dcn.dcn_conv,
               roi_align.roi_align_multilevel, attention.masked_attention)
    # record the inputs each kernel wrapper sees first on the main path:
    # wrap the callers' references (a wrapper's own module stays as it is,
    # its launch counter lives there); the DCN wrapper's caller is in its
    # own module, so the first DCN module's input is recorded by a hook and
    # the kernel's inputs are derived from it in the replay
    seen = {}
    hooks = [(resnet, 'fused_stage1'), (det2d, 'roi_align_multilevel'),
             (decoder, 'masked_attention')]
    originals = {}
    for mod, name in hooks:
        fn = getattr(mod, name)
        originals[(mod, name)] = fn

        def wrapped(*args, _fn=fn, _name=name):
            # attention: record a cross-attention call (layer 0's
            # self-attention has all-zero values)
            cross = _name != 'masked_attention' or \
                args[1].shape[0] != args[0].shape[0]
            if _name not in seen and cross:
                seen[_name] = _clone(args)
            return _fn(*args)
        setattr(mod, name, wrapped)
    first_dcn = next(m for m in model.modules()
                     if isinstance(m, dcn.ModulatedDeformConv))

    def dcn_hook(m, inputs):
        if 'dcn_conv' not in seen:
            x = inputs[0].detach().clone()
            sy, sx, mask = m.sample_coords(x)
            seen['dcn_conv'] = (x, sy.contiguous(), sx.contiguous(), mask,
                                m.tap_weights(x.dtype))
    handle = first_dcn.register_forward_pre_hook(dcn_hook)

    for fn in counted:
        fn.launches = 0
    ms, out = [], None
    try:
        for _ in range(n_requests):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(imgs, cam, shapes)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        handle.remove()
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    launches = {fn.__name__: fn.launches for fn in counted}
    for name, n in launches.items():
        results[name]['launches'] = n
    boxes, scores, labels, valid, diag = out
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (boxes, scores))
    shapes_ok = (tuple(boxes.shape) == (cfg.max_per_scene, 9)
                 and tuple(scores.shape) == (cfg.max_per_scene,))
    ok = finite and shapes_ok and all(n > 0 for n in launches.values())
    log(f'  forward ms (bf16, {H}x{W} x {V} views): '
        + ', '.join(f'{t:.1f}' for t in ms))
    log(f'  valid detections={int(valid.sum())} '
        f'key_active={int(diag["key_active"])} '
        f'key_overflow={int(diag["key_overflow"])} '
        f'num_queries={int(diag["num_queries"])} finite={finite} '
        f'shapes_ok={shapes_ok}')
    log(f'  launches per {n_requests} forwards: {launches}')
    results['_forward_ms'] = ms

    # replay the recorded inputs through kernel and plain version
    plain = {'fused_stage1': stage.fused_stage1_plain,
             'dcn_conv': dcn.dcn_conv_plain,
             'roi_align_multilevel': roi_align.multilevel_roi_align_plain,
             'masked_attention': attention.masked_attention_plain}
    kern = {'fused_stage1': stage.fused_stage1, 'dcn_conv': dcn.dcn_conv,
            'roi_align_multilevel': roi_align.roi_align_multilevel,
            'masked_attention': attention.masked_attention}
    for name, args in seen.items():
        err, rel, fin = compare(kern[name](*args), plain[name](*args))
        good = fin and rel <= BF16_TOL
        ok &= good
        log(f'  replay {name:<22} max_abs_err={err:.3e} rel={rel:.2e} '
            f'{"ok" if good else "FAIL"}')
    missing = set(kern) - set(seen)
    if missing:
        log(f'  kernels never reached: {sorted(missing)}')
        ok = False
    return ok


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: torch.cuda.is_available() is False')
    from mv2d_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = 'cuda'
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f'python {sys.version.split()[0]} torch {torch.__version__} '
        f'cuda {torch.version.cuda}')
    results = {name: dict(name=name, route='cuda', **info, launches=0,
                          max_abs_err=None, ms=None, plain_ms=None)
               for name, info in KERNELS.items()}

    failed = []
    t0 = time.perf_counter()
    log('[build]')
    lib = kernels.build(verbose=True)
    kernels.lib()
    log(f'  built {lib.name} in {time.perf_counter() - t0:.1f} s')
    for phase, fn in (('kernels', lambda: phase_kernels(dev, results)),
                      ('tiny', lambda: phase_tiny_parity(dev)),
                      ('serve', lambda: phase_serve(dev, results))):
        log(f'[{phase}]')
        t1 = time.perf_counter()
        try:
            good = fn()
        except Exception as e:          # a phase that raises has failed
            import traceback
            traceback.print_exc()
            log(f'  {phase} raised {type(e).__name__}: {e}')
            good = False
        log(f'  {phase}: {"ok" if good else "FAILED"} '
            f'({time.perf_counter() - t1:.1f} s)')
        if not good:
            failed.append(phase)
    if failed:
        log(f'chip_smoke: failed phases {failed}')
        sys.exit(1)
    log(json.dumps({'kernels': [results[n] for n in KERNELS]}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
