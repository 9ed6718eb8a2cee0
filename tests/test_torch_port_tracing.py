"""The port's own spans and counters (`mv2d_tpu_torch.utils.profiling`) on
the CPU, at the tiny preset (two frames, DN):

  * with the tracer off, an eval forward and a training step record no
    span and open no profiler range, and they give what the same calls
    give with it on, bit for bit;
  * the spans of one forward and of one step form the tree of the
    forward's and the step's stages: parents, one call id a call, each
    child inside its parent;
  * a span's self time is its duration less its children's;
  * under torch.profiler each span's interval holds its own
    `record_function` range to within 50 us: the spans and the
    profiler's events share a clock;
  * the backbone's stages (`layer1`-`layer4`, `fpn`) are `backbone`'s
    children, once a call and in that order;
  * `nms_rounds` counts the NMS fixpoint's loop tests, and each `sync.*`
    counter moves by its site's syncs on every pass through the site;
    the sync debug mode's notice that it is a prototype is no sync;
  * with the tracer on, `keys.active` and `keys.overflow` sum the
    forward's diagnostics over calls; with it off they do not move, and
    the tracer adds no sync either way.
One card case (marked `cuda`, skipped without a GPU): on a CUDA device
the `sync.*` counters of one forward and of one step equal the warnings
of `torch.cuda.set_sync_debug_mode('warn')`.  Nothing here imports JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_tracing.py
"""
import collections
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from mv2d_tpu_torch import configs                       # noqa: E402
from mv2d_tpu_torch.core import coder, geometry, matching, nms  # noqa: E402
from mv2d_tpu_torch.models.mv2d import MV2D              # noqa: E402
from mv2d_tpu_torch.nn import decoder, pe, rpn           # noqa: E402
from mv2d_tpu_torch.parallel.dist import dp_train_step   # noqa: E402
from mv2d_tpu_torch.synthetic import (init_random_weights,  # noqa: E402
                                      synthetic_train_batch)
from mv2d_tpu_torch.tools.export import rig_camera       # noqa: E402
from mv2d_tpu_torch.train import losses, train_step      # noqa: E402
from mv2d_tpu_torch.train.optim import make_optimizer    # noqa: E402
from mv2d_tpu_torch.utils import profiling               # noqa: E402
from mv2d_tpu_torch.utils.profiling import (Span, counters,  # noqa: E402
                                            sync_warning, tracer)

BACKBONE = ('layer1', 'layer2', 'layer3', 'layer4', 'fpn')
EVAL_TREE = {'forward', 'forward/backbone', 'forward/detect',
             'forward/detect/rpn', 'forward/detect/rpn/nms',
             'forward/detect/rcnn', 'forward/detect/rcnn/nms', 'forward/pe',
             'forward/head', 'forward/head/keys', 'forward/head/decoder',
             'forward/decode'} | {f'forward/backbone/{n}' for n in BACKBONE}
STEP = 'train_step/objective/forward'
TRAIN_TREE = {'train_step', 'train_step/draws', 'train_step/objective',
              'train_step/objective/head_loss',
              'train_step/objective/head_loss/match',
              'train_step/objective/det_loss',
              'train_step/objective/det_loss/nms',
              'train_step/backward', 'train_step/update'} | {
    STEP + p[len('forward'):] for p in EVAL_TREE - {'forward/decode'}}

# site (the function that syncs) -> (counter, syncs a pass); the NMS
# fixpoint's syncs are its loop tests, the first read twice where the loop
# runs; the RPN's constants sync where they are built, once per shape,
# dtype and device (`rpn._constant`), and `rpn_proposals` no more
SITES = {
    nms._fixpoint_cond: [('nms_rounds', 1)],
    matching.hungarian_assign: [('sync.matching.d2h', 1),
                                ('sync.matching.h2d', 1)],
    geometry.normalize_points: [('sync.geometry.pc_range', 2)],
    geometry.virtual_intrinsics: [('sync.geometry.roi_size', 1)],
    coder.nms_free_decode: [('sync.coder.range', 2)],
    MV2D._decoder_inputs: [('sync.mv2d.dummy_box', 1)],
    decoder.CrossAttentionBoxHead.forward: [('sync.decoder.pc_range', 2)],
    pe.PE.forward: [('sync.pe.range', 2)],
    rpn._decode_stds: [('sync.rpn.decode_stds', 1)],
    rpn.bbox2delta: [('sync.rpn.encode_stds', 1)],
    rpn.rpn_proposals: [],
    rpn._level_anchors: [('sync.rpn.anchors', 1)],
    rpn._level_sizes: [('sync.rpn.level_sizes', 1)],
    losses.layer_losses: [('sync.losses.code_weights', 1)],
    losses.dn_layer_loss: [('sync.losses.code_weights', 1)],
    train_step._detector_losses: [('sync.train_step.anchors', 1)],
}


@pytest.fixture(autouse=True)
def _tracer_off():
    """Every test leaves the process-wide tracer off and empty."""
    yield
    tracer.on = tracer.annotate = False
    tracer.drain()


@pytest.fixture(scope='module')
def cfg():
    return configs.tiny(num_frames=2)


@pytest.fixture(scope='module')
def model(cfg):
    return init_random_weights(MV2D(cfg), seed=0).eval()


@pytest.fixture(scope='module')
def scene(cfg):
    V, (H, W) = cfg.total_views, cfg.image_size
    imgs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(V, H, W, 3)).astype(np.float32))
    return imgs, rig_camera(cfg, 'cpu'), torch.tensor([[H, W]] * V)


def _step(cfg, seed=0, n=1):
    """n training steps of a fresh seeded tiny model (float32, one
    thread) -> (the last step's metrics, the trained parameters)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m = init_random_weights(MV2D(cfg), seed=seed).train()
        opt = make_optimizer(m)
        batch = synthetic_train_batch(cfg, seed=0, device='cpu')
        for i in range(n):
            out = dp_train_step(m, opt, [batch],
                                [torch.Generator().manual_seed(i)],
                                mixed_precision=False)
        return out, {k: v.detach().clone() for k, v in m.named_parameters()}
    finally:
        torch.set_num_threads(threads)


def _ranges(prof):
    """(name, start ns, end ns) of the profile's record_function ranges."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def _check_tree(spans, tree):
    assert set(profiling.paths(spans)) == tree
    for s in spans:
        assert s.end >= s.start
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
            assert p.call == s.call
    roots = [s for s in spans if s.parent < 0]
    assert len({s.call for s in roots}) == len(roots)


def test_tracing_off_records_nothing_and_changes_no_output(cfg, model,
                                                           scene):
    from torch.profiler import ProfilerActivity, profile
    names = {p.rsplit('/', 1)[-1] for p in EVAL_TREE | TRAIN_TREE}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off = model(*scene)
        m_off, p_off = _step(cfg)
    assert not {n for n, _, _ in _ranges(prof)} & names
    assert tracer.drain() == []
    tracer.on = tracer.annotate = True
    on = model(*scene)
    tracer.on = tracer.annotate = False
    assert len(tracer.drain()) >= len(EVAL_TREE)
    for a, b in zip(off[:4], on[:4]):
        assert torch.equal(a, b)

    tracer.on = True
    m_on, p_on = _step(cfg)
    tracer.on = False
    assert {s.name for s in tracer.drain()} >= {'train_step', 'backward'}
    assert m_off.keys() == m_on.keys()
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    for k in p_off:
        assert torch.equal(p_off[k], p_on[k]), k


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_spans_form_the_stage_tree(cfg, model, scene, mode):
    tracer.on = True
    if mode == 'eval':
        model(*scene)
        model(*scene)
        tree = EVAL_TREE
    else:
        _step(cfg, n=2)
        tree = TRAIN_TREE
    tracer.on = False
    spans = tracer.drain()
    _check_tree(spans, tree)
    roots = [s for s in spans if s.parent < 0]
    assert len(roots) == 2
    assert roots[0].end <= roots[1].start
    for s in spans:     # every span of a call shares its root's call id
        assert s.call in {r.call for r in roots}


def test_backbone_stages_are_its_children_once_a_call(model, scene):
    tracer.on = True
    model(*scene)
    model(*scene)
    tracer.on = False
    spans = tracer.drain()
    backbones = [i for i, s in enumerate(spans) if s.name == 'backbone']
    assert len(backbones) == 2
    for i in backbones:
        kids = [s for s in spans if s.parent == i]
        assert tuple(s.name for s in kids) == BACKBONE
        assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))
        assert all(s.call == spans[i].call for s in kids)
    assert sum(s.name in BACKBONE for s in spans) == 2 * len(BACKBONE)


def _moved(c0):
    return {k: v - c0.get(k, 0) for k, v in counters.snapshot().items()
            if v != c0.get(k, 0)}


@pytest.mark.parametrize('k_max', [64, 8])
def test_key_counters_sum_the_forward_diagnostics(cfg, scene, k_max):
    m = init_random_weights(MV2D(cfg._replace(k_max=k_max)), seed=0).eval()
    m(*scene)                   # first-call work (the RPN's constants)
    c0 = counters.snapshot()
    off = m(*scene).diagnostics
    moved_off = _moved(c0)
    assert not {'keys.active', 'keys.overflow'} & set(moved_off)
    c0 = counters.snapshot()
    tracer.on = True
    diags = [m(*scene).diagnostics for _ in range(2)]
    tracer.on = False
    moved_on = _moved(c0)
    want = {'keys.active': sum(int(d['key_active']) for d in diags),
            'keys.overflow': sum(int(d['key_overflow']) for d in diags)}
    assert want['keys.active'] == 2 * int(off['key_active']) > 0
    assert (want['keys.overflow'] > 0) == (k_max < want['keys.active'] // 2)
    assert {k: moved_on.get(k, 0) for k in want} == want
    # the tracer adds no sync: the same sites, each as often a call
    assert {k: v for k, v in moved_on.items() if k not in want} == {
        k: 2 * v for k, v in moved_off.items()}


def test_self_time_is_the_span_less_its_children(model, scene):
    spans = [Span('a', -1, 1, 0, 100), Span('b', 0, 1, 10, 30),
             Span('c', 0, 1, 40, 45), Span('d', 2, 1, 41, 44),
             Span('e', -1, 2, 200, 210)]
    assert profiling.self_ns(spans) == [75, 20, 2, 3, 10]
    assert profiling.paths(spans) == ['a', 'a/b', 'a/c', 'a/c/d', 'e']
    tracer.on = True
    model(*scene)
    tracer.on = False
    spans = tracer.drain()
    own = profiling.self_ns(spans)
    for i, s in enumerate(spans):
        kids = sum(k.end - k.start for k in spans if k.parent == i)
        assert own[i] == s.end - s.start - kids


def test_spans_hold_their_profiler_ranges(cfg, model, scene):
    from torch.profiler import ProfilerActivity, profile
    tracer.on = tracer.annotate = True
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(*scene)
        _step(cfg)
    tracer.on = tracer.annotate = False
    spans = tracer.drain()
    ranges = collections.defaultdict(list)
    for n, a, b in sorted(_ranges(prof), key=lambda r: r[1]):
        ranges[n].append((a, b))
    mine = collections.defaultdict(list)
    for s in spans:
        mine[s.name].append((s.start, s.end))
    assert len(spans) >= len(EVAL_TREE) + len(TRAIN_TREE)
    for name, ivs in mine.items():
        assert len(ranges[name]) == len(ivs), name
        for (s0, s1), (r0, r1) in zip(ivs, ranges[name]):
            assert s0 - 50_000 <= r0 and r1 <= s1 + 50_000, name
            assert r0 <= s1 and s0 <= r1, name


def test_sync_warning_is_a_sync_not_the_mode_notice():
    assert sync_warning(UserWarning(
        'called a synchronizing CUDA operation'))
    assert not sync_warning(UserWarning(
        'Synchronization debug mode is a prototype feature and does not yet '
        'detect all synchronizing operations'))
    assert not sync_warning('Profiler clears events at the end of each cycle')


def _passes(fn):
    """fn() -> (the counters it moved, the calls it made of each
    function in SITES)."""
    codes = {getattr(f, '__code__', None): f for f in SITES}
    calls = collections.Counter()
    fixpoints = []      # loop tests of each greedy_fixpoint call

    def prof(frame, event, arg):
        if event != 'call':
            return
        if frame.f_code in codes:
            calls[codes[frame.f_code]] += 1
        if frame.f_code is nms.greedy_fixpoint.__code__:
            fixpoints.append(calls[nms._fixpoint_cond])
    c0 = counters.snapshot()
    sys.setprofile(prof)
    try:
        fn()
    finally:
        sys.setprofile(None)
    moved = {k: v - c0.get(k, 0) for k, v in counters.snapshot().items()
             if v != c0.get(k, 0)}
    ends = fixpoints[1:] + [calls[nms._fixpoint_cond]]
    tests = [b - a for a, b in zip(fixpoints, ends)]
    calls['nms syncs'] = sum(n + (n > 1) for n in tests)
    return moved, calls


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_counters_count_each_pass_through_their_site(cfg, model, scene,
                                                     mode):
    r0 = nms.greedy_fixpoint.rounds
    moved, calls = _passes((lambda: model(*scene)) if mode == 'eval'
                           else (lambda: _step(cfg)))
    want = collections.Counter({'sync.nms.round': calls.pop('nms syncs')})
    for f, n in calls.items():
        for name, per in SITES[f]:
            want[name] += n * per
    assert calls[nms._fixpoint_cond] > 0 and calls[rpn.rpn_proposals] > 0
    assert moved == dict(want)
    assert moved['nms_rounds'] == calls[nms._fixpoint_cond] < \
        moved['sync.nms.round']
    # the counter's earlier name moves with it
    assert nms.greedy_fixpoint.rounds - r0 == moved['nms_rounds']
    # the eval forward reaches no training site, the step no decode
    if mode == 'eval':
        assert not {'sync.matching.d2h', 'sync.train_step.anchors'} & \
            set(moved)
    else:
        assert 'sync.coder.range' not in moved and \
            moved['sync.matching.d2h'] == 1


# ------------------------------------------------------------------ card

@pytest.mark.cuda
def test_sync_counters_equal_the_sync_debug_warnings():
    import warnings
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: syncs exist only on the GPU')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.tiny(num_frames=2)
    dev = 'cuda'
    model = init_random_weights(MV2D(cfg), seed=0).eval().to(dev)
    V, (H, W) = cfg.total_views, cfg.image_size
    imgs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(V, H, W, 3)).astype(np.float32)).to(dev)
    args = (imgs, rig_camera(cfg, dev), torch.tensor([[H, W]] * V,
                                                     device=dev))
    tm = init_random_weights(MV2D(cfg), seed=0).train().to(dev)
    opt = make_optimizer(tm)
    batch = synthetic_train_batch(cfg, seed=0, device=dev)

    def step():
        dp_train_step(tm, opt, [batch],
                      [torch.Generator(device=dev).manual_seed(0)])
    def watched(fn):
        """fn() under the sync debug mode -> (its sync warnings, the
        sync.* counts it moved)."""
        warned = [0]
        old = warnings.showwarning

        def hook(message, *a, **k):
            warned[0] += sync_warning(message)
        torch.cuda.synchronize()
        c0 = counters.snapshot()
        with warnings.catch_warnings():
            warnings.simplefilter('always')
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode('warn')
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode('default')
                warnings.showwarning = old
        torch.cuda.synchronize()
        return warned[0], sum(v - c0.get(k, 0) for k, v in counters.items()
                              if k.startswith('sync.'))

    for fn in (lambda: model(*args), step):
        fn()                                    # builds, first-call work
        warned, counted = watched(fn)
        assert counted == warned > 0
