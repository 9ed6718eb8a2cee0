"""The greedy 2D NMS operator `mv2d::nms_keep` (`ops/nms.py`,
`csrc/nms.cu`) and the CUDA graph of `TwoStageDetector.detect` it makes
possible.

On the CPU (no GPU needed):
  * the operator's CPU implementation, the blocked scan with its fixpoint,
    gives the keep mask that `nms_sorted_keep` and `nms_padded` give and
    that the numpy oracle of `tests/test_nms.py` gives, on random,
    clustered, duplicated, partly invalid and chained boxes;
  * its fake implementation gives a bool mask of the validity's shape, and
    an exported `nms_padded` holds the operator as one node;
  * `detect` on CPU tensors never captures a graph, and an exported
    `detect` runs the eager body with the operator as one node.
On a CUDA device (marked `cuda`, skipped without one; nothing here imports
JAX, so `--noconftest` runs them):
  * the kernel's keep masks equal the plain scan's bit for bit at the
    shapes the cells use ([12, 5, 1000], [12, 1000], [6, 5, 2000]) on
    random, clustered, duplicated, partly invalid and chained boxes, in
    float32, float32 rounded through bfloat16, and bfloat16;
  * `nms_padded` and `nms_sorted_keep` with tied scores equal the CPU's;
  * the graphed `detect` of MV2D-T and MV2D-S (test and train proposal
    settings) equals the eager body bit for bit on two calls with
    different features and after an in-place change of the heads'
    weights; the first call captures and calls each kernel wrapper twice
    (its warm-up and the capture), a later call replays, calls no wrapper,
    runs the kernels by the device's records, and makes no host sync.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_nms_kernel.py
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import chip_smoke as smoke                                # noqa: E402
from mv2d_tpu_torch.core import nms                       # noqa: E402
from mv2d_tpu_torch.models import detector2d              # noqa: E402
from mv2d_tpu_torch.ops import nms as nms_op              # noqa: E402
from mv2d_tpu_torch.utils.profiling import counters       # noqa: E402

KINDS = ['random', 'clustered', 'duplicates', 'invalid', 'chain']


def oracle_keep(boxes, valid, thr):
    """The numpy oracle of tests/test_nms.py on one row's valid boxes, in
    their order (distinct descending scores) -> the keep mask [N]."""
    ref = pytest.importorskip('tests.test_nms')
    idx = np.flatnonzero(valid)
    scores = np.linspace(1.0, 0.0, len(idx), endpoint=False)
    keep = np.zeros(len(valid), bool)
    keep[idx[ref.ref_greedy_nms(boxes[idx], scores, thr)]] = True
    return keep


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize('shape', [(3, 300), (2, 2, 65)])
@pytest.mark.parametrize('kind', KINDS)
def test_cpu_operator_is_the_scan_and_the_oracle(kind, shape):
    b, v = smoke.nms_inputs('cpu', shape, kind, seed=len(shape))
    thr = 0.7
    keep = nms_op.nms_keep(b, v, thr)
    assert keep.dtype == torch.bool and keep.shape == v.shape
    flat_b, flat_v = b.reshape(-1, shape[-1], 4), v.reshape(-1, shape[-1])
    for r, (rb, rv) in enumerate(zip(flat_b.numpy(), flat_v.numpy())):
        assert np.array_equal(keep.reshape(-1, shape[-1])[r].numpy(),
                              oracle_keep(rb, rv, thr)), r
    # the functions around it, on scores in the boxes' order (the valid
    # boxes sort first, in that order)
    scores = torch.linspace(1, 0.01, shape[-1]).expand(v.shape)
    _, ss = nms.nms_sorted_keep(b, scores, v, thr)
    order = nms._sort_by_score(b, scores, v)[3]
    assert torch.equal(torch.zeros_like(keep).scatter(
        -1, order, ss > nms._NEG / 2), keep)
    _, _, idx, ov = nms.nms_padded(b, scores, v, thr, shape[-1])
    kept = [sorted(i[o].tolist()) for i, o in
            zip(idx.reshape(-1, shape[-1]), ov.reshape(-1, shape[-1]))]
    assert kept == [torch.nonzero(k)[:, 0].tolist()
                    for k in keep.reshape(-1, shape[-1])]


def test_fake_implementation_and_export_hold_one_node():
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, v = smoke.nms_inputs('cpu', (2, 3, 70))
    with FakeTensorMode() as mode:
        fb, fv = mode.from_tensor(b), mode.from_tensor(v)
        out = torch.ops.mv2d.nms_keep(fb, fv, 0.5)
        assert out.shape == v.shape and out.dtype == torch.bool

    class Padded(torch.nn.Module):
        def forward(self, boxes, scores, valid):
            return nms.nms_padded(boxes, scores, valid, 0.5, 40)

    scores = torch.rand(v.shape, generator=torch.Generator().manual_seed(0))
    program = torch.export.export(Padded(), (b, scores, v), strict=False)
    targets = [str(n.target) for n in program.graph.nodes]
    assert targets.count('mv2d.nms_keep.default') == 1
    assert not [t for t in targets if 'while_loop' in t]
    got = program.module()(b, scores, v)
    for g, w in zip(got, nms.nms_padded(b, scores, v, 0.5, 40)):
        assert torch.equal(g, w)


@pytest.fixture(scope='module')
def tiny_detector():
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.synthetic import init_random_weights
    cfg = configs.tiny(num_frames=1)
    model = init_random_weights(MV2D(cfg), seed=0).eval()
    return cfg, model.base_detector


def level_feats(det, cfg, V, dev, dtype, seed):
    """Random FPN levels p2..p6 [V, H / s, W / s, C] of cfg's image, C
    the detector's FPN channels."""
    g = torch.Generator().manual_seed(seed)
    H, W = cfg.image_size
    C = det.rpn_head.rpn_conv.in_channels
    return [torch.randn(V, -(-H // s), -(-W // s), C, generator=g)
            .to(dev, dtype) for s in det.fpn_strides]


def test_cpu_detect_never_captures_and_export_runs_eager(tiny_detector):
    cfg, det = tiny_detector
    feats = level_feats(det, cfg, 2, 'cpu', torch.float32, 0)
    c0 = counters.snapshot()
    with torch.no_grad():
        a = det.detect(feats, cfg.image_size, cfg.proposal_test)
        b = det._detect(feats, cfg.image_size, cfg.proposal_test)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert det not in detector2d._GRAPHS

    class Detect(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.det = det

        def forward(self, *levels):
            return tuple(self.det.detect(list(levels), cfg.image_size,
                                         cfg.proposal_test))

    with torch.no_grad():
        program = torch.export.export(Detect(), tuple(feats), strict=False)
    targets = [str(n.target) for n in program.graph.nodes]
    assert targets.count('mv2d.nms_keep.default') == 2
    assert targets.count('mv2d.roi_align.default') == 1
    assert det not in detector2d._GRAPHS
    moved = {k: v - c0.get(k, 0) for k, v in counters.snapshot().items()}
    assert not moved.get('detect_graph.captures') and \
        not moved.get('detect_graph.replays')


# ----------------------------------------------------------------- card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel runs only on the GPU')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return 'cuda'


@pytest.mark.cuda
@pytest.mark.parametrize('box_dtype', ['float32', 'bf16_derived',
                                       'bfloat16'])
@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('shape,thr', [((12, 5, 1000), 0.7),
                                       ((12, 1000), 0.6),
                                       ((6, 5, 2000), 0.7)])
def test_kernel_equals_plain_scan(dev, shape, thr, kind, box_dtype):
    dt = box_dtype if box_dtype == 'bf16_derived' else getattr(torch,
                                                               box_dtype)
    b, v = smoke.nms_inputs(dev, shape, kind, dt, seed=shape[-1])
    before = nms_op.nms_keep.launches
    keep = nms_op.nms_keep(b, v, thr)
    assert nms_op.nms_keep.launches == before + 1
    plain = nms.greedy_keep_plain(b, v, thr)
    assert torch.equal(keep, plain)
    if b.dtype == torch.float32:
        assert torch.equal(keep.cpu(),
                           nms.greedy_keep_plain(b.cpu(), v.cpu(), thr))
    assert torch.equal(nms_op.nms_keep(b, v, thr), keep)     # run to run
    assert bool((keep <= v).all())


@pytest.mark.cuda
def test_nms_functions_with_tied_scores_match_the_cpu(dev):
    b, v = smoke.nms_inputs('cpu', (12, 1000), 'clustered', seed=5)
    g = torch.Generator().manual_seed(5)
    scores = torch.randint(0, 8, v.shape, generator=g).float() / 8
    for fn in (lambda *a: nms.nms_padded(*a, 0.6, 300),
               lambda *a: nms.nms_sorted_keep(*a, 0.7)):
        want = fn(b, scores, v)
        got = fn(b.to(dev), scores.to(dev), v.to(dev))
        for x, y in zip(got, want):
            assert torch.equal(x.cpu(), y)


def detector(name, dev):
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.synthetic import init_random_weights
    cfg = getattr(configs, name)()
    model = init_random_weights(MV2D(cfg), seed=1)
    return cfg, model.base_detector.to(dev, torch.bfloat16).eval()


@pytest.mark.cuda
@pytest.mark.parametrize('name,mode', [('mv2d_t_r50', 'test'),
                                       ('mv2d_s_r50', 'test'),
                                       ('mv2d_t_r50', 'train')])
def test_graphed_detect_equals_eager(dev, name, mode):
    cfg, det = detector(name, dev)
    pcfg = cfg.proposal_test if mode == 'test' else cfg.proposal_train
    V = cfg.total_views
    calls = [level_feats(det, cfg, V, dev, torch.bfloat16, s)
             for s in (1, 2, 3)]
    c0 = counters.snapshot()
    with torch.no_grad():
        for i, feats in enumerate(calls):
            if i == 2:      # the graph copies the heads' weights each call
                det.rpn_head.rpn_cls.bias.add_(0.5)
            n0, k0 = nms_op.nms_keep.launches, \
                detector2d.roi_align_multilevel.launches
            if i == 0:      # the capture, outside the profiler
                got = det.detect(feats, cfg.image_size, pcfg)
            else:
                runs, got = smoke.kernel_runs(
                    lambda: det.detect(feats, cfg.image_size, pcfg))
                assert runs == {'roi_align_multilevel': 1, 'nms_keep': 2}
            moved = {k: counters[k] - c0.get(k, 0)
                     for k in ('detect_graph.captures',
                               'detect_graph.replays')}
            assert moved == {'detect_graph.captures': 1,
                             'detect_graph.replays': i}
            # the wrappers count the warm-up's and the capture's calls,
            # and no replay's; the device records a replay's kernel runs
            twice = 2 if i == 0 else 0
            assert nms_op.nms_keep.launches - n0 == 2 * twice
            assert detector2d.roi_align_multilevel.launches - k0 == twice
            want = det._detect([f.clone() for f in feats], cfg.image_size,
                               pcfg)
            for x, y in zip(got, want):
                assert x.dtype == y.dtype and torch.equal(x, y)
            assert int(got.valid.sum()) > 0
    # the outputs are the caller's: a later replay does not write them
    kept = [t.clone() for t in got]
    with torch.no_grad():
        det.detect(calls[0], cfg.image_size, pcfg)
    for x, y in zip(got, kept):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_replayed_detect_makes_no_host_sync(dev):
    cfg, det = detector('mv2d_s_r50', dev)
    feats = level_feats(det, cfg, cfg.total_views, dev, torch.bfloat16, 4)
    with torch.no_grad():
        det.detect(feats, cfg.image_size, cfg.proposal_test)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
        try:
            out = det.detect(feats, cfg.image_size, cfg.proposal_test)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    assert int(out.valid.sum()) > 0
