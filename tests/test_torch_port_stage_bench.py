"""The port's stage benches (`mv2d_tpu_torch/tools/*_bench.py`, their
harness `tools/stage_common.py`) on the CPU, at the tiny preset:

  * each tool's `main` with `--device cpu --iters 1` prints its rows
    with their NMS fixpoint rounds a call, and the JAX pieces and flags
    it does not port print their reasons; `--init random` takes
    `init_random_weights`;
    `train_bench` loads a checkpoint strictly, writes a trace, and reads
    its `--fixture` scene from a rendered `make_synth_fixture`;
  * `train_bench --flops` counts the backward: the step's FLOPs are more
    than twice its forward_train's;
  * the stage functions of `stage_bench`, chained, equal `MV2D.forward`
    bit for bit (two frames, DCN);
  * the same stages on weights bridged from JAX, each fed the JAX stage's
    own inputs, equal the JAX MV2D's `extract_feats`, `detect`, `pe` and
    `roi_head_forward` within 1e-4 of each output's max magnitude (float32
    end to end; `test_torch_port_slice.py`'s tolerance), discrete outputs
    (validity, labels) exactly;
  * `stage_bench --check` runs its rows and its witness (on the CPU both
    sides are the float32 plain path, so every error is 0); the witness
    puts K2's and K4's plain versions where the forward calls the
    kernels, and only while it runs;
  * `bench_rule_weights` gives every BN running variance 1 and rpn_reg /
    fc_reg 0, and the tensors it sets so correspond one to one, through
    `weights.py`'s key map, to the JAX leaves that `bench.py`'s rule sets
    so; its other tensors are N(0, 0.02);
  * the harness's site naming: the innermost frame of the package below
    the harness, from a stack and from profiler events.
The card's numbers (busy ms, syncs by site) come only from `chip_smoke.py`'s
`stages` phase.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu.models.mv2d import MV2D as JMV2D           # noqa: E402
from mv2d_tpu_torch import configs                       # noqa: E402
from mv2d_tpu_torch.models.detector2d import Proposals   # noqa: E402
from mv2d_tpu_torch.models.mv2d import MV2D              # noqa: E402
from mv2d_tpu_torch.routes import Routes                 # noqa: E402
from mv2d_tpu_torch.synthetic import (bench_rule_weights,  # noqa: E402
                                      init_random_weights)
from mv2d_tpu_torch.tools import (detect_stage_bench, micro_bench,  # noqa
                                  misc_bench, roi_stage_bench,
                                  stage_bench, stage_common,
                                  train_bench, train_stage_bench)
from mv2d_tpu_torch.weights import _flatten, torch_key   # noqa: E402
from tests.test_torch_port_slice import build            # noqa: E402

TINY = ['--device', 'cpu', '--preset', 'tiny', '--num-frames', '2',
        '--iters', '1', '--warmup', '0']
TOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


# tool, extra arguments, rows printed, refusals printed
TOOLS = [
    (stage_bench, ['--flash', '--init', 'random'], 6, ['--flash']),
    (detect_stage_bench, [], 5, []),
    (roi_stage_bench, [], 7, ['align', 'keys']),
    (train_stage_bench, ['--no-remat', '--init', 'random'], 4, []),
    (micro_bench, [], 21, ['align (XLA form)', 'dcn (gather)',
                           'bottleneck p512 fused']),
    (misc_bench, [], 11, []),
]


@pytest.mark.parametrize('tool,extra,n_rows,refused', TOOLS,
                         ids=[t[0].__name__.rsplit('.', 1)[-1]
                              for t in TOOLS])
def test_tool_prints_rows(tool, extra, n_rows, refused, capsys):
    out = tool.main(TINY + extra)
    text = capsys.readouterr().out
    rows = out['rows']
    assert len(rows) == n_rows, list(rows)
    for r in rows.values():
        assert np.isfinite(r.host_ms) and r.host_ms > 0
        assert r.busy_ms is None and r.sites is None     # not on the CPU
        assert f'{r.name:40s} {r.host_ms:9.3f} ms' in text
        assert f'nms rounds {r.rounds:g}  syncs n/a (CPU)' in text
    for piece in refused:
        assert f'{piece}: not ported (' in text
    assert text.count('not ported') == len(refused)
    if tool is stage_bench:
        assert 'of the full row' in text
        assert rows['detect'].rounds == rows['full'].rounds > 0
        assert rows['feats'].rounds == rows['head'].rounds == 0


def test_train_bench_step_weights_trace_fixture(tmp_path, capsys):
    """A step on a strictly loaded checkpoint, traced, with --remat
    (taken) and --no-auto-layout (refused); the --fixture scene from a
    rendered make_synth_fixture."""
    import os
    from mv2d_tpu_torch.tools.make_synth_fixture import make_fixture
    from mv2d_tpu_torch.utils.profiling import TRACE_FILE
    model = init_random_weights(MV2D(configs.tiny(num_frames=2), Routes()))
    ckpt = str(tmp_path / 'w.pth')
    torch.save({'meta': {}, 'state_dict': model.state_dict()}, ckpt)
    trace = str(tmp_path / 'trace')
    out = train_bench.main(TINY + ['--remat', '--no-auto-layout', '--no-dn',
                                   '--weights', ckpt, '--trace', trace])
    text = capsys.readouterr().out
    assert np.isfinite(out['ms_per_step']) and np.isfinite(out['loss'])
    assert 'train step:' in text and 'scenes/s' in text
    assert f'loaded weights from {ckpt}' in text
    assert os.path.getsize(os.path.join(trace, TRACE_FILE)) > 0
    assert '--no-auto-layout: not ported (' in text
    assert text.count('not ported') == 1
    fix = str(tmp_path / 'fixture')
    make_fixture(fix, scenes=1, val_scenes=0, image_h=90, image_w=160)
    cfg = configs.tiny(num_views=6, num_frames=2)
    batch = train_bench.fixture_batch(cfg, fix, 'cpu')
    assert batch.imgs.shape == (12, *cfg.image_size, 3)
    assert batch.gt3d.boxes.shape == (cfg.max_gt, 9)
    assert bool(batch.gt3d.valid.any())


def test_train_bench_flops_count_the_backward(capsys):
    from mv2d_tpu_torch.nn.decoder import NO_DROPOUT
    from mv2d_tpu_torch.synthetic import synthetic_train_batch
    from mv2d_tpu_torch.tools.get_flops import count
    from mv2d_tpu_torch.train.train_step import draw_train
    out = train_bench.main(TINY + ['--flops'])
    assert 'roofline @ 989 TF/s bf16' in capsys.readouterr().out
    cfg = configs.tiny(num_frames=2)
    model = bench_rule_weights(MV2D(cfg, Routes()))
    batch = synthetic_train_batch(cfg, seed=0, device='cpu')
    draws = draw_train(cfg, batch.gt2d.boxes.shape[1],
                       torch.Generator().manual_seed(0))
    with torch.no_grad():
        fwd, _, _ = count(lambda: train_stage_bench.forward_train(
            model, batch, draws, NO_DROPOUT, False))
    assert out['flops'] > 2 * fwd > 0, (out['flops'], fwd)


def test_device_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        stage_bench.main(['--preset', 'tiny'])


def test_forward_by_stages_equals_forward():
    cfg = configs.tiny(num_frames=2, stage_with_dcn=(False, False, True,
                                                     True))
    model = init_random_weights(MV2D(cfg, Routes()), seed=3).eval()
    imgs, cam, shapes = stage_common.rig_inputs(cfg, 'cpu', torch.float32,
                                                seed=1)
    want = model(imgs, cam, shapes)
    got = stage_bench.forward_by_stages(model, imgs, cam, shapes)
    assert int(want.valid.sum()) > 0
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    assert got.diagnostics.keys() == want.diagnostics.keys()


def test_check_runs_its_rows(capsys):
    res = stage_bench.main(TINY + ['--check'])['check']
    assert res['_ok']
    rows = {k: v for k, v in res.items() if not k.startswith('_')}
    assert len(rows) == 27
    assert {'backbone C2', 'fpn p6', 'neck p4', 'rpn reg p2', 'rcnn deltas',
            'pe views 2-3', 'head velocity'} <= set(rows)
    assert all(v['err'] == 0.0 and v['scale'] > 0 for v in rows.values())
    assert 'the chains kept the same detections: True' in \
        capsys.readouterr().out
    wit = res['_witness']
    assert set(wit) == {'layer2', 'layer3', 'layer4', 'head cls',
                        'head box', 'head velocity'}
    assert all(v['kernel'] == 0.0 for v in wit.values())
    assert all(wit[k]['plain'] == wit[k]['apart'] == 0.0
               for k in ('head cls', 'head box', 'head velocity'))


def test_witness_swaps_in_the_plain_versions():
    from mv2d_tpu_torch.nn import decoder
    from mv2d_tpu_torch.ops import attention, dcn
    with stage_bench._plain('dcn'):
        assert dcn.dcn_conv is dcn.dcn_conv_plain
    assert dcn.dcn_conv is not dcn.dcn_conv_plain
    with stage_bench._plain('attention'):
        assert decoder.masked_attention is not attention.masked_attention
    assert decoder.masked_attention is attention.masked_attention
    # the module calls the plain version under the swap
    conv = dcn.ModulatedDeformConv(32, 64)
    x = torch.randn(1, 5, 6, 32)
    with torch.no_grad():
        want = conv(x)
        with stage_bench._plain('dcn'):
            assert torch.equal(conv(x), want)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, scale)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope='module')
def bridged():
    torch.set_num_threads(1)
    return build(k_max=40)


def test_stages_match_jax(bridged):
    b = bridged
    jm, v, jc, tm = b['jm'], b['variables'], b['jc'], b['tm']
    imgs, shapes = jnp.asarray(b['imgs']), jnp.asarray(b['shapes'])
    tcam, tshapes = b['tcam'], torch.from_numpy(b['shapes'])
    f = stage_bench.stage_fns(tm, tcam, tshapes)
    jf = jax.jit(lambda v_, i: jm.apply(v_, i, method=JMV2D.extract_feats))
    jfpn, jp4 = jf(v, imgs)
    with torch.no_grad():
        fpn, p4 = f['feats'](torch.from_numpy(b['imgs']))
    for got, want in zip([*fpn, p4], [*jfpn, jp4]):
        _close(got, want)

    pcfg = jc.proposal_test
    jprops = jax.jit(lambda v_, fe: jm.apply(
        v_, fe, jc.image_size, pcfg,
        method=lambda m, fe_, s, c: m.base_detector.detect(fe_, s, c)))(
            v, jfpn)
    with torch.no_grad():
        props = f['detect']([_t(x) for x in jfpn])
    jvalid = np.asarray(jprops.valid)
    assert np.array_equal(props.valid.numpy(), jvalid) and jvalid.any()
    assert np.array_equal(props.labels.numpy()[jvalid],
                          np.asarray(jprops.labels)[jvalid])
    _close(props.boxes.numpy()[jvalid], np.asarray(jprops.boxes)[jvalid])
    _close(props.scores.numpy()[jvalid], np.asarray(jprops.scores)[jvalid])

    jpos = jax.jit(lambda v_, p: jm.apply(
        v_, p, b['jcam'].img2lidar, shapes, jc.image_size,
        method=lambda m, *a: m.pe(*a)))(v, jp4)
    with torch.no_grad():
        pos = f['pe'](_t(jp4))
    _close(pos, jpos)

    jout = jax.jit(lambda v_, p, ps, pr: jm.apply(
        v_, p, ps, pr, b['jcam'], shapes,
        method=lambda m, p_, ps_, pr_, c, s: m.roi_head_forward(
            p_, ps_, pr_, c, s, mean_time_delta=m._mean_time_delta(c))))(
                v, jp4, jpos, jprops)
    with torch.no_grad():
        out = f['head'](_t(jp4), _t(jpos), Proposals(
            *(_t(getattr(jprops, k)) for k in Proposals._fields)))
    qv = np.asarray(jout.query_valid)
    assert np.array_equal(out.query_valid.numpy(), qv) and qv.any()
    _close(out.all_cls_scores.numpy()[:, qv],
           np.asarray(jout.all_cls_scores)[:, qv])
    _close(out.all_bbox_preds.numpy()[:, qv],
           np.asarray(jout.all_bbox_preds)[:, qv])


def test_bench_rule_weights_match_bench_rule(bridged):
    """Port side: the tensors left at 1 / 0.  JAX side: bench.py's rule,
    `'var' in str(path[-1])` -> 1, `rpn_reg` / `fc_reg` in the path -> 0,
    every other float leaf N(0, 0.02), mapped through `torch_key`."""
    cfg = configs.tiny(stage_with_dcn=(False, False, True, True), k_max=40)
    model = bench_rule_weights(MV2D(cfg, Routes()), seed=0)
    sd = {k: t for k, t in model.state_dict().items()
          if t.is_floating_point()}
    ones = {k for k, t in sd.items() if bool((t == 1).all())}
    zeros = {k for k, t in sd.items() if bool((t == 0).all())}
    assert ones == {k for k in sd if k.endswith('running_var')} and ones
    assert zeros == {k for k in sd if 'rpn_reg' in k or 'fc_reg' in k}
    assert zeros
    drawn = torch.cat([t.reshape(-1) for k, t in sd.items()
                       if k not in ones | zeros])
    assert abs(float(drawn.std()) - 0.02) < 1e-3
    assert abs(float(drawn.mean())) < 1e-3

    v = bridged['variables']
    flat = {**_flatten(v['params']), **_flatten(v['constants'])}
    j_ones, j_zeros, j_all, packed = set(), set(), set(), {}
    for path, value in flat.items():
        if not np.issubdtype(np.asarray(value).dtype, np.floating):
            continue
        key, _ = torch_key(path, packed, value)
        j_all.add(key)
        if 'var' in path.rsplit('/', 1)[-1]:
            j_ones.add(key)
        elif 'rpn_reg' in path or 'fc_reg' in path:
            j_zeros.add(key)
    assert j_ones == ones
    assert j_zeros == zeros
    assert j_all == set(sd)


def test_frame_site_names_innermost_package_frame():
    frames = [('/t/python3.12/warnings.py', '_showwarnmsg', 99),
              ('/t/torch/_higher_order_ops/while_loop.py',
               'while_loop_dense', 90),
              ('/r/mv2d_tpu_torch/core/nms.py', 'greedy_fixpoint', 61),
              ('/r/mv2d_tpu_torch/models/mv2d.py', 'forward', 380),
              ('/x/run.py', 'main', 1)]
    assert stage_common.frame_site(frames) == (
        ('core/nms.py', 'greedy_fixpoint'), 61)
    assert stage_common.frame_site(frames[-1:]) == (
        (stage_common.NO_FRAME, ''), None)
    # a sync in torch code that the harness called, under the tool's main
    harness = [('/t/torch/functional.py', 'topk', 5),
               ('/r/mv2d_tpu_torch/tools/stage_common.py', 'sync_sites',
                200),
               ('/r/mv2d_tpu_torch/tools/misc_bench.py', 'main', 90)]
    assert stage_common.frame_site(harness) == (
        (stage_common.NO_FRAME, ''), None)


def _event(name, s, e, host=True, corr=0):
    return stage_common.Event(name, host, s, e, corr, False)


def test_blocked_by_site_takes_the_next_warning():
    """A sync runtime call goes to the site of the first warning within
    MATCH_US after it; a copy counts only if device to host; calls after
    the watched function returned do not count."""
    nms = ('core/nms.py', 'greedy_fixpoint')
    mv2d = ('models/mv2d.py', '_pixel_keys')
    events = [
        _event('cudaMemcpyAsync', 10, 30, corr=7),
        _event('Memcpy DtoH (Device -> Pinned)', 12, 14, host=False, corr=7),
        _event('cudaStreamSynchronize', 30, 40, corr=8),
        _event('cudaMemcpyAsync', 61, 62, corr=10),             # H2D
        _event('cudaStreamSynchronize', 100, 130, corr=11),
        _event('cudaEventSynchronize', 5000, 5010, corr=12),    # no warning
        _event('cudaDeviceSynchronize', 9000, 9500, corr=13),   # after
    ]
    marks = [(45.0, nms), (140.0, mv2d)]
    out = stage_common.blocked_by_site(events, marks, until=8000.0)
    assert out == {nms: (0.03, 2), mv2d: (0.03, 1),
                   (stage_common.NO_FRAME, ''): (0.01, 1)}
