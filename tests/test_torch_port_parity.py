"""The port's acceptance harness `mv2d_tpu_torch.tools.parity` on the CPU,
at the tiny preset (the R50 file with model.preset='tiny'):

  * its reference transcription (`tools/reference_head.py`) against the
    one in `tests/test_torch_golden_head3d.py` that the repository's
    `tools/parity.py` uses: the same dims, the same state dict, the same
    inputs give exactly equal outputs (that module's dims are globals:
    they are set for the comparison and restored afterwards, also after
    the JAX tool, which sets them too);
  * the synthetic stand-in against the JAX tool's `_synthetic_state_dict`
    key for key and value for value, and the load report's matched count
    against its `convert_report`;
  * the golden in float32: every row finite, proposals and no key
    overflow, each row within the CPU golden's record
    (`docs/PARITY.md:115-123`): 1e-5 for pe, virtual_intrinsics and
    roi_align, 1e-3 for decoder_cls and decoder_box;
  * the golden catching the bug it once caught: the PE frustum weight's
    input channels in coord-major order (c*D + d) on the port's side;
  * the CLI end to end with --synthetic, then with the stand-in saved as
    a checkpoint.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from mv2d_tpu_torch.synthetic import camera_rig          # noqa: E402
from mv2d_tpu_torch.tools import parity, reference_head  # noqa: E402
from mv2d_tpu_torch.tools.common import (build_model_config,  # noqa: E402
                                         load_cli_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R50_FILE = os.path.join(REPO, 'configs', 'mv2d',
                        'mv2d_r50_frcnn_two_frames_1408x512_ep24.py')
TINY = ["model.preset='tiny'"]
# the CPU golden's record, docs/PARITY.md:115-123
ROW_TOL = {'pe': 1e-5, 'virtual_intrinsics': 1e-5, 'roi_align': 1e-5,
           'decoder_cls': 1e-3, 'decoder_box': 1e-3}
# the dims globals of tests/test_torch_golden_head3d.py
GLOBALS = ('C', 'HEADS', 'LAYERS', 'FF', 'DEPTH_NUM', 'NUM_CLASSES', 'V',
           'PAD', 'STRIDE', 'FH', 'FW', 'ROI', 'PC_RANGE', 'POS_RANGE',
           'TOPK', 'MAX_NUM')
PE_W = 'roi_head.position_encoding.position_encoder.0.weight'


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope='module')
def golden_module():
    """`tests.test_torch_golden_head3d` as the JAX tool imports it, its
    dims globals restored when the module's tests end."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import tests.test_torch_golden_head3d as g
    saved = {k: getattr(g, k) for k in GLOBALS}
    try:
        yield g
    finally:
        for k, v in saved.items():
            setattr(g, k, v)


@pytest.fixture(scope='module')
def jax_parity(golden_module):
    """The repository's tools/parity.py, imported as it imports itself."""
    path = os.path.join(REPO, 'tools')
    sys.path.insert(0, path)
    try:
        import parity as jparity
    finally:
        sys.path.remove(path)
    return jparity


@pytest.fixture(scope='module')
def run():
    cfg = build_model_config(load_cli_config(R50_FILE, TINY))
    sd = parity.synthetic_state_dict(cfg)
    model, unmatched = parity.load_report(cfg, sd)
    weights = model.state_dict()
    sample = parity.rig_sample(cfg)
    golden = parity.run_golden(cfg, weights, sd, sample, 8, 'cpu')
    return dict(cfg=cfg, sd=sd, unmatched=unmatched, weights=weights,
                sample=sample, golden=golden)


# ------------------------------------------------- the transcription copy

def _inputs(dims):
    """One set of inputs for every piece of the transcription: the rig's
    cameras 60 degrees apart with a 135-degree field of view (so RoIs
    correlate across views), a padded second view, three RoIs a view."""
    rng = np.random.default_rng(11)
    V, C = dims.V, dims.C
    K, E = camera_rig(V, dims.PAD)
    K[:, 0, 0] = K[:, 1, 1] = 20.0
    lidar2img = K @ np.transpose(E, (0, 2, 1))
    H, W = dims.PAD
    boxes = []
    for v in range(V):
        xy = rng.uniform(0, [W * 0.6, H * 0.6], (3, 2))
        wh = rng.uniform(6, [W * 0.4, H * 0.4], (3, 2))
        boxes.append(np.concatenate([xy, xy + wh], 1).astype(np.float32))
    rois5 = torch.tensor(np.concatenate(
        [np.concatenate([np.full((3, 1), v, np.float32), b], 1)
         for v, b in enumerate(boxes)]))
    Q = 3 * V
    blocked = rng.random((Q, 20)) < 0.5
    blocked[:, 0] = False
    return dict(
        K=K, E=E, lidar2img=lidar2img, boxes=boxes, rois5=rois5,
        p4=torch.tensor(rng.normal(0, 1, (V, C, dims.FH, dims.FW)),
                        dtype=torch.float32),
        img_shapes=np.asarray([[H, W], [H - 8, W - 16]][:V]),
        feat=torch.tensor(rng.normal(0, 1, (Q, C, dims.ROI, dims.ROI)),
                          dtype=torch.float32),
        refs=torch.tensor(rng.uniform(0.05, 0.95, (Q, 3)),
                          dtype=torch.float32),
        keys=torch.tensor(rng.normal(0, 1, (20, C)), dtype=torch.float32),
        kpos=torch.tensor(rng.normal(0, 1, (20, C)), dtype=torch.float32),
        blocked=torch.tensor(blocked))


def _both(dims, g, name, x, sd):
    """Piece `name` of the port's copy and of the test module's
    transcription on the same inputs -> (copy's outputs, test's)."""
    R = reference_head
    if name in ('TPE', 'TQueryGenerator', 'TBoxHead'):
        prefix = parity.HEAD_PREFIXES[
            ('TPE', 'TQueryGenerator', 'TBoxHead').index(name)]
        mods = [getattr(R, name)(dims), getattr(g, name)()]
        sub = {k[len(prefix):]: v for k, v in sd.items()
               if k.startswith(prefix)}
        for m in mods:
            m.load_state_dict(sub)
            m.eval()
        with torch.no_grad():
            if name == 'TPE':
                return [m(x['p4'], x['lidar2img'], x['img_shapes'])
                        for m in mods]
            if name == 'TBoxHead':
                return [m(x['refs'], x['keys'], x['kpos'], x['blocked'])
                        for m in mods]
            tb = [torch.tensor(b) for b in x['boxes']]
            Kv, Ev = g.t_get_box_params(tb, x['K'], x['E'])
            intr = Kv.reshape(-1, 16).float() * 0.1
            return [m(x['feat'], Kv, Ev, intr) for m in mods]
    if name == 't_get_box_params':
        tb = [torch.tensor(b) for b in x['boxes']]
        return (R.t_get_box_params(tb, x['K'], x['E'], dims),
                g.t_get_box_params(tb, x['K'], x['E']))
    n_per_view = [3] * dims.V
    if name == 't_epipolar':
        ours = R.t_epipolar(x['rois5'], n_per_view, x['lidar2img'], 'topk',
                            dims)
        assert any(len(m) > 1 for m in ours), 'the rig must correlate'
        return ours, g.t_epipolar(x['rois5'], n_per_view, x['lidar2img'],
                                  'topk')
    if name == 't_pixel_masks':
        matched = g.t_epipolar(x['rois5'], n_per_view, x['lidar2img'],
                               'topk')
        return (R.t_pixel_masks(x['rois5'], matched, dims),
                g.t_pixel_masks(x['rois5'], matched))
    if name == 't_nms_free_decode':
        rng = np.random.default_rng(5)
        cls = torch.tensor(rng.normal(0, 2, (12, dims.NUM_CLASSES)),
                           dtype=torch.float32)
        box = torch.tensor(rng.normal(0, 20, (12, 10)), dtype=torch.float32)
        return R.t_nms_free_decode(cls, box, dims), g.t_nms_free_decode(
            cls, box)
    assert name == 'np_roi_align_concat'
    box = x['boxes'][0][0]
    return (R.np_roi_align_concat(x['p4'][0], box, dims),
            g._np_roi_align_concat(x['p4'][0], box))


def _flat(out):
    """Tensors and arrays of nested outputs (a list of ints stays one)."""
    if isinstance(out, (list, tuple)) and not all(
            isinstance(o, int) for o in out):
        return [a for o in out for a in _flat(o)]
    return [np.asarray(out)]


@pytest.mark.parametrize('name', [
    'TPE', 'TQueryGenerator', 'TBoxHead', 't_get_box_params', 't_epipolar',
    't_pixel_masks', 't_nms_free_decode', 'np_roi_align_concat'])
def test_transcription_copy_equals_the_tests(golden_module, run, name):
    """Exactly equal outputs (the same arithmetic on the same inputs)."""
    g = golden_module
    # the tiny preset's dims; the test module hard-codes the reference's
    # epipolar sampling (4x4 points, 8 depths)
    dims = reference_head.dims_from_config(run['cfg'])._replace(
        N_SAMP=4, N_DEPTH=8, D_START=0.5, D_END=70.0, EXPAND=2.0)
    for k in GLOBALS:
        setattr(g, k, getattr(dims, k))
    sd = parity.synthetic_state_dict(run['cfg'])
    ours, theirs = _both(dims, g, name, _inputs(dims), sd)
    ours, theirs = _flat(ours), _flat(theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape and np.array_equal(a, b), name


# ---------------------------------------------- stand-in and load report

def test_stand_in_equals_the_jax_tools(jax_parity, run):
    jcfg = jax_parity.build_model_config(
        jax_parity.load_cli_config(R50_FILE, TINY))
    theirs = jax_parity._synthetic_state_dict(jcfg)
    ours = run['sd']
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k], err_msg=k)


def test_load_report_matches_convert_report(jax_parity, run, capsys):
    sd = run['sd']
    _, _, j_unmatched = jax_parity.convert_report(
        {k: v.numpy() for k, v in sd.items()})
    assert j_unmatched == 0 and run['unmatched'] == []
    n = len(sd)
    out = capsys.readouterr().out
    assert f'[convert] {n}/{n} torch keys matched' in out
    # the head subtree: every roi_head key of the port, and nothing else
    model = parity.MV2D(run['cfg'])
    head = {k for k in model.state_dict() if k.startswith('roi_head.')}
    assert set(sd) == head


# ------------------------------------------------------------ the golden

def test_golden_found_proposals_and_kept_every_key(run):
    g = run['golden']
    assert g is not None and g.proposals > 0 and g.key_overflow == 0
    assert set(g.rows) == set(ROW_TOL)


@pytest.mark.parametrize('row', sorted(ROW_TOL))
def test_golden_row_within_the_cpu_record(run, row):
    e = run['golden'].rows[row]
    assert np.isfinite(e) and e <= ROW_TOL[row], (row, e)


def test_golden_catches_a_coord_major_pe_weight(run):
    """The depth-major frustum channels (d*3 + c) read in coord-major
    order (c*D + d) on the port's side only: the pe row must rise."""
    D = run['cfg'].depth_num
    w = run['weights'][PE_W]
    perm = torch.tensor([d * 3 + c for c in range(3) for d in range(D)])
    weights = dict(run['weights'])
    weights[PE_W] = w[:, perm].clone()
    g = parity.run_golden(run['cfg'], weights, run['sd'], run['sample'], 8,
                          'cpu')
    assert g.rows['pe'] > 10 * ROW_TOL['pe'], g.rows
    assert run['golden'].rows['pe'] <= ROW_TOL['pe']


@pytest.mark.parametrize('precision', ['default', 'highest'])
def test_golden_precision_control(run, capsys, precision):
    """--matmul-precision re-runs pe and roi_align in float32 and leaves
    the process's setting as it was."""
    before = torch.get_float32_matmul_precision()
    rows = parity.golden_table(run['cfg'], run['weights'], run['sd'],
                               run['sample'], 8, 'cpu', precision)
    assert torch.get_float32_matmul_precision() == before
    assert f"re-run in float32 under matmul precision '{precision}'" in \
        capsys.readouterr().out
    assert rows['pe'] <= ROW_TOL['pe'] and \
        rows['roi_align'] <= ROW_TOL['roi_align']


def test_golden_skips_the_decoder_rows_in_roi_mode(run, capsys):
    """The transcription builds pixel keys: a roi-key-mode head keeps
    the pe, virtual_intrinsics and roi_align rows only."""
    roi = run['cfg']._replace(key_mode='roi')
    g = parity.run_golden(roi, run['weights'], run['sd'], run['sample'], 8,
                          'cpu')
    assert 'decoder rows skipped: key_mode roi' in capsys.readouterr().out
    assert set(g.rows) == {'pe', 'virtual_intrinsics', 'roi_align'}
    for k, e in g.rows.items():
        assert e <= ROW_TOL[k], (k, e)


def test_no_state_dict_compares_nothing(run, capsys):
    assert parity.golden_table(run['cfg'], run['weights'], None,
                               run['sample'], 8, 'cpu') is None
    assert 'no torch state dict' in capsys.readouterr().out


# ----------------------------------------------------------------- the CLI

def test_cli_synthetic_then_checkpoint(run, tmp_path, capsys):
    args = ['--device', 'cpu', '--cfg-options', *TINY]
    r = parity.main([R50_FILE, '--synthetic', *args])
    out = capsys.readouterr().out
    n = len(run['sd'])
    assert f'[convert] {n}/{n} torch keys matched' in out
    assert '[golden] per-stage max |err|' in out
    for row in ROW_TOL:
        assert f'    {row} ' in out
    assert '[eval] PARITY n/a (synthetic stand-in)' in out
    assert r['unmatched'] == [] and np.isfinite(r['metrics']['NDS'])
    assert r['golden'] == run['golden'].rows

    pth = str(tmp_path / 'stand_in.pth')
    torch.save(run['sd'], pth)
    r2 = parity.main([R50_FILE, pth, '--skip-eval', *args])
    out = capsys.readouterr().out
    assert f'[convert] {n}/{n} torch keys matched' in out
    assert '[eval]' not in out and r2['metrics'] is None
    assert r2['golden'] == r['golden']
