"""The port's kernels as `torch.library` operators and its exported eval
forward, on the CPU:

  * `torch.library.opcheck` on each of the 13 `mv2d` operators (schema,
    fake implementation against the plain one, autograd registration,
    AOT dispatch) at `chip_smoke.op_args`' small shapes, float32;
  * the plain version of B8's operator, from the forward's out and lse,
    against autograd of the plain attention;
  * the NMS fixpoint, a `while_loop` that stops once fixed: `nms_padded`
    equal to JAX's on random boxes and on chains of boxes that each
    suppress the next (long suppression chains inside a 256-box block),
    in fewer rounds than the block has boxes; in an exported program the
    2D NMS is one `mv2d.nms_keep` node, with no loop;
  * the tiny+DCN eval forward exported (`tools.export`), saved, loaded
    and run: equal bit for bit to the direct forward of the same
    signature, and held against JAX's forward on the same weights at
    `test_torch_port_slice`'s tolerances; layer1's fold cache is not
    touched by the trace;
  * `tools.export` as a CLI with `--device cpu`.

Tolerances: as `test_torch_port_slice` (float32 on both sides): scores
1e-4, boxes 2e-3 on valid slots, labels and validity exact.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu.core import nms as jnms                    # noqa: E402
from mv2d_tpu_torch.core import nms as tnms              # noqa: E402
import chip_smoke as smoke                              # noqa: E402
from mv2d_tpu_torch.ops import attention, library       # noqa: E402
from mv2d_tpu_torch.tools import export                  # noqa: E402
from tests.test_torch_port_slice import build            # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def op_args():
    """Each operator's CPU arguments (`chip_smoke.op_args`, float32)."""
    return smoke.op_args('cpu', torch.float32)


@pytest.mark.parametrize('name', sorted(library.OPS))
def test_opcheck(name, op_args):
    torch.set_num_threads(1)
    torch.library.opcheck(getattr(torch.ops.mv2d, name).default,
                          op_args[name])


def test_every_entry_point_is_an_operator():
    from mv2d_tpu_torch import kernels
    assert sorted(o.entry for o in library.OPS.values()) \
        == sorted(kernels.SIGNATURES)


def test_attention_backward_plain_matches_autograd(op_args):
    q, k, v, _, *rest = op_args['masked_attention_bwd']
    bits, ks, kt, qs, qt, out, lse, dout, H = rest
    allowed = attention.mask_from_bits(bits, k.shape[0])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    attention.masked_attention_plain(*leaves, allowed, H).backward(dout)
    got = torch.ops.mv2d.masked_attention_bwd(q, k, v, None, bits, ks, kt,
                                              qs, qt, out, lse, dout, H)
    for g, leaf in zip(got, leaves):
        assert torch.allclose(g, leaf.grad, atol=1e-5, rtol=1e-4)


# ----------------------------------------------------------------- NMS

def nms_boxes(n, rng, chains):
    """n boxes [n, 4] and scores, random, with `chains` runs of n // 8
    boxes in a row, each overlapping the next by IoU 0.7 (and the one
    after it by 0.48), their scores falling along the run and from run to
    run."""
    xy = rng.uniform(0, 400, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (n, 2))], 1)
    scores = rng.uniform(0, 0.5, n)
    per = n // 8
    for c in range(chains):
        x0 = 1000.0 * (c + 1)
        for i in range(per):
            boxes[2 * c * per + i] = [x0 + 3.0 * i, 0.0, x0 + 3.0 * i + 17.0,
                                      10.0]
            scores[2 * c * per + i] = 0.99 - 0.1 * c - 0.001 * i
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize('chains', [0, 3])
def test_nms_padded_matches_jax(chains):
    rng = np.random.default_rng(chains)
    n = 300                         # two blocks of 256
    boxes, scores = nms_boxes(n, rng, chains)
    valid = rng.uniform(size=n) < 0.9
    jb, js, ji, jv = (np.asarray(a) for a in jax.jit(
        jnms.nms_padded, static_argnums=(3, 4))(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
            0.5, 100))
    tb, ts, ti, tv = (a.numpy() for a in tnms.nms_padded(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(valid), 0.5, 100))
    assert np.array_equal(tv, jv) and jv.sum() > 10
    assert np.array_equal(ti[tv], ji[jv])
    assert np.array_equal(ts[tv], js[jv])
    assert np.array_equal(tb[tv], jb[jv])


def test_nms_fixpoint_stops_once_fixed(monkeypatch):
    """Two chains of 25 boxes, each box suppressing the next, resolve in
    about a chain's depth of rounds and stop, far below the 200 the block
    allows."""
    rng = np.random.default_rng(7)
    boxes, scores = nms_boxes(200, rng, 2)
    rounds = []
    body = tnms._fixpoint_body

    def counting(*a):
        rounds.append(1)
        return body(*a)

    monkeypatch.setattr(tnms, '_fixpoint_body', counting)
    b, _, v, _ = tnms._sort_by_score(torch.from_numpy(boxes),
                                     torch.from_numpy(scores),
                                     torch.ones(200, dtype=torch.bool))
    keep = tnms._greedy_suppress_boxes(b, v, 0.5,
                                       tnms.box_utils.box_iou_xyxy)
    assert 10 < len(rounds) < 40, len(rounds)
    # greedy on a chain keeps every other box
    assert keep[:25].tolist() == [i % 2 == 0 for i in range(25)]


# ---------------------------------------------------------- the export

@pytest.fixture(scope='module')
def built():
    torch.set_num_threads(2)
    return build(k_max=40)


@pytest.fixture(scope='module')
def exported(built, tmp_path_factory):
    b = built
    tc = b['tc']
    V, (H, W) = tc.total_views, tc.image_size
    args = export.serve_args(torch.from_numpy(b['imgs']), b['tcam'],
                             torch.from_numpy(b['shapes']))
    model = b['tm']
    program = export.export_model(model, args)
    cache = model.base_detector.backbone._layer1_packed
    path = str(tmp_path_factory.mktemp('export') / export.PROGRAM)
    torch.export.save(program, path)
    return dict(program=program, path=path, args=args, V=V, H=H, W=W,
                cache=cache)


def test_exported_program_holds_the_kernels(exported, built):
    nodes = export.mv2d_nodes(exported['program'])
    tc = built['tc']
    assert nodes.count('mv2d.dcn_conv.default') == 2
    assert nodes.count('mv2d.roi_align.default') == 1
    assert nodes.count('mv2d.bottleneck.default') == 1
    # on the CPU each attention call packs its own mask
    assert nodes.count('mv2d.masked_attention.default') \
        == nodes.count('mv2d.mask_bits.default') \
        == 2 * tc.num_decoder_layers
    # the RPN's and the R-CNN's NMS, each one operator with no loop left
    assert nodes.count('mv2d.nms_keep.default') == 2
    whiles = [n for m in exported['program'].graph_module.modules()
              if isinstance(m, torch.fx.GraphModule)
              for n in m.graph.nodes if 'while_loop' in str(n.target)]
    assert not whiles
    # the trace folds layer1 inside the program; the eager cache is not
    # written
    assert exported['cache'] is None


def test_loaded_program_matches_direct_and_jax(exported, built):
    b = built
    program = torch.export.load(exported['path']).module()
    with torch.no_grad():
        got = program(*exported['args'])
        direct = export.ServeForward(b['tm'])(*exported['args'])
    for g, d in zip(got, direct):
        assert torch.equal(g, d)
    # against JAX's forward (its lidar2img from the host, the program's
    # from intrinsics @ extrinsics^T in float32)
    jout = jax.jit(b['jm'].apply)(b['variables'], jnp.asarray(b['imgs']),
                                  b['jcam'], jnp.asarray(b['shapes']))
    jboxes, jscores, jlabels, jvalid = (np.asarray(x) for x in jout)
    boxes, scores, labels, valid = (t.numpy() for t in got)
    assert np.array_equal(valid, jvalid) and jvalid.sum() > 0
    v = jvalid
    assert np.abs(scores[v] - jscores[v]).max() < 1e-4
    assert np.array_equal(labels[v], jlabels[v])
    assert np.abs(boxes[v] - jboxes[v]).max() < 2e-3


def test_export_cli_on_cpu(tmp_path, capsys):
    out = str(tmp_path / 'exp')
    path = export.main([os.path.join(REPO, 'configs/mv2d/'
                                     'mv2d_r50_frcnn_two_frames_1408x512_'
                                     'ep24.py'), '--out', out,
                        '--device', 'cpu', '--cfg-options',
                        "model.preset='tiny'"])
    text = capsys.readouterr().out
    assert os.path.exists(path) and 'mv2d_tpu_torch.ops.library' \
        in text and 'mv2d.roi_align.default' in text
    sd = torch.load(os.path.join(out, export.WEIGHTS))
    assert 'base_detector.backbone.conv1.weight' in sd
