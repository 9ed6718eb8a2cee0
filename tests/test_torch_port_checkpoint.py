"""The port's training checkpoints (`mv2d_tpu_torch/train/checkpoint.py`),
on the CPU at the tiny preset.

  * a save / restore round trip gives back the model, the AdamW state and
    the meta bit for bit;
  * a save that raises leaves no file, and `latest_checkpoint` skips a
    cut save's `.tmp` and orders epochs by number;
  * `torch.load(weights_only=True)` reads a checkpoint, and
    `tools.common.load_weights` and `tools.serve.ModelRunner` load it with
    strict=True;
  * `load_from` counts missing and unexpected keys and raises on a shape
    mismatch;
  * layer1's folded blocks refold after a restore.
"""
import os

import pytest

torch = pytest.importorskip('torch')

from mv2d_tpu_torch import configs                       # noqa: E402
from mv2d_tpu_torch.models.mv2d import MV2D              # noqa: E402
from mv2d_tpu_torch.nn.resnet import pack_block          # noqa: E402
from mv2d_tpu_torch.train import checkpoint as ckpt      # noqa: E402
from mv2d_tpu_torch.train.optim import apply_update, make_optimizer  # noqa

TINY = dict(model=dict(preset='tiny', overrides=dict(num_frames=2)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def trained(seed, steps=2):
    """A tiny model and its AdamW after `steps` updates on seeded
    gradients."""
    torch.manual_seed(seed)
    model = MV2D(configs.tiny(num_frames=2))
    opt = make_optimizer(model, total_steps=10)
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for p in model.parameters():
            if p.requires_grad:
                p.grad = torch.randn(p.shape, generator=g)
        apply_update(opt)
    return model, opt


def assert_tree_equal(a, b, path=''):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f'{path}[{i}]')
    else:
        assert a == b, (path, a, b)


META = dict(epoch=3, iter=12, seed=7, world_size=2, config="{'a': 1}")


def test_round_trip_is_bit_equal(tmp_path):
    model, opt = trained(0)
    path = str(tmp_path / 'epoch_3.pth')
    ckpt.save_checkpoint(path, model, opt, META)
    other, other_opt = trained(1, steps=1)
    meta = ckpt.restore_checkpoint(path, other, other_opt)
    assert meta == META
    assert_tree_equal(other.state_dict(), model.state_dict())
    assert_tree_equal(other_opt.state_dict(), opt.state_dict())
    # the optimizer goes on from the restored step count
    from mv2d_tpu_torch.train.optim import updates_done
    assert updates_done(other_opt) == 2
    # the restored state trains on as the saved one does
    for m, o in ((model, opt), (other, other_opt)):
        g = torch.Generator().manual_seed(5)
        for p in m.parameters():
            if p.requires_grad:
                p.grad = torch.randn(p.shape, generator=g)
        apply_update(o)
    assert_tree_equal(other.state_dict(), model.state_dict())


def test_failed_save_leaves_no_file(tmp_path, monkeypatch):
    model, opt = trained(0, steps=1)
    path = str(tmp_path / 'epoch_1.pth')
    real_save = torch.save

    def cut(obj, f, *a, **k):
        real_save({'partial': torch.zeros(3)}, f)
        raise OSError('disk full')
    monkeypatch.setattr(torch, 'save', cut)
    with pytest.raises(OSError, match='disk full'):
        ckpt.save_checkpoint(path, model, opt, META)
    assert os.listdir(tmp_path) == []
    monkeypatch.setattr(torch, 'save', real_save)

    assert ckpt.latest_checkpoint(str(tmp_path / 'absent')) is None
    assert ckpt.latest_checkpoint(str(tmp_path)) is None
    for name in ('epoch_2.pth', 'epoch_10.pth', 'epoch_11.pth.tmp',
                 'epoch_12', 'latest.pth'):
        (tmp_path / name).write_bytes(b'')
    assert ckpt.latest_checkpoint(str(tmp_path)) == \
        str(tmp_path / 'epoch_10.pth')


def test_tools_load_a_checkpoint_strictly(tmp_path):
    from mv2d_tpu_torch.tools.common import build_model, load_weights
    from mv2d_tpu_torch.tools.serve import ModelRunner
    model, opt = trained(0, steps=1)
    path = str(tmp_path / 'epoch_1.pth')
    ckpt.save_checkpoint(path, model, opt, META)
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {'meta', 'state_dict', 'optimizer'}
    assert raw['meta'] == META
    assert_tree_equal(raw['state_dict'], model.state_dict())
    loaded = load_weights(build_model(TINY), path)
    assert_tree_equal(loaded.state_dict(), model.state_dict())
    runner = ModelRunner(TINY, path, 1, 1.0, warmup=False, device='cpu')
    try:
        assert_tree_equal(runner.model.state_dict(), model.state_dict())
    finally:
        runner.close()
    # strict: a checkpoint with a key missing is refused
    raw['state_dict'].pop('roi_head.bbox_head.reg_branches.0.0.weight')
    torch.save(raw, path)
    with pytest.raises(RuntimeError, match='Missing key'):
        load_weights(build_model(TINY), path)


def test_load_from_counts_keys_and_raises_on_shape(tmp_path, capsys):
    model, _ = trained(0, steps=0)
    sd = model.state_dict()
    gone = 'roi_head.bbox_head.reg_branches.0.0.weight'
    sd.pop(gone)
    sd['extra.weight'] = torch.zeros(2)
    path = str(tmp_path / 'init.pth')
    torch.save({'state_dict': sd}, path)
    target, _ = trained(1, steps=0)
    before = target.state_dict()[gone].clone()
    counts, missing, unexpected = ckpt.load_from(target, path)
    assert counts == dict(loaded=len(sd) - 1, missing=1, unexpected=1)
    assert missing == [gone] and unexpected == ['extra.weight']
    assert 'missing=1 unexpected=1' in capsys.readouterr().out
    for k, v in target.state_dict().items():
        assert torch.equal(v, before if k == gone else sd[k]), k
    # a bare state dict loads too; a shape that differs raises
    sd = model.state_dict()
    sd['roi_head.bbox_head.reg_branches.0.0.weight'] = torch.zeros(3, 3)
    torch.save(sd, path)
    with pytest.raises(ValueError, match='shape mismatch'):
        ckpt.load_from(target, path)
    with pytest.raises(ValueError, match='.pth'):
        ckpt.load_from(target, str(tmp_path / 'orbax_dir'))


def test_layer1_refolds_after_restore(tmp_path):
    a, opt_a = trained(0, steps=0)
    b, _ = trained(1, steps=0)
    bb = a.base_detector.backbone
    stale = bb.layer1_blocks(torch.float32)         # folded from a
    path = str(tmp_path / 'b.pth')
    ckpt.save_checkpoint(path, b, None, {})
    ckpt.restore_checkpoint(path, a)
    now = bb.layer1_blocks(torch.float32)
    want = [pack_block(blk.folded(), torch.float32)
            for blk in b.base_detector.backbone.layer1]
    for got, old, ref in zip(now, stale, want):
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
        assert any(not torch.equal(old[k], ref[k]) for k in ref)
