"""layer1's folded weights, kept between forwards (`ResNet.layer1_blocks`).

The backbone folds and packs layer1's blocks for kernel K1 once and folds
them again only after a layer1 parameter or buffer changed.  On the CPU,
at a toy size (ResNet-50, one 32x32 view): after a change made between
two forwards, the second forward equals a fresh model's forward with the
same state, and with no change the second forward folds nothing.  An
edit through `.data` bumps no version, so it is seen only once the state
is loaded again: the known limit of the key.
"""
import pytest

torch = pytest.importorskip('torch')

from mv2d_tpu_torch.nn import resnet                     # noqa: E402
from mv2d_tpu_torch.synthetic import init_random_weights  # noqa: E402


def _net(seed):
    return init_random_weights(resnet.ResNet(50), seed).eval()


def _image():
    g = torch.Generator().manual_seed(3)
    return torch.randn(1, 32, 32, 3, generator=g)


def _change(net, kind):
    blk = net.layer1[1]
    with torch.no_grad():
        if kind == 'load_state_dict':
            net.load_state_dict(_net(1).state_dict())
        elif kind == 'in_place_parameter':
            blk.conv2.weight.mul_(-1.5)
        elif kind == 'in_place_buffer':
            blk.bn3.running_mean.add_(0.25)
        elif kind == 'reassigned':
            blk.conv1.weight.data = blk.conv1.weight.data * 0.5
        elif kind == 'in_place_data_then_reload':
            blk.conv2.weight.data.mul_(-1.5)
            net.load_state_dict(net.state_dict())


@pytest.mark.parametrize('kind', ['load_state_dict', 'in_place_parameter',
                                  'in_place_buffer', 'reassigned',
                                  'in_place_data_then_reload'])
def test_layer1_change_after_a_forward_reaches_the_next(kind):
    torch.set_num_threads(1)
    net, x = _net(0), _image()
    with torch.no_grad():
        before = net(x)[0]
        _change(net, kind)
        got = net(x)[0]
        fresh = _net(2)
        fresh.load_state_dict(net.state_dict())
        want = fresh(x)[0]
    assert not torch.equal(got, before)
    assert torch.equal(got, want)


def test_layer1_edit_through_data_is_not_seen_until_reloaded():
    torch.set_num_threads(1)
    net, x = _net(0), _image()
    with torch.no_grad():
        before = net(x)[0]
        net.layer1[1].conv2.weight.data.mul_(-1.5)
        stale = net(x)[0]
        net.load_state_dict(net.state_dict())
        got = net(x)[0]
        fresh = _net(2)
        fresh.load_state_dict(net.state_dict())
        want = fresh(x)[0]
    assert torch.equal(stale, before)
    assert not torch.equal(got, before)
    assert torch.equal(got, want)


def test_layer1_folds_once(monkeypatch):
    torch.set_num_threads(1)
    net, x = _net(0), _image()
    calls = []
    folded = resnet.Bottleneck.folded

    def counting(self):
        calls.append(self)
        return folded(self)
    monkeypatch.setattr(resnet.Bottleneck, 'folded', counting)
    with torch.no_grad():
        first = net(x)[0]
        assert len(calls) == 3
        again = net(x)[0]
    assert len(calls) == 3
    assert torch.equal(first, again)
    assert all(b['w1'].dtype == x.dtype and b['b1'].dtype == torch.float32
               for b in net.layer1_blocks(x.dtype))
