"""The port's bf16 backbone against the JAX package's own bf16 path: the
yardstick for the C4 / C5 rows of `stage_bench --check`.

One weight set: the port's ResNet-50 with DCN in stages 3-4 under
`init_random_weights(seed=0)`, carried into the JAX `ResNet` through
`convert_torch_state_dict` (the DCN tap kernels reshaped [3, 3, C, F] ->
[9, C, F]).  Input: one view of N(0, 1) images at 64x176 (numpy seed 1).
bf16 on both sides: the JAX parameters cast to bfloat16 as `bench.py`
casts them, the port's module with `.to(torch.bfloat16)`.  The reference
is the port's float32 output; a stage's share is max |bf16 - float32| /
max |float32|.  Each stage's port share is held to at most 1.25 times
the JAX package's: both round in bf16, at other places (the JAX DCN
builds its sample coordinates in bf16, the port in float32), and neither
share is the other's error.

    python -m tests.test_torch_port_bf16 [HxW ...]    # from the repo root

prints the shares at other sizes (default 64x176).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from mv2d_tpu.nn.resnet import ResNet as JResNet         # noqa: E402
from mv2d_tpu.train.checkpoint import convert_torch_state_dict  # noqa: E402
from mv2d_tpu_torch.nn.resnet import ResNet              # noqa: E402
from mv2d_tpu_torch.synthetic import init_random_weights  # noqa: E402

DCN = (False, False, True, True)
RATIO = 1.25


def _jax_variables(port):
    sd = {'base_detector.backbone.' + k: v.numpy()
          for k, v in port.state_dict().items()}
    params, consts = convert_torch_state_dict(sd)
    P = params['base_detector']['backbone']
    for blk in P.values():
        conv2 = blk.get('conv2', {})
        if 'conv_offset' in conv2:                       # DCN taps
            conv2['kernel'] = conv2['kernel'].reshape(9, *conv2['kernel']
                                                      .shape[2:])
    return {'params': P, 'constants': consts['base_detector']['backbone']}


def bf16_shares(size=(64, 176)):
    """{stage: (port share, JAX share)} for C2-C5 on one view of `size`,
    the JAX program compiled once for its four outputs."""
    port = init_random_weights(ResNet(50, DCN), seed=0).eval()
    variables = _jax_variables(port)
    x = np.random.default_rng(1).normal(size=(1, *size, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        ref = [c.numpy() for c in port(torch.from_numpy(x))]
        port_bf = [c.float().numpy() for c in port.to(torch.bfloat16)(
            torch.from_numpy(x).to(torch.bfloat16))]
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                      if a.dtype == np.float32 else a, variables)
    jm = JResNet(50, stage_with_dcn=DCN)
    jax_bf = jax.jit(lambda v, i: jm.apply(v, i, True))(
        bf, jnp.asarray(x, jnp.bfloat16))

    def share(got, want):
        got = np.asarray(got, np.float32)
        return float(np.abs(got - want).max() / np.abs(want).max())
    return {f'C{i + 2}': (share(port_bf[i], ref[i]),
                          share(jax_bf[i], ref[i])) for i in range(4)}


@pytest.fixture(scope='module')
def shares():
    return bf16_shares()


@pytest.mark.parametrize('stage', ['C2', 'C3', 'C4', 'C5'])
def test_port_bf16_errs_no_more_than_jax_bf16(shares, stage):
    port, jx = shares[stage]
    print(f'{stage}: bf16 share of max |float32|: port {port:.4%}, '
          f'JAX {jx:.4%}')
    assert np.isfinite(port) and 0 < port <= RATIO * jx, (port, jx)


if __name__ == '__main__':
    import sys
    jax.config.update('jax_platforms', 'cpu')
    for arg in sys.argv[1:] or ['64x176']:
        h, w = (int(v) for v in arg.split('x'))
        row = bf16_shares((h, w))
        print(f'{h}x{w}: ' + ', '.join(
            f'{k} port {p:.2%} / JAX {j:.2%}' for k, (p, j) in row.items()),
            flush=True)
