"""Shared building blocks, channels-last ([V, H, W, C]) at every function.

Port of `mv2d_tpu/nn/layers.py`.  Convolutions run through F.conv2d on a
permuted view: a contiguous [V, H, W, C] tensor permuted to NCHW is a
channels_last tensor, so no copy is made on either side.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as tnn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None = None, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """[V, H, W, C] x OIHW weight -> [V, Ho, Wo, O]."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride, padding)
    return y.permute(0, 2, 3, 1)


def rematerialized(module: tnn.Module, *args,
                   kwargs: Optional[Callable[[], dict]] = None):
    """module(*args, **kwargs()) with its activations recomputed in the
    backward instead of kept (non-reentrant `torch.utils.checkpoint`;
    JAX's `nn.remat`).  The recompute reads the parameters and buffers
    the first call read: under `torch.func.functional_call` (the mixed
    precision step's bfloat16 copies) the module holds the copies only
    while that call lasts, and the backward comes after it.  `kwargs` is
    called anew for each run, so that the recompute can be given fresh
    stateful arguments (a dropout generator at the same state).  No
    global RNG state is saved: nothing here draws from one."""
    params = {**dict(module.named_parameters()),
              **dict(module.named_buffers())}

    def run(*a):
        return torch.func.functional_call(
            module, params, a, kwargs() if kwargs else None)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def linear(x: torch.Tensor, m: tnn.Linear) -> torch.Tensor:
    """nn.Linear applied in the module's parameter dtype."""
    return m(x.to(m.weight.dtype))


def conv1x1(x: torch.Tensor, m: tnn.Conv2d) -> torch.Tensor:
    """A 1x1 nn.Conv2d applied to channels-last x as a matmul."""
    w = m.weight
    return F.linear(x.to(w.dtype), w.reshape(w.shape[0], w.shape[1]),
                    m.bias)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 max pool (padding never wins: -inf)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


class FrozenBatchNorm2d(tnn.Module):
    """BatchNorm with frozen statistics (mmdet BN, requires_grad=False,
    norm_eval=True); state-dict keys match torch BatchNorm2d."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        # parameters (reference checkpoints carry them) that never train
        self.weight = tnn.Parameter(torch.ones(num_features),
                                    requires_grad=False)
        self.bias = tnn.Parameter(torch.zeros(num_features),
                                  requires_grad=False)
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))
        self.register_buffer('num_batches_tracked',
                             torch.zeros((), dtype=torch.long))

    def fold(self):
        """(s, b) with BN(x) == x * s + b, computed in float32."""
        s = self.weight.float() / torch.sqrt(self.running_var.float()
                                             + self.eps)
        return s, self.bias.float() - self.running_mean.float() * s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, b = self.fold()
        return x * s.to(x.dtype) + b.to(x.dtype)
