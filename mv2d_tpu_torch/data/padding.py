"""Bucketed padding: ragged host data -> fixed shapes.

The port's copy of `pad_to` from `mv2d_tpu/data/padding.py`.  The JAX
package's space-to-depth fold of the images is a TPU layout and has no
counterpart here: the port's images stay `[V, H, W, 3]`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_to(arr: np.ndarray, size: int, axis: int = 0, value=0
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad/truncate along axis to `size`; returns (padded, valid_mask)."""
    n = arr.shape[axis]
    valid = np.zeros((size,), bool)
    valid[:min(n, size)] = True
    if n == size:
        return arr, valid
    if n > size:
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(0, size)
        return arr[tuple(sl)], valid
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, size - n)
    return np.pad(arr, pad, constant_values=value), valid
