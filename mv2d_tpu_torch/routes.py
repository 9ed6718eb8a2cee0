"""The JAX package's kernel-routing switches, read once per model.

Four environment variables of `mv2d_tpu` choose a kernel that no default
path runs.  `from_env` reads them, with the JAX package's names and
defaults, into a `Routes` tuple when a model is built (`models.mv2d.MV2D`
with no `routes` argument); the modules below it take the tuple's fields
as constructor arguments and read no environment:

  * `MV2D_FUSED_STAGES` ('1' default, 'all'; `mv2d_tpu/nn/resnet.py`):
    '1' runs layer1 through K1, 'all' also the identity tails of the later
    DCN-free stages through B10 (`ops.stage.fused_identity_chain`) while no
    gradient is recorded.  JAX's '0' (layer1 on XLA convs) is a fallback
    with no function of its own, and the port keeps K1 on every CUDA path,
    so '0' raises, as does any other value.
  * `MV2D_DCN_TRAIN_FUSED` ('0' default, '1'; `mv2d_tpu/ops/pallas_dcn.py`):
    '1' trains DCN through K2 forward and the combined backward B13
    (`ops.dcn.dcn_conv_train`) instead of B5 / B6 and two matmuls.
  * `MV2D_FLASH_SPARSE` (unset, '1', '0', 'mixed';
    `mv2d_tpu/ops/pallas_attention.py`): '1' trains the masked attention
    through K4 and the block-sparse backward B14; unset, '0' and 'mixed'
    keep B8.  Another value raises, as the JAX dict lookup does.
  * `MV2D_ALIGN_V2` ('0' default, '1'; `mv2d_tpu/ops/pallas_roi_align.py`):
    '1' runs the R-CNN RoIAlign (the detect pass and the training RoIs)
    through the slab kernel B11 (`ops.roi_align.roi_align_slab`, with B9
    as its backward) instead of K3.  The function is K3's.

These routes exist to hold B10, B11, B13 and B14 against the JAX
package's kernels; on the H100 B10, B13 and B14 are slower than the
default route they replace (PERF.md), and no workload selects them.

The package's other `MV2D_*` variables are not read.  They compute no
function of their own:
they set TPU tiles or layouts (`MV2D_FLASH_BK`, `MV2D_DCN_RB`,
`MV2D_DCN_SW`, `MV2D_ALIGN_FIXED_S`, `MV2D_ALIGN_BANDS`,
`MV2D_ALIGN_OVERFLOW_K`, `MV2D_ALIGN_V3`, `MV2D_NMS_BLOCK`), fall back to
or choose among XLA forms (`MV2D_NO_PALLAS`, `MV2D_SELF_ATTN_XLA`,
`MV2D_EXACT_TOPK`, `MV2D_MAXPOOL`, `MV2D_STEM_GEMM`,
`MV2D_BACKBONE_1X1_DOT`, `MV2D_ALIGN_OH_VJP`), or steer the TPU bench
(`MV2D_BENCH_RETRY`, `MV2D_AUTO_NODONATE`).
"""
from __future__ import annotations

import os
from typing import NamedTuple


class Routes(NamedTuple):
    """Which kernels a model's optional routes take (the defaults: none)."""
    fused_stages: str = '1'           # '1' or 'all'
    dcn_train_fused: bool = False
    flash_sparse: bool = False
    align_v2: bool = False


def _read(var: str, allowed, default: str) -> str:
    value = os.environ.get(var, '') or default
    if value not in allowed:
        raise ValueError(f'{var}={value!r}: expected one of {sorted(allowed)}')
    return value


def from_env() -> Routes:
    """The four switches from the environment; a value the port does not
    take raises ValueError."""
    return Routes(
        fused_stages=_read('MV2D_FUSED_STAGES', ('1', 'all'), '1'),
        dcn_train_fused=_read('MV2D_DCN_TRAIN_FUSED', ('0', '1'),
                              '0') == '1',
        flash_sparse=_read('MV2D_FLASH_SPARSE', ('0', '1', 'mixed'),
                           '0') == '1',
        align_v2=_read('MV2D_ALIGN_V2', ('0', '1'), '0') == '1')
