"""The port's optional kernel routes (frozen copy of its `Routes` tuple): the
reference takes none of them, so only the tuple's shape is kept."""
from __future__ import annotations

from typing import NamedTuple


class Routes(NamedTuple):
    fused_stages: str = '1'
    dcn_train_fused: bool = False
    flash_sparse: bool = False
    align_v2: bool = False
