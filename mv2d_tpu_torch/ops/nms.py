"""Greedy 2D NMS as a hand-written CUDA kernel (`csrc/nms.cu`).

`nms_keep(boxes, valid, iou_threshold)` takes score-sorted boxes
[..., N, 4] (x1, y1, x2, y2) with validity [..., N] and returns the greedy
keep mask [..., N]: box j is kept when it is valid and no earlier kept box
has IoU > iou_threshold with it.  On CUDA tensors it is two launches, a
bitmask of the pairs' IoU tests and a sweep a warp a row, with no host
round trip, so a CUDA graph can hold it; on any other device it is the
plain version, `core.nms`'s blocked scan with its fixpoint, whose keep mask
the kernel equals bit for bit (the IoU in `box_iou_xyxy`'s arithmetic and
order, and the threshold rounded, in the boxes' dtype, as PyTorch compares
a tensor with a Python scalar).  Runs `mv2d::nms_keep`; the mask's words
are scratch of the caller's allocator.
"""
from __future__ import annotations

import math

import torch

from .. import kernels


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """The greedy keep mask [..., N] of score-sorted boxes [..., N, 4]
    (float32 or bfloat16) and validity [..., N], through `mv2d::nms_keep`."""
    return torch.ops.mv2d.nms_keep(boxes.detach(), valid,
                                   float(iou_threshold))


def nms_keep_plain(boxes, valid, iou_threshold):
    """`mv2d::nms_keep` on the CPU: `core.nms`'s blocked scan."""
    # core.nms calls this module's operator, so it is imported here
    from ..core.nms import greedy_keep_plain
    return greedy_keep_plain(boxes, valid, iou_threshold)


def nms_keep_cuda(boxes, valid, iou_threshold):
    """`mv2d::nms_keep` on CUDA tensors."""
    *lead, N, _ = boxes.shape
    R = math.prod(lead)
    if R > 65535 or N > 64 * 2048:
        raise ValueError(f'nms_keep kernel takes at most 65535 rows of '
                         f'131072 boxes, got {R} of {N}')
    b = boxes.contiguous()
    v = valid.to(torch.bool).contiguous()
    kernels.check_cuda(b, v)
    keep = torch.empty(valid.shape, dtype=torch.bool, device=b.device)
    mask = torch.empty((R, N, -(-N // 64)), dtype=torch.int64,
                       device=b.device)
    # `iou > thr` compares in the IoU's dtype: the threshold rounded to it
    thr = torch.tensor(float(iou_threshold), dtype=b.dtype).item()
    kernels.launch('mv2d_nms_keep', b.data_ptr(), v.data_ptr(),
                   keep.data_ptr(), mask.data_ptr(), R, N, thr,
                   kernels.dtype_code(b))
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0
