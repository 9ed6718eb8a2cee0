"""Model FLOPs of a scene (the eval forward) or of a step (training), from
the configuration's shapes at its caps: every view, 1000 RPN proposals a
view into the R-CNN, `max_per_img` detections a view into the 3D head
(and the missed-GT slots and the DN queries in training), k_max keys in
the pixel key mode, each query's correlated RoIs' cells in the roi key
mode.  So the count stays the same whatever implements the model.

Counted: the products of every learned layer (convolutions, the DCN
contraction and its offset conv, linears), the attention products dense
(4 Q K C a call: Q K^T and P V, as the port's `tools/get_flops` counts
them), and the PE's frustum rays (a 3x3 product a pixel); the bilinear
sampling of DCN (9 FLOPs a sample and channel) and of RoIAlign (49 bins x
4 samples x 4 corners x 2 a RoI and channel, two samples a bin and axis)
as `get_flops` counts them.  Not counted: elementwise work, softmax, NMS,
top-k, and what only an implementation adds (one-hot gathers, dense
separable RoIAlign).  A training step adds the backward of what is
trained: twice the forward's products (the input's and the weights'
gradients) for every layer after the frozen stages, less the input
gradient of the first trained layer's convolutions; the sampling terms'
backward counts 16 FLOPs a DCN sample and channel, and RoIAlign's its
forward again.  The 2D detector's detections in training (no gradient)
count their forward only.
"""
from __future__ import annotations

from typing import Dict

PEAK_BF16 = 989e12
STAGE_BLOCKS = {10: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def conv(n: int, cin: int, cout: int, k: int = 1) -> int:
    """2 x n output positions x cin x cout x k^2."""
    return 2 * n * cin * cout * k * k


def backbone(c: dict, views: int) -> Dict[str, int]:
    """ResNet (pytorch style: the stride on the 3x3 conv) -> {'frozen',
    'trained', 'first' (the trained stages' convolutions that read a
    frozen input), 'sampling' (DCN's bilinear samples x channels)}."""
    H, W = c['image_size']
    h, w = _out(H, 7, 2, 3), _out(W, 7, 2, 3)
    out = dict(frozen=conv(views * h * w, 3, 64, 7), trained=0, first=0,
               sampling=0)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin, p = 64, 64
    frozen = max(c['frozen_stages'], 1)
    for s, n in enumerate(STAGE_BLOCKS[c['depth']]):
        key = 'frozen' if s < frozen else 'trained'
        for b in range(n):
            st = 1 if (s == 0 or b > 0) else 2
            ho, wo = _out(h, 3, st, 1), _out(w, 3, st, 1)
            ni, no = views * h * w, views * ho * wo
            f1 = conv(ni, cin, p)
            fd = conv(no, cin, 4 * p) if b == 0 else 0
            if c['stage_with_dcn'][s]:
                f2 = conv(no, p, 27, 3) + 2 * no * 9 * p * p
                out['sampling'] += no * 9 * p
            else:
                f2 = conv(no, p, p, 3)
            out[key] += f1 + f2 + conv(no, p, 4 * p) + fd
            if key == 'trained' and s == frozen and b == 0:
                out['first'] += f1 + fd
            cin, h, w = 4 * p, ho, wo
        p *= 2
    return out


def level_sizes(c: dict):
    """(h, w) of the FPN levels p2..p6."""
    H, W = c['image_size']
    h, w = _out(_out(H, 7, 2, 3), 3, 2, 1), _out(_out(W, 7, 2, 3), 3, 2, 1)
    out = []
    for _ in range(4):
        out.append((h, w))
        h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    out.append(((out[-1][0] + 1) // 2, (out[-1][1] + 1) // 2))
    return out


def fpn(c: dict, views: int) -> int:
    C = c['fpn_channels']
    n = [views * h * w for h, w in level_sizes(c)[:4]]
    return sum(conv(m, ci, C) + conv(m, C, C, 3)
               for m, ci in zip(n, (256, 512, 1024, 2048)))


def neck(c: dict, views: int) -> int:
    h, w = level_sizes(c)[2]
    C = c['embed_dims']
    return conv(views * h * w, c['fpn_channels'], C) + \
        conv(views * h * w, C, C, 3)


def rpn_head(c: dict, views: int) -> int:
    C = c['fpn_channels']
    return sum(conv(views * h * w, C, C, 3) + conv(views * h * w, C, 3)
               + conv(views * h * w, C, 12) for h, w in level_sizes(c))


def rcnn_head(c: dict, rois: int) -> int:
    C, F, K = c['fpn_channels'], c['rcnn_fc_channels'], c['num_classes']
    return conv(rois, C * 49, F) + conv(rois, F, F) + \
        conv(rois, F, K + 1) + conv(rois, F, 4 * K)


def roi_align(rois: int, channels: int) -> int:
    return rois * channels * 49 * 4 * 4 * 2


def pe(c: dict, views: int) -> int:
    h, w = level_sizes(c)[2]
    n, C, D = views * h * w, c['embed_dims'], c['depth_num']
    f = 2 * n * 9 + conv(n, 3 * D, 4 * C) + conv(n, 4 * C, C)
    if c['with_fpe']:
        f += 2 * conv(n, C, C)
    return f + conv(n, 3 * (C // 2), 4 * C) + conv(n, 4 * C, C)


def query_generator(c: dict, R: int) -> int:
    C = c['embed_dims']
    # the layers, then the unprojection of each RoI's centre: a 4x4 by 4x4
    # and a 4x4 by 4 product
    return conv(R * 49, C, C, 3) + conv(R, C, 4 * C) + \
        conv(R, 4 * C + 16, 2 * C) + conv(R, 2 * C, C) + conv(R, C, 3) + \
        R * 2 * (64 + 16)


def decoder(c: dict, Q: int, K: int, per_query: bool) -> int:
    """The box head: query embedding, the layers (self-attention over the
    Q queries, cross-attention over K keys, shared or each query's own,
    FFN) and every layer's branches."""
    C, Fd, L = c['embed_dims'], c['feedforward_channels'], \
        c['num_decoder_layers']
    nk = Q * K if per_query else K            # key rows projected
    layer = (4 * conv(Q, C, C) + 4 * Q * Q * C                  # self
             + 2 * conv(Q, C, C) + 2 * conv(nk, C, C)           # cross
             + 4 * Q * K * C
             + conv(Q, C, Fd) + conv(Q, Fd, C)                  # FFN
             + 2 * conv(Q, C, C) + conv(Q, C, c['num_classes'])  # cls
             + 2 * conv(Q, C, C) + conv(Q, C, 10))              # reg
    return conv(Q, 3 * C // 2, C) + conv(Q, C, C) + L * layer


def head_shapes(c: dict, views: int, train: bool):
    """(R queries of the RoIs, Q with DN, K keys, per-query keys)."""
    slots = c['proposal_test']['max_per_img'] + (c['max_gt2d'] if train
                                                 else 0)
    R = views * slots
    dn = train and c['use_denoise']
    Q = R + (c['denoise_scalar'] * c['max_gt'] if dn else 0)
    if c['key_mode'] == 'pixel':
        return R, Q, c['k_max'], False
    if dn:                      # every RoI's cells, one shared set
        return R, Q, R * 49, False
    corr = c['correlation']
    kq = corr['topk'] if corr['mode'] == 'topk_matched' else R
    return R, Q, kq * 49, True


def eval_parts(c: dict) -> Dict[str, int]:
    V = c['num_views'] * c['num_frames']
    bb = backbone(c, V)
    R, Q, K, pq = head_shapes(c, V, False)
    C = c['embed_dims']
    rpn_rois = V * c['proposal_test']['rpn_max_per_img']
    return dict(
        backbone=bb['frozen'] + bb['trained'] + 9 * bb['sampling'],
        fpn=fpn(c, V) + neck(c, V), rpn=rpn_head(c, V),
        rcnn=rcnn_head(c, rpn_rois) + roi_align(rpn_rois, c['fpn_channels']),
        pe=pe(c, V),
        head=roi_align(R, 2 * C) + query_generator(c, R)
        + decoder(c, Q, K, pq))


def train_parts(c: dict) -> Dict[str, int]:
    V = c['num_views'] * c['num_frames']
    Vc = c['num_views'] if c['num_frames'] > 1 else V
    bb = backbone(c, V)
    R, Q, K, pq = head_shapes(c, V, True)
    C = c['embed_dims']
    rpn_rois = V * c['proposal_test']['rpn_max_per_img']
    sampled = Vc * 512
    trained = (bb['trained'] + fpn(c, V) + neck(c, V) + rpn_head(c, Vc)
               + rcnn_head(c, sampled) + pe(c, V) + query_generator(c, R)
               + decoder(c, Q, K, pq))
    align = roi_align(sampled, c['fpn_channels']) + roi_align(R, 2 * C)
    return dict(
        forward=bb['frozen'] + trained + 9 * bb['sampling'] + align,
        backward=2 * trained - bb['first'] + 16 * bb['sampling'] + align,
        detect=rpn_head(c, V) + rcnn_head(c, rpn_rois)
        + roi_align(rpn_rois, c['fpn_channels']))


def model_flops(model_cfg: dict, loop: str) -> float:
    """FLOPs of one call of the loop: a scene ('eval') or a step
    ('train')."""
    parts = eval_parts(model_cfg) if loop == 'eval' \
        else train_parts(model_cfg)
    return float(sum(parts.values()))
