"""A float32 torch transcription of the reference MV2D RoI head: the oracle
of the parity tool's golden (`tools/parity.py`).

It follows the reference line for line (mv2d_head.py:103-186
_bbox_forward, pe.py:84-169 PE.forward, positional_encoding.py:15-96,
query_generator.py:343-405, box_correlation.py:95-193,
cross_attention_head.py:199-238, nms_free_coder.py:49-102), on the
reference's parameter names, so one reference-key state dict loads into
it and into the port's `MV2D`.  It is kept apart from the port's own
modules on purpose: its arithmetic is the reference's, not the port's
(the depth-major frustum flattening `d*3 + c`, the parity-blocked sin/cos
stack of SinePositionalEncoding3D, float64 islands where the reference
has them).  Do not tidy it.

Every size comes from a `HeadDims` record (`dims_from_config`), passed to
each constructor and function.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as tnn
import torch.nn.functional as F


class HeadDims(NamedTuple):
    """The head's sizes.  The correlation constants default to the
    reference's epipolar settings (box_correlation.py: 4x4 samples, 8 LID
    depths over 0.5-70 m, expand_stride 2)."""
    C: int
    HEADS: int
    LAYERS: int
    FF: int
    DEPTH_NUM: int
    NUM_CLASSES: int
    V: int
    PAD: Tuple[int, int]
    STRIDE: int
    ROI: int
    PC_RANGE: Tuple[float, ...]
    POS_RANGE: Tuple[float, ...]
    TOPK: int
    MAX_NUM: int
    N_SAMP: int = 4
    N_DEPTH: int = 8
    D_START: float = 0.5
    D_END: float = 70.0
    EXPAND: float = 2.0

    @property
    def FH(self) -> int:
        return self.PAD[0] // self.STRIDE

    @property
    def FW(self) -> int:
        return self.PAD[1] // self.STRIDE


def dims_from_config(cfg) -> HeadDims:
    """The dims of an `MV2DConfig`'s head on one frame's views."""
    corr = cfg.correlation
    return HeadDims(
        C=cfg.embed_dims, HEADS=cfg.num_heads, LAYERS=cfg.num_decoder_layers,
        FF=cfg.feedforward_channels, DEPTH_NUM=cfg.depth_num,
        NUM_CLASSES=cfg.num_classes, V=cfg.num_views,
        PAD=tuple(cfg.image_size), STRIDE=cfg.stride, ROI=cfg.roi_size,
        PC_RANGE=tuple(cfg.pc_range), POS_RANGE=tuple(cfg.position_range),
        TOPK=corr.topk, MAX_NUM=cfg.max_num, N_SAMP=corr.sample_size,
        N_DEPTH=corr.num_depth, D_START=corr.depth_start,
        D_END=corr.depth_end, EXPAND=corr.expand_stride)


def t_pos2posemb3d(pos, num_pos_feats):
    """ref pe.py:21-33."""
    scale = 2 * math.pi
    pos = pos * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode='floor')
                        / num_pos_feats)
    out = []
    for i in (1, 0, 2):                                  # (y, x, z)
        p = pos[..., i, None] / dim_t
        p = torch.stack((p[..., 0::2].sin(), p[..., 1::2].cos()),
                        dim=-1).flatten(-2)
        out.append(p)
    return torch.cat(out, dim=-1)


def t_sine_pe_3d(mask, num_feats, stride):
    """ref positional_encoding.py:58-96 (normalize=True, scale=2pi);
    mask: [B, N, H, W] bool (True = padding)."""
    eps = 1e-6
    scale = 2 * math.pi
    not_mask = 1 - mask.to(torch.int)
    n_embed = not_mask.cumsum(1, dtype=torch.float32)
    y_embed = not_mask.cumsum(2, dtype=torch.float32)
    x_embed = not_mask.cumsum(3, dtype=torch.float32)
    if stride > 0:
        y_embed = (y_embed - 0.5) * stride
        x_embed = (x_embed - 0.5) * stride
    n_embed = n_embed / (n_embed[:, -1:, :, :] + eps) * scale
    y_embed = y_embed / (y_embed[:, :, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, :, -1:] + eps) * scale
    dim_t = torch.arange(num_feats, dtype=torch.float32)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode='floor')
                        / num_feats)
    outs = []
    for e in (n_embed, y_embed, x_embed):
        p = e[..., None] / dim_t
        p = torch.stack((p[..., 0::2].sin(), p[..., 1::2].cos()),
                        dim=4).flatten(4)
        outs.append(p)
    # channel order (n, y, x) -> [B, N, C, H, W]
    return torch.cat(outs, dim=4).permute(0, 1, 4, 2, 3)


class TSE(tnn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv_reduce = tnn.Conv2d(c, c, 1, bias=True)
        self.conv_expand = tnn.Conv2d(c, c, 1, bias=True)

    def forward(self, x, x_se):
        s = self.conv_expand(F.relu(self.conv_reduce(x_se)))
        return x * torch.sigmoid(s)


class TPE(tnn.Module):
    """ref pe.py:51-169, LID=True, with_fpe=True, adapt_pos3d=True."""
    def __init__(self, dims: HeadDims):
        super().__init__()
        self.dims = dims
        C, DEPTH_NUM = dims.C, dims.DEPTH_NUM
        self.position_encoder = tnn.Sequential(
            tnn.Conv2d(3 * DEPTH_NUM, C * 4, 1), tnn.ReLU(),
            tnn.Conv2d(C * 4, C, 1))
        self.adapt_pos3d = tnn.Sequential(
            tnn.Conv2d(C * 3 // 2, C * 4, 1), tnn.ReLU(),
            tnn.Conv2d(C * 4, C, 1))
        self.fpe = TSE(C)

    def forward(self, x, lidar2img, img_shapes):
        V, PAD, DEPTH_NUM = self.dims.V, self.dims.PAD, self.dims.DEPTH_NUM
        POS_RANGE, C, STRIDE = self.dims.POS_RANGE, self.dims.C, \
            self.dims.STRIDE
        # masks at full res -> nearest interpolate (ref pe.py:146-155)
        masks = x.new_ones((1, V, PAD[0], PAD[1]))
        for i in range(V):
            masks[0, i, :img_shapes[i][0], :img_shapes[i][1]] = 0
        masks = F.interpolate(masks, size=x.shape[-2:]).to(torch.bool)

        # position_encoding (ref pe.py:84-135), float64 islands
        eps = 1e-3
        H, W = x.shape[-2:]
        coords_h = (torch.arange(H).double() + 0.5) * PAD[0] / H - 0.5
        coords_w = (torch.arange(W).double() + 0.5) * PAD[1] / W - 0.5
        index = torch.arange(DEPTH_NUM).double()
        bin_size = (POS_RANGE[3] - 1.0) / (DEPTH_NUM * (1 + DEPTH_NUM))
        coords_d = 1.0 + bin_size * index * (index + 1)
        D = DEPTH_NUM
        coords = torch.stack(
            torch.meshgrid([coords_w, coords_h, coords_d],
                           indexing='ij')).permute(1, 2, 3, 0)  # W, H, D, 3
        coords = torch.cat((coords, torch.ones_like(coords[..., :1])), -1)
        coords[..., :2] = coords[..., :2] * torch.maximum(
            coords[..., 2:3], torch.ones_like(coords[..., 2:3]) * eps)
        img2lidars = torch.tensor(
            np.linalg.inv(lidar2img), dtype=torch.float64)  # [V, 4, 4]
        coords = coords.view(1, 1, W, H, D, 4, 1).repeat(1, V, 1, 1, 1, 1, 1)
        i2l = img2lidars.view(1, V, 1, 1, 1, 4, 4).repeat(1, 1, W, H, D, 1, 1)
        coords3d = torch.matmul(i2l, coords).squeeze(-1)[..., :3]
        for k in range(3):
            coords3d[..., k:k + 1] = \
                (coords3d[..., k:k + 1] - POS_RANGE[k]) / \
                (POS_RANGE[k + 3] - POS_RANGE[k])
        coords3d = coords3d.permute(0, 1, 4, 5, 3, 2).contiguous() \
            .view(V, -1, H, W)                           # channels = d*3 + c
        x_c = coords3d.clamp(min=0, max=1)
        x1 = x_c.clamp(min=1e-5)
        x2 = (1 - x_c).clamp(min=1e-5)
        coords3d = torch.log(x1 / x2).float()            # mmdet inverse_sigmoid
        cpe = self.position_encoder(coords3d)
        cpe = self.fpe(cpe, x)
        sin_embed = t_sine_pe_3d(masks, C // 2, STRIDE)
        sin_embed = self.adapt_pos3d(sin_embed.flatten(0, 1))
        return cpe + sin_embed                           # [V, C, H, W]


class TConvModule(tnn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = tnn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x):
        return F.relu(self.conv(x))


class TQueryGenerator(tnn.Module):
    """ref query_generator.py with the shipped config: 1 shared conv,
    avg pool, 1 shared fc, extra_enc over concat(intrinsic x 0.1)."""
    def __init__(self, dims: HeadDims):
        super().__init__()
        self.dims = dims
        C = dims.C
        self.shared_convs = tnn.ModuleList([TConvModule(C, C)])
        self.shared_fcs = tnn.ModuleList([tnn.Linear(C, C * 4)])
        self.extra_enc = tnn.Sequential(
            tnn.Linear(C * 4 + 16, C * 2), tnn.ReLU(),
            tnn.Linear(C * 2, C), tnn.ReLU())
        self.fc_center = tnn.Linear(C, 3)

    def forward(self, x, intrinsics, extrinsics, intrins_feat):
        x = self.shared_convs[0](x)
        x = F.avg_pool2d(x, self.dims.ROI).flatten(1)
        x = F.relu(self.shared_fcs[0](x))
        x = torch.cat([x, intrins_feat], dim=1).clamp(min=-5e3, max=5e3)
        x = self.extra_enc(x)
        center_pred = self.fc_center(x)
        # center2lidar (ref query_generator.py:334-341), fp32 pred, f64 inv
        cp = center_pred.double()
        ci = torch.cat([cp[:, :2] * cp[:, 2:3], cp[:, 2:3]], dim=1)
        hom = torch.cat([ci, torch.ones_like(ci[:, :1])], dim=1)
        lidar2img = torch.bmm(intrinsics, extrinsics.transpose(1, 2))
        img2lidar = torch.inverse(lidar2img).float()
        center_lidar = torch.bmm(img2lidar,
                                 hom.float()[..., None])[:, :3, 0]
        return center_lidar, center_pred


def t_get_box_params(boxes_per_view, intrinsics, extrinsics, dims: HeadDims):
    """ref mv2d_head.py:51-72 (float64, principal-point shift + scale)."""
    ROI = dims.ROI
    il, el = [], []
    for i, bbox in enumerate(boxes_per_view):
        K = torch.tensor(intrinsics[i], dtype=torch.float64) \
            .repeat(len(bbox), 1, 1)
        E = torch.tensor(extrinsics[i], dtype=torch.float64) \
            .repeat(len(bbox), 1, 1)
        wh_bbox = bbox[:, 2:4] - bbox[:, :2]
        scale = bbox.new_tensor([ROI, ROI])[None].double() / wh_bbox.double()
        K[:, :2, 2] = K[:, :2, 2] - bbox[:, :2].double() - 0.5 / scale
        K[:, :2] = K[:, :2] * scale[..., None]
        il.append(K)
        el.append(E)
    return torch.cat(il, 0), torch.cat(el, 0)


def t_epipolar(rois, num_per_view, lidar2img, mode, dims: HeadDims):
    """ref box_correlation.py epipolar_in_box (topk_matched) on ragged rois
    [Rv, 5->(view, x1, y1, x2, y2)].  Returns per-roi matched GLOBAL roi id
    lists (incl. self first)."""
    V, PAD, TOPK = dims.V, dims.PAD, dims.TOPK
    n_samp, n_depth, d_start, d_end = (dims.N_SAMP, dims.N_DEPTH,
                                       dims.D_START, dims.D_END)
    l2i = torch.tensor(lidar2img, dtype=torch.float64)
    i2l = torch.inverse(l2i)
    trans = torch.matmul(l2i[None], i2l[:, None])        # [i, j, 4, 4]

    R = rois.shape[0]
    t = torch.linspace(0, 1, n_samp)
    gy, gx = torch.meshgrid(t, t, indexing='ij')
    grid = torch.stack([gx, gy], -1).reshape(-1, 2)      # [S, 2]
    wh = rois[:, 3:5] - rois[:, 1:3]
    pts = rois[:, None, 1:3] + wh[:, None] * grid[None]  # [R, S, 2]
    S = n_samp * n_samp

    index = torch.arange(n_depth).float()
    bin_size = (d_end - d_start) / (n_depth * (1 + n_depth))
    depths = d_start + bin_size * index * (index + 1)
    uv = pts[:, :, None, :].expand(R, S, n_depth, 2).double()
    d = depths[None, None, :, None].double()
    hom = torch.cat([uv * d, d.expand(R, S, n_depth, 1),
                     torch.ones(R, S, n_depth, 1).double()], -1)
    view_of = rois[:, 0].long()
    tm = trans[view_of]                                  # [R, V, 4, 4]
    proj = torch.einsum('rvij,rsdj->rvsdi', tm, hom)[..., :3]
    depth_t = proj[..., 2]
    uv_t = (proj[..., :2] / depth_t.clamp_min(1e-2)[..., None]).float()
    ok = torch.ones_like(depth_t, dtype=torch.bool)
    ok[depth_t < d_start] = 0
    ok &= (uv_t[..., 0] >= 0) & (uv_t[..., 0] <= PAD[1] - 1) & \
          (uv_t[..., 1] >= 0) & (uv_t[..., 1] <= PAD[0] - 1)
    ok[torch.arange(R), view_of] = 0                     # exclude own view

    uv_f = uv_t.reshape(R, V, S * n_depth, 2)
    ok_f = ok.reshape(R, V, S * n_depth)
    # membership in target-view rois
    matched = [[] for _ in range(R)]
    offs = np.cumsum([0] + num_per_view)
    for r in range(R):
        matched[r].append(r)                             # self first
        for v in range(V):
            if not ok_f[r, v].any():
                continue
            p = uv_f[r, v][ok_f[r, v]]                   # [n_ok, 2]
            hull = torch.cat([p.min(0)[0], p.max(0)[0]])
            ious = []
            ids = []
            hit_any = False
            for j in range(offs[v], offs[v + 1]):
                b = rois[j, 1:5]
                inb = ((p[:, 0] >= b[0]) & (p[:, 0] <= b[2]) &
                       (p[:, 1] >= b[1]) & (p[:, 1] <= b[3])).any()
                hit_any = hit_any or bool(inb)
                xy1 = torch.maximum(hull[:2], b[:2])
                xy2 = torch.minimum(hull[2:], b[2:])
                inter = (xy2 - xy1).clamp(min=0).prod()
                area_h = (hull[2:] - hull[:2]).prod()
                area_b = (b[2:] - b[:2]).prod()
                ious.append(float(inter / (area_h + area_b - inter + 1e-4)))
                ids.append(j)
            if not hit_any:                              # epipolar_in_view
                continue
            order = np.argsort(-np.asarray(ious), kind='stable')[:TOPK]
            mx = max(ious[o] for o in order)
            for o in order:
                if ious[o] > 0 and (ious[o] > 0.0 or ious[o] > 0.0 * mx):
                    matched[r].append(ids[o])
    return matched


def t_pixel_masks(rois, matched, dims: HeadDims):
    """ref gen_box_correlation (box_correlation.py:95-162): per-roi pixel
    mask [V, h, w] = union of in-box masks of the correlated rois."""
    V, FH, FW, STRIDE = dims.V, dims.FH, dims.FW, dims.STRIDE
    ys = (torch.arange(FH).float() + 0.5) * STRIDE - 0.5
    xs = (torch.arange(FW).float() + 0.5) * STRIDE - 0.5
    m = (dims.EXPAND + 0.5) * STRIDE                     # expand_stride
    R = rois.shape[0]
    in_roi = torch.zeros((R, V, FH, FW), dtype=torch.bool)
    for r in range(R):
        v = int(rois[r, 0])
        b = rois[r, 1:5]
        iy = (ys + m >= b[1]) & (ys - m <= b[3])
        ix = (xs + m >= b[0]) & (xs - m <= b[2])
        in_roi[r, v] = iy[:, None] & ix[None, :]
    out = torch.zeros_like(in_roi)
    for r in range(R):
        for j in matched[r]:
            out[r] |= in_roi[j]
    return out


class TLayer(tnn.Module):
    def __init__(self, dims: HeadDims):
        super().__init__()
        self.attentions = tnn.ModuleList([_Attn(dims), _Attn(dims)])
        self.ffns = tnn.ModuleList([_FFN(dims)])
        self.norms = tnn.ModuleList([tnn.LayerNorm(dims.C) for _ in range(3)])

    def forward(self, q, qpos, k, kpos, cross_blocked):
        x = self.attentions[0].attn(q + qpos, q + qpos, q,
                                    need_weights=False)[0]
        q = self.norms[0](q + x)
        x = self.attentions[1].attn(q + qpos, k + kpos, k,
                                    attn_mask=cross_blocked,
                                    need_weights=False)[0]
        q = self.norms[1](q + x)
        x = self.ffns[0].layers[1](F.relu(self.ffns[0].layers[0][0](q)))
        return self.norms[2](q + x)


class _Attn(tnn.Module):
    def __init__(self, dims: HeadDims):
        super().__init__()
        self.attn = tnn.MultiheadAttention(dims.C, dims.HEADS,
                                           batch_first=False)


class _FFN(tnn.Module):
    def __init__(self, dims: HeadDims):
        super().__init__()
        C, FF = dims.C, dims.FF
        self.layers = tnn.ModuleList(
            [tnn.Sequential(tnn.Linear(C, FF)), tnn.Linear(FF, C)])


class TBoxHead(tnn.Module):
    """ref cross_attention_head.py:199-238 (mmdet-style key tree)."""
    def __init__(self, dims: HeadDims):
        super().__init__()
        self.dims = dims
        C, LAYERS, NUM_CLASSES = dims.C, dims.LAYERS, dims.NUM_CLASSES
        self.query_embedding = tnn.Sequential(
            tnn.Linear(C * 3 // 2, C), tnn.ReLU(), tnn.Linear(C, C))
        self.transformer = tnn.Module()
        self.transformer.decoder = tnn.Module()
        self.transformer.decoder.layers = tnn.ModuleList(
            [TLayer(dims) for _ in range(LAYERS)])
        self.transformer.decoder.post_norm = tnn.LayerNorm(C)
        self.cls_branches = tnn.ModuleList([
            tnn.Sequential(tnn.Linear(C, C), tnn.LayerNorm(C), tnn.ReLU(),
                           tnn.Linear(C, C), tnn.LayerNorm(C), tnn.ReLU(),
                           tnn.Linear(C, NUM_CLASSES))
            for _ in range(LAYERS)])
        self.reg_branches = tnn.ModuleList([
            tnn.Sequential(tnn.Linear(C, C), tnn.ReLU(),
                           tnn.Linear(C, C), tnn.ReLU(),
                           tnn.Linear(C, 10))
            for _ in range(LAYERS)])

    def forward(self, refs, keys, kpos, cross_blocked):
        """refs [Q, 3] normalized; keys/kpos [Q?, K, C] or [K, C];
        cross_blocked [Q, K] bool (True = blocked) or [Q, 1, K] for
        per-query key sets (roi mode runs queries as batch)."""
        C, HEADS = self.dims.C, self.dims.HEADS
        qpos = self.query_embedding(t_pos2posemb3d(refs, C // 2))
        if keys.dim() == 2:                              # pixel mode
            q = torch.zeros_like(qpos)[:, None]
            qp = qpos[:, None]
            k = keys[:, None]
            kp = kpos[:, None]
            mask = cross_blocked
        else:                                            # roi mode: bs = Q
            q = torch.zeros_like(qpos)[None]             # [1, Q, C] seq-first
            qp = qpos[None]
            k = keys.permute(1, 0, 2)                    # [K, Q, C]
            kp = kpos.permute(1, 0, 2)
            # per-(query)batch masks -> [Q*heads, 1, K]
            mask = cross_blocked.repeat_interleave(HEADS, 0)
        outs = []
        for lyr in self.transformer.decoder.layers:
            if keys.dim() == 2:
                q = lyr(q, qp, k, kp, mask)
            else:
                # self-attn folds queries into the sequence (batch=Q):
                # FlattenMHSelfAttention (petr_transformer.py:346-351)
                qq = q.permute(1, 0, 2)                  # [Q, 1, C]
                x = lyr.attentions[0].attn(qq + qp.permute(1, 0, 2),
                                           qq + qp.permute(1, 0, 2), qq,
                                           need_weights=False)[0]
                qq = lyr.norms[0](qq + x)
                q2 = qq.permute(1, 0, 2)                 # [1, Q, C]
                x = lyr.attentions[1].attn(q2 + qp, k + kp, k,
                                           attn_mask=mask,
                                           need_weights=False)[0]
                q2 = lyr.norms[1](q2 + x)
                x = lyr.ffns[0].layers[1](
                    F.relu(lyr.ffns[0].layers[0][0](q2)))
                q = lyr.norms[2](q2 + x)
            outs.append(self.transformer.decoder.post_norm(
                q.reshape(-1, C)))
        ref = torch.log(refs.clamp(1e-5, 1 - 1e-5)
                        / (1 - refs).clamp(min=1e-5))    # inverse_sigmoid
        all_cls, all_box = [], []
        for lvl, out in enumerate(outs):
            cls = self.cls_branches[lvl](out)
            reg = self.reg_branches[lvl](out)
            xy = torch.sigmoid(reg[:, 0:2] + ref[:, 0:2])
            z = torch.sigmoid(reg[:, 4:5] + ref[:, 2:3])
            pr = self.dims.PC_RANGE
            xy = xy * torch.tensor([pr[3] - pr[0], pr[4] - pr[1]]) + \
                torch.tensor([pr[0], pr[1]])
            z = z * (pr[5] - pr[2]) + pr[2]
            box = torch.cat([xy, reg[:, 2:4], z, reg[:, 5:]], dim=1)
            all_cls.append(cls)
            all_box.append(box)
        return torch.stack(all_cls), torch.stack(all_box)


def t_nms_free_decode(cls_scores, bbox_preds, dims: HeadDims):
    """ref nms_free_coder.py:49-102 + gravity->bottom shift
    (cross_attention_head.py:372)."""
    NUM_CLASSES, POS_RANGE = dims.NUM_CLASSES, dims.POS_RANGE
    scores = cls_scores.sigmoid().reshape(-1)
    k = min(dims.MAX_NUM, scores.numel())
    top, idx = scores.topk(k)
    labels = idx % NUM_CLASSES
    code = bbox_preds[torch.div(idx, NUM_CLASSES, rounding_mode='floor')]
    rot = torch.atan2(code[:, 6:7], code[:, 7:8])
    boxes = torch.cat([code[:, 0:2], code[:, 4:5],
                       code[:, 2:4].exp(), code[:, 5:6].exp(), rot,
                       code[:, 8:10]], dim=1)
    # reorder to (x, y, z, w, l, h, rot, vx, vy)
    boxes = torch.cat([boxes[:, 0:3], boxes[:, 3:6], boxes[:, 6:]], dim=1)
    lo = torch.tensor(POS_RANGE[:3])
    hi = torch.tensor(POS_RANGE[3:])
    keep = (boxes[:, :3] >= lo).all(1) & (boxes[:, :3] <= hi).all(1)
    boxes = boxes[keep].clone()
    boxes[:, 2] -= boxes[:, 5] * 0.5                     # gravity -> bottom
    return boxes, top[keep], labels[keep]


def np_roi_align(feat, roi, scale, out=7, samp=2):
    """Numpy aligned RoIAlign (single view, channels-last).

    samp <= 0 = mmcv's adaptive rule (the reference configs use
    sampling_ratio=-1 / 0): per-axis sample count = ceil(bin size),
    count = max(gy * gx, 1) as in mmcv's CUDA kernel."""
    H, W, C = feat.shape

    def bil(y, x):
        if x < -1 or x > W or y < -1 or y > H:
            return np.zeros(C)
        x = min(max(x, 0), W - 1)
        y = min(max(y, 0), H - 1)
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        x1, y1 = min(x0 + 1, W - 1), min(y0 + 1, H - 1)
        lx, ly = x - x0, y - y0
        return (feat[y0, x0] * (1 - ly) * (1 - lx) + feat[y0, x1] * (1 - ly) * lx
                + feat[y1, x0] * ly * (1 - lx) + feat[y1, x1] * ly * lx)

    x1, y1, x2, y2 = [v * scale - 0.5 for v in roi]
    bw, bh = (x2 - x1) / out, (y2 - y1) / out
    if samp > 0:
        gy = gx = samp
    else:
        gy = int(np.ceil(np.float32(bh)))
        gx = int(np.ceil(np.float32(bw)))
    count = max(gy * gx, 1)
    res = np.zeros((out, out, C))
    for i in range(out):
        for j in range(out):
            acc = np.zeros(C)
            for si in range(gy):
                for sj in range(gx):
                    yy = y1 + (i + (si + 0.5) / gy) * bh
                    xx = x1 + (j + (sj + 0.5) / gx) * bw
                    acc += bil(yy, xx)
            res[i, j] = acc / count
    return res


def np_roi_align_concat(feat_vchw, box, dims: HeadDims):
    """Adaptive RoIAlign of one view's [C, H, W] features on one box."""
    return np_roi_align(feat_vchw.permute(1, 2, 0).numpy(), box,
                        1.0 / dims.STRIDE, out=dims.ROI, samp=0)
