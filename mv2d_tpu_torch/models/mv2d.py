"""MV2D (two-stage detector, pixel key mode), MV2D-T (two frames) and
MV2D-S (roi key mode): the eval forward and the training forward, each
one fixed-shape pass, on a ResNet or VoVNet backbone with the two-stage
or the single-stage (RetinaNet) 2D detector.

Port of `mv2d_tpu/models/mv2d.py:MV2D.__call__`, `forward_train` and
`roi_head_forward` (with the training branches: DN queries, their block
self-attention mask, and the fake key of queries without pixels):

  2D detector -> padded per-view proposals (+ missed GT in training) ->
  per-RoI virtual intrinsics -> separable RoIAlign(p4 ++ 3D PE) -> query
  generator -> epipolar correlation -> attention keys -> masked decoder
  -> NMS-free decode + cross-view BEV merge (eval) or per-layer outputs
  for the losses (training).

The keys: in pixel key mode the k_max gathered p4 pixels that lie in a
correlated RoI, one shared set; in roi key mode each query's correlated
RoIs' 7x7 aligned cells, a set of its own ([R, Cc*49, C]), or with DN
every RoI's cells as one shared set.

Keys follow the reference checkpoint (base_detector.*, neck.*,
roi_head.{position_encoding, query_generator, bbox_head}.*), so
`weights.state_dict_from_jax` output and reference `.pth` files load with
strict=True.  Activations run in the parameter dtype; camera geometry,
sampling coordinates and box decoding run in float32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as tnn
import torch.nn.functional as F

from ..configs import MV2DConfig
from ..core import boxes as box_utils
from ..core.coder import nms_free_decode
from ..core.geometry import (CameraParams, normalize_points,
                             virtual_intrinsics)
from ..core.nms import box3d_multiclass_nms
from ..nn.decoder import NO_DROPOUT, CrossAttentionBoxHead, Dropout
from ..nn.fpn import FPN
from ..nn.pe import PE, padding_mask_at_feature_res
from ..nn.query_generator import QueryGenerator
from ..ops.grid_mask import GridMaskDraws, grid_mask
from ..ops.roi_align import separable_roi_align_views
from ..routes import Routes, from_env
from .correlation import (adjacency_from_correlation, epipolar_in_box,
                          gather_active_keys, in_roi_pixel_masks)
from .detector2d import Proposals, SingleStageDetector, TwoStageDetector

DUMMY_BOX = (50.0, 50.0, 100.0, 100.0)


class _GatherRows(torch.autograd.Function):
    """table[ids] whose backward sums each row's cotangents by a one-hot
    matmul (the same sum in the same order on every run; an index_put
    with accumulate adds them in the order its atomics land)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, dout):
        ids, = ctx.saved_tensors
        onehot = ids.reshape(1, -1) == torch.arange(
            ctx.rows, device=ids.device)[:, None]          # [rows, n]
        return onehot.to(dout.dtype) @ dout.reshape(ids.numel(), -1), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [N, D], ids [...] -> table[ids] [..., D], with a deterministic
    backward."""
    return _GatherRows.apply(table, ids)


class GroundTruth3D(NamedTuple):
    """Padded scene-level 3D GT (bottom-center boxes, lidar frame)."""
    boxes: torch.Tensor    # [G, 9], G = cfg.max_gt
    labels: torch.Tensor   # [G] int
    valid: torch.Tensor    # [G] bool


class GroundTruth2D(NamedTuple):
    """Padded per-view 2D GT (the 2D detector's targets and the missed-GT
    proposals)."""
    boxes: torch.Tensor    # [V, G2, 4] (x1, y1, x2, y2)
    labels: torch.Tensor   # [V, G2] int
    valid: torch.Tensor    # [V, G2] bool


class DNInfo(NamedTuple):
    """Denoising-query bookkeeping for the loss."""
    known_labels: torch.Tensor   # [DN_PAD] (num_classes = negative)
    known_boxes: torch.Tensor    # [DN_PAD, 9] gravity-center boxes
    valid: torch.Tensor          # [DN_PAD] bool
    num_gt: torch.Tensor         # [] valid GT count


class HeadOutputs(NamedTuple):
    all_cls_scores: torch.Tensor   # [L, R, num_classes]
    all_bbox_preds: torch.Tensor   # [L, R, 10]
    query_valid: torch.Tensor      # [R]
    diagnostics: dict              # num_queries; pixel key mode also
                                   # key_active, key_overflow
    # training with DN: the DN rows' outputs [L, DN_PAD, .] and their info
    dn_cls_scores: Optional[torch.Tensor] = None
    dn_bbox_preds: Optional[torch.Tensor] = None
    dn_info: Optional[DNInfo] = None


class Detections(NamedTuple):
    boxes: torch.Tensor            # [max_per_scene, 9] bottom-center
    scores: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor
    diagnostics: dict


class _RoIHead3D(tnn.Module):
    def __init__(self, c: MV2DConfig, flash_sparse: bool = False):
        super().__init__()
        C = c.embed_dims
        self.position_encoding = PE(
            embed_dims=C, depth_num=c.depth_num,
            position_range=c.position_range, with_fpe=c.with_fpe,
            stride=c.stride, num_sine_feats=C // 2)
        self.query_generator = QueryGenerator(
            in_channels=C, conv_out_channels=C, fc_out_channels=C * 4,
            extra_channels=(C * 2, C))
        self.bbox_head = CrossAttentionBoxHead(
            num_classes=c.num_classes, embed_dims=C,
            num_layers=c.num_decoder_layers, num_heads=c.num_heads,
            feedforward_channels=c.feedforward_channels,
            pc_range=c.pc_range, flash_sparse=flash_sparse,
            remat=c.remat_decoder)


class MV2D(tnn.Module):
    def __init__(self, cfg: MV2DConfig, routes: Optional[Routes] = None):
        """`routes` picks the optional kernel routes; by default they are
        read from the JAX package's switches (`routes.from_env`)."""
        super().__init__()
        if cfg.key_mode not in ('pixel', 'roi'):
            raise ValueError(f'key_mode {cfg.key_mode!r}')
        self.cfg = cfg
        self.routes = routes = from_env() if routes is None else routes
        if cfg.detector_type == 'single_stage':
            self.base_detector = SingleStageDetector(
                depth=cfg.depth, num_classes=cfg.num_classes,
                backbone_type=cfg.backbone_type,
                stage_with_dcn=cfg.stage_with_dcn,
                fpn_channels=cfg.fpn_channels, routes=routes,
                frozen_stages=cfg.frozen_stages, remat=cfg.remat)
        elif cfg.detector_type == 'two_stage':
            self.base_detector = TwoStageDetector(
                depth=cfg.depth, num_classes=cfg.num_classes,
                backbone_type=cfg.backbone_type,
                stage_with_dcn=cfg.stage_with_dcn,
                fpn_channels=cfg.fpn_channels,
                rcnn_fc_channels=cfg.rcnn_fc_channels, routes=routes,
                frozen_stages=cfg.frozen_stages, remat=cfg.remat)
        else:
            raise ValueError(f'detector_type {cfg.detector_type!r}')
        self.neck = FPN([cfg.fpn_channels] * 5, cfg.embed_dims, num_outs=1,
                        start_level=2, end_level=2)
        self.roi_head = _RoIHead3D(cfg, routes.flash_sparse)

    def extract_feats(self, imgs: torch.Tensor):
        """[V, H, W, 3] -> (fpn p2..p6, neck p4)."""
        fpn_feats = self.base_detector.extract_feat(imgs)
        return fpn_feats, self.neck(fpn_feats)[0]

    def _prepare_dn(self, gt: GroundTruth3D, noise: torch.Tensor):
        """DN queries: every GT box repeated denoise_scalar times, its
        gravity center moved by noise [S*G, 3] ~ U(-1, 1) times half its
        size times noise_scale; a query whose noise norm exceeds
        denoise_split is a negative (label num_classes)."""
        c = self.cfg
        S, G = c.denoise_scalar, c.max_gt
        if gt.boxes.shape[0] != G:
            raise ValueError(f'GT bucket {gt.boxes.shape[0]} must equal '
                             f'cfg.max_gt {G} (the DN group width)')
        gravity = box_utils.bottom_to_gravity(gt.boxes.float())
        centers = gravity[:, :3].repeat(S, 1)
        sizes = gt.boxes[:, 3:6].float().repeat(S, 1)
        noise = noise.float()
        diff = sizes / 2 + c.denoise_noise_trans
        noisy = normalize_points(centers + noise * diff
                                 * c.denoise_noise_scale, c.pc_range)
        noisy = noisy.clamp(1e-4, 1.0 - 1e-4)
        neg = torch.linalg.norm(noise, dim=1) > c.denoise_split
        labels = gt.labels.long().repeat(S)
        labels = torch.where(neg, torch.full_like(labels, c.num_classes),
                             labels)
        info = DNInfo(known_labels=labels, known_boxes=gravity.repeat(S, 1),
                      valid=gt.valid.repeat(S), num_gt=gt.valid.sum())
        return noisy, info

    def _dn_self_mask(self, match_valid: torch.Tensor,
                      dn_valid: torch.Tensor) -> torch.Tensor:
        """Self-attention allowed mask [Q, Q] with the DN rows first: match
        queries see no DN query, a DN query sees only its own group among
        the DN queries, invalid slots are no key, the diagonal stays."""
        c = self.cfg
        P, G = c.dn_pad, c.max_gt
        Q = P + match_valid.shape[0]
        dev = match_valid.device
        idx = torch.arange(Q, device=dev)
        gid = idx // G
        is_dn = idx < P
        allowed = ~(~is_dn[:, None] & is_dn[None, :])
        allowed &= ~(is_dn[:, None] & is_dn[None, :]
                     & (gid[:, None] != gid[None, :]))
        allowed &= torch.cat([dn_valid, match_valid])[None, :]
        return allowed | torch.eye(Q, dtype=torch.bool, device=dev)

    def _pixel_keys(self, p4, pos, boxes, valid, corr_ids, corr_mask,
                    img_shapes, training: bool):
        """The pixel key mode's keys: (keys [K, C], key_pos [K, C], cross
        [R, K], the DN rows' cross row [K], diagnostics).  In training a
        query with no correlated pixel attends to pixel 0 instead of
        nothing, which also puts that pixel into the union."""
        c = self.cfg
        V, h, w, C = p4.shape
        P = boxes.shape[1]
        R = V * P
        dev = p4.device
        pad_mask = padding_mask_at_feature_res(img_shapes, c.image_size,
                                               (h, w))
        in_roi = in_roi_pixel_masks(boxes, valid, (h, w), c.stride,
                                    c.correlation.expand_stride)
        A = adjacency_from_correlation(corr_ids, corr_mask, R)
        # pixel (v, i) is a key iff it lies in a roi some query correlates to
        qact = A.any(0).reshape(V, P)
        union = (in_roi & qact[:, :, None]).any(1).reshape(-1)
        if training:
            roi_has_pix = in_roi.any(-1).reshape(R)
            empty_q = ~(A & roi_has_pix[None]).any(-1)            # [R]
            union = torch.cat([union[:1] | empty_q.any(), union[1:]])
        n_active = union.sum()
        key_overflow = (n_active - c.k_max).clamp(min=0)
        key_idx, key_active = gather_active_keys(union, c.k_max)
        key_ok = key_active & ~pad_mask.reshape(-1)[key_idx]
        keys = p4.reshape(V * h * w, C)[key_idx]
        key_pos = pos.to(p4.dtype).reshape(V * h * w, C)[key_idx]
        vk = key_idx // (h * w)
        ik = key_idx % (h * w)
        G = in_roi[:, :, ik] & (torch.arange(V, device=dev)[:, None, None]
                                == vk[None, None, :])           # [V, P, K]
        hits = A.reshape(R, V * P).float() @ G.reshape(V * P, -1).float()
        cross = (hits > 0.5) & key_ok[None]                      # [R, K]
        if training:
            fake_col = (key_idx == 0) & key_active
            cross = cross | (empty_q[:, None] & fake_col[None])
        diagnostics = {'key_active': n_active, 'key_overflow': key_overflow}
        return keys, key_pos, cross, union[key_idx] & key_ok, diagnostics

    def _roi_keys(self, roi_feats, corr_ids, corr_mask, valid, shared: bool):
        """The roi key mode's keys from the aligned cells roi_feats
        [R, 7, 7, 2C] (features ++ PE).  Shared (with DN): every RoI's
        cells [R*49, C], a query seeing its correlated RoIs' cells, a DN
        row every valid RoI's.  Otherwise each query's correlated RoIs'
        cells [R, Cc*49, C] through corr_ids (a RoI correlated twice
        counts twice, as in the JAX package), masked by corr_mask.
        -> (keys, key_pos, cross, the DN rows' cross row or None)."""
        R, s1, s2, C2 = roi_feats.shape
        C, area = C2 // 2, s1 * s2
        cells = roi_feats.reshape(R, area, C2)
        if shared:
            A = adjacency_from_correlation(corr_ids, corr_mask, R)
            flat = cells.reshape(R * area, C2)
            return (flat[:, :C], flat[:, C:],
                    A.repeat_interleave(area, 1),
                    valid.repeat_interleave(area))
        Cc = corr_ids.shape[1]
        kf = gather_rows(cells.reshape(R, area * C2), corr_ids)
        kf = kf.reshape(R, Cc * area, C2)                      # [R, Cc*A, 2C]
        return (kf[..., :C], kf[..., C:],
                corr_mask.repeat_interleave(area, 1), None)

    def roi_head_forward(self, p4: torch.Tensor, pos: torch.Tensor,
                         proposals: Proposals, cam: CameraParams,
                         img_shapes: torch.Tensor,
                         mean_time_delta: Optional[torch.Tensor] = None,
                         gt: Optional[GroundTruth3D] = None,
                         dn_noise: Optional[torch.Tensor] = None,
                         drop: Dropout = NO_DROPOUT) -> HeadOutputs:
        """The 3D head.  With `gt` (training) and the pixel key mode,
        queries whose RoI has no correlated pixel attend to the fake key
        pixel (view 0, 0, 0); with `dn_noise` the DN queries run first."""
        c = self.cfg
        training = gt is not None
        head = self.roi_head
        V, h, w, C = p4.shape
        P = proposals.boxes.shape[1]
        R = V * P
        dev = p4.device
        boxes = torch.where(proposals.valid[..., None],
                            proposals.boxes.float(),
                            torch.tensor(DUMMY_BOX, device=dev))  # [V, P, 4]
        flat_boxes = boxes.reshape(R, 4)
        flat_valid = proposals.valid.reshape(R)
        view_idx = torch.arange(V, device=dev).repeat_interleave(P)

        Kv = virtual_intrinsics(flat_boxes, cam.intrinsics[view_idx],
                                (c.roi_size, c.roi_size))
        wh = flat_boxes[:, 2:4] - flat_boxes[:, 0:2]
        intrins_ok = (wh >= 4.0).all(1) & flat_valid

        cat = torch.cat([p4, pos.to(p4.dtype)], dim=-1)
        amax = (-(-h // c.roi_size), -(-w // c.roi_size))
        roi_feats = separable_roi_align_views(cat, boxes, 1.0 / c.stride,
                                              c.roi_size, amax)
        roi_feats = roi_feats.reshape(R, c.roi_size, c.roi_size, 2 * C)
        bbox_feats = roi_feats[..., :C]

        ref_pts, _ = head.query_generator(bbox_feats, Kv,
                                          cam.ext_t_inv[view_idx],
                                          intrins_ok)
        ref_pts = normalize_points(ref_pts, c.pc_range)          # [R, 3]

        corr_ids, corr_mask = epipolar_in_box(
            boxes, proposals.valid, cam.trans_mats.float(), c.image_size,
            c.correlation)
        use_dn = training and c.use_denoise and dn_noise is not None
        if c.key_mode == 'pixel':
            keys, key_pos, cross, dn_row, diagnostics = self._pixel_keys(
                p4, pos, boxes, proposals.valid, corr_ids, corr_mask,
                img_shapes, training)
        else:
            keys, key_pos, cross, dn_row = self._roi_keys(
                roi_feats, corr_ids, corr_mask, flat_valid, use_dn)
            diagnostics = {}
        diagnostics['num_queries'] = flat_valid.sum()
        dn_info = None
        if use_dn:
            noisy_refs, dn_info = self._prepare_dn(gt, dn_noise)
            refs = torch.cat([noisy_refs.to(ref_pts.dtype), ref_pts])
            self_allowed = self._dn_self_mask(flat_valid, dn_info.valid)
            cross = torch.cat([dn_row[None].expand(c.dn_pad, -1), cross])
        else:
            # self-attention keys: valid queries only; diagonal kept
            refs = ref_pts
            self_allowed = flat_valid[None, :] | torch.eye(
                R, dtype=torch.bool, device=dev)

        all_cls, all_box = head.bbox_head(refs, keys, key_pos, self_allowed,
                                          cross, drop)
        if mean_time_delta is not None:
            all_box = torch.cat([all_box[..., :8],
                                 all_box[..., 8:10] / mean_time_delta,
                                 all_box[..., 10:]], dim=-1)
        if dn_info is None:
            return HeadOutputs(all_cls, all_box, flat_valid, diagnostics)
        n = c.dn_pad
        return HeadOutputs(all_cls[:, n:], all_box[:, n:], flat_valid,
                           diagnostics, all_cls[:, :n], all_box[:, :n],
                           dn_info)

    def _mean_time_delta(self, cam: CameraParams):
        c = self.cfg
        if c.num_frames < 2:
            return None
        ts = cam.timestamps
        delta = ts[c.num_views:].mean() - ts[:c.num_views].mean()
        return torch.where(delta.abs() < 1e-6, torch.ones_like(delta), delta)

    @torch.no_grad()
    def forward(self, imgs: torch.Tensor, cam: CameraParams,
                img_shapes: torch.Tensor) -> Detections:
        """[V, H, W, 3] images -> scene-level 3D detections (max_per_scene
        slots: bottom-center boxes [., 9], scores, labels, valid)."""
        c = self.cfg
        fpn_feats, p4 = self.extract_feats(imgs)
        proposals = self.base_detector.detect(fpn_feats, c.image_size,
                                              c.proposal_test)
        pos = self.roi_head.position_encoding(p4, cam.img2lidar, img_shapes,
                                              c.image_size)
        out = self.roi_head_forward(p4, pos, proposals, cam, img_shapes,
                                    self._mean_time_delta(cam))
        return self.decode(out)

    def decode(self, out: HeadOutputs) -> Detections:
        """The eval forward's last stage: NMS-free decode of the head's
        last layer, then the cross-view BEV merge."""
        c = self.cfg
        boxes, scores, labels, valid = nms_free_decode(
            out.all_cls_scores[-1].float(), out.all_bbox_preds[-1].float(),
            out.query_valid, c.max_num, c.num_classes, c.position_range)
        boxes = box_utils.gravity_to_bottom(boxes)
        scores_mc = F.one_hot(labels, c.num_classes + 1).to(scores.dtype) \
            * scores[:, None]
        bev = torch.stack([boxes[:, 0], boxes[:, 1], boxes[:, 3],
                           boxes[:, 4], boxes[:, 6]], dim=-1)
        merged = box3d_multiclass_nms(boxes, bev, scores_mc, valid, 0.0,
                                      c.max_per_scene, c.bev_nms_thr,
                                      c.num_classes)
        return Detections(*merged, out.diagnostics)

    # ------------------------------------------------------------ training

    def complement_2d_gt(self, proposals: Proposals,
                         gt2d: GroundTruth2D) -> Proposals:
        """Append the GT boxes the detector missed (max IoU with a valid
        detection below cfg.complement_2d_gt, and at least min_bbox_size
        on each side) as extra proposal slots [V, P + G2]."""
        c = self.cfg
        iou = box_utils.box_iou_xyxy(gt2d.boxes.float(),
                                     proposals.boxes.float())  # [V, G2, P]
        iou = torch.where(proposals.valid[:, None, :], iou,
                          torch.zeros_like(iou))
        missed = iou.max(-1).values < c.complement_2d_gt
        wh = gt2d.boxes[..., 2:4] - gt2d.boxes[..., 0:2]
        big = (wh >= c.proposal_train.min_bbox_size).all(-1)
        return Proposals(
            boxes=torch.cat([proposals.boxes.float(),
                             gt2d.boxes.float()], 1),
            scores=torch.cat([proposals.scores,
                              torch.ones_like(gt2d.boxes[..., 0]).to(
                                  proposals.scores.dtype)], 1),
            labels=torch.cat([proposals.labels,
                              gt2d.labels.to(proposals.labels.dtype)], 1),
            valid=torch.cat([proposals.valid,
                             gt2d.valid & missed & big], 1))

    def forward_train(self, imgs: torch.Tensor, cam: CameraParams,
                      img_shapes: torch.Tensor, gt2d: GroundTruth2D,
                      gt3d: GroundTruth3D, grid: GridMaskDraws,
                      dn_noise: torch.Tensor, drop: Dropout = NO_DROPOUT):
        """Training forward (the reference's MV2D(T).forward_train): grid
        mask -> features -> RPN (or RetinaHead) outputs of the current
        frame's views ->
        detections without gradients, complemented with missed 2D GT ->
        the 3D head with DN.  Returns (HeadOutputs, {'fpn_feats',
        'rpn_scores', 'rpn_deltas', 'proposals'}); the losses are built in
        `train.train_step`."""
        c = self.cfg
        fpn_feats, p4 = self.extract_feats(grid_mask(imgs, grid))
        Vc = c.num_views
        if not c.grad_all and c.num_frames > 1:
            # no gradient through the history frames' features
            fpn_feats = tuple(torch.cat([f[:Vc], f[Vc:].detach()])
                              for f in fpn_feats)
            p4 = torch.cat([p4[:Vc], p4[Vc:].detach()])
        # the 2D head's raw outputs on the current frame's views: the RPN's,
        # or the single-stage detector's RetinaHead's
        dense_head = self.base_detector.bbox_head \
            if c.detector_type == 'single_stage' \
            else self.base_detector.rpn_head
        rpn_scores, rpn_deltas = dense_head([f[:Vc] for f in fpn_feats])
        with torch.no_grad():
            proposals = self.base_detector.detect(
                [f.detach() for f in fpn_feats], c.image_size,
                c.proposal_train)
        proposals = self.complement_2d_gt(proposals, gt2d)
        pos = self.roi_head.position_encoding(p4, cam.img2lidar, img_shapes,
                                              c.image_size)
        out = self.roi_head_forward(p4, pos, proposals, cam, img_shapes,
                                    self._mean_time_delta(cam), gt=gt3d,
                                    dn_noise=dn_noise, drop=drop)
        return out, dict(fpn_feats=fpn_feats, rpn_scores=rpn_scores,
                         rpn_deltas=rpn_deltas, proposals=proposals)

    def rcnn_train_forward(self, fpn_feats, rois: torch.Tensor):
        """R-CNN head on the sampled training RoIs [Vc, S, 4]."""
        return self.base_detector.roi_forward_views(fpn_feats, rois)
