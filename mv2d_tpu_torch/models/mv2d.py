"""MV2D / MV2D-T eval forward (pixel key mode), one fixed-shape pass.

Port of `mv2d_tpu/models/mv2d.py:MV2D.__call__` and the non-DN
`roi_head_forward`:

  2D detector -> padded per-view proposals -> per-RoI virtual intrinsics ->
  separable RoIAlign(p4 ++ 3D PE) -> query generator -> epipolar
  correlation -> k_max pixel-key gather -> masked decoder -> NMS-free
  decode + cross-view BEV merge.

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
from ..nn.decoder import CrossAttentionBoxHead
from ..nn.fpn import FPN
from ..nn.pe import PE, padding_mask_at_feature_res
from ..nn.query_generator import QueryGenerator
from ..ops.roi_align import separable_roi_align_views
from .correlation import (adjacency_from_correlation, epipolar_in_box,
                          gather_active_keys, in_roi_pixel_masks)
from .detector2d import Proposals, TwoStageDetector

DUMMY_BOX = (50.0, 50.0, 100.0, 100.0)


class HeadOutputs(NamedTuple):
    all_cls_scores: torch.Tensor   # [L, R, num_classes]
    all_bbox_preds: torch.Tensor   # [L, R, 10]
    query_valid: torch.Tensor      # [R]
    diagnostics: dict              # key_active, key_overflow, num_queries


class Detections(NamedTuple):
    boxes: torch.Tensor            # [max_per_scene, 9] bottom-center
    scores: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor
    diagnostics: dict


class _RoIHead3D(tnn.Module):
    def __init__(self, c: MV2DConfig):
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
            pc_range=c.pc_range, use_flash=c.use_flash_attention)


class MV2D(tnn.Module):
    def __init__(self, cfg: MV2DConfig):
        super().__init__()
        if cfg.detector_type != 'two_stage' or cfg.backbone_type != 'resnet' \
                or cfg.key_mode != 'pixel':
            raise NotImplementedError(
                'the port runs the two-stage ResNet detector in pixel mode')
        self.cfg = cfg
        self.base_detector = TwoStageDetector(
            depth=cfg.depth, num_classes=cfg.num_classes,
            stage_with_dcn=cfg.stage_with_dcn,
            fpn_channels=cfg.fpn_channels,
            rcnn_fc_channels=cfg.rcnn_fc_channels)
        self.neck = FPN([cfg.fpn_channels] * 5, cfg.embed_dims, num_outs=1,
                        start_level=2, end_level=2)
        self.roi_head = _RoIHead3D(cfg)

    def extract_feats(self, imgs: torch.Tensor):
        """[V, H, W, 3] -> (fpn p2..p6, neck p4)."""
        fpn_feats = self.base_detector.extract_feat(imgs)
        return fpn_feats, self.neck(fpn_feats)[0]

    def roi_head_forward(self, p4: torch.Tensor, pos: torch.Tensor,
                         proposals: Proposals, cam: CameraParams,
                         img_shapes: torch.Tensor,
                         mean_time_delta: Optional[torch.Tensor] = None
                         ) -> HeadOutputs:
        c = self.cfg
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

        ref_pts = head.query_generator(bbox_feats, Kv,
                                       cam.ext_t_inv[view_idx], intrins_ok)
        ref_pts = normalize_points(ref_pts, c.pc_range)          # [R, 3]

        corr_ids, corr_mask = epipolar_in_box(
            boxes, proposals.valid, cam.trans_mats.float(), c.image_size,
            c.correlation)
        pad_mask = padding_mask_at_feature_res(img_shapes, c.image_size,
                                               (h, w))
        in_roi = in_roi_pixel_masks(boxes, proposals.valid, (h, w),
                                    c.stride, c.correlation.expand_stride)
        A = adjacency_from_correlation(corr_ids, corr_mask, R)
        # pixel (v, i) is a key iff it lies in a roi some query correlates to
        qact = A.any(0).reshape(V, P)
        union = (in_roi & qact[:, :, None]).any(1).reshape(-1)
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
        # self-attention keys: valid queries only; diagonal kept
        self_allowed = flat_valid[None, :] | torch.eye(
            R, dtype=torch.bool, device=dev)

        all_cls, all_box = head.bbox_head(ref_pts, keys, key_pos,
                                          self_allowed, cross)
        if mean_time_delta is not None:
            all_box = torch.cat([all_box[..., :8],
                                 all_box[..., 8:10] / mean_time_delta,
                                 all_box[..., 10:]], dim=-1)
        diagnostics = {'key_active': n_active, 'key_overflow': key_overflow,
                       'num_queries': flat_valid.sum()}
        return HeadOutputs(all_cls, all_box, flat_valid, diagnostics)

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
