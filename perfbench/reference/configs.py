"""JAX-free mirrors of the model configuration tuples and presets.

`mv2d_tpu.configs` imports flax through the model modules, so it cannot be
imported where JAX is absent.  These tuples carry the same fields and
defaults as `mv2d_tpu.models.mv2d.MV2DConfig`,
`mv2d_tpu.models.correlation.CorrelationConfig` and
`mv2d_tpu.models.detector2d.DetectionProposalCfg`; the presets mirror
`mv2d_tpu.configs.mv2d_t_r50`, `mv2d_t_r101`, `mv2d_s_r50`, `mv2d_t_v99`
and `tiny`.  `use_flash_attention` is kept for parity with the JAX
presets: it routes the TPU's attention, and the port reads it nowhere
(its shared-key attention runs kernel K4 on every CUDA config).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple


class CorrelationConfig(NamedTuple):
    sample_size: int = 4
    num_depth: int = 8
    depth_start: float = 0.5
    depth_end: float = 70.0
    lid: bool = True
    mode: str = 'topk_matched'    # 'topk_matched' | 'all_matched'
    topk: int = 20
    iou_thr: float = 0.0
    ratio: float = 0.0
    expand_stride: float = 2.0

    @classmethod
    def from_mode_string(cls, mode: str, **kw) -> "CorrelationConfig":
        """Parse 'topk_matched:K:iou_thr:ratio' / 'all_matched'."""
        parts = mode.split(':')
        if parts[0] == 'all_matched':
            return cls(mode='all_matched', **kw)
        assert parts[0] == 'topk_matched', f'unsupported mode {mode}'
        return cls(mode='topk_matched', topk=int(parts[1]),
                   iou_thr=float(parts[2]), ratio=float(parts[3]), **kw)


class DetectionProposalCfg(NamedTuple):
    score_thr: float = 0.05
    nms_pre: int = 1000
    max_per_img: int = 75
    iou_threshold: float = 0.6
    min_bbox_size: float = 8.0
    rpn_nms_pre: int = 1000
    rpn_max_per_img: int = 1000
    rpn_iou_threshold: float = 0.7


class MV2DConfig(NamedTuple):
    num_views: int = 6
    num_frames: int = 2
    image_size: Tuple[int, int] = (512, 1408)
    depth: int = 50
    backbone_type: str = 'resnet'
    detector_type: str = 'two_stage'
    stage_with_dcn: Tuple[bool, ...] = (False, False, True, True)
    frozen_stages: int = 1
    grad_all: bool = True
    num_classes: int = 10
    embed_dims: int = 256
    pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    position_range: Tuple[float, ...] = (-61.2, -61.2, -10.0, 61.2, 61.2,
                                         10.0)
    roi_size: int = 7
    stride: int = 16
    depth_num: int = 64
    with_fpe: bool = True
    key_mode: str = 'pixel'
    k_max: int = 16384
    correlation: CorrelationConfig = CorrelationConfig(topk=20)
    proposal_train: DetectionProposalCfg = DetectionProposalCfg()
    proposal_test: DetectionProposalCfg = DetectionProposalCfg()
    num_decoder_layers: int = 6
    num_heads: int = 8
    feedforward_channels: int = 2048
    dropout: float = 0.1
    fpn_channels: int = 256
    rcnn_fc_channels: int = 1024
    use_denoise: bool = True
    denoise_scalar: int = 10
    denoise_noise_scale: float = 1.25
    denoise_noise_trans: float = 0.0
    denoise_split: float = 0.6
    max_gt: int = 96
    max_gt2d: int = 64
    max_num: int = 300
    max_per_scene: int = 300
    bev_nms_thr: float = 1.0
    stage_loss_weights: Tuple[float, ...] = (0.1,) * 6
    complement_2d_gt: float = 0.4
    remat: bool = False
    remat_decoder: bool = False
    use_flash_attention: bool = False

    @property
    def total_views(self) -> int:
        return self.num_views * self.num_frames

    @property
    def dn_pad(self) -> int:
        return self.denoise_scalar * self.max_gt


PROPOSAL_CFG = DetectionProposalCfg(score_thr=0.05, nms_pre=1000,
                                    max_per_img=75, iou_threshold=0.6,
                                    min_bbox_size=8.0)


def mv2d_t_r50(**overrides) -> MV2DConfig:
    """MV2D-T R50 two-frame 1408x512 (ref: ..._two_frames_1408x512_ep24.py)."""
    cfg = MV2DConfig(
        num_views=6, num_frames=2, image_size=(512, 1408), depth=50,
        stage_with_dcn=(False, False, True, True),
        key_mode='pixel', k_max=16384,
        correlation=CorrelationConfig.from_mode_string(
            'topk_matched:20:0.0:0.0', expand_stride=2.0),
        proposal_train=PROPOSAL_CFG, proposal_test=PROPOSAL_CFG,
        use_denoise=True, denoise_noise_scale=1.25, denoise_split=0.6,
        use_flash_attention=True,
    )
    return cfg._replace(**overrides)


def mv2d_s_r50(**overrides) -> MV2DConfig:
    """MV2D-S R50 single-frame RoI-correlation 1408x512
    (ref: ..._single_frame_roi_1408x512_ep24.py: no DCN, no DN,
    correlation topk_matched:1)."""
    cfg = MV2DConfig(
        num_views=6, num_frames=1, image_size=(512, 1408), depth=50,
        stage_with_dcn=(False, False, False, False),
        key_mode='roi',
        correlation=CorrelationConfig.from_mode_string(
            'topk_matched:1:0.0:0.0', expand_stride=0.0),
        proposal_train=PROPOSAL_CFG, proposal_test=PROPOSAL_CFG,
        use_denoise=False,
    )
    return cfg._replace(**overrides)


def mv2d_t_r101(**overrides) -> MV2DConfig:
    """MV2D-T R101 two-frame 1600x640: the reference's R101 detector base
    (configs/mv2d/detectors/maskrcnn_r101.py) at the higher resolution;
    the same head recipe as mv2d_t_r50."""
    cfg = mv2d_t_r50(depth=101, image_size=(640, 1600), k_max=24576)
    return cfg._replace(**overrides)


def mv2d_t_v99(**overrides) -> MV2DConfig:
    """MV2D-T on a VoVNet-99 backbone (the reference's VoVNetCP) at the
    two-frame recipe, without DCN."""
    cfg = mv2d_t_r50(backbone_type='vovnet', depth=99,
                     stage_with_dcn=(False,) * 4)
    return cfg._replace(**overrides)


def tiny(key_mode: str = 'pixel', num_frames: int = 1,
         **overrides) -> MV2DConfig:
    """Miniature config for tests / CPU dry-runs."""
    cfg = MV2DConfig(
        num_views=2, num_frames=num_frames, image_size=(64, 96), depth=10,
        stage_with_dcn=(False, False, False, False),
        embed_dims=32, depth_num=8, num_decoder_layers=2, num_heads=4,
        feedforward_channels=64, fpn_channels=32, rcnn_fc_channels=64,
        key_mode=key_mode, k_max=64, max_gt=4, denoise_scalar=3,
        correlation=CorrelationConfig(sample_size=2, num_depth=4, topk=2),
        proposal_train=DetectionProposalCfg(
            score_thr=0.05, nms_pre=32, max_per_img=6, min_bbox_size=0.0,
            rpn_nms_pre=64, rpn_max_per_img=32),
        proposal_test=DetectionProposalCfg(
            score_thr=0.05, nms_pre=32, max_per_img=6, min_bbox_size=0.0,
            rpn_nms_pre=64, rpn_max_per_img=32),
        max_num=20, max_per_scene=20,
    )
    return cfg._replace(**overrides)
