"""Result formatting: model outputs -> eval inputs / nuScenes submission JSON.

The port's copy of `mv2d_tpu/eval/results.py`.  The model's `Detections`
are tensors on its device, the scores possibly bfloat16:
`detections_numpy` brings them to the host (float32 boxes and scores,
integer labels, boolean valid) before `boxes_to_pred_dict`.

Re-implements the reference's format_results (ref:
custom_nuscenes_dataset.py:324-368 + output_to_nusc_box / lidar_nusc_box_to
global): per-sample lidar-frame boxes are converted to global-frame
nuScenes submission records using the ego/global poses from the infos pkl.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.nuscenes import CLASSES

DEFAULT_ATTRIBUTES = {
    'car': 'vehicle.parked', 'truck': 'vehicle.parked',
    'trailer': 'vehicle.parked', 'bus': 'vehicle.moving',
    'construction_vehicle': 'vehicle.parked', 'bicycle': 'cycle.without_rider',
    'motorcycle': 'cycle.without_rider', 'pedestrian': 'pedestrian.standing',
    'traffic_cone': '', 'barrier': ''}
SPEED_ATTR = {
    'car': 'vehicle.moving', 'truck': 'vehicle.moving',
    'trailer': 'vehicle.moving', 'bus': 'vehicle.moving',
    'construction_vehicle': 'vehicle.moving',
    'bicycle': 'cycle.with_rider', 'motorcycle': 'cycle.with_rider',
    'pedestrian': 'pedestrian.moving'}


def quaternion_from_yaw(yaw: float) -> List[float]:
    # nuScenes boxes: yaw about +z, with the devkit's box frame offset of
    # -pi/2 between lidar yaw and nuScenes yaw handled by the converter
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def quat_to_rot(q) -> np.ndarray:
    w, x, y, z = q
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def derive_attr(name: str, speed: float, velocity_thresh: float = 0.2) -> str:
    """Attribute defaulting used for submissions (ref: mmdet3d
    NuScenesDataset.DefaultAttribute + velocity heuristic in
    _format_bbox)."""
    if name in SPEED_ATTR and speed > velocity_thresh:
        return SPEED_ATTR[name]
    return DEFAULT_ATTRIBUTES.get(name, '')


def _l2e_of(info: Optional[dict]):
    if not info or 'lidar2ego_rotation' not in info:
        return None, None
    return (quat_to_rot(info['lidar2ego_rotation']),
            np.asarray(info.get('lidar2ego_translation', np.zeros(3))))


def detections_numpy(det) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """A `models.mv2d.Detections` -> (boxes [N, 9] float32, scores [N]
    float32, labels [N] int64, valid [N] bool) on the host."""
    return (det.boxes.float().cpu().numpy(),
            det.scores.float().cpu().numpy(),
            det.labels.long().cpu().numpy(),
            det.valid.bool().cpu().numpy())


def boxes_to_pred_dict(boxes: np.ndarray, scores: np.ndarray,
                       labels: np.ndarray, valid: np.ndarray,
                       info: Optional[dict] = None) -> dict:
    """Model outputs (bottom-center lidar boxes) -> evaluator pred dict.

    `info` (the sample's infos-pkl entry) supplies lidar->ego calibration
    for the evaluator's exact class-range ego distances and is also used
    to derive submission attributes from predicted speed."""
    m = np.asarray(valid, bool)
    b = np.asarray(boxes)[m].astype(np.float64)
    # evaluator compares gravity-center-free BEV quantities; keep lidar frame
    names = np.asarray([CLASSES[i] for i in np.asarray(labels)[m]])
    attrs = np.asarray([derive_attr(str(n), float(np.linalg.norm(bb[7:9])))
                        for n, bb in zip(names, b)], dtype=object)
    out = dict(boxes=b, names=names, scores=np.asarray(scores)[m],
               attrs=attrs)
    l2e_r, l2e_t = _l2e_of(info)
    if l2e_r is not None:
        out['l2e_r'], out['l2e_t'] = l2e_r, l2e_t
    return out


def to_nuscenes_submission(tokens: Sequence[str],
                           sample_results: Sequence[dict],
                           infos_by_token: Dict[str, dict],
                           velocity_thresh: float = 0.2) -> dict:
    """Build the official submission JSON structure.

    sample_results[i]: evaluator pred dict (lidar frame).  Uses
    lidar2ego/ego2global from the infos to move boxes to the global frame
    (ref: lidar_nusc_box_to_global in mmdet3d + custom dataset usage).
    """
    results = {}
    for token, res in zip(tokens, sample_results):
        info = infos_by_token[token]
        l2e_r = quat_to_rot(info['lidar2ego_rotation']) \
            if 'lidar2ego_rotation' in info else np.eye(3)
        l2e_t = np.asarray(info.get('lidar2ego_translation', np.zeros(3)))
        e2g_r = quat_to_rot(info['ego2global_rotation']) \
            if 'ego2global_rotation' in info else np.eye(3)
        e2g_t = np.asarray(info.get('ego2global_translation', np.zeros(3)))
        recs = []
        for b, name, score in zip(res['boxes'], res['names'], res['scores']):
            center = b[:3].copy()
            center[2] += b[5] / 2        # bottom -> gravity for submission
            center = e2g_r @ (l2e_r @ center + l2e_t) + e2g_t
            vel = np.r_[b[7:9], 0.0]
            vel = e2g_r @ (l2e_r @ vel)
            # lidar yaw -> global yaw
            yaw = b[6] + np.arctan2(l2e_r[1, 0], l2e_r[0, 0]) + \
                np.arctan2(e2g_r[1, 0], e2g_r[0, 0])
            attr = derive_attr(str(name), float(np.linalg.norm(b[7:9])),
                               velocity_thresh)
            recs.append(dict(
                sample_token=token,
                translation=center.tolist(),
                size=b[3:6].tolist(),
                rotation=quaternion_from_yaw(float(yaw)),
                velocity=vel[:2].tolist(),
                detection_name=str(name),
                detection_score=float(score),
                attribute_name=attr))
        results[token] = recs
    return dict(meta=dict(use_camera=True, use_lidar=False, use_radar=False,
                          use_map=False, use_external=False),
                results=results)


def save_submission(path: str, submission: dict):
    with open(path, 'w') as f:
        json.dump(submission, f)


def gt_dict_from_info(info: dict, classes=CLASSES) -> dict:
    """infos-pkl GT -> evaluator gt dict (lidar frame, bottom-center)."""
    mask = np.asarray(info.get('valid_flag',
                               np.ones(len(info['gt_boxes']), bool)), bool)
    boxes = np.asarray(info['gt_boxes'], np.float64)[mask]
    vel = np.nan_to_num(np.asarray(
        info.get('gt_velocity', np.zeros((len(boxes), 2))),
        np.float64))[mask[:len(mask)]][:len(boxes)]
    if boxes.shape[1] == 7:
        boxes = np.concatenate([boxes, vel], axis=1)
    names = np.asarray(info['gt_names'])[mask]
    keep = np.asarray([n in classes for n in names], bool)
    out = dict(boxes=boxes[keep], names=names[keep])
    attrs = info.get('gt_attrs')
    if attrs is not None:
        out['attrs'] = np.asarray(attrs)[mask][keep]
    l2e_r, l2e_t = _l2e_of(info)
    if l2e_r is not None:
        out['l2e_r'], out['l2e_t'] = l2e_r, l2e_t
    return out
