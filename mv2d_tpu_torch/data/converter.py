"""Offline nuScenes data preparation from the raw table JSONs.

The port's copy of `mv2d_tpu/data/converter.py` (numpy only, unchanged:
the two give equal infos and COCO files).

Replaces the reference's devkit-based converters (ref: tools/create_data.py,
tools/data_converter/nuscenes_converter.py:27,377-560 and
tools/generate_sweep_pkl.py) WITHOUT requiring nuscenes-devkit: reads the
v1.0 table files (sample.json, sample_data.json, calibrated_sensor.json,
ego_pose.json, sample_annotation.json, instance.json, category.json,
attribute.json, sensor.json) directly and produces:

  * `*_infos_{train,val}.pkl`  - per-sample dicts with per-cam
    sensor2lidar rotation/translation + intrinsics, lidar/ego/global poses,
    GT boxes in the lidar frame (x, y, z_bottom, w, l, h, yaw) + velocity,
  * `*_mono3d.coco.json`       - per-view 2D boxes (projected 3D corners)
    with `bbox_cam3d` camera-frame centers used for 2D<->3D matching,
  * temporal sweep lists (historical camera frames with poses expressed in
    the CURRENT lidar frame, like generate_sweep_pkl.py:32-83).

Box convention note: GT yaw here is the heading about +z in the lidar frame
measured from +x (atan2 of the box's forward axis).  mmdet3d pkls built by
other tools may differ by a -yaw - pi/2 convention; `yaw_convention` controls
emission for drop-in compatibility.
"""
from __future__ import annotations

import json
import os
import pickle
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CAM_SENSORS = ('CAM_FRONT', 'CAM_FRONT_RIGHT', 'CAM_FRONT_LEFT', 'CAM_BACK',
               'CAM_BACK_LEFT', 'CAM_BACK_RIGHT')

NAME_MAP = {
    'vehicle.car': 'car', 'vehicle.truck': 'truck',
    'vehicle.trailer': 'trailer', 'vehicle.bus.bendy': 'bus',
    'vehicle.bus.rigid': 'bus', 'vehicle.construction': 'construction_vehicle',
    'vehicle.bicycle': 'bicycle', 'vehicle.motorcycle': 'motorcycle',
    'human.pedestrian.adult': 'pedestrian',
    'human.pedestrian.child': 'pedestrian',
    'human.pedestrian.construction_worker': 'pedestrian',
    'human.pedestrian.police_officer': 'pedestrian',
    'movable_object.trafficcone': 'traffic_cone',
    'movable_object.barrier': 'barrier',
}
CLASSES = ('car', 'truck', 'trailer', 'bus', 'construction_vehicle',
           'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone', 'barrier')


def quat_to_rot(q: Sequence[float]) -> np.ndarray:
    w, x, y, z = q
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def yaw_of(R: np.ndarray) -> float:
    return float(np.arctan2(R[1, 0], R[0, 0]))


class NuScenesTables:
    """Raw table access with indices (a minimal devkit replacement)."""

    def __init__(self, dataroot: str, version: str = 'v1.0-trainval'):
        self.dataroot = dataroot
        tdir = os.path.join(dataroot, version)

        def load(name):
            with open(os.path.join(tdir, f'{name}.json')) as f:
                return json.load(f)

        self.sample = {s['token']: s for s in load('sample')}
        self.sample_data = {s['token']: s for s in load('sample_data')}
        self.calibrated_sensor = {s['token']: s
                                  for s in load('calibrated_sensor')}
        self.ego_pose = {s['token']: s for s in load('ego_pose')}
        self.sensor = {s['token']: s for s in load('sensor')}
        self.instance = {s['token']: s for s in load('instance')}
        self.category = {s['token']: s for s in load('category')}
        try:
            self.attribute = {s['token']: s for s in load('attribute')}
        except FileNotFoundError:
            self.attribute = {}
        try:
            self.scene = {s['token']: s for s in load('scene')}
        except FileNotFoundError:
            self.scene = {}
        self.anns_by_sample: Dict[str, list] = defaultdict(list)
        for a in load('sample_annotation'):
            self.anns_by_sample[a['sample_token']].append(a)
        self.sd_by_sample: Dict[str, Dict[str, dict]] = defaultdict(dict)
        for sd in self.sample_data.values():
            if sd.get('is_key_frame'):
                ch = self.sensor[self.calibrated_sensor[
                    sd['calibrated_sensor_token']]['sensor_token']]['channel']
                self.sd_by_sample[sd['sample_token']][ch] = sd

    def pose_of(self, sd: dict):
        cs = self.calibrated_sensor[sd['calibrated_sensor_token']]
        ep = self.ego_pose[sd['ego_pose_token']]
        s2e_r = quat_to_rot(cs['rotation'])
        s2e_t = np.asarray(cs['translation'])
        e2g_r = quat_to_rot(ep['rotation'])
        e2g_t = np.asarray(ep['translation'])
        return cs, ep, s2e_r, s2e_t, e2g_r, e2g_t

    def sensor2lidar(self, cam_sd: dict, lidar_sd: dict):
        """R, t of cam->lidar at possibly different timestamps (through the
        global frame, like generate_sweep_pkl.add_frame)."""
        _, _, c2e_r, c2e_t, ce2g_r, ce2g_t = self.pose_of(cam_sd)
        _, _, l2e_r, l2e_t, le2g_r, le2g_t = self.pose_of(lidar_sd)
        # cam -> global
        c2g_r = ce2g_r @ c2e_r
        c2g_t = ce2g_r @ c2e_t + ce2g_t
        # global -> lidar
        g2l_r = (le2g_r @ l2e_r).T
        g2l_t = -g2l_r @ (le2g_r @ l2e_t + le2g_t)
        r = g2l_r @ c2g_r
        t = g2l_r @ c2g_t + g2l_t
        return r, t


def _cam_info(nusc: NuScenesTables, cam_sd: dict, lidar_sd: dict) -> dict:
    cs = nusc.calibrated_sensor[cam_sd['calibrated_sensor_token']]
    r, t = nusc.sensor2lidar(cam_sd, lidar_sd)
    return dict(
        data_path=os.path.join(nusc.dataroot, cam_sd['filename']),
        type=nusc.sensor[cs['sensor_token']]['channel'],
        sample_data_token=cam_sd['token'],
        timestamp=cam_sd['timestamp'],
        sensor2lidar_rotation=r,
        sensor2lidar_translation=t,
        cam_intrinsic=np.asarray(cs['camera_intrinsic']))


def create_infos(dataroot: str, version: str = 'v1.0-trainval',
                 scene_names: Optional[Sequence[str]] = None,
                 max_sweeps: int = 25, sweep_cam_stride: int = 1
                 ) -> List[dict]:
    """Build infos for all samples (optionally filtered by scene names).

    Each info carries the current 6 cams plus up to `max_sweeps` historical
    6-cam frames (the reference's 30f pkl: 25 history frames,
    generate_sweep_pkl.py:86-131).
    """
    nusc = NuScenesTables(dataroot, version)
    infos = []
    for token, sample in nusc.sample.items():
        if scene_names is not None:
            sc = nusc.scene.get(sample['scene_token'], {})
            if sc.get('name') not in scene_names:
                continue
        sds = nusc.sd_by_sample[token]
        if 'LIDAR_TOP' not in sds:
            continue
        lidar_sd = sds['LIDAR_TOP']
        cs, ep, l2e_r, l2e_t, e2g_r, e2g_t = nusc.pose_of(lidar_sd)
        cams = {c: _cam_info(nusc, sds[c], lidar_sd) for c in CAM_SENSORS
                if c in sds}
        if len(cams) != 6:
            continue

        # ---- GT boxes: global -> lidar frame
        gt_boxes, names, velocity, num_pts, valid = [], [], [], [], []
        attrs = []
        for a in nusc.anns_by_sample.get(token, []):
            cat = nusc.category[
                nusc.instance[a['instance_token']]['category_token']]['name']
            name = NAME_MAP.get(cat)
            if name is None:
                continue
            c_g = np.asarray(a['translation'])
            R_g = quat_to_rot(a['rotation'])
            c_e = e2g_r.T @ (c_g - e2g_t)
            c_l = l2e_r.T @ (c_e - l2e_t)
            R_l = l2e_r.T @ e2g_r.T @ R_g
            yaw = yaw_of(R_l)
            w, l, h = a['size']          # nuScenes size = (w, l, h)
            c_l = c_l.copy()
            c_l[2] -= h / 2              # gravity -> bottom center
            gt_boxes.append([*c_l, w, l, h, yaw])
            names.append(name)
            velocity.append(_box_velocity(nusc, a, e2g_r, l2e_r))
            n = a.get('num_lidar_pts', 0) + a.get('num_radar_pts', 0)
            num_pts.append(a.get('num_lidar_pts', 0))
            valid.append(n > 0)
            at = ''
            if a.get('attribute_tokens'):
                at = nusc.attribute.get(a['attribute_tokens'][0],
                                        {}).get('name', '')
            attrs.append(at)

        # ---- historical camera sweeps (prev chains per cam)
        sweeps = []
        prev_sds = {c: sds[c] for c in CAM_SENSORS}
        for _ in range(max_sweeps):
            frame = {}
            ok = True
            for c in CAM_SENSORS:
                prv = prev_sds[c].get('prev', '')
                if not prv:
                    ok = False
                    break
                prev_sds[c] = nusc.sample_data[prv]
                ci = _cam_info(nusc, prev_sds[c], lidar_sd)
                # precompute the matrices the loader needs
                K = np.eye(4)
                K[:3, :3] = ci['cam_intrinsic']
                l2c_r = np.linalg.inv(ci['sensor2lidar_rotation'])
                l2c_t = ci['sensor2lidar_translation'] @ l2c_r.T
                rt = np.eye(4)
                rt[:3, :3] = l2c_r.T
                rt[3, :3] = -l2c_t
                ci['intrinsics'] = K
                ci['extrinsics'] = rt
                ci['lidar2img'] = K @ rt.T
                frame[c] = ci
            if not ok:
                break
            sweeps.append(frame)

        infos.append(dict(
            token=token,
            lidar_path=os.path.join(nusc.dataroot, lidar_sd['filename']),
            timestamp=sample['timestamp'],
            cams=cams,
            sweeps=sweeps,
            lidar2ego_rotation=cs['rotation'],
            lidar2ego_translation=cs['translation'],
            ego2global_rotation=ep['rotation'],
            ego2global_translation=ep['translation'],
            gt_boxes=np.asarray(gt_boxes, np.float64).reshape(-1, 7),
            gt_names=np.asarray(names),
            gt_velocity=np.asarray(velocity, np.float64).reshape(-1, 2),
            num_lidar_pts=np.asarray(num_pts),
            valid_flag=np.asarray(valid, bool),
            gt_attrs=np.asarray(attrs),
        ))
    infos.sort(key=lambda i: i['timestamp'])
    return infos


def _box_velocity(nusc: NuScenesTables, ann: dict, e2g_r, l2e_r,
                  max_dt: float = 1.5) -> Tuple[float, float]:
    """Finite-difference global velocity -> lidar frame (devkit
    box_velocity semantics)."""
    prev_tok = ann.get('prev', '')
    next_tok = ann.get('next', '')
    # lazily index annotations by token
    if not hasattr(nusc, '_ann_by_token'):
        nusc._ann_by_token = {}
        for lst in nusc.anns_by_sample.values():
            for a in lst:
                nusc._ann_by_token[a['token']] = a
    a_prev = nusc._ann_by_token.get(prev_tok, ann)
    a_next = nusc._ann_by_token.get(next_tok, ann)
    if a_prev is ann and a_next is ann:
        return (0.0, 0.0)
    t_of = lambda a: nusc.sample[a['sample_token']]['timestamp'] / 1e6
    dt = t_of(a_next) - t_of(a_prev)
    if dt <= 0 or dt > 2 * max_dt:
        return (0.0, 0.0)
    v_g = (np.asarray(a_next['translation']) -
           np.asarray(a_prev['translation'])) / dt
    v_l = l2e_r.T @ (e2g_r.T @ v_g)
    return (float(v_l[0]), float(v_l[1]))


# ------------------------------------------------------------ 2D export

def export_2d_annotations(infos: List[dict], image_hw=(900, 1600),
                          min_visible_corners: int = 1) -> dict:
    """Project 3D GT into every camera -> COCO-style mono3d json dict
    (replaces export_2d_annotation, nuscenes_converter.py:377-560)."""
    images, annotations = [], []
    img_id, ann_id = 0, 0
    H, W = image_hw
    for info in infos:
        for cam, ci in info['cams'].items():
            images.append(dict(id=img_id,
                               file_name=os.path.basename(ci['data_path']),
                               width=W, height=H,
                               token=ci.get('sample_data_token', '')))
            K = np.asarray(ci['cam_intrinsic'])
            r = np.asarray(ci['sensor2lidar_rotation'])
            t = np.asarray(ci['sensor2lidar_translation'])
            # lidar -> cam
            Rcl = np.linalg.inv(r)
            tcl = -Rcl @ t
            for b, name, vel, att in zip(info['gt_boxes'], info['gt_names'],
                                         info['gt_velocity'],
                                         info.get('gt_attrs',
                                                  [''] * len(info['gt_boxes']))):
                corners = _box_corners(b)
                cc = (Rcl @ corners.T).T + tcl
                vis = cc[:, 2] > 0.1
                if vis.sum() < min_visible_corners:
                    continue
                uv = (K @ cc[vis].T).T
                uv = uv[:, :2] / uv[:, 2:3]
                x1, y1 = uv.min(0)
                x2, y2 = uv.max(0)
                x1, x2 = np.clip([x1, x2], 0, W - 1)
                y1, y2 = np.clip([y1, y2], 0, H - 1)
                if x2 <= x1 or y2 <= y1:
                    continue
                center = b[:3].copy()
                center[2] += b[5] / 2
                c_cam = Rcl @ center + tcl
                if c_cam[2] <= 0:
                    continue
                annotations.append(dict(
                    id=ann_id, image_id=img_id,
                    category_id=CLASSES.index(name),
                    bbox=[float(x1), float(y1), float(x2 - x1),
                          float(y2 - y1)],
                    area=float((x2 - x1) * (y2 - y1)), iscrowd=0,
                    bbox_cam3d=[float(v) for v in c_cam],
                    velo_cam3d=[float(v) for v in vel],
                    attribute_name=str(att)))
                ann_id += 1
            img_id += 1
    return dict(images=images, annotations=annotations,
                categories=[dict(id=i, name=c)
                            for i, c in enumerate(CLASSES)])


def _box_corners(b: np.ndarray) -> np.ndarray:
    """Bottom-center box (x, y, z, w, l, h, yaw) -> 8 corners [8, 3],
    lidar frame."""
    x, y, z, w, l, h, yaw = b[:7]
    dx = np.asarray([1, 1, -1, -1, 1, 1, -1, -1]) * w / 2
    dy = np.asarray([1, -1, -1, 1, 1, -1, -1, 1]) * l / 2
    dz = np.asarray([0, 0, 0, 0, 1, 1, 1, 1]) * h
    c, s = np.cos(yaw), np.sin(yaw)
    cx = x + c * dx - s * dy
    cy = y + s * dx + c * dy
    cz = z + dz
    return np.stack([cx, cy, cz], axis=1)


def save_infos(path: str, infos: List[dict], metadata: Optional[dict] = None):
    with open(path, 'wb') as f:
        pickle.dump(dict(infos=infos, metadata=metadata or {}), f)
