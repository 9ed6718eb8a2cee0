"""nuScenes dataset: infos pkl + 2D COCO annotations -> fixed-shape batches.

The port's copy of `mv2d_tpu/data/nuscenes.py`.  Its samples are the JAX
package's with the images always `[V, H, W, 3]` (the test-mode images come
from the port's C++ pool, which writes no space-to-depth layout), and its
collation builds the port's tensors on an explicit device.

Re-implements CustomNuScenesDataset (ref: mmdet3d_plugin/datasets/
custom_nuscenes_dataset.py:28-456) standalone (no mmcv / pycocotools /
nuscenes-devkit):
  * reads the same mmdet3d `*_infos_{train,val}.pkl` (incl. the 30f sweep
    pkls from tools/generate_sweep_pkl.py) and `*_mono3d.coco.json` 2D files,
  * builds per-view intrinsics/extrinsics/lidar2img exactly as
    get_data_info:134-151 (lidar2img = viewpad @ lidar2cam_rt.T),
  * matches 2D boxes to 3D GT by projected-center distance (center_match,
    :199-208, tol 1e-3),
  * two-frame temporal stacking via the sweeps list (ref pipelines/
    loading.py:53-163): train samples a sweep index from sweep_range,
    test takes the middle,
  * emits padded fixed-shape numpy samples; `to_eval_inputs` and
    `to_train_batch` turn one into the model's tensors.
"""
from __future__ import annotations

import json
import os
import pickle
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import pipeline as pl
from .padding import pad_to

CLASSES = ('car', 'truck', 'trailer', 'bus', 'construction_vehicle',
           'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone', 'barrier')

CAM_SENSORS = ('CAM_FRONT', 'CAM_FRONT_RIGHT', 'CAM_FRONT_LEFT', 'CAM_BACK',
               'CAM_BACK_LEFT', 'CAM_BACK_RIGHT')


def load_infos(path: str, load_separate: bool = False) -> List:
    """Load (and timestamp-sort) the infos pkl.

    load_separate (ref load_annotations, custom_nuscenes_dataset.py:48-57):
    each info is spilled to its own pkl under `<path minus extension>/`
    (written once, reused after) and the returned list holds FILE PATHS
    instead of dicts, keeping resident RAM at one sample."""
    with open(path, 'rb') as f:
        data = pickle.load(f)
    infos = data['infos'] if isinstance(data, dict) else data
    infos = sorted(infos, key=lambda e: e['timestamp'])
    if load_separate:
        out_dir = path.rsplit('.', 1)[0] + '_separate'
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for i, info in enumerate(infos):
            out_file = os.path.join(out_dir, '%07d.pkl' % i)
            if not os.path.exists(out_file):
                with open(out_file, 'wb') as f:
                    pickle.dump(info, f)
            paths.append(out_file)
        return paths
    return infos


class Coco2D:
    """Minimal COCO-json reader for the mono3d 2D annotation files
    (replaces pycocotools; ref load_annotations_2d, :73-91)."""

    def __init__(self, path: str):
        with open(path) as f:
            coco = json.load(f)
        self.img_by_file: Dict[str, dict] = {}
        anns_by_img: Dict[int, list] = {}
        for ann in coco.get('annotations', []):
            anns_by_img.setdefault(ann['image_id'], []).append(ann)
        self.cat_to_label = {c['id']: i
                             for i, c in enumerate(coco.get('categories', []))}
        for img in coco.get('images', []):
            key = os.path.basename(img['file_name'])
            img['anns'] = anns_by_img.get(img['id'], [])
            self.img_by_file[key] = img

    def anns_for_image(self, file_name: str):
        """Returns (bboxes_2d [N,4] xyxy, labels [N], bboxes_cam3d [N,>=3],
        ignore [M,4])."""
        img = self.img_by_file.get(os.path.basename(file_name))
        boxes, labels, cam3d, ignore = [], [], [], []
        if img is not None:
            for a in img['anns']:
                x, y, w, h = a['bbox']
                box = [x, y, x + w, y + h]
                if a.get('iscrowd', 0) or a.get('ignore', 0):
                    ignore.append(box)
                    continue
                boxes.append(box)
                labels.append(self.cat_to_label.get(a['category_id'],
                                                    a['category_id']))
                cam3d.append(a.get('bbox_cam3d', [0.0, 0.0, 0.0])[:3])
        return (np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(labels, np.int64),
                np.asarray(cam3d, np.float64).reshape(-1, 3),
                np.asarray(ignore, np.float32).reshape(-1, 4))


def center_match(centers_a: np.ndarray, centers_b: np.ndarray,
                 tol: float = 1e-3) -> np.ndarray:
    """2D-ann camera centers -> 3D GT indices (ref center_match, :199-208)."""
    if len(centers_a) == 0 or len(centers_b) == 0:
        return np.full((len(centers_a),), -1, np.int32)
    dist = np.abs(centers_a[:, None] - centers_b[None]).sum(-1)
    match = dist.argmin(1).astype(np.int32)
    match[dist.min(1) > tol] = -1
    return match


def build_view_matrices(cam_info: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(intrinsics viewpad 4x4, extrinsics lidar2cam_rt 4x4) such that
    lidar2img = intrinsics @ extrinsics.T (ref get_data_info:134-151)."""
    l2c_r = np.linalg.inv(cam_info['sensor2lidar_rotation'])
    l2c_t = cam_info['sensor2lidar_translation'] @ l2c_r.T
    rt = np.eye(4)
    rt[:3, :3] = l2c_r.T
    rt[3, :3] = -l2c_t
    intrinsic = np.asarray(cam_info['cam_intrinsic'])
    viewpad = np.eye(4)
    viewpad[:intrinsic.shape[0], :intrinsic.shape[1]] = intrinsic
    return viewpad, rt


@dataclass
class SampleBuckets:
    max_gt3d: int = 96
    max_gt2d: int = 64


@dataclass
class NuScenesDataset:
    info_path: str
    ann2d_path: Optional[str] = None
    data_root: str = ''
    num_frames: int = 1
    sweep_range: Tuple[int, int] = (3, 27)
    test_mode: bool = False
    use_valid_flag: bool = True
    final_dim: Tuple[int, int] = (512, 1408)
    ida: pl.IdaAugConfig = field(default_factory=pl.IdaAugConfig)
    buckets: SampleBuckets = field(default_factory=SampleBuckets)
    load_separate: bool = False
    bev_aug: bool = True
    # test mode: True runs the C++ pool (pipeline.native_preprocess), False
    # its plain numpy version (apply_ida_image + normalize_image)
    native: bool = True

    def __post_init__(self):
        self.infos = load_infos(self.info_path, self.load_separate)
        self.coco = Coco2D(self.ann2d_path) if self.ann2d_path else None
        self.ida.final_dim = self.final_dim

    def __len__(self):
        return len(self.infos)

    def get_info(self, index: int) -> dict:
        """Resolve one info entry (reads the per-sample pkl when
        load_separate spilled the list to paths)."""
        info = self.infos[index]
        if isinstance(info, str):
            with open(info, 'rb') as f:
                info = pickle.load(f)
        return info

    # ------------------------------------------------------------ raw info

    def _read_image(self, path: str) -> np.ndarray:
        import cv2
        p = path if os.path.isabs(path) or not self.data_root else \
            os.path.join(self.data_root, path)
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(p)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def _gather_views(self, info: dict, rng: np.random.Generator):
        """Current-frame views (+ one sweep frame when num_frames == 2)."""
        paths, Ks, Es, ts = [], [], [], []
        lidar_ts = info['timestamp'] / 1e6
        for cam in CAM_SENSORS:
            ci = info['cams'][cam]
            K, E = build_view_matrices(ci)
            paths.append(ci['data_path'])
            Ks.append(K)
            Es.append(E)
            ts.append(lidar_ts - ci['timestamp'] / 1e6)
        if self.num_frames == 2:
            sweeps = info.get('sweeps', [])
            if len(sweeps) == 0:
                mean_t = (self.sweep_range[0] + self.sweep_range[1]) / 2 * .083
                paths += list(paths)
                Ks += [k.copy() for k in Ks]
                Es += [e.copy() for e in Es]
                ts += [t + mean_t for t in ts[:6]]
            else:
                lo, hi = self.sweep_range
                if self.test_mode or len(sweeps) <= 1:
                    idx = min(int((lo + hi) / 2) - 1, len(sweeps) - 1)
                else:
                    idx = int(rng.integers(lo, min(hi, len(sweeps)))) \
                        if lo < len(sweeps) else len(sweeps) - 1
                    idx = min(idx, len(sweeps) - 1)
                sweep = sweeps[idx]
                for cam in CAM_SENSORS:
                    ci = sweep[cam]
                    if 'intrinsics' in ci:
                        K, E = ci['intrinsics'], ci['extrinsics']
                    else:
                        K, E = build_view_matrices(ci)
                    paths.append(ci['data_path'])
                    Ks.append(np.asarray(K, np.float64))
                    Es.append(np.asarray(E, np.float64))
                    ts.append(lidar_ts - ci['timestamp'] / 1e6)
        return paths, np.stack(Ks), np.stack(Es), np.asarray(ts)

    def _ann3d(self, info: dict):
        """3D GT (bottom-center, lidar frame) with valid_flag filter
        (ref get_ann_info:229-254)."""
        if self.use_valid_flag and 'valid_flag' in info:
            mask = np.asarray(info['valid_flag'], bool)
        else:
            mask = np.asarray(info.get('num_lidar_pts', np.ones(
                len(info['gt_boxes']))) ) > 0
        boxes = np.asarray(info['gt_boxes'], np.float64)[mask]
        names = np.asarray(info['gt_names'])[mask]
        if 'gt_velocity' in info:
            vel = np.asarray(info['gt_velocity'], np.float64)[mask]
            vel = np.nan_to_num(vel)
            boxes = np.concatenate([boxes, vel], axis=-1)
        else:
            boxes = np.concatenate(
                [boxes, np.zeros((len(boxes), 2))], axis=-1)
        labels = np.asarray([CLASSES.index(n) if n in CLASSES else -1
                             for n in names], np.int64)
        keep = labels >= 0
        return boxes[keep].astype(np.float32), labels[keep]

    # ------------------------------------------------------------- samples

    def get_sample(self, index: int, rng: Optional[np.random.Generator] = None
                   ) -> dict:
        """Full host-side pipeline for one scene -> padded numpy sample.

        Keys: imgs [V,H,W,3] f32 (normalized), intrinsics/extrinsics [V,4,4],
        timestamps [V], img_shapes [V,2], gt3d_boxes/labels/valid,
        gt2d_boxes/labels/valid [Vc,...] (train only), token.
        """
        rng = rng or np.random.default_rng()
        info = self.get_info(index)
        paths, Ks, Es, ts = self._gather_views(info, rng)
        V = len(paths)
        training = not self.test_mode

        imgs = [self._read_image(p) for p in paths]
        if training:
            imgs = [pl.photometric_distortion(rng, im.astype(np.float32))
                    for im in imgs]

        # 3D GT + per-view 2D GT (current frame only)
        out: dict = {'token': info['token']}
        gt3d_boxes = np.zeros((0, 9), np.float32)
        gt3d_labels = np.zeros((0,), np.int64)
        gt2d = []
        if training:
            gt3d_boxes, gt3d_labels = self._ann3d(info)
            if self.coco is not None:
                centers = gt3d_boxes[:, :3].copy()
                centers[:, 2] += gt3d_boxes[:, 5] * 0.5        # gravity z
                hom = np.concatenate(
                    [centers, np.ones((len(centers), 1))], axis=1)
                for v in range(6):
                    b2, l2, cam3d, ign = self.coco.anns_for_image(paths[v])
                    lidar2cam = Es[v].T
                    centers_cam = (hom @ lidar2cam.T)[:, :3]
                    m = center_match(cam3d, centers_cam)
                    gt2d.append(dict(boxes=b2, labels=l2, match=m,
                                     ignore=ign))
            else:
                for v in range(6):
                    gt2d.append(dict(boxes=np.zeros((0, 4), np.float32),
                                     labels=np.zeros((0,), np.int64),
                                     match=np.zeros((0,), np.int32),
                                     ignore=np.zeros((0, 4), np.float32)))

        # --- ida aug (shared params across views)
        p = pl.sample_ida(rng, self.ida, training)
        # eval path: the C++ pool (training's photometric images are float
        # and take the numpy path)
        if not training and self.native:
            imgs_out = pl.native_preprocess(
                [np.clip(im, 0, 255) for im in imgs], p)
        else:
            imgs_out = np.stack([
                pl.normalize_image(pl.apply_ida_image(im, p)) for im in imgs])
        Ks = np.stack([pl.apply_ida_intrinsics(k, p) for k in Ks])
        lidar2img = Ks @ np.transpose(Es, (0, 2, 1))
        for g in gt2d:
            g['boxes'], keep = pl.transform_boxes_2d(g['boxes'], p)
            g['labels'] = g['labels'][keep[:len(g['labels'])]] \
                if len(g['labels']) else g['labels']
            g['match'] = g['match'][keep[:len(g['match'])]] \
                if len(g['match']) else g['match']
            g['boxes'] = g['boxes'][keep] if len(keep) else g['boxes']

        # --- BEV rot/scale aug (train)
        if training and self.bev_aug and len(gt3d_boxes):
            lidar2img, Es, gt3d_boxes = pl.global_rot_scale(
                rng, lidar2img, Es, gt3d_boxes)
            # keep K @ E^T == lidar2img consistent: recover K from l2i, E
            # (K unchanged by the BEV aug; extrinsics absorbed it)

        H, W = self.final_dim
        out.update(
            # copy=False: the native path already emits float32, and a
            # same-dtype astype copies ~100 MB per sample
            imgs=imgs_out.astype(np.float32, copy=False),
            intrinsics=Ks.astype(np.float64),
            extrinsics=Es.astype(np.float64),
            lidar2img=lidar2img.astype(np.float64),
            timestamps=ts.astype(np.float64),
            img_shapes=np.tile(np.asarray([[H, W]], np.int32), (V, 1)),
        )
        if training:
            g3b, g3v = pad_to(gt3d_boxes, self.buckets.max_gt3d)
            g3l, _ = pad_to(gt3d_labels.astype(np.int32),
                            self.buckets.max_gt3d)
            out.update(gt3d_boxes=g3b, gt3d_labels=g3l, gt3d_valid=g3v)
            G2 = self.buckets.max_gt2d
            b = np.zeros((V, G2, 4), np.float32)
            l = np.zeros((V, G2), np.int32)
            m3 = np.full((V, G2), -1, np.int32)
            va = np.zeros((V, G2), bool)
            for v, g in enumerate(gt2d):
                bb, vv = pad_to(g['boxes'], G2)
                ll, _ = pad_to(g['labels'].astype(np.int32), G2)
                mm, _ = pad_to(g['match'].astype(np.int32), G2, value=-1)
                b[v], l[v], m3[v], va[v] = bb, ll, mm, vv
            out.update(gt2d_boxes=b, gt2d_labels=l, gt2d_valid=va,
                       gt2d_to_3d=m3)
        return out


# ------------------------------------------------------------- collation

def to_camera_params(sample: dict, device='cuda'):
    from ..core.geometry import prepare_camera_params
    return prepare_camera_params(sample['intrinsics'], sample['extrinsics'],
                                 timestamps=sample['timestamps'],
                                 device=device)


def to_train_batch(sample: dict, device='cuda'):
    """Host sample dict -> single-scene `train.train_step.TrainBatch` on
    `device` (images [V, H, W, 3] float32, labels int64)."""
    from ..models.mv2d import GroundTruth2D, GroundTruth3D
    from ..train.train_step import TrainBatch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return TrainBatch(
        imgs=t(sample['imgs']),
        cam=to_camera_params(sample, device),
        img_shapes=t(sample['img_shapes']),
        gt2d=GroundTruth2D(boxes=t(sample['gt2d_boxes']),
                           labels=t(sample['gt2d_labels']).long(),
                           valid=t(sample['gt2d_valid'])),
        gt3d=GroundTruth3D(boxes=t(sample['gt3d_boxes']),
                           labels=t(sample['gt3d_labels']).long(),
                           valid=t(sample['gt3d_valid'])))


def to_eval_inputs(sample: dict, device='cuda', dtype=torch.float32):
    """Host sample dict -> the forward's (images [V, H, W, 3] in `dtype`,
    CameraParams, image shapes [V, 2]) on `device`.  The float32 images
    are copied to the device first and cast there."""
    imgs = torch.from_numpy(np.ascontiguousarray(sample['imgs']))
    return (imgs.to(device).to(dtype), to_camera_params(sample, device),
            torch.from_numpy(sample['img_shapes']).to(device))


class Prefetcher:
    """Background-thread sample prefetcher (replaces the mmcv DataLoader
    worker pool; image decode + aug run off the main thread, the C++ resize
    pool parallelizes within a sample).  Samples arrive out of order, each
    with its index; `sample_seconds` collects each get_sample's wall time
    in its worker.  An error in a worker is raised by the iteration."""

    def __init__(self, dataset: 'NuScenesDataset', indices: Sequence[int],
                 seed: int = 0, num_threads: int = 4, queue_size: int = 8):
        self.q: 'queue.Queue' = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self.sample_seconds: List[float] = []

        def worker(wid: int):
            rng = np.random.default_rng(seed * 1000 + wid)
            try:
                for i, idx in enumerate(indices):
                    if i % num_threads != wid:
                        continue
                    if self._stop.is_set():
                        break
                    t0 = time.perf_counter()
                    sample = dataset.get_sample(idx, rng)
                    self.sample_seconds.append(time.perf_counter() - t0)
                    self.q.put((idx, sample))
            except Exception as e:      # noqa: BLE001 - raised by __iter__
                self.q.put(e)
            self.q.put(None)

        self.threads = [threading.Thread(target=worker, args=(w,),
                                         daemon=True)
                        for w in range(num_threads)]
        for t in self.threads:
            t.start()
        self._done = 0
        self._n_threads = num_threads

    def __iter__(self):
        while self._done < self._n_threads:
            item = self.q.get()
            if item is None:
                self._done += 1
                continue
            if isinstance(item, Exception):
                self.close()
                raise item
            yield item

    def close(self):
        """Stop the workers: each ends after its current sample, and the
        queue is drained so that none stays blocked on it."""
        self._stop.set()
        while any(t.is_alive() for t in self.threads):
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            for t in self.threads:
                t.join(timeout=0.05)
