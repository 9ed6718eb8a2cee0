"""Render a LEARNABLE synthetic nuScenes-style fixture: the port's copy of
the repository's `tools/make_synth_fixture.py` (the same draws in the same
order, so a seed gives the same fixture).

Real nuScenes data and released weights are not in the repository; this
tool builds the strongest proxy: a multi-view 3D world whose images carry
real geometric signal -

  * a 6-camera rig with nuScenes-like intrinsics/extrinsics (fov ~64deg,
    1600x900 source resolution),
  * objects (4 classes with distinct sizes + colors) placed on the ground
    plane; every view renders each visible object as a filled rectangle at
    its EXACT projected 2D box, so apparent size encodes depth and the
    2D/3D annotations are pixel-consistent with the evidence,
  * COCO 2D json with `bbox_cam3d` camera-frame centers computed with the
    SAME float64 algebra the loader's center_match uses (exact matches),
  * infos pkl in the mmdet3d schema `data/nuscenes.py::load_infos` reads
    (ref tools/create_data.py flow), camera JPEGs under `<out>/imgs/`,
  * a config (`soak_cfg.py`) whose `data.train` / `data.val` name them.

  python -m mv2d_tpu_torch.tools.make_synth_fixture --out /tmp/synth_fix \
      --scenes 48 --val-scenes 8
  python -m mv2d_tpu_torch.tools.train /tmp/synth_fix/soak_cfg.py
  python -m mv2d_tpu_torch.tools.test /tmp/synth_fix/soak_cfg.py
"""
from __future__ import annotations

import argparse
import json
import os
import pickle

from typing import Optional, Sequence

import numpy as np

from ..data.nuscenes import CAM_SENSORS, CLASSES, build_view_matrices

# (name, (dx, dy, dz), base RGB) - dims in the gt_boxes (w, l, h) slots;
# distinct colors give the 2D detector class evidence
OBJ_CLASSES = [
    ('car', (1.95, 4.6, 1.7), (200, 60, 50)),
    ('truck', (2.5, 7.0, 2.9), (60, 160, 210)),
    ('pedestrian', (0.67, 0.73, 1.77), (230, 200, 60)),
    ('barrier', (2.5, 0.5, 0.98), (140, 220, 120)),
]


def make_rig(h: int, w: int):
    """6-camera nuScenes-like rig: yaw-spaced cameras 1.5 m above ground.

    Returns per-cam dicts of sensor2lidar rotation/translation +
    cam_intrinsic (the infos-pkl fields build_view_matrices consumes)."""
    fx = w * 0.8
    K = np.asarray([[fx, 0, w / 2.0], [0, fx, h / 2.0], [0, 0, 1.0]])
    rigs = []
    yaws = [0.0, 55.0, -55.0, 180.0, 110.0, -110.0]  # nuScenes cam order
    for yaw_deg in yaws:
        th = np.deg2rad(yaw_deg)
        fwd = np.asarray([np.cos(th), np.sin(th), 0.0])
        right = np.asarray([np.sin(th), -np.cos(th), 0.0])
        down = np.asarray([0.0, 0.0, -1.0])
        # columns are the camera axes (x=right, y=down, z=forward)
        # expressed in the lidar frame
        R = np.stack([right, down, fwd], axis=1)
        t = fwd * 1.0 + np.asarray([0.0, 0.0, 1.5])
        rigs.append(dict(rotation=R, translation=t, intrinsic=K))
    return rigs


def corners_3d(box9):
    """8 corners of a bottom-center (x, y, z, dx, dy, dz, yaw) box."""
    x, y, z, dx, dy, dz, yaw = box9[:7]
    cs, sn = np.cos(yaw), np.sin(yaw)
    cx = np.asarray([0.5, 0.5, -0.5, -0.5]) * dx
    cy = np.asarray([0.5, -0.5, 0.5, -0.5]) * dy
    rx = cx * cs - cy * sn + x
    ry = cx * sn + cy * cs + y
    out = np.zeros((8, 3))
    out[:4, 0], out[:4, 1], out[:4, 2] = rx, ry, z
    out[4:, 0], out[4:, 1], out[4:, 2] = rx, ry, z + dz
    return out


def project_box(box9, lidar2img, h, w):
    """Projected clipped 2D bbox (xyxy) or None if not visible."""
    cor = corners_3d(box9)
    hom = np.concatenate([cor, np.ones((8, 1))], axis=1)
    p = hom @ lidar2img.T
    depth = p[:, 2]
    if (depth < 0.5).all():
        return None
    # clip the box to the front hemisphere: drop behind-camera corners
    # (good enough for GT: objects straddling the image plane are rare at
    # these placements and get filtered by the visibility checks below)
    vis = depth > 0.5
    if vis.sum() < 4:
        return None
    uv = p[vis, :2] / depth[vis, None]
    x1, y1 = uv.min(0)
    x2, y2 = uv.max(0)
    x1c, y1c = max(x1, 0.0), max(y1, 0.0)
    x2c, y2c = min(x2, w - 1.0), min(y2, h - 1.0)
    if x2c - x1c < 8 or y2c - y1c < 8:
        return None
    # mostly-visible check: at least 25% of the raw box survives the clip
    if (x2c - x1c) * (y2c - y1c) < 0.25 * (x2 - x1) * (y2 - y1):
        return None
    return np.asarray([x1c, y1c, x2c, y2c])


def render_view(rng, h, w, boxes, labels, l2i):
    """Background + per-object filled rectangles at projected boxes.

    Draws far objects first so occlusion ordering is consistent; returns
    (image uint8, list of (gt_index, bbox_xyxy))."""
    img = np.zeros((h, w, 3), np.uint8)
    horizon = h // 2
    img[:horizon] = np.asarray([105, 140, 185], np.uint8)   # sky
    img[horizon:] = np.asarray([75, 75, 78], np.uint8)      # road
    noise = rng.integers(-12, 13, (h, w, 1), endpoint=True)
    img = np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    # low-contrast clutter rectangles (negatives for the RPN)
    for _ in range(10):
        cw, ch = rng.integers(20, 120), rng.integers(15, 80)
        cx, cy = rng.integers(0, w - cw), rng.integers(0, h - ch)
        img[cy:cy + ch, cx:cx + cw] = np.clip(
            img[cy:cy + ch, cx:cx + cw].astype(np.int16)
            + rng.integers(-25, 25), 0, 255).astype(np.uint8)

    anns = []
    depths = []
    for i, b in enumerate(boxes):
        c = np.asarray([b[0], b[1], b[2] + b[5] / 2, 1.0])
        depths.append((c @ l2i.T)[2])
    for i in np.argsort(depths)[::-1]:          # far -> near
        bb = project_box(boxes[i], l2i, h, w)
        if bb is None:
            continue
        x1, y1, x2, y2 = (int(round(v)) for v in bb)
        base = np.asarray(OBJ_CLASSES[labels[i]][2], np.int16)
        shade = rng.integers(-30, 31)
        img[y1:y2, x1:x2] = np.clip(base + shade, 0, 255).astype(np.uint8)
        # simple structure inside the box (window band) for texture
        my = y1 + (y2 - y1) // 4
        img[y1:my, x1:x2] = np.clip(base + shade - 60, 0, 255
                                    ).astype(np.uint8)
        anns.append((i, bb))
    return img, anns


def gen_scene(rng, n_obj):
    boxes, labels = [], []
    for _ in range(n_obj):
        cls = int(rng.integers(0, len(OBJ_CLASSES)))
        dims = np.asarray(OBJ_CLASSES[cls][1])
        dims = dims * rng.uniform(0.85, 1.15, 3)
        r = rng.uniform(6.0, 45.0)
        th = rng.uniform(0, 2 * np.pi)
        x, y = r * np.cos(th), r * np.sin(th)
        yaw = rng.uniform(-np.pi, np.pi)
        boxes.append([x, y, -1.6, dims[0], dims[1], dims[2], yaw])
        labels.append(cls)
    return np.asarray(boxes), np.asarray(labels)


def write_split(out, split, n_scenes, n_obj, h, w, rigs, rng):
    import cv2
    img_dir = os.path.join(out, 'imgs')
    os.makedirs(img_dir, exist_ok=True)
    infos, images, anns = [], [], []
    img_id_base = 0 if split == 'train' else 10 ** 6
    img_id, ann_id = img_id_base, img_id_base
    for s in range(n_scenes):
        boxes, labels = gen_scene(rng, n_obj)
        ts = (1000.0 + s * 0.5) * 1e6
        cams = {}
        for ci, cam in enumerate(CAM_SENSORS):
            rig = rigs[ci]
            cam_info = dict(
                data_path='', timestamp=ts + ci * 0.01e6,
                sensor2lidar_rotation=rig['rotation'],
                sensor2lidar_translation=rig['translation'],
                cam_intrinsic=rig['intrinsic'])
            K4, E4 = build_view_matrices(cam_info)
            l2i = K4 @ E4.T
            img, view_anns = render_view(rng, h, w, boxes, labels, l2i)
            fn = os.path.join(img_dir, f'{split}_s{s}_{cam}.jpg')
            cv2.imwrite(fn, cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                        [cv2.IMWRITE_JPEG_QUALITY, 92])
            cam_info['data_path'] = fn
            cams[cam] = cam_info
            images.append(dict(id=img_id, file_name=os.path.basename(fn)))
            # bbox_cam3d via the loader's own algebra: centers_cam =
            # [gravity_center, 1] @ E4 (data/nuscenes.py get_sample)
            for gi, bb in view_anns:
                gc = np.asarray([boxes[gi][0], boxes[gi][1],
                                 boxes[gi][2] + boxes[gi][5] / 2, 1.0])
                cam3d = (gc @ E4)[:3]
                anns.append(dict(
                    id=ann_id, image_id=img_id, iscrowd=0,
                    bbox=[float(bb[0]), float(bb[1]),
                          float(bb[2] - bb[0]), float(bb[3] - bb[1])],
                    # category ids index the FULL 10-class nuScenes list
                    # so 2D labels agree with the 3D label space
                    category_id=CLASSES.index(OBJ_CLASSES[labels[gi]][0]),
                    bbox_cam3d=[float(v) for v in cam3d]))
                ann_id += 1
            img_id += 1
        infos.append(dict(
            token=f'{split}tok{s}', lidar_path='', sweeps=[],
            timestamp=ts, cams=cams,
            gt_boxes=boxes.astype(np.float64),
            gt_names=np.asarray([OBJ_CLASSES[l][0] for l in labels]),
            gt_velocity=np.zeros((len(boxes), 2)),
            valid_flag=np.ones(len(boxes), bool),
            num_lidar_pts=np.full(len(boxes), 50)))
    info_path = os.path.join(out, f'infos_{split}.pkl')
    with open(info_path, 'wb') as f:
        pickle.dump(dict(infos=infos), f)
    coco_path = os.path.join(out, f'coco_{split}.json')
    with open(coco_path, 'w') as f:
        json.dump(dict(
            images=images, annotations=anns,
            categories=[dict(id=i, name=c)
                        for i, c in enumerate(CLASSES)]), f)
    return info_path, coco_path


CFG_TEMPLATE = """# auto-generated soak config (mv2d_tpu_torch/tools/make_synth_fixture.py)
_base_ = [{base!r}]
data = dict(
    train=dict(info_path={train_info!r}, ann2d_path={train_coco!r},
               num_frames=2, final_dim=(512, 1408), test_mode=False),
    val=dict(info_path={val_info!r}, ann2d_path={val_coco!r},
             num_frames=2, final_dim=(512, 1408), test_mode=True),
)
model = dict(preset='mv2d_t_r50', overrides=dict())
total_epochs = {epochs}
evaluation = dict(interval={eval_interval})
log_interval = 10
"""


def make_fixture(out: str, scenes: int = 48, val_scenes: int = 8,
                 objects: int = 14, image_h: int = 900, image_w: int = 1600,
                 seed: int = 0, epochs: int = 10,
                 eval_interval: int = 5) -> dict:
    """Writes the fixture under `out`; returns the paths of its infos pkls,
    COCO files and config (train_info, train_coco, val_info, val_coco,
    config).  The config trains for `epochs` and evaluates every
    `eval_interval` epochs."""
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(seed)
    rigs = make_rig(image_h, image_w)
    ti, tc = write_split(out, 'train', scenes, objects, image_h, image_w,
                         rigs, rng)
    vi, vc = write_split(out, 'val', val_scenes, objects, image_h, image_w,
                         rigs, rng)
    base = os.path.abspath(os.path.join(
        os.path.dirname(__file__), os.pardir, os.pardir, 'configs', '_base_',
        'schedule.py'))
    cfg = os.path.join(out, 'soak_cfg.py')
    with open(cfg, 'w') as f:
        f.write(CFG_TEMPLATE.format(
            base=base, train_info=ti, train_coco=tc, val_info=vi,
            val_coco=vc, epochs=epochs, eval_interval=eval_interval))
    return dict(train_info=ti, train_coco=tc, val_info=vi, val_coco=vc,
                config=cfg)


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument('--out', required=True)
    p.add_argument('--scenes', type=int, default=48)
    p.add_argument('--val-scenes', type=int, default=8)
    p.add_argument('--objects', type=int, default=14)
    p.add_argument('--image-h', type=int, default=900)
    p.add_argument('--image-w', type=int, default=1600)
    p.add_argument('--epochs', type=int, default=10)
    p.add_argument('--eval-interval', type=int, default=5)
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)
    paths = make_fixture(args.out, args.scenes, args.val_scenes,
                         args.objects, args.image_h, args.image_w, args.seed,
                         args.epochs, args.eval_interval)
    n_imgs = (args.scenes + args.val_scenes) * 6
    print(f'fixture: {args.scenes}+{args.val_scenes} scenes, {n_imgs} '
          f'images @ {args.image_w}x{args.image_h} -> {args.out}')
    print(f'config:  {paths["config"]}')


if __name__ == '__main__':
    main()
