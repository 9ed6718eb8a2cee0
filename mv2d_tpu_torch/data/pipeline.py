"""Host-side (numpy/cv2) image + geometry augmentation pipeline.

The port's copy of `mv2d_tpu/data/pipeline.py`: the same numpy functions
with the same `np.random.Generator` draws in the same order, so equal
seeds give equal samples.  Re-implements the reference's mmcv pipeline
transforms (ref: mmdet3d_plugin/datasets/pipelines/transform_3d.py):
  * PhotoMetricDistortionMultiViewImage   (:1042-1126)
  * ResizeCropFlipImageMono (ida aug)     (:456-676)
  * GlobalRotScaleTransImage (BEV aug)    (:822-906)
  * NormalizeMultiviewImage / PadMultiViewImage

All randomness flows through an explicit np.random.Generator.  The hot
resize+crop+flip+normalize loop runs in the port's C++ worker pool
(csrc/host/dataloader.cpp) through `native_preprocess`, which builds the
library at its first call and raises if the build fails; the numpy form
(`apply_ida_image` + `normalize_image`) is its plain version, chosen by
the caller, never by a failed build.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

try:
    import cv2
except Exception:                                            # pragma: no cover
    cv2 = None

IMG_MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)   # RGB
IMG_STD = np.asarray([58.395, 57.12, 57.375], np.float32)


@dataclass
class IdaAugConfig:
    """BEVDet-style image-domain aug (ref two_frames.py ida_aug_conf)."""
    resize_lim: Tuple[float, float] = (0.8, 1.0)
    final_dim: Tuple[int, int] = (512, 1408)
    bot_pct_lim: Tuple[float, float] = (0.0, 0.0)
    rot_lim: Tuple[float, float] = (0.0, 0.0)
    H: int = 900
    W: int = 1600
    rand_flip: bool = True


@dataclass
class IdaParams:
    resize: float
    resize_dims: Tuple[int, int]   # (newW, newH)
    crop: Tuple[int, int, int, int]
    flip: bool
    rotate: float


def sample_ida(rng: np.random.Generator, cfg: IdaAugConfig,
               training: bool) -> IdaParams:
    """ref ResizeCropFlipImage._sample_augmentation (transform_3d.py:539-566).
    One sample shared across ALL views (BEVDet convention)."""
    H, W = cfg.H, cfg.W
    fH, fW = cfg.final_dim
    if training:
        resize = rng.uniform(*cfg.resize_lim)
        newW, newH = int(W * resize), int(H * resize)
        crop_h = int((1 - rng.uniform(*cfg.bot_pct_lim)) * newH) - fH
        crop_w = int(rng.uniform(0, max(0, newW - fW)))
        flip = bool(cfg.rand_flip and rng.integers(2))
        rotate = float(rng.uniform(*cfg.rot_lim))
    else:
        resize = max(fH / H, fW / W)
        newW, newH = int(W * resize), int(H * resize)
        crop_h = int((1 - np.mean(cfg.bot_pct_lim)) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        flip = False
        rotate = 0.0
    crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
    return IdaParams(resize, (newW, newH), crop, flip, rotate)


def ida_matrix(p: IdaParams) -> np.ndarray:
    """3x3 image-plane homography of the aug (ref _img_transform
    post-homography, transform_3d.py:516-537)."""
    rot = np.eye(2) * p.resize
    tran = -np.asarray(p.crop[:2], np.float64)
    if p.flip:
        A = np.asarray([[-1.0, 0.0], [0.0, 1.0]])
        b = np.asarray([p.crop[2] - p.crop[0], 0.0])
        rot = A @ rot
        tran = A @ tran + b
    a = p.rotate / 180 * np.pi
    # PIL Image.rotate(angle) rotates CCW in pixel coords; the reference's
    # matching matrix uses [[cos, sin], [-sin, cos]]
    A = np.asarray([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
    b = np.asarray([p.crop[2] - p.crop[0], p.crop[3] - p.crop[1]]) / 2
    b = A @ (-b) + b
    rot = A @ rot
    tran = A @ tran + b
    m = np.eye(3)
    m[:2, :2] = rot
    m[:2, 2] = tran
    return m


def apply_ida_image(img: np.ndarray, p: IdaParams) -> np.ndarray:
    """img: [H, W, 3] uint8/float -> [fH, fW, 3] float32."""
    assert cv2 is not None, 'cv2 required for image transforms'
    newW, newH = p.resize_dims
    out = cv2.resize(img.astype(np.float32), (newW, newH),
                     interpolation=cv2.INTER_LINEAR)
    x1, y1, x2, y2 = p.crop
    fH, fW = y2 - y1, x2 - x1
    canvas = np.zeros((fH, fW, 3), np.float32)
    sx1, sy1 = max(x1, 0), max(y1, 0)
    sx2, sy2 = min(x2, newW), min(y2, newH)
    if sx2 > sx1 and sy2 > sy1:
        canvas[sy1 - y1:sy2 - y1, sx1 - x1:sx2 - x1] = out[sy1:sy2, sx1:sx2]
    if p.flip:
        canvas = canvas[:, ::-1]
    if p.rotate != 0.0:
        m = cv2.getRotationMatrix2D((fW / 2, fH / 2), p.rotate, 1.0)
        canvas = cv2.warpAffine(canvas, m, (fW, fH))
    return canvas


def apply_ida_intrinsics(intrinsics: np.ndarray, p: IdaParams) -> np.ndarray:
    """intrinsics: [4, 4] viewpad -> updated (ida_mat @ K[:3,:3])."""
    out = intrinsics.copy()
    out[:3, :3] = ida_matrix(p) @ intrinsics[:3, :3]
    return out


def transform_boxes_2d(boxes: np.ndarray, p: IdaParams,
                       min_area: float = 64.0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """2D GT boxes through the ida aug (ref ResizeCropFlipImageMono,
    transform_3d.py:600-660).  Returns (boxes, keep_mask); boxes are clipped,
    mask drops area <= min_area."""
    if boxes.size == 0:
        return boxes.reshape(0, 4), np.zeros((0,), bool)
    b = boxes.astype(np.float64) * p.resize
    x1, y1, x2, y2 = p.crop
    b[:, 0::2] = np.clip(b[:, 0::2], x1, x2) - x1
    b[:, 1::2] = np.clip(b[:, 1::2], y1, y2) - y1
    keep = (b[:, 2:] - b[:, :2]).prod(1) > min_area
    if p.flip:
        w = x2 - x1
        b2 = b.copy()
        b2[:, 0] = w - b[:, 2]
        b2[:, 2] = w - b[:, 0]
        b = b2
    if p.rotate != 0.0:
        a = p.rotate / 180 * np.pi
        A = np.asarray([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
        c = np.asarray([x2 - x1, y2 - y1]) / 2
        off = A @ (-c) + c
        corners = np.stack([b[:, 0], b[:, 1], b[:, 0], b[:, 3],
                            b[:, 2], b[:, 3], b[:, 2], b[:, 1]],
                           axis=1).reshape(-1, 4, 2)
        corners = corners @ A.T + off[None, None]
        b = np.concatenate([corners.min(1), corners.max(1)], axis=1)
        b[:, 0::2] = np.clip(b[:, 0::2], 0, x2 - x1)
        b[:, 1::2] = np.clip(b[:, 1::2], 0, y2 - y1)
        keep &= (b[:, 2:] - b[:, :2]).prod(1) > min_area
    return b.astype(np.float32), keep


# ------------------------------------------------ multi-scale center crops

def ms_center_crop_params(resize: float, cfg: IdaAugConfig,
                          center_size: float = 2.0) -> IdaParams:
    """MSResizeCropFlipImage._crop_augmentation (ref transform_3d.py:807-818):
    a `center_size` x zoom of the image center at the shared final_dim."""
    H, W = cfg.H, cfg.W
    fH, fW = cfg.final_dim
    r = center_size * resize
    newW, newH = int(W * r), int(H * r)
    crop_h = int(max(0, newH - fH) / 2)
    crop_w = int(max(0, newW - fW) / 2)
    return IdaParams(r, (newW, newH),
                     (crop_w, crop_h, crop_w + fW, crop_h + fH), False, 0.0)


def ms_resize_crop_flip(imgs: Sequence[np.ndarray], intrinsics, extrinsics,
                        timestamps, p: IdaParams, cfg: IdaAugConfig,
                        view_num: int = 1, center_size: float = 2.0):
    """MSResizeCropFlipImage (ref transform_3d.py:677-818): the shared ida
    aug on ALL views plus `view_num` appended center-zoom copies of the
    first views (duplicated extrinsics/timestamps, ida-updated intrinsics).
    Multi-scale variant, registered-but-unused in the shipped recipes.

    Returns (imgs, intrinsics, extrinsics, timestamps) with
    len == N + view_num.
    """
    out_imgs = [apply_ida_image(im, p) for im in imgs]
    out_k = [apply_ida_intrinsics(K, p) for K in intrinsics]
    out_e = list(extrinsics)
    out_t = list(timestamps)
    cp = ms_center_crop_params(p.resize, cfg, center_size)
    for i in range(view_num):
        out_imgs.append(apply_ida_image(imgs[i], cp))
        out_k.append(apply_ida_intrinsics(intrinsics[i], cp))
        out_e.append(extrinsics[i])
        out_t.append(timestamps[i])
    return out_imgs, out_k, out_e, out_t


# --------------------------------------------------- albumentations bridge

def albu_multiview(transforms: Sequence[dict]):
    """AlbuMultiview3D (ref transform_3d.py:907-1041): albumentations-based
    per-view image aug from a config list of dicts.  Returns an
    imgs -> imgs callable; raises if albumentations is unavailable (the
    reference does the same).  Registered-but-unused in shipped recipes."""
    try:
        import albumentations
        from albumentations import Compose
    except ImportError as e:                     # pragma: no cover
        raise RuntimeError('albumentations is not installed') from e

    def build(t):
        t = dict(t)
        cls = getattr(albumentations, t.pop('type'))
        if 'transforms' in t:
            t['transforms'] = [build(x) for x in t['transforms']]
        return cls(**t)

    aug = Compose([build(t) for t in transforms])

    def apply(imgs):
        return [aug(image=np.asarray(im))['image'] for im in imgs]

    return apply


# --------------------------------------------------------------- BEV aug

def global_rot_scale(rng: np.random.Generator,
                     lidar2img: np.ndarray, extrinsics: np.ndarray,
                     gt_boxes: np.ndarray,
                     rot_range=(-0.3925, 0.3925),
                     scale_range=(0.95, 1.05)):
    """BEV rotation + scale applied to camera matrices and 3D GT
    (ref GlobalRotScaleTransImage with reverse_angle=True).

    lidar2img/extrinsics: [V, 4, 4]; gt_boxes: [G, 9] bottom-center.
    Returns updated (lidar2img, extrinsics, gt_boxes).
    """
    ang = rng.uniform(*rot_range)
    scale = rng.uniform(*scale_range)
    ca, sa = np.cos(ang), np.sin(ang)
    R = np.asarray([[ca, -sa, 0, 0], [sa, ca, 0, 0],
                    [0, 0, 1, 0], [0, 0, 0, 1]])
    S = np.diag([scale, scale, scale, 1.0])
    Sinv = np.diag([1 / scale, 1 / scale, 1 / scale, 1.0])
    # reverse_angle=True: matrices right-multiplied by R itself
    M_right = R @ Sinv
    lidar2img = lidar2img @ M_right
    extrinsics = np.transpose(M_right, (1, 0)) @ extrinsics
    # points must transform as M_right^{-1} = S @ R^{-1} to keep projections
    # fixed: rotate centers by -ang, then scale
    gt = gt_boxes.copy()
    c, s = np.cos(-ang), np.sin(-ang)
    rot2 = np.asarray([[c, -s], [s, c]])
    gt[:, :2] = gt[:, :2] @ rot2.T
    gt[:, 6] = gt[:, 6] - ang
    if gt.shape[1] > 7:
        gt[:, 7:9] = gt[:, 7:9] @ rot2.T
    gt[:, :6] *= scale        # centers + sizes
    return lidar2img, extrinsics, gt


# --------------------------------------------------- photometric distortion

def photometric_distortion(rng: np.random.Generator, img: np.ndarray,
                           brightness_delta=32, contrast_range=(0.5, 1.5),
                           saturation_range=(0.5, 1.5), hue_delta=18
                           ) -> np.ndarray:
    """One image [H, W, 3] float32 RGB (ref PhotoMetricDistortion...,
    transform_3d.py:1042-1126)."""
    assert cv2 is not None
    img = img.astype(np.float32)
    if rng.integers(2):
        img = img + rng.uniform(-brightness_delta, brightness_delta)
    mode = rng.integers(2)
    if mode == 1 and rng.integers(2):
        img = img * rng.uniform(*contrast_range)
    hsv = cv2.cvtColor(np.clip(img, 0, 255), cv2.COLOR_RGB2HSV)
    if rng.integers(2):
        hsv[..., 1] *= rng.uniform(*saturation_range)
    if rng.integers(2):
        hsv[..., 0] += rng.uniform(-hue_delta, hue_delta)
        hsv[..., 0][hsv[..., 0] > 360] -= 360
        hsv[..., 0][hsv[..., 0] < 0] += 360
    img = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    if mode == 0 and rng.integers(2):
        img = img * rng.uniform(*contrast_range)
    if rng.integers(2):
        img = img[..., rng.permutation(3)]
    return img


# -------------------------------------------------------- normalize / pad

def normalize_image(img: np.ndarray, mean=IMG_MEAN, std=IMG_STD) -> np.ndarray:
    return (img.astype(np.float32) - mean) / std


def pad_to_divisor(img: np.ndarray, divisor: int = 32) -> np.ndarray:
    h, w = img.shape[:2]
    H = int(np.ceil(h / divisor)) * divisor
    W = int(np.ceil(w / divisor)) * divisor
    if (H, W) == (h, w):
        return img
    out = np.zeros((H, W, *img.shape[2:]), img.dtype)
    out[:h, :w] = img
    return out


# ------------------------------------------------------ native fast path

_native = None
_calls_lock = threading.Lock()


def _load_native() -> ctypes.CDLL:
    global _native
    if _native is None:
        from ..utils.native_build import ensure_built
        lib = ctypes.CDLL(str(ensure_built()))
        lib.preprocess_views.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int]
        lib.preprocess_views.restype = None
        _native = lib
    return _native


def native_preprocess(imgs: Sequence[np.ndarray], p: IdaParams,
                      mean=IMG_MEAN, std=IMG_STD,
                      num_threads: int = 6) -> np.ndarray:
    """Fused resize+crop+flip+normalize of all views in the C++ worker
    pool -> [V, fH, fW, 3] float32.

    Only valid when rotate == 0 (the shipped recipes use rot_lim (0, 0));
    a rotation raises.  Each call adds one to `native_preprocess.calls`.
    """
    if p.rotate != 0.0:
        raise ValueError('native_preprocess takes no rotation; use '
                         'apply_ida_image + normalize_image')
    lib = _load_native()
    V = len(imgs)
    x1, y1, x2, y2 = p.crop
    fH, fW = y2 - y1, x2 - x1
    out = np.empty((V, fH, fW, 3), np.float32)
    srcs = (ctypes.c_void_p * V)()
    hw = np.empty((V, 2), np.int32)
    keep = []
    for i, im in enumerate(imgs):
        im8 = np.ascontiguousarray(im, dtype=np.uint8)
        keep.append(im8)
        srcs[i] = im8.ctypes.data_as(ctypes.c_void_p).value
        hw[i] = im8.shape[:2]
    # dst pixel x -> src pixel, cv2 half-pixel-center convention:
    # sx = (x + crop_x + 0.5)/resize - 0.5
    a = 1.0 / p.resize
    affine = np.tile(np.asarray(
        [a, (x1 + 0.5) / p.resize - 0.5, a, (y1 + 0.5) / p.resize - 0.5],
        np.float32), (V, 1))
    flips = np.full((V,), int(p.flip), np.int32)
    stdinv = (1.0 / std).astype(np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    lib.preprocess_views(
        V, srcs, hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), fH, fW,
        affine.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        stdinv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    with _calls_lock:
        native_preprocess.calls += 1
    return out


native_preprocess.calls = 0
