"""Standalone nuScenes detection-metric evaluator (mAP / TP errors / NDS).

The port's copy of `mv2d_tpu/eval/nuscenes_eval.py` (numpy only,
unchanged: the two give the same float64 metrics).

The reference delegates evaluation to the nuscenes-devkit
(ref: custom_nuscenes_dataset.py:370-428 -> NuScenesEval).  The devkit is
not a dependency of this framework, so the official protocol is
re-implemented here (numpy only), matching the devkit's
`nuscenes/eval/detection/{algo,evaluate}.py` + `eval/common/loaders.py`
step for step:

  * `filter_eval_boxes`: GT and predictions are filtered to per-class
    max ego distances (cvpr_2019 ranges: 50 m vehicles, 40 m ped/moto/
    bicycle, 30 m cone/barrier) BEFORE matching.  Ego distance is the
    xy-norm of the gravity center in the EGO frame (global-frame distance
    to the ego pose in the devkit == ego-frame norm, rotation invariant);
    samples may carry `l2e_r`/`l2e_t` (lidar->ego) for the exact offset,
    else the lidar origin approximates the ego origin.
    (The devkit's bike-rack filter needs the map database and is not
    reproducible from infos; it is omitted — documented deviation.)
  * `accumulate`: per (class, dist_th in {0.5, 1, 2, 4} m), ALL
    predictions of the class are pooled across samples and matched in
    GLOBAL descending-score order (ties: higher original index first,
    like the devkit's sorted()[::-1]) to the nearest unmatched same-class
    GT of the same sample (strict `dist < th`).  TP error curves are
    cumulative means in that global order, interpolated onto the
    101-point recall grid via the interpolated confidence curve.
  * `calc_ap`: 101-point precision curve, clipped at recall>0.1 and
    precision-0.1, normalized by 0.9.
  * `calc_tp`: mean of the interpolated error curve over recall indices
    11..max_recall_ind (last nonzero confidence); 1.0 if none.
  * classes with no GT (or no matches) contribute AP=0 and TP=1.0 to the
    means (devkit `DetectionMetricData.no_predictions`).
  * NDS = (5*mAP + sum_tp max(0, 1 - mTP)) / 10, with the devkit's
    hardcoded exclusions (traffic_cone: orient/vel/attr = NaN;
    barrier: vel/attr = NaN) nanmean'd away.

GT comes from the same infos pkl the dataset reads, so evaluation works
without the nuScenes DB; results can also be exported in the official
submission JSON (eval/results.py) for the devkit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CLASSES = ('car', 'truck', 'trailer', 'bus', 'construction_vehicle',
           'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone', 'barrier')
DIST_THS = (0.5, 1.0, 2.0, 4.0)
TP_DIST_TH = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
NELEM = 101
TP_METRICS = ('trans_err', 'scale_err', 'orient_err', 'vel_err', 'attr_err')
# devkit detection config cvpr_2019 class_range
CLASS_RANGES = {
    'car': 50.0, 'truck': 50.0, 'bus': 50.0, 'trailer': 50.0,
    'construction_vehicle': 50.0, 'pedestrian': 40.0, 'motorcycle': 40.0,
    'bicycle': 40.0, 'traffic_cone': 30.0, 'barrier': 30.0}
# devkit evaluate.py hardcoded TP exclusions
LEAVE_OUT = {
    'traffic_cone': {'attr_err', 'vel_err', 'orient_err'},
    'barrier': {'attr_err', 'vel_err'}}


def _scale_iou(pred_wlh: np.ndarray, gt_wlh: np.ndarray) -> float:
    """Aligned 3D IoU of sizes only (devkit scale_iou)."""
    mins = np.minimum(pred_wlh, gt_wlh)
    inter = mins.prod()
    union = pred_wlh.prod() + gt_wlh.prod() - inter
    return float(inter / max(union, 1e-9))


def _yaw_diff(a: float, b: float, period: float = 2 * np.pi) -> float:
    d = (a - b) % period
    if d > period / 2:
        d = period - d
    return abs(d)


def _cummean(x: np.ndarray) -> np.ndarray:
    """devkit utils.cummean: nan-aware cumulative mean; all-nan -> ones."""
    if np.isnan(x).sum() == len(x):
        return np.ones(len(x))
    sum_vals = np.nancumsum(x.astype(np.float64))
    count_vals = np.cumsum(~np.isnan(x))
    return np.divide(sum_vals, count_vals,
                     out=np.zeros_like(sum_vals), where=count_vals != 0)


def ego_distances(boxes: np.ndarray,
                  l2e_r: Optional[np.ndarray] = None,
                  l2e_t: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-box xy ego distance from lidar-frame bottom-center boxes [N, >=6].

    devkit ego_dist = ||global gravity center - ego pose||_xy, which equals
    the ego-frame gravity-center xy norm.  Without lidar->ego calibration
    the lidar origin stands in for the ego origin."""
    if len(boxes) == 0:
        return np.zeros(0)
    c = boxes[:, :3].astype(np.float64).copy()
    c[:, 2] += boxes[:, 5] / 2.0   # bottom -> gravity center
    if l2e_r is not None:
        c = c @ np.asarray(l2e_r, np.float64).T
    if l2e_t is not None:
        c = c + np.asarray(l2e_t, np.float64)
    return np.linalg.norm(c[:, :2], axis=-1)


def filter_sample_by_range(sample: dict,
                           ranges: Dict[str, float] = CLASS_RANGES) -> dict:
    """devkit loaders.filter_eval_boxes class-range filter (strict <).

    Uses sample['ego_dists'] if present, else computes from boxes with the
    optional 'l2e_r'/'l2e_t' entries."""
    names = np.asarray(sample['names'])
    n = len(names)
    if n == 0:
        return sample
    dists = sample.get('ego_dists')
    if dists is None:
        dists = ego_distances(np.asarray(sample['boxes'], np.float64),
                              sample.get('l2e_r'), sample.get('l2e_t'))
    maxd = np.asarray([ranges.get(str(nm), np.inf) for nm in names])
    keep = np.asarray(dists) < maxd
    out = dict(sample)
    for k in ('boxes', 'names', 'scores', 'attrs', 'ego_dists'):
        if k in out and out[k] is not None:
            out[k] = np.asarray(out[k])[keep]
    return out


def _no_predictions() -> dict:
    """devkit DetectionMetricData.no_predictions."""
    md = dict(recall=np.linspace(0, 1, NELEM),
              precision=np.zeros(NELEM),
              confidence=np.zeros(NELEM))
    for m in TP_METRICS:
        md[m] = np.ones(NELEM)
    return md


def accumulate(preds: List[dict], gts: List[dict], cls: str, dist_th: float
               ) -> dict:
    """devkit algo.accumulate for one (class, threshold).

    preds/gts: parallel per-sample dicts {boxes [N, 9]
    (x, y, z_bottom, w, l, h, yaw, vx, vy), names [N] str, scores [N]
    (preds), attrs [N] str optional}.  Returns the metric-data dict
    {recall, precision, confidence, <tp metric curves>} on the 101-point
    recall grid."""
    npos = sum(int((np.asarray(gt['names']) == cls).sum()) for gt in gts)
    if npos == 0:
        return _no_predictions()

    # pool class predictions across samples
    samp_idx, boxes, scores, attrs = [], [], [], []
    for si, pred in enumerate(preds):
        pm = np.asarray(pred['names']) == cls
        if not pm.any():
            continue
        pb = np.asarray(pred['boxes'], np.float64)[pm]
        ps = np.asarray(pred['scores'], np.float64)[pm]
        pa = pred.get('attrs')
        pa = np.asarray(pa)[pm] if pa is not None else np.asarray([''] * len(pb))
        for b, s, a in zip(pb, ps, pa):
            samp_idx.append(si)
            boxes.append(b)
            scores.append(float(s))
            attrs.append(str(a))
    if not boxes:
        return _no_predictions()
    scores_a = np.asarray(scores)
    # devkit tie order: sorted by (conf, idx) ascending, reversed
    order = np.lexsort((np.arange(len(scores_a)), scores_a))[::-1]

    # per-sample GT caches for this class
    gt_cache = []
    for gt in gts:
        gm = np.asarray(gt['names']) == cls
        gb = np.asarray(gt['boxes'], np.float64)[gm]
        ga = gt.get('attrs')
        ga = np.asarray(ga)[gm] if ga is not None else None
        gt_cache.append((gb, ga, np.zeros(len(gb), bool)))

    tp, fp, conf = [], [], []
    match = {m: [] for m in TP_METRICS}
    match_conf = []
    period = np.pi if cls == 'barrier' else 2 * np.pi
    for ind in order:
        si = samp_idx[ind]
        pb = boxes[ind]
        gb, ga, taken = gt_cache[si]
        is_match = False
        if len(gb):
            d = np.linalg.norm(pb[:2] - gb[:, :2], axis=-1)
            d = np.where(taken, np.inf, d)
            gi = int(d.argmin())
            is_match = bool(d[gi] < dist_th)
        if is_match:
            taken[gi] = True
            tp.append(1)
            fp.append(0)
            conf.append(scores_a[ind])
            match['trans_err'].append(float(d[gi]))
            match['vel_err'].append(float(np.linalg.norm(
                pb[7:9] - gb[gi, 7:9])))
            match['scale_err'].append(1.0 - _scale_iou(pb[3:6], gb[gi, 3:6]))
            match['orient_err'].append(
                _yaw_diff(float(pb[6]), float(gb[gi, 6]), period))
            # devkit attr_acc: nan when GT attr is '' (or unavailable)
            if ga is None or str(ga[gi]) == '':
                match['attr_err'].append(np.nan)
            else:
                match['attr_err'].append(
                    1.0 - float(str(ga[gi]) == attrs[ind]))
            match_conf.append(scores_a[ind])
        else:
            tp.append(0)
            fp.append(1)
            conf.append(scores_a[ind])

    if len(match['trans_err']) == 0:
        return _no_predictions()

    tp_c = np.cumsum(tp).astype(np.float64)
    fp_c = np.cumsum(fp).astype(np.float64)
    conf_a = np.asarray(conf, np.float64)
    prec = tp_c / (fp_c + tp_c)
    rec = tp_c / float(npos)
    rec_interp = np.linspace(0, 1, NELEM)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf_a, right=0)
    md = dict(recall=rec_interp, precision=prec_i, confidence=conf_i)
    mc = np.asarray(match_conf, np.float64)
    for m in TP_METRICS:
        tmp = _cummean(np.asarray(match[m], np.float64))
        md[m] = np.interp(conf_i[::-1], mc[::-1], tmp[::-1])[::-1]
    return md


def calc_ap(md: dict, min_recall: float = MIN_RECALL,
            min_precision: float = MIN_PRECISION) -> float:
    """devkit algo.calc_ap."""
    prec = np.copy(md['precision'])
    prec = prec[round(100 * min_recall) + 1:]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def _max_recall_ind(md: dict) -> int:
    non_zero = np.nonzero(md['confidence'])[0]
    return int(non_zero[-1]) if len(non_zero) else 0


def calc_tp(md: dict, metric: str, min_recall: float = MIN_RECALL) -> float:
    """devkit algo.calc_tp."""
    first_ind = round(100 * min_recall) + 1
    last_ind = _max_recall_ind(md)
    if last_ind < first_ind:
        return 1.0
    return float(np.mean(md[metric][first_ind:last_ind + 1]))


def evaluate(preds: List[dict], gts: List[dict],
             classes: Sequence[str] = CLASSES,
             filter_range: bool = True) -> Dict[str, float]:
    """Full metric suite (devkit evaluate.py semantics).

    preds/gts are parallel per-sample lists with keys boxes [N, 9]
    (x, y, z_bottom, w, l, h, yaw, vx, vy), names [N] (str array), scores
    [N] (preds only), attrs [N] optional, plus optional 'l2e_r'/'l2e_t'
    (lidar->ego) or precomputed 'ego_dists' for the range filter.
    """
    if filter_range:
        preds = [filter_sample_by_range(p) for p in preds]
        gts = [filter_sample_by_range(g) for g in gts]
    metrics: Dict[str, float] = {}
    mean_dist_aps = []
    label_tp: Dict[str, List[float]] = {m: [] for m in TP_METRICS}
    for cls in classes:
        cls_aps = []
        md_tp = None
        for th in DIST_THS:
            md = accumulate(preds, gts, cls, th)
            ap = calc_ap(md)
            cls_aps.append(ap)
            if th == TP_DIST_TH:
                md_tp = md
        for m in TP_METRICS:
            if m in LEAVE_OUT.get(cls, ()):
                v = float('nan')
            else:
                v = calc_tp(md_tp, m)
            label_tp[m].append(v)
            metrics[f'{cls}_{m}'] = v
        cls_ap = float(np.mean(cls_aps))
        metrics[f'{cls}_AP'] = cls_ap
        mean_dist_aps.append(cls_ap)
    mAP = float(np.mean(mean_dist_aps)) if mean_dist_aps else 0.0
    metrics['mAP'] = mAP
    nds_terms = [5 * mAP]
    for m in TP_METRICS:
        with np.errstate(invalid='ignore'):
            mtp = float(np.nanmean(label_tp[m])) if label_tp[m] else 1.0
        if np.isnan(mtp):
            mtp = 1.0
        metrics[f'm{m}'] = mtp
        nds_terms.append(max(0.0, 1.0 - mtp))
    metrics['NDS'] = float(sum(nds_terms) / 10.0)
    return metrics
