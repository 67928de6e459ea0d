"""Instance-segmentation metrics: AP@50, PQ/F1/Pre/Rec, mIoU, Rand Index.

The port's own copy of ``nvfi_tpu/eval/segm_metrics.py`` (numpy and scipy;
its results equal the JAX package's exactly): per-image IoU matching,
MS-COCO 101-point AP, the panoptic-quality family, the Hungarian-matched
clustering metrics and the label alignment helpers.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def eval_segm(segm: np.ndarray, mask: np.ndarray, ignore_npoint_thresh: int = 0):
    """Per-image matching of predicted soft masks against GT instance labels.

    Args:
      segm: (N,) GT instance ids.
      mask: (N, K) predicted soft masks.
    Returns: (pred_iou, pred_matched, confidence, n_gt_inst).
    """
    segm_pred = np.argmax(mask, axis=1)
    _, segm, gt_sizes = np.unique(segm, return_inverse=True, return_counts=True)
    pred_ids, segm_pred, pred_sizes = np.unique(segm_pred, return_inverse=True, return_counts=True)
    n_gt = gt_sizes.shape[0]
    n_pred = pred_sizes.shape[0]
    mask = mask[:, pred_ids]

    intersection = np.zeros((n_gt, n_pred))
    for i in range(n_gt):
        seg_i = segm == i
        for j in range(n_pred):
            intersection[i, j] = np.sum(seg_i & (segm_pred == j))

    ignore_ids = np.where(gt_sizes < ignore_npoint_thresh)[0]
    pred_ignore_ratio = np.sum(intersection[ignore_ids], axis=0) / pred_sizes
    invalid_pred = pred_ignore_ratio > 0.5
    pred_sizes = pred_sizes - np.sum(intersection[ignore_ids], axis=0)
    valid_pred = (pred_sizes > 0) & ~invalid_pred

    intersection = np.delete(intersection, ignore_ids, axis=0)
    gt_sizes = np.delete(gt_sizes, ignore_ids, axis=0)
    n_gt = gt_sizes.shape[0]

    intersection = intersection[:, valid_pred]
    pred_sizes = pred_sizes[valid_pred]
    mask = mask[:, valid_pred]
    n_pred = pred_sizes.shape[0]

    confidence = np.zeros(n_pred)
    for j in range(n_pred):
        inst = mask[segm_pred == j, j]
        confidence[j] = inst.mean() if inst.size else 0.0

    union = gt_sizes[:, None] + pred_sizes[None, :] - intersection
    iou = intersection / np.maximum(union, 1e-10)
    pred_iou = iou.max(axis=0) if n_gt else np.zeros(n_pred)
    pred_matched = (pred_iou >= 0.5).astype(float)
    return pred_iou, pred_matched, confidence, n_gt


def accumulate_eval_results(segm: np.ndarray, mask: np.ndarray, ignore_npoint_thresh: int = 0):
    """Batch accumulation (reference :8-35).  segm (B,N), mask (B,N,K)."""
    ious, matched, conf, n_inst = [], [], [], 0
    for b in range(segm.shape[0]):
        i, m, c, n = eval_segm(segm[b], mask[b], ignore_npoint_thresh)
        ious.append(i)
        matched.append(m)
        conf.append(c)
        n_inst += n
    return np.concatenate(ious), np.concatenate(matched), np.concatenate(conf), n_inst


def calculate_AP(pred_matched: np.ndarray, confidence: np.ndarray, n_gt_inst: int,
                 eps: float = 1e-10) -> float:
    """MS-COCO 101-point AP at IoU 0.5 (reference :99-143)."""
    order = np.argsort(-confidence, kind="mergesort")
    pred_matched = pred_matched[order]
    tp = np.cumsum(pred_matched)
    fp = np.cumsum(1 - pred_matched)
    precisions = (tp / np.maximum(tp + fp, eps)).tolist()
    recalls = (tp / max(n_gt_inst, eps)).tolist()
    for i in range(len(precisions) - 1, 0, -1):
        precisions[i - 1] = max(precisions[i - 1], precisions[i])
    thresholds = np.linspace(0, 1, 101)
    inds = np.searchsorted(recalls, thresholds, side="left")
    queried = np.zeros(101)
    for rid, pid in enumerate(inds):
        if pid < len(precisions):
            queried[rid] = precisions[pid]
    return float(np.mean(queried))


def calculate_PQ_F1(pred_iou: np.ndarray, pred_matched: np.ndarray, n_gt_inst: int,
                    eps: float = 1e-10):
    """Panoptic quality family (reference :146-161)."""
    tp = pred_matched.sum()
    tp_iou = pred_iou[pred_matched > 0].sum()
    fp = pred_matched.shape[0] - tp
    fn = n_gt_inst - tp
    pq = tp_iou / max(tp + 0.5 * fp + 0.5 * fn, eps)
    pre = tp / max(tp + fp, eps)
    rec = tp / max(tp + fn, eps)
    f1 = (2 * pre * rec) / max(pre + rec, eps)
    return float(pq), float(f1), float(pre), float(rec)


def clustering_miou(mask: np.ndarray, segm: np.ndarray) -> float:
    """Hungarian-matched mean IoU over one image (reference :167-232).

    mask: (N, K) soft predictions; segm: (N,) GT ids starting at 0.
    """
    n_gt = int(segm.max()) + 1
    k = max(mask.shape[-1], n_gt)
    pred = np.argmax(mask, axis=-1)
    pred_oh = np.eye(k)[pred]
    gt_oh = np.eye(k)[segm]
    inter = gt_oh.T @ pred_oh
    union = gt_oh.sum(0)[:, None] + pred_oh.sum(0)[None, :] - inter
    iou = inter / (union + 1e-8)
    iou = iou[:n_gt]
    row, col = linear_sum_assignment(iou, maximize=True)
    return float(np.mean(iou[row, col]))


def rand_index(mask: np.ndarray, segm: np.ndarray) -> float:
    """Rand index (reference :236-242)."""
    pred = np.argmax(mask, axis=-1)
    same_gt = segm[:, None] == segm[None, :]
    same_pred = pred[:, None] == pred[None, :]
    return float(np.mean(same_gt == same_pred))


def compress_label(labels: np.ndarray) -> np.ndarray:
    """Relabel to consecutive ids (reference utils/point_segm_util.py:6-12)."""
    _, inv = np.unique(labels, return_inverse=True)
    return inv.reshape(labels.shape)


def align_insts(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Hungarian GT<->pred label alignment (reference utils/point_segm_util.py:15-28)."""
    n_gt = int(gt.max()) + 1
    n_pred = int(pred.max()) + 1
    k = max(n_gt, n_pred)
    inter = np.zeros((k, k))
    for i in range(n_gt):
        g = gt == i
        for j in range(n_pred):
            inter[i, j] = np.sum(g & (pred == j))
    row, col = linear_sum_assignment(-inter)
    remap = np.arange(k)
    for r, c in zip(row, col):
        remap[c] = r
    return remap[pred]
