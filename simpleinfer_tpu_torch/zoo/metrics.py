"""Detection and classification accuracy metrics (counterpart of
simpleinfer_tpu/zoo/metrics.py, numpy only).

The BASELINE.json acceptance criteria are "INT8 within 0.5 mAP (YOLOv5) /
0.5% top-1 (ResNet) of FP32"; this module provides the evaluators that
produce those numbers. The reference has no metrics code at all (its
oracle is 'look at the annotated images', README.md:23-33).

- average_precision / mean_average_precision: VOC/COCO-style AP with
  all-points interpolation over IoU thresholds.
- match_detections: greedy IoU matching of predictions to ground truth.
- top1_accuracy / topk_accuracy for classification.
- int8_parity_report: fp32-vs-quantized engine comparison on a stream of
  inputs (the mAP-delta proxy runnable without a labeled dataset: the
  fp32 model's detections act as ground truth).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .detect import decode_predictions, iou_xyxy


def match_detections(pred_boxes, pred_scores, gt_boxes,
                     iou_thresh: float = 0.5):
    """Greedy match (by descending score) of predictions to ground-truth
    boxes. Returns a bool array: prediction i is a true positive."""
    order = np.argsort(-np.asarray(pred_scores), kind="stable")
    used = np.zeros(len(gt_boxes), bool)
    tp = np.zeros(len(pred_boxes), bool)
    for i in order:
        if len(gt_boxes) == 0:
            break
        ious = iou_xyxy(np.asarray(pred_boxes[i]), np.asarray(gt_boxes))
        ious = np.where(used, -1.0, ious)
        j = int(np.argmax(ious))
        if ious[j] >= iou_thresh:
            tp[i] = True
            used[j] = True
    return tp


def average_precision(tp: np.ndarray, scores: np.ndarray,
                      n_gt: int) -> float:
    """All-points-interpolated AP from per-prediction TP flags."""
    if n_gt == 0:
        return 0.0 if len(tp) else float("nan")
    order = np.argsort(-np.asarray(scores), kind="stable")
    tp = np.asarray(tp, dtype=np.float64)[order]
    fp = 1.0 - tp
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-9)
    # append sentinels; make precision monotone decreasing
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.concatenate([[1.0], precision, [0.0]])
    p = np.maximum.accumulate(p[::-1])[::-1]
    return float(np.sum((r[1:] - r[:-1]) * p[1:]))


def mean_average_precision(predictions: list, ground_truths: list,
                           num_classes: int,
                           iou_thresholds=(0.5,)) -> float:
    """mAP over images/classes/IoU-thresholds.

    predictions: per image, list of (box_xyxy, score, class_id);
    ground_truths: per image, list of (box_xyxy, class_id).
    """
    aps = []
    for iou_t in iou_thresholds:
        for c in range(num_classes):
            scores, tps, n_gt = [], [], 0
            for preds, gts in zip(predictions, ground_truths):
                pb = [p[0] for p in preds if p[2] == c]
                ps = [p[1] for p in preds if p[2] == c]
                gb = [g[0] for g in gts if g[1] == c]
                n_gt += len(gb)
                if pb:
                    tp = match_detections(pb, ps, np.asarray(gb)
                                          if gb else np.zeros((0, 4)), iou_t)
                    scores.extend(ps)
                    tps.extend(tp.tolist())
            if n_gt == 0 and not scores:
                continue  # class absent entirely
            aps.append(average_precision(np.asarray(tps),
                                         np.asarray(scores), n_gt))
    return float(np.mean(aps)) if aps else float("nan")


def top1_accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    return float((np.argmax(logits, axis=-1) == labels).mean())


def topk_accuracy(logits: np.ndarray, labels: np.ndarray,
                  k: int = 5) -> float:
    topk = np.argsort(-logits, axis=-1)[:, :k]
    return float((topk == labels[:, None]).any(axis=1).mean())


# ---------------------------------------------------------- parity report
@dataclass
class ParityReport:
    map_vs_fp32: float  # quantized mAP with fp32 detections as truth
    n_images: int
    fp32_detections: int
    quant_detections: int
    max_abs_logit_delta: float
    # rank-INSENSITIVE agreement: fraction of truth detections that have
    # a same-class IoU>=0.5 match anywhere in the other engine's set.
    # mAP additionally punishes score-rank reshuffles, which on dense
    # near-threshold detection sets flip on ulp-level perturbations —
    # box_recall is the stable budget statistic for CI assertions
    # (tests/test_acceptance.py).
    box_recall: float = float("nan")

    def __str__(self):
        return (f"int8-vs-fp32: mAP@0.5 {self.map_vs_fp32:.4f}, "
                f"box recall {self.box_recall:.4f} over "
                f"{self.n_images} images ({self.fp32_detections} fp32 / "
                f"{self.quant_detections} int8 detections), max |Δraw| "
                f"{self.max_abs_logit_delta:.4g}")


def int8_parity_report(engine_fp32, engine_quant, inputs: np.ndarray,
                       input_name: str | None = None,
                       conf_thresh: float = 0.25,
                       num_classes: int = 80) -> ParityReport:
    """Run both engines on the same NHWC batch; score the quantized
    engine's detections against the fp32 engine's (as pseudo ground
    truth). A quantization that preserves behavior scores mAP ~1.0."""
    in_name = input_name or engine_fp32.input_names[0]
    out_fp = engine_fp32.run({in_name: inputs})
    out_q = engine_quant.run({in_name: inputs})
    (oname,) = engine_fp32.output_names[:1]
    pf, pq = np.asarray(out_fp[oname], np.float32), np.asarray(
        out_q[oname], np.float32)
    preds, gts = [], []
    nf = nq = 0
    for i in range(pf.shape[0]):
        df = decode_predictions(pf[i], conf_thresh=conf_thresh)
        dq = decode_predictions(pq[i], conf_thresh=conf_thresh)
        nf += len(df)
        nq += len(dq)
        gts.append([(np.asarray(d.box), d.class_id) for d in df])
        preds.append([(np.asarray(d.box), d.score, d.class_id) for d in dq])
    m = mean_average_precision(preds, gts, num_classes)
    matched = total = 0
    for preds_i, gts_i in zip(preds, gts):
        for c in {g[1] for g in gts_i}:
            gb = [g[0] for g in gts_i if g[1] == c]
            pb = [p[0] for p in preds_i if p[2] == c]
            ps = [p[1] for p in preds_i if p[2] == c]
            total += len(gb)
            if pb:
                matched += int(match_detections(
                    pb, ps, np.asarray(gb)).sum())
    return ParityReport(
        map_vs_fp32=m, n_images=pf.shape[0], fp32_detections=nf,
        quant_detections=nq,
        max_abs_logit_delta=float(np.abs(pf - pq).max()),
        box_recall=(matched / total if total else float("nan")))
