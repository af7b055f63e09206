"""Precision-recall curve + dataset-level evaluation — port of
``cet_pick_tpu/eval/metrics.py`` without pandas.

``precision_recall_curve`` mirrors reference
cet_pick/evaluation/metrics.py:6-46: predictions sorted by descending score,
ties compressed into buckets, precision/recall/threshold per bucket, average
precision = sum(precision * recall_increment) / n.

``evaluate_detections`` mirrors the driver script
cet_pick/precision_recall_curve.py:33-120: per-image Hungarian matching at
an assignment radius, concatenation over the image list, PR curve, F1 per
threshold, and the running-mean MAE of matched distances (its formula copied
as it is). Tables are dicts of columns: ``image_name``, ``x_coord``,
``y_coord``, ``z_coord`` and, for predictions, optionally ``score``.
``write_pr_table`` writes the PR table as pandas' ``to_csv(sep="\\t",
index=False)`` does; ``merge_output`` and ``remove_golds`` are the host
tools behind the ``merge`` and ``remove-golds`` commands.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Dict, Iterable, Optional

import numpy as np
from scipy import spatial

from cet_pick_tpu_torch.eval.matching import match_coordinates

_XYZ = ("x_coord", "y_coord", "z_coord")


def precision_recall_curve(target, pred, n: Optional[float] = None):
    """target: (N,) 0/1 hits; pred: (N,) scores. Returns
    (precision, recall, threshold, average_precision) per score bucket."""
    target = np.asarray(target, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    if n is None:
        n = target.sum()

    order = np.argsort(-pred, kind="stable")
    scores = pred[order]
    hits = target[order]

    # bucket boundaries where the score changes (ties compressed)
    mask = np.zeros(len(scores), dtype=bool)
    if len(scores):
        mask[:-1] = scores[:-1] != scores[1:]
        mask[-1] = True

    pp = np.where(mask)[0] + 1          # predicted positives per bucket
    tp_cum = np.cumsum(hits)[mask]      # true positives per bucket
    r = np.diff(np.concatenate([[0], tp_cum]))  # hits added per bucket

    with np.errstate(invalid="ignore", divide="ignore"):
        precision = tp_cum / pp
    precision[np.isnan(precision)] = 1
    avpr = float(np.sum(precision * r) / n) if n > 0 else 0.0
    recall = tp_cum / n if n > 0 else np.zeros_like(tp_cum)
    threshold = scores[mask]
    return precision, recall, threshold, avpr


def f1_from_pr(precision, recall):
    """F1 per threshold with 0/0 -> 0 (precision_recall_curve.py:99-103)."""
    p = np.asarray(precision, dtype=np.float64)
    r = np.asarray(recall, dtype=np.float64)
    denom = p + r
    f1 = np.zeros_like(p)
    nz = denom > 0
    f1[nz] = 2 * p[nz] * r[nz] / denom[nz]
    return f1


def _rows_of(table, name):
    names = np.asarray(table["image_name"])
    return np.flatnonzero(names == name)


def evaluate_detections(targets: Dict, predicts: Dict, radius: float,
                        images: str = "target") -> Dict:
    """Full PR/F1 evaluation (precision_recall_curve.py:33-120).

    Returns a dict with the PR table (a dict of arrays), auprc, the best-F1
    row (a dict, or None), the matched-distance MAE and the counts."""
    if images == "union":
        image_list = set(targets["image_name"]) | set(predicts["image_name"])
    elif images == "target":
        image_list = set(targets["image_name"])
    elif images == "predicted":
        image_list = set(predicts["image_name"])
    else:
        raise ValueError(f"unknown images argument: {images}")

    n = len(targets["image_name"])
    matches, scores = [], []
    count, mae = 0, 0.0
    for name in image_list:
        t = _rows_of(targets, name)
        p = _rows_of(predicts, name)
        tc = np.stack([np.asarray(targets[k])[t] for k in _XYZ], axis=1)
        pc = np.stack([np.asarray(predicts[k])[p] for k in _XYZ], axis=1)
        score = (np.asarray(predicts["score"])[p].astype(np.float32)
                 if "score" in predicts else np.ones(len(pc), np.float32))
        match, dist = match_coordinates(tc, pc, radius)
        hit_sum = np.sum(match)
        if hit_sum > 0:
            this_mae = np.sum(dist[match == 1])
            count += hit_sum
            mae += (this_mae - hit_sum * mae) / count
        matches.append(match)
        scores.append(score)

    matches = np.concatenate(matches) if matches else np.zeros(0)
    scores = np.concatenate(scores) if scores else np.zeros(0)

    precision, recall, threshold, auprc = precision_recall_curve(
        matches, scores, n=n)
    f1 = f1_from_pr(precision, recall)
    table = {"threshold": threshold, "precision": precision,
             "recall": recall, "f1": f1}
    best = ({k: float(v[int(np.argmax(f1))]) for k, v in table.items()}
            if len(f1) else None)
    return {
        "table": table,
        "auprc": auprc,
        "mae": float(np.sqrt(mae)) if count else 0.0,
        "best_f1": best["f1"] if best is not None else 0.0,
        "best_row": best,
        "n_targets": n,
        "n_predictions": len(scores),
    }


def _csv_field(v) -> str:
    """One value as pandas' ``to_csv`` writes it: the shortest repr of a
    float (``repr``), nothing for NaN."""
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    return str(v)


def write_pr_table(path: str, table: Dict):
    """The PR table (``evaluate_detections``' ``table``) as a tab-separated
    file, byte for byte ``pd.DataFrame(table).to_csv(path, sep="\\t",
    index=False)`` (metrics.py:109-113, __main__.py:658-659)."""
    cols = list(table)
    n = len(table[cols[0]]) if cols else 0
    with open(path, "w") as f:
        f.write("\t".join(cols) + "\n")
        for i in range(n):
            f.write("\t".join(_csv_field(table[c][i]) for c in cols) + "\n")


def merge_output(path: str, out_name: str,
                 txts: Optional[Iterable[str]] = None):
    """Merge per-tomogram detection txts into one table
    ``image_name x_coord z_coord y_coord score`` (metrics.py:126-147,
    merge_output.py:14-35).

    The reference skips each file's first line (a header assumption);
    kept for drop-in compatibility.
    """
    if txts is None:
        txts = sorted(glob.glob(os.path.join(path, "*.txt")))
    out_file = os.path.join(path, out_name)
    with open(out_file, "w") as out:
        out.write("image_name\tx_coord\tz_coord\ty_coord\tscore\n")
        for f in txts:
            name = os.path.basename(f)[:-4]
            with open(f) as dets:
                for i, line in enumerate(dets):
                    if i > 0:
                        out.write("\t".join([name] + line.split()) + "\n")
    return out_file


def remove_golds(pred_coords: np.ndarray, gold_coords: np.ndarray,
                 radius: float = 20.0) -> np.ndarray:
    """Drop predictions within ``radius`` of any fiducial gold bead
    (metrics.py:150-162, remove_golds.py:14-61, which hardcodes 20)."""
    pred_coords = np.asarray(pred_coords, dtype=np.float64)
    gold_coords = np.asarray(gold_coords, dtype=np.float64)
    if len(pred_coords) == 0 or len(gold_coords) == 0:
        return pred_coords
    dist = spatial.distance.cdist(pred_coords[:, :3], gold_coords[:, :3])
    keep = np.min(dist, axis=1) > radius
    return pred_coords[keep]
