"""Multi-label metrics: binary stats on the device, macro-AUROC on the host.

Counterpart of the JAX package's ``train/metrics.py`` (reference
``get_accuracy``, util/train.py:12-56): ``binary_stats`` is torch (it runs
on the device inside a step); AUROC, the classification report and the
per-class recall are numpy copies (Mann-Whitney U with midrank ties, equal
to sklearn's ``roc_auc_score``), with the reference's constant-column mask.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..registry import PTBXL_ID2CODE


def binary_stats(probs: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Thresholded (0.5) counting metrics over all (sample, class) cells, as
    0-d f32 tensors on the inputs' device (util/train.py:46-53)."""
    preds = (probs >= 0.5).float()
    labels = labels.float()
    tp = torch.sum(preds * labels)
    tn = torch.sum((1 - preds) * (1 - labels))
    fp = torch.sum(preds * (1 - labels))
    fn = torch.sum((1 - preds) * labels)
    eps = 1e-12
    rec_pos = tp / (tp + fn + eps)
    rec_neg = tn / (tn + fp + eps)
    return {
        'binary_accuracy': (tp + tn) / (tp + tn + fp + fn + eps),
        'weighted_binary_accuracy': 0.5 * (rec_pos + rec_neg),
        'binary_positive_recall': rec_pos,
        'binary_negative_recall': rec_neg,
    }


def classification_report(probs: np.ndarray, labels: np.ndarray,
                          threshold: float = 0.5) -> Dict[str, object]:
    """sklearn-style binary classification report over the flattened
    (sample, class) cells -- the reference's ``metrics.classification_report``
    payload (util/train.py:46-53): per-class precision/recall/f1/support for
    'neg' and 'pos', plus accuracy and macro/weighted averages.

    Matches ``sklearn.metrics.classification_report(y_true, y_pred,
    labels=[0, 1], target_names=['neg', 'pos'], output_dict=True,
    zero_division=0)`` exactly (tests/test_metrics.py holds the JAX copy to sklearn).  Note the
    reference passes (preds, labels) in the (y_true, y_pred) slots and swaps
    the rec_pos/rec_neg assignment -- two bugs recorded in SURVEY.md; here
    y_true = labels, y_pred = thresholded probs, names unswapped.
    """
    y_pred = (np.asarray(probs).reshape(-1) >= threshold).astype(np.int64)
    y_true = (np.asarray(labels).reshape(-1) > 0.5).astype(np.int64)
    out: Dict[str, object] = {}
    supports, precs, recs, f1s = [], [], [], []
    for cls, name in ((0, 'neg'), (1, 'pos')):
        tp = int(np.sum((y_pred == cls) & (y_true == cls)))
        pred_p = int(np.sum(y_pred == cls))
        true_p = int(np.sum(y_true == cls))
        prec = tp / pred_p if pred_p else 0.0
        rec = tp / true_p if true_p else 0.0
        f1 = 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0
        out[name] = {'precision': prec, 'recall': rec, 'f1-score': f1,
                     'support': true_p}
        supports.append(true_p)
        precs.append(prec)
        recs.append(rec)
        f1s.append(f1)
    n = int(y_true.size)
    w = np.asarray(supports, np.float64) / max(n, 1)
    out['accuracy'] = float(np.mean(y_pred == y_true))
    out['macro avg'] = {'precision': float(np.mean(precs)),
                        'recall': float(np.mean(recs)),
                        'f1-score': float(np.mean(f1s)), 'support': n}
    out['weighted avg'] = {'precision': float(np.dot(w, precs)),
                           'recall': float(np.dot(w, recs)),
                           'f1-score': float(np.dot(w, f1s)), 'support': n}
    return out


def per_class_recall(probs: np.ndarray, labels: np.ndarray,
                     id2code: Sequence[str] = PTBXL_ID2CODE,
                     threshold: float = 0.5) -> Dict[str, float]:
    """Recall per diagnostic code at the given threshold, over classes with at
    least one positive label (VERDICT round-1 item 4: per-class payload)."""
    probs = np.asarray(probs)
    labels = np.asarray(labels) > 0.5
    preds = probs >= threshold
    out: Dict[str, float] = {}
    for idx in np.nonzero(labels.any(axis=0))[0]:
        pos = labels[:, idx]
        out[id2code[idx]] = float(np.sum(preds[:, idx] & pos) / pos.sum())
    return out


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Binary AUROC via the Mann-Whitney U statistic with midrank ties.

    Equivalent to sklearn.metrics.roc_auc_score for binary labels.
    """
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float('nan')
    order = np.argsort(scores, kind='mergesort')
    ranks = np.empty(scores.size, np.float64)
    sorted_scores = scores[order]
    # midranks for ties
    i = 0
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_sum_pos = ranks[pos].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def multilabel_auroc(
    probs: np.ndarray, labels: np.ndarray,
    id2code: Sequence[str] = PTBXL_ID2CODE,
) -> Dict[str, object]:
    """Macro-AUROC + per-class AUROC over valid classes.

    Valid = the class column is not constant across the batch -- the exact
    reference mask ``torch.any(labels != labels[0], dim=0)`` (util/train.py:29).
    Returns {'macro_auc': float|None, 'per_class_auc': {code: auc}}.
    """
    probs = np.asarray(probs)
    labels = np.asarray(labels)
    msk = np.any(labels != labels[0], axis=0)
    if not msk.any():
        return {'macro_auc': None, 'per_class_auc': None}
    code2auc = {}
    for idx in np.nonzero(msk)[0]:
        code2auc[id2code[idx]] = roc_auc(probs[:, idx], labels[:, idx])
    macro = float(np.mean(list(code2auc.values())))
    return {'macro_auc': macro, 'per_class_auc': code2auc}


def get_accuracy(
    probs, labels, return_auc: bool = True,
    id2code: Sequence[str] = PTBXL_ID2CODE,
) -> Dict[str, object]:
    """Full reference-compatible metric payload (util/train.py:12-56)."""
    stats = {k: float(v) for k, v in binary_stats(torch.as_tensor(np.asarray(probs)),
                                                  torch.as_tensor(np.asarray(labels))).items()}
    out: Dict[str, object] = dict(stats)
    if return_auc:
        out.update(multilabel_auroc(np.asarray(probs), np.asarray(labels), id2code))
    else:
        out.update({'macro_auc': None, 'per_class_auc': None})
    return out
