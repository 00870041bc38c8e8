"""Evaluation metrics: the reference's ``utils/eval_metrics.py`` API.

Counterpart of ``tapclip_tpu/utils/eval_metrics.py``: ``evaluate_accuracy``
and ``evaluate_per_class_accuracy`` keep the reference's signatures and
console output (``eval_metrics.py:7-73``) over one batched forward per
loader batch (under ``torch.inference_mode``), plus the confusion matrix and
retrieval Recall@K.  ``attribution_entropy`` / ``attribution_variance``
come from ``models/attribution_monitor.py`` and are re-exported here.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tapclip_tpu_torch.data.prefetch import background_iter
from tapclip_tpu_torch.models.attribution_monitor import (  # noqa: F401
    attribution_entropy,
    attribution_variance,
)


def _logits(model, images) -> np.ndarray:
    with torch.inference_mode():
        return model(images)["logits"].float().cpu().numpy()


def _accumulate(model, dataloader):
    correct = 0
    total = 0
    per_class_correct = defaultdict(int)
    per_class_total = defaultdict(int)
    for images, labels, mask in background_iter(dataloader):
        preds = _logits(model, images).argmax(axis=1)
        keep = np.asarray(mask)
        labels = np.asarray(labels)
        correct += int(((preds == labels) & keep).sum())
        total += int(keep.sum())
        for t, p in zip(labels[keep], preds[keep]):
            per_class_total[int(t)] += 1
            if t == p:
                per_class_correct[int(t)] += 1
    return correct, total, per_class_correct, per_class_total


def evaluate_accuracy(model, dataloader, device=None, verbose: bool = True) -> float:
    """Overall accuracy (%) with the per-class printout (``eval_metrics.py:7-41``).

    ``device`` is accepted for the reference's signature; the model runs on
    the device of its weights.
    """
    correct, total, pcc, pct = _accumulate(model, dataloader)
    acc = 100.0 * correct / total if total > 0 else 0.0
    if verbose:
        # Byte-identical to the reference's stdout (eval_metrics.py:31-38).
        print(f"\U0001f3af Overall Accuracy: {acc:.2f}%")
        print("\U0001f4ca Per-Class Accuracy:")
        for cls in sorted(pct.keys()):
            t, c = pct[cls], pcc[cls]
            a = 100.0 * c / t if t > 0 else 0.0
            print(f" - Class {cls:2d}: {a:.2f}% ({c}/{t})")
    return acc


def evaluate_per_class_accuracy(
    model, dataloader, device=None, class_names: Optional[Sequence[str]] = None
) -> Dict[str, float]:
    """Per-class accuracy dict keyed by class name (``eval_metrics.py:45-73``)."""
    _, _, pcc, pct = _accumulate(model, dataloader)
    acc_dict = {}
    for cls in sorted(pct.keys()):
        t, c = pct[cls], pcc[cls]
        name = class_names[cls] if class_names else str(cls)
        acc_dict[name] = 100.0 * c / t if t > 0 else 0.0
    return acc_dict


def confusion_from_logits(
    logits: np.ndarray,
    labels: np.ndarray,
    mask: Optional[np.ndarray] = None,
    n_cls: Optional[int] = None,
) -> np.ndarray:
    """``[C, C]`` counts from collected logits (rows = true label)."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    keep = np.ones(len(labels), bool) if mask is None else np.asarray(mask, bool)
    C = int(n_cls if n_cls is not None else logits.shape[-1])
    cm = np.zeros((C, C), np.int64)
    np.add.at(cm, (labels[keep], logits.argmax(axis=-1)[keep]), 1)
    return cm


def confusion_matrix(model, dataloader, n_cls: Optional[int] = None) -> np.ndarray:
    """``[C, C]`` counts over a masked loader, rows = true label, cols = prediction."""
    C = int(n_cls if n_cls is not None else model.n_cls)
    cm = np.zeros((C, C), np.int64)
    for images, labels, mask in background_iter(dataloader):
        cm += confusion_from_logits(_logits(model, images), labels, mask, C)
    return cm


def retrieval_recall(img_feats: np.ndarray, txt_feats: np.ndarray, ks: Sequence[int] = (1, 5, 10)) -> Dict[str, float]:
    """Bidirectional image<->text Recall@K over paired features (row ``i`` of
    each pairs with row ``i`` of the other).  Ties count against the true
    pair.  Returns ``{"i2t_r@K": ..., "t2i_r@K": ...}`` fractions in [0, 1]."""
    img = np.asarray(img_feats, np.float32)
    txt = np.asarray(txt_feats, np.float32)
    if img.shape[0] != txt.shape[0]:
        raise ValueError(f"unpaired features: {img.shape[0]} vs {txt.shape[0]}")
    img = img / np.maximum(np.linalg.norm(img, axis=-1, keepdims=True), 1e-8)
    txt = txt / np.maximum(np.linalg.norm(txt, axis=-1, keepdims=True), 1e-8)
    sims = img @ txt.T
    n = sims.shape[0]
    diag = np.diag(sims)
    i2t_rank = (sims >= diag[:, None]).sum(axis=1) - 1
    t2i_rank = (sims >= diag[None, :]).sum(axis=0) - 1
    out: Dict[str, float] = {}
    for k in ks:
        kk = min(k, n)
        out[f"i2t_r@{k}"] = float((i2t_rank < kk).mean())
        out[f"t2i_r@{k}"] = float((t2i_rank < kk).mean())
    return out
