"""Probability calibration for served classifiers (temperature scaling).

Counterpart of ``tapclip_tpu/utils/calibration.py``: fit one scalar ``T``
minimizing the validation NLL of ``softmax(logits / T)`` (Guo et al.,
2017).  It changes confidences, never the argmax.  ``train --calibrate``
writes the fitted ``T`` to ``calibration.json``; ``serve --temperature``
takes it.  The fit is Newton's method on ``t = log T`` in float32 with the
JAX package's step rule, its derivatives from ``torch.autograd``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tapclip_tpu_torch.data.prefetch import background_iter


def fit_temperature(
    logits: np.ndarray,
    labels: np.ndarray,
    mask: Optional[np.ndarray] = None,
    *,
    steps: int = 50,
) -> float:
    """Fit T > 0 minimizing the NLL of ``softmax(logits / T)``; returns T."""
    z0 = torch.as_tensor(np.asarray(logits, np.float32))
    y = torch.as_tensor(np.asarray(labels)).long()
    m = torch.ones(z0.shape[0]) if mask is None else torch.as_tensor(np.asarray(mask, np.float32))

    def nll(t):
        z = z0 * torch.exp(-t)
        ll = torch.take_along_dim(z, y[:, None], dim=1)[:, 0]
        return ((torch.logsumexp(z, dim=-1) - ll) * m).sum() / m.sum().clamp_min(1.0)

    t = torch.tensor(0.0)
    for _ in range(steps):
        tv = t.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(nll(tv), tv, create_graph=True)
        (h,) = torch.autograd.grad(g, tv)
        g, h = g.detach(), h.detach()
        # Newton where locally convex, a gradient step otherwise.
        delta = torch.where(h > 1e-6, g / torch.clamp(h, min=1e-6), g)
        t = t - torch.clamp(delta, -1.0, 1.0)
    return float(np.exp(t.numpy()))


def expected_calibration_error(
    probs: np.ndarray,
    labels: np.ndarray,
    mask: Optional[np.ndarray] = None,
    n_bins: int = 15,
) -> float:
    """ECE: mean |confidence - accuracy| over equal-width confidence bins,
    weighted by bin occupancy (the standard 15-bin protocol)."""
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels)
    keep = np.ones(len(labels), bool) if mask is None else np.asarray(mask, bool)
    conf = probs.max(axis=-1)[keep]
    correct = (probs.argmax(axis=-1) == labels)[keep]
    if conf.size == 0:
        return 0.0
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    ece = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (conf > lo) & (conf <= hi) if lo > 0 else (conf >= lo) & (conf <= hi)
        if sel.any():
            ece += sel.mean() * abs(conf[sel].mean() - correct[sel].mean())
    return float(ece)


def collect_logits(model, dataloader) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run the model over a masked loader -> (logits, labels, mask) stacks."""
    ls, ys, ms = [], [], []
    for images, labels, mask in background_iter(dataloader):
        with torch.inference_mode():
            ls.append(model(images)["logits"].float().cpu().numpy())
        ys.append(np.asarray(labels))
        ms.append(np.asarray(mask))
    return np.concatenate(ls), np.concatenate(ys), np.concatenate(ms)


def _softmax(z: np.ndarray) -> np.ndarray:
    z = z - z.max(-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(-1, keepdims=True)


def calibrate_from_logits(logits, labels, mask=None) -> dict:
    """Fit T on collected logits -> ``{"temperature", "ece_before", "ece_after", "n"}``."""
    T = fit_temperature(logits, labels, mask)
    n = len(labels) if mask is None else int(np.asarray(mask).sum())
    return {
        "temperature": T,
        "ece_before": expected_calibration_error(_softmax(logits), labels, mask),
        "ece_after": expected_calibration_error(_softmax(logits / T), labels, mask),
        "n": n,
    }


def calibrate(model, dataloader) -> dict:
    """Fit T on a validation loader (one forward pass)."""
    return calibrate_from_logits(*collect_logits(model, dataloader))
