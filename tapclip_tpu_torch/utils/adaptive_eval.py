"""Input-aware two-path evaluation (PIVOT-style).

Counterpart of ``adaptive_logits`` in ``tapclip_tpu/utils/adaptive_eval.py``:

1. every batch runs the CHEAP path (the token-pruned tower, optionally int8);
2. samples whose top-1/top-2 logit margin falls below ``margin`` are "hard":
   they are gathered into rescue batches of a fixed size (padded by
   repeating the first hard sample, as the JAX package pads to one compiled
   shape) and re-scored by the FULL tower;
3. hard samples take the full path's logits, easy ones keep the cheap ones.

At ``margin = inf`` every sample is rescued and the result is the full
path's; at ``-inf`` it is the cheap path's.  ``evaluate_adaptive`` is the
loop over a loader (``data/imagefolder.Loader``) with decode-ahead.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _logits(model, clip_cfg, images) -> np.ndarray:
    from tapclip_tpu_torch.models.model_wrapper import full_model_forward

    with torch.inference_mode():
        out = full_model_forward(
            model.clip_params, model.trainable, model.prompt_learner.bank, images, None,
            clip_cfg=clip_cfg, prompt_cfg=model.prompt_cfg, with_loss=False,
        )
        return out["logits"].float().cpu().numpy()


def _margins(logits: np.ndarray) -> np.ndarray:
    top2 = np.partition(logits, -2, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def adaptive_logits(
    model,
    images,
    *,
    margin: float,
    cheap_cfg=None,
    rescue_batch: Optional[int] = None,
    mask=None,
) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Two-path logits for one batch: ``(logits [B, C_max], stats)``.

    ``cheap_cfg`` defaults to the model's config with ``token_keep_ratio=0.5``
    (pass one with ``quantize_tower=True`` for the int8 cheap path).
    ``rescue_batch`` defaults to the batch size.  ``mask`` (bool ``[B]``)
    marks the valid rows: padding rows are never hard, so ``rescue_frac`` is
    a fraction of the valid samples.
    """
    full_cfg = model.clip_cfg
    if cheap_cfg is None:
        cheap_cfg = full_cfg.replace(token_keep_ratio=0.5)
    images = torch.as_tensor(np.asarray(images), device=model.device)
    B = images.shape[0]
    rescue_batch = rescue_batch or B
    logits = _logits(model, cheap_cfg, images)

    is_hard = _margins(logits) < margin
    if mask is not None:
        is_hard &= np.asarray(mask, bool)
    hard = np.nonzero(is_hard)[0]
    for start in range(0, len(hard), rescue_batch):
        idx = hard[start:start + rescue_batch]
        pad = rescue_batch - len(idx)
        sel = np.concatenate([idx, np.full(pad, idx[0])]) if pad else idx
        out = _logits(model, full_cfg, images[torch.as_tensor(sel, device=images.device)])
        logits[idx] = out[:len(idx)]
    n_valid = int(np.asarray(mask, bool).sum()) if mask is not None else B
    stats = {"n": n_valid, "n_rescued": int(len(hard)),
             "rescue_frac": round(len(hard) / max(n_valid, 1), 4)}
    return logits, stats


def evaluate_adaptive(model, dataloader, *, margin: float, cheap_cfg=None) -> Tuple[float, Dict[str, Any]]:
    """Accuracy (%) over a loader of ``(images, labels, mask)`` batches with
    the two-path scheme, and ``{"total", "rescued", "rescue_frac"}``."""
    from tapclip_tpu_torch.data.prefetch import background_iter

    correct = total = rescued = 0
    for images, labels, mask in background_iter(dataloader):
        logits, st = adaptive_logits(model, images, margin=margin, cheap_cfg=cheap_cfg, mask=mask)
        preds = logits[:, : model.n_cls].argmax(-1)
        keep = np.asarray(mask, bool)
        correct += int(((preds == np.asarray(labels)) & keep).sum())
        total += int(keep.sum())
        rescued += st["n_rescued"]
    acc = 100.0 * correct / max(total, 1)
    return acc, {"total": total, "rescued": rescued, "rescue_frac": round(rescued / max(total, 1), 4)}
