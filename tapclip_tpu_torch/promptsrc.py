"""PromptSRC-style self-regulated prompt tuning (Khattak et al., ICCV 2023).

Counterpart of ``tapclip_tpu/promptsrc.py``.  Composes the three
self-regularization mechanisms over the anchored train step:

1. feature-level agreement, ``TrainConfig.kg_lambda``: the cosine pull of the
   tuned class embeddings toward the frozen zero-shot anchor (KgCoOp);
2. logit-level agreement, ``TrainConfig.scl_lambda``: ``KL(zero-shot ||
   tuned)`` at the frozen init-time temperature;
3. Gaussian prompt aggregation (GPA): the returned trainable is the
   ``N(epoch; mu, sigma)``-weighted average of the per-epoch snapshots of
   every trained leaf;
4. textual diversity, ``TrainConfig.anchor_templates``: the anchor behind
   (1) and (2) averaged over templates (``trainer._multi_template_anchor``).

Every epoch runs through ``fit_prompt_model``; GPA rides its
``checkpoint_cb``, so this module adds no training loop of its own.  With
image-conditioned (CoCoOp) prompts the GPA averages the meta-net beside
``ctx``: a GPA context paired with a best-epoch meta-net would be two
points of different trajectories.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from tapclip_tpu_torch.config import TrainConfig
from tapclip_tpu_torch.trainer import FitResult, evaluate_cached, fit_prompt_model

log = logging.getLogger("tapclip_tpu_torch")


@dataclasses.dataclass
class PromptSRCResult:
    fit: FitResult
    gpa_trainable: Dict[str, Any]  # best_trainable with the aggregated leaves
    gpa_acc: float  # val accuracy of the aggregated prompt
    best_is_gpa: bool  # did aggregation beat the early-stopped best?


def gaussian_weights(n: int, *, mu: Optional[float] = None, sigma: Optional[float] = None) -> np.ndarray:
    """Normalized N(epoch; mu, sigma) weights over epochs 1..n (float64);
    ``mu = 0.6 n`` and ``sigma = n / 3`` unless given."""
    e = np.arange(1, n + 1, dtype=np.float64)
    mu = 0.6 * n if mu is None else mu
    sigma = max(n / 3.0, 1e-6) if sigma is None else max(sigma, 1e-6)
    w = np.exp(-0.5 * ((e - mu) / sigma) ** 2)
    return w / w.sum()


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def fit_promptsrc(
    model,
    train_loader,
    val_loader,
    train_cfg: TrainConfig,
    *,
    gpa_mu: Optional[float] = None,
    gpa_sigma: Optional[float] = None,
    verbose: bool = True,
    **fit_kwargs,
) -> PromptSRCResult:
    """Run the PromptSRC recipe; returns the GPA-aggregated prompt.

    ``train_cfg`` supplies the regularizer weights (``kg_lambda``,
    ``scl_lambda``).  The fit's early-stopped best and the aggregated prompt
    are both evaluated on the fit's validation features; ``model.trainable``
    is left at whichever wins (``best_is_gpa``).
    """
    if "checkpoint_cb" in fit_kwargs or "checkpoint_every" in fit_kwargs:
        raise ValueError(
            "fit_promptsrc drives checkpoint_cb itself (GPA snapshots); wrap fit_prompt_model directly for "
            "custom snapshotting"
        )
    if val_loader is None:
        raise ValueError(
            "fit_promptsrc needs a validation set: the GPA-vs-best winner is selected on validation accuracy "
            "(use fit_prompt_model directly for unvalidated training)"
        )
    # the leaves the fit optimizes: ctx, and the meta-net when image-conditioned
    keys = fit_kwargs.get("trainable_keys")
    if keys is None:
        keys = ("ctx", "meta_net") if model.prompt_cfg.image_conditioned else ("ctx",)
    keys = tuple(keys)
    snaps = []

    def _collect(epoch, state, _acc):
        snaps.append(_map(lambda t: t.detach().float().cpu().numpy().copy(), {k: state.params[k] for k in keys}))

    fit = fit_prompt_model(model, train_loader, val_loader, train_cfg, checkpoint_cb=_collect,
                           checkpoint_every=1, verbose=verbose, **fit_kwargs)
    if not snaps:  # zero epochs: nothing to aggregate
        return PromptSRCResult(fit, dict(fit.best_trainable), fit.best_acc, False)

    w = gaussian_weights(len(snaps), mu=gpa_mu, sigma=gpa_sigma)
    gpa_diff = _map(lambda *leaves: np.tensordot(w, np.stack(leaves), axes=1), *snaps)
    gpa_trainable = dict(fit.best_trainable)
    for k in keys:
        gpa_trainable[k] = _map(lambda agg, ref: torch.as_tensor(agg, dtype=ref.dtype, device=ref.device),
                                gpa_diff[k], fit.best_trainable[k])

    model.trainable = gpa_trainable
    try:
        gpa_acc, _ = evaluate_cached(model, fit.val_cache)
    except BaseException:
        model.trainable = dict(fit.best_trainable)
        raise
    best_is_gpa = gpa_acc >= fit.best_acc
    if not best_is_gpa:
        model.trainable = dict(fit.best_trainable)
    if verbose:
        log.info("PromptSRC GPA over %d epochs: %.2f%% vs best %.2f%% -> %s", len(snaps), gpa_acc, fit.best_acc,
                 "GPA" if best_is_gpa else "early-stopped best")
    return PromptSRCResult(fit, gpa_trainable, gpa_acc, best_is_gpa)
