"""Attribution monitor: context-token attribution from attention.

Counterpart of ``tapclip_tpu/models/attribution_monitor.py``.  The reference
slices ``attn_map[:, :prompt_len, T-1]`` (each context token's attention to
the last sequence position) and softmax-normalizes it over the prompt
dimension.  The column arrives from the attention kernel as a ``[N, T]``
aux output, so this is the slice + softmax.  The index ``T-1`` lands on a
padding slot of the 82-token sequence; the port keeps that choice.
"""

from __future__ import annotations

import torch


def attribution_scores(attn_col: torch.Tensor, prompt_len: int, normalize: bool = True) -> torch.Tensor:
    """``attn_col [N, T]`` (attention-to-last column) -> ``[N, prompt_len]`` f32."""
    raw = attn_col[:, :prompt_len].float()
    return torch.softmax(raw, dim=-1) if normalize else raw


def attribution_entropy(attribution: torch.Tensor) -> torch.Tensor:
    """Mean entropy of attribution rows (the reference's ``eval_metrics.py:76-81``)."""
    p = attribution.float() + 1e-8
    return (-(p * torch.log(p)).sum(dim=-1)).mean()


def attribution_variance(attribution: torch.Tensor, labels: torch.Tensor, n_classes=None) -> torch.Tensor:
    """Mean per-label variance of attribution rows (the reference's
    ``eval_metrics.py:84-96``): per label present, the unbiased (ddof=1)
    variance of its rows, averaged over the prompt axis, then over the
    labels present.  ``n_classes`` defaults to ``max(labels) + 1``."""
    labels = labels.long()
    if n_classes is None:
        n_classes = int(labels.max()) + 1
    one_hot = torch.nn.functional.one_hot(labels, n_classes).to(attribution.dtype)  # [N, C]
    counts = one_hot.sum(dim=0)
    safe = counts.clamp_min(1.0)
    mean = torch.einsum("nc,np->cp", one_hot, attribution) / safe[:, None]
    sq = torch.einsum("nc,np->cp", one_hot, attribution ** 2) / safe[:, None]
    var = (sq - mean ** 2) * (safe / (safe - 1.0).clamp_min(1.0))[:, None]
    present = counts > 0
    per_class = var.mean(dim=-1)
    return torch.where(present, per_class, torch.zeros_like(per_class)).sum() / present.sum().clamp_min(1)
