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
