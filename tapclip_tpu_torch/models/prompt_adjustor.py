"""Prompt adjustor: reweight context vectors by attribution scores.

Counterpart of ``tapclip_tpu/models/prompt_adjustor.py``:

* ``scale``    -- elementwise ``prompt * attribution``;
* ``gate``     -- ``Linear(1,64) -> ReLU -> Linear(64,1) -> Sigmoid`` gating;
* ``residual`` -- ``Linear(1,64) -> ReLU -> Linear(64,D)`` added to the prompt.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

ADJUSTOR_METHODS = ("scale", "gate", "residual")


def init_adjustor_params(
    generator: torch.Generator, method: str, dim: int, hidden: int = 64, device=None
) -> Dict[str, Any]:
    """Adjustor params; empty dict for the parameter-free 'scale' method.

    torch ``nn.Linear``'s default init for the weights (uniform in
    ``+-1/sqrt(fan_in)``), zero biases, as in the JAX package.
    """
    if method not in ADJUSTOR_METHODS:
        raise ValueError(f"Unknown method: {method}")
    if method == "scale":
        return {}
    out_dim = 1 if method == "gate" else dim

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)
        return ((u * 2.0 - 1.0) * bound).to(device or generator.device)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device or generator.device)

    return {
        "w1": uniform((1, hidden), 1.0),
        "b1": zeros(hidden),
        "w2": uniform((hidden, out_dim), hidden ** -0.5),
        "b2": zeros(out_dim),
    }


def adjust_prompt(
    params: Optional[Dict[str, Any]],
    method: str,
    prompt_embed: torch.Tensor,  # [..., P, D]
    attribution: torch.Tensor,  # [..., P]
) -> torch.Tensor:
    if method not in ADJUSTOR_METHODS:
        raise ValueError(f"Unknown method: {method}")
    a = attribution[..., None].to(prompt_embed.dtype)  # [..., P, 1]
    if method == "scale":
        return prompt_embed * a
    dt = a.dtype
    h = torch.relu(a @ params["w1"].to(dt) + params["b1"].to(dt))
    out = h @ params["w2"].to(dt) + params["b2"].to(dt)
    if method == "gate":
        return prompt_embed * torch.sigmoid(out)
    return prompt_embed + out
