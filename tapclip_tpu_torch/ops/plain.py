"""The plain building blocks of a transformer block: LayerNorm, the dense
product, the activations and the MLP.

``models/layers.py`` composes its blocks from these, and the kernels' plain
versions (``fused_mlp_reference``, ``attn_block_reference``) repeat that
composition from them, so the plain versions that the ``tapclip`` ops run on
a CPU tensor (``ops/_library.py``) need no model code.  Parameters are
stored in float32; compute runs in the input's dtype with LayerNorm's
statistics and every product accumulated in f32, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact (erf) form


ACTS = {"gelu": gelu, "quick_gelu": quick_gelu}


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[..., In] @ [In, Out]`` with f32 accumulation, result in ``x.dtype``.

    The weight is rounded to ``x.dtype`` first and the product of the rounded
    values is taken in f32, as ``jnp.dot(..., preferred_element_type=f32)``.
    """
    y = torch.matmul(x.float(), w.to(x.dtype).float())
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def mlp_forward(x: torch.Tensor, p: Params, act: str) -> torch.Tensor:
    h = ACTS[act](dense(x, p["w_fc"], p["b_fc"]))
    return dense(h, p["w_proj"], p["b_proj"])
