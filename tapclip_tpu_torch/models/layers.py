"""Functional transformer building blocks.

Counterpart of ``tapclip_tpu/models/layers.py``: plain functions over
parameter dicts of tensors in the JAX package's layout (linear weights
``[in, out]``).  Parameters are stored in float32; compute runs in the
config's dtype, with LayerNorm and softmax statistics in f32 and every
product accumulated in f32, as in the JAX package.  A stack of blocks is a
list of per-block dicts (the JAX package stacks them along a leading axis).

Routing follows ``tapclip_tpu/models/layers.py::block_forward``: with
``impl`` ``"auto"``, a block without the attribution aux runs the fused
attention block (kernel K2) and every ``gelu`` MLP the fused MLP (K1); the
aux layer runs ``attn_forward`` with plain QKV and out-projections around
the attention kernel K3.  Each kernel wrapper launches its CUDA kernel on a
CUDA tensor and its plain version on a CPU tensor.  ``impl="xla"`` runs
the plain composition on any device.

The fused blocks differentiate: ``fused_attn_block`` and ``fused_mlp_block``
are ``torch.autograd.Function`` s whose backward is the hand-written B4 / B5
on the card (weight gradients only where a parameter requires one).  K3 has
no ported backward and refuses a graph; the attribution pass that runs it is
detached.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from tapclip_tpu_torch.ops.attention import IntOrTensor, multi_head_attention
from tapclip_tpu_torch.ops.fused_mha import fused_attn_block
from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block

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


_ACTS = {"gelu": gelu, "quick_gelu": quick_gelu}


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
    h = _ACTS[act](dense(x, p["w_fc"], p["b_fc"]))
    return dense(h, p["w_proj"], p["b_proj"])


def attn_forward(
    x: torch.Tensor,
    p: Params,
    n_heads: int,
    *,
    kv_valid_len: IntOrTensor = None,
    attn_to_idx: IntOrTensor = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused-QKV multi-head self attention over ``x [B, T, W]``."""
    B, T, W = x.shape
    Dh = W // n_heads
    qkv = dense(x, p["w_qkv"], p["b_qkv"])

    def heads(t):  # [B, T, W] -> [B, H, T, Dh]
        return t.reshape(B, T, n_heads, Dh).transpose(1, 2).contiguous()

    q, k, v = qkv.split(W, dim=-1)
    out, aux = multi_head_attention(
        heads(q), heads(k), heads(v),
        kv_valid_len=kv_valid_len, attn_to_idx=attn_to_idx, impl=impl,
    )
    out = out.transpose(1, 2).reshape(B, T, W)
    return dense(out, p["w_out"], p["b_out"]), aux


def block_forward(
    x: torch.Tensor,
    p: Params,
    n_heads: int,
    *,
    act: str,
    ln_eps: float = 1e-5,
    kv_valid_len: Optional[int] = None,
    attn_to_idx: IntOrTensor = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pre-LN residual attention block (open_clip ResidualAttentionBlock)."""
    if impl == "auto" and attn_to_idx is None:
        x = fused_attn_block(
            x, p["ln_1"], p["attn"], n_heads, valid_len=kv_valid_len, eps=ln_eps
        )
        aux = None
    else:
        h, aux = attn_forward(
            layer_norm(x, p["ln_1"], ln_eps), p["attn"], n_heads,
            kv_valid_len=kv_valid_len, attn_to_idx=attn_to_idx, impl=impl,
        )
        x = x + h
    if act == "gelu" and impl == "auto":
        x = fused_mlp_block(x, p["ln_2"], p["mlp"], eps=ln_eps)
    else:
        x = x + mlp_forward(layer_norm(x, p["ln_2"], ln_eps), p["mlp"], act)
    return x, aux


def transformer_forward(
    x: torch.Tensor,
    blocks: List[Params],
    n_heads: int,
    *,
    act: str,
    ln_eps: float = 1e-5,
    kv_valid_len: Optional[int] = None,
    attn_to_idx: IntOrTensor = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the blocks in order; the attribution aux comes from the last one.

    The reference hooks the last text block's attention, so only the last
    block gets ``attn_to_idx`` (the JAX package runs it outside its scan).
    """
    kw = dict(act=act, ln_eps=ln_eps, kv_valid_len=kv_valid_len, impl=impl)
    head = blocks if attn_to_idx is None else blocks[:-1]
    for blk in head:
        x, _ = block_forward(x, blk, n_heads, **kw)
    if attn_to_idx is None:
        return x, None
    return block_forward(x, blocks[-1], n_heads, attn_to_idx=attn_to_idx, **kw)
