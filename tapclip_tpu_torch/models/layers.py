"""Functional transformer building blocks.

Counterpart of ``tapclip_tpu/models/layers.py``: plain functions over
parameter dicts of tensors in the JAX package's layout (linear weights
``[in, out]``).  Parameters are stored in float32; compute runs in the
config's dtype, with LayerNorm and softmax statistics in f32 and every
product accumulated in f32, as in the JAX package.  A stack of blocks is a
list of per-block dicts (the JAX package stacks them along a leading axis).

Routing follows ``tapclip_tpu/models/layers.py`` as it routes on a TPU,
by ``impl``:

* ``"auto"`` / ``"fused"``: a non-causal block without the attribution aux
  runs the fused attention block (kernel K2); a causal block (the text
  tower) never does: its ``attn_forward`` runs the plain QKV projection, the
  packed-QKV attention core (B6, ``fused_mha``) and the plain
  out-projection.  The aux layer runs ``attn_forward`` around the attention
  kernel K3 (causal or not).
* ``"fused_split"``: every block runs the plain projections around B6 (K3
  for the aux layer), non-causal vision blocks included.
* ``"xla"``: the plain composition everywhere.

Every ``gelu`` MLP runs the fused MLP (K1) except under ``"xla"``.  As in the
JAX package, ``impl="fused"`` with ``attn_to_idx`` runs B6 and returns no
aux.  Each kernel wrapper launches its CUDA kernel on a CUDA tensor and its
plain version on a CPU tensor.  The QKV and out-projections stay
``torch.matmul``: the JAX package computes them outside any Pallas kernel.

``quantize`` (``CLIPConfig.quantize_tower``, the frozen tower's eval path)
routes as the JAX package does, whatever ``impl``: a non-causal block without
the attribution aux and with an int (or no) ``kv_valid_len`` runs the int8
attention half-block (B14, ``int8_attn_block``), and every ``gelu`` MLP the
int8 MLP (B13, ``int8_mlp_block``); ``quantize_deterministic``
(``int8_deterministic``) picks round-to-nearest in both.  Neither has a
gradient.

Every other kernel differentiates: ``fused_attn_block``, ``fused_mha``,
``fused_mlp_block`` and ``fused_attention`` are ``torch.autograd.Function`` s
whose backward is the hand-written B4 / B7 / B5 / flash chain on the card
(weight gradients only where a parameter requires one).  Under
``attn_impl="pallas"`` every block runs K3 between the plain projections and
the plain MLP, and differentiates through the flash chain; the attribution
pass runs under ``no_grad`` (the aux column is detached), so it saves nothing.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from tapclip_tpu_torch.ops.attention import IntOrTensor, multi_head_attention
from tapclip_tpu_torch.ops.fused_mha import fused_attn_block, fused_mha
from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block
from tapclip_tpu_torch.ops.int8_attn import int8_attn_block
from tapclip_tpu_torch.ops.int8_mlp import int8_mlp_block

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
    causal: bool = False,
    kv_valid_len: IntOrTensor = None,
    attn_to_idx: IntOrTensor = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused-QKV multi-head self attention over ``x [B, T, W]``."""
    B, T, W = x.shape
    Dh = W // n_heads
    qkv = dense(x, p["w_qkv"], p["b_qkv"])

    resolved = impl
    if impl in ("auto", "fused_split"):
        if attn_to_idx is not None:
            resolved = "pallas"  # needs the attribution aux column (K3)
        elif kv_valid_len is None or isinstance(kv_valid_len, int):
            resolved = "fused"  # the packed-QKV core (B6)
        else:
            resolved = "xla"
    if resolved == "fused":
        out = fused_mha(qkv, n_heads, valid_len=kv_valid_len, causal=causal)
        return dense(out, p["w_out"], p["b_out"]), None

    def heads(t):  # [B, T, W] -> [B, H, T, Dh]
        return t.reshape(B, T, n_heads, Dh).transpose(1, 2).contiguous()

    q, k, v = qkv.split(W, dim=-1)
    out, aux = multi_head_attention(
        heads(q), heads(k), heads(v), causal=causal,
        kv_valid_len=kv_valid_len, attn_to_idx=attn_to_idx, impl=resolved,
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
    causal: bool = False,
    kv_valid_len: Optional[int] = None,
    attn_to_idx: IntOrTensor = None,
    impl: str = "auto",
    quantize: bool = False,
    quantize_deterministic: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pre-LN residual attention block (open_clip ResidualAttentionBlock)."""
    plain_attn_block = attn_to_idx is None and not causal and (
        kv_valid_len is None or isinstance(kv_valid_len, int)
    )
    if quantize and plain_attn_block:
        x = int8_attn_block(
            x, p["ln_1"], p["attn"], n_heads, valid_len=kv_valid_len, eps=ln_eps,
            deterministic=quantize_deterministic,
        )
        aux = None
    elif impl in ("auto", "fused") and plain_attn_block:
        x = fused_attn_block(
            x, p["ln_1"], p["attn"], n_heads, valid_len=kv_valid_len, eps=ln_eps
        )
        aux = None
    else:
        h, aux = attn_forward(
            layer_norm(x, p["ln_1"], ln_eps), p["attn"], n_heads, causal=causal,
            kv_valid_len=kv_valid_len, attn_to_idx=attn_to_idx, impl=impl,
        )
        x = x + h
    if quantize and act == "gelu":
        x = int8_mlp_block(x, p["ln_2"], p["mlp"], eps=ln_eps, deterministic=quantize_deterministic)
    elif act == "gelu" and impl in ("auto", "fused", "fused_split"):
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
    causal: bool = False,
    kv_valid_len: Optional[int] = None,
    attn_to_idx: IntOrTensor = None,
    impl: str = "auto",
    quantize: bool = False,
    quantize_deterministic: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the blocks in order; the attribution aux comes from the last one.

    The reference hooks the last text block's attention, so only the last
    block gets ``attn_to_idx`` (the JAX package runs it outside its scan).
    """
    kw = dict(act=act, ln_eps=ln_eps, causal=causal, kv_valid_len=kv_valid_len, impl=impl,
              quantize=quantize, quantize_deterministic=quantize_deterministic)
    head = blocks if attn_to_idx is None else blocks[:-1]
    for blk in head:
        x, _ = block_forward(x, blk, n_heads, **kw)
    if attn_to_idx is None:
        return x, None
    return block_forward(x, blocks[-1], n_heads, attn_to_idx=attn_to_idx, **kw)
