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
from torch.utils.checkpoint import checkpoint

from tapclip_tpu_torch.ops.attention import IntOrTensor, multi_head_attention
from tapclip_tpu_torch.ops.fused_mha import fused_attn_block, fused_mha
from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block
from tapclip_tpu_torch.ops.int8_attn import int8_attn_block
from tapclip_tpu_torch.ops.int8_mlp import int8_mlp_block
from tapclip_tpu_torch.ops.plain import dense, layer_norm, mlp_forward

Params = Dict[str, Any]


def normal_init(generator: torch.Generator, shape, std: float, device=None) -> torch.Tensor:
    """``N(0, std^2)`` f32 values drawn on ``generator``'s device, moved to
    ``device`` (default: the generator's)."""
    t = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (t * std).to(device or generator.device)


def init_layer_norm(width: int, device=None) -> Params:
    return {"scale": torch.ones(width, device=device), "bias": torch.zeros(width, device=device)}


def init_attn(generator: torch.Generator, width: int, device=None) -> Params:
    """The attention half's weights, the JAX init's shapes and scales."""
    std = width ** -0.5
    return {
        "w_qkv": normal_init(generator, (width, 3 * width), std, device),
        "b_qkv": torch.zeros(3 * width, device=device),
        "w_out": normal_init(generator, (width, width), std, device),
        "b_out": torch.zeros(width, device=device),
    }


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
    layer_prompts: Optional[torch.Tensor] = None,
    prompt_offset: int = 1,
    prompt_mask=None,
    remat: str = "none",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the blocks in order; the attribution aux comes from the last one.

    The reference hooks the last text block's attention, so only the last
    block gets ``attn_to_idx`` (the JAX package runs it outside its scan).

    ``layer_prompts [n_layers-1, P, W]`` (MaPLe's deep prompts): row ``i``
    overwrites token slots ``prompt_offset .. prompt_offset+P`` of block
    ``i``'s output, so block ``i+1`` sees fresh prompts at its input; the
    last block's output is never overwritten.  ``prompt_mask [n_layers-1]``
    (bool; None: every row) leaves the rows it marks False inert.  The
    overwrite is out of place (a new tensor from ``torch.cat``): the kernels'
    autograd Functions save their inputs for the backward.

    ``remat`` (``CLIPConfig.remat``: "none", "dots" or "full") checkpoints
    each block under a graph (``torch.utils.checkpoint``, non-reentrant):
    the block's forward runs again in the backward, so its kernels launch
    twice.  Eager PyTorch has no policy that keeps the products' outputs, so
    "dots" recomputes the whole block, as "full" does; the gradients equal
    those without remat either way.
    """
    if remat not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat policy {remat!r}")
    kw = dict(act=act, ln_eps=ln_eps, causal=causal, kv_valid_len=kv_valid_len, impl=impl,
              quantize=quantize, quantize_deterministic=quantize_deterministic)
    active = [] if layer_prompts is None else (
        [True] * layer_prompts.shape[0] if prompt_mask is None else [bool(m) for m in prompt_mask])
    checkpointed = remat != "none" and torch.is_grad_enabled()
    last, aux = len(blocks) - 1, None
    for i, blk in enumerate(blocks):
        to_idx = attn_to_idx if i == last else None
        if checkpointed:
            x, aux = checkpoint(block_forward, x, blk, n_heads, attn_to_idx=to_idx, use_reentrant=False, **kw)
        else:
            x, aux = block_forward(x, blk, n_heads, attn_to_idx=to_idx, **kw)
        if i < last and i < len(active) and active[i]:
            P = layer_prompts.shape[1]
            rows = layer_prompts[i].to(x.dtype).expand(x.shape[0], P, x.shape[-1])
            x = torch.cat([x[:, :prompt_offset], rows, x[:, prompt_offset + P:]], dim=1)
    return x, aux
