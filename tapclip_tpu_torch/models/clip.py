"""Functional CLIP: the ViT image tower and the text tower.

Counterpart of ``tapclip_tpu/models/clip.py``.  Plain functions over a
parameter dict in the JAX package's layout (see ``utils/jax_bridge.py`` for
the bridge from a JAX tree).  The patch embedding is a reshape + GEMM over
NHWC images, numerically a strided conv.

Ported: ``init_clip_params`` (ViT), ``patchify``, ``encode_image``,
``embed_tokens``, ``encode_text`` (the proper CLIP text encoder: positional
embedding, causal mask, ``ln_final``, EOT pooling), ``text_forward_embeds``
in ``ref_compat`` and ``idiomatic`` mode, and ``l2_normalize``; every
``attn_impl`` of the JAX package.  The ResNet tower, MoE, VPT, MaPLe's deep
prompts, token pruning and the int8 tower raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from tapclip_tpu_torch.config import CLIPConfig
from tapclip_tpu_torch.data.preprocess import device_normalize
from tapclip_tpu_torch.models import layers

Params = Dict[str, Any]


def _unported(cfg: CLIPConfig) -> Optional[str]:
    if cfg.vision_tower != "vit":
        return "the ResNet vision tower"
    if cfg.moe_experts:
        return "mixture-of-experts towers"
    if cfg.vpt_tokens:
        return "visual prompt tokens (VPT)"
    if cfg.quantize_tower:
        return "the int8 tower (quantize_tower)"
    if cfg.token_keep_ratio < 1.0:
        return "token pruning (token_keep_ratio < 1)"
    return None


def check_supported(cfg: CLIPConfig) -> None:
    missing = _unported(cfg)
    if missing:
        raise NotImplementedError(f"{missing} is not yet ported in tapclip_tpu_torch")


def init_clip_params(generator: torch.Generator, cfg: CLIPConfig, device=None) -> Params:
    """Random-init the parameter tree (shapes and scales of the JAX init).

    Values are drawn on ``generator``'s device and moved to ``device``
    (default: the generator's).  The numbers differ from ``jax.random``'s;
    tests bridge JAX parameters instead (``utils/jax_bridge.py``).
    """
    check_supported(cfg)
    gen_device = generator.device
    device = gen_device if device is None else torch.device(device)

    def normal(*shape, std):
        t = torch.randn(shape, generator=generator, device=gen_device, dtype=torch.float32)
        return (t * std).to(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    def ln(width):
        return {"scale": ones(width), "bias": zeros(width)}

    def blocks(n_layers, width):
        hidden = cfg.mlp_ratio * width
        return [
            {
                "ln_1": ln(width),
                "attn": {
                    "w_qkv": normal(width, 3 * width, std=width ** -0.5),
                    "b_qkv": zeros(3 * width),
                    "w_out": normal(width, width, std=width ** -0.5),
                    "b_out": zeros(width),
                },
                "ln_2": ln(width),
                "mlp": {
                    "w_fc": normal(width, hidden, std=width ** -0.5),
                    "b_fc": zeros(hidden),
                    "w_proj": normal(hidden, width, std=hidden ** -0.5),
                    "b_proj": zeros(width),
                },
            }
            for _ in range(n_layers)
        ]

    vw, tw = cfg.vision_width, cfg.text_width
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    visual = {
        "patch_embed": {"w": normal(patch_dim, vw, std=vw ** -0.5)},
        "class_embedding": normal(vw, std=vw ** -0.5),
        "positional_embedding": normal(cfg.vision_seq_len, vw, std=vw ** -0.5),
        "ln_pre": ln(vw),
        "blocks": blocks(cfg.vision_layers, vw),
        "ln_post": ln(vw),
        "proj": normal(vw, cfg.embed_dim, std=vw ** -0.5),
    }
    text = {
        "token_embedding": normal(cfg.vocab_size, tw, std=0.02),
        "positional_embedding": normal(cfg.context_length, tw, std=0.01),
        "blocks": blocks(cfg.text_layers, tw),
        "ln_final": ln(tw),
        "text_projection": normal(tw, cfg.embed_dim, std=tw ** -0.5),
    }
    logit_scale = torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32, device=device)
    return {"visual": visual, "text": text, "logit_scale": logit_scale}


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC images -> ``[B, num_patches, patch*patch*C]``, flatten order (ph, pw, c)."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def _pad_to_8(x: torch.Tensor) -> Tuple[torch.Tensor, Optional[int]]:
    """Pad the sequence axis to a multiple of 8; pad keys are masked (kv_valid)."""
    T = x.shape[1]
    Tp = (T + 7) // 8 * 8
    if Tp == T:
        return x, None
    return torch.nn.functional.pad(x, (0, 0, 0, Tp - T)), T


def encode_image(params: Params, cfg: CLIPConfig, images: torch.Tensor) -> torch.Tensor:
    """Images ``[B, H, W, 3]`` (preprocessed f32, or raw uint8) -> ``[B, embed_dim]``.

    Matches open_clip ``VisionTransformer.forward`` + projection; the caller
    L2-normalizes.  The tower runs at T padded to a multiple of 8 (197 -> 200
    at ViT-B/16) with the pad keys masked; the pooled class token is row 0.
    """
    check_supported(cfg)
    p = params["visual"]
    dtype = cfg.compute_dtype
    if images.dtype == torch.uint8:
        images = device_normalize(images)
    x = layers.dense(patchify(images.to(dtype), cfg.patch_size), p["patch_embed"]["w"])
    cls = p["class_embedding"].to(dtype).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + p["positional_embedding"].to(dtype)[None]
    x = layers.layer_norm(x, p["ln_pre"], cfg.ln_eps)
    x, kv_valid = _pad_to_8(x)
    x, _ = layers.transformer_forward(
        x, p["blocks"], cfg.vision_heads, act=cfg.act, ln_eps=cfg.ln_eps,
        kv_valid_len=kv_valid, impl=cfg.attn_impl,
    )
    x = layers.layer_norm(x, p["ln_post"], cfg.ln_eps)
    return layers.dense(x[:, 0], p["proj"])


def embed_tokens(params: Params, cfg: CLIPConfig, token_ids) -> torch.Tensor:
    """Token ids ``[B, T]`` -> embeddings ``[B, T, W]`` (frozen lookup)."""
    table = params["text"]["token_embedding"]
    return table[torch.as_tensor(token_ids, device=table.device).long()]


def encode_text(params: Params, cfg: CLIPConfig, token_ids) -> torch.Tensor:
    """Proper CLIP text encoding: ids ``[B, T]`` -> ``[B, embed_dim]``.

    Positional embedding, causal tower, ``ln_final``, and pooling at the EOT
    token (the largest id).  The tower runs at T padded to a multiple of 8
    (77 -> 80) with the pad keys masked; the pad query rows are sliced off
    before pooling.  The caller L2-normalizes.
    """
    check_supported(cfg)
    p = params["text"]
    dtype = cfg.compute_dtype
    ids = torch.as_tensor(token_ids, device=p["token_embedding"].device).long()
    x = embed_tokens(params, cfg, ids).to(dtype)
    x = x + p["positional_embedding"].to(dtype)[None]
    T = x.shape[1]
    x, kv_valid = _pad_to_8(x)
    x, _ = layers.transformer_forward(
        x, p["blocks"], cfg.text_heads, act=cfg.act, ln_eps=cfg.ln_eps, causal=True,
        kv_valid_len=kv_valid, impl=cfg.attn_impl,
    )
    x = layers.layer_norm(x[:, :T], p["ln_final"], cfg.ln_eps)
    pooled = _pool(x, ids.argmax(dim=-1))
    return layers.dense(pooled, p["text_projection"])


def _pool(x: torch.Tensor, pool_idx) -> torch.Tensor:
    """Row ``pool_idx`` (None: the last; an int; or ``[B]``) of ``x [B, T, W]``."""
    if pool_idx is None:
        return x[:, -1]
    if isinstance(pool_idx, int):
        return x[:, pool_idx]
    idx = pool_idx.to(device=x.device, dtype=torch.long).reshape(-1, 1, 1)
    return torch.take_along_dim(x, idx.expand(-1, 1, x.shape[-1]), dim=1)[:, 0]


def text_forward_embeds(
    params: Params,
    cfg: CLIPConfig,
    embeds: torch.Tensor,
    *,
    mode: str = "ref_compat",
    pool_idx=None,
    attn_to_idx=None,
    kv_valid_len: Optional[int] = None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Text transformer over raw embeddings ``[B, T, W]``.

    ``mode="ref_compat"`` reproduces the reference's bare-transformer call:
    NO positional embedding, NO causal mask, NO ln_final; pool at
    ``pool_idx`` (default T-1).  T = 82 runs padded to 88 with the pad keys
    masked, then x and the aux are sliced back to T.

    ``mode="idiomatic"`` (CoOp-style prompt tuning over well-formed
    sequences) adds the positional embedding of the first T positions, runs
    the tower causal and unpadded, and applies ``ln_final`` before pooling.

    Returns ``(features [B, embed_dim], aux [B, T] | None)``, the aux being
    the last layer's head-averaged attention of every query to key
    ``attn_to_idx``.
    """
    check_supported(cfg)
    p = params["text"]
    x = embeds.to(cfg.compute_dtype)
    T = x.shape[1]
    if mode == "idiomatic":
        pos = p["positional_embedding"]
        if T > pos.shape[0]:
            raise ValueError(f"idiomatic mode requires T<= {pos.shape[0]}, got {T}")
        x = x + pos[:T].to(x.dtype)[None]
        causal = True
    elif mode == "ref_compat":
        causal = False
        if kv_valid_len is None:
            x, kv_valid_len = _pad_to_8(x)
    else:
        raise ValueError(f"unknown text mode {mode!r}")
    x, aux = layers.transformer_forward(
        x, p["blocks"], cfg.text_heads, act=cfg.act, ln_eps=cfg.ln_eps, causal=causal,
        kv_valid_len=kv_valid_len, attn_to_idx=attn_to_idx,
        impl=impl if impl is not None else cfg.attn_impl,
    )
    x = x[:, :T]
    if aux is not None:
        aux = aux[:, :T]
    if mode == "idiomatic":
        x = layers.layer_norm(x, p["ln_final"], cfg.ln_eps)
    return layers.dense(_pool(x, pool_idx), p["text_projection"]), aux


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x / ||x||`` in the smooth ``rsqrt(sum(x^2) + eps^2)`` form."""
    x32 = x.float()
    n2 = (x32 * x32).sum(dim=dim, keepdim=True)
    return (x32 * torch.rsqrt(n2 + eps * eps)).to(x.dtype)
