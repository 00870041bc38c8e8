"""Vision saliency: which image patches drove the prediction.

Counterpart of ``tapclip_tpu/utils/saliency.py``.  ViT towers: the class
token's attention over the patches, from the last layer (``"last"``) or by
attention rollout through every layer (``"rollout"``, Abnar & Zuidema 2020:
the residual-adjusted, row-stochastic head-mean maps multiplied through the
stack).  RN towers: the attention pool's mean-token query over the
``image_size // 32`` grid (:func:`resnet_saliency`; one attention, so both
methods give the same map).

This is an explain path, not a hot path.  As in the JAX package, the tower
is re-run in plain operations so that every layer's ``[B, H, T, T]``
probabilities exist: the kernels (K1, K2, B13, B14) never materialize them.
So :func:`vision_attention_forward` is plain torch on the card (float, even
for a model served with ``quantize_tower``, as the JAX package's plain
forward), and its features equal ``clip.encode_image``'s on the kernel path
(held on the card by ``chip_smoke.py`` and on the CPU against the JAX
package), so the maps describe the model that serves.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tapclip_tpu_torch.config import CLIPConfig
from tapclip_tpu_torch.models import layers as L

METHODS = ("rollout", "last")


def vision_attention_forward(params, cfg: CLIPConfig, images) -> Tuple[torch.Tensor, torch.Tensor]:
    """ViT forward that also returns every layer's attention.

    Returns ``(features [B, embed_dim], probs [n_layers, B, H, T, T] f32)``
    with ``T = 1 + n_patches`` (the padding to a multiple of 8 stripped).
    The features are ``clip.encode_image``'s, computed by the plain ops.
    """
    from tapclip_tpu_torch.data.preprocess import device_normalize
    from tapclip_tpu_torch.models.clip import check_supported, patchify

    if cfg.vision_tower == "resnet":
        raise NotImplementedError("saliency applies to ViT towers only "
                                  "(the RN-family tower has no patch-token attention)")
    check_supported(cfg)
    if cfg.moe_experts:
        raise NotImplementedError("saliency's forward re-runs the dense MLP blocks: MoE towers are not supported")
    if cfg.vpt_tokens:
        raise NotImplementedError("saliency's forward does not insert VPT tokens: its attention would not be "
                                  "the tower's")
    p = params["visual"]
    dtype = cfg.compute_dtype
    images = torch.as_tensor(images, device=params["logit_scale"].device)
    if images.dtype == torch.uint8:
        images = device_normalize(images)
    x = L.dense(patchify(images.to(dtype), cfg.patch_size), p["patch_embed"]["w"])
    cls = p["class_embedding"].to(dtype).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + p["positional_embedding"].to(dtype)[None]
    x = L.layer_norm(x, p["ln_pre"], cfg.ln_eps)

    T = x.shape[1]
    Tp = (T + 7) // 8 * 8
    if Tp != T:
        x = torch.nn.functional.pad(x, (0, 0, 0, Tp - T))
    B, H = x.shape[0], cfg.vision_heads
    Dh = x.shape[-1] // H
    key_ok = torch.arange(Tp, device=x.device) < T
    all_probs = []
    for blk in p["blocks"]:
        qkv = L.dense(L.layer_norm(x, blk["ln_1"], cfg.ln_eps), blk["attn"]["w_qkv"], blk["attn"]["b_qkv"])
        q, k, v = (t.reshape(B, Tp, H, Dh).transpose(1, 2) for t in qkv.split(x.shape[-1], dim=-1))
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (Dh ** -0.5)
        logits = torch.where(key_ok, logits, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1)
        all_probs.append(probs[:, :, :T, :T])
        out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float()).to(x.dtype)
        x = x + L.dense(out.transpose(1, 2).reshape(B, Tp, -1), blk["attn"]["w_out"], blk["attn"]["b_out"])
        x = x + L.mlp_forward(L.layer_norm(x, blk["ln_2"], cfg.ln_eps), blk["mlp"], cfg.act)
    pooled = L.layer_norm(x[:, 0], p["ln_post"], cfg.ln_eps)
    return L.dense(pooled, p["proj"]), torch.stack(all_probs)


def resnet_saliency(params, cfg: CLIPConfig, images) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RN towers' map: ``(pooled [B, E], probs [B, h*w] f32)``, the
    attention pool's output (``resnet_encode_image``'s, by the same
    functions) and its mean-token query's head-mean attention over the
    spatial keys (the mean-token key dropped)."""
    from tapclip_tpu_torch.data.preprocess import device_normalize
    from tapclip_tpu_torch.models import resnet

    images = torch.as_tensor(images, device=params["logit_scale"].device)
    if images.dtype == torch.uint8:
        images = device_normalize(images)
    x = resnet.resnet_feature_map(params, cfg, images)
    p = params["visual"]["attnpool"]
    t = resnet.pool_tokens(x, p)
    q, k, v = resnet.pool_heads(t, p, resnet.attnpool_heads(cfg))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (q.shape[-1] ** -0.5)
    probs = torch.softmax(logits, dim=-1)  # [B, H, 1, hw + 1]
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float()).to(x.dtype)
    pooled = L.dense(out.transpose(1, 2).reshape(t.shape[0], -1), p["c_proj"]["w"].T, p["c_proj"]["b"])
    return pooled, probs.mean(dim=1)[:, 0, 1:]


def attention_rollout(probs: torch.Tensor) -> torch.Tensor:
    """Rollout of ``[n_layers, B, H, T, T]`` maps -> ``[B, T, T]``.

    Head mean per layer, the half-residual adjustment ``(A + I) / 2`` (rows
    stay stochastic), then left-multiplied through the stack: row ``q`` of
    the result says where the information at ``q`` came from.
    """
    A = probs.mean(dim=2)  # [L, B, T, T]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A = 0.5 * A + 0.5 * eye
    out = eye.expand(A.shape[1:])
    for a in A:
        out = torch.einsum("bqt,btk->bqk", a, out)
    return out


def patch_saliency(params, cfg: CLIPConfig, images, method: str = "rollout") -> np.ndarray:
    """Class-token saliency over the patch grid -> ``[B, g, g]`` in [0, 1].

    ViT towers: ``method`` is ``"rollout"`` (attention rollout through
    every layer) or ``"last"`` (the head-mean class-token row of the final
    layer, the classic attention map).  RN towers: the attention pool's map
    over the ``image_size // 32`` grid, for either method.  Each map is
    min-max normalized per image.
    """
    if method not in METHODS:
        raise ValueError(f"unknown saliency method {method!r}")
    with torch.inference_mode():
        if cfg.vision_tower == "resnet":
            cls_row = resnet_saliency(params, cfg, images)[1]
        else:
            _, probs = vision_attention_forward(params, cfg, images)
            if method == "rollout":
                cls_row = attention_rollout(probs)[:, 0, 1:]  # [B, n_patches]
            else:
                cls_row = probs[-1].mean(dim=1)[:, 0, 1:]
        cls_row = cls_row.float().cpu().numpy()
    g = cfg.image_size // (32 if cfg.vision_tower == "resnet" else cfg.patch_size)
    grid = cls_row.reshape(-1, g, g)
    lo = grid.min(axis=(1, 2), keepdims=True)
    hi = grid.max(axis=(1, 2), keepdims=True)
    return (grid - lo) / np.maximum(hi - lo, 1e-12)
