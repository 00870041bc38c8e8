"""Functional CLIP: the ViT image tower and the text tower.

Counterpart of ``tapclip_tpu/models/clip.py``.  Plain functions over a
parameter dict in the JAX package's layout (see ``utils/jax_bridge.py`` for
the bridge from a JAX tree).  The patch embedding is a reshape + GEMM over
NHWC images, numerically a strided conv.

Ported: ``init_clip_params`` (ViT and RN), ``patchify``, ``encode_image`` (with
the int8 W8A8 tower of ``quantize_tower`` / ``int8_deterministic``, the
attention-aware token pruning of ``token_keep_ratio``, pretraining's patch
dropout and VPT's learned prompt tokens), ``embed_tokens``, ``encode_text``
(the proper CLIP text encoder: positional embedding, causal mask,
``ln_final``, EOT pooling), ``text_forward_embeds`` in ``ref_compat`` and
``idiomatic`` mode, and ``l2_normalize``; every ``attn_impl`` of the JAX
package; MaPLe's prompts in both towers (``encode_image(maple_prompts=)``,
``text_forward_embeds(deep_prompts=)``); ``CLIPConfig.remat`` in both
towers (``layers.transformer_forward``).  The text tower is never quantized,
as in the JAX package.  ``vision_tower="resnet"`` (the RN50 family) routes
the image side to ``models/resnet.py``; int8, token pruning, MaPLe, patch
dropout and VPT on it raise, as in the JAX package.

``encode_image`` / ``encode_text`` take the JAX package's parallel
arguments: ``transformer_fn`` (the GPipe runner of
``parallel/pipeline.py``, which refuses MaPLe prompts, deep VPT, token
pruning and the RN tower by JAX's messages) and ``seq_parallel`` (the
blocks sequence parallel over the ``model`` group, JAX's ``act_sharding``).

``moe_experts > 0`` gives both ViT towers mixture-of-experts blocks
(``models/moe.py``, picked by :func:`_pick_transformer_fn`); the encoders
append each tower's summed load-balance term to ``moe_loss_out``.  Under a
``model`` group the MoE blocks take the rank's heads and experts (expert
parallelism), and ``seq_parallel`` reaches them too.  As in the JAX
package, MoE refuses the RN tower, MaPLe's prompts, deep VPT, token
pruning, the int8 tower and the pipe axis.

Under a ``model`` group (a mesh step's ``tensor_parallel``) every form runs,
computing what it computes in one process: the int8 tower in B13's and
B14's partial modes (``models/layers.py``), token pruning on each rank's
heads with the class query's probabilities gathered over the group
(:func:`token_keep_indices`), and the RN-family tower replicated on every
rank (none of its leaves is cut, ``parallel/sharding.py``) beside a text
tower that runs tensor parallel.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from tapclip_tpu_torch.config import CLIPConfig
from tapclip_tpu_torch.data.preprocess import device_normalize
from tapclip_tpu_torch.models import layers, moe

Params = Dict[str, Any]


def check_supported(cfg: CLIPConfig) -> None:
    if cfg.vision_tower == "resnet":  # the JAX package's refusals
        if cfg.moe_experts > 0:
            raise NotImplementedError(
                "moe_experts applies to ViT towers only (the RN-family tower has no per-block MLP bank)")
        if cfg.vpt_tokens > 0:
            raise NotImplementedError(
                "vpt_tokens applies to ViT towers only (the RN-family tower has no token sequence to prompt)")


def _pick_transformer_fn(cfg: CLIPConfig, transformer_fn=None, seq_parallel: bool = False):
    """The block-stack runner: an explicit override (pipeline parallelism),
    the MoE blocks (``cfg.moe_experts``; expert parallel under a ``model``
    group) or the dense ones; ``seq_parallel`` is passed to either."""
    if cfg.moe_experts > 0:
        if transformer_fn is not None:
            raise NotImplementedError("pipeline parallelism over MoE towers is not supported (expert + pipeline "
                                      "sharding do not compose yet)")
        run = functools.partial(moe.moe_transformer_forward, capacity_factor=cfg.moe_capacity_factor)
    else:
        run = transformer_fn or layers.transformer_forward
    return functools.partial(run, seq_parallel=True) if seq_parallel else run


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
        return layers.normal_init(generator, shape, std, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def ln(width):
        return layers.init_layer_norm(width, device)

    def blocks(n_layers, width):
        if cfg.moe_experts > 0:
            return moe.init_moe_blocks(generator, n_layers, width, cfg.moe_experts, cfg.mlp_ratio, device)
        hidden = cfg.mlp_ratio * width
        return [
            {
                "ln_1": ln(width),
                "attn": layers.init_attn(generator, width, device),
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
    if cfg.vision_tower == "resnet":
        from tapclip_tpu_torch.models.resnet import init_resnet_params

        visual = init_resnet_params(generator, cfg, device)
    else:
        visual = {
            "patch_embed": {"w": normal(patch_dim, vw, std=vw ** -0.5)},
            "class_embedding": normal(vw, std=vw ** -0.5),
            "positional_embedding": normal(cfg.vision_seq_len, vw, std=vw ** -0.5),
            "ln_pre": ln(vw),
            "blocks": blocks(cfg.vision_layers, vw),
            "ln_post": ln(vw),
            "proj": normal(vw, cfg.embed_dim, std=vw ** -0.5),
        }
        if cfg.vpt_tokens > 0:
            visual["vpt"] = init_vpt_params(generator, cfg, device)
    text = {
        "token_embedding": normal(cfg.vocab_size, tw, std=0.02),
        "positional_embedding": normal(cfg.context_length, tw, std=0.01),
        "blocks": blocks(cfg.text_layers, tw),
        "ln_final": ln(tw),
        "text_projection": normal(tw, cfg.embed_dim, std=tw ** -0.5),
    }
    logit_scale = torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32, device=device)
    return {"visual": visual, "text": text, "logit_scale": logit_scale}


def vpt_shape(cfg: CLIPConfig) -> Tuple[int, ...]:
    """``visual.vpt``'s shape: ``[P, W]`` shallow, ``[L, P, W]`` deep."""
    if cfg.vpt_deep:
        return (cfg.vision_layers, cfg.vpt_tokens, cfg.vision_width)
    return (cfg.vpt_tokens, cfg.vision_width)


def init_vpt_params(generator: torch.Generator, cfg: CLIPConfig, device=None) -> torch.Tensor:
    """Fresh VPT prompt tokens of :func:`vpt_shape`, ``N(0, 1/W)``, drawn on
    ``generator``'s device and moved to ``device``."""
    t = torch.randn(vpt_shape(cfg), generator=generator, device=generator.device, dtype=torch.float32)
    return (t * cfg.vision_width ** -0.5).to(device or generator.device)


def ensure_vpt_params(params: Params, cfg: CLIPConfig, seed: int = 0) -> Params:
    """A tree with ``visual.vpt`` for a VPT config: a loaded tree that has
    none (an open_clip state dict, a tree saved without VPT) gets fresh
    tokens drawn from ``seed``; a tree whose tokens have another shape
    raises, rather than re-initialising trained prompts."""
    if cfg.vpt_tokens <= 0 or cfg.vision_tower == "resnet":
        return params
    visual = params.get("visual", {})
    if "vpt" in visual:
        if tuple(visual["vpt"].shape) != vpt_shape(cfg):
            raise ValueError(
                f"checkpoint carries VPT tokens of shape {tuple(visual['vpt'].shape)} but the config expects "
                f"{vpt_shape(cfg)} (vpt_tokens={cfg.vpt_tokens}, vpt_deep={cfg.vpt_deep}); load with the "
                "matching config")
        return params
    dev = params["logit_scale"].device
    vpt = init_vpt_params(torch.Generator().manual_seed(seed), cfg, dev)
    return dict(params, visual=dict(visual, vpt=vpt))


def patch_dropout_indices(generator: torch.Generator, batch: int, n_patches: int, prob: float,
                          device=None) -> Optional[torch.Tensor]:
    """The patches patch dropout keeps: ``[batch, n_keep]`` indices (0-based
    over the patches) of the top ``n_keep = max(1, round(n_patches * (1 -
    prob)))`` of uniform scores drawn from ``generator``, a uniform subset
    without replacement in score order, as ``jax.lax.top_k`` orders it.
    None when every patch is kept."""
    n_keep = max(1, int(round(n_patches * (1.0 - prob))))
    if n_keep >= n_patches:
        return None
    scores = torch.rand((batch, n_patches), generator=generator, device=generator.device, dtype=torch.float32)
    return torch.topk(scores, n_keep, dim=-1).indices.to(device or generator.device)


def _patch_dropout(x: torch.Tensor, idx: Optional[torch.Tensor]) -> torch.Tensor:
    """FLIP-style patch masking of ``x [B, 1 + n_patches, W]`` (after the
    positional embedding): the class token stays at slot 0, then the patches
    ``idx`` names, in its order.  The gather's backward is a scatter-add."""
    if idx is None:
        return x
    idx = idx.to(device=x.device, dtype=torch.long)
    full = torch.cat([torch.zeros_like(idx[:, :1]), idx + 1], dim=1)
    return torch.take_along_dim(x, full[:, :, None], dim=1)


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


def encode_image(params: Params, cfg: CLIPConfig, images: torch.Tensor, maple_prompts=None, *,
                 generator: Optional[torch.Generator] = None,
                 patch_idx: Optional[torch.Tensor] = None, moe_loss_out: Optional[list] = None,
                 transformer_fn=None, seq_parallel: bool = False) -> torch.Tensor:
    """Images ``[B, H, W, 3]`` (preprocessed f32, or raw uint8) -> ``[B, embed_dim]``.

    Matches open_clip ``VisionTransformer.forward`` + projection; the caller
    L2-normalizes.  The tower runs at T padded to a multiple of 8 (197 -> 200
    at ViT-B/16) with the pad keys masked; the pooled class token is row 0.

    ``maple_prompts = (first [P, W], deep [L-1, P, W] | None, mask | None)``:
    ``first`` is inserted after the class token (after the positional
    embedding, so the prompts carry no position), ``deep`` overwrites those
    slots at the masked block inputs (``layers.transformer_forward``); the
    tower then runs at 197 + P padded to a multiple of 8 with 197 + P valid
    keys.  Refused with VPT and with token pruning, as in the JAX package.

    Training only: with ``cfg.patch_dropout > 0`` and a ``generator`` (or
    the kept indices ``patch_idx`` of :func:`patch_dropout_indices`, drawn
    elsewhere), the patches not kept are dropped after the positional
    embedding (:func:`_patch_dropout`); eval and serving pass neither, so
    they never draw.  With ``cfg.vpt_tokens``, ``visual.vpt`` is inserted
    after the class token, after patch dropout (the prompts are never
    dropped); deep VPT's rows 1.. overwrite those slots at each later block
    input, as MaPLe's deep prompts do.

    MoE towers (``cfg.moe_experts``): the tower's summed load-balance term
    is appended to the list ``moe_loss_out`` when one is given.

    ``transformer_fn`` overrides the block-stack runner (pipeline
    parallelism: ``parallel/pipeline.py::make_pipeline_transformer_fn``);
    ``seq_parallel`` runs the blocks sequence parallel over the ``model``
    group (``layers.transformer_forward``).
    """
    dropout = cfg.patch_dropout > 0 and (generator is not None or patch_idx is not None)
    if cfg.vision_tower == "resnet":
        if transformer_fn is not None:
            raise NotImplementedError("pipeline parallelism applies to transformer towers only (the RN-family "
                                      "tower has no stacked block axis to stage)")
        # As the JAX package: a quantization, pruning or prompt flag on the
        # convolutional tower fails loudly rather than being a silent no-op.
        if dropout:
            raise NotImplementedError(
                "patch_dropout applies to ViT towers only (the RN-family tower has no patch-token sequence)"
            )
        if maple_prompts is not None:
            raise NotImplementedError(
                "MaPLe vision prompts apply to ViT towers only (the RN-family tower has no token sequence)"
            )
        if cfg.quantize_tower:
            raise NotImplementedError(
                "quantize_tower is implemented for ViT towers only "
                "(the RN-family tower is convolutional)"
            )
        if cfg.token_keep_ratio < 1.0:
            raise NotImplementedError(
                "token_keep_ratio applies to ViT towers only "
                "(the RN-family tower has no token sequence to prune)"
            )
        check_supported(cfg)
        from tapclip_tpu_torch.models.resnet import resnet_encode_image

        if images.dtype == torch.uint8:
            images = device_normalize(images)
        return resnet_encode_image(params, cfg, images)
    check_supported(cfg)
    p = params["visual"]
    dtype = cfg.compute_dtype
    if images.dtype == torch.uint8:
        images = device_normalize(images)
    x = layers.dense(patchify(images.to(dtype), cfg.patch_size), p["patch_embed"]["w"])
    cls = p["class_embedding"].to(dtype).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + p["positional_embedding"].to(dtype)[None]
    if dropout:
        if cfg.token_keep_ratio < 1.0:
            raise NotImplementedError(
                "patch_dropout (training) and token_keep_ratio (eval pruning) do not compose — pick one per call"
            )
        if patch_idx is None:
            patch_idx = patch_dropout_indices(generator, x.shape[0], x.shape[1] - 1, cfg.patch_dropout, x.device)
        x = _patch_dropout(x, patch_idx)
    deep = {}
    if maple_prompts is not None:
        if cfg.vpt_tokens > 0:
            raise NotImplementedError(
                "maple prompts and vpt_tokens both claim the prompt slots — pick one prompt source per model"
            )
        if cfg.token_keep_ratio < 1.0:
            raise NotImplementedError(
                "maple prompts do not compose with token_keep_ratio (pruning would silently drop the coupled "
                "prompts)"
            )
        if transformer_fn is not None or cfg.moe_experts > 0:
            raise NotImplementedError(
                "maple prompts require the sequential block scan (no pipeline/MoE transformer_fn override)")
        first, layer_prompts, prompt_mask = maple_prompts
        x = torch.cat([x[:, :1], first.to(dtype).expand(x.shape[0], *first.shape), x[:, 1:]], dim=1)
        if layer_prompts is not None:
            deep = dict(layer_prompts=layer_prompts.to(dtype), prompt_mask=prompt_mask)
    elif cfg.vpt_tokens > 0:
        if cfg.token_keep_ratio < 1.0:
            raise NotImplementedError(
                "vpt_tokens does not compose with token_keep_ratio (pruning would silently drop the learned "
                "prompts)"
            )
        vpt = p["vpt"].to(dtype)
        first = vpt[0] if cfg.vpt_deep else vpt
        x = torch.cat([x[:, :1], first.expand(x.shape[0], *first.shape), x[:, 1:]], dim=1)
        if cfg.vpt_deep:
            if transformer_fn is not None or cfg.moe_experts > 0:
                raise NotImplementedError(
                    "vpt_deep requires the sequential block scan (no pipeline/MoE transformer_fn override)")
            deep = dict(layer_prompts=vpt[1:])
    x = layers.layer_norm(x, p["ln_pre"], cfg.ln_eps)
    x, kv_valid = _pad_to_8(x)
    if cfg.token_keep_ratio < 1.0 and cfg.token_prune_layer < cfg.vision_layers:
        if transformer_fn is not None or cfg.moe_experts > 0:
            raise NotImplementedError(
                "token pruning is not supported with a transformer_fn override or MoE towers (it targets the "
                "dense eval path)")
        x = _forward_with_token_pruning(p, cfg, x, kv_valid)
    else:
        x, tower_aux = _pick_transformer_fn(cfg, transformer_fn, seq_parallel)(
            x, p["blocks"], cfg.vision_heads, kv_valid_len=kv_valid, remat=cfg.remat, **_tower_kw(cfg), **deep,
        )
        if cfg.moe_experts > 0 and moe_loss_out is not None:
            moe_loss_out.append(tower_aux)
    x = layers.layer_norm(x, p["ln_post"], cfg.ln_eps)
    return layers.dense(x[:, 0], p["proj"])


def _tower_kw(cfg: CLIPConfig) -> Dict[str, Any]:
    """The vision blocks' options: activation, LayerNorm eps, attention route
    and the int8 tower's flags."""
    return dict(act=cfg.act, ln_eps=cfg.ln_eps, impl=cfg.attn_impl,
                quantize=cfg.quantize_tower, quantize_deterministic=cfg.int8_deterministic)


def token_keep_indices(blk: Params, cfg: CLIPConfig, x: torch.Tensor, kv_valid) -> torch.Tensor:
    """``[B, n_keep]`` indices of the tokens to keep: the class token first,
    then the patches in order of :func:`token_keep_scores`."""
    scores, n_keep = token_keep_scores(blk, cfg, x, kv_valid)
    scores[:, 0] = torch.inf  # the class token is always kept, first
    return torch.topk(scores, n_keep, dim=-1).indices


def token_keep_scores(blk: Params, cfg: CLIPConfig, x: torch.Tensor, kv_valid) -> Tuple[torch.Tensor, int]:
    """``([B, T] f32, n_keep)``: each token's score, the class query's
    head-averaged attention under block ``blk``'s q/k weights (pads 0), and
    how many tokens pruning keeps.

    Under a ``model`` group (``parallel.collectives.tensor_parallel``)
    ``blk`` is a rank's cut: its ``w_qkv`` columns are its heads' q, k and
    v.  Each rank computes the class query's softmax on its heads, the
    ``[B, H/tp, T]`` rows are all-gathered in head order, and the mean runs
    over all H heads as in one process, so every rank keeps the same tokens."""
    from tapclip_tpu_torch.parallel import collectives

    group = collectives.current_model_group()
    y = layers.layer_norm(x, blk["ln_1"], cfg.ln_eps)
    B, T, _ = y.shape
    w_qkv, b_qkv = blk["attn"]["w_qkv"], blk["attn"]["b_qkv"]
    W = w_qkv.shape[-1] // 3  # the heads' width: the tower's, or a rank's
    H = cfg.vision_heads // collectives.size(group)
    Dh = W // H
    dt = y.dtype

    def proj(rows, lo):  # rows @ w[:, lo:lo+W] + b[lo:lo+W] in the compute dtype
        return rows @ w_qkv[:, lo:lo + W].to(dt) + b_qkv[lo:lo + W].to(dt)

    q_cls = proj(y[:, :1], 0).reshape(B, 1, H, Dh)
    keys = proj(y, W).reshape(B, T, H, Dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q_cls, keys).float()[:, :, 0] * (Dh ** -0.5)  # [B, H, T]
    if kv_valid is not None:
        ki = torch.arange(T, device=x.device)[None, None, :]
        logits = torch.where(ki < kv_valid, logits, torch.full_like(logits, -torch.inf))
    probs = torch.softmax(logits, dim=-1)
    if group is not None:
        probs = collectives.gather_dim(probs, group, 1)  # [B, H, T], the heads in order
    n_keep = max(8, int(T * cfg.token_keep_ratio) // 8 * 8)  # a multiple of 8
    if kv_valid is not None:
        # Never keep more tokens than exist: past this point kv_valid is
        # dropped, so a kept pad row would become an attendable key.
        n_keep = min(n_keep, max(kv_valid // 8 * 8, 8))
    return probs.mean(dim=1), n_keep  # [B, T]


def _forward_with_token_pruning(p: Params, cfg: CLIPConfig, x: torch.Tensor, kv_valid):
    """Attention-aware token filtering (EViT/ATS-style), as the JAX package's:
    ``token_prune_layer`` blocks at the padded T with the pad keys masked,
    then the tokens of :func:`token_keep_indices` under the next block's
    weights, then the remaining blocks on them without a mask."""
    k = cfg.token_prune_layer
    front, back = p["blocks"][:k], p["blocks"][k:]
    x, _ = layers.transformer_forward(x, front, cfg.vision_heads, kv_valid_len=kv_valid, **_tower_kw(cfg))
    idx = token_keep_indices(back[0], cfg, x, kv_valid)
    x = torch.take_along_dim(x, idx[:, :, None], dim=1)
    x, _ = layers.transformer_forward(x, back, cfg.vision_heads, **_tower_kw(cfg))
    return x


def embed_tokens(params: Params, cfg: CLIPConfig, token_ids) -> torch.Tensor:
    """Token ids ``[B, T]`` -> embeddings ``[B, T, W]`` (frozen lookup)."""
    table = params["text"]["token_embedding"]
    return table[torch.as_tensor(token_ids, device=table.device).long()]


def encode_text(params: Params, cfg: CLIPConfig, token_ids, *, moe_loss_out: Optional[list] = None,
                transformer_fn=None, seq_parallel: bool = False) -> torch.Tensor:
    """Proper CLIP text encoding: ids ``[B, T]`` -> ``[B, embed_dim]``.

    Positional embedding, causal tower, ``ln_final``, and pooling at the EOT
    token (the largest id).  The tower runs at T padded to a multiple of 8
    (77 -> 80) with the pad keys masked; the pad query rows are sliced off
    before pooling.  The caller L2-normalizes.  ``moe_loss_out``,
    ``transformer_fn`` and ``seq_parallel``: as :func:`encode_image`'s.
    """
    check_supported(cfg)
    p = params["text"]
    dtype = cfg.compute_dtype
    ids = torch.as_tensor(token_ids, device=p["token_embedding"].device).long()
    x = embed_tokens(params, cfg, ids).to(dtype)
    x = x + p["positional_embedding"].to(dtype)[None]
    T = x.shape[1]
    x, kv_valid = _pad_to_8(x)
    x, tower_aux = _pick_transformer_fn(cfg, transformer_fn, seq_parallel)(
        x, p["blocks"], cfg.text_heads, act=cfg.act, ln_eps=cfg.ln_eps, causal=True,
        kv_valid_len=kv_valid, impl=cfg.attn_impl, remat=cfg.remat,
    )
    if cfg.moe_experts > 0 and moe_loss_out is not None:
        moe_loss_out.append(tower_aux)
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
    return torch.gather(x, 1, idx.expand(-1, 1, x.shape[-1]))[:, 0]  # take_along_dim pins a symbolic batch


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
    deep_prompts: Optional[torch.Tensor] = None,
    deep_prompt_mask=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Text transformer over raw embeddings ``[B, T, W]``.

    ``mode="ref_compat"`` reproduces the reference's bare-transformer call:
    NO positional embedding, NO causal mask, NO ln_final; pool at
    ``pool_idx`` (default T-1).  T = 82 runs padded to 88 with the pad keys
    masked, then x and the aux are sliced back to T.

    ``mode="idiomatic"`` (CoOp-style prompt tuning over well-formed
    sequences) adds the positional embedding of the first T positions, runs
    the tower causal and unpadded, and applies ``ln_final`` before pooling.

    ``deep_prompts [text_layers-1, P, W]`` (MaPLe): row ``i`` overwrites the
    context slots at block ``i+1``'s input, slots from position 0 in
    ``ref_compat`` (``[ctx || tokens]``) and from 1 in ``idiomatic``
    (``[sot, ctx, ...]``); ``deep_prompt_mask`` limits the depth.

    Returns ``(features [B, embed_dim], aux [B, T] | None)``, the aux being
    the last layer's head-averaged attention of every query to key
    ``attn_to_idx`` (None without ``attn_to_idx``, MoE towers included).
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
    deep = {}
    if deep_prompts is not None:
        if cfg.moe_experts > 0:
            raise NotImplementedError(
                "deep text prompts (MaPLe) require the dense block scan (no MoE transformer)")
        deep = dict(layer_prompts=deep_prompts.to(x.dtype), prompt_offset=0 if mode == "ref_compat" else 1,
                    prompt_mask=deep_prompt_mask)
    x, aux = _pick_transformer_fn(cfg)(
        x, p["blocks"], cfg.text_heads, act=cfg.act, ln_eps=cfg.ln_eps, causal=causal,
        kv_valid_len=kv_valid_len, attn_to_idx=attn_to_idx,
        impl=impl if impl is not None else cfg.attn_impl, **deep,
    )
    if cfg.moe_experts > 0 and attn_to_idx is None:
        aux = None  # the second output is the load-balance term, not an attribution aux
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
