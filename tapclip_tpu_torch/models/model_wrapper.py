"""FullModel: frozen CLIP + prompt learner + attribution + adjustor.

Counterpart of ``tapclip_tpu/models/model_wrapper.py``, in both text modes
(``ref_compat`` and the CoOp-style ``idiomatic``).  The attribution pass's
input does not depend on the image, so attribution is computed once per
class, in one batched ``[C, T, D]`` text pass, and the forward is

    1 image-tower pass  +  2 class-batched text passes

(or precomputed image features in place of the tower pass).  The
attribution pass runs without an autograd graph (the reference's hook
detaches the attention map), so a training step differentiates the encode
pass only.  Loss: cross-entropy only, as in the reference.

MaPLe (``PromptConfig.maple_depth`` J > 0) couples the towers: the vision
tower sees prompts projected from the live text prompts (layer 0 from the
class-masked mean context, layers 1..J-1 from the deep text prompts), and
the text blocks 1..J-1 see the deep text prompts in the context slots.  Its
image features depend on the trainable state, so it takes raw images only.

Image-conditioned prompts (CoCoOp, ``PromptConfig.image_conditioned``):
a meta-net maps each sample's normalized image feature to a shift of the
context tokens, so the text passes run per (sample, class), on ``B*C``
rows, and the attribution is per sample, ``[B, C, P]``.  The meta-net's
output layer starts at zero, so the conditioned model starts equal to the
unconditioned one.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from tapclip_tpu_torch.config import CLIPConfig, PromptConfig
from tapclip_tpu_torch.models import clip as clip_model
from tapclip_tpu_torch.models.attribution_monitor import attribution_scores
from tapclip_tpu_torch.models.prompt_adjustor import adjust_prompt, init_adjustor_params
from tapclip_tpu_torch.models.prompt_learner import PromptBank, PromptLearner, build_prompts

NEG_INF = -1e9


def check_prompt_supported(prompt_cfg: PromptConfig) -> None:
    if prompt_cfg.text_mode not in ("ref_compat", "idiomatic"):
        raise ValueError(f"unknown text mode {prompt_cfg.text_mode!r}")


def init_trainable(
    generator: torch.Generator, prompt_learner: PromptLearner, prompt_cfg: PromptConfig
) -> Dict[str, Any]:
    """Trainable state: context bank + adjustor MLP (if any) + logit scale;
    with ``image_conditioned`` the ``"meta_net"`` subtree (CoCoOp's
    bottleneck: ``w1 [E, h]`` of std E^-1/2, ``h = meta_hidden or max(E //
    16, 8)``, and ``b1``, ``w2 [h, D]``, ``b2`` zeros, so the conditioned
    model starts equal to the unconditioned one); with ``maple_depth`` J > 0
    the ``"maple"`` subtree: the deep text prompts ``txt [J-1, P, D]`` (std
    0.02) and the per-layer projections ``proj_w [J, D, Wv]`` (std D^-1/2),
    ``proj_b [J, Wv]`` (zeros) that make the vision prompts.  The draws come
    from ``generator`` (the JAX package draws from ``jax.random``; tests
    bridge its tree)."""
    check_prompt_supported(prompt_cfg)
    device = prompt_learner.bank.ctx.device
    out = {
        "ctx": prompt_learner.bank.ctx.clone(),
        "adjustor": init_adjustor_params(
            generator, prompt_cfg.adjustor_method, prompt_learner.clip_cfg.text_width,
            prompt_cfg.adjustor_hidden, device=device,
        ),
        "logit_scale": torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32, device=device),
    }

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device).to(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    if prompt_cfg.image_conditioned:
        E, D = prompt_learner.clip_cfg.embed_dim, prompt_learner.clip_cfg.text_width
        h = prompt_cfg.meta_hidden or max(E // 16, 8)
        out["meta_net"] = {"w1": normal(E, h) * E ** -0.5, "b1": zeros(h), "w2": zeros(h, D), "b2": zeros(D)}
    if prompt_cfg.maple_depth > 0:
        cfg = prompt_learner.clip_cfg
        J = prompt_cfg.maple_depth
        if prompt_cfg.image_conditioned:
            raise NotImplementedError(
                "maple_depth does not compose with image_conditioned (both re-route the prompt pipeline)"
            )
        if cfg.vision_tower == "resnet":
            raise NotImplementedError("maple_depth requires a ViT vision tower (vision prompts are token insertions)")
        if J > min(cfg.text_layers, cfg.vision_layers):
            raise ValueError(
                f"maple_depth={J} exceeds the tower depth (text {cfg.text_layers}, vision {cfg.vision_layers})"
            )
        D, P = cfg.text_width, prompt_cfg.prompt_len
        out["maple"] = {
            "txt": 0.02 * normal(J - 1, P, D),
            "proj_w": normal(J, D, cfg.vision_width) * D ** -0.5,
            "proj_b": zeros(J, cfg.vision_width),
        }
    return out


def meta_net_forward(p: Dict[str, Any], feats: torch.Tensor) -> torch.Tensor:
    """CoCoOp's bottleneck: ``[B, E]`` L2-normalized image features ->
    ``[B, D]`` per-sample context shift, in f32."""
    h = torch.relu(feats.float() @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def _tile_bank(bank: PromptBank, B: int) -> PromptBank:
    """Repeat the class axis per sample: ``[C, ...] -> [B*C, ...]``."""
    def rep(a):
        return a[None].expand((B,) + tuple(a.shape)).reshape((B * a.shape[0],) + tuple(a.shape[1:]))

    return PromptBank(ctx=rep(bank.ctx), token_embs=rep(bank.token_embs), class_mask=rep(bank.class_mask),
                      eot_pos=rep(bank.eot_pos))


def _idiomatic_seq(ctx: torch.Tensor, token_embs: torch.Tensor, context_length: int) -> torch.Tensor:
    """``[sot, ctx(P), template tokens 1..77-P-1]`` -> ``[C, 77, D]``."""
    P = ctx.shape[1]
    embs = token_embs.to(ctx.dtype)
    return torch.cat([embs[:, :1], ctx, embs[:, 1:context_length - P]], dim=1)


def text_features_with_attribution(
    clip_params,
    ctx: torch.Tensor,  # [C, P, D]
    bank: PromptBank,
    clip_cfg: CLIPConfig,
    prompt_cfg: PromptConfig,
    adjustor_params: Dict[str, Any],
    deep_ctx=None,
):
    """Class-batched attribution -> adjust -> encode.

    Returns ``(feats [C, embed_dim] L2-normalized, attribution [C, P] f32)``.
    ``ref_compat``: ``[ctx || 77-token embedding]`` is the 82-token sequence;
    the attribution column and the pooling position are both T-1.
    ``idiomatic``: ``[sot, ctx, template tokens]`` (77 tokens) through the
    causal tower; the attribution column and the pooling position are each
    class's EOT, shifted by P, and the context queries are rows 1..P.  Under
    the causal mask those queries cannot see their EOT key, so their column
    is exactly 0 and the attribution the softmax of zeros, 1/P, as in the
    JAX package.

    ``deep_ctx`` (MaPLe): ``(prompts [text_layers-1, P, D], mask)``, the
    deep text prompts that overwrite the context slots at the masked block
    inputs; the attribution pass sees them without a graph (as the context),
    the encode pass live.
    """
    check_prompt_supported(prompt_cfg)
    deep = {}
    if deep_ctx is not None:
        deep = dict(deep_prompts=deep_ctx[0], deep_prompt_mask=deep_ctx[1])
    P = prompt_cfg.prompt_len
    mode = prompt_cfg.text_mode
    if mode == "idiomatic":
        Tctx = clip_cfg.context_length
        build = lambda c: _idiomatic_seq(c, bank.token_embs, Tctx)  # noqa: E731
        col = torch.clamp(bank.eot_pos.long() + P, max=Tctx - 1)
        rows = slice(1, P + 1)
    else:
        build = lambda c: build_prompts(c, bank.token_embs)  # noqa: E731
        col = P + bank.token_embs.shape[1] - 1
        rows = slice(0, P)
    with torch.no_grad():  # the reference detaches the attention map
        _, aux = clip_model.text_forward_embeds(
            clip_params, clip_cfg, build(ctx.detach()), mode=mode, attn_to_idx=col, **deep
        )
        attribution = attribution_scores(aux[:, rows], P, prompt_cfg.normalize_attribution)
    adjusted = adjust_prompt(adjustor_params, prompt_cfg.adjustor_method, ctx, attribution)
    feats, _ = clip_model.text_forward_embeds(
        clip_params, clip_cfg, build(adjusted), mode=mode, pool_idx=col, **deep
    )
    return clip_model.l2_normalize(feats), attribution


def _maple_towers(clip_params, trainable, bank, images, clip_cfg: CLIPConfig, prompt_cfg: PromptConfig):
    """MaPLe's coupling: ``(image_feats, deep_ctx)``.  The layer-0 text
    prompts are the class-masked mean of ``ctx`` (every row's at template
    init); each layer's projection of its text prompts gives the vision
    prompts, inserted after the class token (layer 0) or overwriting the
    prompt slots of vision blocks 1..J-1.  Both deep stacks are padded to
    their tower's depth - 1 with rows past J-1 inactive."""
    mp = trainable["maple"]
    J = prompt_cfg.maple_depth
    m = bank.class_mask.float()
    t0 = torch.einsum("cpd,c->pd", trainable["ctx"].float(), m) / m.sum().clamp_min(1.0)
    t_all = torch.cat([t0[None], mp["txt"]], dim=0)  # [J, P, D]
    v_all = torch.einsum("jpd,jdw->jpw", t_all, mp["proj_w"]) + mp["proj_b"][:, None, :]  # [J, P, Wv]

    def deep(rows, n_layers):  # [J-1, P, X] -> ([n_layers, P, X] zero-padded, [n_layers] host mask) or None
        if J <= 1 or n_layers <= 0:
            return None, None
        pad = rows.new_zeros((n_layers - (J - 1),) + tuple(rows.shape[1:]))
        return torch.cat([rows, pad], dim=0), torch.arange(n_layers) < (J - 1)

    v_deep, v_mask = deep(v_all[1:], clip_cfg.vision_layers - 1)
    image_feats = clip_model.encode_image(clip_params, clip_cfg, images, maple_prompts=(v_all[0], v_deep, v_mask))
    t_deep, t_mask = deep(mp["txt"], clip_cfg.text_layers - 1)
    return image_feats, None if t_deep is None else (t_deep, t_mask)


def full_model_forward(
    clip_params,
    trainable: Dict[str, Any],
    bank: PromptBank,
    images: Optional[torch.Tensor],
    labels: Optional[torch.Tensor],
    *,
    clip_cfg: CLIPConfig,
    prompt_cfg: PromptConfig,
    with_loss: bool = False,
    image_feats: Optional[torch.Tensor] = None,
    batch_mask: Optional[torch.Tensor] = None,
    return_text_feats: bool = False,
) -> Dict[str, torch.Tensor]:
    """The fused forward: ``{"logits", "attribution"}`` (+ ``"loss"``,
    ``"loss_cls"``; + ``"text_feats" [C, E]``, L2-normalized, with
    ``return_text_feats``).  Padded classes get ``NEG_INF`` logits.  With
    ``image_conditioned`` the attribution is ``[B, C, P]`` and the text
    features ``[B, C, E]``.

    Either ``images [B,H,W,3]`` or precomputed ``image_feats [B,E]``
    (unnormalized) is given; the image tower is frozen, so callers may cache
    its features across epochs (not under MaPLe, whose vision prompts
    depend on the trainable state: cached features raise).  ``batch_mask
    [B]`` averages the cross-entropy over the marked rows only (padded
    batches).
    """
    check_prompt_supported(prompt_cfg)
    deep_ctx = None
    if prompt_cfg.maple_depth > 0:
        if image_feats is not None:
            raise ValueError(
                "maple_depth makes the vision tower prompt-dependent: pass raw images, not cached image_feats"
            )
        image_feats, deep_ctx = _maple_towers(clip_params, trainable, bank, images, clip_cfg, prompt_cfg)
    if image_feats is None:
        image_feats = clip_model.encode_image(clip_params, clip_cfg, images)
    img = clip_model.l2_normalize(image_feats)
    scale = torch.exp(trainable["logit_scale"]).float()
    if prompt_cfg.image_conditioned:
        # Each sample shifts the context by its meta-net output; the text
        # passes run on B*C rows.  The shift is added in f32 and rounded to
        # the context's dtype after, as in the JAX package.
        ctx = trainable["ctx"]
        B, (C, P, D) = img.shape[0], ctx.shape
        pi = meta_net_forward(trainable["meta_net"], img)  # [B, D]
        ctx_bc = (ctx[None].float() + pi[:, None, None, :]).to(ctx.dtype)
        text_feats, attribution = text_features_with_attribution(
            clip_params, ctx_bc.reshape(B * C, P, D), _tile_bank(bank, B), clip_cfg, prompt_cfg,
            trainable["adjustor"],
        )
        attribution = attribution.reshape(B, C, P)
        text_feats = text_feats.reshape(B, C, -1)
        logits = scale * torch.einsum("be,bce->bc", img.float(), text_feats.float())
    else:
        text_feats, attribution = text_features_with_attribution(
            clip_params, trainable["ctx"], bank, clip_cfg, prompt_cfg, trainable["adjustor"], deep_ctx=deep_ctx
        )
        logits = scale * (img.float() @ text_feats.float().T)
    logits = torch.where(bank.class_mask[None, :], logits, torch.full_like(logits, NEG_INF))

    out = {"logits": logits, "attribution": attribution}
    if return_text_feats:
        out["text_feats"] = text_feats
    if with_loss:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.take_along_dim(logits, labels.long()[:, None], dim=1)[:, 0]
        ce = lse - ll
        if batch_mask is not None:
            m = batch_mask.float()
            loss = (ce * m).sum() / m.sum().clamp_min(1.0)
        else:
            loss = ce.mean()
        out["loss"] = loss
        out["loss_cls"] = loss
    return out


def _on_device(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


class FullModel:
    """User-facing wrapper with the reference's object API.

    ``FullModel(images, labels) -> {"logits", "attribution", "loss", "loss_cls"}``.
    The model lives on the device of ``clip_params``.
    """

    def __init__(
        self,
        class_names: Sequence[str],
        clip_params,
        clip_cfg: CLIPConfig,
        *,
        prompt_cfg: Optional[PromptConfig] = None,
        tokenizer=None,
        generator: Optional[torch.Generator] = None,
    ):
        from tapclip_tpu_torch.data.tokenizer import get_tokenizer

        self.clip_params = clip_params
        self.clip_cfg = clip_cfg
        self.prompt_cfg = prompt_cfg or PromptConfig()
        check_prompt_supported(self.prompt_cfg)
        clip_model.check_supported(clip_cfg)
        self.tokenizer = tokenizer or get_tokenizer()
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.prompt_learner = PromptLearner(
            class_names, clip_params, clip_cfg, self.prompt_cfg, self.tokenizer,
            generator=generator,
        )
        self.trainable = init_trainable(generator, self.prompt_learner, self.prompt_cfg)

    @property
    def device(self) -> torch.device:
        return self.clip_params["logit_scale"].device

    @property
    def class_names(self):
        return self.prompt_learner.class_names

    @property
    def n_cls(self) -> int:
        return self.prompt_learner.n_cls

    def add_class_prompt(self, name: str) -> None:
        """Seen -> unseen expansion; trained rows are untouched."""
        if name in self.class_names:
            return
        idx = self.n_cls
        self.prompt_learner.add_class_prompt(name)
        bank_ctx = self.prompt_learner.bank.ctx
        ctx = self.trainable["ctx"]
        if ctx.shape[0] < bank_ctx.shape[0]:
            pad = ctx.new_zeros((bank_ctx.shape[0] - ctx.shape[0],) + tuple(ctx.shape[1:]))
            ctx = torch.cat([ctx, pad], dim=0)
        ctx[idx] = bank_ctx[idx]
        self.trainable = dict(self.trainable, ctx=ctx)

    def __call__(self, images, labels=None):
        out = full_model_forward(
            self.clip_params,
            self.trainable,
            self.prompt_learner.bank,
            _on_device(images, self.device),
            None if labels is None else _on_device(labels, self.device),
            clip_cfg=self.clip_cfg,
            prompt_cfg=self.prompt_cfg,
            with_loss=labels is not None,
        )
        out = dict(out)
        out["logits"] = out["logits"][:, : self.n_cls]
        attr = out["attribution"]  # [C, P], or [B, C, P] image-conditioned
        out["attribution"] = attr[:, : self.n_cls] if attr.dim() == 3 else attr[: self.n_cls]
        return out

    def predict(self, images):
        """Convenience inference: images -> (pred indices, class names)."""
        logits = self(images)["logits"].float().cpu().numpy()
        preds = logits.argmax(axis=-1)
        return preds, [self.class_names[i] for i in preds]
