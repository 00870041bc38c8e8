"""FullModel: frozen CLIP + prompt learner + attribution + adjustor.

Counterpart of ``tapclip_tpu/models/model_wrapper.py`` (``ref_compat`` text
mode).  The attribution pass's input does not depend on the image, so
attribution is computed once per class, in one batched ``[C, T, D]`` text
pass, and the forward is

    1 image-tower pass  +  2 class-batched text passes

(or precomputed image features in place of the tower pass).  The
attribution pass runs without an autograd graph (the reference's hook
detaches the attention map), so a training step differentiates the encode
pass only.  Loss: cross-entropy only, as in the reference.  The
image-conditioned (CoCoOp) and MaPLe branches are not yet ported and raise.
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
    if prompt_cfg.image_conditioned:
        raise NotImplementedError("image_conditioned prompts are not yet ported in tapclip_tpu_torch")
    if prompt_cfg.maple_depth > 0:
        raise NotImplementedError("MaPLe prompts are not yet ported in tapclip_tpu_torch")
    if prompt_cfg.text_mode != "ref_compat":
        raise NotImplementedError(
            f"text_mode {prompt_cfg.text_mode!r} is not yet ported in tapclip_tpu_torch"
        )


def init_trainable(
    generator: torch.Generator, prompt_learner: PromptLearner, prompt_cfg: PromptConfig
) -> Dict[str, Any]:
    """Trainable state: context bank + adjustor MLP (if any) + logit scale."""
    check_prompt_supported(prompt_cfg)
    device = prompt_learner.bank.ctx.device
    return {
        "ctx": prompt_learner.bank.ctx.clone(),
        "adjustor": init_adjustor_params(
            generator, prompt_cfg.adjustor_method, prompt_learner.clip_cfg.text_width,
            prompt_cfg.adjustor_hidden, device=device,
        ),
        "logit_scale": torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32, device=device),
    }


def text_features_with_attribution(
    clip_params,
    ctx: torch.Tensor,  # [C, P, D]
    bank: PromptBank,
    clip_cfg: CLIPConfig,
    prompt_cfg: PromptConfig,
    adjustor_params: Dict[str, Any],
):
    """Class-batched attribution -> adjust -> encode.

    Returns ``(feats [C, embed_dim] L2-normalized, attribution [C, P] f32)``.
    ``[ctx || 77-token embedding]`` is the 82-token sequence; the attribution
    column and the pooling position are both T-1.
    """
    check_prompt_supported(prompt_cfg)
    P = prompt_cfg.prompt_len
    seq = build_prompts(ctx.detach(), bank.token_embs)
    T = seq.shape[1]
    with torch.no_grad():  # the reference detaches the attention map
        _, aux = clip_model.text_forward_embeds(
            clip_params, clip_cfg, seq, mode="ref_compat", attn_to_idx=T - 1
        )
        attribution = attribution_scores(aux, P, prompt_cfg.normalize_attribution)
    adjusted = adjust_prompt(adjustor_params, prompt_cfg.adjustor_method, ctx, attribution)
    feats, _ = clip_model.text_forward_embeds(
        clip_params, clip_cfg, build_prompts(adjusted, bank.token_embs),
        mode="ref_compat", pool_idx=T - 1,
    )
    return clip_model.l2_normalize(feats), attribution


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
) -> Dict[str, torch.Tensor]:
    """The fused forward: ``{"logits", "attribution"}`` (+ ``"loss"``,
    ``"loss_cls"``).  Padded classes get ``NEG_INF`` logits.

    Either ``images [B,H,W,3]`` or precomputed ``image_feats [B,E]``
    (unnormalized) is given; the image tower is frozen, so callers may cache
    its features across epochs.  ``batch_mask [B]`` averages the
    cross-entropy over the marked rows only (padded batches).
    """
    check_prompt_supported(prompt_cfg)
    if image_feats is None:
        image_feats = clip_model.encode_image(clip_params, clip_cfg, images)
    img = clip_model.l2_normalize(image_feats)
    scale = torch.exp(trainable["logit_scale"]).float()
    text_feats, attribution = text_features_with_attribution(
        clip_params, trainable["ctx"], bank, clip_cfg, prompt_cfg, trainable["adjustor"]
    )
    logits = scale * (img.float() @ text_feats.float().T)
    logits = torch.where(bank.class_mask[None, :], logits, torch.full_like(logits, NEG_INF))

    out = {"logits": logits, "attribution": attribution}
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
        out["attribution"] = out["attribution"][: self.n_cls]
        return out

    def predict(self, images):
        """Convenience inference: images -> (pred indices, class names)."""
        logits = self(images)["logits"].float().cpu().numpy()
        preds = logits.argmax(axis=-1)
        return preds, [self.class_names[i] for i in preds]
