"""CLIPWrapper: the reference's L1 interface over the functional CLIP model.

Counterpart of ``tapclip_tpu/models/clip_wrapper.py`` (the reference's
``models/clip_wrapper.py``): ``encode_image``, ``encode_text``,
``get_attention_map``, ``reset``, ``get_tokenizer``, ``get_preprocess``, and
``transformer_raw``, the reference's bare ``model.transformer(x)`` call.

Attention maps are returned by a function here, not captured by a hook:
the last ``encode_text`` or ``transformer_raw`` call records the final text
block's head-averaged attention probabilities ``[B, T, T]``
(:func:`last_layer_attention_map`), which ``get_attention_map`` returns.
The reference's hook reads the attention output, not the probabilities
(open_clip calls ``nn.MultiheadAttention`` with ``need_weights=False``);
this follows the documented intent, as the JAX package does.

``device`` (default ``cuda``) is where the weights live and the towers
run; asking for ``cuda`` without a card raises.  The JAX package accepts
the argument and ignores it.
"""

from __future__ import annotations

from typing import Optional

import torch

from tapclip_tpu_torch.config import CLIPConfig
from tapclip_tpu_torch.models import clip as clip_model
from tapclip_tpu_torch.models import layers


def last_layer_attention_map(params, cfg: CLIPConfig, embeds: torch.Tensor, *, causal: bool = False) -> torch.Tensor:
    """The last text block's head-averaged attention probabilities
    ``[B, T, T]`` f32 over ``embeds [B, T, W]``.

    The blocks before it run on the plain path (``impl="xla"``).  A
    debugging and compatibility path: the hot path produces only the
    attribution column, by the kernel's aux output.
    """
    blocks = params["text"]["blocks"]
    x = embeds.to(cfg.compute_dtype)
    for blk in blocks[:-1]:
        x, _ = layers.block_forward(x, blk, cfg.text_heads, act=cfg.act, ln_eps=cfg.ln_eps, causal=causal,
                                    impl="xla")
    last = blocks[-1]
    y = layers.layer_norm(x, last["ln_1"], cfg.ln_eps)
    B, T, W = y.shape
    H = cfg.text_heads
    qkv = y @ last["attn"]["w_qkv"].to(y.dtype) + last["attn"]["b_qkv"].to(y.dtype)
    q, k, _ = (t.reshape(B, T, H, W // H).transpose(1, 2) for t in qkv.split(W, dim=-1))
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * ((W // H) ** -0.5)
    if causal:
        qi = torch.arange(T, device=y.device)[:, None]
        logits = logits.masked_fill(torch.arange(T, device=y.device)[None, :] > qi, -torch.inf)
    return torch.softmax(logits.float(), dim=-1).mean(dim=1)


class CLIPWrapper:
    """The reference's ``CLIPWrapper``, imperative API over the port's model."""

    def __init__(
        self,
        model_name: str = "ViT-B-32",
        pretrained_path: Optional[str] = None,
        device: str = "cuda",
        *,
        cfg: Optional[CLIPConfig] = None,
        bpe_path: Optional[str] = None,
        rng_seed: int = 0,
    ):
        from tapclip_tpu_torch.config import MODEL_PRESETS
        from tapclip_tpu_torch.data.preprocess import make_preprocess
        from tapclip_tpu_torch.data.tokenizer import get_tokenizer
        from tapclip_tpu_torch.featurize import load_clip_params

        self.cfg = cfg or MODEL_PRESETS[model_name]
        self.params = load_clip_params(self.cfg, pretrained_path, seed=rng_seed, device=device)
        self.device = self.params["logit_scale"].device
        self.tokenizer = get_tokenizer(bpe_path, self.cfg.context_length)
        self.preprocess = make_preprocess(self.cfg.image_size)
        self._attention_map = None

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    # -- the reference's API --------------------------------------------------

    def reset(self):
        self._attention_map = None

    def encode_image(self, images) -> torch.Tensor:
        """Images ``[B, H, W, 3]`` (preprocessed f32, or raw uint8) ->
        ``[B, embed_dim]``, not normalized."""
        with torch.inference_mode():
            return clip_model.encode_image(self.params, self.cfg, self._on_device(images))

    def encode_text(self, token_ids) -> torch.Tensor:
        """Token ids ``[B, T]`` -> ``[B, embed_dim]`` (the proper CLIP text
        encoder), recording the causal last-layer map."""
        self.reset()
        with torch.inference_mode():
            ids = self._on_device(token_ids).long()
            x = clip_model.embed_tokens(self.params, self.cfg, ids)
            x = x + self.params["text"]["positional_embedding"][None].to(x.dtype)
            self._attention_map = last_layer_attention_map(self.params, self.cfg, x, causal=True)
            return clip_model.encode_text(self.params, self.cfg, ids)

    def transformer_raw(self, embeds) -> torch.Tensor:
        """The reference's bare ``model.transformer(x)`` over embeddings
        ``[B, T, W]`` (no positional embedding, no mask, pooled at T-1),
        recording the non-causal last-layer map."""
        with torch.inference_mode():
            embeds = self._on_device(embeds)
            self._attention_map = last_layer_attention_map(self.params, self.cfg, embeds, causal=False)
            feats, _ = clip_model.text_forward_embeds(self.params, self.cfg, embeds, mode="ref_compat",
                                                      pool_idx=None)
            return feats

    def get_attention_map(self):
        return self._attention_map

    def get_tokenizer(self):
        return self.tokenizer

    def get_preprocess(self):
        return self.preprocess
