"""Embedding functions for retrieval indexes.

Counterpart of the two embed builders of ``tapclip_tpu/featurize.py``:
``make_image_embed_fn`` and ``make_text_embed_fn`` return functions
``(params, batch) -> [B, embed_dim]`` unit-norm f32 features, run under
``torch.inference_mode()``.  ``serve.PredictService.embed_text`` uses the text
one, so served and offline embeddings come from the same code.  The corpus
featurizer (ImageFolder / shard walk, ``.npy`` + manifest output) is not yet
ported.
"""

from __future__ import annotations

from typing import Callable

import torch

from tapclip_tpu_torch.config import CLIPConfig
from tapclip_tpu_torch.models import clip as clip_model


def make_image_embed_fn(cfg: CLIPConfig) -> Callable:
    """``(params, images [B, H, W, 3] f32 | uint8) -> [B, D] f32 unit-norm``."""

    def embed(params, images):
        with torch.inference_mode():
            x = torch.as_tensor(images, device=params["logit_scale"].device)
            return clip_model.l2_normalize(clip_model.encode_image(params, cfg, x)).float()

    return embed


def make_text_embed_fn(cfg: CLIPConfig) -> Callable:
    """``(params, token_ids [B, T] int) -> [B, D] f32 unit-norm``."""

    def embed(params, ids):
        with torch.inference_mode():
            return clip_model.l2_normalize(clip_model.encode_text(params, cfg, ids)).float()

    return embed
