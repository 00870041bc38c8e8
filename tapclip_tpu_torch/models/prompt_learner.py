"""Prompt learner: per-class learnable context vectors.

Counterpart of ``tapclip_tpu/models/prompt_learner.py``.  The class axis is
one stacked, **padded** tensor per field, so adding a class is a buffer
write into a free slot:

* ``ctx``        ``[C_max, P, D]``  learnable context vectors
* ``token_embs`` ``[C_max, 77, D]`` frozen template embeddings
* ``class_mask`` ``[C_max]``        which slots are live
* ``eot_pos``    ``[C_max]``        EOT index in the template tokens

Capacity is ``max(max_classes, 8)`` and grows in chunks of 8.  Context init
matches the reference: tokenize ``"a photo of a {name}"``, embed, and copy
embedding positions ``5 : 5+P`` when ``use_init_prompt``; otherwise Gaussian
from the learner's generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tapclip_tpu_torch.config import CLIPConfig, PromptConfig
from tapclip_tpu_torch.data.tokenizer import SimpleTokenizer

_GROW_CHUNK = 8


@dataclasses.dataclass
class PromptBank:
    """Stacked prompt state. ``ctx`` is the only trainable field."""

    ctx: torch.Tensor  # [C_max, P, D]
    token_embs: torch.Tensor  # [C_max, 77, D]
    class_mask: torch.Tensor  # [C_max] bool
    eot_pos: torch.Tensor  # [C_max] int32

    @property
    def capacity(self) -> int:
        return self.ctx.shape[0]


def build_prompts(ctx: torch.Tensor, token_embs: torch.Tensor) -> torch.Tensor:
    """``[C, P, D] ++ [C, 77, D] -> [C, P+77, D]``."""
    return torch.cat([ctx, token_embs.to(ctx.dtype)], dim=1)


class PromptLearner:
    """Host-side class registry over a padded ``PromptBank``."""

    def __init__(
        self,
        class_names: Sequence[str],
        clip_params,
        clip_cfg: CLIPConfig,
        prompt_cfg: PromptConfig,
        tokenizer: SimpleTokenizer,
        *,
        generator: Optional[torch.Generator] = None,
        banner: bool = True,
    ):
        self.clip_cfg = clip_cfg
        self.prompt_cfg = prompt_cfg
        self.tokenizer = tokenizer
        self._token_embedding = clip_params["text"]["token_embedding"]
        device = self._token_embedding.device
        self.class_names: List[str] = []
        self._generator = generator if generator is not None else torch.Generator().manual_seed(0)

        P, D = prompt_cfg.prompt_len, clip_cfg.text_width
        cap = max(prompt_cfg.max_classes, _GROW_CHUNK)
        f32 = torch.float32
        self.bank = PromptBank(
            ctx=torch.zeros((cap, P, D), dtype=f32, device=device),
            token_embs=torch.zeros((cap, clip_cfg.context_length, D), dtype=f32, device=device),
            class_mask=torch.zeros((cap,), dtype=torch.bool, device=device),
            eot_pos=torch.zeros((cap,), dtype=torch.int32, device=device),
        )
        if banner:  # the reference's construction banner, byte for byte
            print(
                f"cls_specific: {prompt_cfg.class_specific}, "
                f"use_init_prompt: {prompt_cfg.use_init_prompt}"
            )
        for name in class_names:
            self.add_class_prompt(name)

    @property
    def n_cls(self) -> int:
        return len(self.class_names)

    def __call__(self) -> torch.Tensor:
        """Stacked ``[n_cls, P+77, D]`` prompts for live classes."""
        n = self.n_cls
        return build_prompts(self.bank.ctx[:n], self.bank.token_embs[:n])

    def add_class_prompt(self, class_name: str) -> None:
        """Register a class (no-op if present): a write into the next free slot."""
        if class_name in self.class_names:
            return
        idx = len(self.class_names)
        if idx >= self.bank.capacity:
            self._grow(self.bank.capacity + _GROW_CHUNK)
        token_emb, ctx_init, eot = self._init_for_class(class_name)
        b = self.bank
        b.ctx[idx] = ctx_init
        b.token_embs[idx] = token_emb
        b.class_mask[idx] = True
        b.eot_pos[idx] = eot
        self.class_names.append(class_name)

    def _init_for_class(self, class_name: str):
        cfg, pcfg = self.clip_cfg, self.prompt_cfg
        text = pcfg.template.format(class_name)
        ids = self.tokenizer.tokenize([text], cfg.context_length)[0]
        index = torch.as_tensor(ids.astype(np.int64), device=self._token_embedding.device)
        token_emb = self._token_embedding[index].float()  # [77, D]
        eot = int(np.argmax(ids))  # EOT has the largest token id
        P = pcfg.prompt_len
        if pcfg.use_init_prompt and token_emb.shape[0] >= 5 + P:
            ctx_init = token_emb[5 : 5 + P]
        else:
            ctx_init = torch.randn(
                (P, cfg.text_width), generator=self._generator,
                device=self._generator.device, dtype=torch.float32,
            )
        return token_emb, ctx_init, eot

    def _grow(self, new_cap: int) -> None:
        def pad_to(x):
            pad = torch.zeros(
                (new_cap - x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device
            )
            return torch.cat([x, pad], dim=0)

        b = self.bank
        self.bank = PromptBank(
            ctx=pad_to(b.ctx),
            token_embs=pad_to(b.token_embs),
            class_mask=pad_to(b.class_mask),
            eot_pos=pad_to(b.eot_pos),
        )

    # -- (de)serialization helpers -------------------------------------------

    def load_ctx(self, ctx_by_name: Dict[str, np.ndarray]) -> None:
        """Load per-class context vectors by class name (checkpoint restore).

        Every unseen name is registered first (growing the bank), then the
        vectors are written into a new ctx tensor, so a bank shared with a
        snapshot is never written through.
        """
        for name in ctx_by_name:
            if name not in self.class_names:
                self.add_class_prompt(name)
        ctx = self.bank.ctx.clone()
        for name, arr in ctx_by_name.items():
            value = arr if torch.is_tensor(arr) else torch.from_numpy(np.asarray(arr, np.float32))
            ctx[self.class_names.index(name)] = value.to(ctx.device, torch.float32)
        self.bank = dataclasses.replace(self.bank, ctx=ctx)

    def ctx_by_name(self) -> Dict[str, np.ndarray]:
        return {name: self.bank.ctx[i].float().cpu().numpy() for i, name in enumerate(self.class_names)}
