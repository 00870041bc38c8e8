"""Parameter-efficient fine-tuning: LoRA adapters for the CLIP towers.

Counterpart of ``tapclip_tpu/peft.py``.  LoRA (Hu et al. 2021) as
merge-then-run: every step merges

    W' = W + (alpha / r) * A @ B

in f32 on ``attn/w_qkv``, ``attn/w_out``, ``mlp/w_fc`` and ``mlp/w_proj`` of
every block of both towers (an MoE block's expert banks ``moe/w_fc`` and
``moe/w_proj`` per expert; its router stays frozen, with no adapter), then
runs the towers unchanged on the merged
tree, so the same kernels run as in full pretraining (on the card the
backward kernels compute dW of the merged weights, which autograd carries
on into A and B).  The base tree does not require a gradient and has no
optimizer state; ``logit_scale`` stays frozen too.  On MoE towers the step
adds the load-balance term with weight ``moe_aux_weight``, as the JAX
package's does.

The adapter tree mirrors the towers' block lists:
``{"visual": {"blocks": [{"attn": {"w_qkv": {"a", "b"}, ...}, "mlp": {...}}, ...]},
"text": {...}}``.  For a weight ``[..., In, Out]`` (an expert bank's
``[E, In, Out]``) A is ``[..., In, r]`` ``N(0, 1/r)`` and B ``[..., r, Out]``
zero, the rank axis broadcasting over the experts, so step 0 reproduces
the base model.  An RN-family image tower has no block
list and gets no adapters.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from tapclip_tpu_torch.config import CLIPConfig
from tapclip_tpu_torch.models import clip as clip_model
from tapclip_tpu_torch import NotPortedError
from tapclip_tpu_torch.pretrain import PretrainOptimizer, _Mesh, _check_loss, _batch, named_leaves, pair_loss

Params = Dict[str, Any]

ADAPTED = {"attn": ("w_qkv", "w_out"), "mlp": ("w_fc", "w_proj"), "moe": ("w_fc", "w_proj")}


def _towers(params: Params):
    return [t for t in ("visual", "text") if isinstance(params.get(t), dict) and "blocks" in params[t]]


def init_lora_params(generator: torch.Generator, clip_params: Params, rank: int = 8) -> Params:
    """Adapters for every adapted leaf of ``clip_params``, A drawn from
    ``generator`` (tower, block, sublayer and leaf in that order)."""
    out: Params = {}
    for tower in _towers(clip_params):
        blocks = []
        for blk in clip_params[tower]["blocks"]:
            entry = {}
            for sub, names in ADAPTED.items():
                if sub not in blk:
                    continue
                entry[sub] = {}
                for name in names:
                    w = blk[sub][name]
                    *lead, n_in, n_out = w.shape
                    a = torch.randn((*lead, n_in, rank), generator=generator, device=generator.device,
                                    dtype=torch.float32)
                    entry[sub][name] = {"a": (a * rank ** -0.5).to(w.device),
                                        "b": torch.zeros((*lead, rank, n_out), dtype=torch.float32, device=w.device)}
            blocks.append(entry)
        out[tower] = {"blocks": blocks}
    return out


def merge_lora(clip_params: Params, lora: Params, alpha: float = 16.0) -> Params:
    """``W + (alpha / r) * A @ B`` on every adapted leaf, in f32 (the others
    are the base tree's own tensors).  Differentiable in A and B."""
    merged = dict(clip_params)
    for tower, sub_tree in lora.items():
        blocks = []
        for blk, ab in zip(clip_params[tower]["blocks"], sub_tree["blocks"]):
            new = dict(blk)
            for sub, leaves in ab.items():
                new[sub] = dict(blk[sub])
                for name, pair in leaves.items():
                    w = blk[sub][name]
                    scale = alpha / pair["a"].shape[-1]
                    new[sub][name] = (w.float() + scale * (pair["a"] @ pair["b"])).to(w.dtype)
            blocks.append(new)
        merged[tower] = dict(clip_params[tower], blocks=blocks)
    return merged


def lora_param_count(lora: Params) -> int:
    return sum(t.numel() for _, t in named_leaves(lora))


def make_lora_pretrain_step(cfg: CLIPConfig, optimizer: PretrainOptimizer, loss: str = "infonce",
                            alpha: float = 16.0, mesh=None) -> Callable:
    """``step(clip_params, lora, images, token_ids) -> {"loss"}``: the
    contrastive loss of the merged tree, its gradient in the adapters only
    (``optimizer``'s leaves: ``lora``'s), one update in place.

    ``mesh`` (the ``data`` axis): each rank passes its rows and a replica of
    the base tree and the adapters; the adapters' gradients of the rank's
    share of the global-batch loss are summed over ``data``
    (``pretrain.py``'s mesh note).  Adapters under ``tp > 1`` are not yet
    ported (refused by name)."""
    _check_loss(loss)
    m = _Mesh(mesh, cfg)
    if m.tp_group is not None:
        raise NotPortedError("LoRA adapters under tp > 1")
    if m.transformer_fn is not None:
        raise ValueError("--lora-rank does not compose with --pp yet (the merged tree runs the sequential tower)")

    def step(clip_params: Params, lora: Params, images, token_ids) -> Dict[str, torch.Tensor]:
        images, ids = _batch(clip_params, images, token_ids)
        merged = merge_lora(clip_params, lora, alpha=alpha)
        moe_losses: list = []
        img = clip_model.encode_image(merged, cfg, images, moe_loss_out=moe_losses)
        txt = clip_model.encode_text(merged, cfg, ids, moe_loss_out=moe_losses)
        total = pair_loss(loss, merged, img, txt, m.loss_group)
        if moe_losses:
            total = total + cfg.moe_aux_weight * sum(moe_losses)
        optimizer.update(m.reduce(torch.autograd.grad(total, optimizer.leaves, allow_unused=True), optimizer.leaves))
        return {"loss": m.loss(total)}

    return step
