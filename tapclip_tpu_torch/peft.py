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

Under tensor parallelism (``make_lora_pretrain_step(mesh=)`` with a
``model`` axis) the base tree is the rank's shards and the adapters stay
replicated, as in the JAX package: the merge cuts each adapter's delta as
its base leaf is cut (``parallel.sharding.cut``: the per-head qkv cut, the
hidden columns, the out-projection's and ``w_proj``'s rows, an MoE bank's
experts), so each rank's adapters see only their slice of the delta, and
their gradients are summed over ``model`` (and over ``data``).

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
from tapclip_tpu_torch.parallel import collectives
from tapclip_tpu_torch.parallel.sharding import cut, leaf_spec
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


def merge_lora(clip_params: Params, lora: Params, alpha: float = 16.0, mesh=None) -> Params:
    """``W + (alpha / r) * A @ B`` on every adapted leaf, in f32 (the others
    are the base tree's own tensors).  Differentiable in A and B.  ``mesh``
    with a ``model`` axis: ``clip_params`` is this rank's shards, and each
    delta is cut as its base leaf is (the module note)."""
    n = 1 if mesh is None else mesh.tp
    merged = dict(clip_params)
    for tower, sub_tree in lora.items():
        blocks = []
        for i, (blk, ab) in enumerate(zip(clip_params[tower]["blocks"], sub_tree["blocks"])):
            new = dict(blk)
            for sub, leaves in ab.items():
                new[sub] = dict(blk[sub])
                for name, pair in leaves.items():
                    w = blk[sub][name]
                    delta = alpha / pair["a"].shape[-1] * (pair["a"] @ pair["b"])
                    if n > 1:
                        path = f"{tower}/blocks/{i}/{sub}/{name}"
                        delta = cut(path, delta, leaf_spec(path, w, mesh), n, mesh.model_index)
                    new[sub][name] = (w.float() + delta).to(w.dtype)
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

    ``mesh`` (the ``data`` and ``model`` axes): each rank passes its rows,
    its shards of the base tree (``sharding.shard_params``) and a replica of
    the adapters; the adapters' gradients of the rank's share of the
    global-batch loss are summed over ``model`` (each rank's slice of each
    delta) and over ``data`` (``pretrain.py``'s mesh note).  A ``pipe``
    axis is refused here and FSDP by ``pretrain_cli``, as in the JAX CLI."""
    _check_loss(loss)
    m = _Mesh(mesh, cfg)
    if m.transformer_fn is not None:
        raise ValueError("--lora-rank does not compose with --pp yet (the merged tree runs the sequential tower)")

    def step(clip_params: Params, lora: Params, images, token_ids) -> Dict[str, torch.Tensor]:
        images, ids = _batch(clip_params, images, token_ids)
        merged = merge_lora(clip_params, lora, alpha=alpha, mesh=mesh)
        moe_losses: list = []
        with collectives.tensor_parallel(m.tp_group):
            img = clip_model.encode_image(merged, cfg, images, moe_loss_out=moe_losses)
            txt = clip_model.encode_text(merged, cfg, ids, moe_loss_out=moe_losses)
        total = pair_loss(loss, merged, img, txt, m.loss_group)
        if moe_losses:
            total = total + cfg.moe_aux_weight * m.lb_share * sum(moe_losses)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(torch.autograd.grad(total, optimizer.leaves, allow_unused=True), optimizer.leaves)]
        collectives.all_reduce_many_(grads, m.tp_group)
        optimizer.update(m.reduce(grads, optimizer.leaves))
        return {"loss": m.loss(total)}

    return step
