"""Weight bridge from the JAX package's trees to the port's.

The JAX package stores a parameter tree of arrays (``models/clip.py``), with
every transformer block's leaves stacked along a leading ``[L]`` axis.  The
port keeps the same tree and layout, except that a stack of blocks is a list
of L per-block dicts and an RN tower's convolution weights are OIHW (the
JAX package's are HWIO).  An MoE block's stacked leaves (``moe/w_fc [L, E, W, H]``, ``moe/router/w
[L, W, E]``, ...) become per-block ``[E, ...]`` tensors the same way.  The
functions here take trees whose leaves are NumPy
arrays (convert a JAX tree with ``jax.tree.map(np.asarray, tree)``), so the
port itself never imports jax.  :func:`adamw_state_from_optax` carries an
optax AdamW state over, so a JAX mid-training state resumes in the port:
a prompt-tuning state, or (with ``cfg``) a pretraining state of the whole
tree or of the LoRA adapters (:func:`lora_from_jax`).  The extras of
pretraining ride along: ``visual.vpt``, SigLIP's ``logit_bias`` and
distillation's ``kd_proj``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tapclip_tpu_torch.config import CLIPConfig
from tapclip_tpu_torch.models.prompt_learner import PromptBank


def _tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _tree(node, device):
    if isinstance(node, dict):
        return {k: _tree(v, device) for k, v in node.items()}
    return _tensor(node, device)


def _unstack(stacked: Dict[str, Any], device):
    """``{leaf: [L, ...]}`` nested dict -> list of L per-block dicts."""
    leaves = []

    def walk(node):
        for v in node.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)

    walk(stacked)
    n_layers = np.asarray(leaves[0]).shape[0]

    def take(node, i):
        return {
            k: take(v, i) if isinstance(v, dict) else _tensor(np.asarray(v)[i], device)
            for k, v in node.items()
        }

    return [take(stacked, i) for i in range(n_layers)]


def _resnet_tree(node, device):
    """A JAX RN visual tree -> the port's: the same nesting (each layer a
    list of block dicts), every convolution's HWIO ``w`` turned into OIHW."""
    if isinstance(node, dict):
        return {k: (_tensor(np.asarray(v).transpose(3, 2, 0, 1), device) if k == "w" and np.ndim(v) == 4
                    else _resnet_tree(v, device)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_resnet_tree(v, device) for v in node]
    return _tensor(node, device)


def params_from_jax(tree: Dict[str, Any], cfg: CLIPConfig, device="cpu") -> Dict[str, Any]:
    """JAX CLIP parameter tree (NumPy leaves) -> the port's tree (f32
    tensors), with a ViT or an RN (``vision_tower="resnet"``) image tower."""
    out = {}
    towers = ("text",) if cfg.vision_tower == "resnet" else ("visual", "text")
    for tower in towers:
        sub = dict(tree[tower])
        blocks = sub.pop("blocks")
        out[tower] = _tree(sub, device)
        out[tower]["blocks"] = _unstack(blocks, device)
    out["logit_scale"] = _tensor(tree["logit_scale"], device)
    for extra in ("logit_bias", "kd_proj"):
        if extra in tree:
            out[extra] = _tensor(tree[extra], device)
    n_txt = len(out["text"]["blocks"])
    if cfg.vision_tower == "resnet":
        out["visual"] = _resnet_tree(tree["visual"], device)
        got = tuple(len(out["visual"].get(f"layer{i + 1}", ())) for i in range(len(cfg.resnet_layers)))
        if got != tuple(cfg.resnet_layers) or n_txt != cfg.text_layers:
            raise ValueError(f"tree has RN layers {got} / {n_txt} text blocks, config {cfg.name} expects "
                             f"{tuple(cfg.resnet_layers)} / {cfg.text_layers}")
        return out
    n_vis = len(out["visual"]["blocks"])
    if (n_vis, n_txt) != (cfg.vision_layers, cfg.text_layers):
        raise ValueError(
            f"tree has {n_vis} vision / {n_txt} text blocks, config "
            f"{cfg.name} expects {cfg.vision_layers} / {cfg.text_layers}"
        )
    return out


def lora_from_jax(lora: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX LoRA adapters (``peft.init_lora_params``' tree: the CLIP tree
    with ``{"a", "b"}`` at each adapted stacked leaf and None elsewhere, an
    MoE router included, NumPy-valued) -> the port's (``peft.py``: per
    tower, a list of blocks)."""
    def adapted(node):  # the {"a", "b"} pairs, the None leaves dropped
        if isinstance(node, dict) and set(node) == {"a", "b"}:
            return node
        if isinstance(node, dict):
            kept = {k: adapted(v) for k, v in node.items()}
            return {k: v for k, v in kept.items() if v}
        return None

    out = {}
    for tower in ("visual", "text"):
        blocks = adapted((lora.get(tower) or {}).get("blocks"))
        if blocks:
            out[tower] = {"blocks": _unstack(blocks, device)}
    return out


def prompt_state_from_jax(trainable: Dict[str, Any], bank, device="cpu") -> Tuple[Dict[str, Any], PromptBank]:
    """JAX ``trainable`` (``ctx``, ``adjustor``, ``logit_scale``, and
    CoCoOp's ``meta_net`` and MaPLe's ``maple`` subtrees when present) and
    ``PromptBank`` (any object with its four fields, NumPy-valued) -> the
    port's."""
    port_trainable = {
        "ctx": _tensor(trainable["ctx"], device),
        "adjustor": _tree(dict(trainable.get("adjustor", {})), device),
        "logit_scale": _tensor(trainable["logit_scale"], device),
    }
    for key in ("meta_net", "maple"):
        if key in trainable:
            port_trainable[key] = _tree(dict(trainable[key]), device)
    port_bank = PromptBank(
        ctx=_tensor(bank.ctx, device),
        token_embs=_tensor(bank.token_embs, device),
        class_mask=_tensor(bank.class_mask, device, torch.bool),
        eot_pos=_tensor(bank.eot_pos, device, torch.int32),
    )
    return port_trainable, port_bank


def _adam_node(node):
    """The first node with ``count``, ``mu`` and ``nu`` (optax's ScaleByAdamState)."""
    if all(hasattr(node, a) for a in ("count", "mu", "nu")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _adam_node(child)
            if found is not None:
                return found
    return None


def _multisteps_node(node):
    """optax's MultiStepsState (``mini_step``, ``acc_grads``), if any."""
    if all(hasattr(node, a) for a in ("mini_step", "acc_grads")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _multisteps_node(child)
            if found is not None:
                return found
    return None


def _pretrain_state(adam, opt_state, cfg: CLIPConfig, lora: bool) -> Dict[str, Any]:
    from tapclip_tpu_torch.pretrain import named_leaves

    def bridge(tree):
        return lora_from_jax(tree) if lora else params_from_jax(tree, cfg)

    count = int(np.asarray(adam.count))
    mus, nus = named_leaves(bridge(adam.mu)), named_leaves(bridge(adam.nu))
    moments = {} if count == 0 else {
        path: {"step": count, "exp_avg": m.numpy(), "exp_avg_sq": v.numpy()}
        for (path, m), (_, v) in zip(mus, nus)
    }
    multi = _multisteps_node(opt_state)
    mini = 0 if multi is None else int(np.asarray(multi.mini_step))
    acc = None if not mini else {p: t.numpy() for p, t in named_leaves(bridge(multi.acc_grads))}
    return {"count": count, "mini_step": mini, "moments": moments, "acc": acc}


def adamw_state_from_optax(opt_state, cfg: Optional[CLIPConfig] = None, *, lora: bool = False):
    """Without ``cfg``: a prompt-tuning state (:func:`_prompt_adamw_state`).
    With ``cfg``: a pretraining state (the
    optax ``adamw`` of ``pretrain_cli``, under ``clip_by_global_norm`` and
    ``MultiSteps`` or not) of the whole CLIP tree, or of the LoRA adapters
    with ``lora``, as ``pretrain.PretrainOptimizer.load_state_dict`` takes
    it: ``{"count", "mini_step", "moments": {leaf path: moments}, "acc"}``."""
    adam = _adam_node(opt_state)
    if adam is None:
        raise ValueError("no (count, mu, nu) Adam state found in the optax state")
    if cfg is not None:
        return _pretrain_state(adam, opt_state, cfg, lora)
    return _prompt_adamw_state(adam)


def _prompt_adamw_state(adam) -> List[Dict[str, Any]]:
    """optax ``adamw`` state (NumPy-valued, ``(ScaleByAdamState(count, mu, nu),
    ...)``) -> the port's per-leaf AdamW moments, in sorted-key leaf order, for
    ``init_train_state(opt_state=...)`` or ``fit_prompt_model(resume_state=...)``.

    optax's ``count`` is torch's ``step``, ``mu`` its ``exp_avg`` and ``nu``
    its ``exp_avg_sq``; both apply the bias correction by the count, so the
    next step from a resumed state equals the next JAX step.
    """
    from tapclip_tpu_torch.parallel.train_step import tree_leaves

    count = int(np.asarray(adam.count))
    mus, nus = tree_leaves(dict(adam.mu)), tree_leaves(dict(adam.nu))
    if count == 0:
        return [{} for _ in mus]
    return [
        {"step": count, "exp_avg": np.asarray(m, np.float32), "exp_avg_sq": np.asarray(v, np.float32)}
        for m, v in zip(mus, nus)
    ]
