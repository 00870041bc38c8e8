"""Weight bridge from the JAX package's trees to the port's.

The JAX package stores a parameter tree of arrays (``models/clip.py``), with
every transformer block's leaves stacked along a leading ``[L]`` axis.  The
port keeps the same tree and layout, except that a stack of blocks is a list
of L per-block dicts and an RN tower's convolution weights are OIHW (the
JAX package's are HWIO).  The functions here take trees whose leaves are NumPy
arrays (convert a JAX tree with ``jax.tree.map(np.asarray, tree)``), so the
port itself never imports jax.  :func:`adamw_state_from_optax` carries an
optax AdamW state over, so a JAX mid-training state resumes in the port.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

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


def adamw_state_from_optax(opt_state) -> List[Dict[str, Any]]:
    """optax ``adamw`` state (NumPy-valued, ``(ScaleByAdamState(count, mu, nu),
    ...)``) -> the port's per-leaf AdamW moments, in sorted-key leaf order, for
    ``init_train_state(opt_state=...)`` or ``fit_prompt_model(resume_state=...)``.

    optax's ``count`` is torch's ``step``, ``mu`` its ``exp_avg`` and ``nu``
    its ``exp_avg_sq``; both apply the bias correction by the count, so the
    next step from a resumed state equals the next JAX step.
    """
    from tapclip_tpu_torch.parallel.train_step import tree_leaves

    adam = _adam_node(opt_state)
    if adam is None:
        raise ValueError("no (count, mu, nu) Adam state found in the optax state")
    count = int(np.asarray(adam.count))
    mus, nus = tree_leaves(dict(adam.mu)), tree_leaves(dict(adam.nu))
    if count == 0:
        return [{} for _ in mus]
    return [
        {"step": count, "exp_avg": np.asarray(m, np.float32), "exp_avg_sq": np.asarray(v, np.float32)}
        for m, v in zip(mus, nus)
    ]
