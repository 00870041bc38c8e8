"""Weight bridge from the JAX package's trees to the port's.

The JAX package stores a parameter tree of arrays (``models/clip.py``), with
every transformer block's leaves stacked along a leading ``[L]`` axis.  The
port keeps the same tree and layout, except that a stack of blocks is a list
of L per-block dicts.  The functions here take trees whose leaves are NumPy
arrays (convert a JAX tree with ``jax.tree.map(np.asarray, tree)``), so the
port itself never imports jax.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

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


def params_from_jax(tree: Dict[str, Any], cfg: CLIPConfig, device="cpu") -> Dict[str, Any]:
    """JAX CLIP parameter tree (NumPy leaves) -> the port's tree (f32 tensors)."""
    out = {}
    for tower in ("visual", "text"):
        sub = dict(tree[tower])
        blocks = sub.pop("blocks")
        out[tower] = _tree(sub, device)
        out[tower]["blocks"] = _unstack(blocks, device)
    out["logit_scale"] = _tensor(tree["logit_scale"], device)
    n_vis, n_txt = len(out["visual"]["blocks"]), len(out["text"]["blocks"])
    if (n_vis, n_txt) != (cfg.vision_layers, cfg.text_layers):
        raise ValueError(
            f"tree has {n_vis} vision / {n_txt} text blocks, config "
            f"{cfg.name} expects {cfg.vision_layers} / {cfg.text_layers}"
        )
    return out


def prompt_state_from_jax(trainable: Dict[str, Any], bank, device="cpu") -> Tuple[Dict[str, Any], PromptBank]:
    """JAX ``trainable`` (``ctx``, ``adjustor``, ``logit_scale``) and
    ``PromptBank`` (any object with its four fields, NumPy-valued) -> the port's."""
    port_trainable = {
        "ctx": _tensor(trainable["ctx"], device),
        "adjustor": _tree(dict(trainable.get("adjustor", {})), device),
        "logit_scale": _tensor(trainable["logit_scale"], device),
    }
    port_bank = PromptBank(
        ctx=_tensor(bank.ctx, device),
        token_embs=_tensor(bank.token_embs, device),
        class_mask=_tensor(bank.class_mask, device, torch.bool),
        eot_pos=_tensor(bank.eot_pos, device, torch.int32),
    )
    return port_trainable, port_bank
