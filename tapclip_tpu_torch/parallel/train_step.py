"""Train and eval steps for prompt tuning.

Counterpart of ``tapclip_tpu/parallel/train_step.py``: forward (class-level
attribution, fused), backward into the trainable leaves only, AdamW update.
The reference optimizes the per-class context vectors alone
(``trainable_keys=("ctx",)``); the adjustor and ``logit_scale`` stay frozen
unless named.  The CLIP weights never require a gradient, so the backward
runs through the text encode pass only: on the card, one B4 and one B5
launch per text block (``ops/fused_mha.py``, ``ops/fused_mlp.py``).

JAX's pure ``step(state) -> new_state`` becomes an in-place update: the
state's trainable leaves are leaf tensors that ``torch.optim.AdamW``
updates in place, and the step returns the same :class:`TrainState`.
``torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay)``
computes ``optax.adamw``'s update: decay applied to the old parameter, eps
outside the square root, bias correction by the step count.

The image tower is frozen, so both steps take precomputed image features
(``use_image_feats=True``) or pixels.  The KgCoOp, ProGrad and PromptSRC
terms (``kg_lambda``, ``prograd_lambda``, ``scl_lambda``) are not yet
ported and raise.  No data parallelism yet: one device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tapclip_tpu_torch.config import CLIPConfig, PromptConfig, TrainConfig
from tapclip_tpu_torch.models import clip as clip_model
from tapclip_tpu_torch.models.model_wrapper import full_model_forward


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (``jax.tree.leaves``' order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _clone_tree(tree, requires_grad: bool = False, device=None):
    if isinstance(tree, dict):
        return {k: _clone_tree(v, requires_grad, device) for k, v in tree.items()}
    t = tree if torch.is_tensor(tree) else torch.as_tensor(np.array(tree))
    return t.detach().to(device or t.device).clone().requires_grad_(requires_grad)


def snapshot(trainable: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A detached copy of a trainable dict of tensors or arrays (on ``device``
    when given): the optimizer updates the live tensors in place."""
    return _clone_tree(trainable, device=device)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, Any]  # the full trainable dict (ctx, adjustor, logit_scale)
    optimizer: torch.optim.Optimizer  # AdamW over the trainable_keys' leaves
    trainable_keys: Tuple[str, ...] = ("ctx",)

    def diff_leaves(self) -> List[torch.Tensor]:
        return tree_leaves({k: self.params[k] for k in self.trainable_keys})

    def opt_state(self) -> List[Dict[str, Any]]:
        """Per-leaf AdamW moments (``step``, ``exp_avg``, ``exp_avg_sq``), in
        :meth:`diff_leaves` order; ``init_train_state(opt_state=...)`` takes it."""
        out = []
        for p in self.diff_leaves():
            st = self.optimizer.state.get(p, {})
            out.append({k: (v.detach().clone() if torch.is_tensor(v) else v) for k, v in st.items()})
        return out


def make_optimizer(train_cfg: TrainConfig) -> Callable[[List[torch.Tensor]], torch.optim.AdamW]:
    """AdamW with the reference hyperparameters (lr 2e-3, weight decay 0.01),
    as a factory over the parameter list (``init_train_state`` calls it)."""
    return functools.partial(
        torch.optim.AdamW, lr=train_cfg.lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=train_cfg.weight_decay,
    )


def load_adamw_state(optimizer: torch.optim.Optimizer, leaves, per_leaf) -> None:
    """Set each leaf's AdamW moments from ``per_leaf`` (dicts of ``step``,
    ``exp_avg``, ``exp_avg_sq``; empty for a leaf never stepped)."""
    if len(per_leaf) != len(leaves):
        raise ValueError(f"optimizer state mismatch: {len(per_leaf)} leaves vs {len(leaves)}")
    for p, st in zip(leaves, per_leaf):
        if not st:
            continue
        optimizer.state[p] = {
            "step": torch.tensor(float(st["step"]), dtype=torch.float32),
            "exp_avg": _as_tensor(st["exp_avg"], p.device, p.dtype).clone(),
            "exp_avg_sq": _as_tensor(st["exp_avg_sq"], p.device, p.dtype).clone(),
        }


def init_train_state(
    trainable: Dict[str, Any],
    optimizer: Callable,
    trainable_keys: Tuple[str, ...] = ("ctx",),
    *,
    step: int = 0,
    opt_state: Optional[List[Dict[str, Any]]] = None,
) -> TrainState:
    """A fresh state: the trainable_keys' leaves are cloned into leaf tensors
    that require a gradient (the caller's tensors are not touched), and the
    optimizer is built over them, with ``opt_state`` loaded when given."""
    params = dict(trainable)
    for k in trainable_keys:
        params[k] = _clone_tree(trainable[k], requires_grad=True)
    state = TrainState(step=int(step), params=params, optimizer=None,
                       trainable_keys=tuple(trainable_keys))
    leaves = state.diff_leaves()
    state.optimizer = optimizer(leaves)
    if opt_state is not None:
        load_adamw_state(state.optimizer, leaves, opt_state)
    return state


def _device_of(clip_params) -> torch.device:
    return clip_params["logit_scale"].device


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    t = a if torch.is_tensor(a) else torch.as_tensor(np.array(a))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def _unported(**lambdas) -> None:
    for name, value in lambdas.items():
        if value > 0.0:
            raise NotImplementedError(f"{name} > 0 is not yet ported in tapclip_tpu_torch")


def make_train_step(
    clip_cfg: CLIPConfig,
    prompt_cfg: PromptConfig,
    optimizer: Optional[Callable] = None,
    trainable_keys: Tuple[str, ...] = ("ctx",),
    use_image_feats: bool = True,
    kg_lambda: float = 0.0,
    prograd_lambda: float = 0.0,
    scl_lambda: float = 0.0,
) -> Callable:
    """Returns ``step(clip_params, state, bank, images_or_feats, labels, mask)
    -> (state, {"loss", "grad_norm"})``, CE-only.

    ``optimizer`` is accepted for the JAX package's signature; the optimizer
    itself lives in the state (:func:`init_train_state`).  The step updates
    ``state`` in place and returns it.
    """
    _unported(kg_lambda=kg_lambda, prograd_lambda=prograd_lambda, scl_lambda=scl_lambda)
    keys = tuple(trainable_keys)

    def step(clip_params, state: TrainState, bank, x, labels, mask):
        if state.trainable_keys != keys:
            raise ValueError(f"state trains {state.trainable_keys}, step was made for {keys}")
        dev = _device_of(clip_params)
        x = _as_tensor(x, dev)
        labels = _as_tensor(labels, dev, torch.long)
        mask = None if mask is None else _as_tensor(mask, dev, torch.bool)
        out = full_model_forward(
            clip_params, state.params, bank,
            None if use_image_feats else x, labels,
            clip_cfg=clip_cfg, prompt_cfg=prompt_cfg, with_loss=True,
            image_feats=x if use_image_feats else None, batch_mask=mask,
        )
        loss = out["loss"]
        leaves = state.diff_leaves()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        grad_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        for p, g in zip(leaves, grads):
            p.grad = g
        state.optimizer.step()
        for p in leaves:
            p.grad = None
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm.detach()}

    return step


def make_eval_step(
    clip_cfg: CLIPConfig,
    prompt_cfg: PromptConfig,
    use_image_feats: bool = True,
) -> Callable:
    """Returns ``eval_step(clip_params, trainable, bank, x, labels, mask)`` ->
    per-batch ``correct``/``total`` and per-class counts (padded C_max), run
    under ``torch.inference_mode()``."""

    def step(clip_params, trainable, bank, x, labels, mask):
        dev = _device_of(clip_params)
        with torch.inference_mode():
            x = _as_tensor(x, dev)
            labels = _as_tensor(labels, dev, torch.long)
            valid = _as_tensor(mask, dev, torch.long)
            out = full_model_forward(
                clip_params, trainable, bank, None if use_image_feats else x, None,
                clip_cfg=clip_cfg, prompt_cfg=prompt_cfg, with_loss=False,
                image_feats=x if use_image_feats else None,
            )
            logits = out["logits"]
            preds = logits.argmax(dim=-1)
            correct = (preds == labels).long() * valid
            onehot = torch.nn.functional.one_hot(labels, logits.shape[-1]) * valid[:, None]
            return {
                "correct": correct.sum(),
                "total": valid.sum(),
                "per_class_correct": (onehot * correct[:, None]).sum(dim=0),
                "per_class_total": onehot.sum(dim=0),
                "preds": preds,
            }

    return step


def make_image_encoder(clip_cfg: CLIPConfig) -> Callable:
    """The frozen image tower, ``encode(clip_params, images)``, under
    ``torch.inference_mode()`` (for feature caching)."""

    def encode(clip_params, images):
        with torch.inference_mode():
            return clip_model.encode_image(clip_params, clip_cfg, _as_tensor(images, _device_of(clip_params)))

    return encode


def encode_dataset_features(clip_params, clip_cfg: CLIPConfig, loader, *, encoder=None):
    """Run the frozen image tower over a loader of ``(images, labels, mask)``
    batches once; returns ``(feats [N, E] f32, labels [N])`` as NumPy arrays
    (bfloat16 features are widened to f32: NumPy has no bfloat16)."""
    encoder = encoder or make_image_encoder(clip_cfg)
    feats, labels = [], []
    for images, lbls, mask in loader:
        f = encoder(clip_params, images).float().cpu().numpy()
        keep = np.asarray(mask, bool)
        feats.append(f[keep])
        labels.append(np.asarray(lbls)[keep])
    return np.concatenate(feats), np.concatenate(labels)
