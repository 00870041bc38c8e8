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
(``use_image_feats=True``) or pixels.  The zero-shot anchors of the JAX step
are here: the KgCoOp cosine pull (``kg_lambda``), PromptSRC's logit
distillation (``scl_lambda``) and ProGrad's projection (``prograd_lambda``:
one forward, then two pullbacks of ``[loss, KL]`` over the retained graph,
so every backward kernel runs twice per step).

**A mesh** (``mesh=``, ``parallel/mesh.py``'s process-group form): the JAX
step takes its data parallelism from the batch's placement; here each rank
passes its rows of the global batch (``sharding.shard_batch``) and the step
sums, over ``data``, every trained leaf's gradient of this rank's share of
the global-batch loss: its local (masked) mean times its share of the
global count, so that a dp = 2 step equals the dp = 1 step on the same
global batch.  ProGrad's projection is nonlinear, so both pullbacks are
reduced before it (the "global-gradient projection under dp").  The KgCoOp
and scl terms stay batch means over the global batch.  Under ``tp > 1`` the
towers run tensor parallel over ``model`` (``models/layers.py``) inside the
forward, and the trained leaves' gradients come out complete on every rank
of a ``model`` group, so nothing is summed over ``model``.  With no mesh the
step runs exactly what it runs without one.  Every image tower runs under a
``model`` group: the int8 tower and token pruning in the eval step and the
image encoder, and the RN-family tower, which no rule cuts, replicated on
every rank (its gradients, where a step trains it, are whole on each rank
and summed over ``data`` alone).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tapclip_tpu_torch.config import CLIPConfig, PromptConfig, TrainConfig
from tapclip_tpu_torch.models import clip as clip_model
from tapclip_tpu_torch.models.model_wrapper import NEG_INF, full_model_forward
from tapclip_tpu_torch.parallel import collectives


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


def _prograd_project(g_d: List[torch.Tensor], g_g: List[torch.Tensor], lam: float):
    """ProGrad's conflict projection (Zhu et al., ICCV 2023, eq. 4), as the
    JAX package's: over the flat concatenation of the leaves, when the task
    gradient ``g_d`` and the general-knowledge gradient ``g_g`` (of
    KL(zero-shot || tuned)) point against each other, subtract ``lam`` times
    g_d's component along g_g.  A relative guard skips the projection when
    g_g is float noise (``|g_g|^2 <= 1e-12 |g_d|^2``, as at template init).

    ``g_d``, ``g_g``: lists of gradients in the same leaf order.  Returns
    ``(projected list, conflict)`` with ``conflict`` a 0/1 f32 scalar.
    """
    flat_d = torch.cat([g.reshape(-1).float() for g in g_d])
    flat_g = torch.cat([g.reshape(-1).float() for g in g_g])
    dd = flat_d @ flat_d
    gg = flat_g @ flat_g
    dot = flat_d @ flat_g
    conflict = (dot < 0.0) & (gg > 1e-12 * dd)
    coef = torch.where(conflict, dot / gg.clamp_min(1e-30), torch.zeros_like(dot))
    flat = flat_d - lam * coef * flat_g
    out, start = [], 0
    for g in g_d:
        out.append(flat[start:start + g.numel()].reshape(g.shape).to(g.dtype))
        start += g.numel()
    return out, conflict.float()


def make_train_step(
    clip_cfg: CLIPConfig,
    prompt_cfg: PromptConfig,
    optimizer: Optional[Callable] = None,
    trainable_keys: Tuple[str, ...] = ("ctx",),
    use_image_feats: bool = True,
    kg_lambda: float = 0.0,
    kg_feats=None,
    prograd_lambda: float = 0.0,
    anchor_scale: Optional[float] = None,
    scl_lambda: float = 0.0,
    mesh=None,
) -> Callable:
    """Returns ``step(clip_params, state, bank, images_or_feats, labels, mask)
    -> (state, metrics)``; ``metrics`` holds ``loss`` and ``grad_norm``, and
    ``loss_kg``, ``loss_scl``, ``loss_prograd_kl`` and ``prograd_conflict``
    with their terms.

    ``kg_feats [C_max, E]``: the frozen zero-shot class embeddings
    (L2-normalized, padded to the bank width).  ``kg_lambda`` adds
    ``kg_lambda * mean_c(1 - cos(text_feats_c, kg_feats_c))`` over the live
    classes (KgCoOp; image-conditioned, the mean over the batch of each
    sample's term).  ``scl_lambda`` adds ``scl_lambda *
    KL(zero-shot || tuned)`` (PromptSRC's logit term), the zero-shot logits
    taken from the same feature batch at the init-time ``anchor_scale``.
    ``prograd_lambda`` projects the loss gradient away from the KL's where
    they conflict (:func:`_prograd_project`).  The refusals are the JAX
    package's.

    ``optimizer`` is accepted for the JAX package's signature; the optimizer
    itself lives in the state (:func:`init_train_state`).  The step updates
    ``state`` in place and returns it.

    ``mesh``: each rank passes its rows; the metrics are the global batch's
    (the module note).
    """
    _check_mesh(mesh)
    data = None if mesh is None else mesh.data_group
    tp_group = collectives.model_group_of(mesh)
    use_kg, use_prograd, use_scl = kg_lambda > 0.0, prograd_lambda > 0.0, scl_lambda > 0.0
    if use_kg or use_prograd or use_scl:
        if kg_feats is None:
            raise ValueError("kg_lambda/prograd_lambda/scl_lambda > 0 requires kg_feats (the zero-shot anchor)")
        if (use_prograd or use_scl) and not use_image_feats:
            raise ValueError(
                "prograd_lambda/scl_lambda require the cached-feature step (use_image_feats=True): the "
                "zero-shot logits are built from the feature batch"
            )
        if (use_prograd or use_scl) and anchor_scale is None:
            raise ValueError(
                "prograd_lambda/scl_lambda > 0 requires anchor_scale (the INIT-time raw logit_scale): the "
                "zero-shot side must stay frozen even when logit_scale is in trainable_keys"
            )
    keys = tuple(trainable_keys)
    # exp of the init-time scale in f32, as the JAX step takes it
    zs_scale = None if anchor_scale is None else float(np.exp(np.float32(anchor_scale)))
    anchor = {}  # kg_feats as an f32 tensor on the step's device, made on first use

    def anchor_on(dev):
        if dev not in anchor:
            anchor[dev] = _as_tensor(kg_feats, dev, torch.float32)
        return anchor[dev]

    def kl_term(logits, bank, x, mask):
        """KL(zero-shot || tuned) from the tuned logits: the zero-shot side
        is the frozen anchor classifier over the same feature batch at the
        init-time scale, pad classes at the same finite NEG_INF."""
        img = clip_model.l2_normalize(x).float()
        zs = zs_scale * (img @ anchor_on(x.device).T)
        zs = torch.where(bank.class_mask[None, :], zs, torch.full_like(zs, NEG_INF))
        log_zs = torch.log_softmax(zs, dim=-1)
        kl = (log_zs.exp() * (log_zs - torch.log_softmax(logits, dim=-1))).sum(-1)
        if mask is not None:
            m = mask.float()
            return (kl * m).sum() / m.sum().clamp_min(1.0)
        return kl.mean()

    def step(clip_params, state: TrainState, bank, x, labels, mask):
        if state.trainable_keys != keys:
            raise ValueError(f"state trains {state.trainable_keys}, step was made for {keys}")
        dev = _device_of(clip_params)
        x = _as_tensor(x, dev)
        labels = _as_tensor(labels, dev, torch.long)
        mask = None if mask is None else _as_tensor(mask, dev, torch.bool)
        with collectives.tensor_parallel(tp_group):
            out = full_model_forward(
                clip_params, state.params, bank,
                None if use_image_feats else x, labels,
                clip_cfg=clip_cfg, prompt_cfg=prompt_cfg, with_loss=True,
                image_feats=x if use_image_feats else None, batch_mask=mask,
                return_text_feats=use_kg,
            )
        loss = out["loss"]
        metrics = {}
        if use_kg:
            cos = (out["text_feats"].float() * anchor_on(dev)).sum(-1)  # [C], or [B, C] image-conditioned
            cm = bank.class_mask.float()
            # the class-masked mean per sample, then the batch mean: a scalar either way
            metrics["loss_kg"] = (((1.0 - cos) * cm).sum(-1) / cm.sum().clamp_min(1.0)).mean()
            loss = loss + kg_lambda * metrics["loss_kg"]
        if use_scl:
            metrics["loss_scl"] = kl_term(out["logits"], bank, x, mask)
            loss = loss + scl_lambda * metrics["loss_scl"]
        leaves = state.diff_leaves()
        share = None if mesh is None else _global_share(x, mask, data)
        if use_prograd:
            # One forward, two pullbacks of [loss, KL] over the retained graph.
            kl = kl_term(out["logits"], bank, x, mask)
            vals = torch.stack([loss.float(), kl])
            grads = _grads(vals, leaves, vals.new_tensor([1.0, 0.0]), retain_graph=True)
            g_kl = _grads(vals, leaves, vals.new_tensor([0.0, 1.0]))
            if mesh is not None:  # both pullbacks are global before the (nonlinear) projection
                grads, g_kl = _reduced(grads, share, data), _reduced(g_kl, share, data)
            grads, conflict = _prograd_project(grads, g_kl, prograd_lambda)
            metrics.update(loss_prograd_kl=kl, prograd_conflict=conflict)
        else:
            grads = _grads(loss, leaves)
            if mesh is not None:
                grads = _reduced(grads, share, data)
        if mesh is not None:
            loss, metrics = _global_metrics(loss, metrics, share, data)
        grad_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        for p, g in zip(leaves, grads):
            p.grad = g
        state.optimizer.step()
        for p in leaves:
            p.grad = None
        state.step += 1
        metrics.update(loss=loss, grad_norm=grad_norm)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def _check_mesh(mesh) -> None:
    if mesh is not None and mesh.in_process:
        raise ValueError("a train or eval step takes a process-group mesh (make_mesh without devices=)")
    if mesh is not None and mesh.pp > 1:
        raise NotImplementedError("prompt tuning freezes the towers: it runs on the data and model axes, not on a "
                                  "pipe axis (use the sequential tower)")


def _global_share(x, mask, group) -> torch.Tensor:
    """This rank's share of the global batch's count: its (masked) rows over
    the rows summed over ``group`` (f32 scalar; 1 on a one-rank axis)."""
    n = (mask.float().sum() if mask is not None else torch.tensor(float(x.shape[0]), device=x.device))
    total = collectives.all_reduce_(n.detach().clone().reshape(1), group)[0]
    return n / total.clamp_min(1.0)


def _reduced(grads: List[torch.Tensor], share: torch.Tensor, group) -> List[torch.Tensor]:
    """Each rank's gradients of its local mean, weighted by its share and
    summed over ``group``: the gradients of the global-batch mean."""
    out = [g * share.to(g.dtype) for g in grads]
    collectives.all_reduce_many_(out, group)
    return out


def _global_metrics(loss, metrics, share, group):
    """The loss and the per-batch terms as global-batch means (the
    ``prograd_conflict`` flag is already global)."""
    keys = [k for k in ("loss_kg", "loss_scl", "loss_prograd_kl") if k in metrics]
    vals = [(t.detach().float() * share).reshape(1) for t in [loss, *(metrics[k] for k in keys)]]
    collectives.all_reduce_many_(vals, group)
    return vals[0][0], {**metrics, **{k: v[0] for k, v in zip(keys, vals[1:])}}


def _grads(out, leaves, grad_outputs=None, retain_graph: bool = False) -> List[torch.Tensor]:
    """d out / d leaves, zeros for a leaf the output does not reach."""
    grads = torch.autograd.grad(out, leaves, grad_outputs, retain_graph=retain_graph, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def make_eval_step(
    clip_cfg: CLIPConfig,
    prompt_cfg: PromptConfig,
    use_image_feats: bool = True,
    mesh=None,
) -> Callable:
    """Returns ``eval_step(clip_params, trainable, bank, x, labels, mask)`` ->
    per-batch ``correct``/``total`` and per-class counts (padded C_max), run
    under ``torch.inference_mode()``.  ``mesh``: each rank passes its rows;
    the counts are summed over ``data`` (``preds`` stay the rank's)."""
    _check_mesh(mesh)
    tp_group = collectives.model_group_of(mesh)

    def step(clip_params, trainable, bank, x, labels, mask):
        with torch.inference_mode():
            out = _eval(clip_params, trainable, bank, x, labels, mask)
            if mesh is not None:
                counts = [out[k] for k in ("correct", "total", "per_class_correct", "per_class_total")]
                collectives.all_reduce_many_(counts, mesh.data_group)
        return out

    def _eval(clip_params, trainable, bank, x, labels, mask):
        dev = _device_of(clip_params)
        with torch.inference_mode(), collectives.tensor_parallel(tp_group):
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


def make_image_encoder(clip_cfg: CLIPConfig, mesh=None) -> Callable:
    """The frozen image tower, ``encode(clip_params, images)``, under
    ``torch.inference_mode()`` (for feature caching).  ``mesh`` (a
    process-group mesh, as the steps take it): each rank passes its local
    tree and its rows, the tower runs tensor parallel over ``model`` (the
    int8 tower, token pruning and the RN tower included), and each rank
    gets its rows' features."""
    _check_mesh(mesh)
    tp_group = collectives.model_group_of(mesh)

    def encode(clip_params, images):
        with torch.inference_mode(), collectives.tensor_parallel(tp_group):
            return clip_model.encode_image(clip_params, clip_cfg, _as_tensor(images, _device_of(clip_params)))

    return encode


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def encode_dataset_features(clip_params, clip_cfg: CLIPConfig, loader, *, encoder=None):
    """Run the frozen image tower over a loader of ``(images, labels, mask)``
    batches once; returns ``(feats [N, E] f32, labels [N])`` as NumPy arrays
    (bfloat16 features are widened to f32: NumPy has no bfloat16).

    The loader is drained through ``data.prefetch.prefetch_to_device``, as
    in the JAX package: the next batches decode on a thread and copy to the
    device while this one runs the tower.
    """
    from tapclip_tpu_torch.data.prefetch import prefetch_to_device

    encoder = encoder or make_image_encoder(clip_cfg)
    feats, labels = [], []
    for images, lbls, mask in prefetch_to_device(loader, device=_device_of(clip_params)):
        f = encoder(clip_params, images).float().cpu().numpy()
        keep = _host(mask).astype(bool)
        feats.append(f[keep])
        labels.append(_host(lbls)[keep])
    return np.concatenate(feats), np.concatenate(labels)
