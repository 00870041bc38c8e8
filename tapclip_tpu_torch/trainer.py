"""Training engine: epoch loop with best-epoch tracking over cached features.

Counterpart of ``tapclip_tpu/trainer.py`` (the reference's epoch loop,
``train.py:90-128``, and the few-shot fine-tune helper,
``test_cross_domain2.py:17-29``):

* the frozen image tower runs **once** per dataset (features cached, so an
  epoch is text-tower-only, numerically the same as recomputing);
* one train step per batch, AdamW over the context bank only;
* greedy best-state tracking with patience; the attribution entropy is
  logged per epoch.

Batches come in the JAX package's order (``np.random.default_rng(seed +
epoch)``), so both packages see the same batches.  AdamW updates the
trainable tensors in place, so the best state is a copy (:func:`snapshot`),
never an alias of the live ``ctx``.  Resume takes a state restored from a
checkpoint (``utils/checkpoint.py``) or from the JAX package; a restored
``epoch`` continues the epoch numbering, so the shuffle seeds continue
where the interrupted run stopped.  :class:`PathFeatureCache` keys the
frozen tower's features by image path, so the cross-domain grid encodes
each distinct image once.  The zero-shot anchors (KgCoOp / ProGrad /
PromptSRC) are not yet ported.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tapclip_tpu_torch.config import TrainConfig
from tapclip_tpu_torch.models.attribution_monitor import attribution_entropy
from tapclip_tpu_torch.models.model_wrapper import FullModel, text_features_with_attribution
from tapclip_tpu_torch.parallel.train_step import (
    encode_dataset_features,
    init_train_state,
    load_adamw_state,
    make_eval_step,
    make_image_encoder,
    make_optimizer,
    make_train_step,
    snapshot,
)
from tapclip_tpu_torch.utils.logging_utils import StepTimer

log = logging.getLogger("tapclip_tpu_torch")


@dataclasses.dataclass
class CachedSet:
    feats: np.ndarray  # [N, E] unnormalized image-tower features
    labels: np.ndarray  # [N]


def cache_features(model: FullModel, loader, encoder=None) -> CachedSet:
    feats, labels = encode_dataset_features(model.clip_params, model.clip_cfg, loader, encoder=encoder)
    return CachedSet(feats=feats, labels=labels)


def _restore_opt_state(state, restored) -> None:
    """Load a checkpoint's per-leaf AdamW state (``step``, ``exp_avg``,
    ``exp_avg_sq``; empty for a leaf never stepped) into ``state``'s
    optimizer, each moment checked against its trainable leaf's shape, so a
    resume continues the same trajectory."""
    if restored is None:
        return
    leaves = state.diff_leaves()
    for p, st in zip(leaves, restored):
        for key in ("exp_avg", "exp_avg_sq") if st else ():
            if tuple(np.shape(st[key])) != tuple(p.shape):
                raise ValueError(f"optimizer state {key} of shape {tuple(np.shape(st[key]))} "
                                 f"for a leaf of {tuple(p.shape)}")
    load_adamw_state(state.optimizer, leaves, restored)


class PathFeatureCache:
    """Frozen-tower features keyed by image path.

    The cross-domain grid (``test_cross_domain*.py``) evaluates each domain
    under several ``num_shots`` settings whose splits overlap; keyed by path,
    the whole grid costs one image-tower pass per distinct image.
    """

    def __init__(self, model: FullModel, *, batch_size: int = 128, preprocess=None, num_workers: int = 4):
        self.model = model
        self.batch_size = batch_size
        self.preprocess = preprocess
        self.num_workers = num_workers
        self._encoder = make_image_encoder(model.clip_cfg)
        self._feats: Dict[str, np.ndarray] = {}

    def ensure(self, paths) -> None:
        from tapclip_tpu_torch.data.imagefolder import Loader
        from tapclip_tpu_torch.data.prefetch import prefetch_to_device

        missing = [p for p in dict.fromkeys(paths) if p not in self._feats]
        if not missing:
            return
        loader = Loader([(p, 0) for p in missing], self.batch_size, image_size=self.model.clip_cfg.image_size,
                        preprocess=self.preprocess, num_workers=self.num_workers)
        it = iter(missing)
        for images, _, mask in prefetch_to_device(loader, device=self.model.device):
            f = self._encoder(self.model.clip_params, images).float().cpu().numpy()
            for row, ok in zip(f, mask.cpu().numpy()):
                if ok:
                    self._feats[next(it)] = row

    def gather(self, samples) -> CachedSet:
        """``samples``: [(path, label)] -> CachedSet (encoding on demand)."""
        self.ensure([p for p, _ in samples])
        feats = np.stack([self._feats[p] for p, _ in samples])
        labels = np.asarray([lb for _, lb in samples], np.int32)
        return CachedSet(feats=feats, labels=labels)

    def __len__(self) -> int:
        return len(self._feats)


def _batches(cached: CachedSet, batch_size: int, *, shuffle: bool, seed: int):
    """Padded ``(feats, labels, mask)`` NumPy batches, in the JAX package's order."""
    n = len(cached.labels)
    order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        feats = cached.feats[idx]
        labels = cached.labels[idx]
        mask = np.ones(len(idx), bool)
        if len(idx) < batch_size:
            pad = batch_size - len(idx)
            feats = np.concatenate([feats, np.zeros((pad,) + feats.shape[1:], feats.dtype)])
            labels = np.concatenate([labels, np.zeros((pad,), labels.dtype)])
            mask = np.concatenate([mask, np.zeros((pad,), bool)])
        yield feats, labels, mask


def evaluate_cached(model: FullModel, cached: CachedSet, batch_size: int = 256) -> Tuple[float, Dict[int, float]]:
    """(overall %, per-class %) on cached features."""
    eval_step = make_eval_step(model.clip_cfg, model.prompt_cfg)
    correct = total = 0
    C = model.prompt_learner.bank.capacity
    pcc = np.zeros(C, np.int64)
    pct = np.zeros(C, np.int64)
    for feats, labels, mask in _batches(cached, batch_size, shuffle=False, seed=0):
        out = eval_step(model.clip_params, model.trainable, model.prompt_learner.bank, feats, labels, mask)
        correct += int(out["correct"])
        total += int(out["total"])
        pcc += out["per_class_correct"].cpu().numpy()
        pct += out["per_class_total"].cpu().numpy()
    acc = 100.0 * correct / total if total else 0.0
    per_class = {c: (100.0 * pcc[c] / pct[c] if pct[c] else 0.0) for c in range(C) if pct[c]}
    return acc, per_class


@dataclasses.dataclass
class FitResult:
    best_acc: float
    best_trainable: Dict[str, Any]
    acc_history: List[float]
    loss_history: List[float]
    per_class_history: Dict[str, List[float]]
    epochs_run: int
    steps_per_sec: float = float("nan")
    final_state: Any = None  # TrainState (params + optimizer) for resume
    attr_entropy: List[float] = dataclasses.field(default_factory=list)
    val_cache: Any = None


def fit_prompt_model(
    model: FullModel,
    train_loader,
    val_loader,
    train_cfg: TrainConfig,
    *,
    epochs: Optional[int] = None,
    eval_every: int = 1,
    track_best: bool = True,
    verbose: bool = True,
    resume_state=None,
    checkpoint_cb: Optional[Callable] = None,
    checkpoint_every: int = 0,
    trainable_keys: Optional[Tuple[str, ...]] = None,
) -> FitResult:
    """The reference train loop over cached features.

    ``train_loader`` / ``val_loader``: loaders of ``(images, labels, mask)``
    or :class:`CachedSet` s.  ``resume_state``: ``{"trainable", "opt_state",
    "step"[, "epoch"]}`` for an exact mid-training resume, with ``opt_state``
    the per-leaf AdamW moments (``TrainState.opt_state()``, or
    ``utils.jax_bridge.adamw_state_from_optax`` of a JAX state).  With
    ``epoch`` (the last epoch the interrupted run finished), the ``epochs``
    run here are numbered from ``epoch + 1``, and so seeded: the shuffle
    continues the interrupted run's sequence.
    ``checkpoint_cb(epoch, state, epoch_acc)`` runs every ``checkpoint_every``
    epochs and on early stop.
    """
    epochs = epochs if epochs is not None else train_cfg.epochs
    trainable_keys = ("ctx",) if trainable_keys is None else tuple(trainable_keys)
    missing = [k for k in trainable_keys if k not in model.trainable]
    if missing:
        raise ValueError(
            f"trainable_keys {missing} not in model.trainable (have {sorted(model.trainable)})"
        )
    # Built before the feature-caching pass, so unported options fail fast.
    optimizer = make_optimizer(train_cfg)
    step_fn = make_train_step(
        model.clip_cfg, model.prompt_cfg, optimizer, trainable_keys=trainable_keys,
        kg_lambda=train_cfg.kg_lambda, prograd_lambda=train_cfg.prograd_lambda,
        scl_lambda=train_cfg.scl_lambda,
    )
    encoder = make_image_encoder(model.clip_cfg)
    train_cache = (
        train_loader if isinstance(train_loader, CachedSet) else cache_features(model, train_loader, encoder)
    )
    val_cache = (
        val_loader
        if isinstance(val_loader, CachedSet)
        else (cache_features(model, val_loader, encoder) if val_loader else None)
    )

    first_epoch = 1
    if resume_state is not None:
        state = init_train_state(
            snapshot(dict(resume_state["trainable"]), model.device), optimizer, trainable_keys,
            step=int(resume_state.get("step", 0)),
        )
        _restore_opt_state(state, resume_state.get("opt_state"))
        first_epoch = int(resume_state.get("epoch", 0)) + 1
    else:
        state = init_train_state(model.trainable, optimizer, trainable_keys)
    model.trainable = state.params
    bank = model.prompt_learner.bank
    clip_params = model.clip_params
    n_cls = model.n_cls

    def attr_entropy() -> float:
        with torch.inference_mode():
            _, attribution = text_features_with_attribution(
                clip_params, state.params["ctx"], bank, model.clip_cfg, model.prompt_cfg,
                state.params["adjustor"],
            )
            return float(attribution_entropy(attribution[:n_cls]))

    best_acc = 0.0
    best_trainable = snapshot(model.trainable)
    patience_ctr = 0
    acc_hist: List[float] = []
    loss_hist: List[float] = []
    ent_hist: List[float] = []
    per_class_hist: Dict[str, List[float]] = {n: [] for n in model.class_names}
    timer = StepTimer(warmup=1)
    n_steps = 0

    for epoch in range(first_epoch, first_epoch + epochs):
        epoch_loss, n_batches = 0.0, 0
        for feats, labels, mask in _batches(
            train_cache, train_cfg.batch_size, shuffle=True, seed=train_cfg.seed + epoch
        ):
            timer.tic()
            state, metrics = step_fn(clip_params, state, bank, feats, labels, mask)
            epoch_loss += float(metrics["loss"])  # synchronises with the device
            timer.toc(int(mask.sum()))
            n_batches += 1
            n_steps += 1
        avg_loss = epoch_loss / max(n_batches, 1)
        loss_hist.append(avg_loss)
        ent_hist.append(attr_entropy())
        epoch_acc = None
        stop = False
        if val_cache is not None and epoch % eval_every == 0:
            acc, per_class = evaluate_cached(model, val_cache)
            epoch_acc = acc
            acc_hist.append(acc)
            for i, name in enumerate(model.class_names):
                per_class_hist[name].append(per_class.get(i, 0.0))
            if verbose:
                log.info("[Epoch %d] \U0001f3cb️ Avg Train Loss: %.4f", epoch, avg_loss)
                log.info("[Epoch %d] \U0001f9ea Val Accuracy: %.2f%%", epoch, acc)
                log.info("[Epoch %d] \U0001f4ca Per-Class Accuracy: %s", epoch,
                         {n: per_class.get(i, 0.0) for i, n in enumerate(model.class_names)})
                log.info("[Epoch %d] attr entropy: %.4f", epoch, ent_hist[-1])
            if track_best:
                if acc > best_acc:
                    best_acc = acc
                    best_trainable = snapshot(model.trainable)
                    patience_ctr = 0
                else:
                    patience_ctr += 1
                    if patience_ctr == train_cfg.patience:
                        stop = True
        elif verbose:
            log.info("[Epoch %d] \U0001f3cb️ Avg Train Loss: %.4f", epoch, avg_loss)

        if checkpoint_cb is not None and checkpoint_every > 0 and (epoch % checkpoint_every == 0 or stop):
            checkpoint_cb(epoch, state, epoch_acc)
        if stop:
            break

    if not track_best or val_cache is None:
        best_trainable = snapshot(model.trainable)
        best_acc = acc_hist[-1] if acc_hist else 0.0
    return FitResult(
        best_acc=best_acc,
        best_trainable=best_trainable,
        acc_history=acc_hist,
        loss_history=loss_hist,
        per_class_history=per_class_hist,
        epochs_run=len(loss_hist),
        steps_per_sec=1.0 / timer.mean_step_s if n_steps > 2 else float("nan"),
        final_state=state,
        attr_entropy=ent_hist,
        val_cache=val_cache,
    )


def fine_tune_on_few_shot(model: FullModel, loader, *, steps: int = 10, lr: float = 5e-3) -> FitResult:
    """``test_cross_domain2.py:17-29``: N full passes over the few-shot
    loader, AdamW over the context bank only; no early stopping, no best
    tracking."""
    cfg = TrainConfig(lr=lr, epochs=steps, patience=steps + 1)
    return fit_prompt_model(model, loader, None, cfg, epochs=steps, track_best=False, verbose=False)
