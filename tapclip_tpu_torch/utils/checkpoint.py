"""Prompt checkpoints as torch ``.pt`` files, and the reference's ``.pt`` layouts.

Counterpart of ``tapclip_tpu/utils/checkpoint.py``.  The JAX package writes
Orbax directories; the port writes one torch file per checkpoint, read back
with ``torch.load(weights_only=True)``:

    {"format": "tapclip_tpu_torch.prompt_checkpoint",
     "trainable": {"ctx", "adjustor", "logit_scale"},   # tensors
     "bank": {"ctx", "token_embs", "class_mask", "eot_pos"},
     "opt_state": [{"step", "exp_avg", "exp_avg_sq"}, ...],  # when given
     "meta": {"class_names", "step", ...extras}}          # the JSON fields

``opt_state`` is torch's AdamW state per trainable leaf, as
``TrainState.opt_state()`` returns it, so a resume continues the same
trajectory.  :func:`load_any_prompt_checkpoint` also reads the reference's
``.pt`` (legacy stacked ``context_emb`` and per-class ``context_bank``),
the interchange format with the JAX package; an Orbax directory raises.
Sharded snapshots wait for ``parallel/``.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

FORMAT = "tapclip_tpu_torch.prompt_checkpoint"


def _cpu(tree):
    """A detached CPU copy of a tree of tensors (never an alias of a live
    tensor the optimizer updates in place)."""
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu(v) for v in tree]
    if torch.is_tensor(tree):
        return tree.detach().clone().cpu()
    return tree


def bank_as_dict(bank) -> Optional[Dict[str, torch.Tensor]]:
    if bank is None or isinstance(bank, dict):
        return _cpu(bank)
    return _cpu({"ctx": bank.ctx, "token_embs": bank.token_embs, "class_mask": bank.class_mask,
                 "eot_pos": bank.eot_pos})


def bank_from_dict(d: Dict[str, Any], device="cpu"):
    from tapclip_tpu_torch.models.prompt_learner import PromptBank

    def t(key, dtype):
        return torch.as_tensor(d[key], dtype=dtype).to(device)

    return PromptBank(ctx=t("ctx", torch.float32), token_embs=t("token_embs", torch.float32),
                      class_mask=t("class_mask", torch.bool), eot_pos=t("eot_pos", torch.int32))


def _orbax_refused(path: str) -> ValueError:
    return ValueError(
        f"{path} is a directory: Orbax checkpoints (the JAX package's format) are not read by "
        "tapclip_tpu_torch; export the prompts with the JAX package's "
        "save_reference_prompt_checkpoint (a reference .pt) instead"
    )


def _write(obj: Dict[str, Any], path: str) -> str:
    """``torch.save`` into a temporary file beside ``path``, renamed into place."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=os.path.dirname(path))
    os.close(fd)
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def _checkpoint(trainable, bank, class_names, opt_state, step, meta) -> Dict[str, Any]:
    obj = {
        "format": FORMAT,
        "trainable": _cpu(dict(trainable)),
        "bank": bank_as_dict(bank),
        # JSON round trip: the fields stay what the JAX package's meta file holds.
        "meta": json.loads(json.dumps({"class_names": list(class_names), "step": int(step), **(meta or {})})),
    }
    if opt_state is not None:
        obj["opt_state"] = _cpu(list(opt_state))
    return obj


def save_prompt_checkpoint(
    path: str,
    *,
    trainable: Dict[str, Any],
    bank,
    class_names: Sequence[str],
    opt_state: Optional[Sequence[Dict[str, Any]]] = None,
    step: int = 0,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a checkpoint file at ``path``; returns its absolute path."""
    return _write(_checkpoint(trainable, bank, class_names, opt_state, step, extra_meta), path)


def restore_prompt_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint file -> ``{"trainable", "bank", "meta"[, "opt_state"]}``."""
    if os.path.isdir(path):
        raise _orbax_refused(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(obj, dict) and obj.get("format") == FORMAT):
        raise ValueError(f"{path} is not a tapclip_tpu_torch prompt checkpoint")
    return obj


def load_any_prompt_checkpoint(path: str, seen_class_names: Sequence[str]) -> Dict[str, Any]:
    """Read the port's checkpoint or a reference ``.pt``.

    Returns a dict with at least ``ctx_by_name`` ({class: [P, D] f32 array})
    and ``meta``; ``logit_scale`` when the file has one; ``trainable`` and
    ``bank`` for the port's own files.
    """
    if os.path.isdir(path):
        raise _orbax_refused(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and obj.get("format") == FORMAT:
        names = obj["meta"].get("class_names", list(seen_class_names))
        ctx = obj["trainable"]["ctx"].float().numpy()
        return {
            "ctx_by_name": {n: ctx[i] for i, n in enumerate(names)},
            "logit_scale": obj["trainable"]["logit_scale"].float().numpy(),
            "meta": obj["meta"],
            "trainable": obj["trainable"],
            "bank": obj.get("bank"),
        }
    from tapclip_tpu_torch.utils.torch_convert import convert_prompt_state_dict

    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    ctx_by_name, extras = convert_prompt_state_dict(obj, seen_class_names)
    out: Dict[str, Any] = {"ctx_by_name": ctx_by_name, "meta": {}}
    out.update(extras)
    return out


def apply_prompt_checkpoint(model, path: str, seen_class_names: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Load a prompt checkpoint into a live ``FullModel``: context vectors by
    class name (unseen names grow the bank), the trained ctx synced into
    ``model.trainable``, ``logit_scale`` when present.  A legacy stacked
    reference file is split over ``seen_class_names`` (default: the model's
    classes).  Returns what was read."""
    names = list(model.class_names if seen_class_names is None else seen_class_names)
    tree = load_any_prompt_checkpoint(path, names)
    model.prompt_learner.load_ctx(tree["ctx_by_name"])
    model.trainable = dict(model.trainable, ctx=model.prompt_learner.bank.ctx.clone())
    if tree.get("logit_scale") is not None and np.size(tree["logit_scale"]):
        model.trainable = dict(model.trainable, logit_scale=torch.as_tensor(
            np.asarray(tree["logit_scale"], np.float32), device=model.device).reshape(()))
    return tree


class CheckpointManager:
    """Retention and asynchronous writes over :func:`save_prompt_checkpoint`.

    * ``keep_last_n`` — the most recent checkpoints kept (resume safety).
    * ``keep_best_n`` — the best by ``metric`` kept too (``mode='max'`` for
      accuracy, ``'min'`` for loss); a checkpoint in both sets is stored once.
    * ``async_save=True`` — the write and the retention sweep run on one
      background thread; the tensors are copied to the host before the write
      is queued, so the optimizer may update them at once.  Call
      :meth:`wait` (or use the manager as a context manager) before reading.

    Checkpoints are ``step_{step:08d}.pt`` files in ``directory``;
    ``manager_index.json`` lists them, so a later manager over the same
    directory knows them.  Only checkpoints the manager recorded are deleted.
    """

    _INDEX = "manager_index.json"

    def __init__(self, directory: str, *, keep_last_n: int = 2, keep_best_n: int = 0, mode: str = "max",
                 async_save: bool = False):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.directory = os.path.abspath(directory)
        self.keep_last_n = keep_last_n
        self.keep_best_n = keep_best_n
        self.mode = mode
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        self._records = []  # [(step, path, metric-or-None)] in save order
        self._known = set()  # every path this manager has recorded
        self._load_index()
        self._pool = None
        self._pending = []
        if async_save:
            import concurrent.futures

            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-mgr")

    def save(self, *, step: int, trainable: Dict[str, Any], bank, class_names: Sequence[str],
             opt_state=None, metric: Optional[float] = None, extra_meta: Optional[Dict[str, Any]] = None) -> str:
        """Queue (or perform) a checkpoint write; returns its path."""
        path = os.path.join(self.directory, f"step_{step:08d}.pt")
        meta = dict(extra_meta or {})
        if metric is not None:
            meta["metric"] = float(metric)
        obj = _checkpoint(trainable, bank, class_names, opt_state, step, meta)  # host copy up front
        with self._lock:
            self._records.append((int(step), path, None if metric is None else float(metric)))
            self._known.add(path)
        if self._pool is None:
            self._write_and_sweep(obj, path)
        else:
            self._pending.append(self._pool.submit(self._write_and_sweep, obj, path))
        return path

    def wait(self) -> None:
        """Block until every queued save (and retention sweep) completed."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()  # re-raises the worker's exception

    def close(self) -> None:
        self.wait()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def latest_path(self) -> Optional[str]:
        kept = self._kept()
        recs = [r for r in self._records if r[1] in kept]
        return max(recs, key=lambda r: r[0])[1] if recs else None

    @property
    def best_path(self) -> Optional[str]:
        scored = [r for r in self._records if r[2] is not None]
        if not scored:
            return None
        pick = max if self.mode == "max" else min
        return pick(scored, key=lambda r: r[2])[1]

    def all_paths(self):
        return [r[1] for r in self._records if r[1] in self._kept()]

    def _kept(self):
        by_step = sorted(self._records, key=lambda r: r[0])
        last = {r[1] for r in by_step[-self.keep_last_n:]} if self.keep_last_n > 0 else set()
        scored = sorted((r for r in self._records if r[2] is not None), key=lambda r: r[2],
                        reverse=self.mode == "max")
        return last | {r[1] for r in scored[: self.keep_best_n]}

    def _write_and_sweep(self, obj, path):
        _write(obj, path)
        with self._lock:
            keep = self._kept()
            self._records = [r for r in self._records if r[1] in keep]
            known = set(self._known)
        for p in known - keep:
            if os.path.isfile(p):
                os.remove(p)
        with open(os.path.join(self.directory, self._INDEX), "w") as f:
            json.dump([{"step": s, "path": p, "metric": m} for s, p, m in self._records], f)

    def _load_index(self):
        idx = os.path.join(self.directory, self._INDEX)
        if os.path.exists(idx):
            with open(idx) as f:
                self._records = [(r["step"], r["path"], r.get("metric")) for r in json.load(f)
                                 if os.path.isfile(r["path"])]
            self._known.update(r[1] for r in self._records)
