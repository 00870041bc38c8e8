"""Prompt checkpoints as torch ``.pt`` files, and the reference's ``.pt`` layouts.

Counterpart of ``tapclip_tpu/utils/checkpoint.py``.  The JAX package writes
Orbax directories; the port writes one torch file per checkpoint, read back
with ``torch.load(weights_only=True)``:

    {"format": "tapclip_tpu_torch.prompt_checkpoint",
     "trainable": {"ctx", "adjustor", "logit_scale"[, "meta_net"][, "maple"]},  # tensors
     "bank": {"ctx", "token_embs", "class_mask", "eot_pos"},
     "opt_state": [{"step", "exp_avg", "exp_avg_sq"}, ...],  # when given
     "meta": {"class_names", "step", ...extras}}          # the JSON fields

``opt_state`` is torch's AdamW state per trainable leaf, as
``TrainState.opt_state()`` returns it, so a resume continues the same
trajectory.  :func:`load_any_prompt_checkpoint` also reads the reference's
``.pt`` (legacy stacked ``context_emb`` and per-class ``context_bank``),
the interchange format with the JAX package; an Orbax directory raises.

Pretraining's trees (``pretrain_cli``; the JAX package writes Orbax
directories) are ``.pt`` files too:

    {"format": "tapclip_tpu_torch.clip_tree",
     "config": CLIPConfig as JSON,
     "params": the whole tree (lists for the block stacks, an MoE block's
               expert bank and router included; ``visual.vpt`` and
               ``logit_bias`` when present, ``kd_proj`` stripped, LoRA merged)}

loaded only under a config of the same geometry (an MoE tree under a
dense config, or the reverse, raises);

which ``utils.torch_convert.load_openclip_checkpoint`` reads wherever an
open_clip state dict is taken (``--pretrained`` of every driver, ``serve
/reload``, ``--distill-teacher``), and the ``--save-every`` snapshot

    {"format": "tapclip_tpu_torch.pretrain_snapshot",
     "params": the tree (or the LoRA adapter tree), "lora": bool,
     "opt_state": PretrainOptimizer.state_dict(), "epoch", "gstep"}

and ``--sharded-snapshot``'s directory (the JAX package's names:
:func:`save_sharded_snapshot`, :func:`snapshot_format`,
:func:`abstract_target`, :func:`snapshot_saved_target`,
:func:`restore_sharded_snapshot`; the format is the port's own, since the
port reads no Orbax directory):

    manifest.json   {"format": "tapclip_tpu_torch.sharded_snapshot", "mesh":
                     {"data", "pipe", "model"}, "fsdp", "lora", "epoch",
                     "gstep", "blocks": {tower: layers}, "leaves": {whole
                     path: {"local", "shape", "dtype", "spec"}}, "moments":
                     [whole paths], "acc": bool}
    rank{r}.pt      {"format", "rank", "params": {local path: this rank's
                     shard}, "opt_state": its PretrainOptimizer.state_dict()}

Every rank writes its own shards, nothing gathered: the directory is
written under a temporary name and renamed by rank 0 after a barrier.  A
resume on any ``(dp, pp, tp, fsdp)`` rebuilds one leaf at a time on the
host from the saved pieces (``torch.load(mmap=True)``, the cut's exact
inverse, ``parallel.sharding.join_leaf``) and cuts it with the live spec, so
no rank holds the whole tree.  Optimizer moments are matched to the trained
leaves by key path (the JAX CLI matches them by order); where any key or
shape differs, the params resume with fresh moments.
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
CLIP_TREE_FORMAT = "tapclip_tpu_torch.clip_tree"
SNAPSHOT_FORMAT = "tapclip_tpu_torch.pretrain_snapshot"
SHARDED_FORMAT = "tapclip_tpu_torch.sharded_snapshot"
MANIFEST = "manifest.json"
# The fields a saved tree's shapes depend on: a load under a config that
# differs in one of them raises.
_GEOMETRY = ("vision_tower", "image_size", "patch_size", "vision_width", "vision_layers", "resnet_layers",
             "text_width", "text_layers", "embed_dim", "vocab_size", "context_length", "mlp_ratio", "moe_experts")


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
    ``model.trainable``, ``logit_scale`` when present, and CoCoOp's
    ``meta_net`` and MaPLe's ``maple`` subtrees from the port's own file
    (their shapes checked against the model's).  The JAX package's loader
    drops ``meta_net``, so a CoCoOp checkpoint served there runs
    unconditioned; the port carries it.  A legacy stacked reference file is
    split over ``seen_class_names`` (default: the model's classes).  Returns
    what was read."""
    names = list(model.class_names if seen_class_names is None else seen_class_names)
    tree = load_any_prompt_checkpoint(path, names)
    model.prompt_learner.load_ctx(tree["ctx_by_name"])
    model.trainable = dict(model.trainable, ctx=model.prompt_learner.bank.ctx.clone())
    if tree.get("logit_scale") is not None and np.size(tree["logit_scale"]):
        model.trainable = dict(model.trainable, logit_scale=torch.as_tensor(
            np.asarray(tree["logit_scale"], np.float32), device=model.device).reshape(()))
    def shapes(t):
        return None if t is None else {k: tuple(v.shape) for k, v in t.items()}

    for key, what in (("meta_net", "CoCoOp meta-net"), ("maple", "MaPLe")):
        sub = (tree.get("trainable") or {}).get(key)
        if sub is None:
            continue
        if shapes(sub) != shapes(model.trainable.get(key)):
            raise ValueError(f"{path}: a {what} subtree of shapes {shapes(sub)} for a model with "
                             f"{shapes(model.trainable.get(key))}")
        model.trainable = dict(model.trainable, **{key: {k: v.float().to(model.device) for k, v in sub.items()}})
    return tree


def save_clip_tree(path: str, params: Dict[str, Any], cfg) -> str:
    """Write a whole CLIP tree and its config to ``path`` (a ``.pt``)."""
    import dataclasses

    obj = {"format": CLIP_TREE_FORMAT, "config": json.dumps(dataclasses.asdict(cfg)), "params": _cpu(params)}
    return _write(obj, path)


def clip_tree_from(obj: Dict[str, Any], cfg, device="cpu", path: str = "") -> Dict[str, Any]:
    """The tree of a loaded :func:`save_clip_tree` file on ``device``, after
    checking its config's geometry against ``cfg``."""
    saved = json.loads(obj["config"])
    moe_saved = saved.get("moe_experts", 0)
    if bool(moe_saved) != bool(cfg.moe_experts):
        kind = f"an MoE tree ({moe_saved} experts a block)" if moe_saved else "a dense tree (one MLP a block)"
        raise ValueError(f"{path}: {kind} does not fit {cfg.name} with moe_experts={cfg.moe_experts}; load it "
                         f"with moe_experts={moe_saved}")
    for field in _GEOMETRY:
        want = getattr(cfg, field)
        got = saved.get(field)
        if (list(got) if isinstance(got, (list, tuple)) else got) != (list(want) if isinstance(want, tuple)
                                                                     else want):
            raise ValueError(f"{path}: a tree saved for {saved.get('name')} ({field}={got}) does not fit "
                             f"{cfg.name} ({field}={want})")

    def move(t):
        if isinstance(t, dict):
            return {k: move(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [move(v) for v in t]
        return t.to(device=device, dtype=torch.float32)

    return move(obj["params"])


def load_clip_tree(path: str, cfg, device="cpu") -> Dict[str, Any]:
    """Read a :func:`save_clip_tree` file for ``cfg`` onto ``device``."""
    if os.path.isdir(path):
        raise _orbax_refused(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(obj, dict) and obj.get("format") == CLIP_TREE_FORMAT):
        raise ValueError(f"{path} is not a tapclip_tpu_torch CLIP tree")
    return clip_tree_from(obj, cfg, device, path)


def save_pretrain_snapshot(path: str, *, params: Dict[str, Any], opt_state: Dict[str, Any], epoch: int,
                           gstep: int, lora: bool = False) -> str:
    """Write a pretraining snapshot: the tree (or the LoRA adapters),
    ``PretrainOptimizer.state_dict()``, the epoch and the step counter."""
    obj = {"format": SNAPSHOT_FORMAT, "params": _cpu(params), "lora": bool(lora), "opt_state": _cpu(opt_state),
           "epoch": int(epoch), "gstep": int(gstep)}
    return _write(obj, path)


def restore_pretrain_snapshot(path: str) -> Dict[str, Any]:
    """Read a :func:`save_pretrain_snapshot` file (on the CPU)."""
    if os.path.isdir(path):
        raise _orbax_refused(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(obj, dict) and obj.get("format") == SNAPSHOT_FORMAT):
        raise ValueError(f"{path} is not a tapclip_tpu_torch pretraining snapshot")
    return obj


# --- the sharded snapshot (--sharded-snapshot) -------------------------------------------------------


def _mesh_shape(mesh) -> Dict[str, int]:
    return {"data": 1, "pipe": 1, "model": 1} if mesh is None else {"data": mesh.dp, "pipe": mesh.pp,
                                                                     "model": mesh.tp}


def abstract_target(tree: Dict[str, Any], mesh=None, fsdp: bool = False,
                    replicated: bool = False) -> Dict[str, Dict[str, Any]]:
    """A rank's live tree as a restore target: ``{local path: {"path": the
    whole tree's path, "shape": the whole leaf's shape, "dtype", "spec": the
    spec it is cut with}}`` (``replicated``: every leaf whole on every rank,
    as LoRA's adapters; ``mesh`` None: one process)."""
    from tapclip_tpu_torch.parallel import sharding
    from tapclip_tpu_torch.pretrain import named_leaves

    shape = _mesh_shape(mesh)
    n_local = sharding._n_local_blocks(tree)
    out = {}
    for path, t in named_leaves(tree):
        spec = () if mesh is None or replicated else sharding.leaf_spec(path, t, mesh, fsdp)
        loc = sharding.local_spec(path, spec)
        whole = list(t.shape)
        for axis in ("model", "data"):
            if axis in loc:
                whole[loc.index(axis)] *= shape[axis]
        out[path] = {"path": path if mesh is None else sharding._global_block_path(path, mesh, n_local),
                     "shape": whole, "dtype": str(t.dtype).replace("torch.", ""), "spec": list(spec)}
    return out


def save_sharded_snapshot(path: str, *, params: Dict[str, Any], opt_state: Dict[str, Any], epoch: int, gstep: int,
                          mesh=None, fsdp: bool = False, lora: bool = False) -> str:
    """Every rank of ``mesh`` (a collective; ``None``: one process) writes
    its local ``params`` (or LoRA tree, ``lora``: replicated) and its
    ``PretrainOptimizer.state_dict()`` into ``path``, a directory, beside
    the manifest rank 0 writes.  Written under ``path + ".tmp"`` and renamed
    into place by rank 0 after a barrier; returns when every rank sees it."""
    import shutil

    import torch.distributed as dist

    from tapclip_tpu_torch.pretrain import named_leaves

    path = os.path.abspath(path)
    tmp = path + ".tmp"
    rank = 0 if mesh is None else mesh.rank

    def barrier():
        if mesh is not None:
            dist.barrier()

    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    barrier()
    target = abstract_target(params, mesh, fsdp, replicated=lora)
    torch.save({"format": SHARDED_FORMAT, "rank": rank, "params": {p: _cpu(t) for p, t in named_leaves(params)},
                "opt_state": _cpu(opt_state)}, os.path.join(tmp, f"rank{rank}.pt"))
    entries = {e["path"]: {"local": p, **{k: e[k] for k in ("shape", "dtype", "spec")}} for p, e in target.items()}
    moments = sorted(target[p]["path"] for p in opt_state["moments"])
    if mesh is not None and mesh.pp > 1:  # every stage's blocks
        parts = [None] * mesh.world
        dist.all_gather_object(parts, (entries, moments))
        entries = {k: v for e, _ in parts for k, v in e.items()}
        moments = sorted({m for _, ms in parts for m in ms})
    if rank == 0:
        from tapclip_tpu_torch.parallel.sharding import _n_local_blocks

        blocks = {k: v * _mesh_shape(mesh)["pipe"] for k, v in _n_local_blocks(params).items()}
        manifest = {"format": SHARDED_FORMAT, "mesh": _mesh_shape(mesh), "fsdp": bool(fsdp), "lora": bool(lora),
                    "epoch": int(epoch), "gstep": int(gstep), "blocks": blocks, "leaves": entries,
                    "moments": moments, "acc": opt_state.get("acc") is not None}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
    barrier()
    if rank == 0:
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    barrier()
    return path


def snapshot_format(path: str) -> Optional[str]:
    """Which save path wrote the snapshot at ``path``: ``"sharded"`` for a
    :func:`save_sharded_snapshot` directory, ``"host"`` for a
    :func:`save_pretrain_snapshot` file, None for anything else."""
    if os.path.isdir(path):
        try:
            with open(os.path.join(path, MANIFEST)) as f:
                return "sharded" if json.load(f).get("format") == SHARDED_FORMAT else None
        except (OSError, ValueError):
            return None
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except Exception:
        return None
    return "host" if isinstance(obj, dict) and obj.get("format") == SNAPSHOT_FORMAT else None


def snapshot_saved_target(path: str) -> Dict[str, Any]:
    """The snapshot's own structure: its manifest (the saving mesh, each
    leaf's whole path, shape, dtype and spec, the moments' paths)."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != SHARDED_FORMAT:
        raise ValueError(f"{path} is not a tapclip_tpu_torch sharded snapshot")
    return manifest


class SnapshotMismatch(ValueError):
    """A sharded snapshot whose params tree is not the live one."""


def restore_sharded_snapshot(path: str, target: Dict[str, Dict[str, Any]], mesh=None, *, fsdp: bool = False,
                             trained: Sequence[str] = ()) -> Dict[str, Any]:
    """Restore a :func:`save_sharded_snapshot` directory into ``target``'s
    layout (:func:`abstract_target` of this rank's live tree, on ``mesh``
    with ``fsdp``): ``{"params": {local path: this rank's shard}, "opt_state":
    a PretrainOptimizer.state_dict() over the local paths ``trained`` or
    None, "moments": (saved, live) counts, "epoch", "gstep"}``.  Each leaf is
    rebuilt whole from the saved pieces, one at a time, and cut with the
    live spec, whatever topology saved it.  The moments come back only when
    the saved ones and ``trained`` match by key path and shape; otherwise
    ``opt_state`` is None (fresh moments).  A params tree that differs
    raises :class:`SnapshotMismatch`."""
    from tapclip_tpu_torch.parallel.sharding import join_leaf, local_spec, shard_leaf

    manifest = snapshot_saved_target(path)
    saved, shape = manifest["leaves"], manifest["mesh"]
    live = {e["path"]: (p, e) for p, e in target.items()}
    missing, extra = sorted(set(live) - set(saved)), sorted(set(saved) - set(live))
    wrong = sorted(k for k in set(live) & set(saved) if list(saved[k]["shape"]) != list(live[k][1]["shape"]))
    if missing or extra or wrong:
        raise SnapshotMismatch(f"{path}: the snapshot's params tree is not this run's ({len(missing)} leaves "
                               f"missing, e.g. {missing[:2]}; {len(extra)} not in this run, e.g. {extra[:2]}; "
                               f"{len(wrong)} of another shape, e.g. {wrong[:2]})")
    dp, pp, tp = shape["data"], shape["pipe"], shape["model"]
    grid = np.arange(dp * pp * tp).reshape(dp, pp, tp)
    files: Dict[int, Any] = {}

    def saved_rank(r):
        if r not in files:
            files[r] = torch.load(os.path.join(path, f"rank{r}.pt"), map_location="cpu", weights_only=True,
                                  mmap=True)
        return files[r]

    def place(whole_path):  # (stage, the stage's own path) of a leaf on the saving mesh
        parts = whole_path.split("/")
        if pp > 1 and len(parts) > 2 and parts[1] == "blocks":
            per = manifest["blocks"][parts[0]] // pp
            s, parts[2] = divmod(int(parts[2]), per)
            parts[2] = str(parts[2])
            return s, "/".join(parts)
        return 0, whole_path

    def whole(whole_path, read):
        """The whole leaf ``whole_path`` from ``read(rank file, local path)``."""
        spec = tuple(saved[whole_path]["spec"])
        loc = local_spec(whole_path, spec)
        s, local_path = place(whole_path)
        ds = range(dp) if manifest["fsdp"] and "data" in loc else [0]
        js = range(tp) if "model" in loc else [0]
        return join_leaf(whole_path, [[read(saved_rank(int(grid[d, s, j])), local_path) for j in js] for d in ds],
                         spec)

    shape_live = _mesh_shape(mesh)
    n, j = shape_live["model"], (0 if mesh is None else mesh.model_index)
    dn, di = (shape_live["data"], mesh.data_index) if fsdp and mesh is not None else (1, 0)

    def cut(local_path, t):
        return shard_leaf(local_path, t, tuple(target[local_path]["spec"]), n, j, dn, di)

    params = {p: cut(p, whole(k, lambda f, lp: f["params"][lp])) for k, (p, _) in live.items()}
    trained_whole = {target[p]["path"]: p for p in trained}
    counts = (len(manifest["moments"]), len(trained_whole))
    opt_state = None
    if trained_whole and sorted(trained_whole) == manifest["moments"]:
        head = saved_rank(0)["opt_state"]
        moments = {}
        for k, p in trained_whole.items():
            s, lp = place(k)
            moments[p] = {"step": float(saved_rank(int(grid[0, s, 0]))["opt_state"]["moments"][lp]["step"]),
                          **{key: cut(p, whole(k, lambda f, lp, key=key: f["opt_state"]["moments"][lp][key]))
                             for key in ("exp_avg", "exp_avg_sq")}}
        acc = None
        if manifest["acc"]:
            acc = {p: cut(p, whole(k, lambda f, lp: f["opt_state"]["acc"][lp])) for k, p in trained_whole.items()}
        opt_state = {"count": int(head["count"]), "mini_step": int(head["mini_step"]), "moments": moments,
                     "acc": acc}
    return {"params": params, "opt_state": opt_state, "moments": counts, "epoch": int(manifest["epoch"]),
            "gstep": int(manifest["gstep"])}


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
