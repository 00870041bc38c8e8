"""Sharding rules: a leaf's path -> its spec, and the placement that follows.

Counterpart of ``tapclip_tpu/parallel/sharding.py``.  :func:`_spec_for_path`
is the JAX package's rule, whole (the pipe, FSDP and ``/moe/`` branches
included), with specs as data: tuples such as ``(None, None, "model")`` in
place of ``PartitionSpec`` s.  The rules speak of the JAX package's stacked
leaves (``[L, ...]`` with the layer axis first); the port keeps a list of
blocks, so :func:`clip_param_specs` maps ``visual/blocks/3/attn/w_qkv`` to
the stacked path and gives its spec, and :func:`local_spec` drops the layer
entry when a block leaf is placed.

Placement (:func:`shard_params`, :func:`shard_opt_state`, :func:`replicate`,
:func:`shard_batch`) covers the ``data`` and ``model`` axes: each rank keeps
its local shard as a plain tensor.  The Megatron cut on ``model``:

* ``attn/w_qkv [W, 3W]`` and ``attn/b_qkv [3W]`` are cut **per head**: the
  rank holds the q, k and v columns of its own heads, ``[W, 3W/tp]`` laid out
  ``[q_j | k_j | v_j]``, so its attention runs on local heads.  (GSPMD can
  cut the 3W columns contiguously because XLA reshards as it needs; a rank
  that computes locally cannot.)
* ``attn/w_out [W, W]``: the rows of its heads.
* ``mlp/w_fc [W, H]``, ``mlp/b_fc [H]``: its hidden columns; ``mlp/w_proj
  [H, W]``: the matching rows.
* everything else (embeddings, LayerNorms, the output biases, projections):
  replicated.

:func:`gather_params` is the inverse, bit for bit: the checkpoint writer and
``pretrain_cli``'s final tree use it.  Not yet ported (they raise
:class:`~tapclip_tpu_torch.NotPortedError` by name): ``fsdp=True``, the
``/moe/`` leaves under ``tp > 1``, and the ``pipe`` placement.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict

import torch

from tapclip_tpu_torch import NotPortedError
from tapclip_tpu_torch.parallel import collectives
from tapclip_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh, batch_sharding, replicated
from tapclip_tpu_torch.pretrain import map_tree, named_leaves

_BLOCK = re.compile(r"/blocks/\d+/")


def _spec_for_path(path: str, tp: bool, pp: bool = False, fsdp: bool = False) -> tuple:
    # Pipeline parallelism: the stacked-leaf layer axis ([L, ...], leading)
    # of the transformer block pytrees shards over "pipe" — each stage holds
    # L/S contiguous layers. Composes with the Megatron TP columns/rows below
    # on the trailing dims.
    layer_ax = PIPE_AXIS if (pp and "blocks/" in path) else None
    m = MODEL_AXIS if tp else None
    # FSDP: the data axis lands on whichever big-GEMM dim TP does NOT own.
    d = DATA_AXIS if fsdp else None
    if fsdp:
        # Embeddings / projections: the vocab / patch / width dim over data.
        if path.endswith(("token_embedding", "patch_embed/w", "text_projection", "visual/proj")):
            return (DATA_AXIS, None)
    if layer_ax is None and m is None and d is None:
        return ()
    # Expert parallelism: the expert axis (dim 1 of the stacked [L, E, ...]
    # leaves) shards over "model"; the router stays replicated.
    if "/moe/" in path:
        if path.endswith("router/w"):
            return (layer_ax,) if layer_ax else ()
        leaf_name = path.rsplit("/", 1)[-1]
        if leaf_name in ("w_fc", "w_proj"):
            # [L, E, in, out]: experts on model, the (large) dim-2 on data.
            return (layer_ax, m, d, None)
        return (layer_ax, m, None)  # b_fc [L, E, 4W] / b_proj [L, E, W]
    if path.endswith("attn/w_qkv"):
        return (layer_ax, d, m)
    if path.endswith("attn/b_qkv"):
        return (layer_ax, m)
    if path.endswith("attn/w_out"):
        return (layer_ax, m, d)
    if path.endswith("mlp/w_fc"):
        return (layer_ax, d, m)
    if path.endswith("mlp/b_fc"):
        return (layer_ax, m)
    if path.endswith("mlp/w_proj"):
        return (layer_ax, m, d)
    if layer_ax is not None:
        return (layer_ax,)  # ln scales/biases, attn/mlp output biases
    return ()


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over every tensor leaf, paths as ``named_leaves``
    writes them (structure kept, ``None`` leaves kept)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return None if tree is None else fn(prefix[:-1], tree)


def stacked_path(path: str) -> str:
    """The JAX package's path of a port leaf: the block index dropped
    (``visual/blocks/3/attn/w_qkv`` -> ``visual/blocks/attn/w_qkv``)."""
    return _BLOCK.sub("/blocks/", path)


def _guard_rank(spec: tuple, ndim: int) -> tuple:
    """Replicate a leaf whose rank cannot carry the suffix-matched spec."""
    return () if len(spec) > ndim else spec


def _flags(mesh: Mesh):
    return mesh.shape.get(MODEL_AXIS, 1) > 1, mesh.shape.get(PIPE_AXIS, 1) > 1


def clip_param_specs(params: Dict[str, Any], mesh: Mesh, fsdp: bool = False) -> Dict[str, tuple]:
    """``{port path: spec}`` for every leaf, each spec the JAX package's
    ``clip_param_specs`` gives the stacked leaf (a block leaf counts the
    layer axis in its rank)."""
    tp, pp = _flags(mesh)
    out = {}
    for path, leaf in named_leaves(params):
        stacked = stacked_path(path)
        ndim = leaf.dim() + (stacked != path)
        out[path] = _guard_rank(_spec_for_path(stacked, tp, pp, fsdp), ndim)
    return out


def model_sharded(leaves, mesh: Mesh) -> list:
    """For each ``(path, leaf)`` of a tree (whole or a rank's local one),
    whether :func:`shard_params` cuts it over ``model``."""
    tp, pp = _flags(mesh)
    out = []
    for path, leaf in leaves:
        stacked = stacked_path(path)
        spec = _guard_rank(_spec_for_path(stacked, tp, pp), leaf.dim() + (stacked != path))
        out.append(mesh.tp > 1 and MODEL_AXIS in spec)
    return out


def local_spec(path: str, spec: tuple) -> tuple:
    """``spec`` over the port leaf's own axes: a block leaf drops the layer entry."""
    return spec[1:] if stacked_path(path) != path and spec else spec


def _check_placeable(path: str, spec: tuple, fsdp: bool) -> None:
    if fsdp:
        raise NotPortedError("FSDP placement (fsdp=True)")
    if PIPE_AXIS in spec:
        raise NotPortedError("pipe placement")
    if MODEL_AXIS in spec and "/moe/" in path:
        raise NotPortedError(f"MoE leaves under tp > 1 ({path})")


def _qkv_parts(t: torch.Tensor, n: int, j: int) -> torch.Tensor:
    """Rank j's per-head cut of a [..., 3W] qkv leaf: ``[q_j | k_j | v_j]``."""
    w = t.shape[-1] // 3
    if w % n:
        raise ValueError(f"qkv width {w} is not divisible by tp={n}")
    c = w // n
    return torch.cat([t[..., s * w + j * c: s * w + (j + 1) * c] for s in range(3)], dim=-1)


def shard_leaf(path: str, t: torch.Tensor, spec: tuple, n: int, j: int) -> torch.Tensor:
    """Rank ``j`` of ``n``'s local shard of one leaf (a copy)."""
    spec = local_spec(path, spec)
    if MODEL_AXIS not in spec or n == 1:
        return t.detach().clone()
    if path.endswith(("attn/w_qkv", "attn/b_qkv")):
        return _qkv_parts(t.detach(), n, j).contiguous()
    ax = spec.index(MODEL_AXIS)
    size = t.shape[ax]
    if size % n:
        raise ValueError(f"{path}: axis {ax} of size {size} is not divisible by tp={n}")
    return t.detach().narrow(ax, j * (size // n), size // n).contiguous()


def _check_tp(params, tp: int) -> None:
    """``n_heads % tp`` and ``mlp_hidden % tp`` refused by name."""
    for path, t in named_leaves(params):
        if path.endswith("mlp/w_fc") and t.shape[-1] % tp:
            raise ValueError(f"mlp_hidden {t.shape[-1]} is not divisible by tp={tp} ({path})")


def shard_params(params: Dict[str, Any], mesh: Mesh, fsdp: bool = False) -> Dict[str, Any]:
    """This rank's local tree: the Megatron cut on ``model`` (per-head qkv),
    every other leaf a replica.  Each leaf is a copy; ``requires_grad`` is
    carried over."""
    specs = clip_param_specs(params, mesh, fsdp=fsdp)
    n, j = mesh.tp, mesh.model_index
    for path, spec in specs.items():
        _check_placeable(path, spec, fsdp)
    if n > 1:
        _check_tp(params, n)
    return map_with_path(lambda path, t: shard_leaf(path, t, specs[path], n, j).requires_grad_(t.requires_grad),
                         params)


def _gather_leaf(path: str, t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    spec = local_spec(path, spec)
    n = mesh.tp
    if MODEL_AXIS not in spec or n == 1:
        return t.detach().clone()
    parts = collectives._gather_rows(t.detach().unsqueeze(0).contiguous(), mesh.model_group)  # [n, ...]
    if path.endswith(("attn/w_qkv", "attn/b_qkv")):
        c = t.shape[-1] // 3
        return torch.cat([parts[j][..., s * c:(s + 1) * c] for s in range(3) for j in range(n)], dim=-1)
    return torch.cat(list(parts), dim=spec.index(MODEL_AXIS))


def gather_params(local: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The whole tree from every rank's local tree (a collective over
    ``model``: every rank of a ``model`` group calls it), bit for bit the
    tree :func:`shard_params` cut."""
    specs = clip_param_specs(local, mesh)
    return map_with_path(lambda path, t: _gather_leaf(path, t, specs[path], mesh), local)


def shard_opt_state(opt_state: Dict[str, Any], mesh: Mesh, fsdp: bool = False, *,
                    params: Dict[str, Any]) -> Dict[str, Any]:
    """A ``pretrain.PretrainOptimizer.state_dict()`` of the whole tree, cut as
    :func:`shard_params` cuts the leaves its moments and accumulator track
    (by path).  ``params``: the whole tree, for the ranks of the rules."""
    if fsdp:
        raise NotPortedError("FSDP placement (fsdp=True)")
    specs = clip_param_specs(params, mesh)
    n, j = mesh.tp, mesh.model_index

    def cut(path, t):
        return shard_leaf(path, torch.as_tensor(t), specs[path], n, j)

    out = dict(opt_state)
    out["moments"] = {p: {k: (cut(p, v) if k != "step" else v) for k, v in st.items()}
                      for p, st in opt_state["moments"].items()}
    if opt_state.get("acc") is not None:
        out["acc"] = {p: cut(p, a) for p, a in opt_state["acc"].items()}
    return out


def gather_opt_state(opt_state: Dict[str, Any], mesh: Mesh, params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`shard_opt_state` (a collective over ``model``)."""
    specs = clip_param_specs(params, mesh)
    dev = next(iter(named_leaves(params)))[1].device

    def whole(path, t):
        return _gather_leaf(path, torch.as_tensor(t).to(dev), specs[path], mesh).cpu()

    out = dict(opt_state)
    out["moments"] = {p: {k: (whole(p, v) if k != "step" else v) for k, v in st.items()}
                      for p, st in opt_state["moments"].items()}
    if opt_state.get("acc") is not None:
        out["acc"] = {p: whole(p, a) for p, a in opt_state["acc"].items()}
    return out


def replicate(tree: Any, mesh: Mesh) -> Any:
    """A replica of ``tree``: on this rank (process groups, a copy of each
    leaf), or one per device of a device-list mesh (a list; a leaf already
    on that device is shared, not copied)."""
    if mesh.in_process:
        return [_to_device(tree, d) for d in mesh.devices]
    return map_tree(lambda t: t.detach().clone().requires_grad_(t.requires_grad), tree)


def shard_batch(tree: Any, mesh: Mesh) -> Any:
    """The leading (batch) axis over ``data``: this rank's rows (process
    groups), or one part per device of a device-list mesh (a list).  The
    batch must divide by ``dp``."""
    dp = mesh.dp

    def rows(t, i):
        t = torch.as_tensor(t)
        if t.shape[0] % dp:
            raise ValueError(f"batch {t.shape[0]} is not divisible by the mesh's data axis ({dp})")
        b = t.shape[0] // dp
        return t[i * b:(i + 1) * b]

    if mesh.in_process:
        return [map_tree(lambda t, i=i: rows(t, i).to(mesh.devices[i]), tree) for i in range(dp)]
    return map_tree(lambda t: rows(t, mesh.data_index), tree)


def shard_micro_batches(tree: Any, mesh: Mesh, k: int) -> Any:
    """A GradCache macro batch of k micro-batches (micro-major, ``[k * B,
    ...]``) over ``data`` as JAX lays it out (``P(None, "data")`` on ``[k,
    B, ...]``): this rank's rows of every micro-batch, in micro order."""
    dp, i = mesh.dp, mesh.data_index

    def rows(t):
        t = torch.as_tensor(t)
        if t.shape[0] % (k * dp):
            raise ValueError(f"macro batch {t.shape[0]} is not divisible by k * dp = {k * dp}")
        b = t.shape[0] // (k * dp)
        return t.reshape(k, dp, b, *t.shape[1:])[:, i].reshape(k * b, *t.shape[1:])

    return map_tree(rows, tree)


def data_parallel(fn, mesh: Mesh, n_replicated: int):
    """``fn`` over a device-list mesh (one process, a replica per device):
    ``wrapped(*replicated, batch)`` splits ``batch`` (a tensor or an array,
    rows divisible by dp) into dp equal parts, runs ``fn(*replicas_i,
    part_i)`` on device i, and concatenates the results in order on the
    first device.  The first ``n_replicated`` arguments (trees) are copied to
    each device once and kept while the caller passes the same objects; on a
    device they already live on they are not copied at all, so a list that
    repeats one device (``["cuda:0", "cuda:0"]``) runs the split and the
    gather on one card.  Without a mesh, ``fn`` itself."""
    if mesh is None:
        return fn
    if not mesh.in_process:
        raise ValueError("data_parallel takes a device-list mesh (make_mesh(dp, devices=[...]))")
    cache: Dict[int, Any] = {}

    def replicas(tree):
        key = id(tree)
        if key not in cache or cache[key][0] is not tree:
            cache[key] = (tree, replicated(mesh).put(tree))
        return cache[key][1]

    def wrapped(*args):
        *rep, batch = args
        if len(rep) != n_replicated:
            raise TypeError(f"expected {n_replicated} replicated arguments and a batch, got {len(args)} arguments")
        parts = batch_sharding(mesh).put(batch)
        per_dev = [replicas(a) for a in rep]
        outs = [fn(*(r[i] for r in per_dev), parts[i]) for i in range(mesh.dp)]
        first = mesh.devices[0]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([c.to(first) for c in col]) for col in zip(*outs))
        return torch.cat([o.to(first) for o in outs])

    return wrapped


def _to_device(tree, device):
    """``tree`` (tensors in dicts, lists and dataclasses) on ``device``; a
    leaf already there is the same tensor."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _to_device(getattr(tree, f.name), device)
                                            for f in dataclasses.fields(tree)})
    return tree
