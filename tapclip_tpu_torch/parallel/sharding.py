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
:func:`shard_batch`) covers the ``data``, ``pipe`` and ``model`` axes: each
rank keeps its local shard as a plain tensor.

* ``pipe`` (``pp > 1``): stage ``s`` keeps blocks ``s*L/pp .. (s+1)*L/pp - 1``
  of each tower, as its own list indexed from 0 (the leading layer axis of
  the stacked leaves is a slice of the list), so every stage's tree has the
  same paths; the other leaves are replicas.
* ``model``, the Megatron cut:

  * ``attn/w_qkv [W, 3W]`` and ``attn/b_qkv [3W]`` are cut **per head**: the
    rank holds the q, k and v columns of its own heads, ``[W, 3W/tp]`` laid
    out ``[q_j | k_j | v_j]``, so its attention runs on local heads.  (GSPMD
    can cut the 3W columns contiguously because XLA reshards as it needs; a
    rank that computes locally cannot.)
  * ``attn/w_out [W, W]``: the rows of its heads.
  * ``mlp/w_fc [W, H]``, ``mlp/b_fc [H]``: its hidden columns; ``mlp/w_proj
    [H, W]``: the matching rows.
  * everything else (embeddings, LayerNorms, the output biases,
    projections): replicated.
* ``data`` under FSDP (``fsdp=True``): each leaf whose spec names ``data``
  keeps ``1/dp`` along that dimension (``w_qkv``'s and ``w_fc``'s rows,
  ``w_out``'s and ``w_proj``'s columns, the embeddings' and projections'
  first dimension), which ``shard_opt_state(fsdp=True)`` mirrors in the
  AdamW moments (ZeRO).  A dimension ``dp`` does not divide is refused
  (GSPMD would pad it).
* the ``/moe/`` expert banks (expert parallelism): ``w_fc [E, W, H]``,
  ``b_fc [E, H]``, ``w_proj [E, H, W]`` and ``b_proj [E, W]`` keep the
  rank's ``E / tp`` experts (the expert axis over ``model``; an ``E`` that
  ``tp`` does not divide is refused by name), and under FSDP ``w_fc`` /
  ``w_proj`` also ``1/dp`` of their dimension 1 over ``data``; the router
  ``router/w [W, E]`` is replicated.

:func:`gather_params` and :func:`gather_opt_state` are the inverses, bit for
bit, across every combination of the three axes: the checkpoint writer and
``pretrain_cli``'s final tree use them.  :func:`join_leaf` is the same
inverse over pieces held on one host (the sharded snapshot's resume,
``utils/checkpoint.py``), and :func:`cut` the differentiable cut of a whole
tensor to a rank's ``model`` shard (LoRA's delta, ``peft.py``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict

import torch

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


def leaf_spec(path: str, leaf: torch.Tensor, mesh: Mesh, fsdp: bool = False) -> tuple:
    """The JAX package's spec of a port leaf's stacked leaf (a block leaf
    counts the layer axis in its rank)."""
    tp, pp = _flags(mesh)
    stacked = stacked_path(path)
    return _guard_rank(_spec_for_path(stacked, tp, pp, fsdp), leaf.dim() + (stacked != path))


def clip_param_specs(params: Dict[str, Any], mesh: Mesh, fsdp: bool = False) -> Dict[str, tuple]:
    """``{port path: spec}`` for every leaf, each spec the JAX package's
    ``clip_param_specs`` gives the stacked leaf."""
    return {path: leaf_spec(path, leaf, mesh, fsdp) for path, leaf in named_leaves(params)}


def shard_axes(leaves, mesh: Mesh, fsdp: bool = False) -> list:
    """For each ``(path, leaf)`` of a tree (whole or a rank's local one), the
    axes of more than one rank that :func:`shard_params` cuts it over, in
    the mesh's order (``()``: a replica)."""
    sizes = {DATA_AXIS: mesh.dp if fsdp else 1, PIPE_AXIS: mesh.pp, MODEL_AXIS: mesh.tp}
    return [tuple(a for a in (DATA_AXIS, PIPE_AXIS, MODEL_AXIS) if sizes[a] > 1 and a in leaf_spec(path, leaf, mesh, fsdp))
            for path, leaf in leaves]


def fsdp_state(local: Dict[str, Any], mesh: Mesh):
    """The FSDP gather state of a rank's tree (:func:`shard_params` with
    ``fsdp=True``): each leaf cut over ``data``, by ``id``, and its
    dimension."""
    dims = {}
    for path, t in named_leaves(local):
        spec = local_spec(path, leaf_spec(path, t, mesh, True))
        if DATA_AXIS in spec:
            dims[id(t)] = spec.index(DATA_AXIS)
    return collectives.FullySharded(mesh.data_group, dims)


def local_spec(path: str, spec: tuple) -> tuple:
    """``spec`` over the port leaf's own axes: a block leaf drops the layer entry."""
    return spec[1:] if stacked_path(path) != path and spec else spec


def _stage_blocks(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """``params`` with each tower's blocks cut to this stage's (a shallow copy)."""
    S, s = mesh.pp, mesh.pipe_index
    if S <= 1:
        return params
    out = dict(params)
    for tower in ("visual", "text"):
        if isinstance(params.get(tower), dict) and "blocks" in params[tower]:
            blocks = params[tower]["blocks"]
            L = len(blocks)
            if L % S:
                raise ValueError(f"pipeline: {L} layers not divisible by {S} stages")
            out[tower] = dict(params[tower], blocks=blocks[s * L // S:(s + 1) * L // S])
    return out


def _global_block_path(path: str, mesh: Mesh, n_local: Dict[str, int]) -> str:
    """The whole tree's path of a stage's block leaf (its local index offset
    by the stage's first block); other paths unchanged."""
    parts = path.split("/")
    if mesh.pp > 1 and len(parts) > 2 and parts[1] == "blocks":
        parts[2] = str(mesh.pipe_index * n_local[parts[0]] + int(parts[2]))
    return "/".join(parts)


def _n_local_blocks(tree) -> Dict[str, int]:
    return {k: len(v["blocks"]) for k, v in tree.items() if isinstance(v, dict) and "blocks" in v}


def _qkv_parts(t: torch.Tensor, n: int, j: int) -> torch.Tensor:
    """Rank j's per-head cut of a [..., 3W] qkv leaf: ``[q_j | k_j | v_j]``."""
    w = t.shape[-1] // 3
    if w % n:
        raise ValueError(f"qkv width {w} is not divisible by tp={n}")
    c = w // n
    return torch.cat([t[..., s * w + j * c: s * w + (j + 1) * c] for s in range(3)], dim=-1)


def cut(path: str, t: torch.Tensor, spec: tuple, n: int, j: int) -> torch.Tensor:
    """Rank ``j`` of ``n``'s ``model`` shard of ``t``, a whole leaf or a
    tensor of its shape (its local spec taken from ``spec``, the stacked
    leaf's): the per-head qkv cut, else a slice of the spec's ``model``
    axis; ``t`` itself with no such axis.  Differentiable (a view or a
    concatenation of views)."""
    spec = local_spec(path, spec)
    if MODEL_AXIS not in spec or n <= 1:
        return t
    if path.endswith(("attn/w_qkv", "attn/b_qkv")):
        return _qkv_parts(t, n, j)
    ax = spec.index(MODEL_AXIS)
    if t.shape[ax] % n:
        raise ValueError(f"{path}: axis {ax} of size {t.shape[ax]} is not divisible by tp={n}")
    return t.narrow(ax, j * (t.shape[ax] // n), t.shape[ax] // n)


def shard_leaf(path: str, t: torch.Tensor, spec: tuple, n: int, j: int, dn: int = 1, di: int = 0) -> torch.Tensor:
    """Rank ``j`` of ``n`` on ``model`` and ``di`` of ``dn`` on ``data``
    (FSDP): its local shard of one leaf, a copy that holds only the shard."""
    t = cut(path, t.detach(), spec, n, j)
    spec = local_spec(path, spec)
    if DATA_AXIS in spec and dn > 1:
        ax = spec.index(DATA_AXIS)
        if t.shape[ax] % dn:
            raise ValueError(f"{path}: axis {ax} of size {t.shape[ax]} is not divisible by dp={dn} (FSDP)")
        t = t.narrow(ax, di * (t.shape[ax] // dn), t.shape[ax] // dn)
    return t.clone(memory_format=torch.contiguous_format)


def _check_tp(params, tp: int) -> None:
    """``mlp_hidden % tp`` and ``moe_experts % tp`` refused by name (the
    head count: ``models/layers.py``)."""
    for path, t in named_leaves(params):
        if path.endswith("mlp/w_fc") and t.shape[-1] % tp:
            raise ValueError(f"mlp_hidden {t.shape[-1]} is not divisible by tp={tp} ({path})")
        if path.endswith("moe/w_fc") and t.shape[0] % tp:
            raise ValueError(f"moe_experts {t.shape[0]} is not divisible by tp={tp} ({path})")


def shard_params(params: Dict[str, Any], mesh: Mesh, fsdp: bool = False) -> Dict[str, Any]:
    """This rank's local tree: its stage's blocks (``pipe``), the Megatron
    cut on ``model`` (per-head qkv), with ``fsdp`` its ``1/dp`` of every
    leaf the spec cuts over ``data``, every other leaf a replica.  Each leaf
    is a copy that holds only its shard; ``requires_grad`` is carried
    over."""
    specs = clip_param_specs(params, mesh, fsdp=fsdp)
    n, j = mesh.tp, mesh.model_index
    dn, di = (mesh.dp, mesh.data_index) if fsdp else (1, 0)
    if n > 1:
        _check_tp(params, n)
    # a stage's block i carries the spec of the whole tree's block i (every block's is the same)
    return map_with_path(lambda path, t: shard_leaf(path, t, specs[path], n, j, dn, di).requires_grad_(t.requires_grad),
                         _stage_blocks(params, mesh))


def _join_model(path: str, parts, spec: tuple) -> torch.Tensor:
    """The inverse of :func:`cut` over every rank's ``model`` shard
    (``parts``, in rank order; ``spec`` local)."""
    if MODEL_AXIS not in spec or len(parts) == 1:
        return parts[0].clone()
    if path.endswith(("attn/w_qkv", "attn/b_qkv")):
        c = parts[0].shape[-1] // 3
        return torch.cat([parts[j][..., s * c:(s + 1) * c] for s in range(3) for j in range(len(parts))], dim=-1)
    return torch.cat(list(parts), dim=spec.index(MODEL_AXIS))


def join_leaf(path: str, pieces, spec: tuple) -> torch.Tensor:
    """A whole leaf from the pieces :func:`shard_leaf` cut, held on one host:
    ``pieces[d][j]`` the piece of data index ``d`` (one entry unless the
    spec's ``data`` axis cuts it) and model index ``j`` (one unless
    ``model`` does), ``spec`` the stacked leaf's.  Bit for bit the leaf that
    was cut."""
    spec = local_spec(path, spec)
    if DATA_AXIS in spec and len(pieces) > 1:
        ax = spec.index(DATA_AXIS)
        pieces = [[torch.cat([row[j] for row in pieces], dim=ax) for j in range(len(pieces[0]))]]
    return _join_model(path, pieces[0], spec)


def _gather_leaf(path: str, t: torch.Tensor, spec: tuple, mesh: Mesh, fsdp: bool = False) -> torch.Tensor:
    """One leaf whole over ``data`` (with ``fsdp``) and ``model`` (a
    collective over each group that cuts it)."""
    spec = local_spec(path, spec)
    t = t.detach()
    if fsdp and DATA_AXIS in spec and mesh.dp > 1:
        t = collectives.gather_dim(t, mesh.data_group, spec.index(DATA_AXIS))
    if MODEL_AXIS not in spec or mesh.tp == 1:
        return t.clone()
    return _join_model(path, list(collectives._gather_rows(t.unsqueeze(0).contiguous(), mesh.model_group)), spec)


def _join_stages(tree: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Each tower's blocks from every stage, in order (a collective over
    ``pipe``): the inverse of :func:`_stage_blocks`."""
    if mesh.pp <= 1:
        return tree
    out = dict(tree)
    for tower, n in _n_local_blocks(tree).items():
        stacked = [map_tree(lambda t: collectives._gather_rows(t.unsqueeze(0).contiguous(), mesh.pipe_group), blk)
                   for blk in tree[tower]["blocks"]]
        out[tower] = dict(tree[tower], blocks=[map_tree(lambda t, s=s: t[s].clone(), blk)
                                               for s in range(mesh.pp) for blk in stacked])
    return out


def gather_params(local: Dict[str, Any], mesh: Mesh, fsdp: bool = False) -> Dict[str, Any]:
    """The whole tree from every rank's local tree (a collective over the
    ``model`` group, the ``data`` group with ``fsdp`` and the ``pipe``
    group: every rank of the mesh calls it), bit for bit the tree
    :func:`shard_params` cut."""
    specs = clip_param_specs(local, mesh, fsdp=fsdp)
    return _join_stages(map_with_path(lambda path, t: _gather_leaf(path, t, specs[path], mesh, fsdp), local), mesh)


def shard_opt_state(opt_state: Dict[str, Any], mesh: Mesh, fsdp: bool = False, *,
                    params: Dict[str, Any]) -> Dict[str, Any]:
    """A ``pretrain.PretrainOptimizer.state_dict()`` of the whole tree, cut as
    :func:`shard_params` cuts the leaves its moments and accumulator track
    (by path; a stage keeps its blocks' entries under their local paths;
    with ``fsdp`` the moments keep ``1/dp``, ZeRO).  ``params``: the whole
    tree, for the ranks of the rules."""
    specs = clip_param_specs(params, mesh, fsdp=fsdp)
    n, j = mesh.tp, mesh.model_index
    dn, di = (mesh.dp, mesh.data_index) if fsdp else (1, 0)
    staged = _stage_blocks(params, mesh)
    local = {_global_block_path(p, mesh, _n_local_blocks(staged)): p for p, _ in named_leaves(staged)}

    def cut(path, t):
        return shard_leaf(path, torch.as_tensor(t), specs[path], n, j, dn, di)

    out = dict(opt_state)
    out["moments"] = {local[p]: {k: (cut(p, v) if k != "step" else v) for k, v in st.items()}
                      for p, st in opt_state["moments"].items() if p in local}
    if opt_state.get("acc") is not None:
        out["acc"] = {local[p]: cut(p, a) for p, a in opt_state["acc"].items() if p in local}
    return out


def gather_opt_state(opt_state: Dict[str, Any], mesh: Mesh, params: Dict[str, Any],
                     fsdp: bool = False) -> Dict[str, Any]:
    """The inverse of :func:`shard_opt_state` (a collective over every group
    that cuts a leaf), the moments under the whole tree's paths.
    ``params``: this rank's local tree."""
    specs = clip_param_specs(params, mesh, fsdp=fsdp)
    dev = next(iter(named_leaves(params)))[1].device
    n_local = _n_local_blocks(params)

    def whole(path, t):
        return _gather_leaf(path, torch.as_tensor(t).to(dev), specs[path], mesh, fsdp).cpu()

    def joined(entries):  # {local path: value} of every stage under the whole tree's paths
        entries = {_global_block_path(p, mesh, n_local): v for p, v in entries.items()}
        if mesh.pp <= 1:
            return entries
        import torch.distributed as dist

        parts = [None] * mesh.pp
        dist.all_gather_object(parts, entries, group=mesh.pipe_group)
        return {p: v for part in parts for p, v in part.items()}

    out = dict(opt_state)
    out["moments"] = joined({p: {k: (whole(p, v) if k != "step" else v) for k, v in st.items()}
                             for p, st in opt_state["moments"].items()})
    if opt_state.get("acc") is not None:
        out["acc"] = joined({p: whole(p, a) for p, a in opt_state["acc"].items()})
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
