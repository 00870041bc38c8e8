"""The device mesh over ``torch.distributed`` process groups.

Counterpart of ``tapclip_tpu/parallel/mesh.py``.  A mesh is a ``(data,
model)`` grid, or ``(data, pipe, model)`` with ``pp > 1``, with JAX's axis
names and rank grid: ``reshape(dp, tp)`` / ``reshape(dp, pp, tp)``, with
``model`` innermost, so that a ``model`` group is ``tp`` consecutive ranks.

* ``"data"``: the batch axis.  Each rank holds its rows of the global batch;
  the trained leaves' gradients are summed over it (``train_step.py``,
  ``pretrain.py``), and under FSDP it also cuts the big weights
  (``sharding.py``).
* ``"pipe"``: the GPipe stages (``parallel/pipeline.py``): stage ``s`` holds
  its ``L/pp`` consecutive blocks of each tower, and activations pass from
  stage to stage on the ring of its ``pipe`` group.
* ``"model"``: Megatron tensor parallelism in the towers (``models/layers.py``):
  a rank holds its heads' and its hidden columns' weights, and the blocks'
  partial products are all-reduced over it (reduce-scattered over the
  sequence under sequence parallelism).

A mesh comes in two forms:

* **process groups** (:func:`make_mesh` after ``init_process_group``, one
  process per rank, as ``torchrun`` starts them): :attr:`Mesh.data_group`,
  :attr:`Mesh.pipe_group` and :attr:`Mesh.model_group` are this rank's
  groups, built for every cell of the grid by every rank, as
  ``torch.distributed.new_group`` requires;
* **a device list in one process** (``make_mesh(dp, devices=[...])``):
  data-parallel replicas, one per device, for ``serve``, ``featurize`` and
  ``predict``.  It needs no process group.  A list may repeat a device
  (``["cuda:0", "cuda:0"]``), so the split and the gather run on one card.
  It refuses ``tp > 1`` and ``pp > 1``.

The backend is the caller's: :func:`init_distributed` takes NCCL for a CUDA
device and gloo for the CPU unless it is named, and :func:`make_mesh` builds
its groups on the default group's backend unless ``backend=`` is named.
Nothing switches a backend on its own.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from tapclip_tpu_torch import NotPortedError

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device=None, backend: Optional[str] = None) -> int:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` in the environment) and
    return the world size; 1, with no group, when the environment names no
    world.  ``backend`` defaults to :func:`default_backend` of ``device``."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized():
        return dist.get_world_size()
    if world <= 1:
        return 1
    dist.init_process_group(backend or default_backend(device or "cpu"), init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world)
    return world


@dataclasses.dataclass
class Mesh:
    """A ``(data, model)`` or ``(data, pipe, model)`` grid.  ``shape`` is a
    dict (``mesh.shape.get("data", 1)``); ``grid`` holds the ranks (process
    groups) or the device indices into ``devices`` (one process).  For the
    process-group form, ``data_index`` / ``pipe_index`` / ``model_index``
    place this rank, and ``data_group`` / ``pipe_group`` / ``model_group``
    are its groups (``None`` on a one-rank mesh with no process group, and
    ``pipe_group`` without a ``pipe`` axis)."""

    shape: Dict[str, int]
    grid: np.ndarray
    axis_names: tuple = (DATA_AXIS, MODEL_AXIS)
    devices: Optional[List[torch.device]] = None
    rank: Optional[int] = None
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None
    backend: Optional[str] = None
    pipe_index: int = 0
    pipe_group: Any = None

    @property
    def dp(self) -> int:
        return self.shape.get(DATA_AXIS, 1)

    @property
    def tp(self) -> int:
        return self.shape.get(MODEL_AXIS, 1)

    @property
    def pp(self) -> int:
        return self.shape.get(PIPE_AXIS, 1)

    @property
    def world(self) -> int:
        return self.dp * self.pp * self.tp

    @property
    def in_process(self) -> bool:
        """The device-list form: replicas in one process, no groups."""
        return self.devices is not None


def _sizes(n: int, dp: int, tp: int, pp: int):
    """The JAX package's sizing and refusals (``mesh.py:54-58``)."""
    if tp <= 0:
        tp = 1
    if pp <= 0:
        pp = 1
    if dp == -1:
        if n % (tp * pp) != 0:
            raise ValueError(f"{n} devices not divisible by tp*pp={tp * pp}")
        dp = n // (tp * pp)
    if dp * tp * pp > n:
        raise ValueError(f"mesh {dp}x{pp}x{tp} needs {dp * tp * pp} devices, have {n}")
    return dp, tp, pp


def make_mesh(dp: int = -1, tp: int = 1, devices: Optional[Sequence] = None, pp: int = 1, *,
              backend: Optional[str] = None) -> Mesh:
    """Build a ``(data, model)`` mesh, or ``(data, pipe, model)`` when ``pp >
    1``.  ``dp=-1`` takes every remaining rank (or device).

    With ``devices`` (a list of devices): the one-process replica form,
    ``tp`` and ``pp`` must be 1.  Without: the ranks of the default process
    group, ``grid = arange(dp * pp * tp).reshape(dp, pp, tp)`` (``reshape(dp,
    tp)`` when ``pp == 1``, the 2-axis mesh; ranks past the grid get no
    cell, as devices past it get none in JAX, and every rank builds the
    groups); with no process group the world is this one process."""
    import torch.distributed as dist

    if devices is not None:
        devs = [torch.device(d) for d in devices]
        dp, tp, pp = _sizes(len(devs), dp, tp, pp)
        if tp > 1:
            raise NotPortedError("tensor parallelism over a device list in one process (use process groups)")
        if pp > 1:
            raise NotPortedError("the pipe axis over a device list in one process (use process groups)")
        return Mesh(shape={DATA_AXIS: dp, MODEL_AXIS: 1}, grid=np.arange(dp).reshape(dp, 1), devices=devs[:dp])
    world = dist.get_world_size() if dist.is_initialized() else 1
    dp, tp, pp = _sizes(world, dp, tp, pp)
    grid = np.arange(dp * pp * tp).reshape((dp, pp, tp) if pp > 1 else (dp, tp))
    if not dist.is_initialized():
        return Mesh(shape=_shape(grid), grid=grid, rank=0, axis_names=_axes(grid))
    return _grouped(grid, backend)


def _axes(grid: np.ndarray) -> tuple:
    return (DATA_AXIS, PIPE_AXIS, MODEL_AXIS) if grid.ndim == 3 else (DATA_AXIS, MODEL_AXIS)


def _shape(grid: np.ndarray) -> Dict[str, int]:
    return dict(zip(_axes(grid), (int(n) for n in grid.shape)))


def _grouped(grid: np.ndarray, backend: Optional[str]) -> Mesh:
    """The mesh over ``grid``'s ranks (``[dp, tp]`` or ``[dp, pp, tp]``):
    every rank builds every group (in one order: data, pipe, model), then
    keeps its own."""
    import torch.distributed as dist

    backend = backend or dist.get_backend()
    rank = dist.get_rank()
    g3 = grid if grid.ndim == 3 else grid[:, None, :]
    dp, pp, tp = g3.shape

    def groups(lines):
        return {key: dist.new_group([int(r) for r in ranks], backend=backend) for key, ranks in lines}

    data_groups = groups(((s, j), g3[:, s, j]) for s in range(pp) for j in range(tp))
    pipe_groups = groups(((i, j), g3[i, :, j]) for i in range(dp) for j in range(tp)) if pp > 1 else {}
    model_groups = groups(((i, s), g3[i, s, :]) for i in range(dp) for s in range(pp))
    mesh = Mesh(shape=_shape(grid), grid=grid, rank=rank, backend=backend, axis_names=_axes(grid))
    where = np.argwhere(g3 == rank)
    if len(where):
        i, s, j = (int(v) for v in where[0])
        mesh.data_index, mesh.pipe_index, mesh.model_index = i, s, j
        mesh.data_group, mesh.model_group = data_groups[s, j], model_groups[i, s]
        mesh.pipe_group = pipe_groups.get((i, j))
    return mesh


def device_mesh(dp: int, device) -> Mesh:
    """The CLIs' ``--dp``: ``dp`` replicas in this process, on CUDA devices
    0 .. dp - 1 (``make_mesh``'s refusal when the machine has fewer), or
    ``dp`` times the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return make_mesh(dp=dp, devices=[f"cuda:{i}" for i in range(min(dp, torch.cuda.device_count()))])
    return make_mesh(dp=dp, devices=[dev] * dp)


def single_device_mesh() -> Mesh:
    """A one-rank mesh; it needs no process group."""
    return Mesh(shape={DATA_AXIS: 1, MODEL_AXIS: 1}, grid=np.zeros((1, 1), np.int64), rank=0)


def make_multihost_mesh(dp_per_host: int = -1, tp: int = 1, *, backend: Optional[str] = None) -> Mesh:
    """A mesh whose ``model`` groups stay inside one node: ``LOCAL_WORLD_SIZE``
    (``torchrun``'s ranks per node) ranks a node, ``dp_per_host * tp`` of them
    in the grid, the data axis stacked node-major (JAX's DCN x ICI layout).
    One node degenerates to :func:`make_mesh`."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world <= local:
        return make_mesh(dp=dp_per_host, tp=tp, backend=backend)
    if world % local:
        raise ValueError(f"world {world} is not a whole number of nodes of {local} ranks")
    if dp_per_host == -1:
        dp_per_host = local // tp
    if dp_per_host * tp > local or local % tp:
        raise ValueError(f"a node holds {local} ranks: dp_per_host={dp_per_host} x tp={tp} does not fit")
    nodes = world // local
    rows = [np.arange(n * local, n * local + dp_per_host * tp).reshape(dp_per_host, tp) for n in range(nodes)]
    return _grouped(np.concatenate(rows), backend)


# --- placements (the counterparts of the NamedShardings) ---------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """What a ``NamedSharding`` says, as data: the mesh and a spec tuple.
    :meth:`put` is ``jax.device_put(tree, sharding)``."""

    mesh: Mesh
    spec: tuple

    def put(self, tree: Any) -> Any:
        """``tree`` placed: its leading axis over ``data``
        (``sharding.shard_batch``) or a replica (``sharding.replicate``)."""
        from tapclip_tpu_torch.parallel import sharding

        if self.spec == (DATA_AXIS,):
            return sharding.shard_batch(tree, self.mesh)
        if self.spec == ():
            return sharding.replicate(tree, self.mesh)
        raise NotPortedError(f"placement {self.spec} (leaves are placed by sharding.shard_params)")


def batch_sharding(mesh: Mesh) -> Placement:
    """The leading (batch) axis over ``data``."""
    return Placement(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())
