"""Pipeline parallelism for the transformer towers (GPipe schedule).

Counterpart of ``tapclip_tpu/parallel/pipeline.py``.  Each of the S stages
of the mesh's ``pipe`` axis holds ``L/S`` consecutive blocks of a tower
(``sharding.shard_params``: a stage's tree holds its own list of blocks),
and activations pass from stage to stage on the ring of its ``pipe`` group.

Schedule (GPipe, Huang et al. 2019), as the JAX package's ``lax.scan``:

* the rank's batch splits into M microbatches, **strided**: microbatch m is
  rows ``{m, M + m, 2M + m, ...}``, and the inverse permutation restores the
  order at the end;
* the step runs ``M + S - 1`` ticks; each tick every stage receives its
  predecessor's last output (one ``collectives.ring_shift`` over the ring
  ``i -> i + 1``), stage 0 takes the next microbatch instead (zeros in the
  ``S - 1`` bubble ticks), and runs its blocks (``layers.run_blocks``, so
  they launch the block kernels: K2 and K1 in the image tower, B6 between the
  plain projections and K1 in the causal text tower, K3 under
  ``attn_impl="pallas"``; their partial modes under a ``model`` axis);
* the last stage's M valid outputs are collected by a masked sum over the
  ``pipe`` group (``collectives.reduce_from_model`` on that group: the
  forward all-reduces, the backward passes each stage's cotangent through
  once, so the mask gives the last stage the cotangent once, not S times:
  JAX's masked ``psum`` under ``check_vma=False``);
* the stages' input passes ``collectives.copy_to_model`` on the ``pipe``
  group, so its gradient (stage 0's; the others' is zero) is summed over the
  stages and every stage reads the embeddings' whole gradient.

The backward is autograd through the tick loop: the reversed ring, which is
GPipe's backward.  Per-block remat (``remat="full"`` by default, as the JAX
package checkpoints each scan step) bounds the stashed activations.  Every
stage runs every tick, bubbles included, as the JAX scan does, so the ranks
of a ``pipe`` group call the ring in one order in both passes.

Sequence parallelism and FSDP compose: ``layers.transformer_forward``
enters the sequence-parallel layout before the schedule (the ring then moves
a rank's ``T/tp`` rows) and each block gathers its FSDP leaves at its use,
once per tick.  Refused by name, as in the JAX package: the attribution aux
(``attn_to_idx``), int8 towers (``quantize``) and deep prompts.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch

from tapclip_tpu_torch.models import layers
from tapclip_tpu_torch.parallel import collectives

Params = Dict[str, Any]


def check_pipeline_geometry(n_layers: int, n_stages: int, batch: int, n_microbatches: int) -> None:
    if n_layers % n_stages != 0:
        raise ValueError(f"pipeline: {n_layers} layers not divisible by {n_stages} stages")
    if batch % n_microbatches != 0:
        raise ValueError(f"pipeline: batch {batch} not divisible by {n_microbatches} microbatches")


def _gpipe(x: torch.Tensor, blocks: List[Params], n_heads: int, remat: str, kw: Dict[str, Any], *, mesh,
           n_microbatches: int, attn_to_idx=None, layer_prompts=None, **_) -> Tuple[torch.Tensor, None]:
    """The schedule over this stage's ``blocks``, in ``layers.run_blocks``'
    signature (``transformer_forward``'s ``runner``)."""
    if attn_to_idx is not None:
        raise NotImplementedError("attribution aux is not supported under pipeline parallelism (prompt tuning "
                                  "freezes the towers; use the sequential tower)")
    if kw.get("quantize"):
        raise NotImplementedError("int8 eval quantization is not supported under pipeline parallelism (it is an "
                                  "eval-path feature; pp targets training)")
    if layer_prompts is not None:
        raise NotImplementedError("deep prompts require the sequential block scan (no pipeline transformer_fn "
                                  "override)")
    group, S, s = mesh.pipe_group, mesh.pp, mesh.pipe_index
    M, B = n_microbatches, x.shape[0]
    check_pipeline_geometry(len(blocks) * S, S, B, M)
    if torch.is_grad_enabled():
        _check_stages_train_alike(x, blocks, group, S)
    mb = B // M
    x = collectives.copy_to_model(x, group)
    xs = x.reshape(mb, M, *x.shape[1:]).transpose(0, 1)  # [M, mb, T, W]: microbatch m = rows m, M + m, ...
    first = torch.tensor(s == 0, device=x.device)
    carry, outs = torch.zeros_like(xs[0]), []
    for t in range(M + S - 1):
        recv = collectives.ring_shift(carry, group)
        xt = xs[t] if t < M else torch.zeros_like(xs[0])
        # both stay in every stage's graph, so every stage runs the ring's backward too
        inp = torch.where(first, xt, recv)
        carry, _ = layers.run_blocks(inp, blocks, n_heads, remat, kw)
        if t >= S - 1:
            outs.append(carry)
    outs = torch.stack(outs)
    # masked, not dropped: a stage's graph reaches its blocks through its outputs (zero cotangent)
    # and through the ring (its successor's cotangent)
    outs = torch.where(torch.tensor(s == S - 1, device=x.device), outs, torch.zeros_like(outs))
    y = collectives.reduce_from_model(outs, group)  # the last stage's outputs on every stage
    return y.transpose(0, 1).reshape(x.shape), None


def _check_stages_train_alike(x, blocks, group, n_stages: int) -> None:
    """Every stage's graph must run the ring's backward, or none: a stage
    whose input and blocks have nothing to train would leave the ring
    alone while its neighbours wait on it (LiT's ``unlocked_groups`` can
    freeze one stage's blocks and not another's).  One all-reduce of a
    flag over the ``pipe`` group."""
    trains = x.requires_grad or any(t.requires_grad for blk in blocks for t in _leaves(blk))
    n = collectives.all_reduce_(torch.tensor([float(trains)], device=x.device), group)
    if float(n) not in (0.0, float(n_stages)):
        raise NotImplementedError("pipeline parallelism with some stages' blocks frozen and others' trained "
                                  "(a tower's blocks train on every stage or on none)")


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def pipeline_transformer_forward(x: torch.Tensor, blocks: List[Params], n_heads: int, *, mesh, n_microbatches: int,
                                 act: str, remat: str = "full", **kw) -> Tuple[torch.Tensor, None]:
    """Drop-in for ``layers.transformer_forward`` over the mesh's ``pipe``
    axis: ``x`` is this rank's ``[B, T, W]`` (its rows of the batch),
    ``blocks`` this stage's.  Values and gradients equal the sequential
    tower's over every stage's blocks.  ``remat`` defaults to "full" here
    (GPipe's memory model); ``kw`` as ``transformer_forward``'s."""
    return layers.transformer_forward(
        x, blocks, n_heads, act=act, remat=remat,
        runner=functools.partial(_gpipe, mesh=mesh, n_microbatches=n_microbatches), **kw)


def make_pipeline_transformer_fn(mesh, n_microbatches: int, remat: str = "full"):
    """A ``transformer_fn`` for the tower encoders (``models/clip.py``):
    routes the block stack through the GPipe schedule."""

    def fn(x, blocks, n_heads, **kw):
        kw.pop("remat", None)  # pp has its own (per-block, every tick) remat default
        if kw.pop("quantize", False):
            raise NotImplementedError("int8 quantization is not supported under pipeline parallelism")
        kw.pop("quantize_deterministic", None)
        return pipeline_transformer_forward(x, blocks, n_heads, mesh=mesh, n_microbatches=n_microbatches,
                                            remat=remat, **kw)

    return fn
