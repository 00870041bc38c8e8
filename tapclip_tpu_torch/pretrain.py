"""CLIP contrastive pretraining / fine-tuning steps on one device.

Counterpart of ``tapclip_tpu/pretrain.py``: the symmetric InfoNCE and the
SigLIP pairwise sigmoid objectives, a step that trains the towers
themselves, GradCache accumulation with negatives over the whole macro
batch, LiT tower locks, BitFit, an EMA of the tree and the validation
readout (contrastive loss + retrieval Recall@K).

The parameter tree is the port's (``models/clip.py``: a stack of blocks is a
list).  Which leaves train is which leaves require a gradient: a locked or
frozen leaf is left out of autograd and out of the optimizer (no moments, no
decay), so it stays bit-identical.  A fully locked tower therefore runs its
forward with no graph, which is JAX's ``stop_gradient`` pruning; VPT's
``visual.vpt`` trains through an image lock, and the graph then reaches it
through the frozen tower, whose kernels compute no weight gradient.

:class:`PretrainOptimizer` is the JAX CLI's optax chain written out:
``MultiSteps(chain(clip_by_global_norm, adamw(schedule)))`` over the
trainable leaves, with :func:`warmup_cosine_decay_schedule`,
:func:`clip_by_global_norm` and the ``MultiSteps`` running mean as plain
functions.  The AdamW update is ``torch.optim.AdamW`` (``optax.adamw``'s
update: decoupled decay on the old parameter, eps outside the square root,
bias correction by the update count).  One deliberate difference: the
clip's global norm runs over the trained leaves' gradients; under BitFit and
``unlocked_groups`` the JAX chain also counts the frozen leaves' gradients,
which the port never computes.

MoE towers (``CLIPConfig.moe_experts``, ``models/moe.py``) add the Switch
load-balance term of both towers' blocks with weight ``moe_aux_weight``, as
the JAX package's steps do; GradCache adds each micro-batch's term with
weight ``moe_aux_weight / k`` in its live pass.

Every random draw (augmentation boxes, patch-dropout indices) comes from an
explicit ``torch.Generator`` and can be passed in instead (``boxes=``,
``patch_idx=``), so tests feed JAX's draws.

**A mesh** (``mesh=``, the ``data`` and ``model`` axes): each rank passes
its rows of the global batch.  :func:`contrastive_loss_global` scores the
rank's rows against the columns of every rank (an autograd all-gather over
``data``), :func:`siglip_loss_global` walks the ``ppermute`` ring; each
returns the rank's share of the global mean, and the shares sum to the
loss.  The all-gather's backward already carries the other ranks' part of
each feature's gradient, so the trained leaves' gradients are **summed**
over ``data`` (averaging them, as DDP does, would divide by dp a second
time); the clip's global norm is taken after the sum, over the whole tree:
each leaf's squares summed over every group that cuts it (``model`` for
the Megatron shards, ``pipe`` for a stage's blocks, ``data`` for the FSDP
shards), each replicated leaf counted once.  GradCache's negatives span
K·B·dp.
Patch dropout and ``augment`` draw for the global batch from the step's
generator and each rank keeps its rows of the draws, so a dp = 2 step
equals the dp = 1 step.  Under ``tp > 1`` the towers run tensor parallel
over ``model`` (``models/layers.py``); every trained leaf's gradient is
then complete on its rank (a replicated leaf's equal on every rank of the
``model`` group, a shard's its own), so nothing is summed over ``model``.

:func:`make_pretrain_step` also takes JAX's three other forms: a mesh with a
``pipe`` axis runs both towers' blocks on the GPipe schedule
(``parallel/pipeline.py``; ``pp_microbatches`` defaults to ``2 * pp``, and
the per-data-shard batch must divide by it), ``seq_parallel`` (needs a
``model`` axis) runs them sequence parallel, and ``fsdp`` (needs a ``data``
axis; the tree placed by ``sharding.shard_params(..., fsdp=True)``) gathers
each cut leaf at its use, whose gradient then arrives reduce-scattered,
summed over ``data`` already, and is left out of the step's sum over
``data``; the AdamW moments are the shards', so the update stays local and
the tree stays cut.  Each is the plain step's arithmetic.

MoE towers run under ``data`` (plain and FSDP, whose cut reaches the expert
banks) and ``model`` (expert parallelism, ``models/moe.py``); the pipe axis
refuses them by JAX's message.  The load-balance term is a mean over the
global batch's rows, so each rank adds its own rows' term weighted by its
share of them (``1/dp``, as the global losses' shares) and the gradients
are summed over ``data``; under ``model`` the term is the same on every
rank and counted once.  GradCache keeps the JAX package's per-micro mean.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tapclip_tpu_torch.config import CLIPConfig
from tapclip_tpu_torch.models import clip as clip_model
from tapclip_tpu_torch.parallel import collectives
from tapclip_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS

Params = Dict[str, Any]
LOGIT_SCALE_MAX = math.log(100.0)

#: Leaf-path suffixes BitFit trains: every additive bias (LayerNorm / BN
#: biases, the attention and MLP projection biases, and "/b", the RN-family
#: attention-pool projection biases); LN scales and BN statistics stay frozen.
BITFIT_SUFFIXES = ("/bias", "/b_qkv", "/b_out", "/b_fc", "/b_proj", "/b")


# --- losses ------------------------------------------------------------------


def contrastive_loss_local(img_feats: torch.Tensor, txt_feats: torch.Tensor,
                           logit_scale: torch.Tensor) -> torch.Tensor:
    """Bidirectional InfoNCE over ``exp(logit_scale) * img @ txt.T``, in f32
    on the L2-normalised features."""
    img = clip_model.l2_normalize(img_feats).float()
    txt = clip_model.l2_normalize(txt_feats).float()
    logits = torch.exp(logit_scale.float()) * img @ txt.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def siglip_loss_local(img_feats: torch.Tensor, txt_feats: torch.Tensor, logit_scale: torch.Tensor,
                      logit_bias: torch.Tensor) -> torch.Tensor:
    """SigLIP (Zhai et al. 2023): ``-1/B sum_ij log sigmoid(z_ij (t img_i . txt_j + b))``
    with ``z = +1`` on the diagonal and ``-1`` off it."""
    img = clip_model.l2_normalize(img_feats).float()
    txt = clip_model.l2_normalize(txt_feats).float()
    n = img.shape[0]
    logits = torch.exp(logit_scale.float()) * img @ txt.T + logit_bias.float()
    z = 2.0 * torch.eye(n, dtype=torch.float32, device=logits.device) - 1.0
    return -F.logsigmoid(z * logits).sum() / n


def contrastive_loss_global(img_feats: torch.Tensor, txt_feats: torch.Tensor, logit_scale: torch.Tensor,
                            group) -> torch.Tensor:
    """Global-batch InfoNCE over ``group`` (the ``data`` axis): this rank's
    rows ``[B_local, E]`` against every rank's columns (all-gathered), labels
    offset by the rank, the sum over its rows divided by the global count.
    Returns this rank's share; the shares sum to the loss on the gathered
    batch, and the gradients summed over ``group`` are its gradients."""
    img = clip_model.l2_normalize(img_feats).float()
    txt = clip_model.l2_normalize(txt_feats).float()
    img_all = collectives.all_gather(img, group)
    txt_all = collectives.all_gather(txt, group)
    n_local = img.shape[0]
    labels = collectives.rank_in(group) * n_local + torch.arange(n_local, device=img.device)
    s = torch.exp(logit_scale.float())
    li = F.cross_entropy(s * img @ txt_all.T, labels, reduction="none")
    lt = F.cross_entropy(s * txt @ img_all.T, labels, reduction="none")
    return (0.5 * (li + lt)).sum() / (n_local * collectives.size(group))


def siglip_loss_global(img_feats: torch.Tensor, txt_feats: torch.Tensor, logit_scale: torch.Tensor,
                       logit_bias: torch.Tensor, group) -> torch.Tensor:
    """Global-batch SigLIP over ``group`` on the ``ppermute`` ring (the
    paper's chunked form): the image shard stays, the text shards rotate
    D - 1 times, each step one ``[B_local, B_local]`` block; positives only on
    the step that does not rotate.  Returns this rank's share of the global
    mean, as :func:`contrastive_loss_global`."""
    img = clip_model.l2_normalize(img_feats).float()
    txt = clip_model.l2_normalize(txt_feats).float()
    n_local, n_dev = img.shape[0], collectives.size(group)
    s, b = torch.exp(logit_scale.float()), logit_bias.float()

    def block(chunk, z):
        return -F.logsigmoid(z * (s * img @ chunk.T + b)).sum()

    acc = block(txt, 2.0 * torch.eye(n_local, dtype=torch.float32, device=img.device) - 1.0)
    chunk = txt
    for _ in range(n_dev - 1):
        chunk = collectives.ring_shift(chunk, group)
        acc = acc + block(chunk, -1.0)
    return acc / (n_local * n_dev)


def add_siglip_params(params: Params, init_bias: float = -10.0) -> Params:
    """``params`` with SigLIP's ``logit_bias`` (init -10: training starts
    near the all-negatives prior); a bias already there is kept."""
    if "logit_bias" in params:
        return dict(params)
    return dict(params, logit_bias=torch.tensor(init_bias, dtype=torch.float32,
                                                 device=params["logit_scale"].device))


def pair_loss(loss: str, params: Params, img: torch.Tensor, txt: torch.Tensor, group=None) -> torch.Tensor:
    """The objective ``loss`` ("infonce" or "siglip") on one batch of
    features; with ``group`` (a ``data`` group of more than one rank) this
    rank's share of the global-batch objective."""
    if group is not None:
        if loss == "siglip":
            return siglip_loss_global(img, txt, params["logit_scale"], params["logit_bias"], group)
        return contrastive_loss_global(img, txt, params["logit_scale"], group)
    if loss == "siglip":
        return siglip_loss_local(img, txt, params["logit_scale"], params["logit_bias"])
    return contrastive_loss_local(img, txt, params["logit_scale"])


def _check_loss(loss: str) -> None:
    if loss not in ("infonce", "siglip"):
        raise ValueError(f"unknown loss {loss!r}: use 'infonce' or 'siglip'")


# --- the tree's leaves -------------------------------------------------------


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, leaf)`` of a nested dict/list tree, keys sorted, list items by
    index: ``"visual/blocks/0/attn/w_qkv"``.  ``None`` leaves are skipped."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in named_leaves(v, f"{prefix}{i}/")]
    if tree is None:
        return []
    return [(prefix[:-1], tree)]


def map_tree(fn: Callable, tree):
    """``fn`` over every tensor leaf of a nested dict/list tree (structure kept)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def detached_copy(tree):
    """A detached clone of every leaf (an EMA start, a snapshot)."""
    return map_tree(lambda t: t.detach().clone(), tree)


def lock_tower_trainable(params: Params, *, lock_image: bool = False, lock_text: bool = False,
                         unlocked_groups: int = 0) -> Dict[str, bool]:
    """LiT-style locks (Zhai et al.; open_clip's ``--lock-image`` /
    ``--lock-text``): ``{path: trains}`` over the tree.  A locked tower's
    leaves are frozen, ``visual.vpt`` excepted; the top-level extras
    (``logit_scale``, SigLIP's ``logit_bias``, ``kd_proj``) train.

    ``unlocked_groups`` (open_clip's ``unlocked_groups=N``): the locked
    tower's groups are [stem, block_0 .. block_{L-1}, head], and the last N
    train (1: the head, 2: head + last block, ...; L + 2: all of it)."""
    if lock_image and lock_text:
        raise ValueError("locking BOTH towers leaves nothing to train")
    locked = {"visual"} if lock_image else {"text"} if lock_text else set()
    head_keys = {"visual": ("ln_post", "proj"), "text": ("ln_final", "text_projection")}
    out = {}
    for tower in ("visual", "text"):
        if tower in locked and unlocked_groups > 0 and "blocks" not in params[tower]:
            raise ValueError("unlocked_groups requires a stacked-blocks (transformer) tower; "
                             f"{tower!r} has keys {sorted(params[tower])}")
    for path, _ in named_leaves(params):
        parts = path.split("/")
        tower = parts[0]
        if tower not in locked or (tower == "visual" and parts[1] == "vpt"):
            out[path] = True
        elif unlocked_groups <= 0:
            out[path] = False
        else:
            n_blocks = len(params[tower]["blocks"])
            n = min(unlocked_groups, n_blocks + 2)
            first_unlocked = n_blocks - max(0, n - 1)
            if parts[1] == "blocks":
                out[path] = int(parts[2]) >= first_unlocked
            else:
                out[path] = parts[1] in head_keys[tower] or n >= n_blocks + 2
    return out


def bitfit_trainable(params: Params) -> Dict[str, bool]:
    """BitFit (Ben Zaken et al. 2022): ``{path: trains}`` with only the
    additive biases of the towers (:data:`BITFIT_SUFFIXES`), ``visual.vpt``
    and the top-level extras training."""
    out = {}
    for path, _ in named_leaves(params):
        if not path.startswith(("visual/", "text/")) or path == "visual/vpt":
            out[path] = True
        else:
            out[path] = path.endswith(BITFIT_SUFFIXES)
    return out


def set_trainable(params: Params, trainable: Optional[Dict[str, bool]] = None) -> List[Tuple[str, torch.Tensor]]:
    """Mark each leaf of ``params`` (in place) as requiring a gradient or
    not; returns the trained ``(path, leaf)`` pairs, the optimizer's.  With
    no mask every leaf trains."""
    leaves = []
    for path, t in named_leaves(params):
        want = True if trainable is None else trainable[path]
        t.requires_grad_(want)
        if want:
            leaves.append((path, t))
    return leaves


# --- the optimizer -------------------------------------------------------------


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0, exponent: float = 1.0) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps`` (held at ``init_value`` when that is
    0), then cosine decay to ``end_value`` at ``decay_steps``."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps - warmup_steps}.")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def warmup(count):
        if warmup_steps <= 0:
            return init_value
        frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    def cosine(count):
        count = min(count, decay_steps - warmup_steps)
        decayed = 0.5 * (1 + math.cos(math.pi * count / (decay_steps - warmup_steps)))
        return peak_value * ((1 - alpha) * decayed ** exponent + alpha)

    return lambda count: warmup(count) if count < warmup_steps else cosine(count - warmup_steps)


def global_norm(grads: Sequence[torch.Tensor], axes: Optional[Sequence[tuple]] = None,
                groups: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every gradient, in f32.  On a mesh,
    ``axes`` names for each gradient the axes whose ranks hold the other
    parts of its leaf (``()``: the whole leaf) and ``groups`` maps an axis
    to this rank's group: the squares of each set of axes are summed over
    each of its groups in turn (the mesh's axis order, one all-reduce an
    axis), the replicated leaves' counted once, so every rank reads the
    whole tree's norm."""
    squares = [g.float().square().sum() for g in grads]
    if not axes or not any(axes):
        return torch.sqrt(sum(squares))
    keys = sorted(set(axes))
    v = torch.stack([sum((q for q, a in zip(squares, axes) if a == k), torch.zeros((), device=squares[0].device))
                     for k in keys])
    for axis in (DATA_AXIS, PIPE_AXIS, MODEL_AXIS):
        mask = torch.tensor([axis in k for k in keys], device=v.device)
        if bool(mask.any()):
            part = collectives.all_reduce_(torch.where(mask, v, torch.zeros_like(v)), groups[axis])
            v = torch.where(mask, part, v)
    return torch.sqrt(v.sum())


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float, axes: Optional[Sequence[tuple]] = None,
                        groups: Optional[Dict[str, Any]] = None) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: each gradient as ``g / norm * max_norm``
    when the global norm (:func:`global_norm`) reaches ``max_norm``,
    unchanged below it (no ``+1e-6`` in the divisor, unlike
    ``torch.nn.utils.clip_grad_norm_``)."""
    norm = global_norm(grads, axes, groups)
    if float(norm) < max_norm:
        return grads
    return [g / norm.to(g.dtype) * max_norm for g in grads]


def multisteps_mean(acc: List[torch.Tensor], grads: List[torch.Tensor], mini_step: int) -> List[torch.Tensor]:
    """``optax.MultiSteps``' running mean: ``acc + (g - acc) / (mini_step + 1)``."""
    return [a + (g - a) / (mini_step + 1) for a, g in zip(acc, grads)]


class PretrainOptimizer:
    """``MultiSteps(chain(clip_by_global_norm, adamw(lr)))`` over named leaves.

    ``leaves``: the trained ``(path, tensor)`` pairs (:func:`set_trainable`).
    ``lr``: a float or a schedule ``count -> lr``, read at the count of
    updates taken before this one, as optax reads it.  ``grad_clip`` > 0
    clips the (averaged) gradient by its global norm.  ``accum_steps`` K > 1
    averages K gradients and takes one update on the K-th; between updates
    the parameters and the AdamW state do not move.  A step built on a mesh
    sets :attr:`shard_axes` (the axes that cut each leaf) and
    :attr:`norm_groups` (this rank's group of each axis), so the clip reads
    the whole tree's norm.
    """

    def __init__(self, leaves: List[Tuple[str, torch.Tensor]], *, lr, weight_decay: float,
                 grad_clip: float = 0.0, accum_steps: int = 1):
        if not leaves:
            raise ValueError("nothing to train: every leaf is frozen")
        self.paths = [p for p, _ in leaves]
        self.leaves = [t for _, t in leaves]
        self.lr = lr
        self.grad_clip = float(grad_clip)
        self.accum_steps = int(accum_steps)
        self.count = 0  # updates taken
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None
        self.shard_axes: Optional[List[tuple]] = None
        self.norm_groups: Optional[Dict[str, Any]] = None
        self.adamw = torch.optim.AdamW(self.leaves, lr=self.lr_at(0), betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)

    def lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    @torch.no_grad()
    def update(self, grads: Sequence[Optional[torch.Tensor]]) -> bool:
        """One gradient per trained leaf (None: zero).  Returns whether the
        parameters moved (False on a MultiSteps mini step)."""
        grads = [torch.zeros_like(t) if g is None else g.to(t.dtype) for g, t in zip(grads, self.leaves)]
        if self.accum_steps > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(t) for t in self.leaves]
            self.acc = multisteps_mean(self.acc, grads, self.mini_step)
            self.mini_step += 1
            if self.mini_step < self.accum_steps:
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
        if self.grad_clip > 0:
            grads = clip_by_global_norm(grads, self.grad_clip, self.shard_axes, self.norm_groups)
        for t, g in zip(self.leaves, grads):
            t.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.adamw.step()
        for t in self.leaves:
            t.grad = None
        self.count += 1
        return True

    def state_dict(self) -> Dict[str, Any]:
        """Per-leaf AdamW moments by path, the update count and the
        MultiSteps accumulator (host copies)."""
        moments = {}
        for path, t in zip(self.paths, self.leaves):
            st = self.adamw.state.get(t, {})
            if st:
                moments[path] = {"step": float(st["step"]), "exp_avg": st["exp_avg"].detach().cpu().clone(),
                                 "exp_avg_sq": st["exp_avg_sq"].detach().cpu().clone()}
        acc = None if self.acc is None else {p: a.detach().cpu().clone() for p, a in zip(self.paths, self.acc)}
        return {"count": self.count, "mini_step": self.mini_step, "moments": moments, "acc": acc}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore :meth:`state_dict` (or a JAX state through
        ``utils.jax_bridge.adamw_state_from_optax(..., cfg=)``); every saved
        path must be a trained leaf here."""
        index = dict(zip(self.paths, self.leaves))
        unknown = sorted(set(state["moments"]) - set(index))
        if unknown:
            raise ValueError(f"optimizer state for leaves this run does not train: {unknown[:4]}")

        def like(a, t):  # a tensor or an array as a copy in t's device and dtype
            return torch.as_tensor(a).to(t.device, t.dtype).clone()

        for path, st in state["moments"].items():
            t = index[path]
            self.adamw.state[t] = {"step": torch.tensor(float(st["step"]), dtype=torch.float32),
                                   "exp_avg": like(st["exp_avg"], t), "exp_avg_sq": like(st["exp_avg_sq"], t)}
        self.count = int(state.get("count", 0))
        self.mini_step = int(state.get("mini_step", 0))
        acc = state.get("acc")
        self.acc = None if acc is None else [like(acc[p], t) for p, t in zip(self.paths, self.leaves)]


# --- the steps -------------------------------------------------------------------


def _clamp_logit_scale(params: Params) -> None:
    with torch.no_grad():
        params["logit_scale"].clamp_(max=LOGIT_SCALE_MAX)


def _augmented(images: torch.Tensor, augment, generator, boxes, rows=None):
    """``images`` cropped to ``boxes``, or to boxes drawn from ``generator``
    (under a mesh ``rows`` = ``(n, idx)``: drawn for the global batch of n
    rows, of which this rank keeps ``idx``)."""
    from tapclip_tpu_torch.data.augment import draw_boxes, resample_boxes
    from tapclip_tpu_torch.data.preprocess import device_normalize

    if images.dtype == torch.uint8:  # normalise first: it commutes with the crop
        images = device_normalize(images)
    if boxes is None:
        B, H, W, _ = images.shape
        if rows is None:
            boxes = draw_boxes(generator, B, H, W, augment, device=images.device)
        else:
            n, idx = rows
            drawn = draw_boxes(generator, n, H, W, augment)
            boxes = {k: v[idx.to(v.device)].to(images.device) for k, v in drawn.items()}
    return resample_boxes(images, boxes)


class _Mesh:
    """What a pretraining step reads off its mesh: the ``data`` group the
    loss spans (None on one rank: the local loss, as the JAX step), the
    group the gradients are summed over (every mesh), the ``model`` group
    the towers run over, the GPipe runner of a ``pipe`` axis, the
    sequence-parallel and FSDP switches, and this rank's rows of a global
    batch.  Given the step's ``optimizer``, it points the clip's norm at the
    groups that cut each leaf."""

    def __init__(self, mesh, cfg: CLIPConfig, optimizer: Optional[PretrainOptimizer] = None, *,
                 pp_microbatches: int = 0, seq_parallel: bool = False, fsdp: bool = False):
        if mesh is not None and mesh.in_process:
            raise ValueError("a pretraining step takes a process-group mesh (make_mesh without devices=)")
        if mesh is not None and cfg.moe_experts > 0 and mesh.pp > 1:
            raise NotImplementedError("pipeline parallelism over MoE towers is not supported (expert + pipeline "
                                      "sharding do not compose yet)")
        if fsdp and (mesh is None or mesh.dp <= 1):
            raise ValueError("fsdp needs a mesh with a 'data' axis > 1")
        if seq_parallel and (mesh is None or mesh.tp <= 1):
            raise ValueError("seq_parallel needs a mesh with a 'model' axis > 1")
        self.mesh, self.seq_parallel, self.fsdp = mesh, seq_parallel, fsdp
        self.loss_group = mesh.data_group if mesh is not None and mesh.dp > 1 else None
        # this rank's share of the global batch's rows: the weight of its load-balance term
        self.lb_share = 1.0 if self.loss_group is None else 1.0 / mesh.dp
        self.tp_group = collectives.model_group_of(mesh)
        self.transformer_fn = None
        if mesh is not None and mesh.pp > 1:
            from tapclip_tpu_torch.parallel.pipeline import check_pipeline_geometry, make_pipeline_transformer_fn

            for n_layers in (cfg.vision_layers, cfg.text_layers):
                check_pipeline_geometry(n_layers, mesh.pp, batch=1, n_microbatches=1)
            self.transformer_fn = make_pipeline_transformer_fn(
                mesh, pp_microbatches or 2 * mesh.pp, remat=cfg.remat if cfg.remat != "none" else "full")
        self.summed = None  # per trained leaf: whether the step sums its gradient over data
        if mesh is not None and optimizer is not None:
            from tapclip_tpu_torch.parallel.sharding import shard_axes

            axes = shard_axes(zip(optimizer.paths, optimizer.leaves), mesh, fsdp)
            optimizer.shard_axes = axes
            optimizer.norm_groups = {DATA_AXIS: mesh.data_group, PIPE_AXIS: mesh.pipe_group, MODEL_AXIS: mesh.model_group}
            self.summed = [DATA_AXIS not in a for a in axes]

    def rows(self, b: int, k: int = 1):
        """``(n, idx)``: a global batch of k micro-batches of b * dp rows
        each, and this rank's rows of it (``sharding.shard_batch``'s for
        k = 1, ``shard_micro_batches``' for k > 1); None with no data axis."""
        if self.loss_group is None:
            return None
        dp, i = self.mesh.dp, self.mesh.data_index
        return k * b * dp, torch.cat([m * b * dp + i * b + torch.arange(b) for m in range(k)])

    def patch_idx(self, generator, b: int, cfg: CLIPConfig, device):
        """Patch dropout's kept indices for this rank's b rows: drawn for the
        global micro-batch, its rows kept (None: no draw under this mesh)."""
        rows = self.rows(b)
        if rows is None or generator is None or cfg.patch_dropout <= 0:
            return None
        idx = clip_model.patch_dropout_indices(generator, rows[0], cfg.grid_size ** 2, cfg.patch_dropout, device)
        return None if idx is None else idx[rows[1].to(idx.device)]

    def reduce(self, grads: List[Optional[torch.Tensor]], leaves) -> List[torch.Tensor]:
        """The gradients summed over ``data`` (a zero for a leaf not
        reached); an FSDP leaf's arrives summed (its gather's backward)."""
        if self.mesh is None:
            return grads
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
        summed = self.summed or [True] * len(grads)
        collectives.all_reduce_many_([g for g, s in zip(grads, summed) if s], self.mesh.data_group)
        return grads

    def loss(self, total: torch.Tensor) -> torch.Tensor:
        """The global objective from this rank's share."""
        total = total.detach()
        return total if self.loss_group is None else collectives.all_reduce_(total.clone(), self.loss_group)

    @contextlib.contextmanager
    def towers(self, params: Params):
        """The tree the towers read (the FSDP leaves outside the blocks
        gathered, the blocks' gathered at their use) inside the mesh's
        tensor-parallel and FSDP contexts."""
        state = None
        if self.fsdp:
            from tapclip_tpu_torch.parallel.sharding import fsdp_state

            state = fsdp_state(params, self.mesh)
        with collectives.tensor_parallel(self.tp_group), collectives.fully_sharded(state):
            yield params if state is None else state.gathered(params, skip=("blocks",))

    def encoder_kw(self) -> Dict[str, Any]:
        """The encoders' parallel arguments: the GPipe runner and sequence
        parallelism."""
        return {"transformer_fn": self.transformer_fn, "seq_parallel": self.seq_parallel}


def _batch(params: Params, images, token_ids):
    dev = params["logit_scale"].device
    return torch.as_tensor(images, device=dev), torch.as_tensor(token_ids, device=dev)


def _needs_draw(cfg: CLIPConfig, augment, generator, patch_idx, boxes) -> None:
    if generator is None and ((augment is not None and boxes is None)
                              or (cfg.patch_dropout > 0 and patch_idx is None)):
        raise ValueError("this step was built with augment/patch_dropout: pass a per-step torch.Generator "
                         "(or the draws themselves)")


def make_pretrain_step(cfg: CLIPConfig, optimizer: PretrainOptimizer, loss: str = "infonce",
                       augment=None, mesh=None, pp_microbatches: int = 0, seq_parallel: bool = False,
                       fsdp: bool = False) -> Callable:
    """The CLIP pretraining step over the whole tree:
    ``step(params, images, token_ids, generator=None, *, patch_idx=None,
    boxes=None) -> {"loss"}``, updating ``optimizer``'s leaves of ``params``
    in place and clamping ``logit_scale`` to ln 100 after the update.

    ``augment`` (``data.augment.AugmentConfig``): a random-resized crop of
    every sample first (``boxes`` from ``generator``, or given); with
    ``cfg.patch_dropout > 0`` the patches kept are drawn from ``generator``
    after the boxes (or given as ``patch_idx``).  Locks, BitFit and the
    like are the optimizer's leaves (:func:`set_trainable`).

    ``mesh``: each rank passes its rows (``sharding.shard_batch``) and its
    local tree (``sharding.shard_params``, with ``fsdp=True`` for
    ``fsdp``); the loss returned is the global batch's.  A ``pipe`` axis,
    ``pp_microbatches``, ``seq_parallel`` and ``fsdp``: the module note."""
    _check_loss(loss)
    m = _Mesh(mesh, cfg, optimizer, pp_microbatches=pp_microbatches, seq_parallel=seq_parallel, fsdp=fsdp)

    def step(params: Params, images, token_ids, generator: Optional[torch.Generator] = None, *,
             patch_idx=None, boxes=None) -> Dict[str, torch.Tensor]:
        _needs_draw(cfg, augment, generator, patch_idx, boxes)
        images, ids = _batch(params, images, token_ids)
        b = images.shape[0]
        if augment is not None:
            images = _augmented(images, augment, generator, boxes, m.rows(b))
        if patch_idx is None:
            patch_idx = m.patch_idx(generator, b, cfg, images.device)
        moe_losses: List[torch.Tensor] = []
        with m.towers(params) as tree:
            img = clip_model.encode_image(tree, cfg, images, generator=generator, patch_idx=patch_idx,
                                          moe_loss_out=moe_losses, **m.encoder_kw())
            txt = clip_model.encode_text(tree, cfg, ids, moe_loss_out=moe_losses, **m.encoder_kw())
        total = pair_loss(loss, params, img, txt, m.loss_group)
        if moe_losses:  # the Switch load balance over both towers' blocks, this rank's share of it
            total = total + cfg.moe_aux_weight * m.lb_share * sum(moe_losses)
        grads = m.reduce(torch.autograd.grad(total, optimizer.leaves, allow_unused=True), optimizer.leaves)
        if optimizer.update(grads):
            _clamp_logit_scale(params)
        return {"loss": m.loss(total)}

    return step


def make_accum_pretrain_step(cfg: CLIPConfig, optimizer: PretrainOptimizer, k: int, loss: str = "infonce",
                             augment=None, mesh=None) -> Callable:
    """GradCache accumulation (open_clip's ``--accum-freq``): the exact
    objective of a K·B batch at one micro-batch's activation memory.

    ``step(params, images [K*B, ...], token_ids [K*B, T], generator=None, *,
    patch_idx=None, boxes=None)``: the macro batch is augmented as one
    (``boxes`` over K·B rows), then

    1. every micro-batch is encoded with no graph, its features cached;
    2. the K·B loss and its gradients in the features (and in
       ``logit_scale`` / ``logit_bias``, which reach the loss directly) are
       taken once;
    3. each micro-batch is encoded again with a graph and its features'
       gradients are pulled back into the towers, summed over micro-batches.

    Patch dropout draws once per micro-batch (``patch_idx``: a list of K
    index tensors), and both passes use that draw, so cached and live
    features agree.  The sum is the one-shot K·B step's gradient; JAX takes
    the scale's K-fold gradient and divides it back, the port takes it once.

    MoE towers: each micro-batch's load-balance term ``lb_i`` (over its own
    rows: the K·B one needs every micro's activations at once) joins its
    live pass with weight ``moe_aux_weight / k``, as in the JAX package.  The
    loss returned is the objective whose gradient is taken, ``contrastive +
    moe_aux_weight / k * sum(lb_i)``; the JAX step reports ``contrastive +
    moe_aux_weight / k**2 * sum(lb_i)`` (it averages per-micro losses that
    each hold one ``lb_i / k``).

    ``mesh``: each rank passes its rows of every micro-batch in micro order
    (``sharding.shard_micro_batches``: micro i spans every rank, as JAX
    lays the macro batch out), so the negatives span K·B·dp and the draws
    are the dp = 1 step's."""
    _check_loss(loss)
    if k < 2:
        raise ValueError("accumulation needs k >= 2 (use make_pretrain_step)")
    if mesh is not None and mesh.pp > 1:
        raise ValueError("GradCache accumulation composes with dp/tp meshes, not with a pipe axis")
    m = _Mesh(mesh, cfg, optimizer)

    def step(params: Params, images, token_ids, generator: Optional[torch.Generator] = None, *,
             patch_idx=None, boxes=None) -> Dict[str, torch.Tensor]:
        _needs_draw(cfg, augment, generator, patch_idx, boxes)
        images, ids = _batch(params, images, token_ids)
        n = images.shape[0]
        if n % k:
            raise ValueError(f"macro batch {n} not divisible by k={k}")
        b = n // k
        if augment is not None:
            images = _augmented(images, augment, generator, boxes, m.rows(b, k))
        micro = [(images[i * b:(i + 1) * b], ids[i * b:(i + 1) * b]) for i in range(k)]
        if cfg.patch_dropout > 0 and patch_idx is None:
            n_patches = cfg.grid_size ** 2
            patch_idx = [m.patch_idx(generator, b, cfg, images.device) if m.loss_group is not None else
                         clip_model.patch_dropout_indices(generator, b, n_patches, cfg.patch_dropout, images.device)
                         for _ in range(k)]
        draws = patch_idx if patch_idx is not None else [None] * k

        def encode(i, moe_loss_out=None):
            x, t = micro[i]
            with collectives.tensor_parallel(m.tp_group):
                return (clip_model.encode_image(params, cfg, x, patch_idx=draws[i], moe_loss_out=moe_loss_out),
                        clip_model.encode_text(params, cfg, t, moe_loss_out=moe_loss_out))

        with torch.no_grad():
            cached = [encode(i) for i in range(k)]
        img_all = torch.cat([c[0] for c in cached]).requires_grad_(True)
        txt_all = torch.cat([c[1] for c in cached]).requires_grad_(True)
        direct = [t for p, t in zip(optimizer.paths, optimizer.leaves) if p in ("logit_scale", "logit_bias")]
        total = pair_loss(loss, params, img_all, txt_all, m.loss_group)
        g_img, g_txt, *g_direct = torch.autograd.grad(total, [img_all, txt_all, *direct])
        grads: Dict[int, torch.Tensor] = {id(t): g for t, g in zip(direct, g_direct)}
        tower = [t for t in optimizer.leaves if id(t) not in grads]
        total = total.detach()
        for i in range(k):
            lbs: List[torch.Tensor] = []
            fi, ft = encode(i, lbs)
            outs, cotangents = [fi, ft], [g_img[i * b:(i + 1) * b], g_txt[i * b:(i + 1) * b]]
            if lbs:
                lb = sum(lbs)
                total = total + cfg.moe_aux_weight / k * m.lb_share * lb.detach()
                if lb.requires_grad:
                    outs.append(lb)
                    cotangents.append(torch.full_like(lb, cfg.moe_aux_weight / k * m.lb_share))
            pulled = torch.autograd.grad(outs, tower, cotangents, allow_unused=True)
            for t, g in zip(tower, pulled):
                if g is not None:
                    grads[id(t)] = g if id(t) not in grads else grads[id(t)] + g
        if optimizer.update(m.reduce([grads.get(id(t)) for t in optimizer.leaves], optimizer.leaves)):
            _clamp_logit_scale(params)
        return {"loss": m.loss(total)}

    return step


def make_ema_update(decay: float) -> Callable:
    """``update(ema, params)``: ``ema = decay * ema + (1 - decay) * params``
    leaf by leaf, in place (open_clip / BYOL model averaging)."""

    @torch.no_grad()
    def update(ema_params, params):
        ema = [t for _, t in named_leaves(ema_params)]
        live = [t.detach().to(e.dtype) for (_, t), e in zip(named_leaves(params), ema)]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(live, 1.0 - decay))
        return ema_params

    return update


def make_validation_fn(cfg: CLIPConfig) -> Callable:
    """``validate(params, batches, max_samples=1024) -> (loss, recall)``:
    features of up to ``max_samples`` held-out ``(images, token_ids)`` pairs
    (e.g. a ``data.shards.ShardLoader``), then the contrastive loss and
    retrieval Recall@1/5/10 over them (the open_clip validation readout)."""
    from tapclip_tpu_torch.utils.eval_metrics import retrieval_recall

    def validate(params, batches: Iterable, max_samples: int = 1024):
        imgs, txts, n = [], [], 0
        dev = params["logit_scale"].device
        with torch.inference_mode():
            for images, ids in batches:
                x = torch.as_tensor(images, device=dev)
                imgs.append(clip_model.encode_image(params, cfg, x).float().cpu().numpy())
                txts.append(clip_model.encode_text(params, cfg, ids).float().cpu().numpy())
                n += int(x.shape[0])
                if n >= max_samples:
                    break
            if not imgs:
                raise ValueError("validation stream produced no batches")
            img = np.concatenate(imgs)[:max_samples]
            txt = np.concatenate(txts)[:max_samples]
            vloss = float(contrastive_loss_local(torch.from_numpy(img), torch.from_numpy(txt),
                                                 params["logit_scale"].detach().float().cpu()))
        return vloss, retrieval_recall(img, txt)

    return validate
