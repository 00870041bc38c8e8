"""CLIP knowledge distillation: a frozen teacher into a student.

Counterpart of ``tapclip_tpu/distill.py`` (TinyCLIP / CLIP-KD style), three
terms:

* **task**: the student's own InfoNCE (``pretrain.contrastive_loss_local``);
* **kd**: row-wise ``KL(teacher || student)`` over the batch similarity
  matrix, both directions, at temperature ``tau`` with the ``tau^2``
  correction, each model's logits at its own ``logit_scale``;
* **feat**: ``1 - cos(student_e @ kd_proj, teacher_e)`` per modality, with a
  learnable ``kd_proj`` head when the embed dims differ (stripped at export
  by :func:`strip_distill_params`).

The teacher runs under ``torch.inference_mode`` (no graph, nothing saved);
the gradient reaches the student tree, ``kd_proj`` included.  Under a
mesh (``make_distill_step(mesh=)``), :func:`distill_loss_global` takes this
rank's rows against every rank's columns for the task InfoNCE and the KD
KL, and returns its share of the global objective; the student's gradients
are summed over ``data`` as in ``pretrain.py``.  Under a ``model`` axis
both towers of both models run tensor parallel: each rank holds its shards
of the student and of the teacher (each cut with its own config's heads and
hidden width by ``sharding.shard_params``), the teacher's blocks run their
partial modes under ``inference_mode``, and ``kd_proj`` stays replicated.
The step refuses the pipe axis, and ``pretrain_cli`` FSDP and MoE
students, in the JAX CLI's words.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from tapclip_tpu_torch.config import CLIPConfig
from tapclip_tpu_torch.models import clip as clip_model
from tapclip_tpu_torch.parallel import collectives
from tapclip_tpu_torch.pretrain import (
    PretrainOptimizer, _batch, _clamp_logit_scale, _Mesh, contrastive_loss_global, contrastive_loss_local,
)

Params = Dict[str, Any]


def init_distill_params(generator: torch.Generator, student_params: Params, student_embed_dim: int,
                        teacher_embed_dim: int) -> Params:
    """The student tree, plus ``kd_proj [E_s, E_t]`` ``N(0, 1/E_s)`` drawn
    from ``generator`` when the embed dims differ."""
    if student_embed_dim == teacher_embed_dim:
        return dict(student_params)
    w = torch.randn((student_embed_dim, teacher_embed_dim), generator=generator, device=generator.device,
                    dtype=torch.float32) * student_embed_dim ** -0.5
    return dict(student_params, kd_proj=w.to(student_params["logit_scale"].device))


def strip_distill_params(params: Params) -> Params:
    """The tree without its training-only ``kd_proj`` head: a plain CLIP tree."""
    return {k: v for k, v in params.items() if k != "kd_proj"}


def _kd_kl(t_logits: torch.Tensor, s_logits: torch.Tensor, tau: float) -> torch.Tensor:
    """Mean row-wise KL(teacher || student) at temperature tau (x tau^2)."""
    t = torch.log_softmax(t_logits / tau, dim=-1)
    s = torch.log_softmax(s_logits / tau, dim=-1)
    return (tau * tau) * torch.mean(torch.sum(torch.exp(t) * (t - s), dim=-1))


def _feat_mimic(s_e: torch.Tensor, t_e: torch.Tensor, kd_proj) -> torch.Tensor:
    """1 - cos between the (projected) student and the teacher embeddings."""
    if kd_proj is not None:
        s_e = s_e @ kd_proj
    s_e = clip_model.l2_normalize(s_e)
    return 1.0 - torch.mean(torch.sum(s_e * t_e, dim=-1))


def distill_loss_local(s_img, s_txt, t_img, t_txt, s_scale, t_scale, kd_proj, *, tau: float = 1.0,
                       w_task: float = 1.0, w_kd: float = 1.0,
                       w_feat: float = 1.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The single-device objective on un-normalised features (normalised
    here); returns ``(total, {"task", "kd", "feat"})``."""
    si = clip_model.l2_normalize(s_img).float()
    st = clip_model.l2_normalize(s_txt).float()
    ti = clip_model.l2_normalize(t_img).float()
    tt = clip_model.l2_normalize(t_txt).float()
    task = contrastive_loss_local(s_img, s_txt, s_scale)
    s_logits = torch.exp(s_scale.float()) * si @ st.T
    t_logits = torch.exp(t_scale.float()) * ti @ tt.T
    kd = 0.5 * (_kd_kl(t_logits, s_logits, tau) + _kd_kl(t_logits.T, s_logits.T, tau))
    feat = 0.5 * (_feat_mimic(s_img.float(), ti, kd_proj) + _feat_mimic(s_txt.float(), tt, kd_proj))
    total = w_task * task + w_kd * kd + w_feat * feat
    return total, {"task": task, "kd": kd, "feat": feat}


def distill_loss_global(s_img, s_txt, t_img, t_txt, s_scale, t_scale, kd_proj, group, *, tau: float = 1.0,
                        w_task: float = 1.0, w_kd: float = 1.0,
                        w_feat: float = 1.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`distill_loss_local` over the global batch of ``group``: this
    rank's rows against every rank's columns (both models' features
    all-gathered), the feature mimicry per row.  Returns ``(share, parts)``,
    this rank's shares of the objective and of each term; the shares sum to
    the single-device values on the gathered batch."""
    si = clip_model.l2_normalize(s_img).float()
    st = clip_model.l2_normalize(s_txt).float()
    ti = clip_model.l2_normalize(t_img).float()
    tt = clip_model.l2_normalize(t_txt).float()
    n_global = si.shape[0] * collectives.size(group)
    task = contrastive_loss_global(s_img, s_txt, s_scale, group)
    s_i = torch.exp(s_scale.float()) * si @ collectives.all_gather(st, group).T
    s_t = torch.exp(s_scale.float()) * st @ collectives.all_gather(si, group).T
    t_i = torch.exp(t_scale.float()) * ti @ collectives.all_gather(tt, group).T
    t_t = torch.exp(t_scale.float()) * tt @ collectives.all_gather(ti, group).T
    rows = si.shape[0] / n_global  # _kd_kl and _feat_mimic take means over this rank's rows
    kd = 0.5 * (_kd_kl(t_i, s_i, tau) + _kd_kl(t_t, s_t, tau)) * rows
    feat = 0.5 * (_feat_mimic(s_img.float(), ti, kd_proj) + _feat_mimic(s_txt.float(), tt, kd_proj)) * rows
    total = w_task * task + w_kd * kd + w_feat * feat
    return total, {"task": task, "kd": kd, "feat": feat}


def make_distill_step(student_cfg: CLIPConfig, teacher_cfg: CLIPConfig, optimizer: PretrainOptimizer, *,
                      tau: float = 1.0, w_task: float = 1.0, w_kd: float = 1.0, w_feat: float = 1.0,
                      mesh=None) -> Callable:
    """``step(student, teacher, images, token_ids) -> {"loss", "task", "kd",
    "feat"}``: the teacher's features with no graph, the student's loss and
    one update of ``optimizer``'s leaves of ``student`` in place, then the
    ``logit_scale`` clamp.  ``mesh``: each rank passes its rows; the values
    are the global batch's; under a ``model`` axis each rank passes its
    shards of both trees (the module note)."""
    m = _Mesh(mesh, student_cfg, optimizer)
    if m.transformer_fn is not None:
        raise ValueError("--distill-teacher does not compose with --pp/--fsdp yet (dp/tp only)")

    def step(student: Params, teacher: Params, images, token_ids) -> Dict[str, torch.Tensor]:
        images, ids = _batch(student, images, token_ids)
        with collectives.tensor_parallel(m.tp_group):
            with torch.inference_mode():
                t_img = clip_model.encode_image(teacher, teacher_cfg, images)
                t_txt = clip_model.encode_text(teacher, teacher_cfg, ids)
            t_img, t_txt = t_img.clone(), t_txt.clone()  # out of inference mode, usable under a graph
            s_img = clip_model.encode_image(student, student_cfg, images)
            s_txt = clip_model.encode_text(student, student_cfg, ids)
        t_scale = teacher["logit_scale"].detach()
        args = (s_img, s_txt, t_img, t_txt, student["logit_scale"], t_scale, student.get("kd_proj"))
        kw = dict(tau=tau, w_task=w_task, w_kd=w_kd, w_feat=w_feat)
        if m.loss_group is not None:
            total, parts = distill_loss_global(*args, m.loss_group, **kw)
        else:
            total, parts = distill_loss_local(*args, **kw)
        grads = m.reduce(torch.autograd.grad(total, optimizer.leaves, allow_unused=True), optimizer.leaves)
        if optimizer.update(grads):
            _clamp_logit_scale(student)
        return {"loss": m.loss(total), **{k: m.loss(v) for k, v in parts.items()}}

    return step
