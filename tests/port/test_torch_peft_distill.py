"""LoRA (``peft.py``) and distillation (``distill.py``) against the JAX package, on the CPU.

* LoRA: JAX's adapters bridged by ``lora_from_jax``; the merged tree equals
  JAX's ``merge_lora`` (rtol 1e-6) and an init merge is the base tree bit
  for bit; a 3-step ``make_lora_pretrain_step`` trajectory against JAX's
  (losses rtol 1e-4, atol 5e-6; the adapters as
  ``test_torch_pretrain._assert_tree`` holds parameters); the base tree and
  ``logit_scale`` bit-identical after the steps.
* Distillation: ``distill_loss_local`` and its three parts against JAX's
  (rtol 1e-6), with and without the ``kd_proj`` head; a 3-step
  ``make_distill_step`` trajectory against JAX's at the tolerances above,
  ``strip_distill_params``, ``init_distill_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tapclip_tpu import distill as jdist
from tapclip_tpu import peft as jpeft
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.models import clip as jclip

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import distill as tdist
from tapclip_tpu_torch import peft as tpeft
from tapclip_tpu_torch import pretrain as tpre
from tapclip_tpu_torch.utils.jax_bridge import lora_from_jax, params_from_jax

from test_torch_pretrain import LR, TRAJ_TOL, WD, _assert_tree, _batches, _np

torch.set_num_threads(1)

T_TINY = tcfg.TINY_TEST
# A teacher whose joint space is wider than the student's: kd_proj bridges it.
J_TEACHER = J_TINY.replace(embed_dim=48)
T_TEACHER = T_TINY.replace(embed_dim=48)


@pytest.fixture(scope="module")
def tiny():
    return jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY))


@pytest.fixture(scope="module")
def lora(tiny):
    return jax.tree.map(np.asarray, jpeft.init_lora_params(jax.random.PRNGKey(1), tiny, rank=4))


def test_lora_bridge_and_merge_match_jax(tiny, lora):
    tp, tl = params_from_jax(tiny, T_TINY), lora_from_jax(lora)
    assert tpeft.lora_param_count(tl) == jpeft.lora_param_count(lora) == 2 * 2 * 4 * (
        (64 + 192) + (64 + 64) + (64 + 256) + (256 + 64))
    rng = np.random.default_rng(4)
    moved = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32), lora)
    want = params_from_jax(jax.tree.map(np.asarray, jpeft.merge_lora(tiny, moved, alpha=8.0)), T_TINY)
    got = tpeft.merge_lora(tp, lora_from_jax(moved), alpha=8.0)
    for (path, g), (_, w) in zip(tpre.named_leaves(got), tpre.named_leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-6, err_msg=path)
    at_init = tpeft.merge_lora(tp, tl)  # B = 0: the base tree exactly
    for (path, g), (_, w) in zip(tpre.named_leaves(at_init), tpre.named_leaves(tp)):
        assert torch.equal(g, w), path
    fresh = tpeft.init_lora_params(torch.Generator().manual_seed(0), tp, rank=4)
    assert [(p, tuple(t.shape)) for p, t in tpre.named_leaves(fresh)] == [
        (p, tuple(t.shape)) for p, t in tpre.named_leaves(tl)]
    assert all(float(t.abs().max()) == 0.0 for p, t in tpre.named_leaves(fresh) if p.endswith("/b"))


@pytest.mark.parametrize("loss", ["infonce", "siglip"])
def test_lora_trajectory_matches_jax(tiny, lora, loss):
    from tapclip_tpu import pretrain as jpre

    jp = tiny if loss == "infonce" else jax.tree.map(np.asarray, jpre.add_siglip_params(tiny))
    if loss == "siglip":  # JAX's adapter tree mirrors the tree it was made from (logit_bias: None)
        lora = jax.tree.map(np.asarray, jpeft.init_lora_params(jax.random.PRNGKey(1), jp, rank=4))
    batches = _batches(J_TINY)
    opt = optax.adamw(LR, weight_decay=WD)
    jstep = jpeft.make_lora_pretrain_step(J_TINY, opt, loss=loss, alpha=8.0)
    jparams, jl_tree = jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, lora)
    state = opt.init(jl_tree)
    jl = []
    for x, ids in batches:
        jl_tree, state, m = jstep(jparams, jl_tree, state, jnp.asarray(x), jnp.asarray(ids))
        jl.append(float(m["loss"]))
    tp, tl = params_from_jax(jp, T_TINY), lora_from_jax(lora)
    base = tpre.detached_copy(tp)
    tpre.set_trainable(tp, {p: False for p, _ in tpre.named_leaves(tp)})
    opt_t = tpre.PretrainOptimizer(tpre.set_trainable(tl), lr=LR, weight_decay=WD)
    step = tpeft.make_lora_pretrain_step(T_TINY, opt_t, loss=loss, alpha=8.0)
    got = [float(step(tp, tl, x, ids)["loss"]) for x, ids in batches]
    np.testing.assert_allclose(got, jl, **TRAJ_TOL)
    _assert_tree(tl, dict(tpre.named_leaves(lora_from_jax(jax.tree.map(np.asarray, jl_tree)))), TRAJ_TOL)
    for (path, a), (_, b) in zip(tpre.named_leaves(tp), tpre.named_leaves(base)):
        assert torch.equal(a, b), path  # no base weight (and not logit_scale) moves


def _feats(seed, n=8, e=32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, e)).astype(np.float32)


@pytest.mark.parametrize("proj", [False, True])
def test_distill_loss_matches_jax(proj):
    s_img, s_txt = _feats(1), _feats(2)
    t_img, t_txt = (_feats(3, e=48), _feats(4, e=48)) if proj else (_feats(3), _feats(4))
    kd = _feats(5, n=32, e=48) * 0.2 if proj else None
    kw = dict(tau=2.0, w_task=0.5, w_kd=1.5, w_feat=0.7)
    args = (s_img, s_txt, t_img, t_txt, np.float32(2.0), np.float32(3.0))
    jt, jparts = jdist.distill_loss_local(*map(jnp.asarray, args), None if kd is None else jnp.asarray(kd), **kw)
    tt, tparts = tdist.distill_loss_local(*map(torch.as_tensor, args),
                                          None if kd is None else torch.from_numpy(kd), **kw)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    for k in ("task", "kd", "feat"):
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]), rtol=1e-6, atol=1e-7, err_msg=k)


def test_distill_trajectory_matches_jax(tiny):
    teacher = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(5), J_TEACHER))
    student = jax.tree.map(np.asarray, jdist.init_distill_params(jax.random.PRNGKey(2), tiny, 32, 48))
    assert student["kd_proj"].shape == (32, 48)
    kw = dict(tau=2.0, w_task=1.0, w_kd=0.5, w_feat=0.5)
    opt = optax.adamw(LR, weight_decay=WD)
    jstep = jdist.make_distill_step(J_TINY, J_TEACHER, opt, **kw)
    batches = _batches(J_TINY)
    js, jt = jax.tree.map(jnp.asarray, student), jax.tree.map(jnp.asarray, teacher)
    state = opt.init(js)
    jl = []
    for x, ids in batches:
        js, state, m = jstep(js, jt, state, jnp.asarray(x), jnp.asarray(ids))
        jl.append([float(m[k]) for k in ("loss", "task", "kd", "feat")])
    ts, tt = params_from_jax(student, T_TINY), params_from_jax(teacher, T_TEACHER)
    teacher_before = tpre.detached_copy(tt)
    opt_t = tpre.PretrainOptimizer(tpre.set_trainable(ts), lr=LR, weight_decay=WD)
    step = tdist.make_distill_step(T_TINY, T_TEACHER, opt_t, **kw)
    got = []
    for x, ids in batches:
        m = step(ts, tt, x, ids)
        got.append([float(m[k]) for k in ("loss", "task", "kd", "feat")])
    np.testing.assert_allclose(got, jl, **TRAJ_TOL)
    _assert_tree(ts, dict(tpre.named_leaves(params_from_jax(jax.tree.map(np.asarray, js), T_TINY))), TRAJ_TOL)
    for (path, a), (_, b) in zip(tpre.named_leaves(tt), tpre.named_leaves(teacher_before)):
        assert torch.equal(a, b) and not a.requires_grad, path
    assert "kd_proj" not in tdist.strip_distill_params(ts) and "kd_proj" in ts
    same = tdist.init_distill_params(torch.Generator().manual_seed(0), params_from_jax(tiny, T_TINY), 32, 32)
    assert "kd_proj" not in same
    fresh = tdist.init_distill_params(torch.Generator().manual_seed(0), params_from_jax(tiny, T_TINY), 32, 48)
    assert tuple(fresh["kd_proj"].shape) == (32, 48)
