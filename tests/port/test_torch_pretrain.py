"""The port's pretraining steps against the JAX package's, on the CPU.

* Losses: InfoNCE and SigLIP against ``tapclip_tpu.pretrain`` at rtol 1e-6.
* The optimizer pieces written out: ``warmup_cosine_decay_schedule``
  (rtol 1e-6: JAX evaluates it in f32), ``clip_by_global_norm`` and the
  ``MultiSteps`` mean against optax (rtol 1e-6).
* Trajectories (3 steps at ``TINY_TEST``, batch 8, weights bridged from one
  JAX init): the plain step, SigLIP, ``MultiSteps`` + clip + cosine, the
  image lock (the tower bit-identical), ``unlocked_groups``, BitFit (every
  non-bias leaf bit-identical), patch dropout with JAX's draw, the RN tower
  and GradCache against JAX's accumulation step.  Losses at rtol 1e-4,
  atol 5e-6 (``test_torch_train.py``'s trajectory tolerance: f32 summation
  order through the towers, then AdamW); the step's gradients in every leaf
  at rtol 1e-4, atol 1e-5; the parameters as ``_assert_tree`` says (AdamW
  turns a gradient entry that is rounding noise into a move of up to lr).
* GradCache equals the one-shot K·B step of the port itself (losses and
  parameters at rtol 1e-5, atol 1e-6: only the summation order of the
  pulled-back gradients differs); remat gives the gradients of no remat
  (rtol 1e-5, atol 1e-6, as ``tests/test_pretrain.py``); augmentation with
  given boxes is the step on the resampled batch, bit for bit.
* EMA, validation (loss rtol 1e-5, Recall@K exact) and a resume from a JAX
  optimizer state through ``adamw_state_from_optax(..., cfg=)``.

JAX routes to XLA on the CPU; the port's kernel wrappers run their plain
versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tapclip_tpu import pretrain as jpre
from tapclip_tpu.config import MODEL_PRESETS as J_PRESETS
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.models import clip as jclip

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import pretrain as tpre
from tapclip_tpu_torch.data.augment import AugmentConfig, resample_boxes
from tapclip_tpu_torch.models import clip as tclip
from tapclip_tpu_torch.utils.jax_bridge import adamw_state_from_optax, params_from_jax

torch.set_num_threads(1)

TRAJ_TOL = dict(rtol=1e-4, atol=5e-6)
SELF_TOL = dict(rtol=1e-5, atol=1e-6)
B, STEPS, LR, WD = 8, 3, 1e-3, 0.01
T_TINY = tcfg.TINY_TEST


def _batch(cfg, n=B, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    ids = rng.integers(1, cfg.vocab_size - 2, (n, cfg.context_length)).astype(np.int32)
    ids[:, 0] = cfg.vocab_size - 2
    ids[np.arange(n), rng.integers(3, cfg.context_length, n)] = cfg.vocab_size - 1  # EOT, the largest id
    return images, ids


def _np(t):
    return t.detach().float().cpu().numpy()


def _leaves_of_jax(jtree, cfg):
    return dict(tpre.named_leaves(params_from_jax(jax.tree.map(np.asarray, jtree), cfg)))


def _assert_tree(got: dict, want: dict, tol, steps=STEPS, share=1000):
    """Every leaf of ``got`` against ``want``.  AdamW divides each gradient
    entry by its own running RMS, so an entry whose gradient is rounding
    noise on both sides (the key third of ``attn/b_qkv`` and the RN pool's
    ``k_proj/b`` always: the loss does not depend on a key bias) moves by up to lr per step in either
    direction.  So: every entry within 2 lr per step, and at most one in
    ``share`` of a leaf's entries (at least two) outside ``tol``; the
    gradients themselves are held tightly by
    ``test_pretrain_gradients_match_jax``."""
    got = dict(tpre.named_leaves(got))
    assert sorted(got) == sorted(want)
    for path in sorted(want):
        g, w = _np(got[path]).reshape(-1), _np(want[path]).reshape(-1)
        diff = np.abs(g - w)
        assert diff.max(initial=0.0) <= 2 * LR * steps, (path, diff.max())
        if path.endswith("attnpool/k_proj/b"):  # the RN pool's key bias: the same invariance
            continue
        if path.endswith("attn/b_qkv"):
            W = g.shape[0] // 3
            g, w, diff = (np.delete(a, np.s_[W:2 * W]) for a in (g, w, diff))
        outside = int((diff > tol["atol"] + tol["rtol"] * np.abs(w)).sum())
        assert outside <= max(2, g.size // share), (path, outside, g.size, diff.max(initial=0.0))


@pytest.fixture(scope="module")
def tiny():
    jp = jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY)
    return jax.tree.map(np.asarray, jp)


def _port(np_tree, cfg=T_TINY):
    return params_from_jax(np_tree, cfg)


def _jax_run(step, opt, params, batches, extra=lambda i: ()):
    params = jax.tree.map(jnp.asarray, params)
    state = opt.init(params)
    losses = []
    for i, (x, ids) in enumerate(batches):
        params, state, m = step(params, state, jnp.asarray(x), jnp.asarray(ids), *extra(i))
        losses.append(float(m["loss"]))
    return losses, params


def _torch_run(step, params, batches, extra=lambda i: {}):
    return [float(step(params, x, ids, **extra(i))["loss"]) for i, (x, ids) in enumerate(batches)], params


def _batches(cfg, n=B, steps=STEPS):
    return [_batch(cfg, n, seed=s) for s in range(steps)]


# --- losses and the optimizer pieces ---------------------------------------------


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    img, txt = (rng.standard_normal((8, 16)).astype(np.float32) for _ in range(2))
    scale, bias = np.float32(2.3), np.float32(-3.0)
    j = float(jpre.contrastive_loss_local(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale)))
    t = float(tpre.contrastive_loss_local(torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(scale)))
    np.testing.assert_allclose(t, j, rtol=1e-6)
    j = float(jpre.siglip_loss_local(*map(jnp.asarray, (img, txt, scale, bias))))
    t = float(tpre.siglip_loss_local(*map(torch.as_tensor, (img, txt, scale, bias))))
    np.testing.assert_allclose(t, j, rtol=1e-6)
    tp = tpre.add_siglip_params({"logit_scale": torch.tensor(1.0)})
    assert float(tp["logit_bias"]) == float(jpre.add_siglip_params({})["logit_bias"]) == -10.0
    assert float(tpre.add_siglip_params(dict(tp, logit_bias=torch.tensor(2.0)))["logit_bias"]) == 2.0


def test_pretrain_gradients_match_jax(tiny):
    """The step's loss and gradients in every leaf, rtol 1e-4, atol 1e-5
    (f32 summation order through both towers; the gradients are of order 1)."""
    x, ids = _batch(J_TINY)

    def jloss(p):
        return jpre.contrastive_loss_local(jclip.encode_image(p, J_TINY, jnp.asarray(x)),
                                           jclip.encode_text(p, J_TINY, jnp.asarray(ids)), p["logit_scale"])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, tiny))
    tp = _port(tiny)
    leaves = tpre.set_trainable(tp)
    tl = tpre.contrastive_loss_local(tclip.encode_image(tp, T_TINY, torch.from_numpy(x)),
                                     tclip.encode_text(tp, T_TINY, ids), tp["logit_scale"])
    tg = torch.autograd.grad(tl, [t for _, t in leaves])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    want = _leaves_of_jax(jg, J_TINY)
    for (path, _), g in zip(leaves, tg):
        np.testing.assert_allclose(_np(g), _np(want[path]), rtol=1e-4, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (1, 2)])
def test_warmup_cosine_schedule_matches_optax(warmup, total):
    j = optax.warmup_cosine_decay_schedule(init_value=0.0, peak_value=0.1, warmup_steps=warmup,
                                           decay_steps=total, end_value=0.0)
    t = tpre.warmup_cosine_decay_schedule(0.0, 0.1, warmup, total, 0.0)
    np.testing.assert_allclose([t(c) for c in range(total + 3)], [float(j(c)) for c in range(total + 3)],
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), ())]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = tpre.clip_by_global_norm([torch.from_numpy(np.array(g)) for g in grads], max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_multisteps_mean_matches_optax():
    rng = np.random.default_rng(3)
    opt = optax.MultiSteps(optax.sgd(1.0), every_k_schedule=3)
    state = opt.init(jnp.zeros(4))
    acc = [torch.zeros(4)]
    for i in range(2):
        g = rng.standard_normal(4).astype(np.float32)
        _, state = opt.update(jnp.asarray(g), state)
        acc = tpre.multisteps_mean(acc, [torch.from_numpy(g)], i)
        np.testing.assert_allclose(_np(acc[0]), np.asarray(state.acc_grads), rtol=1e-6, atol=1e-7)


# --- trajectories ----------------------------------------------------------------


def _adamw(**kw):
    return optax.adamw(LR, weight_decay=WD, **kw)


def _port_opt(params, trainable=None, **kw):
    return tpre.PretrainOptimizer(tpre.set_trainable(params, trainable), lr=kw.pop("lr", LR), weight_decay=WD, **kw)


@pytest.mark.parametrize("loss", ["infonce", "siglip"])
def test_pretrain_trajectory_matches_jax(tiny, loss):
    jp = tiny if loss == "infonce" else jax.tree.map(np.asarray, jpre.add_siglip_params(tiny))
    batches = _batches(J_TINY)
    opt = _adamw()
    jl, jout = _jax_run(jpre.make_pretrain_step(J_TINY, opt, loss=loss), opt, jp, batches)
    tp = _port(jp)
    tl, tout = _torch_run(tpre.make_pretrain_step(T_TINY, _port_opt(tp), loss=loss), tp, batches)
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)
    assert jl[-1] < jl[0]
    _assert_tree(tout, _leaves_of_jax(jout, J_TINY), TRAJ_TOL)


def test_multisteps_clip_cosine_trajectory_matches_jax(tiny):
    """The CLI's chain: MultiSteps(K=2) over clip_by_global_norm over adamw(cosine), 4 micro steps."""
    sched = optax.warmup_cosine_decay_schedule(0.0, LR, 1, 4, 0.0)
    opt = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(sched, weight_decay=WD)),
                           every_k_schedule=2)
    batches = _batches(J_TINY, steps=4)
    jl, jout = _jax_run(jpre.make_pretrain_step(J_TINY, opt), opt, tiny, batches)
    tp = _port(tiny)
    topt = _port_opt(tp, lr=tpre.warmup_cosine_decay_schedule(0.0, LR, 1, 4, 0.0), grad_clip=0.5, accum_steps=2)
    tl, tout = _torch_run(tpre.make_pretrain_step(T_TINY, topt), tp, batches)
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)
    assert topt.count == 2 and topt.mini_step == 0
    _assert_tree(tout, _leaves_of_jax(jout, J_TINY), TRAJ_TOL)


@pytest.mark.parametrize("unlocked", [0, 2])
def test_image_lock_trajectory_matches_jax(tiny, unlocked):
    """LiT: a full lock leaves the image tower bit-identical; unlocked_groups 2
    trains the head and the last block only."""
    batches = _batches(J_TINY)
    opt = jpre.lock_tower_optimizer(_adamw(), lock_image=True, unlocked_groups=unlocked)
    jstep = jpre.make_pretrain_step(J_TINY, opt, lock_image=unlocked == 0)
    jl, jout = _jax_run(jstep, opt, tiny, batches)
    tp = _port(tiny)
    before = tpre.detached_copy(tp)
    mask = tpre.lock_tower_trainable(tp, lock_image=True, unlocked_groups=unlocked)
    tl, tout = _torch_run(tpre.make_pretrain_step(T_TINY, _port_opt(tp, mask)), tp, batches)
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)
    _assert_tree(tout, _leaves_of_jax(jout, J_TINY), TRAJ_TOL)
    frozen = [p for p, trains in mask.items() if not trains]
    assert frozen and all(p.startswith("visual/") for p in frozen)
    if unlocked:
        assert not mask["visual/blocks/0/attn/w_qkv"] and mask["visual/blocks/1/attn/w_qkv"]
        assert mask["visual/proj"] and not mask["visual/patch_embed/w"]
    old, new = dict(tpre.named_leaves(before)), dict(tpre.named_leaves(tout))
    for path in frozen:
        assert torch.equal(old[path], new[path]), path


def test_bitfit_trajectory_matches_jax(tiny):
    batches = _batches(J_TINY)
    opt = jpre.bitfit_optimizer(_adamw())
    jl, jout = _jax_run(jpre.make_pretrain_step(J_TINY, opt), opt, tiny, batches)
    tp = _port(tiny)
    before = tpre.detached_copy(tp)
    mask = tpre.bitfit_trainable(tp)
    tl, tout = _torch_run(tpre.make_pretrain_step(T_TINY, _port_opt(tp, mask)), tp, batches)
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)
    _assert_tree(tout, _leaves_of_jax(jout, J_TINY), TRAJ_TOL)
    trained = sorted(p for p, t in mask.items() if t)
    assert "visual/blocks/0/attn/b_qkv" in trained and "text/ln_final/bias" in trained
    assert "logit_scale" in trained and "visual/blocks/0/ln_1/scale" not in trained
    old, new = dict(tpre.named_leaves(before)), dict(tpre.named_leaves(tout))
    for path, trains in mask.items():
        assert trains or torch.equal(old[path], new[path]), path


def _jax_patch_idx(rng, b, n_patches, prob):
    n_keep = max(1, int(round(n_patches * (1.0 - prob))))
    return np.asarray(jax.lax.top_k(jax.random.uniform(rng, (b, n_patches)), n_keep)[1])


def test_patch_dropout_trajectory_matches_jax(tiny):
    """Patch dropout 0.5 (4 patches -> 2 kept), JAX's index draw fed in."""
    jc, tc = J_TINY.replace(patch_dropout=0.5), T_TINY.replace(patch_dropout=0.5)
    batches = _batches(jc)
    rngs = [jax.random.fold_in(jax.random.PRNGKey(7), i) for i in range(STEPS)]
    opt = _adamw()
    jl, jout = _jax_run(jpre.make_pretrain_step(jc, opt), opt, tiny, batches, extra=lambda i: (rngs[i],))
    idx = [_jax_patch_idx(jax.random.split(r)[1], B, 4, 0.5) for r in rngs]
    assert idx[0].shape == (B, 2)
    tp = _port(tiny)
    step = tpre.make_pretrain_step(tc, _port_opt(tp))
    tl, tout = _torch_run(step, tp, batches, extra=lambda i: {"patch_idx": torch.from_numpy(idx[i])})
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)
    _assert_tree(tout, _leaves_of_jax(jout, jc), TRAJ_TOL)
    with pytest.raises(ValueError, match="per-step torch.Generator"):
        step(tp, *batches[0])


def test_augment_with_given_boxes_is_the_step_on_the_resampled_batch(tiny):
    x, ids = _batch(J_TINY)
    g = torch.Generator().manual_seed(0)
    from tapclip_tpu_torch.data.augment import draw_boxes

    boxes = draw_boxes(g, B, 32, 32, AugmentConfig(scale=(0.5, 1.0), hflip=0.5))
    losses = []
    for aug in (AugmentConfig(scale=(0.5, 1.0), hflip=0.5), None):
        tp = _port(tiny)
        step = tpre.make_pretrain_step(T_TINY, _port_opt(tp), augment=aug)
        xin = x if aug else _np(resample_boxes(torch.from_numpy(x), boxes))
        losses.append(float(step(tp, xin, ids, boxes=boxes if aug else None)["loss"]))
        losses.append(tp)
    assert losses[0] == losses[2]
    _assert_tree(losses[1], dict(tpre.named_leaves(losses[3])), dict(rtol=0, atol=0))


def test_gradcache_equals_one_shot_and_matches_jax(tiny):
    """K = 2 micro-batches of 4: the loss and the update of the one-shot
    batch-8 step (the port's own), and JAX's accumulation step."""
    batches = _batches(J_TINY, steps=2)
    one = _port(tiny)
    l1, out1 = _torch_run(tpre.make_pretrain_step(T_TINY, _port_opt(one)), one, batches)
    acc = _port(tiny)
    l2, out2 = _torch_run(tpre.make_accum_pretrain_step(T_TINY, _port_opt(acc), 2), acc, batches)
    np.testing.assert_allclose(l2, l1, **SELF_TOL)
    _assert_tree(out2, dict(tpre.named_leaves(out1)), SELF_TOL)
    opt = _adamw()
    jl, jout = _jax_run(jpre.make_accum_pretrain_step(J_TINY, opt, 2), opt, tiny, batches)
    np.testing.assert_allclose(l2, jl, **TRAJ_TOL)
    _assert_tree(out2, _leaves_of_jax(jout, J_TINY), TRAJ_TOL)
    with pytest.raises(ValueError, match="k >= 2"):
        tpre.make_accum_pretrain_step(T_TINY, _port_opt(_port(tiny)), 1)


def test_gradcache_patch_dropout_draws_once_per_micro_batch(tiny):
    """With patch dropout the cached and the live features use one draw per
    micro-batch: the step equals the one-shot step fed the concatenated draw."""
    tc = T_TINY.replace(patch_dropout=0.5)
    x, ids = _batch(J_TINY)
    idx = [torch.randperm(4, generator=torch.Generator().manual_seed(i))[:2].repeat(4, 1) for i in range(2)]
    one, acc = _port(tiny), _port(tiny)
    l1 = tpre.make_pretrain_step(tc, _port_opt(one))(one, x, ids, patch_idx=torch.cat(idx))["loss"]
    l2 = tpre.make_accum_pretrain_step(tc, _port_opt(acc), 2)(acc, x, ids, patch_idx=idx)["loss"]
    np.testing.assert_allclose(float(l2), float(l1), **SELF_TOL)
    _assert_tree(acc, dict(tpre.named_leaves(one)), SELF_TOL)


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_gradients_equal_no_remat(tiny, policy):
    x, ids = _batch(J_TINY)
    grads = []
    for cfg in (T_TINY, T_TINY.replace(remat=policy)):
        tp = _port(tiny)
        leaves = tpre.set_trainable(tp)
        loss = tpre.contrastive_loss_local(tclip.encode_image(tp, cfg, torch.from_numpy(x)),
                                           tclip.encode_text(tp, cfg, ids), tp["logit_scale"])
        grads.append(torch.autograd.grad(loss, [t for _, t in leaves]))
    for a, b in zip(*grads):
        np.testing.assert_allclose(_np(b), _np(a), **SELF_TOL)
    with pytest.raises(ValueError, match="unknown remat policy"):
        tclip.encode_text(_port(tiny), T_TINY.replace(remat="some"), ids)


def test_rn_tower_trajectory_matches_jax():
    """One RN-family config at small width: the convolutional tower trains
    too.  Its gradients are held at rtol 1e-4, atol 1e-5; after two AdamW
    steps at most one in a hundred entries of a leaf lies outside the
    trajectory tolerance (the convolutions' f32 order differs between XLA
    and ATen, and AdamW scales the noise of near-zero gradient entries)."""
    jc = dataclasses.replace(J_PRESETS["RN50"], image_size=64, vision_width=64, resnet_layers=(1, 1, 1, 1),
                             text_width=64, text_layers=2, text_heads=4, embed_dim=32, vocab_size=520,
                             context_length=16)
    tc = tcfg.CLIPConfig(**{f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)})
    jp = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(3), jc))
    batches = _batches(jc, n=4, steps=2)
    opt = _adamw()
    jl, jout = _jax_run(jpre.make_pretrain_step(jc, opt), opt, jp, batches)
    x, ids = batches[0]

    def jloss(p):
        return jpre.contrastive_loss_local(jclip.encode_image(p, jc, jnp.asarray(x)),
                                           jclip.encode_text(p, jc, jnp.asarray(ids)), p["logit_scale"])

    jg = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, jp))
    tp = params_from_jax(jp, tc)
    leaves = tpre.set_trainable(tp)
    tg = torch.autograd.grad(tpre.contrastive_loss_local(tclip.encode_image(tp, tc, torch.from_numpy(x)),
                                                         tclip.encode_text(tp, tc, ids), tp["logit_scale"]),
                             [t for _, t in leaves])
    want = dict(tpre.named_leaves(params_from_jax(jax.tree.map(np.asarray, jg), tc)))
    for (path, _), g in zip(leaves, tg):
        np.testing.assert_allclose(_np(g), _np(want[path]), rtol=1e-4, atol=1e-5, err_msg=path)
    tl, tout = _torch_run(tpre.make_pretrain_step(tc, _port_opt(tp)), tp, batches)
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)
    _assert_tree(tout, dict(tpre.named_leaves(params_from_jax(jax.tree.map(np.asarray, jout), tc))), TRAJ_TOL,
                 steps=2, share=100)
    with pytest.raises(ValueError, match="stacked-blocks"):
        tpre.lock_tower_trainable(tp, lock_image=True, unlocked_groups=1)


def test_resume_from_a_jax_state(tiny):
    """MultiSteps(K=2): one JAX micro step, then the update step from JAX's
    state (moments, count, accumulator) in the port."""
    batches = _batches(J_TINY, steps=2)
    opt = optax.MultiSteps(optax.adamw(LR, weight_decay=WD), every_k_schedule=2)
    step = jpre.make_pretrain_step(J_TINY, opt)
    params = jax.tree.map(jnp.asarray, tiny)
    params, state, _ = step(params, opt.init(params), *map(jnp.asarray, batches[0]))
    mid, mid_state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    params, state, _ = step(params, state, *map(jnp.asarray, batches[1]))
    tp = _port(mid)
    topt = _port_opt(tp, accum_steps=2)
    topt.load_state_dict(adamw_state_from_optax(mid_state, T_TINY))
    assert topt.mini_step == 1 and topt.count == 0
    tpre.make_pretrain_step(T_TINY, topt)(tp, *batches[1])
    assert topt.count == 1 and topt.mini_step == 0
    _assert_tree(tp, _leaves_of_jax(params, J_TINY), TRAJ_TOL)


def test_ema_and_validation_match_jax(tiny):
    jp = jax.tree.map(jnp.asarray, tiny)
    target = jax.tree.map(lambda a: a + 1.0, jp)
    upd = jpre.make_ema_update(0.5)
    ema = jax.tree.map(jnp.copy, jp)
    tema, ttarget = _port(tiny), _port(jax.tree.map(np.asarray, target))
    tupd = tpre.make_ema_update(0.5)
    for _ in range(3):
        ema = upd(ema, target)
        tupd(tema, ttarget)
    _assert_tree(tema, _leaves_of_jax(ema, J_TINY), dict(rtol=1e-6, atol=1e-7))
    batches = [_batch(J_TINY, n=4, seed=s) for s in range(3)]
    jloss, jrec = jpre.make_validation_fn(J_TINY)(jp, iter(batches), max_samples=10)
    tloss, trec = tpre.make_validation_fn(T_TINY)(_port(tiny), iter(batches), max_samples=10)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert trec == jrec
