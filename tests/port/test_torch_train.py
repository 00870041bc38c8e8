"""The port's training slice against the JAX package, on the CPU.

* B4 / B5: the port's plain backward of the fused attention block and of the
  fused MLP against the JAX package's Pallas backward kernels run in
  interpret mode, all seven outputs, f32 at rtol = atol = 1e-5 (summation
  order, and the TPU kernel's erf polynomial, <= 1.5e-7), with valid < T
  and valid = T and more than one row tile; one bfloat16 case each at
  rtol = atol = 2e-2 (both sides round the same intermediates to bf16, but a
  value that lands on the other side of a rounding step moves by one bf16
  ulp, 2^-8 relative, and a weight gradient sums many of them).
* The autograd Functions: ``torch.autograd.grad`` through
  ``fused_mlp_block`` / ``fused_attn_block`` equals the plain backward.
* ``make_train_step``: a 5-step AdamW trajectory against JAX's
  ``make_train_step`` at ``TINY_TEST``, cached-feature and pixels-in, loss,
  ``grad_norm`` and ``ctx`` at rtol 1e-4, atol 5e-6 (as
  ``tests/test_grad_oracle.py``).
* ``fit_prompt_model``: histories against JAX's on a small ``CachedSet``;
  the best-state snapshot does not alias the live ``ctx``; resume from a
  JAX mid-training state through ``adamw_state_from_optax``.

JAX routes to XLA on the CPU; the port's kernel wrappers run their plain
versions.  Batch 4 and capacity 8 throughout: ``tests/test_scale.py`` counts
JAX compiles of a batch-2 forward at capacity 16 in the same worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapclip_tpu import trainer as jtrainer
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.config import PromptConfig as JPromptConfig
from tapclip_tpu.config import TrainConfig as JTrainConfig
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models import model_wrapper as jmw
from tapclip_tpu.models.attribution_monitor import attribution_entropy as j_attribution_entropy
from tapclip_tpu.ops.fused_mha import _attn_block_bwd_impl
from tapclip_tpu.ops.fused_mlp import _fused_mlp_bwd_impl
from tapclip_tpu.parallel import train_step as jts

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import trainer as ttrainer
from tapclip_tpu_torch.models import model_wrapper as tmw
from tapclip_tpu_torch.models.attribution_monitor import attribution_entropy
from tapclip_tpu_torch.ops.fused_mha import attn_block_bwd_reference, attn_block_reference, fused_attn_block
from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block, fused_mlp_bwd_reference, fused_mlp_reference
from tapclip_tpu_torch.parallel import train_step as tts
from tapclip_tpu_torch.utils.jax_bridge import adamw_state_from_optax, params_from_jax, prompt_state_from_jax
from tapclip_tpu_torch.utils.logging_utils import StepTimer

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
TRAJ_TOL = dict(rtol=1e-4, atol=5e-6)
B, T, W, HEADS, HID = 2, 16, 128, 2, 512
CLASSES = ["Backpack", "Pen", "Mug"]
NAMES = ("dx", "dgamma", "dbeta", "dw_1", "db_1", "dw_2", "db_2")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_grads(got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(_np(g).reshape(-1), _np(w).reshape(-1), err_msg=name, **tol)


@pytest.fixture(scope="module")
def blk():
    rng = np.random.default_rng(0)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return {
        "x": f(B, T, W), "g": f(B, T, W),
        "mlp": [1.0 + f(W, scale=0.1), f(W, scale=0.1), f(W, HID, scale=0.05), f(HID, scale=0.1),
                f(HID, W, scale=0.05), f(W, scale=0.1)],
        "attn": [1.0 + f(W, scale=0.1), f(W, scale=0.1), f(W, 3 * W, scale=W ** -0.5),
                 f(3 * W, scale=0.1), f(W, W, scale=W ** -0.5), f(W, scale=0.1)],
    }


DTYPES = [(jnp.float32, torch.float32, TOL), (jnp.bfloat16, torch.bfloat16, BF16_TOL)]


# --- B5: fused MLP backward ---------------------------------------------------


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_mlp_bwd_plain_matches_pallas_interpret(blk, jdt, tdt, tol):
    p = blk["mlp"]
    # row_tile 8 over R = 32 rows: four grid steps accumulate the weight grads.
    want = _fused_mlp_bwd_impl(jnp.asarray(blk["x"], jdt), *map(jnp.asarray, p),
                               jnp.asarray(blk["g"], jdt), 1e-5, 8, True)
    got = fused_mlp_bwd_reference(torch.from_numpy(blk["x"]).to(tdt), torch.from_numpy(blk["g"]).to(tdt),
                                  *map(torch.from_numpy, p[:5]), 1e-5)
    assert got[0].dtype == tdt and all(t.dtype == torch.float32 for t in got[1:])
    _assert_grads(got, want, tol)


# --- B4: fused attention block backward ----------------------------------------


@pytest.mark.parametrize(
    "jdt,tdt,tol,valid",
    [(*DTYPES[0], 13), (*DTYPES[0], T), (*DTYPES[1], 13)],
    ids=["f32-valid<T", "f32-valid=T", "bf16-valid<T"],
)
def test_attn_block_bwd_plain_matches_pallas_interpret(blk, jdt, tdt, tol, valid):
    p = blk["attn"]
    # block_b 1 over B = 2: two grid steps accumulate the weight grads.
    want = _attn_block_bwd_impl(
        jnp.asarray(blk["x"], jdt), *map(jnp.asarray, p[:5]), jnp.asarray(blk["g"], jdt),
        n_heads=HEADS, valid=valid, eps=1e-5, block_b=1, interpret=True, stage_batched=False,
    )
    got = attn_block_bwd_reference(torch.from_numpy(blk["x"]).to(tdt), torch.from_numpy(blk["g"]).to(tdt),
                                   *map(torch.from_numpy, p[:5]), HEADS, valid, 1e-5)
    _assert_grads(got, want, tol)


# --- the autograd Functions ----------------------------------------------------


def _leaves(arrays):
    return [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]


def test_fused_mlp_function_grads_equal_plain_backward(blk):
    x, *p = _leaves([blk["x"], *blk["mlp"]])
    g = torch.from_numpy(blk["g"])
    out = fused_mlp_block(x, {"scale": p[0], "bias": p[1]},
                          dict(zip(("w_fc", "b_fc", "w_proj", "b_proj"), p[2:])))
    got = torch.autograd.grad(out, [x, *p], g)
    want = fused_mlp_bwd_reference(x.detach(), g, *[t.detach() for t in p[:5]], 1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b.reshape(a.shape), rtol=0, atol=0)
    # and equals autograd through the plain forward
    auto = torch.autograd.grad(fused_mlp_reference(x, *p), [x, *p], g)
    for a, b in zip(got, auto):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("valid", [13, T], ids=["valid<T", "valid=T"])
def test_fused_attn_block_function_grads_equal_plain_backward(blk, valid):
    x, *p = _leaves([blk["x"], *blk["attn"]])
    g = torch.from_numpy(blk["g"])
    out = fused_attn_block(x, {"scale": p[0], "bias": p[1]},
                           dict(zip(("w_qkv", "b_qkv", "w_out", "b_out"), p[2:])), HEADS, valid_len=valid)
    got = torch.autograd.grad(out, [x, *p], g)
    want = attn_block_bwd_reference(x.detach(), g, *[t.detach() for t in p[:5]], HEADS, valid, 1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b.reshape(a.shape), rtol=0, atol=0)
    auto = torch.autograd.grad(attn_block_reference(x, *p, HEADS, valid, 1e-5), [x, *p], g)
    for a, b in zip(got, auto):
        torch.testing.assert_close(a, b, **TOL)


def test_functions_differentiate_input_only():
    """Frozen weights (the prompt-tuning case): only dx is asked for."""
    torch.manual_seed(0)
    x = torch.randn(2, 8, 64, requires_grad=True)
    ln = {"scale": torch.ones(64), "bias": torch.zeros(64)}
    mlp = {"w_fc": torch.randn(64, 256) * 0.1, "b_fc": torch.zeros(256),
           "w_proj": torch.randn(256, 64) * 0.1, "b_proj": torch.zeros(64)}
    attn = {"w_qkv": torch.randn(64, 192) * 0.1, "b_qkv": torch.zeros(192),
            "w_out": torch.randn(64, 64) * 0.1, "b_out": torch.zeros(64)}
    y = fused_mlp_block(fused_attn_block(x, ln, attn, 2, valid_len=6), ln, mlp)
    (dx,) = torch.autograd.grad(y.square().sum(), [x])
    assert dx.shape == x.shape and torch.isfinite(dx).all()
    assert all(not t.requires_grad for t in (*ln.values(), *mlp.values()))


# --- model, monitors, timer ------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jc = J_TINY
    jp = jclip.init_clip_params(jax.random.PRNGKey(0), jc)
    tc = tcfg.CLIPConfig(**{f: getattr(jc, f) for f in jc.__dataclass_fields__})
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return jc, jp, tc, tp


def _models(tiny):
    jc, jp, tc, tp = tiny
    jm = jmw.FullModel(CLASSES, jp, jc, rng=jax.random.PRNGKey(3))
    tm = tmw.FullModel(CLASSES, tp, tc)
    tm.trainable, tm.prompt_learner.bank = prompt_state_from_jax(
        jax.tree.map(np.asarray, jm.trainable), jax.tree.map(np.asarray, jm.prompt_learner.bank)
    )
    return jm, tm


def _batch(rng, jc, n, pixels):
    x = (rng.standard_normal((n, jc.image_size, jc.image_size, 3)) if pixels
         else rng.standard_normal((n, jc.embed_dim))).astype(np.float32)
    labels = rng.integers(0, len(CLASSES), n).astype(np.int32)
    return x, labels


def test_full_model_forward_image_feats_and_batch_mask(tiny):
    jm, tm = _models(tiny)
    jc, jp, tc, tp = tiny
    feats, labels = _batch(np.random.default_rng(1), jc, 4, pixels=False)
    mask = np.array([True, True, False, True])
    want = jmw.full_model_forward(
        jp, jm.trainable, jm.prompt_learner.bank, None, jnp.asarray(labels), clip_cfg=jc,
        prompt_cfg=JPromptConfig(), with_loss=True, image_feats=jnp.asarray(feats),
        batch_mask=jnp.asarray(mask),
    )
    got = tmw.full_model_forward(
        tp, tm.trainable, tm.prompt_learner.bank, None, torch.from_numpy(labels), clip_cfg=tc,
        prompt_cfg=tcfg.PromptConfig(), with_loss=True, image_feats=torch.from_numpy(feats),
        batch_mask=torch.from_numpy(mask),
    )
    live = np.asarray(jm.prompt_learner.bank.class_mask)
    np.testing.assert_allclose(_np(got["logits"])[:, live], _np(want["logits"])[:, live], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(got["loss"]), _np(want["loss"]), rtol=1e-5, atol=1e-6)


def test_attribution_pass_builds_no_graph(tiny):
    jm, tm = _models(tiny)
    jc, jp, tc, tp = tiny
    ctx = tm.trainable["ctx"].clone().requires_grad_()
    feats, attribution = tmw.text_features_with_attribution(
        tp, ctx, tm.prompt_learner.bank, tc, tcfg.PromptConfig(), tm.trainable["adjustor"])
    assert feats.requires_grad and not attribution.requires_grad
    assert attribution.grad_fn is None


def test_attribution_entropy_matches():
    a = np.random.default_rng(4).dirichlet(np.ones(5), size=6).astype(np.float32)
    np.testing.assert_allclose(_np(attribution_entropy(torch.from_numpy(a))),
                               _np(j_attribution_entropy(jnp.asarray(a))), rtol=1e-6, atol=1e-6)


def test_step_timer():
    timer = StepTimer(warmup=1)
    for items in (4, 8, 8):
        timer.tic()
        timer.toc(items)
    assert len(timer._times) == 2 and timer.mean_step_s >= 0.0
    assert timer.items_per_sec > 0.0
    assert np.isnan(StepTimer().mean_step_s)


# --- make_train_step: 5-step trajectory ------------------------------------------


@pytest.mark.parametrize("pixels", [False, True], ids=["cached-features", "pixels-in"])
def test_train_step_trajectory_matches_jax(tiny, pixels):
    jc, jp, tc, tp = tiny
    jm, tm = _models(tiny)
    rng = np.random.default_rng(7)
    batches = [_batch(rng, jc, 4, pixels) for _ in range(5)]
    mask = np.array([True, True, True, False])  # one padded row

    jopt = jts.make_optimizer(JTrainConfig(lr=2e-3, weight_decay=0.01))
    jstate = jts.init_train_state(jm.trainable, jopt)
    jstep = jts.make_train_step(jc, JPromptConfig(), jopt, use_image_feats=not pixels)
    tstate = tts.init_train_state(tm.trainable, tts.make_optimizer(tcfg.TrainConfig(lr=2e-3, weight_decay=0.01)))
    tstep = tts.make_train_step(tc, tcfg.PromptConfig(), use_image_feats=not pixels)
    for x, labels in batches:
        jstate, jm_ = jstep(jp, jstate, jm.prompt_learner.bank, jnp.asarray(x), jnp.asarray(labels),
                            jnp.asarray(mask))
        tstate, tm_ = tstep(tp, tstate, tm.prompt_learner.bank, x, labels, mask)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(_np(tm_[k]), _np(jm_[k]), err_msg=k, **TRAJ_TOL)
    assert tstate.step == int(jstate.step) == 5
    np.testing.assert_allclose(_np(tstate.params["ctx"]), _np(jstate.params["ctx"]), **TRAJ_TOL)
    # the model's own tensors were not updated in place by the state
    np.testing.assert_array_equal(_np(tm.trainable["ctx"]), _np(jm.trainable["ctx"]))


def test_resume_from_jax_state_matches_jax(tiny):
    """Three JAX steps, then two more in each package from the same state."""
    jc, jp, tc, tp = tiny
    jm, tm = _models(tiny)
    rng = np.random.default_rng(9)
    batches = [_batch(rng, jc, 4, pixels=False) for _ in range(5)]
    mask = np.ones(4, bool)
    cfg = dict(lr=5e-3, weight_decay=0.01)
    jopt = jts.make_optimizer(JTrainConfig(**cfg))
    jstate = jts.init_train_state(jm.trainable, jopt)
    jstep = jts.make_train_step(jc, JPromptConfig(), jopt)
    for x, labels in batches[:3]:
        jstate, _ = jstep(jp, jstate, jm.prompt_learner.bank, jnp.asarray(x), jnp.asarray(labels),
                          jnp.asarray(mask))
    trainable, _ = prompt_state_from_jax(jax.tree.map(np.asarray, jstate.params), jm.prompt_learner.bank)
    opt_state = adamw_state_from_optax(jax.tree.map(np.asarray, jstate.opt_state))
    assert len(opt_state) == 1 and opt_state[0]["step"] == 3
    tstate = tts.init_train_state(trainable, tts.make_optimizer(tcfg.TrainConfig(**cfg)),
                                  step=int(jstate.step), opt_state=opt_state)
    tstep = tts.make_train_step(tc, tcfg.PromptConfig())
    for x, labels in batches[3:]:
        jstate, jm_ = jstep(jp, jstate, jm.prompt_learner.bank, jnp.asarray(x), jnp.asarray(labels),
                            jnp.asarray(mask))
        tstate, tm_ = tstep(tp, tstate, tm.prompt_learner.bank, x, labels, mask)
        np.testing.assert_allclose(_np(tm_["loss"]), _np(jm_["loss"]), **TRAJ_TOL)
    np.testing.assert_allclose(_np(tstate.params["ctx"]), _np(jstate.params["ctx"]), **TRAJ_TOL)
    moments = tstate.opt_state()[0]
    np.testing.assert_allclose(_np(moments["exp_avg"]), _np(jstate.opt_state[0].mu["ctx"]), **TRAJ_TOL)
    assert float(moments["step"]) == 5


def test_adamw_state_from_fresh_optax_state_is_empty(tiny):
    jm, _ = _models(tiny)
    jopt = jts.make_optimizer(JTrainConfig())
    jstate = jts.init_train_state(jm.trainable, jopt, ("ctx", "logit_scale"))
    assert adamw_state_from_optax(jax.tree.map(np.asarray, jstate.opt_state)) == [{}, {}]
    with pytest.raises(ValueError, match="Adam state"):
        adamw_state_from_optax(())


# --- fit_prompt_model ------------------------------------------------------------


def _cached_sets(jc, n_train=12, n_val=8, seed=11):
    rng = np.random.default_rng(seed)
    tr, va = _batch(rng, jc, n_train, False), _batch(rng, jc, n_val, False)
    return tr, va


def test_fit_prompt_model_histories_match_jax(tiny):
    jc, jp, tc, tp = tiny
    jm, tm = _models(tiny)
    (xtr, ytr), (xva, yva) = _cached_sets(jc)
    kw = dict(lr=5e-2, epochs=3, batch_size=4, patience=10)
    jres = jtrainer.fit_prompt_model(jm, jtrainer.CachedSet(xtr, ytr), jtrainer.CachedSet(xva, yva),
                                     JTrainConfig(**kw), verbose=False)
    tres = ttrainer.fit_prompt_model(tm, ttrainer.CachedSet(xtr, ytr), ttrainer.CachedSet(xva, yva),
                                     tcfg.TrainConfig(**kw), verbose=False)
    assert tres.epochs_run == jres.epochs_run == 3
    np.testing.assert_allclose(tres.loss_history, jres.loss_history, **TRAJ_TOL)
    np.testing.assert_allclose(tres.attr_entropy, jres.attr_entropy, **TRAJ_TOL)
    assert tres.acc_history == jres.acc_history
    assert tres.best_acc == jres.best_acc
    assert tres.per_class_history == jres.per_class_history
    np.testing.assert_allclose(_np(tres.best_trainable["ctx"]), _np(jres.best_trainable["ctx"]), **TRAJ_TOL)
    np.testing.assert_allclose(_np(tm.trainable["ctx"]), _np(jm.trainable["ctx"]), **TRAJ_TOL)


def test_fit_best_state_is_a_snapshot(tiny):
    """AdamW updates ``ctx`` in place; the best state must not follow it."""
    jc, jp, tc, tp = tiny
    _, tm = _models(tiny)
    (xtr, ytr), (xva, yva) = _cached_sets(jc, seed=12)
    res = ttrainer.fit_prompt_model(tm, ttrainer.CachedSet(xtr, ytr), ttrainer.CachedSet(xva, yva),
                                    tcfg.TrainConfig(lr=5e-2, epochs=2, batch_size=4), verbose=False)
    best = res.best_trainable["ctx"]
    live = tm.trainable["ctx"]
    assert best.data_ptr() != live.data_ptr() and not best.requires_grad
    before = best.clone()
    with torch.no_grad():
        live.add_(1.0)
    torch.testing.assert_close(best, before, rtol=0, atol=0)


def test_fit_resume_from_jax_state_matches_jax(tiny):
    """Both fits resume from the same JAX mid-training state."""
    jc, jp, tc, tp = tiny
    jm, tm = _models(tiny)
    (xtr, ytr), (xva, yva) = _cached_sets(jc, seed=13)
    kw = dict(lr=5e-2, epochs=1, batch_size=4)
    jopt = jts.make_optimizer(JTrainConfig(**kw))
    jstate = jts.init_train_state(jm.trainable, jopt)
    jstep = jts.make_train_step(jc, JPromptConfig(), jopt)
    for s in range(2):
        jstate, _ = jstep(jp, jstate, jm.prompt_learner.bank, jnp.asarray(xtr[4 * s:4 * s + 4]),
                          jnp.asarray(ytr[4 * s:4 * s + 4]), jnp.ones(4, bool))
    j_resume = {"trainable": jstate.params, "opt_state": jstate.opt_state, "step": int(jstate.step)}
    t_resume = {"trainable": jax.tree.map(np.asarray, jstate.params),
                "opt_state": adamw_state_from_optax(jax.tree.map(np.asarray, jstate.opt_state)),
                "step": int(jstate.step)}
    jres = jtrainer.fit_prompt_model(jm, jtrainer.CachedSet(xtr, ytr), jtrainer.CachedSet(xva, yva),
                                     JTrainConfig(**kw), verbose=False, resume_state=j_resume)
    seen = []
    tres = ttrainer.fit_prompt_model(tm, ttrainer.CachedSet(xtr, ytr), ttrainer.CachedSet(xva, yva),
                                     tcfg.TrainConfig(**kw), verbose=False, resume_state=t_resume,
                                     checkpoint_cb=lambda e, st, acc: seen.append((e, st.step, acc)),
                                     checkpoint_every=1)
    np.testing.assert_allclose(tres.loss_history, jres.loss_history, **TRAJ_TOL)
    np.testing.assert_allclose(_np(tres.final_state.params["ctx"]), _np(jres.final_state.params["ctx"]),
                               **TRAJ_TOL)
    assert seen == [(1, 2 + 3, tres.acc_history[0])]


def test_fine_tune_on_few_shot_matches_jax(tiny):
    jc, jp, tc, tp = tiny
    jm, tm = _models(tiny)
    (xtr, ytr), _ = _cached_sets(jc, n_train=8, seed=14)
    jres = jtrainer.fine_tune_on_few_shot(jm, jtrainer.CachedSet(xtr, ytr), steps=2)
    tres = ttrainer.fine_tune_on_few_shot(tm, ttrainer.CachedSet(xtr, ytr), steps=2)
    np.testing.assert_allclose(tres.loss_history, jres.loss_history, **TRAJ_TOL)
    assert tres.acc_history == [] and tres.best_acc == 0.0


# --- what is not ported yet -------------------------------------------------------


@pytest.mark.parametrize("option", ["kg_lambda", "prograd_lambda", "scl_lambda"])
def test_unported_options_raise(tiny, option):
    jc, jp, tc, tp = tiny
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tts.make_train_step(tc, tcfg.PromptConfig(), **{option: 0.1})
    _, tm = _models(tiny)
    loader = [np.zeros((1, 4))]  # never read: the options are refused first
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ttrainer.fit_prompt_model(tm, loader, None, tcfg.TrainConfig(**{option: 0.1}), verbose=False)


def test_unknown_trainable_key_raises(tiny):
    _, tm = _models(tiny)
    with pytest.raises(ValueError, match="not in model.trainable"):
        ttrainer.fit_prompt_model(tm, None, None, tcfg.TrainConfig(), trainable_keys=("nope",))
