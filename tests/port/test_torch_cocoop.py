"""Image-conditioned (CoCoOp) prompts against the JAX package, on the CPU.

Both packages get the tiny config's weights (``params_from_jax``) and the
same prompt state with a nonzero meta-net (``prompt_state_from_jax``), and
the same numpy inputs from a seed.

* The forward in both text modes: logits, the per-sample ``[B, C, P]``
  attribution and the ``[B, C, E]`` text features at FWD_TOL (1e-5; f32,
  only the order of the sums differs); at init (``w2 = 0``) the conditioned
  model equals the unconditioned one and every sample's attribution row is
  the class-level row.
* The meta-net's gradient: ``torch.autograd.grad`` against ``jax.grad`` at
  GRAD_TOL (rtol 1e-4, atol 1e-6), nonzero through the zero-init ``w2``.
* ``make_train_step``: 3 steps in both text modes, CE alone and with each
  anchor (kg, scl, ProGrad), ``ctx`` and ``meta_net`` trained: every metric
  (``loss_kg`` a scalar) at TRAJ_TOL (rtol 1e-4, atol 5e-6, as
  ``test_torch_anchored.py``), both leaves at TRAJ_NORM_TOL (2e-5 of each
  leaf's norm: each f32 trajectory's distance from a float64 one, twice).
* ``fit_prompt_model``'s default keys (``ctx`` and ``meta_net``),
  ``fit_promptsrc``'s GPA over the meta-net, ``add_class_prompt``,
  ``PredictService``'s per-sample batches and ``/explain``, and
  ``predict_corpus`` (``None`` attribution) against the JAX package; the
  ``.pt`` round trip and a resume with the meta-net and its AdamW state.

Batch 4 at capacity 8 (``tests/test_scale.py`` counts JAX compiles of a
batch-2 forward at capacity 16 in the same worker).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tapclip_tpu import predict as j_predict
from tapclip_tpu import promptsrc as jpsrc
from tapclip_tpu import trainer as jtrainer
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.config import PromptConfig as JPromptConfig
from tapclip_tpu.config import TrainConfig as JTrainConfig
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models import model_wrapper as jmw
from tapclip_tpu.parallel import train_step as jts
from tapclip_tpu.serve import PredictService as JPredictService

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import predict as t_predict
from tapclip_tpu_torch import promptsrc as tpsrc
from tapclip_tpu_torch import trainer as ttrainer
from tapclip_tpu_torch.models import model_wrapper as tmw
from tapclip_tpu_torch.parallel import train_step as tts
from tapclip_tpu_torch.serve import PredictService
from tapclip_tpu_torch.utils import checkpoint as tckpt
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax, prompt_state_from_jax

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-4, atol=5e-6)
# The trained leaves after the trajectory: AdamW divides each entry's update by its own gradient's
# scale, so an entry whose gradient is small beside the sums that make it carries their f32
# rounding into its move.  Each f32 trajectory lies within 1e-5 of the leaf's norm from a float64
# run of the JAX step (measured on ref_compat-ce's ctx: 5.0e-6 the port, 8.3e-6 JAX; one entry of
# 1536 then differs by 2.4e-5 between the two), so two f32 trajectories within twice that.
TRAJ_NORM_TOL = 2e-5
CLASSES = ["Backpack", "Pen", "Mug"]
MODES = ["ref_compat", "idiomatic"]
B = 4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def tiny():
    jc = J_TINY
    jp = jclip.init_clip_params(jax.random.PRNGKey(0), jc)
    tc = tcfg.CLIPConfig(**{f: getattr(jc, f) for f in jc.__dataclass_fields__})
    return jc, jp, tc, params_from_jax(jax.tree.map(np.asarray, jp), tc)


def _pcfg(mode="ref_compat", **kw):
    kw = dict(image_conditioned=True, text_mode=mode, prompt_len=3, **kw)
    return JPromptConfig(**kw), tcfg.PromptConfig(**kw)


def _models(tiny, mode="ref_compat", *, w2_scale=0.2, classes=CLASSES, **kw):
    """(JAX model, port model) with one prompt state: the JAX init, its
    meta-net's ``w2`` drawn nonzero (``w2_scale`` 0 keeps the zero init)."""
    jc, jp, tc, tp = tiny
    jpc, tpc = _pcfg(mode, **kw)
    jm = jmw.FullModel(classes, jp, jc, prompt_cfg=jpc, rng=jax.random.PRNGKey(3))
    mn = dict(jm.trainable["meta_net"])
    w2 = np.random.default_rng(0).standard_normal(mn["w2"].shape) * w2_scale
    jm.trainable = dict(jm.trainable, meta_net=dict(mn, w2=jnp.asarray(w2, jnp.float32)))
    tm = tmw.FullModel(classes, tp, tc, prompt_cfg=tpc)
    tm.trainable, tm.prompt_learner.bank = prompt_state_from_jax(
        jax.tree.map(np.asarray, jm.trainable), jax.tree.map(np.asarray, jm.prompt_learner.bank))
    return jm, tm


def _images(seed, n=B, size=32):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


# --- init and forward ------------------------------------------------------------------


def test_init_trainable_meta_net_shapes_and_zero_output_layer(tiny):
    jc, _, tc, _ = tiny
    jm, tm = _models(tiny, w2_scale=0.0)
    fresh = tmw.FullModel(CLASSES, tiny[3], tc, prompt_cfg=_pcfg()[1]).trainable["meta_net"]
    h = max(jc.embed_dim // 16, 8)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        "w1": (jc.embed_dim, h), "b1": (h,), "w2": (h, jc.text_width), "b2": (jc.text_width,)}
    assert all(float(fresh[k].abs().max()) == 0.0 for k in ("b1", "w2", "b2"))
    np.testing.assert_allclose(float(fresh["w1"].std()), jc.embed_dim ** -0.5, rtol=0.2)
    wide = tmw.FullModel(CLASSES, tiny[3], tc, prompt_cfg=_pcfg(meta_hidden=12)[1]).trainable["meta_net"]
    assert tuple(wide["w1"].shape) == (jc.embed_dim, 12)


@pytest.mark.parametrize("mode", MODES)
def test_zero_init_equals_the_unconditioned_model(tiny, mode):
    jc, jp, tc, tp = tiny
    _, cond = _models(tiny, mode, w2_scale=0.0)
    base = tmw.FullModel(CLASSES, tp, tc, prompt_cfg=tcfg.PromptConfig(text_mode=mode, prompt_len=3))
    base.trainable = dict(base.trainable, ctx=cond.trainable["ctx"])
    x = _images(1)
    ob, oc = base(x), cond(x)
    np.testing.assert_allclose(_np(oc["logits"]), _np(ob["logits"]), **FWD_TOL)
    a = _np(oc["attribution"])
    assert a.shape == (B, len(CLASSES), 3)
    np.testing.assert_allclose(a, np.broadcast_to(a[:1], a.shape), atol=1e-6)
    np.testing.assert_allclose(a[0], _np(ob["attribution"]), atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_jax_with_per_sample_attribution(tiny, mode):
    jc, jp, tc, tp = tiny
    jm, tm = _models(tiny, mode)
    feats = np.random.default_rng(2).standard_normal((B, jc.embed_dim)).astype(np.float32)
    kw = dict(with_loss=True, return_text_feats=True)
    labels = np.array([0, 1, 2, 0])
    want = jmw.full_model_forward(jp, jm.trainable, jm.prompt_learner.bank, None, jnp.asarray(labels),
                                  clip_cfg=jc, prompt_cfg=jm.prompt_cfg, image_feats=jnp.asarray(feats), **kw)
    with torch.no_grad():
        got = tmw.full_model_forward(tp, tm.trainable, tm.prompt_learner.bank, None, torch.from_numpy(labels),
                                     clip_cfg=tc, prompt_cfg=tm.prompt_cfg, image_feats=torch.from_numpy(feats), **kw)
    assert tuple(got["attribution"].shape) == (B, 8, 3) and tuple(got["text_feats"].shape) == (B, 8, jc.embed_dim)
    for k in ("logits", "attribution", "text_feats", "loss"):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), err_msg=k, **FWD_TOL)
    a = _np(got["attribution"])[:, : len(CLASSES)]
    if mode == "ref_compat":  # the rows differ per sample (idiomatic: exactly 1/P under the causal mask)
        assert np.abs(a - a.mean(axis=0, keepdims=True)).max() > 1e-4
    # FullModel slices the class axis of the 3-D attribution.
    x = _images(3)
    np.testing.assert_allclose(_np(tm(x)["attribution"]), _np(jm(jnp.asarray(x))["attribution"]), **FWD_TOL)


def test_meta_net_gradient_matches_jax(tiny):
    jc, jp, tc, tp = tiny
    jm, tm = _models(tiny, w2_scale=0.0)
    feats = np.random.default_rng(4).standard_normal((B, jc.embed_dim)).astype(np.float32)
    labels = np.array([0, 1, 2, 0])

    def jloss(tr):
        return jmw.full_model_forward(jp, tr, jm.prompt_learner.bank, None, jnp.asarray(labels), clip_cfg=jc,
                                      prompt_cfg=jm.prompt_cfg, with_loss=True, image_feats=jnp.asarray(feats))["loss"]

    want = jax.grad(jloss)(jm.trainable)
    state = tts.init_train_state(tm.trainable, tts.make_optimizer(tcfg.TrainConfig()), ("ctx", "meta_net"))
    loss = tmw.full_model_forward(tp, state.params, tm.prompt_learner.bank, None, torch.from_numpy(labels),
                                  clip_cfg=tc, prompt_cfg=tm.prompt_cfg, with_loss=True,
                                  image_feats=torch.from_numpy(feats))["loss"]
    grads = dict(zip(["ctx", "b1", "b2", "w1", "w2"], torch.autograd.grad(loss, state.diff_leaves())))
    assert float(grads["w2"].abs().max()) > 0.0 and float(grads["ctx"].abs().max()) > 0.0
    np.testing.assert_allclose(_np(grads["ctx"]), _np(want["ctx"]), **GRAD_TOL)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(_np(grads[k]), _np(want["meta_net"][k]), err_msg=k, **GRAD_TOL)


# --- the train step ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def anchor(tiny):
    a = np.random.default_rng(2).standard_normal((8, J_TINY.embed_dim)).astype(np.float32)
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


TERMS = {
    "ce": {},
    "kg": dict(kg_lambda=0.5),
    "scl": dict(scl_lambda=1.0),
    "prograd": dict(prograd_lambda=1.0),
}
KEYS = ("ctx", "meta_net")


@pytest.mark.parametrize("terms", list(TERMS))
@pytest.mark.parametrize("mode", MODES)
def test_train_step_trajectory_matches_jax(tiny, anchor, mode, terms):
    jc, jp, tc, tp = tiny
    jm, tm = _models(tiny, mode)
    kw = dict(TERMS[terms])
    if kw:
        kw.update(kg_feats=anchor, anchor_scale=float(np.log(1.0 / 0.07)))
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        labels = rng.integers(0, len(CLASSES), B).astype(np.int32)
        x = 3.0 * anchor[(labels + 1) % len(CLASSES)] + 0.5 * rng.standard_normal((B, jc.embed_dim))
        batches.append((x.astype(np.float32), labels))
    mask = np.array([True, True, True, False])
    jopt = jts.make_optimizer(JTrainConfig(lr=5e-2, weight_decay=0.01))
    jstate = jts.init_train_state(jm.trainable, jopt, KEYS)
    jstep = jts.make_train_step(jc, jm.prompt_cfg, jopt, trainable_keys=KEYS,
                                **{k: jnp.asarray(v) if k == "kg_feats" else v for k, v in kw.items()})
    tstate = tts.init_train_state(tm.trainable, tts.make_optimizer(tcfg.TrainConfig(lr=5e-2, weight_decay=0.01)),
                                  KEYS)
    tstep = tts.make_train_step(tc, tm.prompt_cfg, trainable_keys=KEYS, **kw)
    for x, labels in batches:
        jstate, jmet = jstep(jp, jstate, jm.prompt_learner.bank, jnp.asarray(x), jnp.asarray(labels),
                             jnp.asarray(mask))
        tstate, tmet = tstep(tp, tstate, tm.prompt_learner.bank, x, labels, mask)
        assert sorted(tmet) == sorted(jmet)
        for k in tmet:
            assert tmet[k].dim() == 0, k  # loss_kg included: a scalar, as JAX's
            np.testing.assert_allclose(_np(tmet[k]), _np(jmet[k]), err_msg=k, **TRAJ_TOL)
    pairs = [("ctx", tstate.params["ctx"], jstate.params["ctx"])] + [
        (k, tstate.params["meta_net"][k], jstate.params["meta_net"][k]) for k in ("w1", "b1", "w2", "b2")]
    for k, got, want in pairs:
        got, want = _np(got).astype(np.float64), _np(want)
        assert np.linalg.norm(got - want) <= TRAJ_NORM_TOL * np.linalg.norm(want), k


# --- fit, PromptSRC, add_class -----------------------------------------------------------


def _cached(seed, n, dim):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, dim)).astype(np.float32), rng.integers(0, len(CLASSES), n).astype(np.int32)


def test_fit_prompt_model_trains_ctx_and_meta_net_by_default(tiny):
    jc, jp, tc, tp = tiny
    jm, tm = _models(tiny, w2_scale=0.0)
    xtr, ytr = _cached(11, 8, jc.embed_dim)
    xva, yva = _cached(12, 8, jc.embed_dim)
    kw = dict(lr=5e-2, epochs=2, batch_size=4, patience=10)
    jres = jtrainer.fit_prompt_model(jm, jtrainer.CachedSet(xtr, ytr), jtrainer.CachedSet(xva, yva),
                                     JTrainConfig(**kw), verbose=False)
    tres = ttrainer.fit_prompt_model(tm, ttrainer.CachedSet(xtr, ytr), ttrainer.CachedSet(xva, yva),
                                     tcfg.TrainConfig(**kw), verbose=False)
    assert tres.final_state.trainable_keys == KEYS
    np.testing.assert_allclose(tres.loss_history, jres.loss_history, **TRAJ_TOL)
    assert tres.acc_history == jres.acc_history
    np.testing.assert_allclose(tres.attr_entropy, jres.attr_entropy, **TRAJ_TOL)  # class-level, on ctx
    w2 = _np(tres.final_state.params["meta_net"]["w2"])
    assert np.abs(w2).max() > 0.0  # moved off its zero init
    np.testing.assert_allclose(w2, _np(jres.final_state.params["meta_net"]["w2"]), **TRAJ_TOL)
    with pytest.raises(ValueError, match="not in model.trainable"):
        ttrainer.fit_prompt_model(tm, ttrainer.CachedSet(xtr, ytr), None, tcfg.TrainConfig(**kw),
                                  trainable_keys=("ctx", "maple"))


def test_fit_promptsrc_aggregates_the_meta_net(tiny):
    jc, jp, tc, tp = tiny
    jm, tm = _models(tiny, w2_scale=0.0)
    xtr, ytr = _cached(13, 8, jc.embed_dim)
    xva, yva = _cached(14, 8, jc.embed_dim)
    kw = dict(lr=5e-2, epochs=3, batch_size=4, patience=10, kg_lambda=1.0, scl_lambda=1.0)
    jres = jpsrc.fit_promptsrc(jm, jtrainer.CachedSet(xtr, ytr), jtrainer.CachedSet(xva, yva), JTrainConfig(**kw),
                               verbose=False)
    tres = tpsrc.fit_promptsrc(tm, ttrainer.CachedSet(xtr, ytr), ttrainer.CachedSet(xva, yva),
                               tcfg.TrainConfig(**kw), verbose=False)
    np.testing.assert_allclose(tres.fit.loss_history, jres.fit.loss_history, **TRAJ_TOL)
    np.testing.assert_allclose(_np(tres.gpa_trainable["ctx"]), _np(jres.gpa_trainable["ctx"]), **TRAJ_TOL)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(_np(tres.gpa_trainable["meta_net"][k]), _np(jres.gpa_trainable["meta_net"][k]),
                                   err_msg=k, **TRAJ_TOL)
    assert float(tres.gpa_trainable["meta_net"]["w2"].abs().max()) > 0.0
    assert (tres.gpa_acc, tres.best_is_gpa) == (jres.gpa_acc, jres.best_is_gpa)


def test_add_class_prompt_on_a_conditioned_model(tiny):
    jm, tm = _models(tiny)
    for m in (jm, tm):
        m.add_class_prompt("Clipboards")
    x = _images(5)
    want, got = jm(jnp.asarray(x)), tm(x)
    assert tuple(got["logits"].shape) == (B, 4) and tuple(got["attribution"].shape) == (B, 4, 3)
    np.testing.assert_allclose(_np(got["logits"]), _np(want["logits"]), **FWD_TOL)
    np.testing.assert_allclose(_np(got["attribution"]), _np(want["attribution"]), **FWD_TOL)
    preds, names = tm.predict(x)
    assert len(names) == B and set(names) <= set(CLASSES + ["Clipboards"])


# --- serving and predict ------------------------------------------------------------------


def test_predict_service_per_sample_batches_and_explain(tiny):
    """A batch of 4 per-sample answers, /embed in the same batch, and
    /explain's rows (the image's own) against the JAX service."""
    import threading

    jm, tm = _models(tiny)
    jsvc = JPredictService(jm, batch_size=B, max_latency_ms=50.0)
    tsvc = PredictService(tm, batch_size=B, max_latency_ms=50.0)
    try:
        imgs = [np.random.default_rng(20 + i).integers(0, 256, (32, 32, 3), dtype=np.uint8) for i in range(B)]
        for svc, key in ((jsvc, "jax"), (tsvc, "port")):
            out = [None] * B

            def ask(i, svc=svc, out=out):
                out[i] = (svc.embed if i == B - 1 else svc.predict)(imgs[i])

            threads = [threading.Thread(target=ask, args=(i,)) for i in range(B)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
            if key == "jax":
                want = out
            else:
                got = out
        for g, w in zip(got[:-1], want[:-1]):
            assert g["class"] == w["class"]
            np.testing.assert_allclose([g["probs"][n] for n in CLASSES], [w["probs"][n] for n in CLASSES],
                                       atol=1e-4)
        np.testing.assert_allclose(got[-1]["embedding"], want[-1]["embedding"], atol=1e-4)
        ex = [tsvc.explain(imgs[i]) for i in range(2)]
        jex = jsvc.explain(imgs[0])
        for n in CLASSES:
            np.testing.assert_allclose(ex[0]["attribution"][n], jex["attribution"][n], atol=1e-5)
        assert any(ex[0]["attribution"][n] != ex[1]["attribution"][n] for n in CLASSES)  # conditioned rows
        tsvc.add_class("Clipboards")
        assert len(tsvc.predict(imgs[0])["probs"]) == len(CLASSES) + 1
    finally:
        jsvc.close()
        tsvc.close()


def test_predict_corpus_runs_the_full_forward_with_no_attribution(tiny, tmp_path):
    jm, tm = _models(tiny)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        p = tmp_path / f"img{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    jrows, jattr = j_predict.predict_corpus(jm, paths, batch_size=B, top_k=2)
    trows, tattr = t_predict.predict_corpus(tm, paths, batch_size=B, top_k=2)
    assert jattr is None and tattr is None
    assert [r["path"] for r in trows] == [r["path"] for r in jrows] == paths
    for r, q in zip(trows, jrows):
        assert r["labels"] == q["labels"]
        np.testing.assert_allclose(r["scores"], q["scores"], atol=1e-5)


# --- checkpoints -------------------------------------------------------------------------------


def test_checkpoint_round_trip_and_resume_carry_the_meta_net(tiny, tmp_path):
    jc, jp, tc, tp = tiny
    _, tm = _models(tiny)
    xtr, ytr = _cached(15, 8, jc.embed_dim)
    cfg = tcfg.TrainConfig(lr=5e-2, epochs=2, batch_size=4, patience=10)
    full = ttrainer.fit_prompt_model(tm, ttrainer.CachedSet(xtr, ytr), None, cfg, epochs=4, verbose=False)

    _, tm = _models(tiny)
    half = ttrainer.fit_prompt_model(tm, ttrainer.CachedSet(xtr, ytr), None, cfg, verbose=False)
    st = half.final_state
    path = tckpt.save_prompt_checkpoint(str(tmp_path / "cocoop.pt"), trainable=st.params, bank=tm.prompt_learner.bank,
                                        class_names=CLASSES, opt_state=st.opt_state(), step=st.step,
                                        extra_meta={"epoch": 2})
    tree = tckpt.restore_prompt_checkpoint(path)
    assert sorted(tree["trainable"]["meta_net"]) == ["b1", "b2", "w1", "w2"]
    assert len(tree["opt_state"]) == 5  # ctx and the meta-net's four leaves

    _, fresh = _models(tiny, w2_scale=0.0)
    tckpt.apply_prompt_checkpoint(fresh, path)
    for k in ("w1", "b1", "w2", "b2"):
        torch.testing.assert_close(fresh.trainable["meta_net"][k], st.params["meta_net"][k].detach(), rtol=0, atol=0)
    _, other = _models(tiny, meta_hidden=16)
    with pytest.raises(ValueError, match="meta-net subtree"):
        tckpt.apply_prompt_checkpoint(other, path)

    _, tm = _models(tiny)
    resume = {"trainable": tree["trainable"], "opt_state": tree["opt_state"], "step": tree["meta"]["step"],
              "epoch": tree["meta"]["epoch"]}
    resumed = ttrainer.fit_prompt_model(tm, ttrainer.CachedSet(xtr, ytr), None, cfg, resume_state=resume,
                                        verbose=False)
    np.testing.assert_allclose(half.loss_history + resumed.loss_history, full.loss_history, rtol=1e-6, atol=1e-7)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(_np(resumed.final_state.params["meta_net"][k]),
                                   _np(full.final_state.params["meta_net"][k]), rtol=1e-6, atol=1e-7, err_msg=k)


def test_prompt_state_from_jax_carries_the_meta_net(tiny):
    jm, tm = _models(tiny)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_array_equal(_np(tm.trainable["meta_net"][k]), _np(jm.trainable["meta_net"][k]))


def test_serving_a_checkpoint_keeps_the_conditioning(tiny, tmp_path):
    """A CoCoOp checkpoint applied to a conditioned model serves with its
    trained meta-net (the JAX package's loader drops it)."""
    jm, tm = _models(tiny)
    path = tckpt.save_prompt_checkpoint(str(tmp_path / "c.pt"), trainable=tm.trainable, bank=tm.prompt_learner.bank,
                                        class_names=CLASSES)
    _, fresh = _models(tiny, w2_scale=0.0)
    tckpt.apply_prompt_checkpoint(fresh, path)
    x = _images(6)
    np.testing.assert_allclose(_np(fresh(x)["logits"]), _np(tm(x)["logits"]), rtol=0, atol=0)
    assert os.path.getsize(path) > 0
