"""The anchored train step (KgCoOp, PromptSRC's logit term, ProGrad) and
PromptSRC against the JAX package, on the CPU.

* ``_prograd_project`` on hand-made gradients (a conflict, no conflict, a
  general-knowledge gradient at float noise): the projection and the 0/1
  conflict exactly as JAX's up to f32 summation order (1e-6).
* ``make_train_step``: 5-step trajectories on cached features with the kg
  term, the logit term, ProGrad and all three together, against JAX's step
  on the same bridged weights, anchor and batches: every metric and ``ctx``
  at TRAJ_TOL (rtol 1e-4, atol 5e-6, as ``test_torch_drivers.py``), and
  ``prograd_conflict`` equal at every step.
* The same-pipeline anchor: ``loss_kg`` is 0 within 1e-6 at template init;
  ``_multi_template_anchor`` against JAX's within 1e-5, and its refusal
  without template init; the step's refusals are JAX's.
* ``train --kg-lambda --prograd-lambda --scl-lambda --anchor-templates
  --device cpu``: the history equals JAX's ``train`` at TRAJ_TOL.
* PromptSRC: ``gaussian_weights`` equal; ``fit_promptsrc``'s aggregated
  ``ctx`` (TRAJ_TOL) and both accuracies (equal) against JAX's.

Batch 4, capacity 8 (``tests/test_scale.py`` counts JAX compiles of a
batch-2 forward at capacity 16 in the same worker).  Each JAX step is
compiled once per module: the trajectories share one anchor.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tapclip_tpu import promptsrc as jpsrc
from tapclip_tpu import train as j_train
from tapclip_tpu import trainer as jtrainer
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.config import PromptConfig as JPromptConfig
from tapclip_tpu.config import TrainConfig as JTrainConfig
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models import model_wrapper as jmw
from tapclip_tpu.parallel import train_step as jts
from tapclip_tpu.utils import torch_convert as jtc

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import promptsrc as tpsrc
from tapclip_tpu_torch import train as t_train
from tapclip_tpu_torch import trainer as ttrainer
from tapclip_tpu_torch.models import model_wrapper as tmw
from tapclip_tpu_torch.parallel import train_step as tts
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax, prompt_state_from_jax

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

TRAJ_TOL = dict(rtol=1e-4, atol=5e-6)
CLASSES = ["Backpack", "Pen", "Mug"]
TEMPLATES = ("a photo of a {}", "a drawing of a {}")
ANCHOR_SCALE = float(np.log(1.0 / 0.07))


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


def _models(tiny, **prompt_kw):
    jc, jp, tc, tp = tiny
    jm = jmw.FullModel(CLASSES, jp, jc, prompt_cfg=JPromptConfig(**prompt_kw), rng=jax.random.PRNGKey(3))
    tm = tmw.FullModel(CLASSES, tp, tc, prompt_cfg=tcfg.PromptConfig(**prompt_kw))
    tm.trainable, tm.prompt_learner.bank = prompt_state_from_jax(
        jax.tree.map(np.asarray, jm.trainable), jax.tree.map(np.asarray, jm.prompt_learner.bank))
    return jm, tm


# --- _prograd_project -----------------------------------------------------------------


def _grads(rng, case):
    g_d = {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    if case == "noise":
        g_g = {k: (1e-9 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in g_d.items()}
    else:
        sign = -1.0 if case == "conflict" else 1.0
        g_g = {k: (sign * v + 0.3 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in g_d.items()}
    return g_d, g_g


@pytest.mark.parametrize("case,conflict", [("conflict", 1.0), ("agree", 0.0), ("noise", 0.0)])
def test_prograd_project_matches_jax(case, conflict):
    g_d, g_g = _grads(np.random.default_rng(5), case)
    want, jc = jts._prograd_project(jax.tree.map(jnp.asarray, g_d), jax.tree.map(jnp.asarray, g_g), 0.8)
    got, tc = tts._prograd_project([torch.from_numpy(g_d[k]) for k in "ab"],
                                   [torch.from_numpy(g_g[k]) for k in "ab"], 0.8)
    assert float(tc) == float(jc) == conflict
    for k, g in zip("ab", got):
        np.testing.assert_allclose(_np(g), _np(want[k]), rtol=1e-6, atol=1e-6)
    if not conflict:
        for k, g in zip("ab", got):
            np.testing.assert_array_equal(_np(g), g_d[k])


# --- make_train_step trajectories -------------------------------------------------------


@pytest.fixture(scope="module")
def anchor(tiny):
    """A unit-row anchor away from the model's own features, so the KL has
    a gradient from step 1."""
    a = np.random.default_rng(2).standard_normal((8, J_TINY.embed_dim)).astype(np.float32)
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


TERMS = {
    "kg": dict(kg_lambda=0.5),
    "scl": dict(scl_lambda=1.0),
    "prograd": dict(prograd_lambda=1.0),
    "all": dict(kg_lambda=0.5, scl_lambda=1.0, prograd_lambda=1.0),
}


@pytest.mark.parametrize("terms", list(TERMS))
def test_anchored_step_trajectory_matches_jax(tiny, anchor, terms):
    jc, jp, tc, tp = tiny
    jm, tm = _models(tiny)
    kw = dict(TERMS[terms], anchor_scale=ANCHOR_SCALE)
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(5):
        # Each image near the anchor row of the class after its label: the
        # zero-shot side disagrees with the label, so ProGrad's projection
        # engages on some steps.
        labels = rng.integers(0, len(CLASSES), 4).astype(np.int32)
        x = 3.0 * anchor[(labels + 1) % len(CLASSES)] + 0.5 * rng.standard_normal((4, jc.embed_dim))
        batches.append((x.astype(np.float32), labels))
    mask = np.array([True, True, True, False])
    jopt = jts.make_optimizer(JTrainConfig(lr=5e-2, weight_decay=0.01))
    jstate = jts.init_train_state(jm.trainable, jopt)
    jstep = jts.make_train_step(jc, JPromptConfig(), jopt, kg_feats=jnp.asarray(anchor), **kw)
    tstate = tts.init_train_state(tm.trainable, tts.make_optimizer(tcfg.TrainConfig(lr=5e-2, weight_decay=0.01)))
    tstep = tts.make_train_step(tc, tcfg.PromptConfig(), kg_feats=anchor, **kw)
    conflicts = []
    for x, labels in batches:
        jstate, jm_ = jstep(jp, jstate, jm.prompt_learner.bank, jnp.asarray(x), jnp.asarray(labels),
                            jnp.asarray(mask))
        tstate, tm_ = tstep(tp, tstate, tm.prompt_learner.bank, x, labels, mask)
        assert sorted(tm_) == sorted(jm_)
        for k in tm_:
            if k == "prograd_conflict":
                assert float(tm_[k]) == float(jm_[k])
                conflicts.append(float(tm_[k]))
            else:
                np.testing.assert_allclose(_np(tm_[k]), _np(jm_[k]), err_msg=k, **TRAJ_TOL)
    np.testing.assert_allclose(_np(tstate.params["ctx"]), _np(jstate.params["ctx"]), **TRAJ_TOL)
    if "prograd_lambda" in kw:
        assert 1.0 in conflicts  # the projection engaged


def test_anchored_step_refusals_match_jax(tiny, anchor):
    jc, jp, tc, tp = tiny
    cases = [
        (dict(kg_lambda=0.1), "requires kg_feats"),
        (dict(scl_lambda=0.1, kg_feats=anchor, anchor_scale=1.0, use_image_feats=False), "cached-feature step"),
        (dict(prograd_lambda=0.1, kg_feats=anchor), "requires anchor_scale"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            jts.make_train_step(jc, JPromptConfig(), None, **kw)
        with pytest.raises(ValueError, match=match):
            tts.make_train_step(tc, tcfg.PromptConfig(), **kw)


# --- the same-pipeline anchor -------------------------------------------------------------


def test_kg_loss_is_zero_at_template_init(tiny):
    """fit_prompt_model's anchor is the model's own init features: the first
    step's loss_kg is 0 and its KL is 0, so ProGrad's guard holds."""
    jc, jp, tc, tp = tiny
    _, tm = _models(tiny)
    kg_feats = ttrainer._anchor_features(tm, tm.prompt_learner.bank, tm.trainable["adjustor"])
    assert not kg_feats.is_inference() and kg_feats.shape == (8, jc.embed_dim)
    step = tts.make_train_step(tc, tcfg.PromptConfig(), kg_lambda=1.0, kg_feats=kg_feats, prograd_lambda=1.0,
                               anchor_scale=float(tm.trainable["logit_scale"]), scl_lambda=1.0)
    state = tts.init_train_state(tm.trainable, tts.make_optimizer(tcfg.TrainConfig()))
    x = np.random.default_rng(1).standard_normal((4, jc.embed_dim)).astype(np.float32)
    _, m = step(tp, state, tm.prompt_learner.bank, x, np.array([0, 1, 2, 0]), np.ones(4, bool))
    assert abs(float(m["loss_kg"])) <= 1e-6
    assert abs(float(m["loss_scl"])) <= 1e-6 and abs(float(m["loss_prograd_kl"])) <= 1e-6
    assert float(m["prograd_conflict"]) == 0.0


def test_multi_template_anchor_matches_jax_and_refuses_random_init(tiny):
    jc, jp, tc, tp = tiny
    jm, tm = _models(tiny)
    anchor_fn = jax.jit(lambda cp, ctx, bank, adj: jmw.text_features_with_attribution(
        cp, ctx, bank, jc, jm.prompt_cfg, adj)[0])
    want = jtrainer._multi_template_anchor(jm, TEMPLATES, jm.trainable["adjustor"], anchor_fn)
    got = ttrainer._multi_template_anchor(tm, TEMPLATES, tm.trainable["adjustor"])
    assert got.shape == want.shape == (8, jc.embed_dim)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    _, rand = _models(tiny, use_init_prompt=False)
    with pytest.raises(ValueError, match="use_init_prompt=True"):
        ttrainer._multi_template_anchor(rand, TEMPLATES, rand.trainable["adjustor"])


# --- train with the anchors ----------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A class-colored JPEG tree of the three classes and a JAX-exported
    open_clip state dict."""
    root = tmp_path_factory.mktemp("anchored")
    rng = np.random.default_rng(0)
    for ci, name in enumerate(CLASSES):
        d = root / "tree" / name
        d.mkdir(parents=True)
        base = np.zeros(3)
        base[ci % 3] = 180
        for i in range(6):
            Image.fromarray(np.clip(base + rng.normal(0, 25, (32, 32, 3)), 0, 255).astype(np.uint8)).save(
                d / f"{i}.jpg")
    params = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY))
    sd = jtc.save_openclip_checkpoint(params, J_TINY, str(root / "open_clip.bin"))
    return {"tree": str(root / "tree"), "sd": sd, "out": root}


def test_train_with_every_anchor_matches_jax(files):
    args = ["--preset", "tiny", "--data-root", files["tree"], "--classes", *CLASSES, "--epochs", "2",
            "--num-shots", "3", "--batch-size", "4", "--pretrained", files["sd"], "--lr", "5e-2",
            "--kg-lambda", "0.1", "--prograd-lambda", "1", "--scl-lambda", "1", "--anchor-templates", *TEMPLATES]
    jres = j_train.main(args + ["--output-root", str(files["out"] / "jax")])
    tres = t_train.main(args + ["--output-root", str(files["out"] / "port"), "--device", "cpu"])
    jh = json.load(open(os.path.join(jres["paths"]["csv_dir"], "history.json")))
    th = json.load(open(os.path.join(tres["paths"]["csv_dir"], "history.json")))
    assert th["acc"] == jh["acc"] and len(th["loss"]) == 2
    np.testing.assert_allclose(th["loss"], jh["loss"], **TRAJ_TOL)
    assert tres["result"].final_state.step == 6


# --- PromptSRC --------------------------------------------------------------------------------


@pytest.mark.parametrize("n,mu,sigma", [(1, None, None), (7, None, None), (10, 3.0, 0.5)])
def test_gaussian_weights_equal(n, mu, sigma):
    np.testing.assert_array_equal(tpsrc.gaussian_weights(n, mu=mu, sigma=sigma),
                                  jpsrc.gaussian_weights(n, mu=mu, sigma=sigma))


def test_fit_promptsrc_matches_jax(tiny):
    jc, jp, tc, tp = tiny
    jm, tm = _models(tiny)
    rng = np.random.default_rng(11)
    xtr, ytr = rng.standard_normal((12, jc.embed_dim)).astype(np.float32), rng.integers(0, 3, 12).astype(np.int32)
    xva, yva = rng.standard_normal((8, jc.embed_dim)).astype(np.float32), rng.integers(0, 3, 8).astype(np.int32)
    kw = dict(lr=5e-2, epochs=3, batch_size=4, patience=10, kg_lambda=1.0, scl_lambda=1.0,
              anchor_templates=TEMPLATES)
    jres = jpsrc.fit_promptsrc(jm, jtrainer.CachedSet(xtr, ytr), jtrainer.CachedSet(xva, yva), JTrainConfig(**kw),
                               verbose=False)
    tres = tpsrc.fit_promptsrc(tm, ttrainer.CachedSet(xtr, ytr), ttrainer.CachedSet(xva, yva),
                               tcfg.TrainConfig(**kw), verbose=False)
    np.testing.assert_allclose(tres.fit.loss_history, jres.fit.loss_history, **TRAJ_TOL)
    np.testing.assert_allclose(_np(tres.gpa_trainable["ctx"]), _np(jres.gpa_trainable["ctx"]), **TRAJ_TOL)
    assert (tres.gpa_acc, tres.fit.best_acc, tres.best_is_gpa) == (jres.gpa_acc, jres.fit.best_acc, jres.best_is_gpa)
    np.testing.assert_allclose(_np(tm.trainable["ctx"]), _np(jm.trainable["ctx"]), **TRAJ_TOL)


def test_fit_promptsrc_refuses_cocoop(tiny):
    """PromptSRC with CoCoOp prompts no longer refuses: its GPA averages
    the meta-net beside ctx, and the early-stopped best keeps both (the
    values against JAX's are in ``tests/port/test_torch_cocoop.py``)."""
    jc, jp, tc, tp = tiny
    tm = tmw.FullModel(CLASSES, tp, tc, prompt_cfg=tcfg.PromptConfig(image_conditioned=True))
    rng = np.random.default_rng(12)
    x, y = rng.standard_normal((8, jc.embed_dim)).astype(np.float32), rng.integers(0, 3, 8).astype(np.int32)
    res = tpsrc.fit_promptsrc(tm, ttrainer.CachedSet(x, y), ttrainer.CachedSet(x, y),
                              tcfg.TrainConfig(lr=5e-2, epochs=2, batch_size=4), verbose=False)
    assert sorted(res.gpa_trainable["meta_net"]) == ["b1", "b2", "w1", "w2"]
    assert float(res.gpa_trainable["meta_net"]["w2"].abs().max()) > 0.0
