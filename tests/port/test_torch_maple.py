"""MaPLe in the port against the JAX package, on the CPU.

* ``encode_image(maple_prompts=)``, ``text_forward_embeds(deep_prompts=)``
  (with the attribution aux) and ``full_model_forward`` (logits and
  attribution) in ``ref_compat`` and ``idiomatic`` mode at J = 1 and 2,
  from JAX's ``"maple"`` tree carried over by ``prompt_state_from_jax``:
  within 1e-5 (f32; the logits, 14.3 times a cosine, within 1e-4).
* ``make_maple_train_step``: a 3-step AdamW trajectory over ``("ctx",
  "maple")`` on raw images against JAX's at ``fit_maple``'s lr 2e-3, loss
  and every leaf at TRAJ_TOL (rtol 1e-4, atol 5e-6).  Adam moves a leaf
  whose gradient is near 0 by up to lr whatever the gradient's size, so a
  few of proj_w's 8,192 entries, whose gradients differ in sign between
  the two summation orders, part by a fraction of lr.
* The refusals: cached features, a depth past the towers, the ResNet tower,
  token pruning, ``fit_prompt_model``, ``fit_maple`` at depth 0, and
  CoCoOp (still not ported).
* ``maple.main --device cpu --save``: the ``.pt`` carries ``"maple"`` and its
  AdamW moments, and ``apply_prompt_checkpoint`` restores the subtree.

TINY_TEST (2 + 2 layers, width 64, 32 px images), batch 3.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from tapclip_tpu import maple as jmaple
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.config import PromptConfig as JPromptConfig
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models import model_wrapper as jmw
from tapclip_tpu.utils import torch_convert as jtc

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import maple as tmaple
from tapclip_tpu_torch import trainer as ttrainer
from tapclip_tpu_torch.models import clip as tclip
from tapclip_tpu_torch.models import model_wrapper as tmw
from tapclip_tpu_torch.parallel import train_step as tts
from tapclip_tpu_torch.utils import checkpoint as tck
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax, prompt_state_from_jax

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=5e-6)
CLASSES = ["Backpack", "Pen", "Mug"]


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


def _images(jc, n=3, seed=1):
    return np.random.default_rng(seed).standard_normal((n, jc.image_size, jc.image_size, 3)).astype(np.float32)


def _prompts(rng, *shape):
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("J", [1, 2])
def test_encode_image_with_maple_prompts_matches_jax(tiny, J):
    jc, jp, tc, tp = tiny
    rng = np.random.default_rng(J)
    x = _images(jc)
    first = _prompts(rng, 2, jc.vision_width)
    deep = mask = None
    if J > 1:  # one deep row (the tower has vision_layers - 1 = 1), active
        deep, mask = _prompts(rng, jc.vision_layers - 1, 2, jc.vision_width), np.ones(jc.vision_layers - 1, bool)
    encode = jax.jit(lambda p, x, prompts: jclip.encode_image(p, jc, x, maple_prompts=prompts))
    want = encode(jp, jnp.asarray(x), (jnp.asarray(first), None if deep is None else jnp.asarray(deep),
                                        None if mask is None else jnp.asarray(mask)))
    got = tclip.encode_image(tp, tc, torch.from_numpy(x), maple_prompts=(
        torch.from_numpy(first), None if deep is None else torch.from_numpy(deep),
        None if mask is None else torch.from_numpy(mask)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("mode", ["ref_compat", "idiomatic"])
@pytest.mark.parametrize("active", [False, True], ids=["J1-inert-row", "J2"])
def test_text_forward_embeds_with_deep_prompts_matches_jax(tiny, mode, active):
    jc, jp, tc, tp = tiny
    rng = np.random.default_rng(4)
    T = 82 if mode == "ref_compat" else jc.context_length
    x = (0.1 * rng.standard_normal((3, T, jc.text_width))).astype(np.float32)
    deep = _prompts(rng, jc.text_layers - 1, 5, jc.text_width)
    mask = np.full(jc.text_layers - 1, active)
    col = T - 1 if mode == "ref_compat" else np.array([5, 10, 15], np.int32)

    def jax_forward(p, x, deep, mask, c):
        idx = col if isinstance(col, int) else c
        return jclip.text_forward_embeds(p, jc, x, mode=mode, attn_to_idx=idx, pool_idx=idx, deep_prompts=deep,
                                         deep_prompt_mask=mask)

    jf, jaux = jax.jit(jax_forward)(jp, jnp.asarray(x), jnp.asarray(deep), jnp.asarray(mask), jnp.asarray(col))
    tcol = col if isinstance(col, int) else torch.from_numpy(col)
    tf, taux = tclip.text_forward_embeds(tp, tc, torch.from_numpy(x), mode=mode, attn_to_idx=tcol, pool_idx=tcol,
                                         deep_prompts=torch.from_numpy(deep), deep_prompt_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(_np(tf), _np(jf), **TOL)
    np.testing.assert_allclose(_np(taux), _np(jaux), **TOL)
    if not active:  # an inert row is the plain tower
        plain, _ = tclip.text_forward_embeds(tp, tc, torch.from_numpy(x), mode=mode, pool_idx=tcol)
        torch.testing.assert_close(tf, plain, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["ref_compat", "idiomatic"])
@pytest.mark.parametrize("J", [1, 2])
def test_full_model_forward_maple_matches_jax(tiny, mode, J):
    jc, jp, tc, tp = tiny
    kw = dict(maple_depth=J, prompt_len=2, text_mode=mode)
    jm, tm = _models(tiny, **kw)
    assert sorted(tm.trainable["maple"]) == ["proj_b", "proj_w", "txt"]
    assert tm.trainable["maple"]["txt"].shape == (J - 1, 2, jc.text_width)
    x = _images(jc)
    want = jmw.full_model_forward(jp, jm.trainable, jm.prompt_learner.bank, jnp.asarray(x), None, clip_cfg=jc,
                                  prompt_cfg=JPromptConfig(**kw))
    got = tmw.full_model_forward(tp, tm.trainable, tm.prompt_learner.bank, torch.from_numpy(x), None, clip_cfg=tc,
                                 prompt_cfg=tcfg.PromptConfig(**kw))
    live = np.asarray(jm.prompt_learner.bank.class_mask)
    np.testing.assert_allclose(_np(got["logits"])[:, live], _np(want["logits"])[:, live], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(got["attribution"]), _np(want["attribution"]), **TOL)


def test_maple_train_step_trajectory_matches_jax(tiny):
    jc, jp, tc, tp = tiny
    kw = dict(maple_depth=2, prompt_len=2)
    jm, tm = _models(tiny, **kw)
    rng = np.random.default_rng(6)
    batches = [(_images(jc, 3, seed=10 + i), rng.integers(0, 3, 3).astype(np.int32)) for i in range(3)]
    mask = np.array([True, True, False])
    jopt = optax.adamw(2e-3, weight_decay=1e-4)  # fit_maple's defaults
    jparams = dict(jm.trainable)
    jopt_state = jopt.init({k: jparams[k] for k in tmaple.MAPLE_KEYS})
    jstep = jmaple.make_maple_train_step(jc, JPromptConfig(**kw), jopt)
    tstate = tts.init_train_state(tm.trainable, lambda leaves: torch.optim.AdamW(
        leaves, lr=2e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4), tmaple.MAPLE_KEYS)
    tstep = tmaple.make_maple_train_step(tc, tcfg.PromptConfig(**kw))
    for x, labels in batches:
        jparams, jopt_state, jloss = jstep(jp, jparams, jopt_state, jm.prompt_learner.bank, jnp.asarray(x),
                                           jnp.asarray(labels), jnp.asarray(mask))
        tstate, m = tstep(tp, tstate, tm.prompt_learner.bank, x, labels, mask)
        np.testing.assert_allclose(_np(m["loss"]), _np(jloss), **TRAJ_TOL)
    np.testing.assert_allclose(_np(tstate.params["ctx"]), _np(jparams["ctx"]), **TRAJ_TOL)
    for k in ("txt", "proj_w", "proj_b"):
        np.testing.assert_allclose(_np(tstate.params["maple"][k]), _np(jparams["maple"][k]), err_msg=k, **TRAJ_TOL)
    # the CLIP weights were never differentiated
    assert all(p.grad is None and not p.requires_grad for p in tp["visual"]["blocks"][0]["attn"].values())


def test_maple_refusals(tiny):
    jc, jp, tc, tp = tiny
    jm, tm = _models(tiny, maple_depth=2, prompt_len=2)
    feats = torch.zeros(2, jc.embed_dim)
    with pytest.raises(ValueError, match="pass raw images"):
        tmw.full_model_forward(tp, tm.trainable, tm.prompt_learner.bank, None, None, clip_cfg=tc,
                               prompt_cfg=tm.prompt_cfg, image_feats=feats)
    with pytest.raises(ValueError, match="exceeds the tower depth"):
        tmw.FullModel(CLASSES, tp, tc, prompt_cfg=tcfg.PromptConfig(maple_depth=3))
    learner = SimpleNamespace(clip_cfg=tc.replace(vision_tower="resnet"), bank=tm.prompt_learner.bank)
    with pytest.raises(NotImplementedError, match="ViT vision tower"):
        tmw.init_trainable(torch.Generator(), learner, tcfg.PromptConfig(maple_depth=1))
    first = torch.zeros(2, jc.vision_width)
    with pytest.raises(NotImplementedError, match="token_keep_ratio"):
        tclip.encode_image(tp, tc.replace(token_keep_ratio=0.5), torch.zeros(1, 32, 32, 3),
                           maple_prompts=(first, None, None))
    with pytest.raises(NotImplementedError, match="fit_maple"):
        ttrainer.fit_prompt_model(tm, None, None, tcfg.TrainConfig())
    _, plain = _models(tiny)
    with pytest.raises(ValueError, match="maple_depth >= 1"):
        tmaple.fit_maple(plain, [])
    # CoCoOp is supported on its own; MaPLe with it is refused, with JAX's message.
    tmw.check_prompt_supported(tcfg.PromptConfig(image_conditioned=True))
    both = dict(maple_depth=1, image_conditioned=True)
    with pytest.raises(NotImplementedError, match="does not compose with image_conditioned"):
        tmw.init_trainable(torch.Generator(), tm.prompt_learner, tcfg.PromptConfig(**both))
    with pytest.raises(NotImplementedError, match="does not compose with image_conditioned"):
        jmw.init_trainable(jax.random.PRNGKey(0), jm.prompt_learner, JPromptConfig(**both))


def test_maple_main_saves_and_restores_the_subtree(tiny, tmp_path):
    jc, jp, tc, tp = tiny
    rng = np.random.default_rng(0)
    for ci, name in enumerate(CLASSES):
        d = tmp_path / "tree" / name
        d.mkdir(parents=True)
        base = np.zeros(3)
        base[ci] = 180
        for i in range(4):
            Image.fromarray(np.clip(base + rng.normal(0, 25, (32, 32, 3)), 0, 255).astype(np.uint8)).save(
                d / f"{i}.jpg")
    sd = jtc.save_openclip_checkpoint(jax.tree.map(np.asarray, jp), jc, str(tmp_path / "open_clip.bin"))
    save = str(tmp_path / "maple.pt")
    out = tmaple.main(["--train-root", str(tmp_path / "tree"), "--shots", "2", "--depth", "2", "--preset", "tiny",
                       "--pretrained", sd, "--epochs", "2", "--batch-size", "4", "--save", save, "--device", "cpu"])
    assert len(out["loss_history"]) == 2 and np.isfinite(out["loss_history"]).all()
    assert 0.0 <= out["best_acc"] <= 100.0 and out["checkpoint"] == save
    tree = tck.restore_prompt_checkpoint(save)
    assert sorted(tree["trainable"]["maple"]) == ["proj_b", "proj_w", "txt"]
    assert len(tree["opt_state"]) == 4 and all(float(st["step"]) == 4 for st in tree["opt_state"])  # 2 x 2 steps
    _, fresh = _models(tiny, maple_depth=2, prompt_len=2)
    tck.apply_prompt_checkpoint(fresh, save)
    for k, v in tree["trainable"]["maple"].items():
        torch.testing.assert_close(fresh.trainable["maple"][k], v, rtol=0, atol=0)
    _, other = _models(tiny, maple_depth=1, prompt_len=2)
    with pytest.raises(ValueError, match="MaPLe subtree"):
        tck.apply_prompt_checkpoint(other, save)
    with pytest.raises(ValueError, match="Orbax"):
        tmaple.main(["--train-root", str(tmp_path / "tree"), "--preset", "tiny", "--save", str(tmp_path),
                     "--device", "cpu"])
