"""The port's model modules against the JAX package, end to end on the CPU.

The same parameters (a JAX init, bridged with ``params_from_jax``) and the
same numpy inputs go through both packages.  JAX routes to XLA on the CPU;
the port's kernel wrappers run their plain versions.  Two geometries:
``TINY_TEST``, and one layer per tower at real widths (vision 768 / 12
heads, text 512 / 8 heads, 32 px images), so that the head split at ViT-B
widths is checked.  f32 tolerance rtol = atol = 1e-4, as in
``tests/test_clip_model.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.config import CLIPConfig as JCLIPConfig
from tapclip_tpu.config import PromptConfig as JPromptConfig
from tapclip_tpu.data.tokenizer import get_tokenizer as j_get_tokenizer
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models import model_wrapper as jmw
from tapclip_tpu.models.attribution_monitor import attribution_scores as j_attribution_scores
from tapclip_tpu.models.prompt_adjustor import adjust_prompt as j_adjust_prompt
from tapclip_tpu.models.prompt_adjustor import init_adjustor_params as j_init_adjustor
from tapclip_tpu.models.prompt_learner import PromptLearner as JPromptLearner

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch.data.tokenizer import get_tokenizer as t_get_tokenizer
from tapclip_tpu_torch.models import clip as tclip
from tapclip_tpu_torch.models import model_wrapper as tmw
from tapclip_tpu_torch.models.attribution_monitor import attribution_scores
from tapclip_tpu_torch.models.prompt_adjustor import adjust_prompt, init_adjustor_params
from tapclip_tpu_torch.models.prompt_learner import PromptLearner
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax, prompt_state_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
CLASSES = ["Backpack", "Pen", "Mug"]

WIDE = dict(
    name="one-layer-b16-widths", image_size=32, patch_size=16,
    vision_width=768, vision_layers=1, vision_heads=12,
    vocab_size=520, context_length=16,
    text_width=512, text_layers=1, text_heads=8, embed_dim=512,
)
GEOMETRIES = {"tiny": J_TINY, "wide": JCLIPConfig(**WIDE)}


def _port_cfg(jcfg):
    return tcfg.CLIPConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def geo(request):
    jc = GEOMETRIES[request.param]
    jp = jclip.init_clip_params(jax.random.PRNGKey(0), jc)
    tc = _port_cfg(jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return jc, jp, tc, tp


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.detach().float().numpy()


def _images(cfg, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


def test_params_bridge_layout(geo):
    jc, jp, tc, tp = geo
    assert len(tp["visual"]["blocks"]) == jc.vision_layers
    np.testing.assert_array_equal(
        tp["visual"]["blocks"][-1]["mlp"]["w_fc"].numpy(),
        np.asarray(jp["visual"]["blocks"]["mlp"]["w_fc"][-1]),
    )
    assert tp["text"]["token_embedding"].shape == (jc.vocab_size, jc.text_width)


def test_encode_image_matches_jax(geo):
    jc, jp, tc, tp = geo
    x = _images(jc)
    want = jclip.encode_image(jp, jc, jnp.asarray(x))
    got = tclip.encode_image(tp, tc, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_encode_image_uint8_matches_jax(geo):
    jc, jp, tc, tp = geo
    px = np.random.default_rng(3).integers(0, 256, (2, jc.image_size, jc.image_size, 3), dtype=np.uint8)
    want = jclip.encode_image(jp, jc, jnp.asarray(px))
    got = tclip.encode_image(tp, tc, torch.from_numpy(px))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_text_forward_embeds_features_and_aux(geo):
    jc, jp, tc, tp = geo
    T = 5 + jc.context_length  # [ctx || tokens], padded to a multiple of 8 inside
    emb = np.random.default_rng(1).standard_normal((3, T, jc.text_width)).astype(np.float32) * 0.1
    want_f, want_aux = jclip.text_forward_embeds(jp, jc, jnp.asarray(emb), mode="ref_compat",
                                                 attn_to_idx=T - 1)
    got_f, got_aux = tclip.text_forward_embeds(tp, tc, torch.from_numpy(emb), mode="ref_compat",
                                               attn_to_idx=T - 1)
    assert got_aux.shape == (3, T)
    np.testing.assert_allclose(_np(got_f), _np(want_f), **TOL)
    np.testing.assert_allclose(_np(got_aux), _np(want_aux), **TOL)
    want_f2, _ = jclip.text_forward_embeds(jp, jc, jnp.asarray(emb), pool_idx=4)
    got_f2, aux2 = tclip.text_forward_embeds(tp, tc, torch.from_numpy(emb), pool_idx=4)
    assert aux2 is None
    np.testing.assert_allclose(_np(got_f2), _np(want_f2), **TOL)


def test_plain_impl_equals_kernel_routing_on_cpu(geo):
    """``attn_impl="xla"`` (plain composition) and ``"auto"`` (kernel
    wrappers, plain on the CPU) give the same features."""
    jc, jp, tc, tp = geo
    x = torch.from_numpy(_images(jc, n=2))
    a = tclip.encode_image(tp, tc, x)
    b = tclip.encode_image(tp, tc.replace(attn_impl="xla"), x)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_l2_normalize_and_patchify():
    x = np.random.default_rng(2).standard_normal((4, 7)).astype(np.float32)
    x[0] = 0.0
    np.testing.assert_allclose(_np(tclip.l2_normalize(torch.from_numpy(x))),
                               _np(jclip.l2_normalize(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    im = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(_np(tclip.patchify(torch.from_numpy(im), 16)),
                                  _np(jclip.patchify(jnp.asarray(im), 16)))


def test_unported_configs_raise(geo):
    jc, jp, tc, tp = geo
    x = torch.from_numpy(_images(jc, n=1))
    for kw in (dict(token_keep_ratio=0.5), dict(quantize_tower=True), dict(vpt_tokens=2),
               dict(moe_experts=2)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            tclip.encode_image(tp, tc.replace(**kw), x)
    with pytest.raises(NotImplementedError, match="visual prompt tokens"):
        tclip.text_forward_embeds(tp, tc.replace(vpt_tokens=2), torch.zeros(1, 8, jc.text_width))
    with pytest.raises(NotImplementedError, match="int8 tower"):
        tclip.encode_text(tp, tc.replace(quantize_tower=True), np.zeros((1, jc.context_length), np.int32))


# --- prompt layer ------------------------------------------------------------


def _learners(jc, jp, tc, tp, classes, pcfg_kw=None):
    pcfg_kw = pcfg_kw or {}
    jl = JPromptLearner(classes, jp, jc, JPromptConfig(**pcfg_kw), j_get_tokenizer(), banner=False)
    tl = PromptLearner(classes, tp, tc, tcfg.PromptConfig(**pcfg_kw), t_get_tokenizer(), banner=False)
    return jl, tl


def _assert_bank_equal(jbank, tbank):
    np.testing.assert_array_equal(_np(tbank.ctx), _np(jbank.ctx))
    np.testing.assert_array_equal(_np(tbank.token_embs), _np(jbank.token_embs))
    np.testing.assert_array_equal(tbank.class_mask.numpy(), np.asarray(jbank.class_mask))
    np.testing.assert_array_equal(tbank.eot_pos.numpy(), np.asarray(jbank.eot_pos))


def test_prompt_bank_contents_match(geo):
    jc, jp, tc, tp = geo
    jl, tl = _learners(jc, jp, tc, tp, CLASSES)
    assert tl.bank.capacity == jl.bank.capacity == 8
    _assert_bank_equal(jl.bank, tl.bank)
    np.testing.assert_array_equal(_np(tl()), _np(jl()))


def test_prompt_bank_grows_in_chunks_of_8(geo):
    jc, jp, tc, tp = geo
    names = [f"class_{i}" for i in range(9)]
    jl, tl = _learners(jc, jp, tc, tp, names, dict(max_classes=4))
    assert tl.bank.capacity == jl.bank.capacity == 16
    _assert_bank_equal(jl.bank, tl.bank)
    tl.add_class_prompt("class_3")  # present: no-op
    assert tl.n_cls == 9


@pytest.mark.parametrize("normalize", [True, False])
def test_attribution_scores_match(normalize):
    col = np.random.default_rng(4).random((5, 21)).astype(np.float32)
    want = j_attribution_scores(jnp.asarray(col), 5, normalize)
    got = attribution_scores(torch.from_numpy(col), 5, normalize)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("method", ["scale", "gate", "residual"])
def test_adjustors_match(method):
    D = 16
    jparams = j_init_adjustor(jax.random.PRNGKey(1), method, D, 64)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    rng = np.random.default_rng(5)
    ctx = rng.standard_normal((3, 5, D)).astype(np.float32)
    attr = rng.random((3, 5)).astype(np.float32)
    want = j_adjust_prompt(jparams, method, jnp.asarray(ctx), jnp.asarray(attr))
    got = adjust_prompt(tparams, method, torch.from_numpy(ctx), torch.from_numpy(attr))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    port_init = init_adjustor_params(torch.Generator().manual_seed(0), method, D, 64)
    assert {k: tuple(v.shape) for k, v in port_init.items()} == {
        k: tuple(v.shape) for k, v in jparams.items()
    }


# --- the fused forward -------------------------------------------------------


def _jax_model_and_port_state(jc, jp, tc, tp, pcfg_kw, classes=CLASSES):
    jpc = JPromptConfig(**pcfg_kw)
    jm = jmw.FullModel(classes, jp, jc, prompt_cfg=jpc, rng=jax.random.PRNGKey(3))
    trainable, bank = prompt_state_from_jax(
        jax.tree.map(np.asarray, jm.trainable), jax.tree.map(np.asarray, jm.prompt_learner.bank)
    )
    return jm, jpc, trainable, bank


@pytest.mark.parametrize("method", ["scale", "residual"])
def test_text_features_with_attribution_matches(geo, method):
    jc, jp, tc, tp = geo
    jm, jpc, trainable, bank = _jax_model_and_port_state(jc, jp, tc, tp, dict(adjustor_method=method))
    want_f, want_a = jmw.text_features_with_attribution(
        jp, jm.trainable["ctx"], jm.prompt_learner.bank, jc, jpc, jm.trainable["adjustor"]
    )
    got_f, got_a = tmw.text_features_with_attribution(
        tp, trainable["ctx"], bank, tc, tcfg.PromptConfig(adjustor_method=method), trainable["adjustor"]
    )
    np.testing.assert_allclose(_np(got_f), _np(want_f), **TOL)
    np.testing.assert_allclose(_np(got_a), _np(want_a), **TOL)


def test_full_model_forward_matches(geo):
    jc, jp, tc, tp = geo
    jm, jpc, trainable, bank = _jax_model_and_port_state(jc, jp, tc, tp, {})
    x = _images(jc, n=4, seed=7)
    labels = np.array([0, 2, 1, 2])
    want = jmw.full_model_forward(
        jp, jm.trainable, jm.prompt_learner.bank, jnp.asarray(x), jnp.asarray(labels),
        clip_cfg=jc, prompt_cfg=jpc, with_loss=True,
    )
    got = tmw.full_model_forward(
        tp, trainable, bank, torch.from_numpy(x), torch.from_numpy(labels),
        clip_cfg=tc, prompt_cfg=tcfg.PromptConfig(), with_loss=True,
    )
    logits_w, logits_g = _np(want["logits"]), _np(got["logits"])
    assert logits_g.shape == (4, 8)
    live = np.asarray(jm.prompt_learner.bank.class_mask)
    np.testing.assert_allclose(logits_g[:, live], logits_w[:, live], **TOL)
    np.testing.assert_array_equal(logits_g[:, ~live], np.full_like(logits_g[:, ~live], tmw.NEG_INF))
    np.testing.assert_allclose(_np(got["attribution"]), _np(want["attribution"]), **TOL)
    np.testing.assert_allclose(_np(got["loss"]), _np(want["loss"]), **TOL)


def test_full_model_add_class_beyond_capacity_matches(geo):
    """8 classes fill the bank; a 9th grows it to 16 in both packages, and
    the logits over all nine classes still agree."""
    jc, jp, tc, tp = geo
    names = [f"class_{i}" for i in range(8)]
    jm = jmw.FullModel(names, jp, jc, rng=jax.random.PRNGKey(3))
    tm = tmw.FullModel(names, tp, tc)
    for m in (jm, tm):
        m.add_class_prompt("Clipboards")
        m.add_class_prompt("Clipboards")  # present: no-op
    assert tm.class_names == jm.class_names and tm.n_cls == 9
    assert tm.trainable["ctx"].shape[0] == jm.trainable["ctx"].shape[0] == 16
    _assert_bank_equal(jm.prompt_learner.bank, tm.prompt_learner.bank)
    np.testing.assert_array_equal(_np(tm.trainable["ctx"]), _np(jm.trainable["ctx"]))
    # Batch 3: JAX's jit cache is process-wide, and tests/test_scale.py counts
    # the compiles of a batch-2 forward at capacity 16 in the same worker.
    x = _images(jc, n=3, seed=8)
    want = jm(x)
    with torch.inference_mode():
        got = tm(x)
        preds, names_out = tm.predict(x)
    assert got["logits"].shape == (3, 9) and got["attribution"].shape == (9, 5)
    np.testing.assert_allclose(_np(got["logits"]), _np(want["logits"]), **TOL)
    np.testing.assert_allclose(_np(got["attribution"]), _np(want["attribution"]), **TOL)
    assert list(preds) == list(np.asarray(want["logits"]).argmax(-1))
    assert names_out == [tm.class_names[i] for i in preds]
