"""The port's causal text tower against the JAX package, on the CPU.

* B6 / B7: the plain packed-QKV attention core and its plain backward
  against the JAX package's ``fused_mha`` / ``_fused_mha_bwd_impl`` run in
  interpret mode (2 heads of 64, W = 128: the head layout on which JAX takes
  its Pallas path rather than ``_xla_reference``), causal and not, T 48, 77
  and 80, all keys valid or 77.  f32 at rtol = atol = 2e-5: the same math,
  but the JAX kernel's online exp2 softmax with deferred normalisation sums
  in another order than the plain ``torch.softmax``.  B6's split products
  on the card's tensor cores, emulated (``split_error.emulate_mha``),
  against JAX's ``_fused_mha_fwd_impl`` in interpret mode at the card's
  tolerances (1e-4 f32, 2e-2 bf16), causal and not.  B7's split products
  on the card's tensor cores, emulated (``split_error.emulate_mha_bwd``),
  against the same Pallas backward at the same tolerances, f32 and bf16,
  causal and not, also at T 97.
* K3 causal: the plain attention with the aux column against JAX's
  ``fused_attention(causal=True)`` in interpret mode, and the idiomatic case
  where every context query's aux is exactly 0.
* The model: ``encode_text`` and ``text_forward_embeds(mode="idiomatic")``
  against JAX (XLA on the CPU) on a two-layer tower at W = 128 with
  ``context_length`` 77; ``attn_impl`` ``"fused"`` / ``"fused_split"`` on the
  vision tower; JAX's ``fused`` with an aux request returns no aux, and so
  does the port.  rtol = atol = 1e-4, as ``tests/test_clip_model.py``.
* Idiomatic prompt tuning: features and the uniform 1/P attribution, and a
  5-step ``make_train_step`` trajectory (cached features) at rtol 1e-4,
  atol 5e-6 (as ``tests/test_grad_oracle.py``).
* Zero-shot: the classifier, its logits and its accuracy against JAX's.

Batch 3 or 4 and capacity 8 throughout: ``tests/test_scale.py`` counts JAX
compiles of a batch-2 forward at capacity 16 in the same worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapclip_tpu import zero_shot as jzs
from tapclip_tpu.config import CLIPConfig as JCLIPConfig
from tapclip_tpu.config import PromptConfig as JPromptConfig
from tapclip_tpu.config import TrainConfig as JTrainConfig
from tapclip_tpu.data.tokenizer import get_tokenizer as j_get_tokenizer
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models import layers as jlayers
from tapclip_tpu.models import model_wrapper as jmw
from tapclip_tpu.ops.flash_attention import fused_attention as jax_fused_attention
from tapclip_tpu.ops.fused_mha import _fused_mha_bwd_impl, _fused_mha_fwd_impl
from tapclip_tpu.ops.fused_mha import fused_mha as jax_fused_mha
from tapclip_tpu.parallel import train_step as jts

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import zero_shot as tzs
from tapclip_tpu_torch.data.tokenizer import get_tokenizer as t_get_tokenizer
from tapclip_tpu_torch.models import clip as tclip
from tapclip_tpu_torch.models import layers as tlayers
from tapclip_tpu_torch.models import model_wrapper as tmw
from tapclip_tpu_torch.ops.attention import attention_reference
from tapclip_tpu_torch.ops.flash_attention import fused_attention
from tapclip_tpu_torch.ops.fused_mha import fused_mha, fused_mha_bwd_reference, fused_mha_reference
from tapclip_tpu_torch.parallel import train_step as tts
from tapclip_tpu_torch.scripts.split_error import emulate_mha, emulate_mha_bwd
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax, prompt_state_from_jax

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 against the f32 answer: q.k and p.v see bf16 inputs (8 bits of
# mantissa, 2^-8 relative each), and the two packages round p at different
# places (the JAX kernel before the deferred 1/l, the plain version after).
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
TRAJ_TOL = dict(rtol=1e-4, atol=5e-6)
B, W, HEADS = 2, 128, 2
CLASSES = ["Backpack", "Alarm_Clock", "Mug"]

TEXT77 = dict(
    name="two-layer-text-77", image_size=32, patch_size=16,
    vision_width=128, vision_layers=2, vision_heads=2,
    vocab_size=520, context_length=77,
    text_width=128, text_layers=2, text_heads=2, embed_dim=64,
)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _qkv(T, seed=0):
    return (np.random.default_rng(seed).standard_normal((B, T, 3 * W)) * 0.5).astype(np.float32)


# --- B6: the packed-QKV attention core -----------------------------------------

SHAPES = [(48, None), (77, None), (80, None), (80, 77)]
SHAPE_IDS = ["T48", "T77", "T80", "T80-valid77"]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("T,valid", SHAPES, ids=SHAPE_IDS)
def test_fused_mha_plain_matches_pallas_interpret(T, valid, causal):
    qkv = _qkv(T)
    want = jax_fused_mha(jnp.asarray(qkv), HEADS, valid_len=valid, causal=causal, interpret=True)
    got = fused_mha(_t(qkv), HEADS, valid_len=valid, causal=causal)
    assert got.shape == (B, T, W)
    np.testing.assert_allclose(_np(got), _np(want), **KERNEL_TOL)


# The card's B6 tolerances (tests/port/test_torch_gpu.py DTYPES, chip_smoke.py).
CARD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("T,valid", SHAPES, ids=SHAPE_IDS)
def test_fused_mha_emulated_split_matches_pallas_interpret(T, valid, causal, dtype):
    """B6's products as the card forms them on the tensor cores
    (``split_error.emulate_mha``: three bf16 terms of an f32 q, k, p and v;
    one of a bf16 value and of p's bf16 rounding) against the Pallas
    ``_mha_kernel`` in interpret mode, at the card's tolerances."""
    qkv = _qkv(T, seed=9)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _fused_mha_fwd_impl(jnp.asarray(qkv, jdt), HEADS, valid, 1, True, causal)
    got = emulate_mha(_t(qkv).to(tdt), HEADS, T if valid is None else valid, causal)
    assert got.dtype == tdt and got.shape == (B, T, W)
    np.testing.assert_allclose(_np(got), _np(want), **CARD_TOL[dtype])


def test_fused_mha_bf16_close_to_f32():
    qkv = _qkv(80, seed=1)
    want = _np(jax_fused_mha(jnp.asarray(qkv), HEADS, valid_len=77, causal=True, interpret=True))
    jax_bf16 = jax_fused_mha(jnp.asarray(qkv, jnp.bfloat16), HEADS, valid_len=77, causal=True,
                             interpret=True)
    got = fused_mha(_t(qkv).to(torch.bfloat16), HEADS, valid_len=77, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, **BF16_TOL)
    np.testing.assert_allclose(_np(jax_bf16), want, **BF16_TOL)


# --- B7: its backward ------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("T,valid", [(77, 77), (80, 77)], ids=["T77", "T80-valid77"])
def test_fused_mha_bwd_plain_matches_pallas_interpret(T, valid, causal):
    qkv, g = _qkv(T, seed=2), _qkv(T, seed=3)[..., :W]
    want = _fused_mha_bwd_impl(jnp.asarray(qkv), jnp.asarray(g), HEADS, valid, 1, True, causal)
    got = fused_mha_bwd_reference(_t(qkv), _t(g), HEADS, valid, causal)
    assert got.shape == (B, T, 3 * W)
    np.testing.assert_allclose(_np(got), _np(want), **KERNEL_TOL)


def test_fused_mha_bwd_plain_bf16_matches_pallas_interpret():
    qkv, g = _qkv(80, seed=4), _qkv(80, seed=5)[..., :W]
    want = _fused_mha_bwd_impl(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16),
                               HEADS, 77, 1, True, True)
    got = fused_mha_bwd_reference(_t(qkv).to(torch.bfloat16), _t(g).to(torch.bfloat16), HEADS, 77, True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("T,valid", [(48, 48), (77, 77), (80, 77), (97, 90)],
                         ids=["T48", "T77", "T80-valid77", "T97-valid90"])
def test_fused_mha_bwd_emulated_split_matches_pallas_interpret(T, valid, causal, dtype):
    """B7's products as the card forms them on the tensor cores
    (``split_error.emulate_mha_bwd``: three bf16 terms of an f32 operand, one
    of a bf16 value and of p's bf16 rounding, ds in three terms) against the
    Pallas ``_mha_bwd_kernel`` in interpret mode, at B7's CPU tolerances; T 97
    is off B7's 32-row query and key tiles."""
    qkv, g = _qkv(T, seed=6), _qkv(T, seed=7)[..., :W]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _fused_mha_bwd_impl(jnp.asarray(qkv, jdt), jnp.asarray(g, jdt), HEADS, valid, 1, True, causal)
    got = emulate_mha_bwd(_t(qkv).to(tdt), _t(g).to(tdt), HEADS, valid, causal)
    assert got.dtype == tdt and got.shape == (B, T, 3 * W)
    np.testing.assert_allclose(_np(got), _np(want), **(KERNEL_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fused_mha_function_grad_equals_autograd_of_plain_forward(causal):
    """The Function's backward (the plain B7 on the CPU) against
    ``torch.autograd`` through the plain forward."""
    qkv = _t(_qkv(80, seed=6)).requires_grad_()
    g = _t(_qkv(80, seed=7)[..., :W])
    (got,) = torch.autograd.grad(fused_mha(qkv, HEADS, valid_len=77, causal=causal), [qkv], g)
    (want,) = torch.autograd.grad(fused_mha_reference(qkv, HEADS, 77, causal), [qkv], g)
    torch.testing.assert_close(got, want, **KERNEL_TOL)


# --- K3 causal ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def qkv_heads():
    rng = np.random.default_rng(8)
    return [rng.standard_normal((B, HEADS, 77, 64)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("valid", [None, [77, 60]], ids=["all-valid", "per-row-valid"])
def test_fused_attention_causal_matches_pallas_interpret(qkv_heads, valid):
    eot = [20, 76]
    kw = dict(causal=True, kv_valid_len=None if valid is None else np.asarray(valid, np.int32))
    want_out, want_aux = jax_fused_attention(
        *(jnp.asarray(a) for a in qkv_heads), attn_to_idx=jnp.asarray(eot, jnp.int32), interpret=True,
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()},
    )
    got_out, got_aux = fused_attention(
        *(_t(a) for a in qkv_heads), attn_to_idx=torch.tensor(eot), causal=True,
        kv_valid_len=None if valid is None else torch.tensor(valid),
    )
    np.testing.assert_allclose(_np(got_out), _np(want_out), **KERNEL_TOL)
    np.testing.assert_allclose(_np(got_aux), _np(want_aux), **KERNEL_TOL)
    # queries before their row's attribution key see it with probability 0
    for b, e in enumerate(eot):
        assert not _np(got_aux)[b, :e].any() and not _np(want_aux)[b, :e].any()


def test_idiomatic_context_queries_have_zero_aux(qkv_heads):
    """The idiomatic aux layer: context queries 1..P sit before every
    class's EOT key, so their column is exactly 0 in both packages."""
    P, eot = 5, [6 + 5, 9 + 5]
    q, k, v = qkv_heads
    _, want = jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                  attn_to_idx=jnp.asarray(eot, jnp.int32), interpret=True)
    _, got = fused_attention(_t(q), _t(k), _t(v), causal=True, attn_to_idx=torch.tensor(eot))
    assert (_np(got)[:, 1:P + 1] == 0).all() and (_np(want)[:, 1:P + 1] == 0).all()
    _, plain = attention_reference(_t(q), _t(k), _t(v), causal=True, attn_to_idx=torch.tensor(eot))
    assert (_np(plain)[:, 1:P + 1] == 0).all()


# --- the model -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def text77():
    jc = JCLIPConfig(**TEXT77)
    jp = jclip.init_clip_params(jax.random.PRNGKey(1), jc)
    tc = tcfg.CLIPConfig(**TEXT77)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return jc, jp, tc, tp


def test_params_bridge_carries_the_text_tower(text77):
    jc, jp, tc, tp = text77
    for key in ("token_embedding", "positional_embedding", "text_projection"):
        np.testing.assert_array_equal(_np(tp["text"][key]), _np(jp["text"][key]))
    for key in ("scale", "bias"):
        np.testing.assert_array_equal(_np(tp["text"]["ln_final"][key]), _np(jp["text"]["ln_final"][key]))


TEXTS = ["a photo of a Backpack.", "a bad photo of a Alarm Clock.", "Mug"]


@pytest.mark.parametrize("impl", ["auto", "xla", "fused_split"])
def test_encode_text_matches_jax(text77, impl):
    jc, jp, tc, tp = text77
    ids = t_get_tokenizer().tokenize(TEXTS, 77)
    np.testing.assert_array_equal(ids, j_get_tokenizer().tokenize(TEXTS, 77))
    want = jclip.encode_text(jp, jc, jnp.asarray(ids))
    got = tclip.encode_text(tp, tc.replace(attn_impl=impl), ids)
    assert got.shape == (3, jc.embed_dim)
    np.testing.assert_allclose(_np(got), _np(want), **MODEL_TOL)


@pytest.mark.parametrize("T", [77, 40])
def test_text_forward_embeds_idiomatic_matches_jax(text77, T):
    jc, jp, tc, tp = text77
    emb = (np.random.default_rng(9).standard_normal((3, T, jc.text_width)) * 0.1).astype(np.float32)
    eot = np.array([12, T - 1, 30], np.int32)
    want_f, want_aux = jclip.text_forward_embeds(jp, jc, jnp.asarray(emb), mode="idiomatic",
                                                 attn_to_idx=jnp.asarray(eot), pool_idx=jnp.asarray(eot))
    got_f, got_aux = tclip.text_forward_embeds(tp, tc, _t(emb), mode="idiomatic",
                                               attn_to_idx=torch.from_numpy(eot),
                                               pool_idx=torch.from_numpy(eot))
    assert got_aux.shape == (3, T)
    np.testing.assert_allclose(_np(got_f), _np(want_f), **MODEL_TOL)
    np.testing.assert_allclose(_np(got_aux), _np(want_aux), **MODEL_TOL)
    with pytest.raises(ValueError, match="idiomatic mode requires T"):
        tclip.text_forward_embeds(tp, tc, torch.zeros(1, 78, jc.text_width), mode="idiomatic")
    with pytest.raises(ValueError, match="unknown text mode"):
        tclip.text_forward_embeds(tp, tc, torch.zeros(1, 8, jc.text_width), mode="nope")


@pytest.mark.parametrize("impl", ["fused", "fused_split"])
def test_encode_image_fused_impls_match_jax(text77, impl):
    """``fused_split`` runs B6 in every vision block, ``fused`` K2 there;
    the JAX package runs XLA for both on the CPU."""
    jc, jp, tc, tp = text77
    x = np.random.default_rng(10).standard_normal((3, 32, 32, 3)).astype(np.float32)
    want = jclip.encode_image(jp, jc.replace(attn_impl=impl), jnp.asarray(x))
    got = tclip.encode_image(tp, tc.replace(attn_impl=impl), _t(x))
    np.testing.assert_allclose(_np(got), _np(want), **MODEL_TOL)


def test_fused_impl_with_aux_returns_none_like_jax(text77):
    """JAX's ``attn_forward(impl="fused")`` runs the packed-QKV core and
    returns no aux even when ``attn_to_idx`` is set; so does the port."""
    jc, jp, tc, tp = text77
    x = (np.random.default_rng(11).standard_normal((3, 24, W)) * 0.5).astype(np.float32)
    jblk = jax.tree.map(lambda a: a[0], jp["text"]["blocks"]["attn"])
    want, want_aux = jlayers.attn_forward(jnp.asarray(x), jblk, HEADS, causal=True, attn_to_idx=5,
                                          impl="fused")
    got, got_aux = tlayers.attn_forward(_t(x), tp["text"]["blocks"][0]["attn"], HEADS, causal=True,
                                        attn_to_idx=5, impl="fused")
    assert want_aux is None and got_aux is None
    np.testing.assert_allclose(_np(got), _np(want), **MODEL_TOL)
    emb = _t(x)
    _, aux = tclip.text_forward_embeds(tp, tc.replace(attn_impl="fused"), emb, attn_to_idx=23)
    assert aux is None


# --- idiomatic prompt tuning --------------------------------------------------------


def _idiomatic_pair(text77, classes=CLASSES):
    jc, jp, tc, tp = text77
    jpc = JPromptConfig(text_mode="idiomatic")
    jm = jmw.FullModel(classes, jp, jc, prompt_cfg=jpc, rng=jax.random.PRNGKey(3))
    trainable, bank = prompt_state_from_jax(
        jax.tree.map(np.asarray, jm.trainable), jax.tree.map(np.asarray, jm.prompt_learner.bank)
    )
    return jm, jpc, trainable, bank, tcfg.PromptConfig(text_mode="idiomatic")


def test_idiomatic_text_features_and_uniform_attribution_match_jax(text77):
    jc, jp, tc, tp = text77
    jm, jpc, trainable, bank, tpc = _idiomatic_pair(text77)
    want_f, want_a = jmw.text_features_with_attribution(
        jp, jm.trainable["ctx"], jm.prompt_learner.bank, jc, jpc, jm.trainable["adjustor"])
    got_f, got_a = tmw.text_features_with_attribution(tp, trainable["ctx"], bank, tc, tpc,
                                                      trainable["adjustor"])
    np.testing.assert_allclose(_np(got_f), _np(want_f), **MODEL_TOL)
    P, live = tpc.prompt_len, bank.class_mask.numpy()
    # A live class's context queries cannot see its EOT key: softmax of
    # zeros.  (A padded slot's EOT lands at row P, which sees it.)
    np.testing.assert_array_equal(_np(got_a)[live], np.full((live.sum(), P), 1.0 / P, np.float32))
    np.testing.assert_allclose(_np(got_a), _np(want_a), **MODEL_TOL)


def test_idiomatic_train_step_trajectory_matches_jax(text77):
    jc, jp, tc, tp = text77
    jm, jpc, trainable, bank, tpc = _idiomatic_pair(text77)
    rng = np.random.default_rng(12)
    batches = [(rng.standard_normal((4, jc.embed_dim)).astype(np.float32),
                rng.integers(0, len(CLASSES), 4).astype(np.int32)) for _ in range(5)]
    mask = np.array([True, True, True, False])
    jopt = jts.make_optimizer(JTrainConfig(lr=2e-3, weight_decay=0.01))
    jstate = jts.init_train_state(jm.trainable, jopt)
    jstep = jts.make_train_step(jc, jpc, jopt, use_image_feats=True)
    tstate = tts.init_train_state(trainable, tts.make_optimizer(tcfg.TrainConfig(lr=2e-3, weight_decay=0.01)))
    tstep = tts.make_train_step(tc, tpc, use_image_feats=True)
    for x, labels in batches:
        jstate, jm_ = jstep(jp, jstate, jm.prompt_learner.bank, jnp.asarray(x), jnp.asarray(labels),
                            jnp.asarray(mask))
        tstate, tm_ = tstep(tp, tstate, bank, x, labels, mask)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(_np(tm_[k]), _np(jm_[k]), err_msg=k, **TRAJ_TOL)
    np.testing.assert_allclose(_np(tstate.params["ctx"]), _np(jstate.params["ctx"]), **TRAJ_TOL)


def test_idiomatic_full_model_forward_matches_jax(text77):
    jc, jp, tc, tp = text77
    jm, jpc, trainable, bank, tpc = _idiomatic_pair(text77)
    x = np.random.default_rng(13).standard_normal((3, 32, 32, 3)).astype(np.float32)
    labels = np.array([0, 2, 1])
    want = jmw.full_model_forward(jp, jm.trainable, jm.prompt_learner.bank, jnp.asarray(x),
                                  jnp.asarray(labels), clip_cfg=jc, prompt_cfg=jpc, with_loss=True)
    got = tmw.full_model_forward(tp, trainable, bank, _t(x), torch.from_numpy(labels), clip_cfg=tc,
                                 prompt_cfg=tpc, with_loss=True)
    live = np.asarray(jm.prompt_learner.bank.class_mask)
    np.testing.assert_allclose(_np(got["logits"])[:, live], _np(want["logits"])[:, live], **MODEL_TOL)
    np.testing.assert_allclose(_np(got["loss"]), _np(want["loss"]), **MODEL_TOL)


# --- zero-shot ---------------------------------------------------------------------------


def test_zero_shot_classifier_and_logits_match_jax(text77):
    jc, jp, tc, tp = text77
    templates = ("a photo of a {}.", "a drawing of the {}.")
    names = CLASSES + ["Flip_Flops"]
    want = jzs.build_zero_shot_classifier(jp, jc, names, j_get_tokenizer(), templates=templates,
                                          batch_size=3)
    got = tzs.build_zero_shot_classifier(tp, tc, names, t_get_tokenizer(), templates=templates,
                                         batch_size=3)
    assert got.shape == (4, jc.embed_dim) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **MODEL_TOL)
    x = np.random.default_rng(14).standard_normal((3, 32, 32, 3)).astype(np.float32)
    want_l = jzs.zero_shot_logits(jp, jc, want, jnp.asarray(x))
    got_l = tzs.zero_shot_logits(tp, tc, got, x)
    np.testing.assert_allclose(_np(got_l), _np(want_l), rtol=1e-4, atol=1e-3)
    labels = np.asarray(want_l).argmax(-1)
    labels[0] = (labels[0] + 1) % 4  # one wrong row
    loader = [(x, labels, np.array([True, True, True]))]
    assert tzs.evaluate_zero_shot(tp, tc, got, loader) == pytest.approx(
        jzs.evaluate_zero_shot(jp, jc, want, loader)) == pytest.approx(200.0 / 3)
    assert tzs.class_name_to_text("Alarm_Clock") == jzs.class_name_to_text("Alarm_Clock")
    assert tzs.OPENAI_IMAGENET_TEMPLATES_SMALL == jzs.OPENAI_IMAGENET_TEMPLATES_SMALL
    assert tzs.DEFAULT_TEMPLATES == jzs.DEFAULT_TEMPLATES
