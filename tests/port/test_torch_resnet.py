"""The RN50-family tower and the reference's ``CLIPWrapper`` against the JAX package, on the CPU.

RN tower (``models/resnet.py``), at ``tests/test_resnet.py``'s ``RCFG``
(64 px, width 16, one block a stage) with BatchNorm statistics drawn away
from identity, weights bridged by ``params_from_jax`` (HWIO -> OIHW):

* ``resnet_encode_image`` / ``clip.encode_image`` against JAX's at F32_TOL
  (rtol 1e-5, atol 1e-6: f32, only the order of the convolutions' sums
  differs), raw uint8 pixels equal to the float path;
* the open_clip converter both ways: a JAX-exported state dict converts to
  the bridged tree bit for bit, the port's export equals JAX's bit for bit,
  the attention pool's positional resample equals JAX's;
* the attention pool's saliency against JAX's: the pooled output (also
  the tower's) at F32_TOL, the probabilities at PROB_TOL (1e-6), each
  min-max-normalized grid at PROB_TOL over that map's range (the
  normalization divides by it); the RN refusals are JAX's (int8, token pruning,
  MaPLe, VPT, MoE, the ViT saliency forward);
* the RN presets' geometry, and each of RN50, RN101 and RN50x4 built,
  exported, converted back bit for bit and run at a reduced resolution;
* an RN ``FullModel``: logits and 3 pixels-in train steps against JAX's at
  TRAJ_TOL (rtol 1e-4, atol 5e-6), and ``/explain`` with saliency (its
  grid as the saliency grids above, plus the service's 6-decimal rounding).

``CLIPWrapper`` and ``last_layer_attention_map`` (``models/clip_wrapper.py``)
at the tiny config: the maps (causal and not) at 1e-6, every method against
JAX's ``CLIPWrapper`` on one JAX-exported state dict (the encoders' outputs at
F32_NORM_TOL, 2e-6 of the tensor's norm: each f32 run's distance from a
float64 one, twice), and the
non-causal map's column T-1 equal to the attribution pass's aux (K3's
function) at 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapclip_tpu.config import MODEL_PRESETS as J_PRESETS
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.config import CLIPConfig as JCLIPConfig
from tapclip_tpu.config import PromptConfig as JPromptConfig
from tapclip_tpu.config import TrainConfig as JTrainConfig
from tapclip_tpu.data.tokenizer import get_tokenizer as j_get_tokenizer
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models import clip_wrapper as jcw
from tapclip_tpu.models import model_wrapper as jmw
from tapclip_tpu.models import resnet as jrn
from tapclip_tpu.parallel import train_step as jts
from tapclip_tpu.utils import saliency as jsal
from tapclip_tpu.utils import torch_convert as jtc

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch.data.tokenizer import get_tokenizer as t_get_tokenizer
from tapclip_tpu_torch.models import clip as tclip
from tapclip_tpu_torch.models import clip_wrapper as tcw
from tapclip_tpu_torch.models import model_wrapper as tmw
from tapclip_tpu_torch.models import resnet as trn
from tapclip_tpu_torch.parallel import train_step as tts
from tapclip_tpu_torch.serve import PredictService
from tapclip_tpu_torch.utils import saliency as tsal
from tapclip_tpu_torch.utils import torch_convert as ttc
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax, prompt_state_from_jax

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-4, atol=5e-6)
SAL_TOL = 1e-5
PROB_TOL = 1e-6  # attention probabilities, f32
SERVE_ROUNDING = 5e-7  # PredictService rounds each value to 6 decimals
# The tiny text and image towers' f32 outputs: the port's and XLA's sums run in different orders,
# and each lies within about 5e-7 of the tensor's norm from a float64 run of the same tower
# (measured on encode_text: 4.6e-7 the port, 4.5e-7 JAX), so two f32 runs within twice that.
F32_NORM_TOL = 2e-6
MAP_TOL = 1e-6

RCFG = JCLIPConfig(name="rn-test", vision_tower="resnet", image_size=64, vision_width=16, resnet_layers=(1, 1, 1, 1),
                   vocab_size=520, context_length=12, text_width=16, text_layers=2, text_heads=2, embed_dim=24)


def _port_cfg(jc):
    return tcfg.CLIPConfig(**{f: getattr(jc, f) for f in jc.__dataclass_fields__})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _perturb_bn(node, rng):
    """BatchNorm statistics away from identity (a fresh BN is the identity)."""
    if isinstance(node, list):
        return [_perturb_bn(v, rng) for v in node]
    if not isinstance(node, dict):
        return node
    if set(node) == {"scale", "bias", "mean", "var"}:
        n = np.shape(node["mean"])
        return {"scale": rng.uniform(0.7, 1.3, n).astype(np.float32), "bias": rng.normal(0, 0.1, n).astype(np.float32),
                "mean": rng.normal(0, 0.05, n).astype(np.float32), "var": rng.uniform(0.6, 1.4, n).astype(np.float32)}
    return {k: _perturb_bn(v, rng) for k, v in node.items()}


@pytest.fixture(scope="module")
def rn():
    """(JAX params, port params, port config) at RCFG."""
    jp = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(1), RCFG))
    jp = dict(jp, visual=_perturb_bn(jp["visual"], np.random.default_rng(5)))
    tc = _port_cfg(RCFG)
    return jp, params_from_jax(jp, tc), tc


def _images(seed, n=3, size=RCFG.image_size):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


# --- the tower ---------------------------------------------------------------------------


def test_resnet_encode_image_matches_jax(rn):
    jp, tp, tc = rn
    x = _images(2)
    want = np.asarray(jclip.encode_image(jax.tree.map(jnp.asarray, jp), RCFG, jnp.asarray(x)))
    got = tclip.encode_image(tp, tc, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, **F32_TOL)
    torch.testing.assert_close(trn.resnet_encode_image(tp, tc, torch.from_numpy(x)), got, rtol=0, atol=0)
    fmap = trn.resnet_feature_map(tp, tc, torch.from_numpy(x))
    assert tuple(fmap.shape) == (3, RCFG.vision_width * 32, 2, 2)
    np.testing.assert_allclose(_np(fmap).transpose(0, 2, 3, 1),
                               np.asarray(jrn.resnet_feature_map(jax.tree.map(jnp.asarray, jp), RCFG, jnp.asarray(x))),
                               **F32_TOL)
    # uint8 pixels are normalized on the device: the float path's answer.
    from tapclip_tpu_torch.data.preprocess import normalize

    u8 = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    f32 = normalize(u8.astype(np.float32) / 255.0).astype(np.float32)
    torch.testing.assert_close(tclip.encode_image(tp, tc, torch.from_numpy(u8)),
                               tclip.encode_image(tp, tc, torch.from_numpy(f32)), rtol=0, atol=0)


def test_tf32_switch_is_restored_after_the_tower(rn, monkeypatch):
    _, tp, tc = rn
    before = torch.backends.cudnn.allow_tf32
    seen = []
    orig = trn.F.conv2d

    def spy(*a, **k):
        seen.append(torch.backends.cudnn.allow_tf32)
        return orig(*a, **k)

    monkeypatch.setattr(trn.F, "conv2d", spy)
    tclip.encode_image(tp, tc, torch.from_numpy(_images(4, n=1)))
    assert seen and not any(seen)  # every convolution without TF32
    assert torch.backends.cudnn.allow_tf32 == before


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)


def test_openclip_conversion_both_ways_matches_jax(rn, tmp_path):
    jp, tp, tc = rn
    sd = jtc.export_openclip_state_dict(jp, RCFG)
    _assert_trees_equal(ttc.convert_openclip_state_dict(sd, tc), tp)
    got = ttc.export_openclip_state_dict(tp, tc)
    assert sorted(got) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], np.asarray(sd[k]), err_msg=k)
    path = ttc.save_openclip_checkpoint(tp, tc, str(tmp_path / "rn.bin"))
    _assert_trees_equal(ttc.load_openclip_checkpoint(path, tc), tp)
    # a checkpoint loaded at another resolution: the attention pool's grid is resampled
    big = RCFG.replace(image_size=96)
    want = jtc.convert_openclip_state_dict(sd, big)["visual"]["attnpool"]["positional_embedding"]
    got = ttc.convert_openclip_state_dict(sd, _port_cfg(big))["visual"]["attnpool"]["positional_embedding"]
    assert tuple(got.shape) == (10, RCFG.vision_width * 32)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("method", ["rollout", "last"])
def test_resnet_saliency_matches_jax(rn, method):
    jp, tp, tc = rn
    x = np.random.default_rng(6).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    pooled, probs = tsal.resnet_saliency(tp, tc, x)
    assert tuple(probs.shape) == (3, 4)
    np.testing.assert_allclose(_np(pooled), _np(tclip.encode_image(tp, tc, torch.from_numpy(x))), **F32_TOL)
    jparams = jax.tree.map(jnp.asarray, jp)
    jpooled, jprobs = jsal._jitted_resnet_saliency(RCFG)(jparams, jnp.asarray(x))
    np.testing.assert_allclose(_np(pooled), np.asarray(jpooled), **F32_TOL)
    np.testing.assert_allclose(_np(probs), np.asarray(jprobs), atol=PROB_TOL, rtol=0)
    got = tsal.patch_saliency(tp, tc, x, method=method)
    want = jsal.patch_saliency(jparams, RCFG, jnp.asarray(x), method=method)
    assert got.shape == (3, 2, 2) and got.min() == 0.0 and got.max() == 1.0
    # min-max normalization divides the probabilities' error by each map's range
    spread = np.ptp(np.asarray(jprobs), axis=-1)[:, None, None]
    assert (np.abs(got - want) <= PROB_TOL / spread).all(), np.abs(got - want).max()


def test_resnet_refusals_match_jax(rn):
    jp, tp, tc = rn
    x = torch.zeros(1, 64, 64, 3)
    for kw, match in ((dict(quantize_tower=True), "quantize_tower is implemented for ViT towers only"),
                      (dict(token_keep_ratio=0.5), "token_keep_ratio applies to ViT towers only")):
        with pytest.raises(NotImplementedError, match=match):
            tclip.encode_image(tp, tc.replace(**kw), x)
        with pytest.raises(NotImplementedError, match=match):
            jclip.encode_image(jax.tree.map(jnp.asarray, jp), RCFG.replace(**kw), jnp.asarray(x.numpy()))
    with pytest.raises(NotImplementedError, match="MaPLe vision prompts apply to ViT towers only"):
        tclip.encode_image(tp, tc, x, maple_prompts=(torch.zeros(2, 16), None, None))
    for kw, match in ((dict(vpt_tokens=2), "vpt_tokens applies to ViT towers only"),
                      (dict(moe_experts=2), "moe_experts applies to ViT towers only")):
        with pytest.raises(NotImplementedError, match=match):
            tclip.init_clip_params(torch.Generator().manual_seed(0), tc.replace(**kw))
        with pytest.raises(NotImplementedError, match=match):
            jclip.init_clip_params(jax.random.PRNGKey(0), RCFG.replace(**kw))
    with pytest.raises(NotImplementedError, match="ViT towers only"):
        tsal.vision_attention_forward(tp, tc, x)
    with pytest.raises(NotImplementedError, match="requires a ViT vision tower"):
        tmw.FullModel(["a", "b"], tp, tc, prompt_cfg=tcfg.PromptConfig(maple_depth=1, prompt_len=2))


def test_resnet_presets_match_jax_geometry():
    for name in ("RN50", "RN101", "RN50x4", "RN50x16", "RN50x64"):
        got, want = tcfg.MODEL_PRESETS[name], J_PRESETS[name]
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert got.vision_tower == "resnet"


@pytest.mark.parametrize("name,size", [("RN50", 64), ("RN101", 64), ("RN50x4", 96)])
def test_resnet_presets_build_convert_and_encode(name, size):
    """Each preset's visual tower at its own widths and depths (a reduced
    input size): random init, export and convert back bit for bit, and
    finite features of the embed width."""
    cfg = tcfg.MODEL_PRESETS[name].replace(image_size=size)
    visual = trn.init_resnet_params(torch.Generator().manual_seed(0), cfg)
    assert [len(visual[f"layer{i + 1}"]) for i in range(4)] == list(cfg.resnet_layers)
    sd = ttc._export_resnet_visual(visual, cfg)
    _assert_trees_equal(ttc._convert_resnet_visual(sd, cfg, "cpu"), visual)
    feats = trn.resnet_encode_image({"visual": visual}, cfg, torch.from_numpy(_images(7, n=2, size=size)))
    assert tuple(feats.shape) == (2, cfg.embed_dim) and bool(torch.isfinite(feats).all())


# --- an RN FullModel ------------------------------------------------------------------------


def test_resnet_full_model_and_train_step_match_jax(rn):
    jp, tp, tc = rn
    names = ["Backpack", "Pen"]
    pcfg = dict(prompt_len=3, max_classes=4)
    jm = jmw.FullModel(names, jax.tree.map(jnp.asarray, jp), RCFG, prompt_cfg=JPromptConfig(**pcfg),
                       tokenizer=j_get_tokenizer(context_length=RCFG.context_length), rng=jax.random.PRNGKey(0))
    tm = tmw.FullModel(names, tp, tc, prompt_cfg=tcfg.PromptConfig(**pcfg),
                       tokenizer=t_get_tokenizer(context_length=RCFG.context_length))
    tm.trainable, tm.prompt_learner.bank = prompt_state_from_jax(
        jax.tree.map(np.asarray, jm.trainable), jax.tree.map(np.asarray, jm.prompt_learner.bank))
    x = _images(8, n=4)
    np.testing.assert_allclose(_np(tm(x)["logits"]), np.asarray(jm(jnp.asarray(x))["logits"]), rtol=1e-5, atol=1e-5)

    jopt = jts.make_optimizer(JTrainConfig(lr=5e-2))
    jstate = jts.init_train_state(jm.trainable, jopt)
    jstep = jts.make_train_step(RCFG, jm.prompt_cfg, jopt, use_image_feats=False)
    tstate = tts.init_train_state(tm.trainable, tts.make_optimizer(tcfg.TrainConfig(lr=5e-2)))
    tstep = tts.make_train_step(tc, tm.prompt_cfg, use_image_feats=False)
    labels, mask = np.array([0, 1, 1, 0], np.int32), np.ones(4, bool)
    for i in range(3):
        xi = _images(9 + i, n=4)
        jstate, jmet = jstep(jm.clip_params, jstate, jm.prompt_learner.bank, jnp.asarray(xi), jnp.asarray(labels),
                             jnp.asarray(mask))
        tstate, tmet = tstep(tp, tstate, tm.prompt_learner.bank, xi, labels, mask)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(_np(tmet[k]), _np(jmet[k]), err_msg=k, **TRAJ_TOL)
    np.testing.assert_allclose(_np(tstate.params["ctx"]), _np(jstate.params["ctx"]), **TRAJ_TOL)


def test_resnet_explain_with_saliency(rn):
    jp, tp, tc = rn
    tm = tmw.FullModel(["Backpack", "Pen"], tp, tc, prompt_cfg=tcfg.PromptConfig(prompt_len=3),
                       tokenizer=t_get_tokenizer(context_length=RCFG.context_length))
    svc = PredictService(tm, batch_size=2, max_latency_ms=5.0)
    try:
        px = np.random.default_rng(10).integers(0, 256, (64, 64, 3), dtype=np.uint8)
        out = svc.explain(px, saliency=True)
        jparams = jax.tree.map(jnp.asarray, jp)
        want = jsal.patch_saliency(jparams, RCFG, jnp.asarray(px[None]))[0]
        # As test_resnet_saliency_matches_jax holds the grids: the probabilities agree at PROB_TOL
        # (f32, the convolutions' order of sums differs), and the min-max normalization divides
        # that error by the map's range; the service rounds each entry to 6 decimals.
        _, jprobs = jsal._jitted_resnet_saliency(RCFG)(jparams, jnp.asarray(px[None]))
        _, probs = tsal.resnet_saliency(tp, tc, px[None])
        np.testing.assert_allclose(_np(probs), np.asarray(jprobs), atol=PROB_TOL, rtol=0)
        tol = PROB_TOL / float(np.ptp(np.asarray(jprobs)[0])) + SERVE_ROUNDING
        assert np.abs(np.asarray(out["saliency"]) - want).max() <= max(SAL_TOL, tol)
        assert set(out["attribution"]) == {"Backpack", "Pen"}
        assert out["class"] == svc.predict(px)["class"]
    finally:
        svc.close()


# --- CLIPWrapper ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wrappers(tmp_path_factory):
    """(JAX CLIPWrapper, port CLIPWrapper) on one JAX-exported state dict."""
    params = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY))
    sd = jtc.save_openclip_checkpoint(params, J_TINY, str(tmp_path_factory.mktemp("wrap") / "open_clip.bin"))
    jw = jcw.CLIPWrapper(cfg=J_TINY, pretrained_path=sd)
    tw = tcw.CLIPWrapper(cfg=tcfg.TINY_TEST, pretrained_path=sd, device="cpu")
    return jw, tw


@pytest.mark.parametrize("causal", [False, True], ids=["bare", "causal"])
def test_last_layer_attention_map_matches_jax(wrappers, causal):
    jw, tw = wrappers
    x = np.random.default_rng(11).standard_normal((2, 9, J_TINY.text_width)).astype(np.float32)
    want = np.asarray(jcw.last_layer_attention_map(jw.params, J_TINY, jnp.asarray(x), causal=causal))
    got = tcw.last_layer_attention_map(tw.params, tcfg.TINY_TEST, torch.from_numpy(x), causal=causal)
    assert tuple(got.shape) == (2, 9, 9) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, atol=MAP_TOL, rtol=0)
    np.testing.assert_allclose(_np(got).sum(-1), 1.0, atol=1e-6)
    if causal:
        assert float(torch.triu(got, diagonal=1).abs().max()) == 0.0


def _assert_norm_close(got, want, tol=F32_NORM_TOL):
    """``||got - want|| <= tol ||want||`` (the f32 error over the tensor's norm)."""
    assert got.shape == want.shape
    err = float(np.linalg.norm(got.astype(np.float64) - want) / np.linalg.norm(want))
    assert err <= tol, err


def test_clip_wrapper_matches_jax(wrappers):
    jw, tw = wrappers
    texts = ["a photo of a pen", "a mug"]
    assert np.array_equal(np.asarray(tw.get_tokenizer().tokenize(texts, J_TINY.context_length)),
                          np.asarray(jw.get_tokenizer().tokenize(texts, J_TINY.context_length)))
    ids = np.asarray(tw.get_tokenizer().tokenize(texts, J_TINY.context_length))
    assert tw.get_attention_map() is None
    _assert_norm_close(_np(tw.encode_text(ids)), np.asarray(jw.encode_text(jnp.asarray(ids))))
    np.testing.assert_allclose(_np(tw.get_attention_map()), np.asarray(jw.get_attention_map()), atol=MAP_TOL, rtol=0)
    tw.reset()
    assert tw.get_attention_map() is None
    x = np.random.default_rng(12).standard_normal((2, 32, 32, 3)).astype(np.float32)
    _assert_norm_close(_np(tw.encode_image(x)), np.asarray(jw.encode_image(jnp.asarray(x))))
    emb = np.random.default_rng(13).standard_normal((2, 10, J_TINY.text_width)).astype(np.float32)
    _assert_norm_close(_np(tw.transformer_raw(emb)), np.asarray(jw.transformer_raw(jnp.asarray(emb))))
    np.testing.assert_allclose(_np(tw.get_attention_map()), np.asarray(jw.get_attention_map()), atol=MAP_TOL, rtol=0)
    pre = tw.get_preprocess()
    from PIL import Image

    im = Image.fromarray(np.random.default_rng(14).integers(0, 256, (40, 50, 3), dtype=np.uint8))
    np.testing.assert_array_equal(np.asarray(pre(im)), np.asarray(jw.get_preprocess()(im)))


def test_transformer_raw_map_column_equals_the_attribution_aux(wrappers):
    """K3's aux output is the head-averaged attention of every query to one
    key: column T-1 of ``transformer_raw``'s map is the attribution pass's
    aux on the same embeddings."""
    _, tw = wrappers
    emb = np.random.default_rng(15).standard_normal((3, 13, J_TINY.text_width)).astype(np.float32)
    tw.transformer_raw(emb)
    amap = tw.get_attention_map()
    with torch.inference_mode():
        _, aux = tclip.text_forward_embeds(tw.params, tcfg.TINY_TEST, torch.from_numpy(emb), mode="ref_compat",
                                           attn_to_idx=12)
    np.testing.assert_allclose(_np(amap[:, :, 12]), _np(aux), atol=MAP_TOL, rtol=0)


def test_clip_wrapper_uses_its_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcw.CLIPWrapper(cfg=tcfg.TINY_TEST)
    w = tcw.CLIPWrapper(cfg=tcfg.TINY_TEST, device="cpu", rng_seed=3)
    assert w.device == torch.device("cpu") and w.params["logit_scale"].device.type == "cpu"
