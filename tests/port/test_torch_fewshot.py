"""The few-shot zoo's feature-space methods, TPT and ``fewshot`` against the
JAX package, on the CPU.

* Augment: ``resample_boxes`` from JAX's own boxes (the draw of
  ``augment_batch`` repeated with its keys) equals JAX's ``augment_batch``
  within 1e-6, with and without a flip, with boxes that reach past the
  image; the port's draw by its statistics (area and ratio in range, the
  box inside the image, the flip rate).
* TPT: ``_selected_marginal_entropy`` within 1e-6; ``make_tpt_predict_fn`` at
  V = 4 on JAX's augmented views: logits, baseline logits and both
  entropies within 1e-4; its refusals.
* The adapters after the same steps within 1e-5: the linear probe (JAX's
  W0), Tip-Adapter (the same grid pick and accuracy), Tip-Adapter-F and
  CLIP-Adapter (its init bit for bit; both fits at logit scale 1, see
  FIT_SCALE) and the k-NN scores.
* ``fewshot.main --device cpu`` on one small JPEG tree with all eleven
  methods: the Method and Shots columns equal JAX's, and the accuracy of
  every method that draws nothing at random within one image of JAX's
  (zero-shot, k-NN, Tip-Adapter, Tip-Adapter-F, CLIP-Adapter, prompt,
  ProGrad, PromptSRC).  The linear probe, MaPLe and TPT draw from each
  package's own generator: they are held above, and in
  ``test_torch_maple.py``, with JAX's draws passed in.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from tapclip_tpu import clip_adapter as jca
from tapclip_tpu import fewshot as jfs
from tapclip_tpu import linear_probe as jlp
from tapclip_tpu import tip_adapter as jtip
from tapclip_tpu import tpt as jtpt
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.config import PromptConfig as JPromptConfig
from tapclip_tpu.data import augment as jaug
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models import model_wrapper as jmw
from tapclip_tpu.utils import torch_convert as jtc

from tapclip_tpu_torch import clip_adapter as tca
from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import fewshot as tfs
from tapclip_tpu_torch import linear_probe as tlp
from tapclip_tpu_torch import tip_adapter as ttip
from tapclip_tpu_torch import tpt as ttpt
from tapclip_tpu_torch.data import augment as taug
from tapclip_tpu_torch.models import model_wrapper as tmw
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax, prompt_state_from_jax

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
# The fits that start from a cache or a classifier that already separates
# the training shots are compared at logit scale 1: at CLIP's 14.3 the
# softmax saturates, some gradient entries fall to 1e-8 where f32 keeps no
# relative precision, and Adam, which moves each entry by up to the rate
# whatever its gradient's size, turns that noise into differences of a
# tenth of the rate between two summation orders.
FIT_SCALE = 1.0
CLASSES = ["Backpack", "Pen", "Mug"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# --- augment ---------------------------------------------------------------------------


def _jax_boxes(rng, B, H, W, cfg):
    """The boxes JAX's ``augment_batch`` draws from ``rng`` (its own code,
    run op by op as the reference below is: a compiled program may round
    the box arithmetic another way)."""
    k_area, k_ar, k_x, k_y, k_flip = jax.random.split(rng, 5)
    area = jax.random.uniform(k_area, (B,), minval=cfg.scale[0], maxval=cfg.scale[1]) * (H * W)
    ar = jnp.exp(jax.random.uniform(k_ar, (B,), minval=math.log(cfg.ratio[0]), maxval=math.log(cfg.ratio[1])))
    w = jnp.clip(jnp.sqrt(area * ar), 1.0, float(W))
    h = jnp.clip(jnp.sqrt(area / ar), 1.0, float(H))
    boxes = {"x0": jax.random.uniform(k_x, (B,)) * (W - w), "y0": jax.random.uniform(k_y, (B,)) * (H - h),
             "w": w, "h": h}
    boxes["flip"] = (jax.random.bernoulli(k_flip, cfg.hflip, (B,)) if cfg.hflip > 0 else jnp.zeros((B,), bool))
    return boxes


@pytest.mark.parametrize("hflip", [0.0, 0.5], ids=["no-flip", "flip"])
def test_resample_from_jax_boxes_matches_jax(hflip):
    # ratio up to 4: wide boxes clamp to the image width; coordinates past
    # the edges clamp to the border pixels.
    cfg = dict(scale=(0.3, 1.0), ratio=(0.25, 4.0), hflip=hflip)
    images = np.random.default_rng(0).standard_normal((16, 24, 20, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(4)
    want = jaug.augment_batch(rng, jnp.asarray(images), jaug.AugmentConfig(**cfg))
    boxes = {k: torch.from_numpy(np.array(v)) for k, v in _jax_boxes(rng, 16, 24, 20, jaug.AugmentConfig(**cfg)).items()}
    assert float(boxes["w"].max()) == 20.0  # a box clamped to the image
    if hflip:
        assert 0 < int(boxes["flip"].sum()) < 16
    got = taug.resample_boxes(torch.from_numpy(images), boxes)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_draw_boxes_statistics():
    # Areas up to half the image at ratios in (3/4, 4/3): no box needs the
    # clamp, so area and log-ratio keep their uniform laws.
    cfg = taug.AugmentConfig(scale=(0.2, 0.5), ratio=(0.75, 4 / 3), hflip=0.5)
    b = taug.draw_boxes(torch.Generator().manual_seed(0), 4000, 40, 40, cfg)
    area = (b["w"] * b["h"] / (40 * 40)).numpy()
    log_ratio = np.log((b["w"] / b["h"]).numpy())
    assert area.min() >= 0.2 - 1e-5 and area.max() <= 0.5 + 1e-5 and abs(area.mean() - 0.35) < 0.01
    assert log_ratio.min() >= math.log(0.75) - 1e-5 and log_ratio.max() <= math.log(4 / 3) + 1e-5
    assert abs(float(log_ratio.mean())) < 0.01
    assert (b["x0"] >= 0).all() and (b["x0"] + b["w"] <= 40 + 1e-4).all()
    assert (b["y0"] >= 0).all() and (b["y0"] + b["h"] <= 40 + 1e-4).all()
    assert abs(float(b["flip"].float().mean()) - 0.5) < 0.03


# --- TPT --------------------------------------------------------------------------------


def test_selected_marginal_entropy_matches_jax():
    logits = np.random.default_rng(1).standard_normal((3, 8, 5)).astype(np.float32) * 3
    logp = np.asarray(jax.jit(jax.nn.log_softmax)(jnp.asarray(logits)))
    want = jax.jit(jtpt._selected_marginal_entropy, static_argnums=1)
    for k in (1, 3, 8):
        np.testing.assert_allclose(_np(ttpt._selected_marginal_entropy(torch.from_numpy(logp.copy()), k)),
                                   _np(want(jnp.asarray(logp), k)), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    jc = J_TINY
    jp = jclip.init_clip_params(jax.random.PRNGKey(0), jc)
    tc = tcfg.CLIPConfig(**{f: getattr(jc, f) for f in jc.__dataclass_fields__})
    return jc, jp, tc, params_from_jax(jax.tree.map(np.asarray, jp), tc)


def test_tpt_predict_matches_jax_on_its_views(tiny):
    jc, jp, tc, tp = tiny
    jm = jmw.FullModel(CLASSES, jp, jc, rng=jax.random.PRNGKey(3))
    tm = tmw.FullModel(CLASSES, tp, tc)
    tm.trainable, tm.prompt_learner.bank = prompt_state_from_jax(
        jax.tree.map(np.asarray, jm.trainable), jax.tree.map(np.asarray, jm.prompt_learner.bank))
    cfg = dict(n_views=4, select_frac=0.5, steps=1, lr=5e-2)
    images = np.random.default_rng(2).standard_normal((3, jc.image_size, jc.image_size, 3)).astype(np.float32)
    mask = np.array([True, True, False])
    rng = jax.random.PRNGKey(9)
    jlogits, jaux = jtpt.make_tpt_predict_fn(jc, JPromptConfig(), jtpt.TPTConfig(**cfg))(
        jp, jm.trainable, jm.prompt_learner.bank, jnp.asarray(images), rng, jnp.asarray(mask))
    # The views JAX's program draws: the clean view, then augment_batch on
    # the repeated batch with the same key.
    B, H, W, C = images.shape
    rep = np.broadcast_to(images[:, None], (B, 3, H, W, C)).reshape(B * 3, H, W, C)
    aug_cfg = jaug.AugmentConfig(scale=(0.3, 1.0), ratio=(3 / 4, 4 / 3), hflip=0.5)
    aug = np.asarray(jax.jit(jaug.augment_batch, static_argnums=2)(rng, jnp.asarray(rep), aug_cfg))
    aug = aug.reshape(B, 3, H, W, C)
    views = np.concatenate([images[:, None], aug], axis=1)
    tlogits, taux = ttpt.make_tpt_predict_fn(tc, tcfg.PromptConfig(), ttpt.TPTConfig(**cfg))(
        tp, tm.trainable, tm.prompt_learner.bank, images, None, mask, views=torch.from_numpy(views))
    live = slice(0, len(CLASSES))
    np.testing.assert_allclose(_np(tlogits)[:, live], _np(jlogits)[:, live], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(taux["baseline_logits"])[:, live], _np(jaux["baseline_logits"])[:, live],
                               rtol=1e-4, atol=1e-4)
    for k in ("entropy_before", "entropy_after"):
        np.testing.assert_allclose(_np(taux[k]), _np(jaux[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    assert float(taux["entropy_after"]) < float(taux["entropy_before"])
    # the port's own draw: view 0 is the clean image
    v = ttpt.make_views(torch.Generator().manual_seed(0), torch.from_numpy(images), ttpt.TPTConfig(**cfg))
    assert v.shape == (B, 4, H, W, C) and torch.equal(v[:, 0], torch.from_numpy(images))


def test_tpt_refusals(tiny):
    jc, jp, tc, tp = tiny
    for kw, match in ((dict(image_conditioned=True), "CoCoOp"), (dict(maple_depth=1), "maple_depth")):
        with pytest.raises(NotImplementedError, match=match):
            ttpt.make_tpt_predict_fn(tc, tcfg.PromptConfig(**kw))


# --- the adapters ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def feats():
    """Unit-row features of 3 classes around 3 centres, a zero-shot classifier."""
    rng = np.random.default_rng(3)
    centres = rng.standard_normal((3, 32))

    def make(n):
        y = np.arange(n) % 3
        x = centres[y] + 0.8 * rng.standard_normal((n, 32))
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32), y.astype(np.int32)

    zs = centres + 0.5 * rng.standard_normal(centres.shape)
    return make(12), make(30), (zs / np.linalg.norm(zs, axis=-1, keepdims=True)).astype(np.float32)


def test_linear_probe_matches_jax_with_its_init(feats):
    (xtr, ytr), (xva, yva), _ = feats
    kw = dict(steps=60, lr=0.1, weight_decay=1e-4)
    jw, jb = jlp.fit_linear_probe(xtr, ytr, 3, seed=5, **kw)
    w0 = 0.01 * jax.random.normal(jax.random.PRNGKey(5), (32, 3), jnp.float32)
    tw, tb = tlp.fit_linear_probe(xtr, ytr, 3, w0=np.asarray(w0), **kw)
    np.testing.assert_allclose(tw, jw, **TOL)
    np.testing.assert_allclose(tb, jb, **TOL)
    assert tlp.probe_accuracy(xva, yva, tw, tb) == jlp.probe_accuracy(xva, yva, jw, jb)
    assert [tlp.cosine_lr(0.1, 60, t) for t in (0, 30, 60, 90)] == pytest.approx([0.1, 0.05, 0.0, 0.0], abs=1e-12)


def test_tip_adapter_matches_jax(feats):
    (xtr, ytr), (xva, yva), zs = feats
    keys, values = ttip.build_cache_model(xtr, ytr, 3)
    jkeys, jvalues = jtip.build_cache_model(xtr, ytr, 3)
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(values, jvalues)
    np.testing.assert_allclose(_np(ttip.tip_logits(xva, keys, values, zs, 14.3, 1.75, 4.0)),
                               _np(jtip.tip_logits(xva, keys, values, zs, 14.3, 1.75, 4.0)), **TOL)
    assert ttip.search_hyperparams(xva, yva, keys, values, zs, 14.3) == jtip.search_hyperparams(
        xva, yva, keys, values, zs, 14.3)
    # The fit at its default steps and rate, at logit scale 1 (see FIT_SCALE).
    kf = ttip.fit_tip_adapter_f(keys, values, xtr, ytr, zs, FIT_SCALE, 1.0, 5.5)
    jkf = jtip.fit_tip_adapter_f(keys, values, xtr, ytr, zs, FIT_SCALE, 1.0, 5.5)
    assert np.abs(kf - keys).max() > 1e-2  # the keys moved
    np.testing.assert_allclose(kf, jkf, **TOL)
    assert ttip.cache_accuracy(xva, yva, kf, values, zs, 14.3, 1.0, 5.5) == jtip.cache_accuracy(
        xva, yva, jkf, values, zs, 14.3, 1.0, 5.5)


@pytest.mark.parametrize("text_adapter", [False, True], ids=["visual", "joint"])
def test_clip_adapter_matches_jax(feats, text_adapter):
    (xtr, ytr), (xva, yva), zs = feats
    for k, v in tca.init_adapter(32, 4, 7).items():
        np.testing.assert_array_equal(v, jca.init_adapter(32, 4, 7)[k])
    kw = dict(ratio=0.35, text_adapter=text_adapter, seed=2)  # default steps and rate
    tv, tt = tca.fit_clip_adapter(xtr, ytr, zs, FIT_SCALE, **kw)
    jv, jt = jca.fit_clip_adapter(xtr, ytr, zs, FIT_SCALE, **kw)
    for got, want in ((tv, jv),) + (((tt, jt),) if text_adapter else ()):
        for k in ("w1", "w2"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    assert (tt is None) == (jt is None) == (not text_adapter)
    np.testing.assert_allclose(_np(tca.adapter_logits(xva, zs, 1.0, tv, 0.35, tt)),  # the cosines
                               _np(jca.adapter_logits(xva, zs, 1.0, jv, 0.35, jt)), **TOL)
    assert tca.search_ratio(xva, yva, zs, 14.3, tv, text=tt) == jca.search_ratio(xva, yva, zs, 14.3, jv, text=jt)


def test_knn_scores_match_jax(feats):
    (xtr, ytr), (xva, _), _ = feats
    for k in (5, 50):  # k past N takes every train feature
        np.testing.assert_allclose(_np(tfs.knn_classify(xtr, ytr, xva, 3, k=k)),
                                   _np(jfs.knn_classify(xtr, ytr, xva, 3, k=k)), rtol=1e-5, atol=1e-3)


# --- fewshot.main -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("fewshot")
    rng = np.random.default_rng(0)
    for ci, name in enumerate(CLASSES):
        d = root / "tree" / name
        d.mkdir(parents=True)
        base = np.zeros(3)
        base[ci] = 180
        for i in range(6):
            Image.fromarray(np.clip(base + rng.normal(0, 25, (32, 32, 3)), 0, 255).astype(np.uint8)).save(
                d / f"{i}.jpg")
    params = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY))
    sd = jtc.save_openclip_checkpoint(params, J_TINY, str(root / "open_clip.bin"))
    return {"tree": str(root / "tree"), "sd": sd, "out": root}


DETERMINISTIC = ("zero-shot", "knn", "tip-adapter", "tip-adapter-f", "clip-adapter", "prompt", "prograd",
                 "promptsrc")


def test_fewshot_main_matches_jax(files):
    args = ["--train-root", files["tree"], "--shots", "2", "--preset", "tiny", "--pretrained", files["sd"],
            "--batch-size", "8", "--epochs", "2", "--lr", "5e-2", "--maple-depth", "2", "--tpt-views", "4"]
    want = jfs.main(args + ["--out", str(files["out"] / "jax")])
    got = tfs.main(args + ["--out", str(files["out"] / "port"), "--device", "cpu"])
    assert [r["Method"] for r in got] == [r["Method"] for r in want] == list(tfs.ALL_METHODS)
    assert [r["Shots"] for r in got] == [r["Shots"] for r in want] == ["2-shot"] * 11
    one_image = 100.0 / 12 + 0.01  # 4 held-out images per class
    for g, w in zip(got, want):
        assert 0.0 <= g["Accuracy"] <= 100.0 and g["TrainSeconds"] >= 0.0
        if g["Method"] in DETERMINISTIC:
            assert abs(g["Accuracy"] - w["Accuracy"]) <= one_image, (g, w)
    df = pd.read_csv(files["out"] / "port" / "fewshot.csv")
    assert list(df.columns) == tfs.CSV_COLUMNS and list(df["Method"]) == list(tfs.ALL_METHODS)
    assert (files["out"] / "port" / "fewshot_bar.png").is_file()
    with pytest.raises(ValueError, match="unknown methods"):
        tfs.run_fewshot_benchmark(files["tree"], methods=("nope",), cfg=tcfg.TINY_TEST, params=None)


@pytest.mark.parametrize("driver", ["linear_probe", "tip_adapter", "clip_adapter", "tpt"])
def test_standalone_mains_run_on_the_cpu(files, driver):
    """Each method's own entry point with ``--device cpu`` on the same tree;
    Tip-Adapter's (no random draw) against the JAX package's main."""
    model = ["--preset", "tiny", "--pretrained", files["sd"]]
    split = ["--train-root", files["tree"], "--shots", "2", "--batch-size", "8"]
    argv = {
        "linear_probe": ["--train-root", files["tree"], "--val-root", files["tree"], "--steps", "50"],
        "tip_adapter": split + ["--search-hp", "--finetune", "--steps", "20"],
        "clip_adapter": split + ["--search-ratio", "--text-adapter", "--steps", "20"],
        "tpt": ["--val-root", files["tree"], "--views", "4", "--batch-size", "8"],
    }[driver] + model
    mod = {"linear_probe": tlp, "tip_adapter": ttip, "clip_adapter": tca, "tpt": ttpt}[driver]
    got = mod.main(argv + ["--device", "cpu"])
    accs = {k: v for k, v in got.items() if k.endswith("acc") or k.endswith("accuracy")}
    assert accs and all(0.0 <= v <= 100.0 for v in accs.values()), got
    if driver == "tip_adapter":
        want = jtip.main(argv)
        assert sorted(got) == sorted(want) and (got["alpha"], got["beta"]) == (want["alpha"], want["beta"])
        for k in ("zero_shot_acc", "tip_acc", "tip_f_acc"):
            assert abs(got[k] - want[k]) <= 1 / 12 + 1e-9, (k, got[k], want[k])
