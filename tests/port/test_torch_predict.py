"""The classify path against the JAX package: ``predict`` and vision saliency.

Both packages' ``predict.main`` run on one folder of unlabeled JPEGs and PNGs
(nested, with one corrupt file that both skip), one open_clip state dict
exported by the JAX package from its tiny-config weights, and one reference
prompt ``.pt`` (the interchange format).  The port runs on ``--device cpu``
(its kernels' plain versions).  ``predictions.csv`` stores ``{:.6f}``
scores.  The int8 tower: off the TPU the JAX package rounds to nearest
(interpret mode has no PRNG), which is the port's ``--int8-deterministic``;
the port's stochastic default is held against its float run within
INT8_SERVE_TOL (``chip_smoke.py``'s limit on served f32 probabilities).
Saliency: the plain forward's probabilities and both grids against
``tapclip_tpu/utils/saliency.py`` on bridged weights.
"""

import csv
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tapclip_tpu import predict as j_predict
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.utils import saliency as jsal
from tapclip_tpu.utils import torch_convert as jtc

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import predict as t_predict
from tapclip_tpu_torch.models import clip as tclip
from tapclip_tpu_torch.utils import saliency as tsal
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

CLASSES = ["Backpack", "Alarm_Clock", "Laptop"]
SCORE_TOL = 1e-5  # beside the CSV's 6 decimals
ATTR_TOL = 1e-6
INT8_SCORE_TOL = 1e-3  # round to nearest on both sides; a code on the other side of a rounding step
INT8_SERVE_TOL = 1e-2
SAL_TOL = 1e-5
F32_TOL = 1e-4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """12 class-colored images (nested dirs, JPEG and PNG), a corrupt
    file, the state dict and a reference prompt .pt of seeded context."""
    root = tmp_path_factory.mktemp("predict")
    rng = np.random.default_rng(0)
    photos = root / "photos"
    for i in range(12):
        d = photos / ("a" if i % 2 else os.path.join("b", "c"))
        d.mkdir(parents=True, exist_ok=True)
        base = np.zeros(3)
        base[i % 3] = 170
        arr = np.clip(base + rng.normal(0, 40, (40 + i, 44, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"img{i:02d}.{'png' if i % 4 == 0 else 'jpg'}")
    (photos / "a" / "img05_broken.jpg").write_bytes(b"not a jpeg")
    params = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY))
    sd = jtc.save_openclip_checkpoint(params, J_TINY, str(root / "open_clip.bin"))
    ctx = (0.3 * rng.standard_normal((3, 5, J_TINY.text_width))).astype(np.float32)
    ckpt = jtc.save_reference_prompt_checkpoint(ctx, CLASSES, str(root / "prompts.pt"))
    return {"root": root, "photos": str(photos), "sd": sd, "ckpt": ckpt}


def _args(files, out, *extra):
    return ["--image-root", files["photos"], "--out", str(out), "--preset", "tiny", "--pretrained", files["sd"],
            "--ckpt", files["ckpt"], "--classes", *CLASSES, "--batch-size", "4", *extra]


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def predicted(files):
    """JAX's and the port's float predict (--top-k 2 --json), and the
    port's int8 runs."""
    root = files["root"]
    out = {"jax": j_predict.main(_args(files, root / "jax", "--top-k", "2", "--json")),
           "port": t_predict.main(_args(files, root / "port", "--top-k", "2", "--json", "--device", "cpu"))}
    return out


def _rows(result):
    head, *rows = _csv(result["csv"])
    return head, rows


def test_list_images_and_batches_match_jax(files):
    paths = t_predict.list_images(files["photos"])
    assert paths == j_predict.list_images(files["photos"]) and len(paths) == 13
    for dtype in ("uint8", "float32"):
        got = list(t_predict.iter_image_batches(paths, 4, 32, dtype))
        want = list(j_predict.iter_image_batches(paths, 4, 32, dtype))
        assert [m for _, m, _ in got] == [m for _, m, _ in want]
        assert sum(len(m) for _, m, _ in got) == 12 and all(len(m) == int(k.sum()) for _, m, k in got)
        for (gi, _, gk), (wi, _, wk) in zip(got, want):
            np.testing.assert_array_equal(gk, wk)
            np.testing.assert_array_equal(gi[gk], wi[wk])  # a masked row holds whatever the decoder left


def test_predict_float_matches_jax(predicted):
    jres, tres = predicted["jax"], predicted["port"]
    assert tres["n"] == jres["n"] == 12
    (jh, jrows), (th, trows) = _rows(jres), _rows(tres)
    assert th == jh == ["path", "label", "score", "label_2", "score_2"]
    for t, j in zip(trows, jrows):
        assert [t[0], t[1], t[3]] == [j[0], j[1], j[3]]
        np.testing.assert_allclose([float(t[2]), float(t[4])], [float(j[2]), float(j[4])], atol=SCORE_TOL, rtol=0)
    tj, jj = json.load(open(tres["json"])), json.load(open(jres["json"]))
    assert tj["classes"] == jj["classes"] == CLASSES
    np.testing.assert_allclose(tj["attribution"], jj["attribution"], atol=ATTR_TOL, rtol=0)
    assert np.asarray(tj["attribution"]).shape == (3, 5)
    assert [r["labels"] for r in tj["predictions"]] == [r["labels"] for r in jj["predictions"]]
    assert len({r[1] for r in trows}) > 1  # the prompts separate the colors


def test_predict_int8_deterministic_matches_jax(files, predicted, tmp_path):
    jres = j_predict.main(_args(files, tmp_path / "j", "--int8"))
    tres = t_predict.main(_args(files, tmp_path / "t", "--int8", "--int8-deterministic", "--device", "cpu"))
    (_, jrows), (_, trows) = _rows(jres), _rows(tres)
    assert [r[:2] for r in trows] == [r[:2] for r in jrows]
    np.testing.assert_allclose([float(r[2]) for r in trows], [float(r[2]) for r in jrows], atol=INT8_SCORE_TOL)
    # int8 rows differ from the float run's: the tower is quantized.
    float_rows = _rows(predicted["port"])[1]
    assert any(abs(float(a[2]) - float(b[2])) > 1e-6 for a, b in zip(trows, float_rows))


def test_predict_int8_stochastic_close_to_float(files, predicted, tmp_path):
    tres = t_predict.main(_args(files, tmp_path, "--int8", "--top-k", "3", "--device", "cpu"))
    (_, rows), (_, float_rows) = _rows(tres), _rows(predicted["port"])
    by_label = lambda r: {r[i]: float(r[i + 1]) for i in range(1, len(r), 2)}  # noqa: E731
    for r, f in zip(rows, float_rows):
        got, want = by_label(r), by_label(f)
        for name in want:
            assert abs(got[name] - want[name]) <= INT8_SERVE_TOL


def test_predict_saliency_and_uint8_transfer(files, predicted, tmp_path):
    """--saliency writes one overlay per image (and forces uint8 pixels);
    --no-uint8-transfer gives the float pipeline's answers."""
    tres = t_predict.main(_args(files, tmp_path / "s", "--saliency", "last", "--no-uint8-transfer", "--json",
                                "--device", "cpu"))
    rows = json.load(open(tres["json"]))["predictions"]
    assert len(rows) == 12 and all(os.path.isfile(r["saliency_png"]) for r in rows)
    assert sorted(os.listdir(tmp_path / "s" / "saliency"))[0] == "00000_img01_saliency.png"  # photos/a/ sorts first
    f32 = t_predict.main(_args(files, tmp_path / "f", "--no-uint8-transfer", "--top-k", "2", "--device", "cpu"))
    assert _rows(f32) == _rows(predicted["port"])


def test_predict_dp_matches_one_device_and_jax(files, predicted, tmp_path):
    """``predict --dp 2`` over two CPU replicas: the same rows as ``--dp 1``
    (scores at 1e-6: the halves' products sum in another order on the CPU)
    and as the JAX package's ``--dp 2`` on its virtual mesh."""
    port = t_predict.main(_args(files, tmp_path / "port", "--top-k", "2", "--json", "--device", "cpu", "--dp", "2"))
    jres = j_predict.main(_args(files, tmp_path / "jax", "--top-k", "2", "--json", "--dp", "2"))
    (ph, prows), (oh, orows), (jh, jrows) = _rows(port), _rows(predicted["port"]), _rows(jres)
    assert ph == oh == jh and len(prows) == len(orows) == len(jrows) == 12
    for p, o, j in zip(prows, orows, jrows):
        assert [p[0], p[1], p[3]] == [o[0], o[1], o[3]] == [j[0], j[1], j[3]]
        np.testing.assert_allclose([float(p[2]), float(p[4])], [float(o[2]), float(o[4])], atol=1e-6, rtol=0)
        np.testing.assert_allclose([float(p[2]), float(p[4])], [float(j[2]), float(j[4])], atol=SCORE_TOL, rtol=0)


def test_predict_refusals(files, tmp_path):
    with pytest.raises(SystemExit, match="--batch-size must divide by --dp"):
        t_predict.main(_args(files, tmp_path, "--dp", "3", "--device", "cpu"))
    # An image-conditioned (CoCoOp) model now runs: the full forward, no attribution.
    from tapclip_tpu_torch.models.model_wrapper import FullModel

    tp = params_from_jax(jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY)),
                         tcfg.TINY_TEST)
    cocoop = FullModel(CLASSES, tp, tcfg.TINY_TEST, prompt_cfg=tcfg.PromptConfig(image_conditioned=True))
    assert t_predict.predict_corpus(cocoop, []) == ([], None)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no images"):
        t_predict.main(_args(dict(files, photos=str(empty)), tmp_path, "--device", "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_predict.main(_args(files, tmp_path))


# --- saliency ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def towers(tiny_params):
    """(JAX params, port params) of the tiny config, and uint8 images."""
    tp = params_from_jax(jax.tree.map(np.asarray, tiny_params), tcfg.TINY_TEST)
    x = np.random.default_rng(3).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    return tiny_params, tp, x


def test_vision_attention_forward_matches_jax(towers):
    jp, tp, x = towers
    jf, jprobs = jsal.vision_attention_forward(jp, J_TINY, jnp.asarray(x))
    with torch.inference_mode():
        tf, tprobs = tsal.vision_attention_forward(tp, tcfg.TINY_TEST, x)
        kernel_path = tclip.encode_image(tp, tcfg.TINY_TEST, torch.from_numpy(x))
    assert tuple(tprobs.shape) == (2, 3, 4, 5, 5)  # layers, batch, heads, 1 + 4 patches
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=SAL_TOL, rtol=0)
    np.testing.assert_allclose(tprobs.sum(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(tf.numpy(), kernel_path.numpy(), atol=F32_TOL, rtol=F32_TOL)
    # uint8 pixels are normalized on the device: the float path's answer.
    from tapclip_tpu_torch.data.preprocess import normalize

    f32 = normalize(x.astype(np.float32) / 255.0).astype(np.float32)
    torch.testing.assert_close(tsal.vision_attention_forward(tp, tcfg.TINY_TEST, f32)[1], tprobs, rtol=0, atol=0)


@pytest.mark.parametrize("method", ["rollout", "last"])
def test_patch_saliency_matches_jax(towers, method):
    jp, tp, x = towers
    got = tsal.patch_saliency(tp, tcfg.TINY_TEST, x, method=method)
    want = jsal.patch_saliency(jp, J_TINY, jnp.asarray(x), method=method)
    assert got.shape == (3, 2, 2) and got.min() == 0.0 and got.max() == 1.0
    np.testing.assert_allclose(got, want, atol=SAL_TOL, rtol=0)


def test_attention_rollout_matches_jax(towers):
    probs = np.random.default_rng(4).random((3, 2, 4, 6, 6)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    got = tsal.attention_rollout(torch.from_numpy(probs)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsal.attention_rollout(jnp.asarray(probs))), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


def test_saliency_refusals(towers):
    _, tp, x = towers
    with pytest.raises(ValueError, match="unknown saliency method"):
        tsal.patch_saliency(tp, tcfg.TINY_TEST, x, method="gradcam")
    rn = tcfg.MODEL_PRESETS["RN50"]
    # The RN towers' map is the attention pool's (tests/port/test_torch_resnet.py);
    # the per-layer ViT forward keeps JAX's refusal.
    with pytest.raises(NotImplementedError, match="ViT towers only"):
        tsal.vision_attention_forward(tp, rn, x)


# --- evaluate_adaptive ------------------------------------------------------------------------


def test_evaluate_adaptive_matches_jax(files, tiny_params):
    """The two-path loop over a uint8 loader (the corrupt file masked out):
    accuracy and rescues equal JAX's at margins that rescue none, some and
    all of the images (the middle one in the widest gap of the cheap path's
    margins, so no image sits near it)."""
    from tapclip_tpu.data import imagefolder as jif
    from tapclip_tpu.models.model_wrapper import FullModel as JFullModel
    from tapclip_tpu.utils import adaptive_eval as jae

    from tapclip_tpu_torch.data import imagefolder as tif
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.utils import adaptive_eval as tae
    from tapclip_tpu_torch.utils.jax_bridge import prompt_state_from_jax

    jc = J_TINY.replace(token_prune_layer=1)
    tc = tcfg.TINY_TEST.replace(token_prune_layer=1)
    jm = JFullModel(CLASSES, tiny_params, jc)
    tm = FullModel(CLASSES, params_from_jax(jax.tree.map(np.asarray, tiny_params), tc), tc)
    tm.trainable, tm.prompt_learner.bank = prompt_state_from_jax(
        jax.tree.map(np.asarray, jm.trainable), jax.tree.map(np.asarray, jm.prompt_learner.bank))
    samples = [(p, i % 3) for i, p in enumerate(j_predict.list_images(files["photos"]))]

    def loaders():
        return (jif.Loader(samples, 8, image_size=32, output_dtype="uint8"),
                tif.Loader(samples, 8, image_size=32, output_dtype="uint8"))

    margins = np.sort(np.concatenate([
        jae._margins(jae.adaptive_logits(jm, x, margin=-np.inf)[0][np.asarray(m)][:, :3]) for x, _, m in loaders()[0]]))
    gap = int(np.argmax(np.diff(margins)))
    mid = float(margins[gap] + margins[gap + 1]) / 2
    for margin, rescued in ((0.0, 0), (mid, gap + 1), (np.inf, 12)):
        jl, tl = loaders()
        want = jae.evaluate_adaptive(jm, jl, margin=margin)
        got = tae.evaluate_adaptive(tm, tl, margin=margin)
        assert got == want and got[1]["total"] == 12 and got[1]["rescued"] == rescued, margin
