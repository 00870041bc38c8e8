"""The evaluate and tune paths against the JAX package: corruptions,
``robustness`` and ``sweep`` (``zero_shot_eval`` is held in
``test_torch_retrieval.py``, ``evaluate_adaptive`` in
``test_torch_predict.py``).

Both packages run on one two-domain tree of class-colored JPEGs, one open_clip
state dict exported by the JAX package from its tiny-config weights and one
reference prompt ``.pt`` of seeded context.  The port runs on ``--device
cpu`` (its kernels' plain versions).  The five deterministic corruptions are
held against JAX's at every severity (CORRUPT_TOL); the three stochastic ones
draw from a ``torch.Generator`` where JAX draws from its keys, so they are
held by their statistics, as ``tests/test_robustness.py`` holds JAX's.
"""

import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from tapclip_tpu import robustness as j_rob
from tapclip_tpu import sweep as j_sweep
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.utils import corruptions as jcor
from tapclip_tpu.utils import torch_convert as jtc

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import robustness as t_rob
from tapclip_tpu_torch import sweep as t_sweep
from tapclip_tpu_torch.utils import corruptions as tcor

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

CLASSES = ["Alarm_Clock", "Backpack", "Laptop"]  # the tree's sorted folders
DOMAINS = ["Real World", "Art"]
DETERMINISTIC = ("gaussian_blur", "contrast", "brightness", "saturate", "pixelate")
CORRUPT_TOL = 1e-6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("robustness")
    rng = np.random.default_rng(0)
    for dom in DOMAINS:
        for ci, name in enumerate(CLASSES):
            d = root / "tree" / dom / name
            d.mkdir(parents=True)
            base = np.zeros(3)
            base[ci] = 170
            for i in range(6):
                Image.fromarray(np.clip(base + rng.normal(0, 40, (40, 48, 3)), 0, 255).astype(np.uint8)).save(
                    d / f"{i}.jpg")
    params = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY))
    sd = jtc.save_openclip_checkpoint(params, J_TINY, str(root / "open_clip.bin"))
    ctx = (0.3 * rng.standard_normal((3, 5, J_TINY.text_width))).astype(np.float32)
    ckpt = jtc.save_reference_prompt_checkpoint(ctx, CLASSES, str(root / "prompts.pt"))
    return {"root": root, "tree": str(root / "tree"), "sd": sd, "ckpt": ckpt}


# --- corruptions ------------------------------------------------------------------------------


@pytest.mark.parametrize("size", [32, 37])
@pytest.mark.parametrize("name", DETERMINISTIC)
def test_deterministic_corruptions_match_jax(name, size):
    u8 = np.random.default_rng(size).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    x = u8.astype(np.float32) / 255.0
    for sev in (1, 2, 3, 4, 5):
        want = np.asarray(jcor.corrupt(jnp.asarray(x), name, sev if name == "pixelate" else jnp.int32(sev)))
        got = tcor.corrupt(torch.from_numpy(x), name, sev).numpy()
        np.testing.assert_allclose(got, want, atol=CORRUPT_TOL, rtol=0, err_msg=f"{name} severity {sev}")
        assert not np.allclose(got, x)


def test_corrupt_uint8_normalized_matches_jax():
    u8 = np.random.default_rng(1).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    for name in DETERMINISTIC:
        want = np.asarray(jcor.corrupt_uint8_normalized(jnp.asarray(u8), name, 3 if name == "pixelate"
                                                        else jnp.int32(3)))
        got = tcor.corrupt_uint8_normalized(torch.from_numpy(u8), name, 3).numpy()
        np.testing.assert_allclose(got, want, atol=CORRUPT_TOL / 0.26, rtol=0)  # / the smallest std


@pytest.mark.parametrize("name", sorted(tcor.STOCHASTIC))
def test_stochastic_corruptions_draw_from_the_generator(name):
    x = torch.from_numpy(np.random.default_rng(2).random((2, 16, 16, 3), dtype=np.float32))
    a = tcor.corrupt(x, name, 3, torch.Generator().manual_seed(1))
    b = tcor.corrupt(x, name, 3, torch.Generator().manual_seed(1))
    c = tcor.corrupt(x, name, 3, torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and a.shape == x.shape and a.min() >= 0 and a.max() <= 1
    with pytest.raises(ValueError, match="requires an rng"):
        tcor.corrupt(x, name, 3)


def test_stochastic_corruption_statistics():
    """As tests/test_robustness.py: impulse noise hits about p of the
    pixels; gaussian noise grows with severity; and the moments the JAX
    definitions fix: gaussian noise of sigma about x, shot noise of mean x
    and variance x / lam."""
    g = torch.Generator().manual_seed(3)
    half = torch.full((1, 64, 64, 3), 0.5)
    frac = float((tcor.corrupt(half, "impulse_noise", 5, g) != 0.5).float().mean())
    assert 0.2 <= frac <= 0.35  # p = 0.27 at severity 5
    x = torch.from_numpy(np.random.default_rng(4).random((2, 16, 16, 3), dtype=np.float32))
    d1 = float((tcor.corrupt(x, "gaussian_noise", 1, g) - x).abs().mean())
    d5 = float((tcor.corrupt(x, "gaussian_noise", 5, g) - x).abs().mean())
    assert d5 > 2 * d1
    noise = tcor.corrupt(half, "gaussian_noise", 1, g) - 0.5
    assert abs(float(noise.std()) - 0.08) < 0.005 and abs(float(noise.mean())) < 0.005
    shot = tcor.corrupt(half, "shot_noise", 1, g)  # lam 60: N(30, 30) / 60
    assert abs(float(shot.mean()) - 0.5) < 0.005 and abs(float(shot.std()) - (0.5 / 60) ** 0.5) < 0.005


def test_corruption_refusals():
    x = torch.zeros((1, 8, 8, 3))
    with pytest.raises(KeyError, match="unknown corruption"):
        tcor.corrupt(x, "frobnicate", 1)
    assert float(tcor.corrupt(x, "brightness", 9).max()) == pytest.approx(0.5)  # severity clamps to 5


# --- robustness -------------------------------------------------------------------------------


def _rob_args(files, *extra):
    return ["--val-root", os.path.join(files["tree"], DOMAINS[0]), "--preset", "tiny", "--pretrained", files["sd"],
            "--ckpt", files["ckpt"], "--batch-size", "8", *extra]


def test_robustness_matches_jax(files, tmp_path):
    """The clean row and every deterministic row equal JAX's; a stochastic
    corruption adds its rows; robustness.csv and the chart."""
    names, severities = ["contrast", "pixelate"], ["--severities", "2"]
    want = j_rob.main(_rob_args(files, "--corruptions", *names, *severities))
    got = t_rob.main(_rob_args(files, "--corruptions", *names, "gaussian_noise", *severities, "--out", str(tmp_path),
                               "--device", "cpu"))
    assert got[0] == want[0] and got[0]["Corruption"] == "clean" and got[0]["Severity"] == 0
    assert got[: len(want)] == want and len(got) == len(want) + 1 == 4
    assert [(r["Corruption"], r["Severity"]) for r in got[len(want):]] == [("gaussian_noise", 2)]
    assert all(0.0 <= r["Accuracy"] <= 100.0 for r in got)
    df = pd.read_csv(tmp_path / "robustness.csv")
    assert list(df.columns) == ["Corruption", "Severity", "Accuracy", "Retention"] and len(df) == len(got)
    assert os.path.isfile(tmp_path / "robustness_bar.png")
    assert t_rob.mean_corruption_accuracy(got[: len(want)]) == j_rob.mean_corruption_accuracy(want)


def test_robustness_refusals():
    """Prompt kinds whose text is per sample or that carry vision prompts are
    refused before any work (the port's FullModel refuses them too)."""
    for change, match in ((dict(image_conditioned=True), "CoCoOp"), (dict(maple_depth=1), "MaPLe")):
        stub = SimpleNamespace(clip_cfg=tcfg.TINY_TEST, prompt_cfg=dataclasses.replace(tcfg.PromptConfig(), **change))
        with pytest.raises(NotImplementedError, match=match):
            t_rob.evaluate_robustness(stub, [])
    with pytest.raises(KeyError, match="unknown corruptions"):
        t_rob.evaluate_robustness(None, [], corruptions=("fog",))


# --- sweep ------------------------------------------------------------------------------------


def test_sweep_matches_jax(files, tmp_path):
    argv = ["--data-root", os.path.join(files["tree"], DOMAINS[0]), "--classes", *CLASSES, "--preset", "tiny",
            "--pretrained", files["sd"], "--lrs", "5e-2", "1e-2", "--shots", "3", "--epochs", "2"]
    want = j_sweep.main(argv + ["--out", str(tmp_path / "j")])
    got = t_sweep.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    assert got["n_cells"] == want["n_cells"] == 2
    keys = ["lr", "shots", "adjustor", "prompt_len", "seed", "best_acc", "epochs_run"]
    tdf, jdf = pd.read_csv(got["csv"]), pd.read_csv(want["csv"])
    assert list(tdf.columns) == list(jdf.columns)
    pd.testing.assert_frame_equal(tdf[keys], jdf[keys])
    assert {k: got["best"][k] for k in keys} == {k: want["best"][k] for k in keys}
    assert os.path.isfile(tmp_path / "t" / "best.json")
    with pytest.raises(ValueError, match="zero-shot"):
        t_sweep.main(argv + ["--shots", "0", "--out", str(tmp_path), "--device", "cpu"])
