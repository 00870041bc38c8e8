"""The port's checkpoint tools and tour: ``convert_checkpoint``, ``ckpt_info``,
``model_soup`` and ``examples/quickstart``, against the JAX package's
scripts on the same files where both read them.

Conversions are exact: an open_clip state dict (the JAX package's tiny
weights, exported by its converter) -> the port's CLIP tree ``.pt`` -> back
to ``.bin`` gives every tensor back bit for bit, and the tree equals the JAX
weights bridged by ``params_from_jax``; prompt checkpoints cross to and from
the reference ``.pt`` in both layouts bit for bit, and the JAX package reads
the port's reference files to the same ctx.  ``ckpt_info`` counts what the
JAX script counts.  The soups follow ``tests/test_model_soup.py``, and the
uniform soup equals the JAX script's ``average_trees`` on the same leaves.
Every entry point runs as ``python -m`` in an interpreter that never
imports jax.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import scripts.ckpt_info as JCI
import scripts.model_soup as JMS
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.utils import torch_convert as jtc

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch.models import clip as clip_model
from tapclip_tpu_torch.scripts import ckpt_info, convert_checkpoint, model_soup
from tapclip_tpu_torch.utils import checkpoint as tck
from tapclip_tpu_torch.utils import torch_convert as ttc
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

TC = tcfg.TINY_TEST
CLASSES = ["Backpack", "Pen"]


@pytest.fixture(scope="module")
def openclip_bin(tmp_path_factory, tiny_params):
    """The JAX package's tiny weights as an open_clip ``.bin``."""
    path = str(tmp_path_factory.mktemp("bin") / "open_clip_pytorch_model.bin")
    jtc.save_openclip_checkpoint(jax.tree.map(np.asarray, tiny_params), J_TINY, path)
    return path


def _leaves_equal(a, b):
    """The same leaves at the same key paths (dict order aside), bit for bit."""
    la, lb = (dict(torch.utils._pytree.tree_flatten_with_path(t)[0]) for t in (a, b))
    assert set(la) == set(lb)
    for path, x in la.items():
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(lb[path])), path


def test_convert_clip_roundtrip_exact(openclip_bin, tiny_params, tmp_path):
    tree = str(tmp_path / "clip_tiny.pt")
    convert_checkpoint.main(["clip", "--src", openclip_bin, "--model", "tiny-test", "--dst", tree])
    _leaves_equal(tck.load_clip_tree(tree, TC), params_from_jax(jax.tree.map(np.asarray, tiny_params), TC))
    back = str(tmp_path / "back.bin")
    convert_checkpoint.main(["export", "--src", tree, "--model", "tiny-test", "--dst", back])
    src, got = torch.load(openclip_bin), torch.load(back)
    assert set(src) == set(got)
    for k in src:
        assert torch.equal(src[k], got[k]), k


def test_convert_prompt_legacy_layout(tmp_path):
    P = 5
    legacy_ctx = np.random.default_rng(0).standard_normal((2, P, TC.text_width)).astype(np.float32)
    src = tmp_path / "best_model_epoch27_acc99.71.pt"
    torch.save({"prompt_learner.context_emb": torch.from_numpy(legacy_ctx), "logit_scale": torch.tensor(2.0)}, src)
    dst = str(tmp_path / "prompts.pt")
    convert_checkpoint.main(["prompt", "--src", str(src), "--classes", *CLASSES, "--model", "tiny-test",
                             "--prompt-len", str(P), "--dst", dst])
    tree = tck.load_any_prompt_checkpoint(dst, CLASSES)
    assert tree["meta"]["class_names"] == CLASSES and tree["meta"]["source"] == str(src)
    for i, name in enumerate(CLASSES):
        np.testing.assert_array_equal(tree["ctx_by_name"][name], legacy_ctx[i])
    np.testing.assert_array_equal(tree["logit_scale"], np.float32(2.0))


@pytest.mark.parametrize("legacy", [False, True], ids=["per-class", "legacy"])
def test_prompt_export_roundtrip(tmp_path, legacy):
    """The port's prompt ``.pt`` -> reference ``.pt`` -> back (the port's and
    the JAX package's readers) == the ctx rows of the live classes."""
    from tapclip_tpu_torch.models.prompt_learner import PromptLearner
    from tapclip_tpu_torch.data.tokenizer import get_tokenizer

    params = clip_model.init_clip_params(torch.Generator().manual_seed(0), TC)
    pl = PromptLearner(CLASSES, params, TC, tcfg.PromptConfig(max_classes=4), get_tokenizer(None, TC.context_length),
                       banner=False)
    ctx = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 5, TC.text_width)).astype(np.float32))
    src = tck.save_prompt_checkpoint(str(tmp_path / "prompts.pt"), trainable={"ctx": ctx, "adjustor": {}},
                                     bank=pl.bank, class_names=CLASSES)
    dst = str(tmp_path / "ref.pt")
    convert_checkpoint.main(["prompt-export", "--src", src, "--dst", dst] + (["--legacy"] if legacy else []))
    back = ttc.load_reference_prompt_checkpoint(dst, CLASSES)[0]
    jback = jtc.load_reference_prompt_checkpoint(dst, CLASSES)[0]
    for i, name in enumerate(CLASSES):
        np.testing.assert_array_equal(back[name], ctx[i].numpy())
        np.testing.assert_array_equal(np.asarray(jback[name]), ctx[i].numpy())


def test_tools_refuse_orbax_directories(tmp_path):
    for argv in (["clip", "--src", str(tmp_path), "--model", "tiny-test", "--dst", str(tmp_path / "x.pt")],
                 ["prompt-export", "--src", str(tmp_path), "--dst", str(tmp_path / "x.pt")]):
        with pytest.raises(ValueError, match="Orbax"):
            convert_checkpoint.main(argv)
    with pytest.raises(ValueError, match="Orbax"):
        ckpt_info.main([str(tmp_path)])


def test_ckpt_info_counts_like_the_jax_script(openclip_bin, tmp_path, capsys):
    n = ckpt_info.main([openclip_bin])
    assert n == JCI.main([openclip_bin])
    tree = tck.save_clip_tree(str(tmp_path / "tree.pt"), ttc.load_openclip_checkpoint(openclip_bin, TC), TC)
    assert ckpt_info.main([tree, "--depth", "2"]) == n  # a tree holds the same parameters
    out = capsys.readouterr().out
    assert "format" in out and "params.visual" in out and f"total parameters: {n:,}" in out


def test_average_trees_exact():
    trees = [{"a": torch.full((2, 2), float(i)), "b": {"c": [torch.full((3,), 2.0 * i)]}} for i in range(1, 4)]
    soup = model_soup.average_trees(trees)
    assert torch.equal(soup["a"], torch.full((2, 2), 2.0))  # mean(1, 2, 3)
    assert torch.equal(soup["b"]["c"][0], torch.full((3,), 4.0))  # mean(2, 4, 6)


def test_average_trees_dtype_and_structure():
    soup = model_soup.average_trees([{"w": torch.ones(2, dtype=torch.bfloat16) * i} for i in (1.0, 3.0)])
    assert soup["w"].dtype == torch.bfloat16 and torch.equal(soup["w"].float(), torch.full((2,), 2.0))
    with pytest.raises(ValueError, match="structure"):
        model_soup.average_trees([{"w": torch.ones(2)}, {"x": torch.ones(2)}])
    with pytest.raises(ValueError, match="no ingredient"):
        model_soup.average_trees([])


def test_uniform_soup_equals_the_jax_scripts(tiny_params):
    """Three bridged trees: the port's soup == the JAX script's on the same leaves."""
    rng = np.random.default_rng(4)
    base = jax.tree.map(np.asarray, tiny_params)
    jtrees = [jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * 0.1).astype(a.dtype), base)
              for _ in range(3)]
    ports = [params_from_jax(t, TC) for t in jtrees]
    ports[1] = dict(reversed(list(ports[1].items())))  # leaves match by key path, whatever the dict order
    got = model_soup.average_trees(ports)
    _leaves_equal(got, params_from_jax(jax.tree.map(np.asarray, JMS.average_trees(jtrees)), TC))


def test_greedy_soup_keeps_helpful_drops_harmful():
    trees = [{"w": torch.tensor([v])} for v in (1.0, 1.2, 9.0)]

    def eval_fn(tree):
        return -abs(float(tree["w"][0]) - 1.0)

    order = list(np.argsort([eval_fn(t) for t in trees])[::-1])  # best first: 0, 1, 2
    soup, kept, _ = model_soup.greedy_soup(trees, order, eval_fn)
    assert kept == [0]  # 1.2 pulls the mean to 1.1 (worse), 9.0 far worse
    assert torch.equal(soup["w"], torch.tensor([1.0]))


def _ingredients(tmp_path, openclip_bin):
    tree = clip_model.init_clip_params(torch.Generator().manual_seed(1), TC)
    return [openclip_bin, tck.save_clip_tree(str(tmp_path / "ing1.pt"), tree, TC)]


def test_soup_cli_uniform_and_greedy(tmp_path, openclip_bin):
    paths = _ingredients(tmp_path, openclip_bin)
    out = model_soup.main(["--inputs", *paths, "--out", str(tmp_path / "soup.pt"), "--preset", "tiny",
                           "--device", "cpu"])
    a, b = (ttc.load_openclip_checkpoint(p, TC) for p in paths)
    soup = tck.load_clip_tree(out["out"], TC)
    want = ((a["logit_scale"].double() + b["logit_scale"].double()) / 2).float()
    assert torch.equal(soup["logit_scale"], want) and out["kept"] == [0, 1]

    rng = np.random.default_rng(0)
    root = tmp_path / "val"
    for ci, name in enumerate(["A", "B"]):
        (root / name).mkdir(parents=True)
        base = np.zeros(3)
        base[ci] = 180
        for i in range(4):
            arr = np.clip(base + rng.normal(0, 25, (32, 32, 3)), 0, 255)
            Image.fromarray(arr.astype(np.uint8)).save(root / name / f"{i}.jpg")
    out2 = model_soup.main(["--inputs", *paths, "--out", str(tmp_path / "gsoup.pt"), "--greedy",
                            "--val-root", str(root), "--preset", "tiny", "--device", "cpu", "--batch-size", "4"])
    assert 1 <= len(out2["kept"]) <= 2 and out2["val_acc"] is not None
    with pytest.raises(SystemExit, match="at least 2"):
        model_soup.main(["--inputs", paths[0], "--out", str(tmp_path / "x.pt"), "--preset", "tiny",
                         "--device", "cpu"])


def test_quickstart_end_to_end():
    """The tour runs its nine steps on the CPU and actually learns; step 9's
    exported encode_image gives unit-norm features."""
    from tapclip_tpu_torch.examples import quickstart

    out = quickstart.main(["--device", "cpu"])
    assert out["acc1"] >= 90.0  # the color-separable task is solved after prompt tuning
    assert out["probe"] >= 0.9
    assert out["n_preds"] == 30
    np.testing.assert_allclose(out["embedding"].norm(dim=-1).numpy(), 1.0, rtol=1e-5)


def test_entry_points_run_without_jax(tmp_path, openclip_bin):
    """Each tool and the tour as ``python -m`` on the CPU, in one interpreter
    that ends with neither jax nor the JAX package imported."""
    tree, soup, exp = (str(tmp_path / n) for n in ("tree.pt", "soup.pt", "export"))
    runs = [
        ("tapclip_tpu_torch.scripts.convert_checkpoint", ["clip", "--src", openclip_bin, "--model", "tiny-test",
                                                          "--dst", tree]),
        ("tapclip_tpu_torch.scripts.ckpt_info", [tree]),
        ("tapclip_tpu_torch.scripts.model_soup", ["--inputs", openclip_bin, tree, "--out", soup, "--preset", "tiny",
                                                  "--device", "cpu"]),
        ("tapclip_tpu_torch.scripts.export_model", ["--preset", "tiny", "--device", "cpu", "--pretrained", soup,
                                                    "--out", exp, "--batch", "2"]),
        ("tapclip_tpu_torch.examples.quickstart", ["--device", "cpu"]),
    ]
    code = (
        "import runpy, sys, tempfile, torch\n"
        "torch.set_num_threads(1)\n"
        f"tempfile.tempdir = {str(tmp_path)!r}\n"
        f"for mod, argv in {runs!r}:\n"
        "    sys.argv = [mod] + argv\n"
        "    runpy.run_module(mod, run_name='__main__', alter_sys=True)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tapclip_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "quickstart complete." in proc.stdout
    assert not [n for n in os.listdir(tmp_path) if n.startswith("tapclip_quickstart_")]  # the tour's own, removed
    assert os.path.exists(os.path.join(exp, "encode_image.pt2")) and os.path.exists(soup)
