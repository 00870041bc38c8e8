"""The base-to-new protocol (``base_to_new.py``) against the JAX package, on the CPU.

* ``harmonic_mean``, ``TRANSFER_KEYS`` and the CSV columns equal JAX's;
  ``split_selection_test`` gives the same halves in the same order (the
  same ``np.random.default_rng`` permutations).
* The trained set ``("ctx", "adjustor", "logit_scale")`` under the default
  ``"scale"`` adjustor: an empty subtree and a 0-dim leaf through
  ``init_train_state``, AdamW and ``_restore_opt_state``; 3 steps against
  JAX's at TRAJ_TOL (rtol 1e-4, atol 5e-6).
* ``main`` (``parse`` + ``run``) of both packages on one 4-class JPEG tree
  and one JAX-exported open_clip state dict: Base, New and H within one
  image of each (100 / n_images points; the port runs ``--device cpu``),
  the CSV's header written once over two appended runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tapclip_tpu import base_to_new as j_b2n
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.config import PromptConfig as JPromptConfig
from tapclip_tpu.config import TrainConfig as JTrainConfig
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models import model_wrapper as jmw
from tapclip_tpu.parallel import train_step as jts
from tapclip_tpu.utils import torch_convert as jtc

from tapclip_tpu_torch import base_to_new as t_b2n
from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import trainer as ttrainer
from tapclip_tpu_torch.models import model_wrapper as tmw
from tapclip_tpu_torch.parallel import train_step as tts
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax, prompt_state_from_jax

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

TRAJ_TOL = dict(rtol=1e-4, atol=5e-6)
COLORS = {"Blue": (30, 30, 200), "Cyan": (30, 200, 200), "Red": (200, 30, 30), "Yellow": (200, 200, 30)}
PER_CLASS = 8


@pytest.mark.parametrize("base,new", [(80.0, 80.0), (100.0, 50.0), (0.0, 0.0), (90.0, 0.0), (37.5, 62.25)])
def test_harmonic_mean_matches_jax(base, new):
    assert t_b2n.harmonic_mean(base, new) == j_b2n.harmonic_mean(base, new)


def test_transfer_keys_and_csv_columns_match_jax():
    assert t_b2n.TRANSFER_KEYS == j_b2n.TRANSFER_KEYS
    assert t_b2n.CSV_COLUMNS == ["Base", "New", "H", "Shots", "KgLambda"]


@pytest.mark.parametrize("sizes,seed", [((5, 5, 5), 7), ((1, 4, 9), 0), ((2, 3), 11)])
def test_split_selection_test_gives_jax_halves(sizes, seed):
    val = [(f"c{label}_{i}.jpg", label) for label, n in enumerate(sizes) for i in range(n)][::-1]
    got, want = t_b2n.split_selection_test(val, seed=seed), j_b2n.split_selection_test(val, seed=seed)
    assert got == want
    sel, test = got
    assert set(sel) | set(test) == set(val)
    if min(sizes) > 1:
        assert not set(sel) & set(test)


def test_empty_subtree_and_scalar_leaf_train_like_jax():
    """The protocol's trained set under the ``scale`` adjustor (no
    parameters): the step, its AdamW state and a restore of it."""
    jc = J_TINY
    jp = jclip.init_clip_params(jax.random.PRNGKey(0), jc)
    tc = tcfg.CLIPConfig(**{f: getattr(jc, f) for f in jc.__dataclass_fields__})
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    names = ["Blue", "Cyan"]
    jm = jmw.FullModel(names, jp, jc, prompt_cfg=JPromptConfig(), rng=jax.random.PRNGKey(0))
    tm = tmw.FullModel(names, tp, tc)
    tm.trainable, tm.prompt_learner.bank = prompt_state_from_jax(
        jax.tree.map(np.asarray, jm.trainable), jax.tree.map(np.asarray, jm.prompt_learner.bank))
    keys = ("ctx", "adjustor", "logit_scale")
    assert tm.trainable["adjustor"] == {} and tm.trainable["logit_scale"].dim() == 0
    jopt = jts.make_optimizer(JTrainConfig(lr=5e-2))
    jstate = jts.init_train_state(jm.trainable, jopt, keys)
    jstep = jts.make_train_step(jc, JPromptConfig(), jopt, trainable_keys=keys)
    topt = tts.make_optimizer(tcfg.TrainConfig(lr=5e-2))
    tstate = tts.init_train_state(tm.trainable, topt, keys)
    assert [tuple(p.shape) for p in tstate.diff_leaves()] == [tuple(tm.trainable["ctx"].shape), ()]
    tstep = tts.make_train_step(tc, tm.prompt_cfg, trainable_keys=keys)
    rng = np.random.default_rng(3)
    for _ in range(3):
        x = rng.standard_normal((4, jc.embed_dim)).astype(np.float32)
        y = rng.integers(0, 2, 4).astype(np.int32)
        mask = np.ones(4, bool)
        jstate, jmet = jstep(jp, jstate, jm.prompt_learner.bank, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
        tstate, tmet = tstep(tp, tstate, tm.prompt_learner.bank, x, y, mask)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), **TRAJ_TOL)
    for k in ("ctx", "logit_scale"):
        np.testing.assert_allclose(tstate.params[k].detach().numpy(), np.asarray(jstate.params[k]), **TRAJ_TOL)
    restored = tts.init_train_state(ttrainer.snapshot(tstate.params), topt, keys, step=tstate.step)
    ttrainer._restore_opt_state(restored, tstate.opt_state())
    st = restored.optimizer.state[restored.diff_leaves()[1]]
    assert float(st["step"]) == 3.0 and st["exp_avg"].dim() == 0


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A 4-class colored JPEG tree (alphabetical halves: Blue/Cyan base,
    Red/Yellow new) and a JAX-exported open_clip state dict."""
    root = tmp_path_factory.mktemp("b2n")
    rng = np.random.default_rng(0)
    for name, c in COLORS.items():
        d = root / "train" / name
        d.mkdir(parents=True)
        for i in range(PER_CLASS):
            arr = np.clip(np.array(c)[None, None] + rng.normal(0, 15, (J_TINY.image_size,) * 2 + (3,)), 0, 255)
            Image.fromarray(arr.astype(np.uint8)).save(d / f"{i}.jpg")
    params = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY))
    sd = jtc.save_openclip_checkpoint(params, J_TINY, str(root / "open_clip.bin"))
    return {"root": str(root / "train"), "sd": sd, "out": root}


@pytest.mark.parametrize("extra", [[], ["--kg-lambda", "0.5", "--class-split-seed", "1"]], ids=["plain", "kg-shuffled"])
def test_main_matches_jax(tree, extra, tmp_path):
    args = ["--root", tree["root"], "--preset", "tiny", "--pretrained", tree["sd"], "--shots", "4", "--epochs", "3",
            "--batch-size", "8", "--lr", "5e-2", *extra]
    want = j_b2n.main(args)
    out = tmp_path / "b2n"
    parsed = t_b2n.parse(args + ["--out", str(out), "--device", "cpu"])
    got = t_b2n.run(parsed)
    # Base is read on 2 classes x 2 held-out images, New on 2 x 8 images.
    for key, n_images in (("Base", 4), ("New", 2 * PER_CLASS)):
        assert abs(got[key] - want[key]) <= 100.0 / n_images + 0.01, (key, got, want)
    assert got["H"] == pytest.approx(t_b2n.harmonic_mean(got["Base"], got["New"]), abs=0.01)
    assert (got["Shots"], got["KgLambda"]) == (want["Shots"], want["KgLambda"])
    t_b2n.run(parsed)  # a second row appended under the one header
    lines = (out / "base_to_new.csv").read_text().splitlines()
    assert lines[0] == "Base,New,H,Shots,KgLambda" and len(lines) == 3


def test_main_device_cuda_without_card_raises(tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_b2n.main(["--root", tree["root"], "--preset", "tiny", "--shots", "1", "--epochs", "1"])
