"""The port's file I/O against the JAX package's: weights, prompt
checkpoints, loaders, and the metrics that train and the cross-domain
entry points write.

Weights: the JAX package exports its tiny-config parameters as an open_clip
state dict; the port's converter must equal the JAX converter bridged by
``params_from_jax`` leaf by leaf, bit for bit, and ``export(convert(sd))``
must give the state dict back bit for bit.  Prompt checkpoints cross
between the packages as reference ``.pt`` files in both layouts with the
same ctx bit for bit and the same logits (LOGIT_TOL).  The loaders see the
same files in the same order and yield the same bytes on both decode paths;
the port's native library (its own build of ``native/image_pipeline.cpp``)
equals the JAX package's and the PIL path bit for bit at sizes that resize.
"""

import json
import logging
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.config import TrainConfig as JTrainConfig
from tapclip_tpu.data import domains as jdom
from tapclip_tpu.data import imagefolder as jif
from tapclip_tpu.data import native as jnative
from tapclip_tpu.data import preprocess as jpre
from tapclip_tpu.data import synthetic as jsyn
from tapclip_tpu.models import attribution_monitor as jam
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models.model_wrapper import FullModel as JFullModel
from tapclip_tpu.utils import calibration as jcal
from tapclip_tpu.utils import checkpoint as jck
from tapclip_tpu.utils import eval_metrics as jem
from tapclip_tpu.utils import torch_convert as jtc

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch.data import domains as tdom
from tapclip_tpu_torch.data import imagefolder as tif
from tapclip_tpu_torch.data import native as tnative
from tapclip_tpu_torch.data import prefetch as tpf
from tapclip_tpu_torch.data import preprocess as tpre
from tapclip_tpu_torch.data import synthetic as tsyn
from tapclip_tpu_torch.models import attribution_monitor as tam
from tapclip_tpu_torch.models.model_wrapper import FullModel
from tapclip_tpu_torch.trainer import CachedSet, fit_prompt_model
from tapclip_tpu_torch.utils import calibration as tcal
from tapclip_tpu_torch.utils import checkpoint as tck
from tapclip_tpu_torch.utils import eval_metrics as tem
from tapclip_tpu_torch.utils import logging_utils as tlog
from tapclip_tpu_torch.utils import torch_convert as ttc
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax, prompt_state_from_jax

CLASSES = ["Backpack", "Alarm_Clock", "Laptop"]
T_TINY = tcfg.TINY_TEST
# Logits are exp(logit_scale) = 14.3 times a cosine (the card's serving limits).
LOGIT_TOL = 1e-3
TRAJ_TOL = dict(rtol=1e-4, atol=5e-6)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flat(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype == torch.float32, k
        assert torch.equal(a, b), k


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def sd(tiny_params):
    """The JAX package's tiny parameters as an open_clip state dict."""
    return jtc.export_openclip_state_dict(_np(tiny_params), J_TINY)


# --- weights ----------------------------------------------------------------------


@pytest.mark.parametrize("image_size", [32, 48], ids=["same-grid", "pos-embed-resized"])
def test_convert_equals_bridged_jax_convert_exactly(sd, image_size):
    jc, tc = J_TINY.replace(image_size=image_size), T_TINY.replace(image_size=image_size)
    want = params_from_jax(_np(jtc.convert_openclip_state_dict(sd, jc)), tc)
    got = ttc.convert_openclip_state_dict(sd, tc)
    _assert_trees_equal(got, want)
    assert len(got["visual"]["blocks"]) == tc.vision_layers and isinstance(got["text"]["blocks"], list)


def test_convert_takes_tensor_values(sd):
    as_tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    _assert_trees_equal(ttc.convert_openclip_state_dict(as_tensors, T_TINY),
                        ttc.convert_openclip_state_dict(sd, T_TINY))


def test_export_of_convert_gives_back_the_state_dict(sd):
    back = ttc.export_openclip_state_dict(ttc.convert_openclip_state_dict(sd, T_TINY), T_TINY)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert back[k].dtype == np.float32 and back[k].shape == sd[k].shape, k
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


def test_openclip_files_cross_between_packages(tmp_path, sd, tiny_params):
    """The port's file loads in the JAX package to its own parameters, a JAX
    file loads in the port, and the ``state_dict`` nesting and ``module.``
    prefix are read."""
    port_params = ttc.convert_openclip_state_dict(sd, T_TINY)
    path = ttc.save_openclip_checkpoint(port_params, T_TINY, str(tmp_path / "port.pt"))
    jax_back = jtc.load_openclip_checkpoint(path, J_TINY)
    for (k, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jax_back)[0],
                              jax.tree_util.tree_flatten_with_path(_np(tiny_params))[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(k))
    jpath = jtc.save_openclip_checkpoint(_np(tiny_params), J_TINY, str(tmp_path / "jax.bin"))
    _assert_trees_equal(ttc.load_openclip_checkpoint(jpath, T_TINY), port_params)
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "nested.pt")
    _assert_trees_equal(ttc.load_openclip_checkpoint(str(tmp_path / "nested.pt"), T_TINY), port_params)


def test_convert_refuses_another_patch_size_and_resnet(sd):
    with pytest.raises(ValueError, match="patch size"):
        ttc.convert_openclip_state_dict(sd, T_TINY.replace(patch_size=8))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ttc.convert_openclip_state_dict(sd, tcfg.RN50)
    with pytest.raises(ValueError, match="no open_clip slot"):
        ttc.export_openclip_state_dict({**ttc.convert_openclip_state_dict(sd, T_TINY), "kd_proj": 0}, T_TINY)


def test_resize_pos_embed_vit_b16_to_336_bit_for_bit():
    """197 -> 577 tokens (ViT-B/16 at 224 -> 336 px): the same float64 numpy
    arithmetic as the JAX package, bit for bit, and torch's bicubic."""
    pos = np.random.default_rng(0).standard_normal((197, 768)).astype(np.float32)
    got = ttc.resize_pos_embed(pos, 577)
    assert got.shape == (577, 768) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jtc.resize_pos_embed(pos, 577))
    np.testing.assert_array_equal(got[0], pos[0])
    grid = torch.from_numpy(pos[1:].reshape(14, 14, 768)).permute(2, 0, 1)[None].double()
    ref = torch.nn.functional.interpolate(grid, size=(24, 24), mode="bicubic", align_corners=False)
    np.testing.assert_allclose(got[1:], ref[0].permute(1, 2, 0).reshape(576, 768).numpy(), atol=1e-5)
    np.testing.assert_array_equal(ttc.resize_pos_embed(pos, 197), pos)
    with pytest.raises(ValueError, match="square-grid"):
        ttc.resize_pos_embed(pos, 200)


# --- prompt checkpoints -------------------------------------------------------------


@pytest.fixture(scope="module")
def pair(tiny_params):
    """(JAX model, port model) on the same weights and prompt state, with
    trained-looking (random) context vectors."""
    jm = JFullModel(CLASSES, tiny_params, J_TINY)
    ctx = np.asarray(jm.trainable["ctx"]) + 0.1 * np.random.default_rng(5).standard_normal(
        jm.trainable["ctx"].shape).astype(np.float32)
    jm.trainable = dict(jm.trainable, ctx=jnp.asarray(ctx), logit_scale=jnp.asarray(np.float32(3.0)))
    tm = FullModel(CLASSES, params_from_jax(_np(tiny_params), T_TINY), T_TINY)
    tm.trainable, tm.prompt_learner.bank = prompt_state_from_jax(_np(jm.trainable), _np(jm.prompt_learner.bank))
    return jm, tm


def _images(seed, n=5):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _fresh_pair(tiny_params):
    jm = JFullModel(CLASSES, tiny_params, J_TINY)
    tm = FullModel(CLASSES, params_from_jax(_np(tiny_params), T_TINY), T_TINY)
    return jm, tm


def _logits_agree(jm, tm, seed=0):
    x = _images(seed)
    with torch.inference_mode():
        got = tm(x)["logits"].numpy()
    want = np.asarray(jm(jnp.asarray(x))["logits"])
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("legacy", [False, True], ids=["context_bank", "legacy-context_emb"])
def test_jax_reference_pt_into_port(tmp_path, pair, tiny_params, legacy):
    jm, _ = pair
    path = str(tmp_path / "ref.pt")
    jtc.save_reference_prompt_checkpoint(np.asarray(jm.trainable["ctx"]), CLASSES, path,
                                         logit_scale=np.asarray(jm.trainable["logit_scale"]), legacy=legacy)
    jm2, tm2 = _fresh_pair(tiny_params)
    tck.apply_prompt_checkpoint(tm2, path)
    jck.apply_prompt_checkpoint(jm2, path)
    n = len(CLASSES)
    np.testing.assert_array_equal(tm2.trainable["ctx"][:n].numpy(), np.asarray(jm.trainable["ctx"])[:n])
    assert float(tm2.trainable["logit_scale"]) == 3.0
    _logits_agree(jm2, tm2)


@pytest.mark.parametrize("legacy", [False, True], ids=["context_bank", "legacy-context_emb"])
def test_port_reference_pt_into_jax(tmp_path, pair, tiny_params, legacy):
    _, tm = pair
    path = str(tmp_path / "ref.pt")
    ttc.save_reference_prompt_checkpoint(tm.trainable["ctx"], CLASSES, path,
                                         logit_scale=tm.trainable["logit_scale"], legacy=legacy)
    loaded = jck.load_any_prompt_checkpoint(path, CLASSES)
    for i, name in enumerate(CLASSES):
        np.testing.assert_array_equal(loaded["ctx_by_name"][name], tm.trainable["ctx"][i].numpy())
    jm2, tm2 = _fresh_pair(tiny_params)
    jck.apply_prompt_checkpoint(jm2, path)
    tck.apply_prompt_checkpoint(tm2, path)
    _logits_agree(jm2, tm2, seed=1)


def test_unseen_names_in_a_checkpoint_grow_the_bank(tmp_path, tiny_params):
    jm, tm = _fresh_pair(tiny_params)
    rng = np.random.default_rng(2)
    names = CLASSES[:2] + ["Clipboards", "Mug"]
    ctx = rng.standard_normal((len(names), 5, J_TINY.text_width)).astype(np.float32)
    path = ttc.save_reference_prompt_checkpoint(ctx, names, str(tmp_path / "grow.pt"))
    tck.apply_prompt_checkpoint(tm, path)
    jck.apply_prompt_checkpoint(jm, path)
    assert tm.class_names == jm.class_names == CLASSES + ["Clipboards", "Mug"]
    for i, name in enumerate(names):
        np.testing.assert_array_equal(tm.trainable["ctx"][tm.class_names.index(name)].numpy(), ctx[i])
    _logits_agree(jm, tm, seed=3)


def test_load_ctx_never_writes_through_a_shared_bank(tiny_params):
    _, tm = _fresh_pair(tiny_params)
    bank = tm.prompt_learner.bank
    before = bank.ctx.clone()
    tm.prompt_learner.load_ctx({"Backpack": np.ones((5, T_TINY.text_width), np.float32)})
    assert torch.equal(bank.ctx, before)
    assert torch.equal(tm.prompt_learner.bank.ctx[0], torch.ones(5, T_TINY.text_width))
    got = tm.prompt_learner.ctx_by_name()
    assert list(got) == CLASSES and np.array_equal(got["Backpack"], np.ones((5, T_TINY.text_width)))


def _trained_state(tm, steps=3):
    """A model state after a few AdamW steps on random cached features."""
    from tapclip_tpu_torch.parallel import train_step as ts

    rng = np.random.default_rng(4)
    state = ts.init_train_state(tm.trainable, ts.make_optimizer(tcfg.TrainConfig(lr=5e-2)))
    step = ts.make_train_step(T_TINY, tcfg.PromptConfig())
    for _ in range(steps):
        feats = rng.standard_normal((4, T_TINY.embed_dim)).astype(np.float32)
        state, _ = step(tm.clip_params, state, tm.prompt_learner.bank, feats, rng.integers(0, 3, 4), None)
    return state


def test_prompt_checkpoint_round_trip(tmp_path, tiny_params):
    _, tm = _fresh_pair(tiny_params)
    state = _trained_state(tm)
    path = tck.save_prompt_checkpoint(str(tmp_path / "ck.pt"), trainable=state.params, bank=tm.prompt_learner.bank,
                                      class_names=tm.class_names, opt_state=state.opt_state(), step=state.step,
                                      extra_meta={"epoch": 2, "best_acc": 50.0})
    tree = tck.restore_prompt_checkpoint(path)
    assert tree["meta"] == {"class_names": CLASSES, "step": 3, "epoch": 2, "best_acc": 50.0}
    _assert_trees_equal({k: v for k, v in tree["trainable"].items() if k != "adjustor"},
                        {k: v.detach() for k, v in state.params.items() if k != "adjustor"})
    for got, want in zip(tree["opt_state"], state.opt_state()):
        assert float(got["step"]) == float(want["step"]) == 3.0
        assert torch.equal(got["exp_avg"], want["exp_avg"]) and torch.equal(got["exp_avg_sq"], want["exp_avg_sq"])
    bank = tck.bank_from_dict(tree["bank"])
    assert torch.equal(bank.token_embs, tm.prompt_learner.bank.token_embs)
    assert bank.class_mask.dtype == torch.bool and bank.eot_pos.dtype == torch.int32
    _, tm2 = _fresh_pair(tiny_params)
    tck.apply_prompt_checkpoint(tm2, path)
    assert torch.equal(tm2.trainable["ctx"][:3], state.params["ctx"].detach()[:3])
    loaded = tck.load_any_prompt_checkpoint(path, [])
    assert list(loaded["ctx_by_name"]) == CLASSES and loaded["meta"]["step"] == 3


def test_orbax_directories_and_foreign_files_are_refused(tmp_path, tiny_params):
    jm = JFullModel(CLASSES, tiny_params, J_TINY)
    orbax_dir = jck.save_prompt_checkpoint(str(tmp_path / "orbax"), trainable=jm.trainable,
                                           bank=jm.prompt_learner.bank, class_names=CLASSES)
    for fn in (tck.restore_prompt_checkpoint, lambda p: tck.load_any_prompt_checkpoint(p, CLASSES)):
        with pytest.raises(ValueError, match="Orbax"):
            fn(orbax_dir)
    ref = ttc.save_reference_prompt_checkpoint(np.zeros((3, 5, 64), np.float32), CLASSES, str(tmp_path / "r.pt"))
    with pytest.raises(ValueError, match="not a tapclip_tpu_torch prompt checkpoint"):
        tck.restore_prompt_checkpoint(ref)


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_checkpoint_manager_keeps_prunes_and_indexes_as_jax(tmp_path, tiny_params, async_save):
    jm, tm = _fresh_pair(tiny_params)
    metrics = [50.0, 90.0, 10.0, 30.0, 20.0]
    kept = {}
    for name, mod, model in (("jax", jck, jm), ("port", tck, tm)):
        d = tmp_path / name
        d.mkdir()
        (d / "step_00000099.pt").write_bytes(b"not ours")  # foreign: never swept
        with mod.CheckpointManager(str(d), keep_last_n=2, keep_best_n=1, async_save=async_save) as mgr:
            for step, m in enumerate(metrics, 1):
                mgr.save(step=step, trainable=model.trainable, bank=model.prompt_learner.bank,
                         class_names=CLASSES, metric=m, extra_meta={"epoch": step})
        kept[name] = sorted(os.path.basename(p).split(".")[0] for p in mgr.all_paths())
        assert os.path.basename(mgr.best_path).startswith("step_00000002")
        assert os.path.basename(mgr.latest_path).startswith("step_00000005")
        assert (d / "step_00000099.pt").exists()
    assert kept["port"] == kept["jax"] == ["step_00000002", "step_00000004", "step_00000005"]
    d = tmp_path / "port"
    assert sorted(os.listdir(d)) == ["manager_index.json", "step_00000002.pt", "step_00000004.pt",
                                     "step_00000005.pt", "step_00000099.pt"]
    index = json.loads((d / "manager_index.json").read_text())
    assert [(r["step"], r["metric"]) for r in index] == [(2, 90.0), (4, 30.0), (5, 20.0)]
    again = tck.CheckpointManager(str(d), keep_last_n=2, keep_best_n=1)
    assert [os.path.basename(p) for p in again.all_paths()] == ["step_00000002.pt", "step_00000004.pt",
                                                                 "step_00000005.pt"]
    assert tck.restore_prompt_checkpoint(again.best_path)["meta"] == {
        "class_names": CLASSES, "step": 2, "epoch": 2, "metric": 90.0}


def test_resume_two_plus_two_epochs_equals_four(tmp_path, tiny_params):
    """2 epochs, a checkpoint, then 2 epochs resumed from it equal 4
    uninterrupted epochs: ctx, AdamW step and both moments restored, and the
    shuffle's per-epoch seeds continue."""
    rng = np.random.default_rng(6)
    train = CachedSet(rng.standard_normal((10, T_TINY.embed_dim)).astype(np.float32), rng.integers(0, 3, 10))
    val = CachedSet(rng.standard_normal((6, T_TINY.embed_dim)).astype(np.float32), rng.integers(0, 3, 6))
    cfg = tcfg.TrainConfig(lr=5e-2, batch_size=4, patience=10)
    _, full_model = _fresh_pair(tiny_params)
    full = fit_prompt_model(full_model, train, val, cfg, epochs=4, verbose=False)

    _, first_model = _fresh_pair(tiny_params)
    mgr = tck.CheckpointManager(str(tmp_path / "ckpts"), keep_last_n=1)

    def snap(epoch, state, metric):
        mgr.save(step=state.step, trainable=state.params, bank=first_model.prompt_learner.bank,
                 class_names=CLASSES, opt_state=state.opt_state(), metric=metric, extra_meta={"epoch": epoch})

    first = fit_prompt_model(first_model, train, val, cfg, epochs=2, verbose=False, checkpoint_cb=snap,
                             checkpoint_every=1)
    tree = tck.restore_prompt_checkpoint(mgr.latest_path)
    assert tree["meta"]["epoch"] == 2 and tree["meta"]["step"] == 6
    _, second_model = _fresh_pair(tiny_params)
    resume = {"trainable": tree["trainable"], "opt_state": tree["opt_state"], "step": tree["meta"]["step"],
              "epoch": tree["meta"]["epoch"]}
    second = fit_prompt_model(second_model, train, val, cfg, epochs=2, verbose=False, resume_state=resume)
    np.testing.assert_allclose(first.loss_history + second.loss_history, full.loss_history, **TRAJ_TOL)
    assert first.acc_history + second.acc_history == full.acc_history
    assert second.final_state.step == full.final_state.step == 12
    np.testing.assert_allclose(second.final_state.params["ctx"].detach().numpy(),
                               full.final_state.params["ctx"].detach().numpy(), **TRAJ_TOL)
    for got, want in zip(second.final_state.opt_state(), full.final_state.opt_state()):
        assert float(got["step"]) == float(want["step"]) == 12.0
        np.testing.assert_allclose(got["exp_avg_sq"].numpy(), want["exp_avg_sq"].numpy(), **TRAJ_TOL)
    # A resume without the epoch restarts the shuffle and leaves the trajectory.
    _, restart_model = _fresh_pair(tiny_params)
    restart = fit_prompt_model(restart_model, train, val, cfg, epochs=2, verbose=False,
                               resume_state={**resume, "epoch": 0})
    assert not np.allclose(restart.loss_history, full.loss_history[2:], rtol=1e-6, atol=0)


def test_restored_optimizer_state_is_checked(tiny_params):
    from tapclip_tpu_torch.parallel import train_step as ts
    from tapclip_tpu_torch.trainer import _restore_opt_state

    def fresh():
        return ts.init_train_state({"ctx": torch.zeros(2, 3)}, ts.make_optimizer(tcfg.TrainConfig()))

    state = fresh()
    _restore_opt_state(state, None)
    _restore_opt_state(state, [{}])
    assert state.opt_state() == [{}]
    _restore_opt_state(state, [{"step": torch.tensor(4.0), "exp_avg": np.ones((2, 3), np.float32),
                                "exp_avg_sq": torch.ones(2, 3)}])
    (got,) = state.opt_state()
    assert float(got["step"]) == 4.0 and torch.equal(got["exp_avg"], torch.ones(2, 3))
    with pytest.raises(ValueError, match="optimizer state mismatch"):
        _restore_opt_state(fresh(), [{}, {}])
    with pytest.raises(ValueError, match="shape"):
        _restore_opt_state(fresh(), [{"step": 1, "exp_avg": torch.ones(3), "exp_avg_sq": torch.ones(3)}])


# --- loaders ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_native_ready():
    """The JAX package's native library (collection-time builds in several
    workers can race on its one path: re-read it once when the first load
    found a partial file)."""
    if not jnative.available():
        jnative._lib, jnative._build_error = None, None
    assert jnative.available(), jnative.build_error()
    assert tnative.available(), tnative.build_error()


SIZES = [(40, 57), (57, 40), (32, 32), (100, 33), (45, 45), (64, 90), (33, 70)]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Three classes of JPEGs and PNGs at sizes that need resizing to 32 px."""
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(0)
    for ci, name in enumerate(["ClassA", "ClassB", "ClassC"]):
        (root / name).mkdir()
        for i, (h, w) in enumerate(SIZES):
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            ext = "png" if (i + ci) % 3 == 0 else "jpg"
            Image.fromarray(arr).save(root / name / f"{i}.{ext}")
    (root / "ClassA" / "notes.txt").write_text("not an image")
    return str(root)


def test_synthetic_tree_and_batch_equal_jax(tmp_path):
    jsyn.build_imagefolder(str(tmp_path / "j"), CLASSES, per_class=3, image_size=24, seed=4)
    tsyn.build_imagefolder(str(tmp_path / "t"), CLASSES, per_class=3, image_size=24, seed=4)
    for name in CLASSES:
        files = sorted(os.listdir(tmp_path / "j" / name))
        assert files == sorted(os.listdir(tmp_path / "t" / name)) and len(files) == 3
        for f in files:
            assert (tmp_path / "j" / name / f).read_bytes() == (tmp_path / "t" / name / f).read_bytes()
    for a, b in zip(jsyn.random_batch(np.random.default_rng(1), 3, 8), tsyn.random_batch(np.random.default_rng(1), 3, 8)):
        np.testing.assert_array_equal(a, b)


def test_domains_equal_jax(tmp_path):
    for dom, classes in (("Art", ["A", "B", "C"]), ("Clipart", ["B", "C", "D"])):
        for c in classes:
            (tmp_path / dom / c).mkdir(parents=True)
    (tmp_path / "Art" / "file.txt").write_text("")
    assert tdom.discover_classes(str(tmp_path), "Art") == jdom.discover_classes(str(tmp_path), "Art") == ["A", "B", "C"]
    assert tdom.common_classes(str(tmp_path), ["Art", "Clipart"]) == ["B", "C"]
    assert tdom.common_classes(str(tmp_path), []) == []
    assert tdom.DATASETS == jdom.DATASETS and tdom.OFFICEHOME_UNSEEN_CLASSES == jdom.OFFICEHOME_UNSEEN_CLASSES


def test_preprocess_uint8_equals_jax(tree):
    path = os.path.join(tree, "ClassB", "1.jpg")
    np.testing.assert_array_equal(tpre.make_preprocess_uint8(32)(path), jpre.make_preprocess_uint8(32)(path))
    with Image.open(path) as im:
        got = tpre.make_preprocess_uint8(24)(im)
    assert got.dtype == np.uint8 and got.shape == (24, 24, 3)


def test_index_scan_and_few_shot_split_equal_jax(tree):
    ti, ji = tif.ImageFolderIndex.scan(tree), jif.ImageFolderIndex.scan(tree)
    assert (ti.classes, ti.class_to_idx, ti.samples) == (ji.classes, ji.class_to_idx, ji.samples)
    assert len(ti.samples) == 3 * len(SIZES)
    for shots, seed in ((0, 0), (2, 0), (3, 7), (9, 1)):
        names = ["ClassC", "ClassA"]
        ts, js = tif.few_shot_split(ti, names, shots, seed=seed), jif.few_shot_split(ji, names, shots, seed=seed)
        assert (ts.train, ts.val, ts.label_map) == (js.train, js.val, js.label_map)
    with pytest.raises(KeyError):
        tif.few_shot_split(ti, ["Nope"], 1)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("use_native", [False, True], ids=["pil", "native"])
def test_loader_batches_equal_jax(tree, jax_native_ready, use_native, dtype):
    """Two shuffled epochs, batch 4 over 21 files (a padded last batch):
    the same bytes, labels and masks as the JAX loader on the same path."""
    samples = tif.few_shot_split(tif.ImageFolderIndex.scan(tree), ["ClassA", "ClassB", "ClassC"], 9).train
    kw = dict(shuffle=True, seed=3, image_size=32, num_workers=2, use_native=use_native, output_dtype=dtype)
    tl, jl = tif.Loader(samples, 4, **kw), jif.Loader(samples, 4, **kw)
    assert tl.use_native == jl.use_native == use_native and tl.decoder == ("native" if use_native else "pil")
    assert len(tl) == len(jl) == 6
    for _ in range(2):
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) == 6
        for (ti, tlab, tm), (ji, jlab, jm) in zip(tb, jb):
            assert ti.dtype == ji.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tlab, jlab)
            np.testing.assert_array_equal(tm, jm)
        assert tb[-1][2].tolist() == [True] + [False] * 3
        assert not tb[-1][0][1:].any()


@pytest.mark.parametrize("use_native", [False, True], ids=["pil", "native"])
def test_loader_skips_and_counts_an_undecodable_file(tmp_path, jax_native_ready, use_native):
    rng = np.random.default_rng(1)
    d = tmp_path / "ClassA"
    d.mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 255, (36, 30, 3), dtype=np.uint8)).save(d / f"{i}.jpg")
    (d / "2.jpg").write_bytes(b"truncated garbage")
    samples = tif.ImageFolderIndex.scan(str(tmp_path)).samples
    tl = tif.Loader(samples, 3, image_size=32, use_native=use_native)
    jl = jif.Loader(samples, 3, image_size=32, use_native=use_native)
    tb, jb = list(tl), list(jl)
    assert tl.skipped == jl.skipped == 1
    assert sum(int(m.sum()) for _, _, m in tb) == 4
    for (a, la, ma), (b, lb, mb) in zip(tb, jb):
        np.testing.assert_array_equal(ma, mb)
        np.testing.assert_array_equal(a[ma], b[mb])
        np.testing.assert_array_equal(la, lb)


def test_native_equals_jax_native_and_pil(tree, jax_native_ready):
    """The port's own build of the native pipeline against the JAX package's
    library and the PIL path, bit for bit, at 32 and 24 px from 7 sizes."""
    paths = [p for p, _ in tif.ImageFolderIndex.scan(tree).samples]
    blobs = [open(p, "rb").read() for p in paths]
    assert tnative.library_path().is_file()
    assert str(tnative.library_path()) != jnative._SO_PATH
    for size in (32, 24):
        got, ok = tnative.decode_batch(paths, size, num_threads=3)
        want, jok = jnative.decode_batch(paths, size, num_threads=3)
        assert ok.all() and jok.all()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.stack([jpre.preprocess_path(p, size) for p in paths]))
        got8, _ = tnative.decode_batch_u8(paths, size)
        np.testing.assert_array_equal(got8, jnative.decode_batch_u8(paths, size)[0])
        np.testing.assert_array_equal(got8, np.stack([tpre.make_preprocess_uint8(size)(p) for p in paths]))
        np.testing.assert_array_equal(tnative.decode_bytes_batch(blobs, size)[0], got)
        np.testing.assert_array_equal(tnative.decode_bytes_batch_u8(blobs, size)[0], got8)
        raw, _ = tnative.decode_batch(paths[:2], size, do_normalize=False)
        np.testing.assert_array_equal(raw, jnative.decode_batch(paths[:2], size, do_normalize=False)[0])
    np.testing.assert_array_equal(tnative.decode_one(paths[3], 32), jpre.preprocess_path(paths[3], 32))
    bad = os.path.join(tree, "ClassA", "notes.txt")
    assert not tnative.decode_batch([bad], 32)[1][0]
    with pytest.raises(IOError):
        tnative.decode_one(bad, 32)


def test_get_dataloaders_equal_jax_and_log_the_decoder(tree, caplog):
    classes = ["ClassB", "ClassA"]
    with caplog.at_level(logging.INFO, logger="tapclip_tpu_torch"):
        t_train, t_val = tif.get_dataloaders(tree, classes, batch_size=4, num_shots=2, seed=2, image_size=32,
                                             verbose=False)
    j_train, j_val = jif.get_dataloaders(tree, classes, batch_size=4, num_shots=2, seed=2, image_size=32,
                                         verbose=False)
    assert t_train.samples == j_train.samples and t_val.samples == j_val.samples
    assert (t_train.shuffle, t_val.shuffle) == (True, False)
    assert f"loader: {t_val.decoder} decode path" in caplog.text
    t0, v0 = tif.get_dataloaders(tree, classes, num_shots=0, verbose=False)
    assert t0 is None and v0.samples == jif.get_dataloaders(tree, classes, num_shots=0, verbose=False)[1].samples


def test_path_feature_cache_encodes_each_image_once_as_jax(tree, pair):
    from tapclip_tpu.trainer import PathFeatureCache as JCache

    from tapclip_tpu_torch.trainer import PathFeatureCache

    jm, tm = pair
    split = tif.few_shot_split(tif.ImageFolderIndex.scan(tree), ["ClassA", "ClassB"], 3, seed=1)
    cache = PathFeatureCache(tm, batch_size=4, preprocess=tpre.make_preprocess(32), num_workers=2)
    calls = []
    encode = cache._encoder
    cache._encoder = lambda params, images: calls.append(len(images)) or encode(params, images)
    train, val = cache.gather(split.train), cache.gather(split.val)
    assert len(cache) == len(split.train) + len(split.val) and sum(calls) == 4 * len(calls)
    n_calls = len(calls)
    again = cache.gather(split.val + split.train)
    assert len(calls) == n_calls  # every path was cached
    np.testing.assert_array_equal(again.feats[: len(split.val)], val.feats)
    np.testing.assert_array_equal(train.labels, [lb for _, lb in split.train])
    want = JCache(jm, batch_size=4, preprocess=jpre.make_preprocess(32), num_workers=2).gather(split.val)
    np.testing.assert_allclose(val.feats, want.feats, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(val.labels, want.labels)


def test_background_iter_and_device_prefetch():
    assert list(tpf.background_iter(iter(range(7)), depth=2)) == list(range(7))

    def broken():
        yield 1
        raise RuntimeError("decode failed")

    it = tpf.background_iter(broken())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    batches = [(np.full((2, 3), i, np.float32), np.arange(2), {"m": np.ones(2, bool)}) for i in range(5)]
    out = list(tpf.prefetch_to_device(batches, size=2, device="cpu"))
    assert len(out) == 5
    for i, (x, y, d) in enumerate(out):
        assert torch.is_tensor(x) and x.device.type == "cpu" and torch.equal(x, torch.full((2, 3), float(i)))
        assert torch.equal(y, torch.arange(2)) and d["m"].dtype == torch.bool
    with pytest.raises(ValueError):
        list(tpf.device_prefetch([], size=0))


# --- metrics, calibration, logging ------------------------------------------------------


def test_metrics_equal_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((20, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 20)
    mask = rng.random(20) > 0.2
    np.testing.assert_array_equal(tem.confusion_from_logits(logits, labels, mask, 4),
                                  jem.confusion_from_logits(logits, labels, mask, 4))
    img, txt = rng.standard_normal((12, 8)), rng.standard_normal((12, 8))
    txt[3] = img[3]
    assert tem.retrieval_recall(img, txt) == jem.retrieval_recall(img, txt)
    with pytest.raises(ValueError, match="unpaired"):
        tem.retrieval_recall(img, txt[:5])
    attr = rng.random((16, 5)).astype(np.float32)
    lab = np.array([0, 0, 1, 1, 1, 3, 3, 3, 3, 0, 1, 3, 0, 0, 1, 3])
    for n_classes in (None, 6):
        got = float(tam.attribution_variance(torch.from_numpy(attr), torch.from_numpy(lab), n_classes))
        want = float(jam.attribution_variance(jnp.asarray(attr), jnp.asarray(lab), n_classes))
        assert got == pytest.approx(want, rel=1e-5)
    assert tem.attribution_variance is tam.attribution_variance


def test_calibration_equals_jax():
    rng = np.random.default_rng(10)
    logits = (4 * rng.standard_normal((40, 5))).astype(np.float32)
    labels = rng.integers(0, 5, 40)
    mask = rng.random(40) > 0.1
    got, want = tcal.calibrate_from_logits(logits, labels, mask), jcal.calibrate_from_logits(logits, labels, mask)
    assert got["n"] == want["n"] == int(mask.sum())
    for key in ("temperature", "ece_before", "ece_after"):
        assert got[key] == pytest.approx(want[key], rel=1e-4, abs=1e-6), key


def test_eval_loops_equal_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(11)
    batches = [(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8), rng.integers(0, 3, 4),
                np.array([True, True, True, i == 0])) for i in range(3)]
    jbatches = [(jnp.asarray(x), y, m) for x, y, m in batches]
    assert tem.evaluate_accuracy(tm, batches, verbose=False) == jem.evaluate_accuracy(jm, jbatches, verbose=False)
    assert (tem.evaluate_per_class_accuracy(tm, batches, class_names=CLASSES)
            == jem.evaluate_per_class_accuracy(jm, jbatches, class_names=CLASSES))
    np.testing.assert_array_equal(tem.confusion_matrix(tm, batches), jem.confusion_matrix(jm, jbatches))
    tl, ty, tmask = tcal.collect_logits(tm, batches)
    jl, jy, jmask = jcal.collect_logits(jm, jbatches)
    np.testing.assert_allclose(tl, jl, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(tmask, jmask)


def test_output_tree_logging_and_profile(tmp_path):
    paths = tlog.generate_output_paths("v1", str(tmp_path))
    assert sorted(paths) == ["base", "csv_dir", "log_dir", "model_dir", "plot_dir"]
    assert all(os.path.isdir(p) for p in paths.values())
    assert os.path.basename(paths["base"]).startswith("v1_")
    log_file = os.path.join(paths["log_dir"], "x.log")
    tlog.setup_logging(log_file).info("hello from the port")
    logging.getLogger().handlers[-1].flush()
    assert "| INFO | hello from the port" in open(log_file).read()
    with tlog.maybe_profile(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    with tlog.maybe_profile(None):
        pass
