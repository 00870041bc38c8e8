"""Pretraining's loaders and ``pretrain_cli`` against the JAX package, on the CPU.

* ``ShardLoader`` and ``CsvLoader``: the same files through both packages'
  loaders give the same batches, pixel for pixel and id for id, in the same
  order, over two epochs and across ranks; ``state`` / ``restore`` resume
  at an epoch; corrupt samples are skipped and counted; a manifest without
  the named columns raises.
* ``pretrain_cli.main`` on ``--device cpu`` beside the JAX package's
  ``main`` on one ImageFolder tree and one open_clip state dict (2 epochs,
  cosine schedule with warmup, global-norm clip, EMA, held-out shards
  every epoch, zero-shot every epoch, a snapshot every epoch): the
  per-epoch losses at rtol 1e-4, atol
  5e-6 (JAX runs it on the suite's 8-device virtual mesh, the port on one
  device: the same global-batch loss), the CSV rows (losses and the
  validation loss at that tolerance, Recall@K and the zero-shot accuracies
  within one sample), the final tree and the
  EMA tree as ``test_torch_pretrain._assert_tree`` holds parameters.  Then
  ``--resume`` from the port's snapshot for a third epoch, the final tree
  read back by ``featurize``'s loader, ``--shard-dir`` and ``--csv-path``
  epochs over the same images, and every refusal of the CLI.
"""

import csv
import io
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.data import csv_dataset as jcsv
from tapclip_tpu.data import shards as jshards
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.utils import torch_convert as jtc

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import pretrain as tpre
from tapclip_tpu_torch import pretrain_cli
from tapclip_tpu_torch.data import csv_dataset as tcsv
from tapclip_tpu_torch.data import shards as tshards
from tapclip_tpu_torch.data.tokenizer import SimpleTokenizer
from tapclip_tpu_torch.utils import checkpoint as ckpt_io
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

from test_torch_pretrain import TRAJ_TOL, _assert_tree

torch.set_num_threads(1)

T_TINY = tcfg.TINY_TEST
CLASSES = ["Backpack", "Pen", "Mug"]
PER_CLASS = 8


def _jpeg(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Class-coloured 40 x 48 JPEGs, ``PER_CLASS`` per class, plus the same
    images as shards of 10 and as a TSV manifest (relative paths)."""
    root = tmp_path_factory.mktemp("pretrain_data")
    rng = np.random.default_rng(0)
    rows, samples = [], []
    for ci, name in enumerate(CLASSES):
        (root / "tree" / name).mkdir(parents=True)
        base = np.zeros(3)
        base[ci] = 180
        for i in range(PER_CLASS):
            arr = np.clip(base + rng.normal(0, 25, (40, 48, 3)), 0, 255).astype(np.uint8)
            rel = f"tree/{name}/{i}.jpg"
            Image.fromarray(arr).save(root / rel)
            caption = f"a photo of a {name.lower()} number {i}"
            rows.append((rel, caption))
            samples.append((_jpeg(arr), caption))
    shard_dir = root / "shards"
    tshards.write_shards(samples, str(shard_dir), shard_size=10)
    with open(root / "pairs.tsv", "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["filepath", "title"])
        w.writerows(rows)
    return {"root": str(root), "tree": str(root / "tree"), "shards": str(shard_dir),
            "tsv": str(root / "pairs.tsv"), "n": len(rows)}


def _tokenize(caps):
    return np.asarray(SimpleTokenizer().tokenize(caps, 16))


def _epochs(loader, n=2):
    return [[(x.copy(), ids.copy()) for x, ids in loader] for _ in range(n)]


def _assert_same_batches(got, want):
    assert [len(e) for e in got] == [len(e) for e in want] and len(got[0]) > 0
    for eg, ew in zip(got, want):
        for (xg, ig), (xw, iw) in zip(eg, ew):
            np.testing.assert_array_equal(xg, xw)
            np.testing.assert_array_equal(ig, iw)


@pytest.mark.parametrize("world", [1, 2])
def test_shard_loader_matches_jax(tree, world):
    shards = tshards.list_shards(tree["shards"])
    kw = dict(tokenize=_tokenize, image_size=32, shuffle_buffer=5, seed=3, world=world, use_native=False)
    for rank in range(world):
        got = _epochs(tshards.ShardLoader(shards, 4, rank=rank, **kw))
        want = _epochs(jshards.ShardLoader(shards, 4, rank=rank, **kw))
        _assert_same_batches(got, want)
    one = tshards.ShardLoader(shards, 4, **dict(kw, world=1))
    assert len(one) == tree["n"] // 4 and one.num_samples == tree["n"]
    first = _epochs(one, 1)[0]
    second_epoch = _epochs(one, 1)
    resumed = tshards.ShardLoader(shards, 4, **dict(kw, world=1))
    resumed.restore({"epoch": 1, "shards_done": 0})
    _assert_same_batches(_epochs(resumed, 1), second_epoch)
    assert resumed.state() == {"epoch": 2, "shards_done": 0}
    assert not all(np.array_equal(a[0], b[0]) for a, b in zip(first, second_epoch[0]))  # reshuffled
    u8 = next(iter(tshards.ShardLoader(shards, 4, **dict(kw, world=1), output_dtype="uint8")))[0]
    assert u8.dtype == np.uint8 and u8.shape == (4, 32, 32, 3)


def test_csv_loader_matches_jax(tree, tmp_path):
    kw = dict(tokenize=_tokenize, image_size=32, seed=5, use_native=False)
    _assert_same_batches(_epochs(tcsv.CsvLoader(tree["tsv"], 5, **kw)),
                         _epochs(jcsv.CsvLoader(tree["tsv"], 5, **kw)))
    _assert_same_batches(_epochs(tcsv.CsvLoader(tree["tsv"], 5, rank=1, world=2, **kw)),
                         _epochs(jcsv.CsvLoader(tree["tsv"], 5, rank=1, world=2, **kw)))
    loader = tcsv.CsvLoader(tree["tsv"], 5, **kw)
    _epochs(loader, 1)
    second = _epochs(loader, 1)
    resumed = tcsv.CsvLoader(tree["tsv"], 5, **kw)
    resumed.restore({"epoch": 1})
    _assert_same_batches(_epochs(resumed, 1), second)
    assert resumed.state() == {"epoch": 2}
    bad = tmp_path / "bad.csv"
    with open(tree["tsv"]) as f:
        lines = f.read().splitlines()
    (tmp_path / "broken.jpg").write_bytes(b"not a jpeg")
    bad.write_text("\n".join(lines[:3] + [f"{tmp_path / 'broken.jpg'}\tbroken"]) + "\n")
    root_rel = [line.split("\t") for line in lines[1:3]]
    fixed = tmp_path / "fixed.tsv"
    fixed.write_text("filepath\ttitle\n" + "".join(f"{os.path.join(tree['root'], p)}\t{c}\n" for p, c in root_rel)
                     + f"{tmp_path / 'broken.jpg'}\tbroken\n")
    skipping = tcsv.CsvLoader(str(fixed), 2, **kw)
    batches = list(skipping)
    assert len(batches) == 1 and skipping.skipped == 1
    with pytest.raises(ValueError, match="need columns"):
        tcsv.CsvLoader(tree["tsv"], 5, img_key="path", **kw)


@pytest.fixture(scope="module")
def sd_path(tmp_path_factory):
    params = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY))
    return jtc.save_openclip_checkpoint(params, J_TINY, str(tmp_path_factory.mktemp("sd") / "open_clip.bin"))


def _cli_args(tree, sd_path, out, *extra):
    return ["--preset", "tiny", "--data-root", tree["tree"], "--pretrained", sd_path, "--epochs", "2",
            "--batch-size", "8", "--lr", "1e-3", "--schedule", "cosine", "--warmup-steps", "1", "--grad-clip", "1",
            "--ema-decay", "0.9", "--zeroshot-val-root", tree["tree"], "--val-shard-dir", tree["shards"],
            "--save-every", "1", "--output-root", str(out), *extra]


def _rows(paths):
    with open(os.path.join(paths["csv_dir"], "pretrain_metrics.csv")) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def runs(tree, sd_path, tmp_path_factory):
    from tapclip_tpu import pretrain_cli as jcli

    jout = jcli.main(_cli_args(tree, sd_path, tmp_path_factory.mktemp("jax_out")))
    tout = pretrain_cli.main(_cli_args(tree, sd_path, tmp_path_factory.mktemp("port_out"), "--device", "cpu"))
    return jout, tout


def test_pretrain_cli_matches_jax(runs):
    import orbax.checkpoint as ocp

    jout, tout = runs
    np.testing.assert_allclose(tout["loss_history"], jout["loss_history"], **TRAJ_TOL)
    jrows, trows = _rows(jout["paths"]), _rows(tout["paths"])
    recall = [f"{d}_r@{k}" for d in ("i2t", "t2i") for k in (1, 5, 10)]
    assert list(trows[0]) == list(jrows[0])
    assert set(trows[0]) == {"epoch", "loss", "skipped_images", "val_loss", *recall, "zeroshot_acc",
                             "zeroshot_acc_ema"}
    n = len(CLASSES) * PER_CLASS
    for tr, jr in zip(trows, jrows):
        assert tr["epoch"] == jr["epoch"] and tr["skipped_images"] == jr["skipped_images"] == "0"
        for key in ("loss", "val_loss"):
            np.testing.assert_allclose(float(tr[key]), float(jr[key]), rtol=1e-4, atol=1e-5, err_msg=key)
        for key in recall:  # a near tie may rank one pair apart
            assert abs(float(tr[key]) - float(jr[key])) <= 1.0 / n + 1e-4, (key, tr, jr)
        for key in ("zeroshot_acc", "zeroshot_acc_ema"):
            assert abs(float(tr[key]) - float(jr[key])) <= 100.0 / n + 1e-6, (key, tr, jr)
    assert len(tout["val_history"]) == 2 and "ema" in tout["val_history"][0]
    steps = 2 * (n // 8)
    for key in ("ckpt", "ema_ckpt"):
        want = ocp.PyTreeCheckpointer().restore(os.path.abspath(jout[key]))
        got = ckpt_io.load_clip_tree(tout[key], T_TINY)
        _assert_tree(got, dict(tpre.named_leaves(params_from_jax(jax.tree.map(np.asarray, want), T_TINY))),
                     TRAJ_TOL, steps=steps)
    snaps = sorted(f for f in os.listdir(tout["paths"]["model_dir"]) if f.startswith("pretrain_snapshot"))
    assert snaps == ["pretrain_snapshot_e000002.pt"]


def test_pretrain_cli_resume_featurize_shards_and_csv(runs, tree, sd_path, tmp_path):
    from tapclip_tpu_torch import featurize
    from tapclip_tpu_torch.models import clip as tclip

    _, tout = runs
    snap = os.path.join(tout["paths"]["model_dir"], "pretrain_snapshot_e000002.pt")
    resumed = pretrain_cli.main(_cli_args(tree, sd_path, tmp_path / "resumed", "--device", "cpu", "--epochs", "3",
                                          "--resume", snap))
    assert len(resumed["loss_history"]) == 1 and [r["epoch"] for r in _rows(resumed["paths"])] == ["3"]
    params = featurize.load_clip_params(T_TINY, resumed["ckpt"], device="cpu")
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    emb = featurize.make_image_embed_fn(T_TINY)(params, x)
    want = tclip.l2_normalize(tclip.encode_image(resumed["params"], T_TINY, torch.from_numpy(x))).float()
    torch.testing.assert_close(emb, want.detach(), rtol=0, atol=0)
    for extra in (["--shard-dir", tree["shards"], "--shuffle-buffer", "4"], ["--csv-path", tree["tsv"]]):
        out = pretrain_cli.main(["--preset", "tiny", "--pretrained", sd_path, "--epochs", "1", "--batch-size", "8",
                                 "--device", "cpu", "--output-root", str(tmp_path / extra[0][2:]), *extra])
        assert len(out["loss_history"]) == 1 and np.isfinite(out["loss_history"][0])


@pytest.mark.parametrize("argv,match", [
    (["--pp", "2"], "1 devices not divisible by tp*pp=2"),  # the pipe axis needs torchrun's ranks
    (["--fsdp", "--pp", "2"], "--fsdp does not compose with --pp"),  # the JAX CLI's refusal
    (["--sharded-snapshot", "--resume", "no_such_snapshot"], "not a readable sharded snapshot directory"),
])
def test_pretrain_cli_refuses_mesh_flags(argv, match, capsys):
    with pytest.raises((SystemExit, ValueError)) as err:
        pretrain_cli.main(["--preset", "tiny", "--device", "cpu", *argv])
    assert match in str(err.value) + capsys.readouterr().err


@pytest.mark.parametrize("argv,exc,match", [
    (["--distill-teacher", "t.pt", "--moe-experts", "2"], ValueError, "with MoE students is not wired"),
    (["--vpt-deep"], ValueError, "--vpt-deep requires --vpt-tokens"),
    (["--shard-dir", "a", "--csv-path", "b"], ValueError, "exclusive"),
    (["--distill-teacher", "t.pt", "--lora-rank", "2"], ValueError, "does not compose with --lora-rank"),
    (["--distill-teacher", "t.pt", "--loss", "siglip"], ValueError, "drop --loss siglip"),
    (["--bitfit", "--lora-rank", "2"], ValueError, "pick one"),
    (["--bitfit", "--lock-image-tower"], ValueError, "drop --lock-"),
    (["--lock-text-tower", "--lora-rank", "2"], ValueError, "composes oddly"),
    (["--lock-text-tower", "--lock-image-tower"], ValueError, "locking BOTH towers"),
    (["--patch-dropout", "0.5", "--lora-rank", "2"], ValueError, "full-tree pretraining step only"),
    (["--accum-full-negatives", "2", "--accum-steps", "2"], ValueError, "not with --accum-steps"),
    (["--accum-full-negatives", "2", "--lora-rank", "2"], ValueError, "full-tree pretraining step only"),
])
def test_pretrain_cli_refusals(tree, tmp_path, argv, exc, match):
    with pytest.raises(exc, match=match):
        pretrain_cli.main(["--preset", "tiny", "--data-root", tree["tree"], "--batch-size", "8", "--epochs", "1",
                           "--device", "cpu", "--output-root", str(tmp_path), *argv])
