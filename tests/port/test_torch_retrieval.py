"""The index path against the JAX package: shards, ``featurize``, ``search``,
and the text tower's other offline reader, ``zero_shot_eval``.

Both packages' ``main`` run on one synthetic ImageFolder tree (class-colored
JPEGs and one byte-for-byte duplicate), one tar-shard corpus with captions
and one open_clip state dict exported by the JAX package from its tiny-config
weights.  The port runs on ``--device cpu`` (its kernels' plain versions).
``featurize`` stores float16 rows, so embeddings are held within EMB_TOL;
``search`` runs both packages on the JAX package's index files, so the
scores are the same f32 sums of the same bf16 terms (SCORE_TOL).
"""

import csv
import io
import os
import shutil
import tarfile

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from tapclip_tpu import featurize as j_feat
from tapclip_tpu import search as j_search
from tapclip_tpu import zero_shot_eval as j_zse
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.data import shards as j_shards
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.utils import torch_convert as jtc

from tapclip_tpu_torch import featurize as t_feat
from tapclip_tpu_torch import search as t_search
from tapclip_tpu_torch import zero_shot_eval as t_zse
from tapclip_tpu_torch.data import shards as t_shards

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

CLASSES = ["Backpack", "Alarm_Clock", "Laptop"]
DOMAINS = ["Real World", "Art"]
EMB_TOL = 2e-3  # float16 storage of unit-norm rows
SCORE_TOL = 1e-5
TIE = 1e-6
TINY = ["--preset", "tiny"]


def _jpeg(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two domains of class-colored 40 x 48 JPEGs (the first, 3 classes x 5
    + a copy of one, is the tree featurize indexes), the shard dir (11
    captioned JPEGs in shards of 4) and the state dict."""
    root = tmp_path_factory.mktemp("retrieval")
    rng = np.random.default_rng(0)
    for dom, n in ((DOMAINS[0], 5), (DOMAINS[1], 3)):
        for ci, name in enumerate(CLASSES):
            d = root / "domains" / dom / name
            d.mkdir(parents=True)
            base = np.zeros(3)
            base[ci] = 180
            for i in range(n):
                Image.fromarray(np.clip(base + rng.normal(0, 40, (40, 48, 3)), 0, 255).astype(np.uint8)).save(
                    d / f"{i}.jpg")
    tree = root / "domains" / DOMAINS[0]
    shutil.copy(tree / CLASSES[0] / "0.jpg", tree / CLASSES[0] / "9_copy.jpg")
    samples = [(_jpeg(rng.integers(0, 256, (36 + i, 44, 3), dtype=np.uint8)), f"caption {i} of a {CLASSES[i % 3]}")
               for i in range(11)]
    shard_dir = root / "shards"
    j_shards.write_shards(samples, str(shard_dir), shard_size=4)
    params = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY))
    sd = jtc.save_openclip_checkpoint(params, J_TINY, str(root / "open_clip.bin"))
    return {"root": root, "tree": str(tree), "domains": str(root / "domains"), "shards": str(shard_dir), "sd": sd,
            "samples": samples}


def _featurize(files, out, *extra, port=True):
    src = ["--image-root", files["tree"]] if "--shard-dir" not in extra else []
    argv = [*src, "--out", str(out), *TINY, "--pretrained", files["sd"], "--batch-size", "4", *extra]
    if port:
        return t_feat.main(argv + ["--device", "cpu"])
    return j_feat.main(argv)


@pytest.fixture(scope="module")
def featurized(files):
    """JAX's and the port's featurize outputs: the tree, the shards with
    --embed-text."""
    root = files["root"]
    out = {}
    for kind, extra in (("tree", ()), ("shards", ("--shard-dir", files["shards"], "--embed-text"))):
        for pkg in ("jax", "port"):
            d = root / f"{pkg}_{kind}"
            out[pkg, kind] = (str(d), _featurize(files, d, *extra, port=pkg == "port"))
    return out


def _manifest(d):
    with open(os.path.join(d, "manifest.csv")) as f:
        return list(csv.reader(f))


# --- shards ---------------------------------------------------------------------------------


def test_shard_helpers_match_jax(files, tmp_path):
    shards = t_shards.list_shards(files["shards"])
    assert shards == j_shards.list_shards(files["shards"]) and len(shards) == 3
    assert t_shards.count_samples(shards) == j_shards.count_samples(shards) == 11
    got = [s for p in shards for s in t_shards._iter_shard(p)]
    assert got == [s for p in shards for s in j_shards._iter_shard(p)] == files["samples"]
    # The port's writer writes the JAX package's tars, member for member.
    t_paths = t_shards.write_shards(files["samples"], str(tmp_path / "t"), shard_size=4)
    for tp, jp in zip(t_paths, shards):
        assert os.path.basename(tp) == os.path.basename(jp)
        with tarfile.open(tp) as a, tarfile.open(jp) as b:
            assert [(m.name, m.size) for m in a] == [(m.name, m.size) for m in b]
    # An unpaired member is dropped by the stream and by the count.
    with tarfile.open(tmp_path / "t" / "shard-000009.tar", "w") as tf:
        info = tarfile.TarInfo("lonely.jpg")
        info.size = 3
        tf.addfile(info, io.BytesIO(b"abc"))
    assert t_shards.count_samples(t_shards.list_shards(str(tmp_path / "t"))) == 11
    assert list(t_shards._iter_shard(str(tmp_path / "t" / "shard-000009.tar"))) == []
    with pytest.raises(FileNotFoundError):
        t_shards.list_shards(str(tmp_path))


# --- featurize --------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["tree", "shards"])
def test_featurize_matches_jax(featurized, kind):
    (jd, jres), (td, tres) = featurized["jax", kind], featurized["port", kind]
    assert tres == jres
    assert _manifest(td) == _manifest(jd)
    names = ["image_embeddings.npy"] + (["text_embeddings.npy"] if kind == "shards" else [])
    for name in names:
        got, want = np.load(os.path.join(td, name)), np.load(os.path.join(jd, name))
        assert got.dtype == np.float16 and got.shape == want.shape
        np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=EMB_TOL, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(got.astype(np.float32), axis=-1), 1.0, atol=EMB_TOL)
    if kind == "shards":
        assert _manifest(td)[1] == ["0", "caption 0 of a Backpack"] and tres["n_text"] == 11


@pytest.mark.parametrize("kind", ["tree", "shards"])
def test_featurize_ranks_concatenate_to_the_world_one_corpus(files, featurized, tmp_path, kind):
    td = featurized["port", kind][0]
    extra = ("--shard-dir", files["shards"], "--embed-text") if kind == "shards" else ()
    parts = [tmp_path / f"rank{r}" for r in range(2)]
    for r, d in enumerate(parts):
        _featurize(files, d, *extra, "--rank", str(r), "--world", "2")
    whole = _manifest(td)
    rows = [row[1:] for d in parts for row in _manifest(d)[1:]]
    assert rows == [row[1:] for row in whole[1:]] and all(len(_manifest(d)) > 1 for d in parts)
    for name in ["image_embeddings.npy"] + (["text_embeddings.npy"] if kind == "shards" else []):
        got = np.concatenate([np.load(os.path.join(d, name)) for d in parts])
        np.testing.assert_allclose(got.astype(np.float32), np.load(os.path.join(td, name)).astype(np.float32),
                                   atol=1e-3, rtol=0)


def test_featurize_uint8_transfer_equals_the_float_pipeline(files, featurized, tmp_path):
    td = featurized["port", "tree"][0]
    _featurize(files, tmp_path, "--no-uint8-transfer")
    np.testing.assert_array_equal(np.load(tmp_path / "image_embeddings.npy"),
                                  np.load(os.path.join(td, "image_embeddings.npy")))


@pytest.mark.parametrize("kind", ["tree", "shards"])
def test_featurize_dp_matches_one_device_and_jax(files, featurized, tmp_path, kind):
    """``featurize --dp 2`` over two CPU replicas: each batch splits in two
    and the rows come back in order, equal to ``--dp 1``'s (the halves run
    their products at half the rows: summation order only) and to the JAX
    package's ``--dp 2`` on its virtual mesh, at the float16 files' EMB_TOL."""
    extra = ("--shard-dir", files["shards"], "--embed-text") if kind == "shards" else ()
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    _featurize(files, port, *extra, "--dp", "2")
    _featurize(files, jax_dir, *extra, "--dp", "2", port=False)
    td = featurized["port", kind][0]
    assert _manifest(port) == _manifest(td)
    for name in ["image_embeddings.npy"] + (["text_embeddings.npy"] if kind == "shards" else []):
        got = np.load(port / name).astype(np.float32)
        np.testing.assert_allclose(got, np.load(os.path.join(td, name)).astype(np.float32), atol=1e-3, rtol=0)
        np.testing.assert_allclose(got, np.load(jax_dir / name).astype(np.float32), atol=EMB_TOL, rtol=0)


def test_featurize_refusals(files, tmp_path):
    with pytest.raises(SystemExit, match="--batch-size must divide by --dp"):
        _featurize(files, tmp_path, "--dp", "3")
    with pytest.raises(SystemExit, match="--embed-text requires --shard-dir"):
        _featurize(files, tmp_path, "--embed-text")
    with pytest.raises(SystemExit, match="bad --rank"):
        _featurize(files, tmp_path, "--rank", "2", "--world", "2")
    with pytest.raises(ValueError, match="Orbax"):
        t_feat.main(["--image-root", files["tree"], "--out", str(tmp_path), *TINY, "--pretrained", str(tmp_path),
                     "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_feat.main(["--image-root", files["tree"], "--out", str(tmp_path), *TINY])


# --- search -----------------------------------------------------------------------------------


def _same_ranking(got_scores, got_rows, want_scores, want_rows):
    """Scores within SCORE_TOL; rows equal wherever the score is not tied
    with a neighbour within TIE."""
    np.testing.assert_allclose(got_scores, want_scores, atol=SCORE_TOL, rtol=0)
    for gs, gr, ws, wr in zip(got_scores, got_rows, want_scores, want_rows):
        for j in range(len(ws)):
            tied = any(abs(ws[j] - ws[i]) <= TIE for i in range(len(ws)) if i != j)
            if not tied:
                assert gr[j] == wr[j], (j, gr, wr)


@pytest.mark.parametrize("corpus", ["image", "text"])
def test_search_index_matches_jax(featurized, corpus):
    d = featurized["jax", "shards"][0]
    jidx = j_search.SearchIndex.load(d, text=corpus == "text")
    tidx = t_search.SearchIndex.load(d, text=corpus == "text", device="cpu")
    assert tidx.n == jidx.n == 11 and tidx._index.dtype == torch.bfloat16
    q = np.random.default_rng(1).standard_normal((3, tidx.dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    for k in (4, 50):  # 50 is clamped to the corpus
        got, want = tidx.search(q, k=k), jidx.search(q, k=k)
        assert got[0].dtype == np.float32 and got[0].shape == (3, min(k, 11))
        _same_ranking(got[0], got[1], *want)
    assert tidx.manifest == jidx.manifest


def test_search_main_matches_jax(files, featurized, tmp_path):
    d = featurized["jax", "tree"][0]
    model = [*TINY, "--pretrained", files["sd"]]
    for query in (["--row", "3"], ["--text", "a photo of a Laptop"], ["--image", os.path.join(files["tree"],
                                                                                               "Laptop", "2.jpg")]):
        want = j_search.main(["--index", d, *query, "-k", "6", *model])
        got = t_search.main(["--index", d, *query, "-k", "6", *model, "--device", "cpu"])
        _same_ranking(np.array([[r["score"] for r in got]]), np.array([[r["row"] for r in got]]),
                      np.array([[r["score"] for r in want]]), np.array([[r["row"] for r in want]]))
    assert got[0]["meta"][1].endswith("2.jpg")  # an image's own file is its top match
    row = t_search.main(["--index", d, "--row", "3", "-k", "1", "--device", "cpu"])
    assert row[0]["row"] == 3  # a row's own row is its top match
    # Two index dirs concatenate; --row counts across them.
    both = t_search.main(["--index", d, d, "--row", "17", "-k", "2", "--device", "cpu"])
    assert {r["row"] for r in both} == {1, 17}
    with pytest.raises(SystemExit, match="exactly one"):
        t_search.main(["--index", d, "--row", "1", "--text", "x", "--device", "cpu"])
    with pytest.raises(SystemExit, match="out of range"):
        t_search.main(["--index", d, "--row", "99", "--device", "cpu"])


def test_search_dedup_matches_jax(featurized, tmp_path):
    """The copied file pairs with its original; chunked scoring with a
    full-size tail window finds the JAX package's pair set."""
    d = featurized["jax", "tree"][0]
    want = j_search.main(["--index", d, "--dedup", "0.99"])
    got = t_search.main(["--index", d, "--dedup", "0.99", "--dedup-out", str(tmp_path / "pairs.csv"),
                         "--device", "cpu"])
    assert {(r["row_a"], r["row_b"]) for r in got} == {(r["row_a"], r["row_b"]) for r in want}
    copy = [r for r in got if r["path_b"].endswith("9_copy.jpg") and r["path_a"].endswith("0.jpg")]
    assert copy and copy[0]["score"] >= 0.99
    assert [r["score"] for r in got] == sorted((r["score"] for r in got), reverse=True)
    with open(tmp_path / "pairs.csv") as f:
        assert len(list(csv.DictReader(f))) == len(got)
    tidx = t_search.SearchIndex.load(d, device="cpu")
    jidx = j_search.SearchIndex.load(d)
    for thr in (0.9, 0.5):  # chunks of 5 over 16 rows: the tail window (rows 11-15) overlaps the one before
        got = tidx.find_duplicates(thr, chunk=5)
        want = jidx.find_duplicates(thr, chunk=5)
        assert {(i, j) for i, j, _ in got} == {(i, j) for i, j, _ in want}
        np.testing.assert_allclose(sorted(s for *_, s in got), sorted(s for *_, s in want), atol=SCORE_TOL)
        assert all(i < j for i, j, _ in got) and len(set(got)) == len(got)


# --- zero_shot_eval -----------------------------------------------------------------------


def test_zero_shot_eval_matches_jax(files, tmp_path):
    argv = ["--preset", "tiny", "--pretrained", files["sd"], "--classes", *CLASSES, "--domain-root", files["domains"],
            "--domains", *DOMAINS, "--ensemble"]
    want = j_zse.main(argv + ["--output-root", str(tmp_path / "j")])
    args, cfg = t_zse.parse(argv + ["--output-root", str(tmp_path / "t"), "--device", "cpu"])
    got = t_zse.write_plot(t_zse.run(args, cfg))
    assert got["results"] == want["results"] and len(got["results"]) == 2
    for out in (got, want):  # <root>/main_zeroshot_<time>/csv/zero_shot_results.csv
        run_dir, rel = os.path.relpath(out["csv"], tmp_path).split(os.sep, 2)[1:]
        assert run_dir.startswith("main_zeroshot_") and rel == os.path.join("csv", "zero_shot_results.csv")
    pd.testing.assert_frame_equal(pd.read_csv(got["csv"]), pd.read_csv(want["csv"]))
    assert os.path.isfile(got["plot"])
