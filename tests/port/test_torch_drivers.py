"""The port's drivers against the JAX package's, from files to served answers.

Both packages run ``train``, ``test_cross_domain`` (with ``--ref-artifacts``)
and ``test_cross_domain2`` on one synthetic two-domain ImageFolder tree and
one open_clip state dict, exported by the JAX package from its tiny-config
parameters (``--pretrained``).  The port runs on ``--device cpu`` (its
kernels' plain versions).  They must write the same artifact tree (the
port's checkpoints are ``.pt`` files where the JAX package writes Orbax
directories) with the same schema and numbers, and read each other's
reference ``.pt`` to the same logits (LOGIT_TOL).  Then ``serve
--pretrained --ckpt`` answers over HTTP as a model built from the same
files, and ``POST /reload`` swaps the tower.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from tapclip_tpu import test_cross_domain as j_xd
from tapclip_tpu import test_cross_domain2 as j_xd2
from tapclip_tpu import train as j_train
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models.model_wrapper import FullModel as JFullModel
from tapclip_tpu.utils import checkpoint as jck
from tapclip_tpu.utils import torch_convert as jtc

from tapclip_tpu_torch import NotPortedError
from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import test_cross_domain as t_xd
from tapclip_tpu_torch import test_cross_domain2 as t_xd2
from tapclip_tpu_torch import train as t_train
from tapclip_tpu_torch.models.model_wrapper import FullModel
from tapclip_tpu_torch.serve import PredictService, build_model, make_http_server
from tapclip_tpu_torch.utils import checkpoint as tck
from tapclip_tpu_torch.utils import torch_convert as ttc

CLASSES = ["Backpack", "Alarm_Clock", "Laptop"]
DOMAINS = ["Real World", "Art"]
T_TINY = tcfg.TINY_TEST
LOGIT_TOL = 1e-3
PROB_TOL = 5e-4
TRAJ_TOL = dict(rtol=1e-4, atol=5e-6)


@pytest.fixture(scope="module")
def domain_tree(tmp_path_factory):
    """Two domains of class-colored 40 x 48 JPEGs (resized to 32 px), the
    three classes and an unseen one."""
    root = tmp_path_factory.mktemp("domains")
    rng = np.random.default_rng(0)
    for dom in DOMAINS:
        for ci, name in enumerate(CLASSES + ["Clipboards"]):
            d = root / dom / name
            d.mkdir(parents=True)
            base = np.zeros(3)
            base[ci % 3] = 180
            for i in range(8):
                arr = np.clip(base + rng.normal(0, 25, (40, 48, 3)), 0, 255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"{i}.jpg")
    return str(root)


def _state_dict(tmp_path_factory, seed, cfg=J_TINY):
    params = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(seed), cfg))
    path = tmp_path_factory.mktemp(f"sd{seed}") / "open_clip.bin"
    return jtc.save_openclip_checkpoint(params, cfg, str(path))


@pytest.fixture(scope="module")
def sd_path(tmp_path_factory):
    return _state_dict(tmp_path_factory, 0)


def _train_args(domain_tree, sd_path, out, *extra):
    return ["--preset", "tiny", "--data-root", os.path.join(domain_tree, "Real World"), "--classes", *CLASSES,
            "--epochs", "2", "--num-shots", "3", "--batch-size", "8", "--pretrained", sd_path,
            "--save-every", "1", "--output-root", str(out), *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory, domain_tree, sd_path):
    """(JAX train.main result, port train.main result) on the same files."""
    out = tmp_path_factory.mktemp("train")
    jres = j_train.main(_train_args(domain_tree, sd_path, out / "jax", "--confusion", "--calibrate"))
    tres = t_train.main(_train_args(domain_tree, sd_path, out / "port", "--confusion", "--calibrate",
                                    "--device", "cpu"))
    return jres, tres


def _tree(base):
    """Relative paths under ``base``: a JAX Orbax directory named
    ``step_*`` / ``best_model_*`` counts as one entry, as the port's file."""
    out = set()
    for dirpath, dirnames, filenames in os.walk(base):
        rel = os.path.relpath(dirpath, base)
        for d in list(dirnames):
            if d.startswith(("step_", "best_model_")):
                out.add(os.path.normpath(os.path.join(rel, d)))
                dirnames.remove(d)
        out.update(os.path.normpath(os.path.join(rel, f)) for f in filenames)
    return {p[:-3] if p.endswith(".pt") else p for p in out}


def test_train_writes_the_jax_artifact_tree(trained):
    jres, tres = trained
    assert jres["best_acc"] == tres["best_acc"]
    assert _tree(tres["paths"]["base"]) == _tree(jres["paths"]["base"])
    assert os.path.isfile(tres["ckpt"]) and tres["ckpt"].endswith(".pt")
    want = {"models/checkpoints/manager_index.json", "models/checkpoints/step_00000002",
            "models/checkpoints/step_00000004", "csv/history.json", "csv/calibration.json",
            "csv/main_confusion.csv", "logs/main_train.log", "plots/main_attribution.png",
            "plots/main_confusion.png", f"plots/main_acc_curve_acc{tres['best_acc']:.2f}.png",
            f"models/best_model_main_acc{tres['best_acc']:.2f}"}
    assert _tree(tres["paths"]["base"]) == want


def test_train_history_and_checkpoint_match_jax(trained):
    jres, tres = trained
    jh = json.load(open(os.path.join(jres["paths"]["csv_dir"], "history.json")))
    th = json.load(open(os.path.join(tres["paths"]["csv_dir"], "history.json")))
    assert sorted(th) == sorted(jh) == ["acc", "loss"]
    assert th["acc"] == jh["acc"] and len(th["loss"]) == 2
    np.testing.assert_allclose(th["loss"], jh["loss"], **TRAJ_TOL)
    jtree = jck.restore_prompt_checkpoint(jres["ckpt"])
    ttree = tck.restore_prompt_checkpoint(tres["ckpt"])
    assert sorted(ttree["meta"]) == sorted(jtree["meta"]) == ["best_acc", "class_names", "preset", "step"]
    assert ttree["meta"] == jtree["meta"]
    assert sorted(ttree["trainable"]) == sorted(jtree["trainable"])
    assert sorted(ttree["bank"]) == sorted(jtree["bank"])
    np.testing.assert_allclose(ttree["trainable"]["ctx"].numpy(), np.asarray(jtree["trainable"]["ctx"]), **TRAJ_TOL)
    assert len(ttree["opt_state"]) == 1 and float(ttree["opt_state"][0]["step"]) == ttree["meta"]["step"]
    # The tuned model separates this val set, so the NLL keeps falling as T
    # shrinks and the fitted T is where 50 Newton steps stop (the fit itself
    # is held against JAX's on overlapping classes in test_torch_io.py).
    jc = json.load(open(os.path.join(jres["paths"]["csv_dir"], "calibration.json")))
    tc = json.load(open(os.path.join(tres["paths"]["csv_dir"], "calibration.json")))
    assert sorted(tc) == sorted(jc) == ["ece_after", "ece_before", "n", "temperature"] and tc["n"] == jc["n"]
    assert tc["ece_before"] == pytest.approx(jc["ece_before"], rel=1e-3) and tc["temperature"] > 0
    cm = lambda res: open(os.path.join(res["paths"]["csv_dir"], "main_confusion.csv")).read()  # noqa: E731
    assert cm(tres) == cm(jres)
    index = json.load(open(os.path.join(tres["paths"]["model_dir"], "checkpoints", "manager_index.json")))
    assert [r["step"] for r in index] == [2, 4]


def test_train_resume_two_plus_two_equals_four(tmp_path, domain_tree, sd_path):
    """``--resume`` from the epoch-2 snapshot, 2 more epochs, equals 4
    uninterrupted epochs (the shuffle continues)."""
    base = ["--device", "cpu", "--patience", "10"]
    full = t_train.main(_train_args(domain_tree, sd_path, tmp_path / "full", *base, "--epochs", "4"))
    first = t_train.main(_train_args(domain_tree, sd_path, tmp_path / "first", *base))
    snap = os.path.join(first["paths"]["model_dir"], "checkpoints", "step_00000004.pt")
    assert tck.restore_prompt_checkpoint(snap)["meta"]["epoch"] == 2
    second = t_train.main(_train_args(domain_tree, sd_path, tmp_path / "second", *base, "--resume", snap))
    loss = first["result"].loss_history + second["result"].loss_history
    np.testing.assert_allclose(loss, full["result"].loss_history, **TRAJ_TOL)
    assert first["result"].acc_history + second["result"].acc_history == full["result"].acc_history
    assert second["result"].final_state.step == full["result"].final_state.step == 8


def test_train_uint8_transfer_equals_the_float_pipeline(tmp_path, trained, domain_tree, sd_path):
    """uint8 pixels normalized on the device: the same losses as the host's
    float pipeline (the loaders take the native path where it builds)."""
    _, tres = trained
    out = t_train.main(_train_args(domain_tree, sd_path, tmp_path, "--device", "cpu", "--uint8-transfer"))
    assert tres["decoder"] == "pil" and out["decoder"] in ("native", "pil")
    np.testing.assert_allclose(out["result"].loss_history, tres["result"].loss_history, rtol=1e-6, atol=0)
    assert out["result"].acc_history == tres["result"].acc_history


def test_train_zero_shot_synthetic_and_refusals(tmp_path):
    out = t_train.main(["--preset", "tiny", "--device", "cpu", "--synthetic-data", "--num-shots", "0",
                        "--output-root", str(tmp_path)])
    assert 0.0 <= out["best_acc"] <= 100.0 and "ckpt" not in out
    with pytest.raises(NotPortedError, match="--kg-lambda > 0"):
        t_train.main(["--preset", "tiny", "--device", "cpu", "--kg-lambda", "0.5"])
    with pytest.raises(ValueError, match="Orbax"):
        t_train.main(["--preset", "tiny", "--device", "cpu", "--synthetic-data", "--pretrained", str(tmp_path),
                      "--output-root", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_train.main(["--preset", "tiny", "--synthetic-data", "--output-root", str(tmp_path)])


@pytest.fixture(scope="module")
def ref_pt(trained, tmp_path_factory):
    """The JAX run's best prompts as a reference .pt (the interchange format)."""
    jres, _ = trained
    tree = jck.restore_prompt_checkpoint(jres["ckpt"])
    path = tmp_path_factory.mktemp("ref") / "best_model_epoch2_acc0.pt"
    return jtc.save_reference_prompt_checkpoint(np.asarray(tree["trainable"]["ctx"]), tree["meta"]["class_names"],
                                                str(path), logit_scale=np.asarray(tree["trainable"]["logit_scale"]))


def _xd_args(domain_tree, sd_path, ckpt, out, *extra):
    return ["--preset", "tiny", "--checkpoint", ckpt, "--domain-root", domain_tree, "--domains", *DOMAINS,
            "--shots", "0", "3", "--batch-size", "8", "--pretrained", sd_path, "--output-root", str(out), *extra]


def test_cross_domain_ref_artifacts_match_jax(tmp_path, domain_tree, sd_path, ref_pt):
    extra = ["--seen-classes", *CLASSES, "--unseen-classes", "Clipboards", "--ref-artifacts"]
    jout = j_xd.main(_xd_args(domain_tree, sd_path, ref_pt, tmp_path / "j", *extra,
                              "--artifact-root", str(tmp_path / "j")))
    tout = t_xd.main(_xd_args(domain_tree, sd_path, ref_pt, tmp_path / "t", *extra,
                              "--artifact-root", str(tmp_path / "t"), "--device", "cpu"))
    assert tout["results"] == jout["results"] and len(tout["results"]) == 4
    assert os.path.relpath(tout["csv"], tmp_path / "t") == os.path.relpath(jout["csv"], tmp_path / "j")
    assert os.path.relpath(tout["plot"], tmp_path / "t") == os.path.relpath(jout["plot"], tmp_path / "j")
    assert os.path.basename(tout["csv"]).startswith("cross_domain_results_2_")  # epochs from the file name
    assert "visible results" in tout["csv"] and os.path.isfile(tout["plot"])
    df = pd.read_csv(tout["csv"])
    assert list(df.columns) == ["Domain", "Shots", "Accuracy"]
    pd.testing.assert_frame_equal(df, pd.read_csv(jout["csv"]))


def test_cross_domain_default_artifacts(tmp_path, domain_tree, sd_path, ref_pt):
    out = t_xd.main(_xd_args(domain_tree, sd_path, ref_pt, tmp_path, "--seen-classes", *CLASSES, "--device", "cpu"))
    assert out["csv"].endswith(os.path.join("csv", "cross_domain_results.csv"))
    assert out["plot"].endswith(os.path.join("plots", "cross_domain_accuracy_bar.png"))
    assert os.path.isfile(out["plot"]) and os.path.isfile(os.path.join(out["paths"]["log_dir"], "cross_domain.log"))
    assert set(pd.read_csv(out["csv"])["Shots"]) == {"Zero-Shot", "3-shot"}


def test_cross_domain2_matches_jax(tmp_path, domain_tree, sd_path, ref_pt):
    """Per-domain fine-tuning from the same reference .pt, with the unseen
    class joining the bank: the same grid as the JAX package's."""
    extra = ["--seen-classes", *CLASSES, "Clipboards", "--ft-steps", "2"]
    jout = j_xd2.main(_xd_args(domain_tree, sd_path, ref_pt, tmp_path / "j", *extra))
    tout = t_xd2.main(_xd_args(domain_tree, sd_path, ref_pt, tmp_path / "t", *extra, "--device", "cpu"))
    assert len(tout["results"]) == 4
    assert [(r["Domain"], r["Shots"]) for r in tout["results"]] == [(r["Domain"], r["Shots"]) for r in jout["results"]]
    np.testing.assert_allclose([r["Accuracy"] for r in tout["results"]], [r["Accuracy"] for r in jout["results"]],
                               atol=1e-9)
    assert os.path.relpath(tout["csv"], tout["paths"]["base"]) == os.path.join("csv", "cross_domain_results.csv")
    assert os.path.basename(tout["plot"]) == os.path.basename(jout["plot"]) == "cross_domain_bar_main.png"
    assert os.path.isfile(tout["plot"])


def _images(seed, n=6):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def test_driver_checkpoints_cross_between_packages(tmp_path, trained, sd_path):
    """Each run's best prompts, as a reference .pt, loaded by the other
    package on the same weights: the same ctx bit for bit, the same logits."""
    jres, tres = trained
    ttree = tck.restore_prompt_checkpoint(tres["ckpt"])
    port_ref = ttc.save_reference_prompt_checkpoint(ttree["trainable"]["ctx"], CLASSES, str(tmp_path / "p.pt"),
                                                    logit_scale=ttree["trainable"]["logit_scale"])
    jtree = jck.restore_prompt_checkpoint(jres["ckpt"])
    jax_ref = jtc.save_reference_prompt_checkpoint(np.asarray(jtree["trainable"]["ctx"]), CLASSES,
                                                   str(tmp_path / "j.pt"))
    jparams = jtc.load_openclip_checkpoint(sd_path, J_TINY)
    x = _images(1)
    for path, ctx in ((port_ref, ttree["trainable"]["ctx"].numpy()), (jax_ref, np.asarray(jtree["trainable"]["ctx"]))):
        tm = build_model(T_TINY, CLASSES, "cpu", pretrained=sd_path, ckpt=path)
        jm = JFullModel(CLASSES, jax.tree.map(jnp.asarray, jparams), J_TINY)
        jck.apply_prompt_checkpoint(jm, path)
        np.testing.assert_array_equal(tm.trainable["ctx"][:3].numpy(), ctx[:3])
        np.testing.assert_array_equal(np.asarray(jm.trainable["ctx"])[:3], ctx[:3])
        with torch.inference_mode():
            got = tm(x)["logits"].numpy()
        want = np.asarray(jm(jnp.asarray(x))["logits"])
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# --- serving from files ---------------------------------------------------------------


def _request(url, obj=None):
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _direct(model, px):
    """Logits and softmax of a model called in memory on one image."""
    with torch.inference_mode():
        logits = model(px[None])["logits"][0].numpy()
    e = np.exp(logits - logits.max())
    return logits, e / e.sum()


def _served_probs(out, names):
    return np.array([out["probs"][n] for n in names])


@pytest.fixture(scope="module")
def sd2_path(tmp_path_factory):
    return _state_dict(tmp_path_factory, 1)


def test_serve_pretrained_ckpt_and_reload_over_http(tmp_path_factory, trained, sd_path, sd2_path):
    """The service and server ``main`` builds, from --pretrained and --ckpt:
    /predict equals a FullModel built in memory from the same files; POST
    /reload swaps in the second state dict and equals a fresh model built
    from it; a reload of mismatched shapes or of a directory answers 400 and
    changes nothing."""
    _, tres = trained
    ckpt = tres["ckpt"]
    served = build_model(T_TINY, CLASSES, "cpu", pretrained=sd_path, ckpt=ckpt)
    ref = FullModel(CLASSES, ttc.load_openclip_checkpoint(sd_path, T_TINY), T_TINY)
    tck.apply_prompt_checkpoint(ref, ckpt)
    svc = PredictService(served, batch_size=4, max_latency_ms=5.0)
    server = make_http_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    images = _images(2, 4)

    def check(model):
        for px in images:
            code, out = _request(base + "/predict", {"pixels": px.tolist()})
            assert code == 200
            logits, probs = _direct(model, px)
            np.testing.assert_allclose(_served_probs(out, CLASSES), probs, atol=PROB_TOL)
            assert out["index"] == int(logits.argmax())
        code, out = _request(base + "/explain", {"pixels": images[0].tolist()})
        assert code == 200 and out["index"] == int(_direct(model, images[0])[0].argmax())

    try:
        code, health = _request(base + "/health")
        assert code == 200 and health["classes"] == 3
        check(ref)
        bad = _state_dict(tmp_path_factory, 2, J_TINY.replace(embed_dim=16))
        before = [_request(base + "/predict", {"pixels": px.tolist()})[1] for px in images]
        for path, match in ((bad, "leaf shape mismatches"), (str(tmp_path_factory.getbasetemp()), "directory")):
            code, out = _request(base + "/reload", {"path": path})
            assert code == 400 and match in out["error"]
            assert [_request(base + "/predict", {"pixels": px.tolist()})[1] for px in images] == before
        code, out = _request(base + "/reload", {"path": sd2_path})
        assert code == 200 and out == {"reloaded": True, "classes": CLASSES}
        check(build_model(T_TINY, CLASSES, "cpu", pretrained=sd2_path, ckpt=ckpt))
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        thread.join(timeout=10)


def test_reload_while_requests_are_in_flight(trained, sd_path, sd2_path):
    """Every answer served around a reload is the old model's or the new
    one's, never old text features paired with the new tower."""
    _, tres = trained
    old = build_model(T_TINY, CLASSES, "cpu", pretrained=sd_path, ckpt=tres["ckpt"])
    new = build_model(T_TINY, CLASSES, "cpu", pretrained=sd2_path, ckpt=tres["ckpt"])
    svc = PredictService(build_model(T_TINY, CLASSES, "cpu", pretrained=sd_path, ckpt=tres["ckpt"]),
                         batch_size=4, max_latency_ms=2.0)
    images = _images(3, 8)
    want = [(_direct(old, px)[1], _direct(new, px)[1]) for px in images]
    answers, errors = [], []

    def client(i):
        try:
            for _ in range(6):
                answers.append((i, _served_probs(svc.predict(images[i]), CLASSES)))
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(images))]
    try:
        for t in threads:
            t.start()
        time.sleep(0.05)
        svc.reload_weights(sd2_path)
        for t in threads:
            t.join(timeout=120)
        after = [_served_probs(svc.predict(px), CLASSES) for px in images]
    finally:
        svc.close()
    assert not errors and len(answers) == 6 * len(images)
    for i, probs in answers:
        assert any(np.abs(probs - w).max() <= PROB_TOL for w in want[i]), i
    for probs, (_, w_new) in zip(after, want):
        np.testing.assert_allclose(probs, w_new, atol=PROB_TOL)


def test_serve_main_subprocess_pretrained_ckpt(trained, sd_path):
    """``python -m tapclip_tpu_torch.serve --pretrained --ckpt`` on the CPU,
    over HTTP, answers as a model built from the same files."""
    _, tres = trained
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tapclip_tpu_torch.serve", "--preset", "tiny", "--device", "cpu",
         "--pretrained", sd_path, "--ckpt", tres["ckpt"], "--classes", *CLASSES, "--port", str(port)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, env=env)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                code, health = _request(base + "/health")
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
                assert time.monotonic() < deadline, "server did not start"
                time.sleep(0.2)
        assert code == 200 and health["classes"] == 3
        px = _images(4, 1)[0]
        code, out = _request(base + "/predict", {"pixels": px.tolist()})
        assert code == 200
        model = build_model(T_TINY, CLASSES, "cpu", pretrained=sd_path, ckpt=tres["ckpt"])
        np.testing.assert_allclose(_served_probs(out, CLASSES), _direct(model, px)[1], atol=PROB_TOL)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
