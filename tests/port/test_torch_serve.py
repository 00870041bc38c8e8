"""The port's PredictService and HTTP server against the JAX package's.

A port ``PredictService`` on ``device="cpu"`` with the tiny config, fed the
bridged JAX weights and prompt state, serves the same probabilities,
attribution rows and text embeddings as the JAX ``PredictService`` on the
same inputs (1e-4).
The route option the port does not have yet ("saliency" in /explain)
answers HTTP 501.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tapclip_tpu.models.model_wrapper import FullModel as JFullModel
from tapclip_tpu.serve import PredictService as JPredictService
from tapclip_tpu.serve import decode_image_payload as j_decode

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch.models.model_wrapper import FullModel
from tapclip_tpu_torch.serve import (
    NotPortedError,
    PredictService,
    decode_image_payload,
    main,
    make_http_server,
)
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax, prompt_state_from_jax

CLASSES = ["Backpack", "Pen", "Monitor"]
TOL = 1e-4


def _pixels(seed, size, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    return rng.standard_normal((size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def pair(tiny_cfg, tiny_params):
    """(JAX model, port model) with the same weights and prompt state."""
    jm = JFullModel(CLASSES, tiny_params, tiny_cfg)
    tc = tcfg.TINY_TEST
    tm = FullModel(CLASSES, params_from_jax(jax.tree.map(np.asarray, tiny_params), tc), tc)
    tm.trainable, tm.prompt_learner.bank = prompt_state_from_jax(
        jax.tree.map(np.asarray, jm.trainable), jax.tree.map(np.asarray, jm.prompt_learner.bank)
    )
    return jm, tm


@pytest.fixture(scope="module")
def services(pair):
    jm, tm = pair
    jsvc = JPredictService(jm, batch_size=4, max_latency_ms=5.0)
    tsvc = PredictService(tm, batch_size=4, max_latency_ms=5.0)
    jsvc.predict(np.zeros((32, 32, 3), np.float32), timeout=300)  # JAX compiles here
    yield jsvc, tsvc
    jsvc.close()
    tsvc.close()


def _probs(result, names):
    return np.array([result["probs"][n] for n in names])


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "f32"])
def test_predict_probs_match_jax(services, dtype):
    jsvc, tsvc = services
    for seed in range(3):
        px = _pixels(seed, 32, dtype)
        want, got = jsvc.predict(px, timeout=300), tsvc.predict(px)
        assert got["class"] == want["class"] and got["index"] == want["index"]
        np.testing.assert_allclose(_probs(got, CLASSES), _probs(want, CLASSES), atol=TOL)
        assert abs(sum(got["probs"].values()) - 1.0) < 1e-4


def test_concurrent_predicts_batch_and_match(services):
    jsvc, tsvc = services
    results = {}

    def call(i):
        results[i] = tsvc.predict(_pixels(10 + i % 4, 32))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(results) == 8
    for i in range(4):
        assert results[i]["index"] == results[i + 4]["index"]
        want = jsvc.predict(_pixels(10 + i, 32), timeout=300)
        np.testing.assert_allclose(_probs(results[i], CLASSES), _probs(want, CLASSES), atol=TOL)
    assert tsvc.stats()["requests"] >= 8


def test_embed_matches_jax(services):
    jsvc, tsvc = services
    px = _pixels(5, 32)
    want, got = jsvc.embed(px, timeout=300), tsvc.embed(px)
    np.testing.assert_allclose(got["embedding"], want["embedding"], atol=TOL)


def test_explain_attribution_matches_jax(services):
    jsvc, tsvc = services
    px = _pixels(6, 32)
    want, got = jsvc.explain(px), tsvc.explain(px)
    assert got["class"] == want["class"]
    for n in CLASSES:
        np.testing.assert_allclose(got["attribution"][n], want["attribution"][n], atol=TOL)
    np.testing.assert_allclose(_probs(got, CLASSES), _probs(want, CLASSES), atol=TOL)
    with pytest.raises(NotPortedError, match="not yet ported in tapclip_tpu_torch"):
        tsvc.explain(px, saliency=True)


@pytest.mark.parametrize("texts", [["a photo of a Backpack.", "Mug", "a drawing of a Pen"], []],
                         ids=["3-texts-padded-to-4", "no-texts"])
def test_embed_text_matches_jax(pair, tiny_cfg, tiny_params, texts):
    """``embed_text`` (ids padded with id-0 rows to a power of two) against
    JAX's ``make_text_embed_fn`` on the same padded ids."""
    from tapclip_tpu.featurize import make_text_embed_fn

    _, tm = pair
    svc = PredictService(tm, batch_size=4, max_latency_ms=5.0)
    try:
        got = svc.embed_text(texts)["embeddings"]
    finally:
        svc.close()
    if not texts:
        assert got == []
        return
    ids = tm.tokenizer.tokenize(texts, tiny_cfg.context_length)
    ids = np.concatenate([ids, np.zeros((1, ids.shape[1]), ids.dtype)])
    want = np.asarray(make_text_embed_fn(tiny_cfg)(tiny_params, jax.numpy.asarray(ids)))[:3]
    assert np.asarray(got).shape == (3, tiny_cfg.embed_dim)
    np.testing.assert_allclose(np.asarray(got), want, atol=TOL)


def _request(url, obj=None):
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_http_round_trip_add_class_and_501(tiny_cfg, tiny_params):
    """Its own service (adding a class changes the model): HTTP on an
    ephemeral port, POST /classes then /predict covers the new class, and
    the routes not yet ported answer 501."""
    tc = tcfg.TINY_TEST
    tm = FullModel(CLASSES, params_from_jax(jax.tree.map(np.asarray, tiny_params), tc), tc)
    svc = PredictService(tm, batch_size=4, max_latency_ms=5.0)
    server = make_http_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        code, body = _request(base + "/health")
        assert code == 200 and json.loads(body)["classes"] == 3
        code, body = _request(base + "/classes", {"name": "Clipboards"})
        assert code == 200 and json.loads(body)["classes"] == CLASSES + ["Clipboards"]
        px = _pixels(7, 32).tolist()
        code, body = _request(base + "/predict", {"pixels": px})
        out = json.loads(body)
        assert code == 200 and set(out["probs"]) == set(CLASSES + ["Clipboards"])
        with torch.inference_mode():
            direct = tm(np.asarray(px, np.uint8)[None])["logits"][0].numpy()
        e = np.exp(direct - direct.max())
        np.testing.assert_allclose(_probs(out, CLASSES + ["Clipboards"]), e / e.sum(), atol=TOL)
        code, body = _request(base + "/explain", {"pixels": px})
        assert code == 200 and len(json.loads(body)["attribution"]["Clipboards"]) == 5
        code, body = _request(base + "/embed", {"pixels": px})
        assert code == 200 and len(json.loads(body)["embedding"]) == tc.embed_dim
        code, body = _request(base + "/embed_text", {"texts": ["a dog", "a cat"]})
        emb = np.asarray(json.loads(body)["embeddings"])
        assert code == 200 and emb.shape == (2, tc.embed_dim)
        np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-5)
        code, body = _request(base + "/explain", {"pixels": px, "saliency": True})
        assert code == 501
        assert "not yet ported in tapclip_tpu_torch" in json.loads(body)["error"]
        code, body = _request(base + "/reload", {"path": "x"})  # no such file
        assert code == 400 and "Error" in json.loads(body)["error"]
        code, body = _request(base + "/metrics")
        assert code == 200 and "tapclip_classes 4" in body
        code, _ = _request(base + "/nope", {})
        assert code == 404
        code, _ = _request(base + "/predict", {"pixels": [[1, 2]]})
        assert code == 400
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        thread.join(timeout=10)


def test_decode_image_payload_matches_jax():
    rng = np.random.default_rng(8)
    img = Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    b64 = {"image": base64.b64encode(buf.getvalue()).decode()}
    ints = {"pixels": rng.integers(0, 256, (32, 32, 3)).tolist()}
    floats = {"pixels": rng.random((32, 32, 3)).tolist()}
    for payload, dtype in ((b64, np.uint8), (ints, np.uint8), (floats, np.float32)):
        want = j_decode(payload, 32, keep_uint8=True)
        got = decode_image_payload(payload, 32)
        assert got.dtype == want.dtype == dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        decode_image_payload({}, 32)


def test_main_refuses_what_is_not_ported(capsys):
    for argv in (["--synthetic", "--dp", "2"], ["--dp"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
    assert "not yet ported in tapclip_tpu_torch" in capsys.readouterr().err


def test_main_device_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--preset", "tiny", "--synthetic", "--device", "cuda"])
