"""Batched inference serving for a (prompt-tuned) TAP-CLIP model, on PyTorch.

Counterpart of ``tapclip_tpu/serve.py``: a threaded HTTP server with dynamic
micro-batching in front of one predict function.

* **Fixed batch.**  Requests are aggregated into a ``[B, H, W, 3]`` batch
  (padded); uint8 batches cross to the device as bytes and are normalized
  there.
* **Dynamic micro-batching.**  A collector thread drains the request queue:
  a batch launches when ``batch_size`` requests are waiting or the oldest
  has waited ``max_latency_ms``.
* **Text features are cached.**  The text side (the attribution pass and the
  encode pass) runs once per vocabulary change; then serving cost is the
  image tower + one logits GEMM.
* **Classes can be added live** (``POST /classes``): the class axis is padded.

Every model call runs under ``torch.inference_mode()``, entered on the
thread that runs it (grad mode is thread-local, and batches run on the
collector thread).

Endpoints (JSON):
  GET  /health, /metrics, /classes
  POST /classes   {"name": "Clipboards"} -> {"classes": [...]}
  POST /predict   {"image": <base64 jpeg/png>} or {"pixels": [[...]]}
                  -> {"class": str, "index": int, "probs": {name: p}}
  POST /explain   same payload -> prediction + per-class attribution rows
  POST /embed     same payload -> {"embedding": [E floats]}
  POST /embed_text {"texts": [str, ...]} -> {"embeddings": [[E floats], ...]}
Not yet ported (HTTP 501): /reload, "saliency" in /explain.

Run: ``python -m tapclip_tpu_torch.serve --model ViT-B-16 --synthetic``
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

log = logging.getLogger("tapclip_torch.serve")

NOT_PORTED = "not yet ported in tapclip_tpu_torch"


class NotPortedError(NotImplementedError):
    """A route or option of the JAX server that the port does not have yet."""

    def __init__(self, what: str):
        super().__init__(f"{what}: {NOT_PORTED}")


class PredictService:
    """Micro-batching front end over the model's image tower + cached text side."""

    def __init__(self, model, *, batch_size: int = 8, max_latency_ms: float = 10.0,
                 temperature: float = 1.0):
        self.model = model
        self.batch_size = batch_size
        self.max_latency_ms = max_latency_ms
        if temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        self.temperature = float(temperature)
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()  # model mutation (add_class) vs predict
        self._text_cache = None
        self._n_requests = 0
        self._n_batches = 0
        self._batch_ms_total = 0.0
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._collector, daemon=True, name="predict-batcher")
        self._worker.start()

    # -- public ---------------------------------------------------------

    def predict(self, pixels: np.ndarray, timeout: float = 30.0) -> Dict[str, Any]:
        """Enqueue one [H, W, 3] image; blocks until its batch returns."""
        return self._enqueue(pixels, "predict", timeout)

    def embed(self, pixels: np.ndarray, timeout: float = 30.0) -> Dict[str, Any]:
        """L2-normalized image embedding; rides the same batches as predict."""
        return self._enqueue(pixels, "embed", timeout)

    def _enqueue(self, pixels: np.ndarray, kind: str, timeout: float) -> Dict[str, Any]:
        done = threading.Event()
        slot: Dict[str, Any] = {}
        self._queue.put((pixels, slot, done, kind))
        if not done.wait(timeout):
            raise TimeoutError(f"{kind} timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["result"]

    def embed_text(self, texts: List[str]) -> Dict[str, Any]:
        """L2-normalized CLIP text embeddings (the proper text encoder) for a
        list of strings, the text half of a retrieval index.  The batch is
        padded with id-0 rows to the next power of two, as the JAX server
        pads to bound its executables."""
        from tapclip_tpu_torch.featurize import make_text_embed_fn

        if not texts:
            return {"embeddings": []}
        m = self.model
        ids = np.asarray(m.tokenizer.tokenize(list(texts), m.clip_cfg.context_length))
        n = len(texts)
        n_pad = 1 << (n - 1).bit_length()  # next power of two
        if n_pad != n:
            ids = np.concatenate([ids, np.zeros((n_pad - n, ids.shape[1]), ids.dtype)])
        with self._lock:  # the offline featurizer's function: the same embeddings
            feats = make_text_embed_fn(m.clip_cfg)(m.clip_params, ids)
            feats = feats[:n].float().cpu().numpy()
        return {"embeddings": [[round(float(v), 6) for v in row] for row in feats]}

    def reload_weights(self, source) -> Dict[str, Any]:
        raise NotPortedError("/reload")

    def explain(self, pixels: np.ndarray, saliency=None) -> Dict[str, Any]:
        """Prediction + context-token attribution for one image (not batched)."""
        if saliency:
            raise NotPortedError("saliency")
        px = pixels[None] if pixels.dtype == np.uint8 else pixels[None].astype(np.float32)
        with self._lock, torch.inference_mode():
            out = self.model(px)
            names = list(self.model.class_names)
            logits = out["logits"].float().cpu().numpy()[0]
            attr = out["attribution"].float().cpu().numpy()
        probs = _softmax(logits[None] / self.temperature)[0]
        pred = int(logits.argmax())
        return {
            "index": pred,
            "class": names[pred],
            "probs": {n: round(float(probs[j]), 6) for j, n in enumerate(names)},
            "attribution": {n: [round(float(v), 6) for v in attr[j]] for j, n in enumerate(names)},
        }

    def add_class(self, name: str) -> List[str]:
        with self._lock:  # a buffer write into the padded bank; no tower call
            self.model.add_class_prompt(name)
            self._text_cache = None  # prompts changed -> recompute the text side
        return list(self.model.class_names)

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)

    def stats(self) -> Dict[str, Any]:
        n_b = max(self._n_batches, 1)
        return {
            "requests": self._n_requests,
            "batches": self._n_batches,
            "mean_batch_fill": round(self._n_requests / n_b, 2),
            "mean_batch_ms": round(self._batch_ms_total / n_b, 2),
        }

    # -- internals ------------------------------------------------------

    def _collector(self):
        poll_s = self.max_latency_ms / 1000.0 / 4
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_latency_ms / 1000.0
            while len(batch) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=min(remaining, poll_s)))
                except queue.Empty:
                    continue
            self._run_batch(batch)

    def _cached_text_feats(self) -> torch.Tensor:
        """[C_max, E] L2-normalized text features, recomputed per vocabulary change."""
        if self._text_cache is None:
            from tapclip_tpu_torch.models.model_wrapper import text_features_with_attribution

            m = self.model
            feats, _ = text_features_with_attribution(
                m.clip_params, m.trainable["ctx"], m.prompt_learner.bank,
                m.clip_cfg, m.prompt_cfg, m.trainable["adjustor"],
            )
            self._text_cache = feats
        return self._text_cache

    def _run_batch(self, batch):
        t_start = time.monotonic()
        pixels = [b[0] for b in batch]
        size = self.model.clip_cfg.image_size
        if all(p.dtype == np.uint8 for p in pixels):
            x = np.zeros((self.batch_size, size, size, 3), np.uint8)
            for i, p in enumerate(pixels):
                x[i] = p
        else:
            from tapclip_tpu_torch.data.preprocess import normalize

            x = np.zeros((self.batch_size, size, size, 3), np.float32)
            for i, p in enumerate(pixels):
                x[i] = normalize(p.astype(np.float32) / 255.0) if p.dtype == np.uint8 else p
        try:
            with self._lock, torch.inference_mode():
                m = self.model
                logits, feats = predict_batch(
                    m.clip_params, m.clip_cfg, self._cached_text_feats(),
                    m.trainable["logit_scale"], m.prompt_learner.bank.class_mask,
                    torch.from_numpy(x).to(m.device),
                )
                names = list(m.class_names)
                logits = logits[: len(batch), : len(names)].float().cpu().numpy()
                feats = feats[: len(batch)].float().cpu().numpy()
            probs = _softmax(logits / self.temperature)
            preds = logits.argmax(-1)
            for i, (_, slot, done, kind) in enumerate(batch):
                if kind == "embed":
                    slot["result"] = {"embedding": [round(float(v), 6) for v in feats[i]]}
                else:
                    slot["result"] = {
                        "index": int(preds[i]),
                        "class": names[int(preds[i])],
                        "probs": {n: round(float(probs[i, j]), 6) for j, n in enumerate(names)},
                    }
                done.set()
            self._n_requests += len(batch)
            self._n_batches += 1
            self._batch_ms_total += (time.monotonic() - t_start) * 1e3
        except Exception as e:  # noqa: BLE001 - propagate to every waiter
            log.exception("batch failed")
            for _, slot, done, _kind in batch:
                slot["error"] = f"{type(e).__name__}: {e}"
                done.set()


def predict_batch(clip_params, clip_cfg, text_feats, logit_scale, class_mask, images):
    """Serving hot path: image tower + logits against cached text features.

    Returns (logits [B, C_max] with padded classes at -1e30, normalized image
    features [B, E]).
    """
    from tapclip_tpu_torch.models import clip as clip_model

    img = clip_model.l2_normalize(clip_model.encode_image(clip_params, clip_cfg, images))
    logits = torch.exp(logit_scale) * (img.float() @ text_feats.float().T)
    return torch.where(class_mask[None], logits, torch.full_like(logits, -1e30)), img


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def decode_image_payload(payload: Dict[str, Any], image_size: int) -> np.ndarray:
    """Request JSON -> [H, W, 3] pixels.

    A base64 image or integer pixels stay raw uint8 (resized and cropped) and
    are normalized on the device; float pixels (0-1, or 0-255 when any value
    exceeds 2) are CLIP-normalized here as f32.  The JAX server's
    ``keep_uint8=True`` mode, the one its HTTP handler uses.
    """
    from tapclip_tpu_torch.data.preprocess import normalize, preprocess_pil_uint8

    if "image" in payload:
        from PIL import Image

        img = Image.open(io.BytesIO(base64.b64decode(payload["image"])))
        return preprocess_pil_uint8(img, image_size)
    if "pixels" in payload:
        arr = np.asarray(payload["pixels"])
        if arr.shape != (image_size, image_size, 3):
            raise ValueError(f"pixels must be [{image_size}, {image_size}, 3], got {arr.shape}")
        if np.issubdtype(arr.dtype, np.integer):
            if arr.min() < 0 or arr.max() > 255:
                raise ValueError("integer pixels must be in [0, 255]")
            return arr.astype(np.uint8)
        if arr.max() > 2.0:
            arr = arr.astype(np.float32) / 255.0
        return normalize(arr).astype(np.float32)  # in the payload's precision, as the JAX server
    raise ValueError("payload must contain 'image' (base64) or 'pixels'")


def make_http_server(service: PredictService, host: str = "127.0.0.1", port: int = 8711):
    """Threaded stdlib HTTP server bound to the service (returned unstarted)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    image_size = service.model.clip_cfg.image_size

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            log.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, code: int, obj: Dict[str, Any]):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> Dict[str, Any]:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {
                    "status": "ok",
                    "model": service.model.clip_cfg.name,
                    "classes": len(service.model.class_names),
                    "batch_size": service.batch_size,
                    **service.stats(),
                })
            elif self.path == "/metrics":
                s = service.stats()
                lines = [
                    "# TYPE tapclip_requests_total counter",
                    f"tapclip_requests_total {s['requests']}",
                    "# TYPE tapclip_batches_total counter",
                    f"tapclip_batches_total {s['batches']}",
                    "# TYPE tapclip_batch_fill_mean gauge",
                    f"tapclip_batch_fill_mean {s['mean_batch_fill']}",
                    "# TYPE tapclip_batch_ms_mean gauge",
                    f"tapclip_batch_ms_mean {s['mean_batch_ms']}",
                    "# TYPE tapclip_classes gauge",
                    f"tapclip_classes {len(service.model.class_names)}",
                ]
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/classes":
                self._send(200, {"classes": list(service.model.class_names)})
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            try:
                payload = self._read_json()
                if self.path == "/predict":
                    self._send(200, service.predict(decode_image_payload(payload, image_size)))
                elif self.path == "/explain":
                    self._send(200, service.explain(decode_image_payload(payload, image_size),
                                                    saliency=payload.get("saliency")))
                elif self.path == "/embed":
                    self._send(200, service.embed(decode_image_payload(payload, image_size)))
                elif self.path == "/embed_text":
                    self._send(200, service.embed_text(payload.get("texts", [])))
                elif self.path == "/classes":
                    self._send(200, {"classes": service.add_class(payload["name"])})
                elif self.path == "/reload":
                    self._send(200, service.reload_weights(payload.get("path")))
                else:
                    self._send(404, {"error": f"no route {self.path}"})
            except NotPortedError as e:
                self._send(501, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - serving boundary
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def build_model(cfg, class_names, device: str, seed: int = 0):
    """FullModel with random weights drawn from ``seed`` on ``device``."""
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.models.model_wrapper import FullModel

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is present")
    generator = torch.Generator(device=dev).manual_seed(seed)
    params = clip_model.init_clip_params(generator, cfg, device=dev)
    return FullModel(class_names, params, cfg)


def server_config(args):
    """The model config the parsed flags ask for (``--model`` or ``--preset``,
    then ``--int8``, ``--int8-deterministic`` and ``--token-keep-ratio``, as
    the JAX server applies them)."""
    from tapclip_tpu_torch.config import MODEL_PRESETS, preset

    cfg = preset(args.preset).model if args.preset else MODEL_PRESETS[args.model]
    if args.int8:
        cfg = cfg.replace(quantize_tower=True, int8_deterministic=args.int8_deterministic)
    if args.token_keep_ratio < 1.0:
        cfg = cfg.replace(token_keep_ratio=args.token_keep_ratio)
    return cfg


def main(argv: Optional[List[str]] = None):
    from tapclip_tpu_torch.config import MODEL_PRESETS

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="ViT-B-16", choices=list(MODEL_PRESETS))
    p.add_argument("--preset", default=None, help="use a config preset's model "
                   "(e.g. tiny) instead of --model")
    p.add_argument("--classes", nargs="+", default=["Backpack", "Pen", "Monitor"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8711)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-latency-ms", type=float, default=10.0)
    p.add_argument("--temperature", type=float, default=1.0,
                   help="softmax temperature for served probabilities")
    p.add_argument("--synthetic", action="store_true",
                   help="random weights from a fixed seed (required: loading "
                        "open_clip weights is not yet ported)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--int8", action="store_true",
                   help="serve the int8 W8A8 tower (ViT only)")
    p.add_argument("--int8-deterministic", action="store_true",
                   help="with --int8: round-to-nearest everywhere for reproducible "
                        "scoring (the same kernels, without stochastic rounding)")
    p.add_argument("--token-keep-ratio", type=float, default=1.0,
                   help="attention-aware token pruning ratio (1.0 = off)")
    for flag in ("--pretrained", "--ckpt", "--dp"):
        p.add_argument(flag, default=None, nargs="?", const=True, help=f"({NOT_PORTED})")
    args = p.parse_args(argv)
    for flag in ("pretrained", "ckpt", "dp"):
        if getattr(args, flag) is not None:
            p.error(f"--{flag.replace('_', '-')} is {NOT_PORTED}")
    if not args.synthetic:
        p.error("pass --synthetic: loading open_clip weights is " + NOT_PORTED)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = server_config(args)
    model = build_model(cfg, args.classes, args.device)
    if model.device.type == "cuda":
        # Build the kernels before the first request: nvcc takes longer than
        # a request's timeout on a fresh checkout.
        from tapclip_tpu_torch.ops import _build

        _build.library()
        log.info("kernels ready in %.1f s (%s)", _build.build_log["seconds"],
                 "cached" if _build.build_log["cached"] else "nvcc")
    service = PredictService(model, batch_size=args.batch_size,
                             max_latency_ms=args.max_latency_ms, temperature=args.temperature)
    server = make_http_server(service, args.host, args.port)
    log.info("serving %s with %d classes on http://%s:%d (batch=%d, max_latency=%.0fms, device=%s)",
             cfg.name, len(args.classes), args.host, args.port, args.batch_size,
             args.max_latency_ms, args.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
