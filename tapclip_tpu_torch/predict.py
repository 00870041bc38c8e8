"""Batch inference: classify a folder of unlabeled images with tuned prompts.

Counterpart of ``tapclip_tpu/predict.py``, with the serving path's math:

- the adjusted class-text features are computed once (the attribution pass
  does not depend on the image; ``models/model_wrapper.py``), then every
  batch runs the frozen image tower and one logits product against them,
  as ``serve.py``'s predict;
- a fixed batch size with the tail padded and masked, uint8 host -> device
  transport and decode-ahead with pinned asynchronous copies, as
  ``featurize``;
- ``predictions.csv`` (``path,label,score[,label_j,score_j...]``) and, with
  ``--json``, ``predictions.json`` with the full top-k and the class-level
  attribution matrix; with ``--saliency`` a patch-saliency overlay PNG per
  image (``utils/saliency.py``; the PNGs need matplotlib).

``--int8`` runs the W8A8 tower (B13 and B14 in every block; stochastic
rounding unless ``--int8-deterministic``).  Runs on ``cuda`` unless
``--device cpu`` is given; asking for ``cuda`` without a card raises.
Image-conditioned (CoCoOp) models have per-sample text features, so they
run the full forward per batch and their attribution is ``None`` (``null``
in ``--json``).  ``--dp N`` splits every batch over N replicas of the tower
in this process (CUDA devices 0 .. N - 1; the batch size must divide by N),
on the cached-text path as in the JAX package.

Usage:
    python -m tapclip_tpu_torch.predict --image-root photos/ --out preds/ \\
        --model ViT-B-16 --pretrained open_clip_pytorch_model.bin --ckpt best_model.pt \\
        --classes Backpack Pen Mug --top-k 3
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import logging
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch


log = logging.getLogger("tapclip_tpu_torch")

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".gif", ".tif", ".tiff")


def list_images(root: str) -> List[str]:
    """Every image file under ``root``, recursively, sorted."""
    out: List[str] = []
    for dirpath, _, filenames in os.walk(root):
        out.extend(os.path.join(dirpath, fn) for fn in filenames if fn.lower().endswith(IMAGE_EXTENSIONS))
    return sorted(out)


def iter_image_batches(
    paths: List[str],
    batch_size: int,
    image_size: int,
    output_dtype: str,
    fast_decode: bool = False,
) -> Iterator[Tuple[np.ndarray, List[str], np.ndarray]]:
    """Decode ``paths`` into fixed-size ``(images, paths, mask)`` batches.

    Rides ``imagefolder.Loader`` (the label carries the corpus index), so a
    corrupt file is skipped, not fatal.  The mask can be False mid-batch (a
    decode failure on the native path), not just on the padded tail;
    ``paths`` lists the real rows in batch order.
    """
    from tapclip_tpu_torch.data.imagefolder import Loader

    loader = Loader([(p, i) for i, p in enumerate(paths)], batch_size, shuffle=False, image_size=image_size,
                    output_dtype=output_dtype, fast_decode=fast_decode)
    for images, idx, mask in loader:
        yield images, [paths[int(i)] for i, m in zip(idx, mask) if m], mask


def make_classify_fn(cfg, mesh=None):
    """``(params, text_feats [C, E], logit_scale, class_mask, images) ->
    probs [B, C]``: ``serve.predict_batch``'s logits, softmaxed.  With
    ``mesh`` (a device-list mesh) the images split over its replicas
    (``parallel.sharding.data_parallel``)."""
    from tapclip_tpu_torch.parallel.sharding import data_parallel
    from tapclip_tpu_torch.serve import predict_batch

    def classify(params, text_feats, logit_scale, class_mask, images):
        with torch.inference_mode():
            images = torch.as_tensor(images, device=text_feats.device)
            logits, _ = predict_batch(params, cfg, text_feats, logit_scale, class_mask, images)
            return torch.softmax(logits, dim=-1)

    return data_parallel(classify, mesh, 4)


def predict_corpus(
    model,
    paths: List[str],
    *,
    batch_size: int = 256,
    top_k: int = 1,
    uint8_transfer: bool = True,
    mesh=None,
    prefetch_depth: int = 2,
    fast_decode: bool = False,
    saliency: Optional[str] = None,
    saliency_dir: Optional[str] = None,
):
    """Classify ``paths`` -> ``(rows, attribution)``.

    rows: one ``{"path", "labels": [k], "scores": [k]}`` per decodable image,
    in corpus order.  attribution: the class-level ``[n_cls, P]`` scores the
    adjusted features were built with, or ``None`` for an image-conditioned
    (CoCoOp) model, which runs the full forward per batch (its attribution
    is per sample); ``mesh`` (a device-list mesh) applies to the cached
    path, as in the JAX package.  ``saliency`` (``"rollout"`` or
    ``"last"``) also writes a heatmap-overlay PNG per image into
    ``saliency_dir`` (each row gains ``"saliency_png"``) and forces uint8
    transport (the overlay needs display-space pixels).
    """
    from tapclip_tpu_torch.data.prefetch import prefetch_to_device
    from tapclip_tpu_torch.models.model_wrapper import full_model_forward, text_features_with_attribution

    cfg, pcfg = model.clip_cfg, model.prompt_cfg
    bank = model.prompt_learner.bank
    n_cls = model.n_cls
    top_k = max(1, min(top_k, n_cls))
    if pcfg.image_conditioned:
        attribution = None

        def probs_fn(images):
            with torch.inference_mode():
                logits = full_model_forward(model.clip_params, model.trainable, bank, images, None, clip_cfg=cfg,
                                            prompt_cfg=pcfg)["logits"]
                return torch.softmax(logits, dim=-1)
    else:
        with torch.inference_mode():
            feats, attribution = text_features_with_attribution(
                model.clip_params, model.trainable["ctx"], bank, cfg, pcfg, model.trainable["adjustor"])
        attribution = attribution[:n_cls].float().cpu().numpy()
        scale = model.trainable["logit_scale"].float()
        classify = make_classify_fn(cfg, mesh)

        def probs_fn(images):
            return classify(model.clip_params, feats, scale, bank.class_mask, images)

    if saliency:
        if saliency not in ("rollout", "last"):
            raise ValueError(f"unknown saliency method {saliency!r}")
        if saliency_dir is None:
            raise ValueError("saliency requires saliency_dir")
        os.makedirs(saliency_dir, exist_ok=True)
        uint8_transfer = True  # the overlay needs display-space pixels

    dtype = "uint8" if uint8_transfer else "float32"
    batches = iter_image_batches(paths, batch_size, cfg.image_size, dtype, fast_decode)
    rows = []
    names = list(model.class_names)
    for images, metas, mask in prefetch_to_device(batches, size=prefetch_depth, device=model.device):
        keep = mask.cpu().numpy()
        # Slice to the real classes before ranking: padded slots carry
        # probability 0.0 and an unstable argsort could rank one above a
        # tied real class.
        probs = probs_fn(images).float().cpu().numpy()[keep][:, :n_cls]
        order = np.argsort(-probs, axis=-1)[:, :top_k]
        grids = None
        if saliency:
            from tapclip_tpu_torch.utils.plotting import save_saliency_overlay
            from tapclip_tpu_torch.utils.saliency import patch_saliency

            # 16 images at a time: the rollout holds every layer's
            # [b, H, T, T] probabilities.
            masked = images[torch.as_tensor(keep, device=images.device)]
            grids = np.concatenate([
                patch_saliency(model.clip_params, cfg, masked[s : s + 16], method=saliency)
                for s in range(0, len(masked), 16)
            ]) if len(masked) else np.zeros((0, 1, 1))
            masked = masked.cpu().numpy()
        for bi, (path, idx, p) in enumerate(zip(metas, order, probs)):
            row = {"path": path, "labels": [names[j] for j in idx], "scores": [float(p[j]) for j in idx]}
            if grids is not None:
                stem = os.path.splitext(os.path.basename(path))[0]
                png = os.path.join(saliency_dir, f"{len(rows):05d}_{stem}_saliency.png")
                row["saliency_png"] = save_saliency_overlay(masked[bi].astype(np.float32) / 255.0, grids[bi], png,
                                                            title=f"{row['labels'][0]} ({saliency})")
            rows.append(row)
    return rows, attribution


def build_argparser() -> argparse.ArgumentParser:
    from tapclip_tpu_torch.featurize import add_tower_args

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image-root", required=True, help="directory of images (recursive; no labels needed)")
    p.add_argument("--out", required=True, help="output directory")
    add_tower_args(p)
    p.add_argument("--ckpt", default=None, help="tuned prompt checkpoint (the port's .pt or a reference .pt)")
    p.add_argument("--classes", nargs="+", default=None)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--top-k", type=int, default=1)
    p.add_argument("--json", action="store_true",
                   help="also write predictions.json (full top-k + class-level attribution)")
    p.add_argument("--int8", action="store_true", help="quantized W8A8 tower (B13 and B14)")
    p.add_argument("--int8-deterministic", action="store_true",
                   help="with --int8: round to nearest everywhere (the same kernels)")
    p.add_argument("--saliency", default=None, choices=["rollout", "last"],
                   help="write a patch-saliency overlay PNG per image into OUT/saliency/")
    p.add_argument("--fast-decode", action="store_true",
                   help="DCT-scaled JPEG decode in the native pipeline (near- but not bit-identical pixels)")
    p.add_argument("--uint8-transfer", dest="uint8_transfer", action="store_true", default=True)
    p.add_argument("--no-uint8-transfer", dest="uint8_transfer", action="store_false")
    p.add_argument("--dp", type=int, default=0,
                   help="split every batch over this many replicas (CUDA devices 0 .. dp - 1; 0: one device)")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    mesh = None
    if args.dp:
        from tapclip_tpu_torch.parallel.mesh import device_mesh

        mesh = device_mesh(args.dp, args.device)
        if args.batch_size % args.dp:
            raise SystemExit("--batch-size must divide by --dp")
    from tapclip_tpu_torch.config import ExperimentConfig, preset
    from tapclip_tpu_torch.featurize import tower_config
    from tapclip_tpu_torch.train import build_model

    ecfg = preset(args.preset) if args.preset else ExperimentConfig()
    ecfg = dataclasses.replace(ecfg, model=tower_config(args, args.int8, args.int8_deterministic))
    if args.classes:
        ecfg = dataclasses.replace(ecfg, class_names=tuple(args.classes))
    if args.pretrained:
        ecfg = dataclasses.replace(ecfg, pretrained_path=args.pretrained)
    model, _ = build_model(ecfg, bpe_path=args.bpe_path, device=args.device)
    if args.ckpt:
        from tapclip_tpu_torch.utils.checkpoint import apply_prompt_checkpoint

        apply_prompt_checkpoint(model, args.ckpt)
        log.info("loaded tuned prompts from %s", args.ckpt)

    paths = list_images(args.image_root)
    if not paths:
        raise SystemExit(f"no images found under {args.image_root}")
    log.info("classifying %d images into %d classes (top-%d)", len(paths), model.n_cls, args.top_k)
    rows, attribution = predict_corpus(
        model, paths, batch_size=args.batch_size, top_k=args.top_k, uint8_transfer=args.uint8_transfer,
        mesh=mesh, fast_decode=args.fast_decode, saliency=args.saliency,
        saliency_dir=os.path.join(args.out, "saliency") if args.saliency else None,
    )

    os.makedirs(args.out, exist_ok=True)
    k = max(1, min(args.top_k, model.n_cls))
    csv_path = os.path.join(args.out, "predictions.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        header = ["path", "label", "score"]
        for j in range(2, k + 1):
            header += [f"label_{j}", f"score_{j}"]
        w.writerow(header)
        for r in rows:
            line = [r["path"]]
            for lab, sc in zip(r["labels"], r["scores"]):
                line += [lab, f"{sc:.6f}"]
            w.writerow(line)
    result = {"n": len(rows), "csv": csv_path}
    if args.json:
        json_path = os.path.join(args.out, "predictions.json")
        with open(json_path, "w") as f:
            json.dump({"classes": list(model.class_names),
                       "attribution": None if attribution is None else attribution.tolist(),
                       "predictions": rows}, f, indent=2)
        result["json"] = json_path
    log.info("wrote %d predictions to %s", len(rows), csv_path)
    return result


if __name__ == "__main__":
    main()
