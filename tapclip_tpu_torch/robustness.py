"""Corruption-robustness evaluation (the ImageNet-C protocol).

Counterpart of ``tapclip_tpu/robustness.py``: a classifier evaluated on
corrupted copies of a labeled ImageFolder at severities 1..5 per corruption
(Hendrycks & Dietterich 2019), reporting accuracy per (corruption,
severity), the mean corruption accuracy (mCA) and the retention against the
clean accuracy.

The val set is decoded once as uint8 and held on the device; every
(corruption, severity) pass re-corrupts those batches there
(``utils/corruptions.py``) ahead of the image tower, so the sweep costs no
further decode or host -> device copy.  The text side runs once (the cached
features ``predict`` uses).  ``main`` is :func:`parse`, then :func:`run`
(the sweep and ``robustness.csv``), then :func:`write_chart`.

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
without a card raises.

Usage:
    python -m tapclip_tpu_torch.robustness --val-root .../Real_World \\
        --model ViT-B-16 --pretrained open_clip_pytorch_model.bin --ckpt best_model.pt --out results/rob
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tapclip_tpu_torch.utils.corruptions import CORRUPTIONS, SEVERITIES

log = logging.getLogger("tapclip_tpu_torch")


def make_corrupt_classify_fn(cfg, name: Optional[str]):
    """``(params, text_feats, class_mask, images_u8, severity, rng) -> pred
    [B]`` with corruption ``name`` ahead of the tower (``None``: the clean
    path, plain device normalization); the argmax needs no logit scale."""
    from tapclip_tpu_torch.data.preprocess import device_normalize
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.utils.corruptions import corrupt_uint8_normalized

    def classify(params, text_feats, class_mask, images_u8, severity, rng):
        with torch.inference_mode():
            if name is None:
                x = device_normalize(images_u8)
            else:
                x = corrupt_uint8_normalized(images_u8, name, severity, rng)
            img = clip_model.l2_normalize(clip_model.encode_image(params, cfg, x)).float()
            logits = img @ text_feats.float().T
            logits = torch.where(class_mask[None, :], logits, torch.full_like(logits, -1e30))
            return logits.argmax(dim=-1)

    return classify


def evaluate_robustness(
    model,
    samples,
    *,
    corruptions: Sequence[str] = tuple(CORRUPTIONS),
    severities: Sequence[int] = SEVERITIES,
    batch_size: int = 64,
    seed: int = 0,
    verbose: bool = True,
) -> List[Dict]:
    """Run the sweep -> rows ``[{Corruption, Severity, Accuracy, Retention}]``.

    The first row is the clean pass (``Corruption="clean", Severity=0``);
    Retention is accuracy / clean accuracy.  ``model`` is a ``FullModel``:
    its trained context and adjustor feed the cached text features, as in
    ``predict``.  The stochastic corruptions of batch ``b`` in pass ``tag``
    draw from a generator seeded ``(seed, tag, b)``.
    """
    from tapclip_tpu_torch.data.imagefolder import Loader
    from tapclip_tpu_torch.models.model_wrapper import text_features_with_attribution

    unknown = [c for c in corruptions if c not in CORRUPTIONS]
    if unknown:
        raise KeyError(f"unknown corruptions {unknown}; have {sorted(CORRUPTIONS)}")
    cfg, pcfg = model.clip_cfg, model.prompt_cfg
    if pcfg.image_conditioned:
        raise NotImplementedError("robustness eval uses cached text features; CoCoOp models recompute the "
                                  "text per sample (run predict per corruption instead)")
    if pcfg.maple_depth > 0:
        raise NotImplementedError("robustness eval runs the plain frozen image tower; MaPLe's trainable "
                                  "vision prompts would be dropped silently")
    bank = model.prompt_learner.bank
    with torch.inference_mode():
        feats, _ = text_features_with_attribution(model.clip_params, model.trainable["ctx"], bank, cfg, pcfg,
                                                  model.trainable["adjustor"])

    # Decode the val set once; the batches are re-corrupted on the device.
    dev = model.device
    loader = Loader(samples, batch_size, shuffle=False, image_size=cfg.image_size, output_dtype="uint8")
    batches = [(torch.from_numpy(i).to(dev), np.asarray(lb), np.asarray(m)) for i, lb, m in loader]

    def accuracy(fn, severity, rng_tag):
        correct = total = 0
        for bi, (images, labels, mask) in enumerate(batches):
            rng = torch.Generator(device=dev).manual_seed((seed * 1_000_003 + rng_tag * 131 + bi) % 2 ** 63)
            pred = fn(model.clip_params, feats, bank.class_mask, images, severity, rng).cpu().numpy()
            correct += int(((pred == labels) & mask).sum())
            total += int(mask.sum())
        return 100.0 * correct / max(total, 1)

    t0 = time.monotonic()
    clean = accuracy(make_corrupt_classify_fn(cfg, None), 0, 0)
    rows: List[Dict] = [{"Corruption": "clean", "Severity": 0, "Accuracy": round(clean, 2), "Retention": 1.0}]
    if verbose:
        log.info("robustness: clean %.2f%% (%.1fs)", clean, time.monotonic() - t0)
    for ci, name in enumerate(corruptions, start=1):
        fn = make_corrupt_classify_fn(cfg, name)
        for sev in severities:
            acc = accuracy(fn, int(sev), ci * 17 + int(sev))
            rows.append({"Corruption": name, "Severity": int(sev), "Accuracy": round(acc, 2),
                         "Retention": round(acc / max(clean, 1e-9), 4)})
            if verbose:
                log.info("robustness: %-16s s%d %6.2f%%", name, sev, acc)
    return rows


def mean_corruption_accuracy(rows: List[Dict]) -> float:
    accs = [r["Accuracy"] for r in rows if r["Corruption"] != "clean"]
    return float(np.mean(accs)) if accs else float("nan")


def save_csv(rows: List[Dict], out_dir: str) -> str:
    """``robustness.csv`` under ``out_dir``."""
    import pandas as pd

    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "robustness.csv")
    pd.DataFrame(rows, columns=["Corruption", "Severity", "Accuracy", "Retention"]).to_csv(csv_path, index=False)
    return csv_path


def save_chart(rows: List[Dict], out_dir: str) -> str:
    """The grouped severity bar chart under ``out_dir`` (matplotlib)."""
    from tapclip_tpu_torch.utils.plotting import save_cross_domain_bar

    return save_cross_domain_bar(
        [dict(Domain=r["Corruption"], Shots=f"s{r['Severity']}", Accuracy=r["Accuracy"])
         for r in rows if r["Corruption"] != "clean"],
        os.path.join(out_dir, "robustness_bar.png"),
        title="Corruption Robustness (ImageNet-C protocol)", bar_width=0.15,
    )


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--val-root", required=True, help="labeled ImageFolder")
    p.add_argument("--corruptions", nargs="+", default=list(CORRUPTIONS), choices=list(CORRUPTIONS))
    p.add_argument("--severities", nargs="+", type=int, default=list(SEVERITIES))
    p.add_argument("--model", default="ViT-B-16")
    p.add_argument("--preset", default=None)
    p.add_argument("--pretrained", default=None, help="open_clip .pt/.bin state dict (random weights if unset)")
    p.add_argument("--ckpt", default=None, help="trained prompt checkpoint (the port's .pt or a reference .pt)")
    p.add_argument("--bpe-path", default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--out", default=None, help="artifact dir (csv + chart)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    return p.parse_args(argv)


def run(args) -> Dict:
    """The model, the prompt checkpoint, the sweep and ``robustness.csv``."""
    from tapclip_tpu_torch.config import PromptConfig
    from tapclip_tpu_torch.data.imagefolder import ImageFolderIndex
    from tapclip_tpu_torch.data.tokenizer import get_tokenizer
    from tapclip_tpu_torch.featurize import load_clip_params, tower_config
    from tapclip_tpu_torch.models.model_wrapper import FullModel

    cfg = tower_config(args)
    params = load_clip_params(cfg, args.pretrained, device=args.device)
    index = ImageFolderIndex.scan(args.val_root)
    model = FullModel(index.classes, params, cfg, prompt_cfg=PromptConfig(max_classes=max(8, len(index.classes))),
                      tokenizer=get_tokenizer(args.bpe_path), generator=torch.Generator().manual_seed(args.seed))
    if args.ckpt:
        from tapclip_tpu_torch.utils.checkpoint import apply_prompt_checkpoint

        apply_prompt_checkpoint(model, args.ckpt)
    rows = evaluate_robustness(model, index.samples, corruptions=tuple(args.corruptions),
                               severities=tuple(args.severities), batch_size=args.batch_size, seed=args.seed)
    log.info("robustness: mean corruption accuracy %.2f%% (clean %.2f%%)", mean_corruption_accuracy(rows),
             rows[0]["Accuracy"])
    return {"rows": rows, "csv": save_csv(rows, args.out) if args.out else None, "out": args.out}


def write_chart(out: Dict) -> Dict:
    if out["out"]:
        out["chart"] = save_chart(out["rows"], out["out"])
        log.info("robustness artifacts: %s, %s", out["csv"], out["chart"])
    return out


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    logging.basicConfig(level=logging.INFO)
    return write_chart(run(parse(argv)))["rows"]


if __name__ == "__main__":
    main()
