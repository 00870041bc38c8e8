"""Standard CLIP zero-shot cross-domain evaluation driver.

Counterpart of ``tapclip_tpu/zero_shot_eval.py``: build a zero-shot
classifier from the class names once (one template, or the OpenAI ensemble
with ``--ensemble``), evaluate every domain's val split (features keyed by
image path, ``trainer.PathFeatureCache``), and write the same
``Domain,Shots,Accuracy`` CSV and bar chart as the transfer drivers (rows
labeled "Zero-Shot").  ``main`` is :func:`parse`, then :func:`run` (the
domains and the CSV), then :func:`write_plot`.

Usage:
    python -m tapclip_tpu_torch.zero_shot_eval --domain-root data/OfficeHome \\
        --pretrained open_clip_pytorch_model.bin --classes ... [--ensemble]
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np

from tapclip_tpu_torch.config import preset
from tapclip_tpu_torch.train import apply_overrides, build_argparser, build_model


def parse(argv: Optional[List[str]] = None):
    p = build_argparser(__doc__)
    p.add_argument("--domains", nargs="+", default=["Real World", "Art", "Clipart", "Product"])
    p.add_argument("--domain-root", default=None)
    p.add_argument("--ensemble", action="store_true",
                   help="use the OpenAI template ensemble instead of a single template")
    p.add_argument("--raw-names", action="store_true",
                   help="keep underscores in class names (strict reference parity)")
    args = p.parse_args(argv)
    return args, apply_overrides(preset(args.preset), args)


def run(args, cfg) -> dict:
    """The model, the classifier, one accuracy per domain and the CSV."""
    from tapclip_tpu_torch.data.imagefolder import ImageFolderIndex, few_shot_split
    from tapclip_tpu_torch.trainer import PathFeatureCache
    from tapclip_tpu_torch.utils.logging_utils import generate_output_paths, setup_logging
    from tapclip_tpu_torch.utils.plotting import save_results_csv
    from tapclip_tpu_torch.zero_shot import (
        DEFAULT_TEMPLATES,
        OPENAI_IMAGENET_TEMPLATES_SMALL,
        build_zero_shot_classifier,
    )

    paths = generate_output_paths(cfg.version + "_zeroshot", cfg.output_root)
    log = setup_logging(os.path.join(paths["log_dir"], "zero_shot.log"))
    model, preprocess = build_model(cfg, bpe_path=args.bpe_path, device=args.device)
    class_names = list(cfg.class_names)
    templates = OPENAI_IMAGENET_TEMPLATES_SMALL if args.ensemble else DEFAULT_TEMPLATES
    classifier = build_zero_shot_classifier(model.clip_params, cfg.model, class_names, model.tokenizer,
                                            templates=templates, raw_names=args.raw_names)
    classifier = classifier.float().cpu().numpy()
    log.info("zero-shot classifier: %d classes x %d templates", len(class_names), len(templates))

    domain_root = args.domain_root or os.path.dirname(cfg.data_root) or "."
    cache = PathFeatureCache(model, preprocess=preprocess)
    scale = float(np.exp(model.clip_params["logit_scale"].float().cpu().numpy()))
    results = []
    for domain in args.domains:
        index = ImageFolderIndex.scan(os.path.join(domain_root, domain))
        split = few_shot_split(index, class_names, num_shots=0, seed=cfg.train.seed)
        cached = cache.gather(split.val)
        img = cached.feats / np.linalg.norm(cached.feats, axis=-1, keepdims=True)
        logits = scale * img @ classifier.T
        acc = 100.0 * float((logits.argmax(-1) == cached.labels).mean())
        log.info("[Zero-Shot/%s] accuracy: %.2f%%", domain, acc)
        results.append({"Domain": domain, "Shots": "Zero-Shot", "Accuracy": acc})
    csv_path = save_results_csv(results, os.path.join(paths["csv_dir"], "zero_shot_results.csv"))
    return {"results": results, "csv": csv_path, "plot": os.path.join(paths["plot_dir"], "zero_shot_bar.png"),
            "paths": paths}


def write_plot(out: dict) -> dict:
    """The bar chart of a :func:`run` (matplotlib)."""
    from tapclip_tpu_torch.utils.plotting import save_cross_domain_bar

    save_cross_domain_bar(out["results"], out["plot"], title="Zero-Shot Cross-Domain Accuracy", ylim=(0, 100))
    logging.getLogger("tapclip_tpu_torch").info("results: %s | plot: %s", out["csv"], out["plot"])
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    args, cfg = parse(argv)
    return write_plot(run(args, cfg))


if __name__ == "__main__":
    main()
