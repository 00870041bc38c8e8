"""Unified few-shot adaptation benchmark: every method, one command.

Counterpart of ``tapclip_tpu/fewshot.py``.  Eleven adaptation paths over the
same frozen CLIP towers run on ONE dataset/shots split and fill one table,

    Method,Shots,Accuracy,TrainSeconds   (fewshot.csv + grouped bar PNG)

zero-shot, weighted k-NN, linear probe, Tip-Adapter (+F), CLIP-Adapter,
TAP prompt tuning, ProGrad, PromptSRC, MaPLe and TPT (test-time tuning,
which uses no training shots).  The frozen-tower methods share one feature
pass; prompt tuning, ProGrad and PromptSRC train over those cached
features; MaPLe re-runs the image tower every step (its vision prompts are
trainable) and TPT runs it over every view of every eval image.  The split
is ``few_shot_split``'s throughout.

Tip-Adapter's alpha/beta search and CLIP-Adapter's ratio search select on
the EVAL features, as the upstream papers do; ``--no-search`` keeps the
fixed defaults.

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
without a card raises.  ``main`` is :func:`parse`, then :func:`run` (the
table and ``fewshot.csv``), then :func:`write_chart` (matplotlib).

Usage:
    python -m tapclip_tpu_torch.fewshot --train-root .../Real_World --shots 16 \\
        --model ViT-B-16 --pretrained open_clip_pytorch_model.bin --out results/fewshot
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

log = logging.getLogger("tapclip_tpu_torch")

ALL_METHODS = (
    "zero-shot",
    "knn",
    "linear-probe",
    "tip-adapter",
    "tip-adapter-f",
    "clip-adapter",
    "prompt",
    "prograd",
    "promptsrc",
    "maple",
    "tpt",
)
CSV_COLUMNS = ["Method", "Shots", "Accuracy", "TrainSeconds"]
PROMPTSRC_TEMPLATES = ("a photo of a {}", "a blurry photo of a {}", "a drawing of a {}")


def knn_classify(train_feats, train_labels, query_feats, num_classes: int, *, k: int = 20,
                 temperature: float = 0.07, device=None) -> torch.Tensor:
    """Weighted k-NN over L2-normalized features -> ``[B, C]`` scores: each
    query's k nearest train features vote with weight ``exp(cos / T)``
    (one product and ``torch.topk``)."""
    from tapclip_tpu_torch.linear_probe import as_tensor

    Q = as_tensor(query_feats, device)
    X = as_tensor(train_feats, Q.device)
    y = torch.as_tensor(np.asarray(train_labels), device=Q.device).long()
    k = min(k, X.shape[0])
    top = torch.topk(Q @ X.T, k, dim=-1)  # [B, N] cosines (unit rows) -> [B, k]
    w = torch.exp(top.values / temperature)
    votes = torch.nn.functional.one_hot(y[top.indices], num_classes).float()  # [B, k, C]
    return torch.einsum("bk,bkc->bc", w, votes)


def run_fewshot_benchmark(
    train_root: str,
    *,
    val_root: Optional[str] = None,
    shots: int = 16,
    methods=ALL_METHODS,
    cfg=None,
    params=None,
    bpe_path: Optional[str] = None,
    batch_size: int = 256,
    epochs: int = 30,
    lr: float = 2e-3,
    maple_depth: int = 3,
    maple_prompt_len: int = 2,
    tpt_views: int = 8,
    search_hp: bool = True,
    ensemble: bool = False,
    seed: int = 0,
    verbose: bool = True,
) -> List[Dict]:
    """Run the selected methods -> ``[{Method, Shots, Accuracy, TrainSeconds}]``
    (accuracy in percent on the held-out split).  Every method runs on the
    device of ``params``."""
    from tapclip_tpu_torch.config import PromptConfig, TrainConfig
    from tapclip_tpu_torch.data.imagefolder import ImageFolderIndex, Loader, eval_samples, few_shot_split
    from tapclip_tpu_torch.data.tokenizer import get_tokenizer
    from tapclip_tpu_torch.linear_probe import extract_samples
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.trainer import CachedSet
    from tapclip_tpu_torch.zero_shot import (
        DEFAULT_TEMPLATES,
        OPENAI_IMAGENET_TEMPLATES_SMALL,
        build_zero_shot_classifier,
    )

    unknown = [m for m in methods if m not in ALL_METHODS]
    if unknown:
        raise ValueError(f"unknown methods {unknown}; choose from {ALL_METHODS}")

    dev = params["logit_scale"].device
    tokenizer = get_tokenizer(bpe_path, cfg.context_length)
    index = ImageFolderIndex.scan(train_root)
    class_names = index.classes
    n_cls = len(class_names)
    split = few_shot_split(index, class_names, shots, seed=seed)
    val_samples = eval_samples(index, val_root, split)

    logit_scale = float(np.exp(params["logit_scale"].float().cpu().numpy()))
    zs_classifier = build_zero_shot_classifier(
        params, cfg, class_names, tokenizer,
        templates=OPENAI_IMAGENET_TEMPLATES_SMALL if ensemble else DEFAULT_TEMPLATES,
    ).cpu().numpy()

    # One shared frozen-tower pass serves every feature-space method.
    Xtr = ytr = Xva = yva = None
    if [m for m in methods if m not in ("maple", "tpt")]:
        Xtr, ytr = extract_samples(cfg, params, split.train, batch_size)
        Xva, yva = extract_samples(cfg, params, val_samples, batch_size)
        if verbose:
            log.info("fewshot: %d train / %d eval features, %d classes", len(ytr), len(yva), n_cls)

    shots_label = f"{shots}-shot"
    results: List[Dict] = []

    def record(method: str, acc_pct: float, dt: float) -> None:
        results.append({"Method": method, "Shots": shots_label, "Accuracy": round(float(acc_pct), 2),
                        "TrainSeconds": round(float(dt), 2)})
        if verbose:
            log.info("fewshot %-14s %6.2f%%  (%.1fs)", method, acc_pct, dt)

    def prompt_model(**prompt_kw):
        return FullModel(class_names, params, cfg, prompt_cfg=PromptConfig(max_classes=max(8, n_cls), **prompt_kw),
                         tokenizer=tokenizer, generator=torch.Generator().manual_seed(seed))

    def train_cfg(**kw):
        return TrainConfig(lr=lr, epochs=epochs, batch_size=min(batch_size, 64), seed=seed, **kw)

    if "zero-shot" in methods:
        t0 = time.monotonic()
        pred = (Xva @ zs_classifier.T).argmax(-1)
        record("zero-shot", 100.0 * (pred == yva).mean(), time.monotonic() - t0)

    if "knn" in methods:
        t0 = time.monotonic()
        pred = knn_classify(Xtr, ytr, Xva, n_cls, device=dev).argmax(-1).cpu().numpy()
        record("knn", 100.0 * (pred == yva).mean(), time.monotonic() - t0)

    if "linear-probe" in methods:
        from tapclip_tpu_torch.linear_probe import fit_linear_probe, probe_accuracy

        t0 = time.monotonic()
        W, b = fit_linear_probe(Xtr, ytr, n_cls, seed=seed, device=dev)
        record("linear-probe", 100.0 * probe_accuracy(Xva, yva, W, b), time.monotonic() - t0)

    if "tip-adapter" in methods or "tip-adapter-f" in methods:
        from tapclip_tpu_torch.tip_adapter import (
            build_cache_model,
            cache_accuracy,
            fit_tip_adapter_f,
            search_hyperparams,
        )

        t0 = time.monotonic()
        keys, values = build_cache_model(Xtr, ytr, n_cls)
        alpha, beta = 1.0, 5.5
        if search_hp:
            alpha, beta, _ = search_hyperparams(Xva, yva, keys, values, zs_classifier, logit_scale, device=dev)
        build_dt = time.monotonic() - t0
        if "tip-adapter" in methods:
            record("tip-adapter", 100.0 * cache_accuracy(Xva, yva, keys, values, zs_classifier, logit_scale, alpha,
                                                         beta, dev), build_dt)
        if "tip-adapter-f" in methods:
            t0 = time.monotonic()
            keys_f = fit_tip_adapter_f(keys, values, Xtr, ytr, zs_classifier, logit_scale, alpha, beta, device=dev)
            record("tip-adapter-f", 100.0 * cache_accuracy(Xva, yva, keys_f, values, zs_classifier, logit_scale,
                                                           alpha, beta, dev), build_dt + (time.monotonic() - t0))

    if "clip-adapter" in methods:
        from tapclip_tpu_torch.clip_adapter import adapter_accuracy, fit_clip_adapter, search_ratio

        t0 = time.monotonic()
        visual, _ = fit_clip_adapter(Xtr, ytr, zs_classifier, logit_scale, seed=seed, device=dev)
        ratio = 0.2
        if search_hp:
            ratio, _ = search_ratio(Xva, yva, zs_classifier, logit_scale, visual, device=dev)
        record("clip-adapter", 100.0 * adapter_accuracy(Xva, yva, zs_classifier, logit_scale, visual, ratio,
                                                        device=dev), time.monotonic() - t0)

    if "prompt" in methods or "prograd" in methods:
        from tapclip_tpu_torch.trainer import fit_prompt_model

        # ProGrad (Zhu et al. 2023): the same protocol as "prompt", the update
        # projected so it never increases the KL to the zero-shot predictions.
        for method, kw in (("prompt", {}), ("prograd", {"prograd_lambda": 1.0})):
            if method in methods:
                t0 = time.monotonic()
                fit = fit_prompt_model(prompt_model(), CachedSet(Xtr, ytr), CachedSet(Xva, yva), train_cfg(**kw),
                                       verbose=False)
                record(method, fit.best_acc, time.monotonic() - t0)

    if "promptsrc" in methods:
        # Feature + logit self-regularization toward the frozen zero-shot
        # model over a small template-ensembled anchor, then Gaussian
        # aggregation of the per-epoch prompts (Khattak et al. 2023).
        from tapclip_tpu_torch.promptsrc import fit_promptsrc

        t0 = time.monotonic()
        res = fit_promptsrc(prompt_model(), CachedSet(Xtr, ytr), CachedSet(Xva, yva),
                            train_cfg(kg_lambda=1.0, scl_lambda=1.0, anchor_templates=PROMPTSRC_TEMPLATES),
                            verbose=False)
        record("promptsrc", max(res.gpa_acc, res.fit.best_acc), time.monotonic() - t0)

    if "maple" in methods:
        from tapclip_tpu_torch.maple import fit_maple

        t0 = time.monotonic()
        mk = dict(image_size=cfg.image_size, output_dtype="uint8")
        res = fit_maple(prompt_model(maple_depth=maple_depth, prompt_len=maple_prompt_len),
                        Loader(split.train, min(batch_size, 32), shuffle=True, seed=seed, **mk),
                        Loader(val_samples, min(batch_size, 64), shuffle=False, **mk),
                        epochs=epochs, lr=lr, verbose=False)
        record("maple", res["best_acc"], time.monotonic() - t0)

    if "tpt" in methods:
        # Test-time tuning consumes no training shots: the row is the
        # zero-shot-regime baseline (template-init context, per-sample
        # entropy minimization on the eval images).
        from tapclip_tpu_torch.tpt import TPTConfig, evaluate_tpt

        t0 = time.monotonic()
        res = evaluate_tpt(prompt_model(), val_samples, tpt=TPTConfig(n_views=tpt_views, steps=1),
                           batch_size=min(batch_size, 16), seed=seed, verbose=False)
        record("tpt", res["accuracy"], time.monotonic() - t0)

    return results


def write_csv(results: List[Dict], out_dir: str) -> str:
    """``fewshot.csv`` under ``out_dir``."""
    import pandas as pd

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "fewshot.csv")
    pd.DataFrame(results, columns=CSV_COLUMNS).to_csv(path, index=False)
    return path


def write_chart(results: List[Dict], out_dir: str) -> str:
    """The grouped bar chart (matplotlib): methods are the groups."""
    from tapclip_tpu_torch.utils.plotting import save_cross_domain_bar

    return save_cross_domain_bar([dict(r, Domain=r["Method"]) for r in results],
                                 os.path.join(out_dir, "fewshot_bar.png"), title="Few-Shot Adaptation Methods")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train-root", required=True)
    p.add_argument("--val-root", default=None)
    p.add_argument("--shots", type=int, default=16)
    p.add_argument("--methods", nargs="+", default=list(ALL_METHODS), choices=list(ALL_METHODS))
    p.add_argument("--model", default="ViT-B-16")
    p.add_argument("--preset", default=None)
    p.add_argument("--pretrained", default=None, help="open_clip .bin/.pt state dict")
    p.add_argument("--bpe-path", default=None)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--maple-depth", type=int, default=3)
    p.add_argument("--maple-prompt-len", type=int, default=2)
    p.add_argument("--tpt-views", type=int, default=8)
    p.add_argument("--no-search", action="store_true", help="fixed tip/adapter hyperparameters (no eval-split search)")
    p.add_argument("--ensemble", action="store_true")
    p.add_argument("--out", default=None, help="artifact dir (csv + bar chart)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    return p


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return build_argparser().parse_args(argv)


def run(args) -> List[Dict]:
    """The weights, :func:`run_fewshot_benchmark` and, with ``--out``,
    ``fewshot.csv``."""
    from tapclip_tpu_torch.config import MODEL_PRESETS, preset
    from tapclip_tpu_torch.featurize import load_clip_params

    cfg = preset(args.preset).model if args.preset else MODEL_PRESETS[args.model]
    params = load_clip_params(cfg, args.pretrained, device=args.device)
    results = run_fewshot_benchmark(
        args.train_root, val_root=args.val_root, shots=args.shots, methods=tuple(args.methods), cfg=cfg,
        params=params, bpe_path=args.bpe_path, batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
        maple_depth=args.maple_depth, maple_prompt_len=args.maple_prompt_len, tpt_views=args.tpt_views,
        search_hp=not args.no_search, ensemble=args.ensemble, seed=args.seed,
    )
    if args.out:
        log.info("fewshot csv: %s", write_csv(results, args.out))
    return results


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    logging.basicConfig(level=logging.INFO)
    args = parse(argv)
    results = run(args)
    if args.out:
        log.info("fewshot chart: %s", write_chart(results, args.out))
    return results


if __name__ == "__main__":
    main()
