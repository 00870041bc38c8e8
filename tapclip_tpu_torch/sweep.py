"""Hyperparameter sweep driver: a grid of prompt-tuning runs, one tower pass.

Counterpart of ``tapclip_tpu/sweep.py``: the whole (lr x shots x adjustor x
prompt_len x seed) study in one process.

- The frozen image tower runs once per distinct image
  (``trainer.PathFeatureCache``, one for the whole grid): every cell trains
  on cached ``[N, E]`` features (B4 and B5 in every training step).
- Each cell gets a fresh, seeded ``FullModel`` and the early-stopping loop
  of ``train.py`` (``trainer.fit_prompt_model``).
- Artifacts: ``sweep.csv`` (one row per cell: the axes, best accuracy,
  epochs, wall seconds) and ``best.json`` (retrain the winning cell with
  ``train`` for a deployable checkpoint).

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
without a card raises.

Usage:
    python -m tapclip_tpu_torch.sweep --data-root data/.../Real\\ World \\
        --classes Backpack Pen Mug --out sweeps/ \\
        --lrs 2e-3 5e-3 --shots 5 15 --adjustors scale gate --seeds 0 1
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import itertools
import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence

import torch

log = logging.getLogger("tapclip_tpu_torch")


def run_sweep(
    clip_params,
    clip_cfg,
    *,
    data_root: str,
    class_names: Sequence[str],
    base_prompt_cfg,
    base_train_cfg,
    tokenizer=None,
    lrs: Sequence[float] = (2e-3,),
    shots: Sequence[int] = (5,),
    adjustors: Sequence[str] = ("scale",),
    prompt_lens: Sequence[int] = (5,),
    seeds: Sequence[int] = (0,),
    epochs: Optional[int] = None,
    verbose: bool = False,
) -> List[Dict]:
    """Run the grid; one result row per cell, in grid order."""
    from tapclip_tpu_torch.data.imagefolder import ImageFolderIndex, few_shot_split
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.trainer import PathFeatureCache, fit_prompt_model

    # Check the grid before any training: a bad axis value must not throw
    # away completed cells mid-grid.
    bad_shots = [n for n in shots if n <= 0]
    if bad_shots:
        raise ValueError(f"shots={bad_shots}: zero-shot cells don't belong in a tuning sweep (every cell trains; "
                         "use zero_shot_eval for 0-shot rows)")
    index = ImageFolderIndex.scan(data_root)
    # One tower pass for the whole sweep: the cache is keyed by image path and
    # the tower is frozen, so every cell gathers from the same features.
    probe = FullModel(list(class_names), clip_params, clip_cfg, prompt_cfg=base_prompt_cfg, tokenizer=tokenizer)
    cache = PathFeatureCache(probe)

    rows: List[Dict] = []
    grid = list(itertools.product(lrs, shots, adjustors, prompt_lens, seeds))
    log.info("sweep: %d cells over %d classes (%s)", len(grid), len(class_names), data_root)
    for ci, (lr, n_shots, adjustor, p_len, seed) in enumerate(grid):
        pcfg = dataclasses.replace(base_prompt_cfg, adjustor_method=adjustor, prompt_len=p_len)
        tcfg = dataclasses.replace(base_train_cfg, lr=lr, num_shots=n_shots, seed=seed)
        model = FullModel(list(class_names), clip_params, clip_cfg, prompt_cfg=pcfg, tokenizer=tokenizer,
                          generator=torch.Generator().manual_seed(seed))
        split = few_shot_split(index, list(class_names), n_shots, seed=seed)
        t0 = time.perf_counter()
        result = fit_prompt_model(model, cache.gather(split.train), cache.gather(split.val), tcfg, epochs=epochs,
                                  verbose=verbose)
        row = {"lr": lr, "shots": n_shots, "adjustor": adjustor, "prompt_len": p_len, "seed": seed,
               "best_acc": round(result.best_acc, 4), "epochs_run": result.epochs_run,
               "wall_s": round(time.perf_counter() - t0, 2)}
        rows.append(row)
        log.info("[%d/%d] %s", ci + 1, len(grid), row)
    return rows


def write_artifacts(rows: List[Dict], out_dir: str) -> Dict:
    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "sweep.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    best = max(rows, key=lambda r: r["best_acc"])
    with open(os.path.join(out_dir, "best.json"), "w") as f:
        json.dump(best, f, indent=2)
    return {"csv": csv_path, "best": best, "n_cells": len(rows)}


def main(argv: Optional[List[str]] = None) -> Dict:
    from tapclip_tpu_torch.config import MODEL_PRESETS, ExperimentConfig, preset

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-root", required=True)
    p.add_argument("--classes", nargs="+", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--model", default="ViT-B-16", choices=sorted(MODEL_PRESETS))
    p.add_argument("--preset", default=None, help="experiment preset ('tiny' for tests); overrides --model")
    p.add_argument("--pretrained", default=None, help="open_clip .pt/.bin state dict (random weights if unset)")
    p.add_argument("--bpe-path", default=None)
    p.add_argument("--lrs", type=float, nargs="+", default=[2e-3])
    p.add_argument("--shots", type=int, nargs="+", default=[5])
    p.add_argument("--adjustors", nargs="+", default=["scale"], choices=["scale", "gate", "residual"])
    p.add_argument("--prompt-lens", type=int, nargs="+", default=[5])
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    ecfg = preset(args.preset) if args.preset else ExperimentConfig(model=MODEL_PRESETS[args.model])
    if args.pretrained:
        ecfg = dataclasses.replace(ecfg, pretrained_path=args.pretrained)
    classes = args.classes or list(ecfg.class_names)

    from tapclip_tpu_torch.data.tokenizer import get_tokenizer
    from tapclip_tpu_torch.featurize import load_clip_params

    params = load_clip_params(ecfg.model, ecfg.pretrained_path, device=args.device)
    rows = run_sweep(params, ecfg.model, data_root=args.data_root, class_names=classes, base_prompt_cfg=ecfg.prompt,
                     base_train_cfg=ecfg.train, tokenizer=get_tokenizer(args.bpe_path, ecfg.model.context_length),
                     lrs=args.lrs, shots=args.shots, adjustors=args.adjustors, prompt_lens=args.prompt_lens,
                     seeds=args.seeds, epochs=args.epochs)
    out = write_artifacts(rows, args.out)
    log.info("sweep complete: %d cells -> %s (best: %s)", out["n_cells"], out["csv"], out["best"])
    return out


if __name__ == "__main__":
    main()
