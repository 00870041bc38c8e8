"""Base-to-new generalization protocol (the CoOp/CoCoOp/KgCoOp benchmark).

Counterpart of ``tapclip_tpu/base_to_new.py``.  The dataset's classes are
split in half; prompts are trained few-shot on the BASE half only, then
the base and the NEW classes are evaluated separately and reported with
their harmonic mean H = 2*B*N/(B+N) (Zhou et al. 2022b §4.1).

Transfer under per-class prompts: the context is class-specific, so the new
classes get fresh template-initialised contexts (what ``add_class_prompt``
does for the reference's unseen class), while every class-agnostic leaf
that training touched (the adjustor, the logit scale and, when enabled, the
CoCoOp meta-net) transfers.  Base is reported on a held-out half of the
base validation pool, disjoint from the half that selects the early-stopped
state (:func:`split_selection_test`).

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
without a card raises.  ``main`` is :func:`parse`, then :func:`run` (the
readout and, with ``--out``, ``base_to_new.csv``).

Usage:
    python -m tapclip_tpu_torch.base_to_new --root .../Real_World --shots 16 \\
        --model ViT-B-16 --pretrained open_clip_pytorch_model.bin [--kg-lambda 1.0]
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

log = logging.getLogger("tapclip_tpu_torch")

# Class-agnostic trainable leaves that transfer from the base-trained model
# to the new-class model (the per-class ctx does not).
TRANSFER_KEYS = ("adjustor", "logit_scale", "meta_net")
CSV_COLUMNS = ["Base", "New", "H", "Shots", "KgLambda"]


def harmonic_mean(base_acc: float, new_acc: float) -> float:
    if base_acc + new_acc <= 0:
        return 0.0
    return 2.0 * base_acc * new_acc / (base_acc + new_acc)


def split_selection_test(val, seed: int = 0):
    """Disjoint, class-stratified ``(selection, test)`` halves of a val pool
    of ``(path, label)``, with the JAX package's permutations
    (``np.random.default_rng(seed)``, one per label in sorted order).  Early
    stopping selects on the first half; Base is evaluated on the second.  A
    single-sample class appears in both halves."""
    by_label: Dict[int, List] = {}
    for item in val:
        by_label.setdefault(item[1], []).append(item)
    rs = np.random.default_rng(seed)
    sel, test = [], []
    for label in sorted(by_label):
        items = by_label[label]
        perm = rs.permutation(len(items)).tolist()
        cut = max(1, len(items) // 2)
        test_idx = perm[cut:] if len(perm) > cut else perm[:cut]
        sel.extend(items[i] for i in perm[:cut])
        test.extend(items[i] for i in test_idx)
    return sel, test


def run_base_to_new(
    root: str,
    *,
    shots: int = 16,
    cfg=None,
    params=None,
    bpe_path: Optional[str] = None,
    batch_size: int = 64,
    epochs: int = 30,
    lr: float = 2e-3,
    kg_lambda: float = 0.0,
    class_split_seed: Optional[int] = None,
    seed: int = 0,
    verbose: bool = True,
) -> Dict[str, float]:
    """Train on the base half, evaluate both halves -> ``{Base, New, H,
    Shots, KgLambda}``.  ``params`` live on the device the run uses.

    ``class_split_seed=None`` splits alphabetically (the first half is
    base); an int shuffles the class list first.
    """
    from tapclip_tpu_torch.config import PromptConfig, TrainConfig
    from tapclip_tpu_torch.data.imagefolder import ImageFolderIndex, Loader, few_shot_split
    from tapclip_tpu_torch.data.tokenizer import get_tokenizer
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.trainer import fit_prompt_model
    from tapclip_tpu_torch.utils.eval_metrics import evaluate_accuracy

    index = ImageFolderIndex.scan(root)
    classes = list(index.classes)
    if len(classes) < 2:
        raise ValueError("base-to-new needs at least 2 classes")
    if class_split_seed is not None:
        rs = np.random.default_rng(class_split_seed)
        classes = [classes[i] for i in rs.permutation(len(classes))]
    half = (len(classes) + 1) // 2
    base, new = classes[:half], classes[half:]
    if verbose:
        log.info("base-to-new: %d base / %d new classes, %d shots", len(base), len(new), shots)

    tokenizer = get_tokenizer(bpe_path)
    mk = dict(image_size=cfg.image_size)
    pcfg = PromptConfig(max_classes=max(8, half))

    def model_of(names):
        return FullModel(names, params, cfg, prompt_cfg=pcfg, tokenizer=tokenizer,
                         generator=torch.Generator().manual_seed(seed))

    split_b = few_shot_split(index, base, shots, seed=seed)
    val_sel, val_test = split_selection_test(split_b.val, seed=seed + 1)
    model = model_of(base)
    # ctx never transfers, so New can respond to training only through the
    # shared leaves: the trained set is ctx plus TRANSFER_KEYS, so a leaf
    # added there is trained as well as transferred.
    train_keys = ("ctx", *(k for k in TRANSFER_KEYS if k in model.trainable))
    fit = fit_prompt_model(
        model,
        Loader(split_b.train, batch_size, shuffle=True, seed=seed, **mk),
        Loader(val_sel, batch_size, shuffle=False, **mk),
        TrainConfig(lr=lr, epochs=epochs, batch_size=min(batch_size, 64), seed=seed, kg_lambda=kg_lambda),
        verbose=False,
        trainable_keys=train_keys,
    )
    model.trainable = fit.best_trainable
    base_acc = evaluate_accuracy(model, Loader(val_test, batch_size, shuffle=False, **mk), verbose=False)

    # New half: fresh template contexts, the trained class-agnostic leaves.
    split_n = few_shot_split(index, new, 0, seed=seed)
    model_new = model_of(new)
    model_new.trainable = dict(
        model_new.trainable,
        **{k: fit.best_trainable[k] for k in TRANSFER_KEYS if k in fit.best_trainable and k in model_new.trainable},
    )
    new_acc = evaluate_accuracy(model_new, Loader(split_n.val, batch_size, shuffle=False, **mk), verbose=False)

    out = {
        "Base": round(float(base_acc), 2),
        "New": round(float(new_acc), 2),
        "H": round(harmonic_mean(float(base_acc), float(new_acc)), 2),
        "Shots": shots,
        "KgLambda": kg_lambda,
    }
    if verbose:
        log.info("base-to-new: base %.2f%%, new %.2f%%, H %.2f", out["Base"], out["New"], out["H"])
    return out


def save_artifacts(rows: List[Dict], out_dir: str) -> str:
    """Append to ``base_to_new.csv`` under ``out_dir`` (one row per run; the
    header is written once), so successive runs into one directory gather
    their rows."""
    import pandas as pd

    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "base_to_new.csv")
    pd.DataFrame(rows, columns=CSV_COLUMNS).to_csv(csv_path, index=False, mode="a",
                                                   header=not os.path.exists(csv_path))
    return csv_path


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True, help="labeled ImageFolder")
    p.add_argument("--shots", type=int, default=16)
    p.add_argument("--model", default="ViT-B-16")
    p.add_argument("--preset", default=None)
    p.add_argument("--pretrained", default=None, help="open_clip .bin/.pt state dict")
    p.add_argument("--bpe-path", default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--kg-lambda", type=float, default=0.0)
    p.add_argument("--class-split-seed", type=int, default=None,
                   help="shuffle classes before halving (default: alphabetical)")
    p.add_argument("--out", default=None, help="artifact dir (csv)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    return p


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return build_argparser().parse_args(argv)


def run(args) -> Dict[str, float]:
    """The weights, :func:`run_base_to_new` and, with ``--out``, the CSV row."""
    from tapclip_tpu_torch.config import MODEL_PRESETS, preset
    from tapclip_tpu_torch.featurize import load_clip_params

    cfg = preset(args.preset).model if args.preset else MODEL_PRESETS[args.model]
    params = load_clip_params(cfg, args.pretrained, device=args.device)
    out = run_base_to_new(
        args.root, shots=args.shots, cfg=cfg, params=params, bpe_path=args.bpe_path, batch_size=args.batch_size,
        epochs=args.epochs, lr=args.lr, kg_lambda=args.kg_lambda, class_split_seed=args.class_split_seed,
        seed=args.seed,
    )
    if args.out:
        log.info("base-to-new artifact: %s", save_artifacts([out], args.out))
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    logging.basicConfig(level=logging.INFO)
    return run(parse(argv))


if __name__ == "__main__":
    main()
