"""Tip-Adapter: training-free few-shot adaptation via a cache model.

Counterpart of ``tapclip_tpu/tip_adapter.py`` (Zhang et al., ECCV 2022): the
few-shot training features are the cache's keys (L2-normalized), their
one-hot labels its values, and a kernel-weighted cache readout is blended
into the zero-shot logits:

    logits = logit_scale * q @ W_zs.T + alpha * exp(-beta * (1 - q @ keys.T)) @ values

Tip-Adapter-F fine-tunes the keys (a bias-free linear layer) with
cross-entropy on the same shots.  Everything after feature extraction is a
few products on ``[N_shots, D]`` matrices: the alpha/beta grid is scored
from one affinity matrix, and Tip-Adapter-F trains full-batch (AdamW on a
cosine-decayed rate, ``linear_probe.fit_full_batch``).

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
without a card raises.

Usage:
    python -m tapclip_tpu_torch.tip_adapter --train-root .../Real_World \\
        --shots 16 --model ViT-B-16 --pretrained open_clip_pytorch_model.bin --search-hp --finetune
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tapclip_tpu_torch.linear_probe import as_tensor, extract_samples, fit_full_batch

log = logging.getLogger("tapclip_tpu_torch")


def build_cache_model(features: np.ndarray, labels: np.ndarray, num_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Few-shot features/labels -> ``(keys [N, D] L2-normalized, values [N, C])``."""
    keys = np.asarray(features, np.float32)
    keys = keys / np.maximum(np.linalg.norm(keys, axis=-1, keepdims=True), 1e-12)
    values = np.eye(num_classes, dtype=np.float32)[np.asarray(labels, np.int64)]
    return keys, values


def tip_logits(img_feats, keys, values, zs_classifier, logit_scale: float, alpha: float, beta: float,
               device=None) -> torch.Tensor:
    """``[B, C]`` blended logits (all inputs L2-normalized on the feature dim)."""
    q = as_tensor(img_feats, device)
    clip_logits = logit_scale * q @ as_tensor(zs_classifier, q.device).T
    affinity = q @ as_tensor(keys, q.device).T
    return clip_logits + alpha * (torch.exp(-beta * (1.0 - affinity)) @ as_tensor(values, q.device))


def search_hyperparams(
    val_feats,
    val_labels: np.ndarray,
    keys,
    values,
    zs_classifier,
    logit_scale: float,
    alphas: Sequence[float] = (0.5, 1.0, 1.75, 2.5, 3.5, 5.0),
    betas: Sequence[float] = (1.0, 2.5, 4.0, 5.5, 7.0, 8.5),
    device=None,
) -> Tuple[float, float, float]:
    """Grid-search ``(alpha, beta)`` on held-out features -> ``(alpha, beta,
    val_accuracy)``.  The affinity and zero-shot logits are computed once;
    the cells are scored in the JAX package's order (alpha outer, beta
    inner, as f32 values) and the first best wins."""
    q = as_tensor(val_feats, device)
    y = torch.as_tensor(np.asarray(val_labels), device=q.device).long()
    V = as_tensor(values, q.device)
    clip_logits = logit_scale * q @ as_tensor(zs_classifier, q.device).T
    affinity = q @ as_tensor(keys, q.device).T  # [B, N]
    grid = np.asarray([(a, b) for a in alphas for b in betas], np.float32)
    accs = []
    for a, b in grid:
        logits = clip_logits + float(a) * (torch.exp(-float(b) * (1.0 - affinity)) @ V)
        accs.append((logits.argmax(-1) == y).float().mean())
    accs = torch.stack(accs).cpu().numpy()
    best = int(np.argmax(accs))
    return float(grid[best][0]), float(grid[best][1]), float(accs[best])


def fit_tip_adapter_f(
    keys,
    values,
    train_feats,
    train_labels: np.ndarray,
    zs_classifier,
    logit_scale: float,
    alpha: float,
    beta: float,
    *,
    steps: int = 200,
    lr: float = 1e-3,
    weight_decay: float = 1e-2,
    device=None,
) -> np.ndarray:
    """Tip-Adapter-F: fine-tune the cache keys with cross-entropy -> new keys
    ``[N, D]`` (values, the zero-shot classifier and the towers frozen)."""
    X = as_tensor(train_feats, device)
    y = torch.as_tensor(np.asarray(train_labels), device=X.device).long()
    V = as_tensor(values, X.device)
    clip_logits = logit_scale * X @ as_tensor(zs_classifier, X.device).T

    def loss_fn(K):
        return F.cross_entropy(clip_logits + alpha * (torch.exp(-beta * (1.0 - X @ K.T)) @ V), y)

    (K,) = fit_full_batch([as_tensor(keys, X.device)], loss_fn, steps, lr, weight_decay=weight_decay,
                          decoupled=True)
    return K.cpu().numpy()


def cache_accuracy(feats, labels: np.ndarray, keys, values, zs_classifier, logit_scale: float, alpha: float,
                   beta: float, device=None) -> float:
    logits = tip_logits(feats, keys, values, zs_classifier, logit_scale, alpha, beta, device).cpu().numpy()
    return float((logits.argmax(-1) == np.asarray(labels)).mean())


def add_split_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The tree, split and tower flags ``tip_adapter`` and ``clip_adapter`` share."""
    p.add_argument("--train-root", required=True, help="ImageFolder (few-shot source)")
    p.add_argument("--val-root", default=None, help="ImageFolder for eval (default: held-out split of train-root)")
    p.add_argument("--shots", type=int, default=16)
    p.add_argument("--model", default="ViT-B-16")
    p.add_argument("--preset", default=None)
    p.add_argument("--pretrained", default=None, help="open_clip .bin/.pt state dict")
    p.add_argument("--bpe-path", default=None)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--ensemble", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    return p


def load_split(args):
    """``(cfg, params, class_names, logit_scale, zs_classifier [C, E] np,
    (Xtr, ytr), (Xva, yva))`` for the split of ``args``."""
    from tapclip_tpu_torch.config import MODEL_PRESETS, preset
    from tapclip_tpu_torch.data.imagefolder import ImageFolderIndex, eval_samples, few_shot_split
    from tapclip_tpu_torch.data.tokenizer import get_tokenizer
    from tapclip_tpu_torch.featurize import load_clip_params
    from tapclip_tpu_torch.zero_shot import (
        DEFAULT_TEMPLATES,
        OPENAI_IMAGENET_TEMPLATES_SMALL,
        build_zero_shot_classifier,
    )

    cfg = preset(args.preset).model if args.preset else MODEL_PRESETS[args.model]
    params = load_clip_params(cfg, args.pretrained, device=args.device)
    logit_scale = float(np.exp(params["logit_scale"].float().cpu().numpy()))
    index = ImageFolderIndex.scan(args.train_root)
    class_names = index.classes
    split = few_shot_split(index, class_names, args.shots, seed=args.seed)
    val_samples = eval_samples(index, args.val_root, split)
    zs = build_zero_shot_classifier(
        params, cfg, class_names, get_tokenizer(args.bpe_path, cfg.context_length),
        templates=OPENAI_IMAGENET_TEMPLATES_SMALL if args.ensemble else DEFAULT_TEMPLATES,
    ).cpu().numpy()
    train = extract_samples(cfg, params, split.train, args.batch_size)
    val = extract_samples(cfg, params, val_samples, args.batch_size)
    return cfg, params, class_names, logit_scale, zs, train, val


def main(argv: Optional[List[str]] = None) -> dict:
    p = add_split_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=5.5)
    p.add_argument("--search-hp", action="store_true", help="grid-search alpha/beta on the eval features")
    p.add_argument("--finetune", action="store_true", help="Tip-Adapter-F: fine-tune the cache keys")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    _, _, class_names, logit_scale, zs, (Xtr, ytr), (Xva, yva) = load_split(args)
    dev = args.device
    log.info("tip-adapter: %d shots x %d classes, %d eval samples", args.shots, len(class_names), len(yva))
    keys, values = build_cache_model(Xtr, ytr, len(class_names))
    result = {"zero_shot_acc": cache_accuracy(Xva, yva, keys, values, zs, logit_scale, 0.0, 1.0, dev)}
    alpha, beta = args.alpha, args.beta
    if args.search_hp:
        alpha, beta, _ = search_hyperparams(Xva, yva, keys, values, zs, logit_scale, device=dev)
        log.info("tip-adapter: grid-searched alpha=%.2f beta=%.2f", alpha, beta)
    result.update(alpha=alpha, beta=beta,
                  tip_acc=cache_accuracy(Xva, yva, keys, values, zs, logit_scale, alpha, beta, dev))
    if args.finetune:
        keys_f = fit_tip_adapter_f(keys, values, Xtr, ytr, zs, logit_scale, alpha, beta, steps=args.steps,
                                   lr=args.lr, device=dev)
        result["tip_f_acc"] = cache_accuracy(Xva, yva, keys_f, values, zs, logit_scale, alpha, beta, dev)
    for k, v in result.items():
        log.info("tip-adapter %s: %s", k, f"{100 * v:.2f}%" if k.endswith("acc") else v)
    return result


if __name__ == "__main__":
    main()
