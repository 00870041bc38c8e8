"""CLIP-Adapter: residual bottleneck adapters on frozen CLIP features.

Counterpart of ``tapclip_tpu/clip_adapter.py`` (Gao et al., 2021): a small
bias-free bottleneck MLP on the frozen tower's output, blended residually
into the feature,

    a(f) = relu(relu(f @ W1) @ W2)        (D -> D/r -> D)
    f'   = ratio * a(f) + (1 - ratio) * f   (then re-L2-normalized)

trained with cross-entropy against the frozen zero-shot classifier; a
text-side adapter of the same shape is the joint variant.  Training is
full-batch (AdamW on a cosine-decayed rate, ``linear_probe.fit_full_batch``);
the ratio search scores each cell from the same adapter.

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
without a card raises.

Usage:
    python -m tapclip_tpu_torch.clip_adapter --train-root .../Real_World \\
        --shots 16 --model ViT-B-16 --pretrained open_clip_pytorch_model.bin --ratio 0.2
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tapclip_tpu_torch.linear_probe import as_tensor, fit_full_batch

log = logging.getLogger("tapclip_tpu_torch")

Adapter = Dict[str, np.ndarray]


def init_adapter(dim: int, reduction: int = 4, seed: int = 0) -> Adapter:
    """Bias-free bottleneck ``{"w1": [D, D//r], "w2": [D//r, D]}``, He-style
    (``np.random.default_rng(seed)``: the JAX package's draw, bit for bit)."""
    hidden = max(1, dim // reduction)
    rng = np.random.default_rng(seed)
    return {
        "w1": (rng.standard_normal((dim, hidden)) * np.sqrt(2.0 / dim)).astype(np.float32),
        "w2": (rng.standard_normal((hidden, dim)) * np.sqrt(2.0 / hidden)).astype(np.float32),
    }


def apply_adapter(adapter, feats, ratio: float, device=None) -> torch.Tensor:
    """Residual-blend ``feats`` through the adapter -> re-normalized ``[N, D]``."""
    f = as_tensor(feats, device)
    a = torch.relu(torch.relu(f @ as_tensor(adapter["w1"], f.device)) @ as_tensor(adapter["w2"], f.device))
    out = ratio * a + (1.0 - ratio) * f
    return out / torch.linalg.norm(out, dim=-1, keepdim=True).clamp_min(1e-12)


def adapter_logits(img_feats, zs_classifier, logit_scale: float, visual: Optional[Adapter], ratio: float,
                   text: Optional[Adapter] = None, text_ratio: Optional[float] = None, device=None) -> torch.Tensor:
    """``[B, C]`` logits with the visual (and optionally text) adapter applied."""
    q = as_tensor(img_feats, device)
    t = as_tensor(zs_classifier, q.device)
    if visual is not None:
        q = apply_adapter(visual, q, ratio)
    if text is not None:
        t = apply_adapter(text, t, ratio if text_ratio is None else text_ratio)
    return logit_scale * q @ t.T


def fit_clip_adapter(
    train_feats,
    train_labels: np.ndarray,
    zs_classifier,
    logit_scale: float,
    *,
    ratio: float = 0.2,
    reduction: int = 4,
    text_adapter: bool = False,
    steps: int = 200,
    lr: float = 1e-3,
    weight_decay: float = 1e-2,
    seed: int = 0,
    device=None,
) -> Tuple[Adapter, Optional[Adapter]]:
    """Train the adapter(s) with cross-entropy on few-shot features ->
    ``(visual, text)`` NumPy weights; the towers, features and zero-shot
    classifier stay frozen."""
    X = as_tensor(train_feats, device)
    y = torch.as_tensor(np.asarray(train_labels), device=X.device).long()
    T = as_tensor(zs_classifier, X.device)
    init = {"visual": init_adapter(int(X.shape[-1]), reduction, seed)}
    if text_adapter:
        init["text"] = init_adapter(int(T.shape[-1]), reduction, seed + 1)
    names = [(side, w) for side in sorted(init) for w in ("w1", "w2")]

    def loss_fn(*leaves):
        p = {side: {} for side in init}
        for (side, w), leaf in zip(names, leaves):
            p[side][w] = leaf
        return F.cross_entropy(adapter_logits(X, T, logit_scale, p["visual"], ratio, p.get("text")), y)

    trained = fit_full_batch([as_tensor(init[side][w], X.device) for side, w in names], loss_fn, steps, lr,
                             weight_decay=weight_decay, decoupled=True)
    out = {side: {} for side in init}
    for (side, w), leaf in zip(names, trained):
        out[side][w] = leaf.cpu().numpy()
    return out["visual"], out.get("text")


def search_ratio(val_feats, val_labels: np.ndarray, zs_classifier, logit_scale: float, visual: Adapter,
                 ratios: Sequence[float] = (0.1, 0.2, 0.35, 0.5, 0.65, 0.8), text: Optional[Adapter] = None,
                 device=None) -> Tuple[float, float]:
    """Grid-search the blend ratio on held-out features -> ``(ratio, acc)``;
    the cells as f32 values, the first best wins."""
    y = torch.as_tensor(np.asarray(val_labels)).long()
    accs = []
    for r in np.asarray(ratios, np.float32):
        logits = adapter_logits(val_feats, zs_classifier, logit_scale, visual, float(r), text, float(r), device)
        accs.append((logits.argmax(-1).cpu() == y).float().mean())
    accs = torch.stack(accs).numpy()
    best = int(np.argmax(accs))
    return float(ratios[best]), float(accs[best])


def adapter_accuracy(feats, labels: np.ndarray, zs_classifier, logit_scale: float, visual: Optional[Adapter],
                     ratio: float, text: Optional[Adapter] = None, device=None) -> float:
    logits = adapter_logits(feats, zs_classifier, logit_scale, visual, ratio, text, device=device).cpu().numpy()
    return float((logits.argmax(-1) == np.asarray(labels)).mean())


def main(argv: Optional[List[str]] = None) -> dict:
    from tapclip_tpu_torch.tip_adapter import add_split_args, load_split

    p = add_split_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    p.add_argument("--ratio", type=float, default=0.2, help="residual blend weight of the adapter branch")
    p.add_argument("--reduction", type=int, default=4, help="bottleneck reduction factor (hidden = D // reduction)")
    p.add_argument("--text-adapter", action="store_true", help="also train a text-side adapter (joint variant)")
    p.add_argument("--search-ratio", action="store_true", help="grid-search the blend ratio on the eval features")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-2)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    _, _, class_names, logit_scale, zs, (Xtr, ytr), (Xva, yva) = load_split(args)
    dev = args.device
    log.info("clip-adapter: %d shots x %d classes, %d eval samples", args.shots, len(class_names), len(yva))
    result = {"zero_shot_acc": adapter_accuracy(Xva, yva, zs, logit_scale, None, 0.0, device=dev)}
    visual, text = fit_clip_adapter(Xtr, ytr, zs, logit_scale, ratio=args.ratio, reduction=args.reduction,
                                    text_adapter=args.text_adapter, steps=args.steps, lr=args.lr,
                                    weight_decay=args.weight_decay, seed=args.seed, device=dev)
    ratio = args.ratio
    if args.search_ratio:
        ratio, _ = search_ratio(Xva, yva, zs, logit_scale, visual, text=text, device=dev)
        log.info("clip-adapter: grid-searched ratio=%.2f", ratio)
    result.update(ratio=ratio, adapter_acc=adapter_accuracy(Xva, yva, zs, logit_scale, visual, ratio, text,
                                                            device=dev))
    for k, v in result.items():
        log.info("clip-adapter %s: %s", k, f"{100 * v:.2f}%" if k.endswith("acc") else v)
    return result


if __name__ == "__main__":
    main()
