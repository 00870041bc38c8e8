"""Linear-probe evaluation: multinomial logistic regression on frozen CLIP
features.

Counterpart of ``tapclip_tpu/linear_probe.py``, the third leg of the CLIP
evaluation protocol (zero-shot / linear probe / fine-tune).  Features are
extracted once through the frozen tower, then the probe trains full-batch:
``steps`` Adam steps of ``[N, D] x [D, C]`` on the device, the learning
rate on optax's cosine decay.

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
without a card raises.

Usage:
    python -m tapclip_tpu_torch.linear_probe --train-root data/.../Real_World \\
        --val-root data/.../Clipart --model ViT-B-16 --pretrained open_clip_pytorch_model.bin
"""

from __future__ import annotations

import argparse
import logging
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

log = logging.getLogger("tapclip_tpu_torch")


def cosine_lr(lr: float, steps: int, t: int) -> float:
    """optax's ``cosine_decay_schedule(lr, steps)`` at count ``t`` (the count
    before the step increments it): ``lr * (1 + cos(pi * min(t, steps) /
    steps)) / 2``."""
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(t, steps) / steps))


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` as an f32 tensor on ``device`` (default: its own, or the CPU)."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x, np.float32))
    return t.to(device=device if device is not None else t.device, dtype=torch.float32)


def fit_full_batch(params: List[torch.Tensor], loss_fn, steps: int, lr: float, *, weight_decay: float = 0.0,
                   decoupled: bool = False) -> List[torch.Tensor]:
    """``steps`` full-batch steps of Adam (``decoupled``: AdamW with
    ``weight_decay``) on the cosine-decayed ``lr``, as optax's
    ``adam``/``adamw`` over ``cosine_decay_schedule``.  Updates ``params``
    (leaf tensors) in place and returns them."""
    params = [p.detach().clone().requires_grad_(True) for p in params]
    if decoupled:
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for t in range(steps):
        opt.param_groups[0]["lr"] = cosine_lr(lr, steps, t)
        grads = torch.autograd.grad(loss_fn(*params), params)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
    return [p.detach() for p in params]


def fit_linear_probe(
    features,
    labels,
    num_classes: int,
    *,
    steps: int = 500,
    lr: float = 0.1,
    weight_decay: float = 1e-4,
    seed: int = 0,
    device=None,
    w0=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Train ``softmax(features @ W + b)`` full-batch -> ``(W [D, C], b [C])``.

    Cross-entropy + ``weight_decay * sum(W^2)``, cosine-decayed Adam.  ``W0 =
    0.01 * N(0, 1)`` is drawn from a CPU generator seeded with ``seed``
    unless ``w0`` is given (the draw is apart from the fit, so a caller can
    pass another package's draw).
    """
    X = as_tensor(features, device)
    y = torch.as_tensor(np.asarray(labels), device=X.device).long()
    D = X.shape[1]
    if w0 is None:
        w0 = 0.01 * torch.randn((D, num_classes), generator=torch.Generator().manual_seed(seed))
    W0 = as_tensor(w0, X.device)

    def loss_fn(W, b):
        return F.cross_entropy(X @ W + b, y) + weight_decay * (W * W).sum()

    W, b = fit_full_batch([W0, torch.zeros(num_classes, device=X.device)], loss_fn, steps, lr)
    return W.cpu().numpy(), b.cpu().numpy()


def probe_accuracy(features: np.ndarray, labels: np.ndarray, W: np.ndarray, b: np.ndarray) -> float:
    pred = np.argmax(features.astype(np.float32) @ W + b, axis=-1)
    return float((pred == np.asarray(labels)).mean())


def _extract(cfg, params, root: str, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Frozen-tower features (f32, unit rows) + labels for an ImageFolder tree."""
    from tapclip_tpu_torch.data.imagefolder import ImageFolderIndex

    index = ImageFolderIndex.scan(root)
    return extract_samples(cfg, params, index.samples, batch_size)


def extract_samples(cfg, params, samples, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Frozen-tower features (f32 of the float16 unit rows ``featurize``
    stores) + labels for a list of ``(path, label)``; uint8 transport."""
    from tapclip_tpu_torch.data.imagefolder import Loader
    from tapclip_tpu_torch.featurize import featurize_images

    loader = Loader(samples, batch_size, shuffle=False, image_size=cfg.image_size, output_dtype="uint8")
    feats = featurize_images(params, cfg, iter(loader))
    return feats.astype(np.float32), np.asarray([lb for _, lb in samples], np.int32)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train-root", required=True, help="ImageFolder (train)")
    p.add_argument("--val-root", default=None, help="ImageFolder (eval; default: train accuracy only)")
    p.add_argument("--model", default="ViT-B-16")
    p.add_argument("--preset", default=None)
    p.add_argument("--pretrained", default=None, help="open_clip .bin/.pt state dict")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from tapclip_tpu_torch.config import MODEL_PRESETS, preset
    from tapclip_tpu_torch.featurize import load_clip_params

    cfg = preset(args.preset).model if args.preset else MODEL_PRESETS[args.model]
    params = load_clip_params(cfg, args.pretrained, device=args.device)
    Xtr, ytr = _extract(cfg, params, args.train_root, args.batch_size)
    n_cls = int(ytr.max()) + 1
    log.info("probe: %d train features (%d classes, dim %d)", len(ytr), n_cls, Xtr.shape[1])
    W, b = fit_linear_probe(Xtr, ytr, n_cls, steps=args.steps, lr=args.lr, weight_decay=args.weight_decay,
                            device=args.device)
    result = {"train_acc": probe_accuracy(Xtr, ytr, W, b)}
    log.info("linear-probe train accuracy: %.2f%%", 100 * result["train_acc"])
    if args.val_root:
        Xva, yva = _extract(cfg, params, args.val_root, args.batch_size)
        result["val_acc"] = probe_accuracy(Xva, yva, W, b)
        log.info("linear-probe val accuracy: %.2f%%", 100 * result["val_acc"])
    return result


if __name__ == "__main__":
    main()
