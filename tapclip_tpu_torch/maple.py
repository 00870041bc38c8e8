"""MaPLe: multi-modal prompt learning (coupled text + vision prompts).

Counterpart of ``tapclip_tpu/maple.py`` (Khattak et al., CVPR 2023): deep
shared text prompts overwrite the context slots at text blocks 1..J-1, and
per-layer linear projections of the text prompts are inserted as vision
prompts at vision blocks 0..J-1 (``models/model_wrapper.py``).  The vision
tower sees trainable prompts, so image features are never cached: every
step runs the full image tower forward and backward (on the card, K1/K2
forward and B4/B5 backward at the image shape, T 197 + P) beside the text
tower's passes.  The trained state is ``FullModel.trainable["ctx"]`` and
``["maple"]``; ``--save`` writes the port's ``.pt`` prompt checkpoint
(``utils/checkpoint.py``), which carries both.

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
without a card raises.  ``main`` is :func:`parse`, then :func:`run`.

Usage:
    python -m tapclip_tpu_torch.maple --train-root .../Real_World --shots 16 \\
        --depth 3 --model ViT-B-16 --pretrained open_clip_pytorch_model.bin
"""

from __future__ import annotations

import argparse
import functools
import logging
import os
from typing import Dict, List, Optional

import torch

log = logging.getLogger("tapclip_tpu_torch")

MAPLE_KEYS = ("ctx", "maple")


def make_maple_train_step(clip_cfg, prompt_cfg, optimizer=None, mesh=None):
    """The raw-image train step over ``("ctx", "maple")``:
    ``step(clip_params, state, bank, images, labels, mask) -> (state,
    {"loss", "grad_norm"})``, AdamW in the state (``init_train_state(...,
    MAPLE_KEYS)``).  The CLIP weights require no gradient, so the towers'
    backward kernels compute dx only.  ``mesh``: the sharded step
    (``parallel/train_step.py``'s mesh form: each rank passes its rows)."""
    from tapclip_tpu_torch.parallel.train_step import make_train_step

    return make_train_step(clip_cfg, prompt_cfg, optimizer, trainable_keys=MAPLE_KEYS, use_image_feats=False,
                           mesh=mesh)


def fit_maple(
    model,
    train_loader,
    val_loader=None,
    *,
    epochs: int = 20,
    lr: float = 2e-3,
    weight_decay: float = 1e-4,
    patience: int = 0,
    verbose: bool = True,
) -> Dict:
    """Train ``ctx`` + ``maple`` on raw image batches: per-epoch validation
    accuracy, best-state tracking, optional patience (``fit_prompt_model``'s
    loop shape without the feature cache).  Returns ``{"best_acc",
    "best_trainable", "acc_history", "loss_history", "final_state"}``."""
    from tapclip_tpu_torch.parallel.train_step import init_train_state, snapshot
    from tapclip_tpu_torch.utils.eval_metrics import evaluate_accuracy

    if model.prompt_cfg.maple_depth <= 0:
        raise ValueError("fit_maple requires PromptConfig.maple_depth >= 1")
    optimizer = functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    state = init_train_state(model.trainable, optimizer, MAPLE_KEYS)
    model.trainable = state.params
    step = make_maple_train_step(model.clip_cfg, model.prompt_cfg)
    bank = model.prompt_learner.bank

    best_acc, best_trainable = 0.0, snapshot(state.params)
    acc_hist: List[float] = []
    loss_hist: List[float] = []
    patience_ctr = 0
    for epoch in range(1, epochs + 1):
        epoch_loss, n_batches = 0.0, 0
        for images, labels, mask in train_loader:
            state, metrics = step(model.clip_params, state, bank, images, labels, mask)
            epoch_loss += float(metrics["loss"])
            n_batches += 1
        avg_loss = epoch_loss / max(n_batches, 1)
        loss_hist.append(avg_loss)
        if val_loader is not None:
            acc = evaluate_accuracy(model, val_loader, verbose=False)
            acc_hist.append(acc)
            if verbose:
                log.info("[Epoch %d] \U0001f3cb️ Avg Train Loss: %.4f", epoch, avg_loss)
                log.info("[Epoch %d] \U0001f9ea Val Accuracy: %.2f%%", epoch, acc)
            if acc > best_acc:
                best_acc, best_trainable = acc, snapshot(state.params)
                patience_ctr = 0
            else:
                patience_ctr += 1
                if patience and patience_ctr >= patience:
                    break
        elif verbose:
            log.info("[Epoch %d] \U0001f3cb️ Avg Train Loss: %.4f", epoch, avg_loss)
    if val_loader is None:
        best_trainable = snapshot(state.params)
        best_acc = float("nan")
    return {"best_acc": best_acc, "best_trainable": best_trainable, "acc_history": acc_hist,
            "loss_history": loss_hist, "final_state": state}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train-root", required=True, help="ImageFolder (few-shot source)")
    p.add_argument("--val-root", default=None)
    p.add_argument("--shots", type=int, default=16)
    p.add_argument("--depth", type=int, default=3, help="MaPLe prompt depth J")
    p.add_argument("--prompt-len", type=int, default=2, help="tokens per prompt (the paper uses short contexts)")
    p.add_argument("--model", default="ViT-B-16")
    p.add_argument("--preset", default=None)
    p.add_argument("--pretrained", default=None, help="open_clip .bin/.pt state dict")
    p.add_argument("--bpe-path", default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--patience", type=int, default=0)
    p.add_argument("--save", default=None, help="prompt checkpoint (.pt) for the best state")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    return p


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return build_argparser().parse_args(argv)


def run(args) -> dict:
    """The model, the split, ``fit_maple`` and the checkpoint."""
    from tapclip_tpu_torch.config import MODEL_PRESETS, PromptConfig, preset
    from tapclip_tpu_torch.data.imagefolder import ImageFolderIndex, Loader, eval_samples, few_shot_split
    from tapclip_tpu_torch.data.tokenizer import get_tokenizer
    from tapclip_tpu_torch.featurize import load_clip_params
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.utils.checkpoint import _orbax_refused, save_prompt_checkpoint
    from tapclip_tpu_torch.utils.eval_metrics import evaluate_accuracy

    if args.save and os.path.isdir(args.save):
        raise _orbax_refused(args.save)
    cfg = preset(args.preset).model if args.preset else MODEL_PRESETS[args.model]
    params = load_clip_params(cfg, args.pretrained, device=args.device)
    index = ImageFolderIndex.scan(args.train_root)
    class_names = index.classes
    split = few_shot_split(index, class_names, args.shots, seed=args.seed)
    val_samples = eval_samples(index, args.val_root, split)
    prompt_cfg = PromptConfig(maple_depth=args.depth, prompt_len=args.prompt_len,
                              max_classes=max(8, len(class_names)))
    model = FullModel(class_names, params, cfg, prompt_cfg=prompt_cfg,
                      tokenizer=get_tokenizer(args.bpe_path, cfg.context_length),
                      generator=torch.Generator().manual_seed(args.seed))
    mk = dict(image_size=cfg.image_size, output_dtype="uint8")
    train_loader = Loader(split.train, args.batch_size, shuffle=True, seed=args.seed, **mk)
    val_loader = Loader(val_samples, args.batch_size, shuffle=False, **mk)

    acc0 = evaluate_accuracy(model, val_loader, verbose=False)
    log.info("maple: depth=%d, %d shots x %d classes, init acc %.2f%%", args.depth, args.shots, len(class_names),
             acc0)
    res = fit_maple(model, train_loader, val_loader, epochs=args.epochs, lr=args.lr,
                    weight_decay=args.weight_decay, patience=args.patience)
    model.trainable = res["best_trainable"]
    out = {"init_acc": acc0, "best_acc": res["best_acc"], "loss_history": res["loss_history"],
           "acc_history": res["acc_history"]}
    if args.save:
        final = res["final_state"]
        out["checkpoint"] = save_prompt_checkpoint(
            args.save, trainable=model.trainable, bank=model.prompt_learner.bank,
            class_names=list(model.class_names), opt_state=final.opt_state(), step=final.step,
            extra_meta={"best_acc": res["best_acc"], "maple_depth": args.depth},
        )
    log.info("maple: init %.2f%% -> best %.2f%%", acc0, res["best_acc"])
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    logging.basicConfig(level=logging.INFO)
    return run(parse(argv))


if __name__ == "__main__":
    main()
