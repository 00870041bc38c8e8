"""Training driver: few-shot prompt tuning on one domain from files.

Counterpart of ``tapclip_tpu/train.py`` (the reference's ``train.py``): an
ImageFolder tree in, per-epoch validation accuracy, greedy best-state early
stopping, periodic checkpoints (``--save-every``, resumable with
``--resume``), the best prompts as a checkpoint, the accuracy curve, the
attribution chart, ``history.json`` and, on request, the confusion matrix
and a fitted temperature (``calibration.json``, read by ``serve
--temperature``).  The frozen image tower runs once per split (features
cached); every epoch trains the prompts over the cached features.

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
without a card raises.  ``main`` is :func:`parse`, then :func:`run` (every
artifact but the plots), then :func:`write_plots`.

Usage:
    python -m tapclip_tpu_torch.train --data-root data/OfficeHome/Real_World \\
        --pretrained open_clip_pytorch_model.bin --num-shots 5
    python -m tapclip_tpu_torch.train --preset tiny --synthetic-data --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from tapclip_tpu_torch import NotPortedError
from tapclip_tpu_torch.config import MODEL_PRESETS, ExperimentConfig, preset


def build_argparser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--preset", default="reference_train", help="experiment preset")
    p.add_argument("--model", default=None, choices=list(MODEL_PRESETS), help="CLIP variant")
    p.add_argument("--data-root", default=None)
    p.add_argument("--classes", nargs="+", default=None)
    p.add_argument("--pretrained", default=None, help="open_clip .bin/.pt state dict")
    p.add_argument("--bpe-path", default=None, help="CLIP BPE merges file")
    p.add_argument("--prompt-len", type=int, default=None)
    p.add_argument("--adjustor", default=None, choices=["scale", "gate", "residual"])
    p.add_argument("--text-mode", default=None, choices=["ref_compat", "idiomatic"])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--patience", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--kg-lambda", type=float, default=None, help="KgCoOp weight (not yet ported: 0 only)")
    p.add_argument("--prograd-lambda", type=float, default=None, help="ProGrad weight (not yet ported: 0 only)")
    p.add_argument("--scl-lambda", type=float, default=None, help="PromptSRC weight (not yet ported: 0 only)")
    p.add_argument("--anchor-templates", nargs="+", default=None, metavar="TPL",
                   help="PromptSRC anchor templates (used by the lambdas above)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-shots", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--version", default=None)
    p.add_argument("--output-root", default=None)
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    p.add_argument("--synthetic-data", action="store_true",
                   help="generate a synthetic ImageFolder (smoke runs)")
    p.add_argument("--profile-dir", default=None, help="torch.profiler trace dir (trace.json)")
    p.add_argument("--confusion", action="store_true",
                   help="write a validation confusion matrix (csv + heatmap PNG) for the best model")
    p.add_argument("--calibrate", action="store_true",
                   help="fit a softmax temperature on the validation set and report ECE before/after")
    p.add_argument("--resume", default=None,
                   help="prompt checkpoint (.pt) to resume from: prompt params, optimizer state, "
                        "step and epoch (the shuffle continues)")
    p.add_argument("--save-every", type=int, default=0,
                   help="snapshot params + optimizer state every N epochs (resume with --resume)")
    p.add_argument("--keep-last-n", type=int, default=2, help="retain the N most recent periodic snapshots")
    p.add_argument("--keep-best-n", type=int, default=0, help="also retain the N best-by-val-accuracy snapshots")
    p.add_argument("--async-save", action="store_true",
                   help="write periodic snapshots on a background thread")
    p.add_argument("--uint8-transfer", action="store_true",
                   help="ship uint8 pixels host->device and normalize on the device (bit-identical)")
    return p


def apply_overrides(cfg: ExperimentConfig, args) -> ExperimentConfig:
    model = MODEL_PRESETS[args.model] if args.model else cfg.model
    if args.dtype:
        model = model.replace(dtype=args.dtype)
    prompt = cfg.prompt
    for field, arg in [("prompt_len", args.prompt_len), ("adjustor_method", args.adjustor),
                       ("text_mode", args.text_mode)]:
        if arg is not None:
            prompt = dataclasses.replace(prompt, **{field: arg})
    train = cfg.train
    for field, arg in [("epochs", args.epochs), ("patience", args.patience),
                       ("lr", args.lr), ("weight_decay", args.weight_decay),
                       ("batch_size", args.batch_size), ("num_shots", args.num_shots),
                       ("seed", args.seed), ("kg_lambda", args.kg_lambda),
                       ("prograd_lambda", args.prograd_lambda),
                       ("scl_lambda", args.scl_lambda),
                       ("anchor_templates",
                        tuple(args.anchor_templates) if args.anchor_templates is not None else None)]:
        if arg is not None:
            train = dataclasses.replace(train, **{field: arg})
    for name in ("kg_lambda", "prograd_lambda", "scl_lambda"):
        if getattr(train, name) > 0.0:
            raise NotPortedError(f"--{name.replace('_', '-')} > 0")
    return dataclasses.replace(
        cfg,
        model=model,
        prompt=prompt,
        train=train,
        class_names=tuple(args.classes) if args.classes else cfg.class_names,
        data_root=args.data_root or cfg.data_root,
        pretrained_path=args.pretrained or cfg.pretrained_path,
        version=args.version or cfg.version,
        output_root=args.output_root or cfg.output_root,
    )


def build_model(cfg: ExperimentConfig, *, bpe_path: Optional[str] = None, rng_seed: int = 0, device="cuda"):
    """(FullModel, preprocess fn) on ``device``: open_clip weights from
    ``cfg.pretrained_path`` (a ``.pt``/``.bin`` state dict), else random
    weights drawn from ``rng_seed``."""
    from tapclip_tpu_torch.data.preprocess import make_preprocess
    from tapclip_tpu_torch.data.tokenizer import get_tokenizer
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.models.model_wrapper import FullModel

    log = logging.getLogger("tapclip_tpu_torch")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is present")
    if cfg.pretrained_path:
        from tapclip_tpu_torch.utils.torch_convert import load_openclip_checkpoint

        params = load_openclip_checkpoint(cfg.pretrained_path, cfg.model, device=dev)
        log.info("loaded pretrained CLIP weights from %s", cfg.pretrained_path)
    else:
        params = clip_model.init_clip_params(torch.Generator(device=dev).manual_seed(rng_seed), cfg.model,
                                             device=dev)
        log.warning("no --pretrained given: using RANDOM CLIP weights")
    tokenizer = get_tokenizer(bpe_path, cfg.model.context_length)
    if tokenizer.is_fallback:
        log.warning("BPE merge table not found (set --bpe-path or TAPCLIP_BPE_PATH); "
                    "using byte-level fallback tokenizer")
    model = FullModel(list(cfg.class_names), params, cfg.model, prompt_cfg=cfg.prompt, tokenizer=tokenizer,
                      generator=torch.Generator().manual_seed(cfg.train.seed))
    return model, make_preprocess(cfg.model.image_size)


def maybe_synthetic_root(cfg: ExperimentConfig, synthetic: bool) -> str:
    if not synthetic:
        return cfg.data_root
    from tapclip_tpu_torch.data.synthetic import build_imagefolder

    root = tempfile.mkdtemp(prefix="tapclip_synth_")
    build_imagefolder(root, list(cfg.class_names), per_class=24, image_size=cfg.model.image_size,
                      seed=cfg.train.seed)
    return root


def parse(argv: Optional[List[str]] = None) -> Tuple[argparse.Namespace, ExperimentConfig]:
    args = build_argparser(__doc__).parse_args(argv)
    return args, apply_overrides(preset(args.preset), args)


def run(args, cfg: ExperimentConfig) -> dict:
    """Every step of ``main`` but the plots: the output tree and log, the
    model, the loaders, the fit (periodic checkpoints), the best checkpoint,
    the attribution rows, the confusion csv and calibration, ``history.json``.
    Returns what :func:`write_plots` draws."""
    from tapclip_tpu_torch.data.imagefolder import get_dataloaders
    from tapclip_tpu_torch.models.model_wrapper import text_features_with_attribution
    from tapclip_tpu_torch.trainer import cache_features, evaluate_cached, fit_prompt_model
    from tapclip_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        restore_prompt_checkpoint,
        save_prompt_checkpoint,
    )
    from tapclip_tpu_torch.utils.logging_utils import generate_output_paths, maybe_profile, setup_logging

    paths = generate_output_paths(cfg.version, cfg.output_root)
    log = setup_logging(os.path.join(paths["log_dir"], f"{cfg.version}_train.log"))
    log.info("config: %s", cfg)

    model, preprocess = build_model(cfg, bpe_path=args.bpe_path, device=args.device)
    log.info("\U0001f527 Trainable Parameters:")
    for name in model.class_names:
        log.info(" - prompt_learner.context_bank.%s | shape: %s", name, tuple(model.trainable["ctx"].shape[1:]))

    data_root = maybe_synthetic_root(cfg, args.synthetic_data)
    train_loader, val_loader = get_dataloaders(
        data_root,
        list(cfg.class_names),
        batch_size=cfg.train.batch_size,
        num_shots=cfg.train.num_shots,
        preprocess=None if args.uint8_transfer else preprocess,
        seed=cfg.train.seed,
        image_size=cfg.model.image_size,
        output_dtype="uint8" if args.uint8_transfer else "float32",
    )
    if train_loader is None:  # zero-shot: one eval pass
        acc, _ = evaluate_cached(model, cache_features(model, val_loader))
        log.info("zero-shot accuracy: %.2f%%", acc)
        return {"best_acc": acc, "paths": paths}

    resume_state = None
    if args.resume:
        tree = restore_prompt_checkpoint(args.resume)
        resume_state = {"trainable": tree["trainable"], "opt_state": tree.get("opt_state"),
                        "step": tree["meta"].get("step", 0), "epoch": tree["meta"].get("epoch", 0)}
        log.info("resuming from %s (step %s, epoch %s)", args.resume, resume_state["step"], resume_state["epoch"])

    ckpt_mgr = CheckpointManager(os.path.join(paths["model_dir"], "checkpoints"), keep_last_n=args.keep_last_n,
                                 keep_best_n=args.keep_best_n, mode="max", async_save=args.async_save)

    def snapshot(epoch, state, metric=None):
        p = ckpt_mgr.save(step=int(state.step), trainable=state.params, bank=model.prompt_learner.bank,
                          class_names=model.class_names, opt_state=state.opt_state(), metric=metric,
                          extra_meta={"epoch": epoch})
        log.info("periodic checkpoint at epoch %d -> %s", epoch, p)

    with maybe_profile(args.profile_dir):
        result = fit_prompt_model(model, train_loader, val_loader, cfg.train, resume_state=resume_state,
                                  checkpoint_cb=snapshot if args.save_every else None,
                                  checkpoint_every=args.save_every)
    ckpt_mgr.close()
    log.info("best val accuracy: %.2f%% (after %d epochs)", result.best_acc, result.epochs_run)

    model.trainable = result.best_trainable
    ckpt_path = os.path.join(paths["model_dir"], f"best_model_{cfg.version}_acc{result.best_acc:.2f}.pt")
    final = result.final_state
    save_prompt_checkpoint(
        ckpt_path,
        trainable=result.best_trainable,
        bank=model.prompt_learner.bank,
        class_names=model.class_names,
        opt_state=final.opt_state() if final else None,
        step=final.step if final else result.epochs_run,
        extra_meta={"best_acc": result.best_acc, "preset": args.preset},
    )
    log.info("\U0001f4e6 Model saved: %s", ckpt_path)

    with torch.inference_mode():
        _, attribution = text_features_with_attribution(
            model.clip_params, model.trainable["ctx"], model.prompt_learner.bank, cfg.model, cfg.prompt,
            model.trainable["adjustor"])
    out = {"best_acc": result.best_acc, "paths": paths, "ckpt": ckpt_path, "result": result,
           "decoder": train_loader.decoder, "version": cfg.version, "class_names": list(model.class_names),
           "attribution": attribution[: model.n_cls].float().cpu().numpy(), "confusion": None}

    if args.confusion or args.calibrate:
        # One val pass feeds both readouts.
        from tapclip_tpu_torch.utils.calibration import calibrate_from_logits, collect_logits

        logits, labels, vmask = collect_logits(model, val_loader)
        if args.confusion:
            from tapclip_tpu_torch.utils.eval_metrics import confusion_from_logits

            cm = confusion_from_logits(logits, labels, vmask, model.n_cls)
            cm_csv = os.path.join(paths["csv_dir"], f"{cfg.version}_confusion.csv")
            np.savetxt(cm_csv, cm, fmt="%d", delimiter=",", header=",".join(model.class_names), comments="")
            log.info("confusion matrix saved to %s", cm_csv)
            out["confusion"] = cm
        if args.calibrate:
            calib = calibrate_from_logits(logits, labels, vmask)
            log.info("calibration: T=%.3f  ECE %.4f -> %.4f (n=%d)", calib["temperature"], calib["ece_before"],
                     calib["ece_after"], calib["n"])
            with open(os.path.join(paths["csv_dir"], "calibration.json"), "w") as f:
                json.dump(calib, f, indent=2)

    with open(os.path.join(paths["csv_dir"], "history.json"), "w") as f:
        json.dump({"acc": result.acc_history, "loss": result.loss_history}, f, indent=2)
    return out


def write_plots(out: dict) -> dict:
    """The accuracy curve, the attribution chart and (with ``--confusion``)
    the confusion heatmap of a :func:`run` (matplotlib)."""
    from tapclip_tpu_torch.utils.plotting import save_accuracy_curve, save_attribution_chart, save_confusion_matrix

    if "result" not in out:  # zero-shot: nothing to draw
        return out
    log = logging.getLogger("tapclip_tpu_torch")
    plot_dir, version, result = out["paths"]["plot_dir"], out["version"], out["result"]
    plot_path = os.path.join(plot_dir, f"{version}_acc_curve_acc{result.best_acc:.2f}.png")
    save_accuracy_curve(result.acc_history, result.per_class_history, plot_path)
    log.info("\U0001f4ca Accuracy plot saved to %s", plot_path)
    attr_path = save_attribution_chart(out["attribution"], out["class_names"],
                                       os.path.join(plot_dir, f"{version}_attribution.png"))
    log.info("attribution chart saved to %s", attr_path)
    if out["confusion"] is not None:
        cm_png = save_confusion_matrix(out["confusion"], out["class_names"],
                                       os.path.join(plot_dir, f"{version}_confusion.png"))
        log.info("confusion heatmap saved to %s", cm_png)
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    args, cfg = parse(argv)
    return write_plots(run(args, cfg))


if __name__ == "__main__":
    main()
