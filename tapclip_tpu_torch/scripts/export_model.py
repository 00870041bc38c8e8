"""Export ahead-of-time model artifacts (``torch.export`` ``.pt2`` programs).

Counterpart of ``scripts/export_model.py``: the *computation* is exported
(``utils/model_export.py``), so a serving host runs the model with torch and
the ``tapclip`` op registrations, without the model code.  The forward
kernels stay in the programs as ``tapclip::`` ops: on the card they launch
the hand-written kernels, on the CPU their plain versions.

Usage (random weights, tiny preset, CPU):
    python -m tapclip_tpu_torch.scripts.export_model --preset tiny --device cpu \\
        --out /tmp/tapclip_export --batch 8 \\
        --functions encode_image encode_text classify full_forward

Real deployment (the card, converted open_clip weights, tuned prompts):
    python -m tapclip_tpu_torch.scripts.export_model --model ViT-B-16 \\
        --pretrained open_clip_pytorch_model.bin --ckpt results/.../prompts.pt \\
        --classes Backpack Pen Mug --batch 256 --out exports/vitb16_b256

``--pretrained`` takes an open_clip ``.bin``/``.pt`` state dict or a CLIP
tree ``.pt`` of the port; ``--ckpt`` a prompt ``.pt`` (the port's or a
reference one); an Orbax directory raises.  With ``classify`` in the
function set, the script also writes ``class_features.npz`` (adjusted text
features + logit scale + class mask + names) next to the artifacts:
everything the classify program needs at call time besides the tower
weights and pixels.

``--poly`` exports one batch-size-polymorphic artifact (forces
``attn_impl='xla'``, the plain composition: the kernels' exports are
static-shape).  ``--device`` takes the JAX script's ``--platform``; a
program is traced on that one device and moved at load time
(``load_exported(path, device=...)``).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

import numpy as np
import torch

log = logging.getLogger("tapclip_tpu_torch.export")


def build_argparser() -> argparse.ArgumentParser:
    from tapclip_tpu_torch.config import MODEL_PRESETS

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default=None, help="experiment preset ('tiny' for tests); overrides --model")
    p.add_argument("--model", default="ViT-B-16", choices=list(MODEL_PRESETS),
                   help="model preset when no --preset is given")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    p.add_argument("--pretrained", default=None, help="open_clip .bin/.pt or the port's CLIP tree .pt")
    p.add_argument("--ckpt", default=None, help="tuned prompt checkpoint (.pt: the port's or a reference one)")
    p.add_argument("--classes", nargs="+", default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--functions", nargs="+", default=["encode_image", "encode_text"],
                   choices=["encode_image", "encode_text", "classify", "full_forward"])
    p.add_argument("--out", required=True)
    p.add_argument("--poly", action="store_true", help="batch-polymorphic export (attn_impl=xla)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from tapclip_tpu_torch.config import MODEL_PRESETS, ExperimentConfig, preset
    from tapclip_tpu_torch.models.model_wrapper import text_features_with_attribution
    from tapclip_tpu_torch.train import build_model
    from tapclip_tpu_torch.utils import model_export as ME

    cfg = preset(args.preset) if args.preset else ExperimentConfig(model=MODEL_PRESETS[args.model])
    if args.classes:
        cfg = dataclasses.replace(cfg, class_names=tuple(args.classes))
    if args.pretrained:
        cfg = dataclasses.replace(cfg, pretrained_path=args.pretrained)
    if args.poly:
        cfg = dataclasses.replace(cfg, model=cfg.model.replace(attn_impl="xla"))

    model, _ = build_model(cfg, device=args.device)
    if args.ckpt:
        from tapclip_tpu_torch.utils.checkpoint import apply_prompt_checkpoint

        apply_prompt_checkpoint(model, args.ckpt)
        log.info("loaded tuned prompts from %s", args.ckpt)

    bank = model.prompt_learner.bank
    out = ME.export_model(
        args.out,
        model.clip_params,
        cfg.model,
        model.prompt_cfg,
        model.trainable,
        bank,
        batch=args.batch,
        functions=tuple(args.functions),
        symbolic_batch=args.poly,
    )
    for name, meta in ME.load_manifest(out)["functions"].items():
        log.info("  %-13s %8d bytes  device=%s  ops=%s", name, meta["bytes"], meta["device"],
                 ",".join(meta["tapclip_ops"]) or "-")

    if "classify" in args.functions:
        with torch.no_grad():
            feats, _ = text_features_with_attribution(
                model.clip_params, model.trainable["ctx"], bank, cfg.model, model.prompt_cfg,
                model.trainable["adjustor"],
            )
        npz = os.path.join(out, "class_features.npz")
        np.savez(
            npz,
            text_feats=feats.float().cpu().numpy(),
            logit_scale=np.float32(model.trainable["logit_scale"].item()),
            class_mask=bank.class_mask.cpu().numpy(),
            class_names=np.asarray(list(model.class_names)),
        )
        log.info("  class_features.npz: %d classes (capacity %d)", model.n_cls, bank.capacity)
    log.info("export complete: %s", out)
    return out


if __name__ == "__main__":
    main()
