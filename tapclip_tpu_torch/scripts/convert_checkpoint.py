"""Convert checkpoints between the reference torch formats and tapclip_tpu_torch.

Counterpart of ``scripts/convert_checkpoint.py``, on ``.pt`` files where the
JAX script writes Orbax directories (an Orbax directory raises, as
``utils/checkpoint.py`` refuses it).

Usage:
  # open_clip CLIP weights (.bin/.pt) -> the port's CLIP tree (.pt), loadable
  # by every --pretrained
  python -m tapclip_tpu_torch.scripts.convert_checkpoint clip \\
      --src open_clip_pytorch_model.bin --model ViT-B-32 --dst converted/clip_vitb32.pt

  # reference FullModel prompt checkpoint (.pt, legacy or per-class layout)
  # -> the port's prompt checkpoint (.pt) usable by the drivers
  python -m tapclip_tpu_torch.scripts.convert_checkpoint prompt \\
      --src best_model_epoch27_acc99.71.pt --classes Backpack Alarm_Clock Laptop Pen \\
      --model ViT-B-32 --dst converted/prompts.pt

  # CLIP tree (.pt; pretrained / EMA / distilled / a soup) -> open_clip .bin,
  # loadable back into the torch ecosystem
  python -m tapclip_tpu_torch.scripts.convert_checkpoint export \\
      --src pretrain_out/clip_pretrained.pt --model ViT-B-16 --dst exported_model.bin

  # the port's prompt checkpoint -> reference .pt
  python -m tapclip_tpu_torch.scripts.convert_checkpoint prompt-export \\
      --src prompts.pt --dst reference_prompts.pt [--legacy]
"""

from __future__ import annotations

import argparse
import os


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count(v) for v in tree)
    return tree.numel()


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("clip", help="open_clip weights -> CLIP tree .pt")
    pc.add_argument("--src", required=True)
    pc.add_argument("--model", default="ViT-B-32")
    pc.add_argument("--dst", required=True)

    pe = sub.add_parser("export", help="CLIP tree .pt -> open_clip .bin")
    pe.add_argument("--src", required=True)
    pe.add_argument("--model", default="ViT-B-16")
    pe.add_argument("--dst", required=True)

    px = sub.add_parser("prompt-export", help="prompt checkpoint .pt -> reference .pt")
    px.add_argument("--src", required=True)
    px.add_argument("--dst", required=True)
    px.add_argument("--model", default="ViT-B-32", help=argparse.SUPPRESS)
    px.add_argument("--legacy", action="store_true",
                    help="write the stacked context_emb layout instead of per-class context_bank entries")

    pp = sub.add_parser("prompt", help="reference prompt checkpoint -> prompt checkpoint .pt")
    pp.add_argument("--src", required=True)
    pp.add_argument("--classes", nargs="+", required=True)
    pp.add_argument("--model", default="ViT-B-32")
    pp.add_argument("--prompt-len", type=int, default=5)
    pp.add_argument("--bpe-path", default=None)
    pp.add_argument("--dst", required=True)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import torch

    from tapclip_tpu_torch.config import MODEL_PRESETS, PromptConfig

    cfg = MODEL_PRESETS[args.model]

    if args.cmd == "clip":
        from tapclip_tpu_torch.utils.checkpoint import save_clip_tree
        from tapclip_tpu_torch.utils.torch_convert import load_openclip_checkpoint

        params = load_openclip_checkpoint(args.src, cfg)
        save_clip_tree(args.dst, params, cfg)
        print(f"converted {_count(params):,} params -> {args.dst}")
        return args.dst

    if args.cmd == "prompt-export":
        from tapclip_tpu_torch.utils.checkpoint import restore_prompt_checkpoint
        from tapclip_tpu_torch.utils.torch_convert import save_reference_prompt_checkpoint

        state = restore_prompt_checkpoint(os.path.abspath(args.src))
        names = state["meta"]["class_names"]
        save_reference_prompt_checkpoint(state["trainable"]["ctx"], names, args.dst, legacy=args.legacy)
        print(f"exported prompt checkpoint ({len(names)} classes, "
              f"{'legacy' if args.legacy else 'per-class'} layout) -> {args.dst}")
        return args.dst

    if args.cmd == "export":
        from tapclip_tpu_torch.utils.torch_convert import load_openclip_checkpoint, save_openclip_checkpoint

        params = load_openclip_checkpoint(args.src, cfg)
        save_openclip_checkpoint(params, cfg, args.dst)
        print(f"exported {_count(params):,} params -> {args.dst}")
        return args.dst

    # prompt checkpoint
    from tapclip_tpu_torch.data.tokenizer import get_tokenizer
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.utils.checkpoint import apply_prompt_checkpoint, save_prompt_checkpoint

    params = clip_model.init_clip_params(torch.Generator().manual_seed(0), cfg)
    model = FullModel(
        args.classes,
        params,
        cfg,
        prompt_cfg=PromptConfig(prompt_len=args.prompt_len, max_classes=max(8, len(args.classes))),
        tokenizer=get_tokenizer(args.bpe_path, cfg.context_length),
    )
    apply_prompt_checkpoint(model, args.src, args.classes)
    save_prompt_checkpoint(
        args.dst,
        trainable=model.trainable,
        bank=model.prompt_learner.bank,
        class_names=model.class_names,
        extra_meta={"source": os.path.abspath(args.src)},
    )
    print(f"converted prompt checkpoint ({len(args.classes)} classes) -> {args.dst}")
    return args.dst


if __name__ == "__main__":
    main()
