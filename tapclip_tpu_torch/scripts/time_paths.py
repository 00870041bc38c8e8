"""Time the int8 image batch, the idiomatic prompt-tune step and the text tower of one checkout of the port.

    python3 tapclip_tpu_torch/scripts/time_paths.py [--root DIR] [--runs N] [--paths int8,idiomatic,text,split]

Imports ``tapclip_tpu_torch`` from the checkout at ``DIR`` (default: the one
holding this file), builds its kernels and ViT-B/16 with random weights from
seed 0, and prints one JSON line: the card's name and power limit, then
CUDA-event ms (mean of 20 calls after 3 warm-up calls, ``--runs`` readings
each) of

* the int8 tower's image batch of 8 (uint8 pixels in, ``encode_image`` with
  ``quantize_tower``: 12 B13 and 12 B14 launches and the weights quantized
  on every call), float32 and bfloat16, stochastic and round to nearest;
* one idiomatic (CoOp-style) prompt-tuning step on cached features (batch
  32, five classes in a bank of 8: 23 B6, one causal K3, 12 B7 and 12 B5
  launches), float32 and bfloat16; each call continues from the state the
  previous one returned;
* ``encode_text`` of a 64-text batch (random token ids at ``context_length``
  77, run at T 80 with the pad keys masked: 12 B6 and 12 K1 launches),
  float32 and bfloat16;
* one image batch of 8 with ``attn_impl="fused_split"`` (plain projections
  around B6 in every vision block: 12 B6 and 12 K1 launches), float32 and
  bfloat16.

``--paths`` times only the named ones (default: all four).

To compare two commits on one card, unpack both and run this file against
each in turn within one machine: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

CLASSES = ["Backpack", "Alarm_Clock", "Laptop", "Pen", "Mug"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--paths", default="int8,idiomatic,text,split")
    args = ap.parse_args()
    want = set(args.paths.split(","))
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_paths: needs a CUDA device", file=sys.stderr)
        return 1
    from tapclip_tpu_torch.config import VIT_B_16, PromptConfig, TrainConfig
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.parallel.train_step import init_train_state, make_optimizer, make_train_step
    from tapclip_tpu_torch.serve import build_model

    # This file's own helpers, whichever checkout the package comes from.
    sys.path.append(str(Path(__file__).resolve().parent))
    from _bench_util import card_line, time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    params = build_model(VIT_B_16, CLASSES, "cuda", seed=0).clip_params
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (8, VIT_B_16.image_size, VIT_B_16.image_size, 3),
                                           dtype=np.uint8)).cuda()
    feats = rng.standard_normal((32, VIT_B_16.embed_dim)).astype(np.float32)
    labels = rng.integers(0, len(CLASSES), 32)
    mask = np.ones(32, bool)
    pcfg = PromptConfig(text_mode="idiomatic")
    ids = torch.from_numpy(rng.integers(1, VIT_B_16.vocab_size - 1, (64, VIT_B_16.context_length))).cuda()
    ids[:, 20] = VIT_B_16.vocab_size - 1  # the EOT token (the largest id) the tower pools at
    readings = {}
    for dtype in ("float32", "bfloat16"):
        cfg = VIT_B_16.replace(dtype=dtype)
        split = cfg.replace(attn_impl="fused_split")
        with torch.inference_mode():
            for mode, det in (("stochastic", False), ("round-to-nearest", True)) if "int8" in want else ():
                cfg_q = cfg.replace(quantize_tower=True, int8_deterministic=det)
                readings[f"int8 image batch 8 {mode} {dtype}"] = [
                    time_ms(lambda: clip_model.encode_image(params, cfg_q, images), 20, 3) for _ in range(args.runs)]
            if "text" in want:
                readings[f"encode_text batch 64 {dtype}"] = [
                    time_ms(lambda: clip_model.encode_text(params, cfg, ids), 20, 3) for _ in range(args.runs)]
            if "split" in want:
                readings[f"fused_split image batch 8 {dtype}"] = [
                    time_ms(lambda: clip_model.encode_image(params, split, images), 20, 3) for _ in range(args.runs)]
        if "idiomatic" not in want:
            continue
        model = FullModel(CLASSES, params, cfg, prompt_cfg=pcfg)
        step = make_train_step(cfg, pcfg)
        holder = [init_train_state(model.trainable, make_optimizer(TrainConfig(batch_size=32)))]

        def one_step(step=step, model=model, holder=holder):
            holder[0] = step(params, holder[0], model.prompt_learner.bank, feats, labels, mask)[0]

        readings[f"idiomatic step batch 32 {dtype}"] = [time_ms(one_step, 20, 3) for _ in range(args.runs)]
    print(json.dumps({"root": args.root, "card": card_line(), "ms": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
