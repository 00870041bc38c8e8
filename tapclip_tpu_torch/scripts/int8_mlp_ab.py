"""A/B of the int8 MLP kernel's variants (S5) on the card.

    python3 -m tapclip_tpu_torch.scripts.int8_mlp_ab [--batch B] [--model NAME] [--reps N]

Counterpart of ``scripts/int8_mlp_ab.py``: B13 (``csrc/int8_mlp.cu``) in the
stochastic mode, as built (``erff``, ``v / s``) and with its two
compile-time variants, ``erf3`` (the A&S 3-term erf, |err| <= 2.5e-5) and
``recipmul`` (``v * (127 / amax)`` in place of the division), alone and
together, at the model's vision width (default ViT-B/16, batch 8: rows
8 x 200, W 768, H 3,072).  Each variant is held against the base output by
the norm-relative error (the same random draws, so the only differences are
the variant's roundings) and against its own plain version; the variants are
timed in turns (base, erf3, recipmul, both, repeated ``--reps`` times, CUDA
events) and the medians printed in one JSON line after the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

VARIANTS = {"base": {}, "erf3": {"erf3": True}, "recipmul": {"recipmul": True},
            "both": {"erf3": True, "recipmul": True}}


def _case(B: int, model: str, dtype, seed: int = 0):
    import torch

    from tapclip_tpu_torch.config import MODEL_PRESETS
    from tapclip_tpu_torch.ops.int8_mlp import quantize_mlp

    cfg = MODEL_PRESETS[model]
    W, H = cfg.vision_width, cfg.mlp_ratio * cfg.vision_width
    T = (cfg.vision_seq_len + 7) // 8 * 8
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    x = rn(B, T, W).to(dtype)
    ln = (1.0 + rn(W, s=0.1), rn(W, s=0.1))
    q = quantize_mlp({"w_fc": rn(W, H, s=W ** -0.5), "b_fc": rn(H, s=0.1),
                      "w_proj": rn(H, W, s=H ** -0.5), "b_proj": rn(W, s=0.1)})
    return x, ln, q


def run(B: int = 8, model: str = "ViT-B-16", reps: int = 5, dtype=None) -> dict:
    """Errors and median CUDA-event ms of each variant."""
    import torch

    from tapclip_tpu_torch.ops.int8_mlp import int8_mlp_cuda, int8_mlp_plain
    from tapclip_tpu_torch.scripts.int8_probe import time_ms

    dtype = dtype or torch.float32
    x, (gamma, beta), q = _case(B, model, dtype)
    out = {"shape": f"{x.shape[0]}x{x.shape[1]}x{x.shape[2]} H{q['w_fc'].shape[1]}",
           "dtype": str(dtype).replace("torch.", ""), "variants": {}}
    with torch.inference_mode():
        base = int8_mlp_cuda(x, gamma, beta, q).float()
        for name, flags in VARIANTS.items():
            got = int8_mlp_cuda(x, gamma, beta, q, **flags).float()
            plain = int8_mlp_plain(x, gamma, beta, q, **flags).float()
            torch.cuda.synchronize()
            out["variants"][name] = {
                "vs_base_rel_err": float((got - base).norm() / base.norm()),
                "vs_base_update_rel_err": float((got - base).norm() / (base - x.float()).norm()),
                "vs_plain_update_rel_err": float((got - plain).norm() / (plain - x.float()).norm()),
                "max_abs_err": float((got - plain).abs().max()),
                "plain_ms": time_ms(lambda: int8_mlp_plain(x, gamma, beta, q, **flags), 5, 1),
                "ms": [],
            }
        for _ in range(reps):
            for name, flags in VARIANTS.items():
                out["variants"][name]["ms"].append(
                    time_ms(lambda: int8_mlp_cuda(x, gamma, beta, q, **flags), 10, 2))
    for v in out["variants"].values():
        v["median_ms"] = statistics.median(v["ms"])
    base_ms = out["variants"]["base"]["median_ms"]
    for v in out["variants"].values():
        v["ratio"] = v["median_ms"] / base_ms
    return out


def main(argv=None) -> int:
    import torch

    from tapclip_tpu_torch.scripts.int8_probe import card_line

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--model", default="ViT-B-16")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_mlp_ab: needs a CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        print(json.dumps(run(args.batch, args.model, args.reps, dtype)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
