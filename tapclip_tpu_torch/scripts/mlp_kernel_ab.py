"""A/B of the fused MLP half-block's variants (S2) on the card.

    python3 -m tapclip_tpu_torch.scripts.mlp_kernel_ab [--batch B] [--model NAME] [--reps N]

Counterpart of ``scripts/mlp_kernel_ab.py``: K1 (``ops/fused_mlp.py::
fused_mlp_block``, ``csrc/fused_mlp.cu``: the port of that script's
production kernel, the parent) against the variants of that script's
``main()``, each switch as its nearest counterpart on K1's own launches
(``fused_mlp_variant``, ``csrc/fused_mlp_variants.cu``):

* ``row_tile`` (rt512) -> 128-row tiles in both products instead of K1's 64
  (or 32); the schedule alone, so its output is K1's bit for bit;
* ``erf3`` -> the A&S 3-term erf in the fc epilogue; ``ln1pass`` -> var =
  E[x^2] - mean^2;
* ``ilv_chunks`` 2 / 4 -> the hidden dimension in 2 or 4 chunks: the fc of
  chunk j + 1 runs in one grid with the projection of chunk j, the f32
  partials summed in the TPU kernel's order.

``base`` is K1's configuration, run through the variant launcher (it must
equal the parent bit for bit, as must rt512).  At the model's vision widths
(default ViT-B/16, batch 8: rows 8 x 200, W 768, H 3,072), f32 and bf16, each
variant is held against the parent and against its own plain version, and
timed in turns with CUDA events; prints the card's name and power limit, then
one JSON line per dtype.
"""

from __future__ import annotations

import argparse
import json
import sys

from tapclip_tpu_torch.scripts._bench_util import ab, card_line, mlp_work, vit_layer

# The variants of scripts/mlp_kernel_ab.py::main: run_variant's keyword
# arguments (row_tile 256 is its default), plus "base" (no switch).
VARIANTS = {
    "base": {},
    "rt512": {"row_tile": 512},
    "erf3": {"erf3": True},
    "ln1pass": {"ln1pass": True},
    "ilv2": {"ilv_chunks": 2},
    "ilv4": {"ilv_chunks": 4},
    "ilv4_erf3": {"ilv_chunks": 4, "erf3": True},
}
# The variants whose output is K1's bit for bit: its own configuration and
# the larger tile (the schedule alone).
SCHEDULE_ONLY = ("base", "rt512")
REPLACES = "scripts/mlp_kernel_ab.py:62"


def port_flags(jax_kwargs: dict) -> dict:
    """fused_mlp_variant's switches for the JAX script's run_variant arguments."""
    return {"row_tile": 0 if jax_kwargs.get("row_tile", 256) == 256 else 128,
            "erf3": bool(jax_kwargs.get("erf3", False)),
            "ln1pass": bool(jax_kwargs.get("ln1pass", False)),
            "chunks": int(jax_kwargs.get("ilv_chunks", 1))}


def run(B: int = 8, model: str = "ViT-B-16", reps: int = 5, dtype=None, device: str = "cuda",
        seed: int = 0) -> dict:
    """The A/B table (see ``_bench_util.ab``) at one dtype."""
    import torch

    from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block, fused_mlp_reference, fused_mlp_variant
    from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_variant_reference

    x, _, _, ln, mlp = vit_layer(B, model, dtype or torch.float32, device, seed)
    p = (x, ln["scale"], ln["bias"], mlp["w_fc"], mlp["b_fc"], mlp["w_proj"], mlp["b_proj"])
    variants = {}
    for name, kw in VARIANTS.items():
        f = port_flags(kw)
        variants[name] = (lambda f=f: fused_mlp_variant(*p, **f), lambda f=f: fused_mlp_variant_reference(*p, **f),
                          tuple(sorted(f.items())))
    work = mlp_work(x, mlp["w_fc"].shape[-1])
    return ab((lambda: fused_mlp_block(x, ln, mlp), lambda: fused_mlp_reference(*p)), variants,
              parent_keys=tuple(variants[name][2] for name in SCHEDULE_ONLY), work=work, reps=reps)


def main(argv=None) -> int:
    import torch

    a = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    a.add_argument("--batch", type=int, default=8)
    a.add_argument("--model", default="ViT-B-16")
    a.add_argument("--reps", type=int, default=5)
    args = a.parse_args(argv)
    if not torch.cuda.is_available():
        print("mlp_kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        print(json.dumps(run(args.batch, args.model, args.reps, dtype)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
