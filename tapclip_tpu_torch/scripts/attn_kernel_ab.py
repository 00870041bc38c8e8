"""A/B of the attention half-block's variants of ``scripts/attn_kernel_ab.py`` (S3) on the card.

    python3 -m tapclip_tpu_torch.scripts.attn_kernel_ab [--batch B] [--model NAME] [--reps N]

Counterpart of ``scripts/attn_kernel_ab.py``: that script's two kernels, run
by ``ops/fused_mha.py::attn_block_variant`` as configurations of K2's earlier
FMA core (``csrc/attn_core.cuh``), against the parent, the variant launcher
with no switch (``v0_default``'s configuration):

* ``make_variant_kernel`` (form "variant"): without ``perhead_qkv`` q, k and v
  are all rounded to the compute dtype; ``perhead_qkv`` keeps q, k f32 and
  the block's q, k, v in shared memory instead of K2's f32 workspace (refused
  where they do not fit: past T 256); ``softmax_opt`` False is the normalised
  softmax (exp, p / l before rounding: two passes over the keys), True K2's,
  "bf16" exp2 at bf16 width; ``ln_1pass``; ``group_heads``;
* ``make_interleaved_kernel`` (form "interleaved"): per head group the
  out-projection's partial sums in f32, reduced in group order by a second
  launch.

``group_heads`` counts heads per 128-lane step on the TPU (2 at head dim 64,
its default) and heads per block in the FMA core here (1 with no switch), so
the TPU's g becomes g * 64 / 128.  ``bB`` and ``vmem_mb`` have no
counterpart: those variants are reported ``same_as`` the one they equal.
K2 (``csrc/attn_block.cu``, the same function on the tensor cores since it
left the FMA core) is timed in the same turns as a column of its own
(``columns["k2"]``).  Prints the card's name and power limit, then one JSON
line per dtype.
"""

from __future__ import annotations

import argparse
import json
import sys

from tapclip_tpu_torch.scripts._bench_util import ab, attn_work, card_line, vit_layer

# name: (the JAX script's runner, its keyword arguments), from main() and
# the module docstring, plus one variant for each switch alone.
VARIANTS = {
    "v0_default": ("run_variant", {}),
    "v1_group256": ("run_variant", {"group_heads": 4}),
    "v2_ln1pass": ("run_variant", {"ln_1pass": True}),
    "v3_perhead_qkv": ("run_variant", {"perhead_qkv": True}),
    "v4_bb8": ("run_variant", {"bB": 8}),
    "smopt": ("run_variant", {"softmax_opt": True}),
    "smopt_bf16": ("run_variant", {"softmax_opt": "bf16"}),
    "bb8_ph_smopt": ("run_variant", {"bB": 8, "perhead_qkv": True, "softmax_opt": True, "vmem_mb": 48}),
    "bb8_ph_smopt_v64": ("run_variant", {"bB": 8, "perhead_qkv": True, "softmax_opt": True, "vmem_mb": 64}),
    "bb8_ph_smopt_v32": ("run_variant", {"bB": 8, "perhead_qkv": True, "softmax_opt": True, "vmem_mb": 32}),
    "interleaved": ("run_interleaved", {"group_heads": 2}),
}
REPLACES = {"run_variant": "scripts/attn_kernel_ab.py:175", "run_interleaved": "scripts/attn_kernel_ab.py:58"}
TPU_GROUP = 2  # run_variant's and run_interleaved's default group_heads (128 lanes / head dim 64)


def port_flags(runner: str, jax_kwargs: dict, n_heads: int) -> dict:
    """attn_block_variant's form and switches for the JAX script's arguments."""
    group = max(1, min(n_heads, jax_kwargs.get("group_heads", TPU_GROUP) * 64 // 128))
    if runner == "run_interleaved":
        return {"form": "interleaved", "group_heads": group}
    return {"form": "variant", "group_heads": group, "ln_1pass": bool(jax_kwargs.get("ln_1pass", False)),
            "perhead_qkv": bool(jax_kwargs.get("perhead_qkv", False)),
            "softmax_opt": jax_kwargs.get("softmax_opt", False)}



def run(B: int = 8, model: str = "ViT-B-16", reps: int = 5, dtype=None, device: str = "cuda",
        seed: int = 0) -> dict:
    """The A/B table (see ``_bench_util.ab``) at one dtype."""
    import torch

    from tapclip_tpu_torch.ops.fused_mha import (
        attn_block_reference,
        attn_block_variant,
        attn_block_variant_reference,
        fused_attn_block,
    )
    from tapclip_tpu_torch.scripts._bench_util import vit_shape

    _, valid, _, heads, _ = vit_shape(model)
    x, ln, attn, _, _ = vit_layer(B, model, dtype or torch.float32, device, seed)
    p = (ln["scale"], ln["bias"], *attn.values())
    variants = {}
    for name, (runner, kw) in VARIANTS.items():
        f = port_flags(runner, kw, heads)
        variants[name] = (lambda f=f: attn_block_variant(x, ln, attn, heads, valid, **f),
                          lambda f=f: attn_block_variant_reference(x, *p, heads, valid, **f),
                          tuple(sorted(f.items())))
    return ab((lambda: attn_block_variant(x, ln, attn, heads, valid),
               lambda: attn_block_variant_reference(x, *p, heads, valid)), variants,
              parent_key=tuple(sorted(port_flags("run_variant", {}, heads).items())), work=attn_work(x, valid),
              reps=reps, columns={"k2": (lambda: fused_attn_block(x, ln, attn, heads, valid_len=valid),
                                         lambda: attn_block_reference(x, *p, heads, valid, 1e-5))})


def main(argv=None) -> int:
    import torch

    a = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    a.add_argument("--batch", type=int, default=8)
    a.add_argument("--model", default="ViT-B-16")
    a.add_argument("--reps", type=int, default=5)
    args = a.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        print(json.dumps(run(args.batch, args.model, args.reps, dtype)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
