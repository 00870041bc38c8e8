"""A/B of the attention half-block's softmax variants (S4) on the card.

    python3 -m tapclip_tpu_torch.scripts.attn_softmax_ab [--batch B] [--model NAME] [--reps N]

Counterpart of ``scripts/attn_softmax_ab.py`` (whose default, ``vitl``, is
``--model ViT-L-14`` here): the variants of that script, run by
``ops/fused_mha.py::attn_block_variant(form="softmax")`` as configurations of
K2's earlier FMA core (``csrc/attn_core.cuh``), against the parent, the
flags-off online kernel (``base``'s configuration):

* ``qk_cast``: q and k rounded to the compute dtype before the score product;
  ``fold_q``: q times scale * log2 e, the score not scaled again;
* ``mask_mode`` "tail": the valid select in the last 64-key tile only
  (refused unless every pad key lies past that tile's start and the last
  128-key boundary); "zerokv": pad rows of k and v zeroed, no select,
  l -= n_pad * exp2(-m);
* ``sum_mxu``: l sums p after its rounding to the compute dtype;
* ``tail_split``: keys before and from the last 128-key boundary summed
  apart and merged (the same function in another order);
* ``group_heads`` as in ``attn_kernel_ab`` (the TPU's g becomes g * 64 / 128
  heads a block); ``swpipe`` and ``bB`` have no counterpart (reported
  ``same_as``).

``base`` (no switch) is the parent's configuration and must equal it bit for
bit.  K2 (``csrc/attn_block.cu``, the same function on the tensor cores) is
timed in the same turns as a column of its own (``columns["k2"]``).  In the
JAX script ``sum_mxu`` reads the tail select whatever ``mask_mode``
(v6b_full raises there); here it takes the mask it is given.  Prints the
card's name and power limit, then one JSON line per dtype.
"""

from __future__ import annotations

import argparse
import json
import sys

from tapclip_tpu_torch.scripts._bench_util import ab, attn_work, card_line, vit_layer

# name: run_variant's keyword arguments, from main() and the module docstring
# (v1-v10), plus one variant for each switch alone.
VARIANTS = {
    "base": {},
    "v1_qkcast": {"qk_cast": True},
    "foldq": {"fold_q": True},
    "v2_foldq": {"qk_cast": True, "fold_q": True},
    "tailsel": {"mask_mode": "tail"},
    "v3_tailsel": {"qk_cast": True, "fold_q": True, "mask_mode": "tail"},
    "zerokv": {"mask_mode": "zerokv"},
    "v4_zerokv": {"qk_cast": True, "fold_q": True, "mask_mode": "zerokv"},
    "summxu": {"sum_mxu": True},
    "v6_summxu": {"qk_cast": True, "fold_q": True, "mask_mode": "tail", "sum_mxu": True},
    "v6b_full": {"qk_cast": True, "fold_q": True, "mask_mode": "full", "sum_mxu": True},
    "v6c_nofold": {"qk_cast": True, "mask_mode": "tail", "sum_mxu": True},
    "tail_split": {"tail_split": True},
    "group256": {"group_heads": 4},
    "swpipe": {"swpipe": True},
    "v10_swpipe": {"qk_cast": True, "fold_q": True, "mask_mode": "tail", "sum_mxu": True, "swpipe": True},
}
REPLACES = "scripts/attn_softmax_ab.py:95"
TPU_GROUP = 2  # make_kernel's default heads per group at head dim 64


def port_flags(jax_kwargs: dict, n_heads: int) -> dict:
    """attn_block_variant's switches for the JAX script's run_variant arguments
    (``swpipe`` is dropped: no counterpart)."""
    group = max(1, min(n_heads, (jax_kwargs.get("group_heads") or TPU_GROUP) * 64 // 128))
    return {"form": "softmax", "group_heads": group, "qk_cast": bool(jax_kwargs.get("qk_cast", False)),
            "fold_q": bool(jax_kwargs.get("fold_q", False)), "mask_mode": jax_kwargs.get("mask_mode", "full"),
            "sum_mxu": bool(jax_kwargs.get("sum_mxu", False)),
            "tail_split": bool(jax_kwargs.get("tail_split", False))}


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
    for name, kw in VARIANTS.items():
        f = port_flags(kw, heads)
        variants[name] = (lambda f=f: attn_block_variant(x, ln, attn, heads, valid, **f),
                          lambda f=f: attn_block_variant_reference(x, *p, heads, valid, **f),
                          tuple(sorted(f.items())))
    return ab((lambda: attn_block_variant(x, ln, attn, heads, valid, form="softmax"),
               lambda: attn_block_variant_reference(x, *p, heads, valid, form="softmax")), variants,
              parent_key=tuple(sorted(port_flags({}, heads).items())), work=attn_work(x, valid), reps=reps,
              columns={"k2": (lambda: fused_attn_block(x, ln, attn, heads, valid_len=valid),
                              lambda: attn_block_reference(x, *p, heads, valid, 1e-5))})


def main(argv=None) -> int:
    import torch

    a = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    a.add_argument("--batch", type=int, default=8)
    a.add_argument("--model", default="ViT-B-16")
    a.add_argument("--reps", type=int, default=5)
    args = a.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_softmax_ab: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        print(json.dumps(run(args.batch, args.model, args.reps, dtype)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
