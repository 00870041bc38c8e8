"""A/B of the one-launch fused ViT layer (S1) on the card.

    python3 -m tapclip_tpu_torch.scripts.fused_layer_ab [--batch B] [--model NAME] [--reps N]

Counterpart of ``scripts/fused_layer_ab.py``: the two production half-block
kernels, K2 then K1 (the parent, "two half-block kernels", seven launches),
against the whole layer in one cooperative launch on the same tensor-core
tiles (``ops/fused_layer.py::fused_layer``, ``csrc/fused_layer.cu``).  The
JAX script's three variants differ only in ``bB`` (batch rows a grid step)
and ``h_chunk`` (the hidden columns a step), which have no counterpart in a
persistent grid that walks tiles of every product: "fused bB8" is the
kernel and the other two are reported ``same_as`` it.  The fused layer keeps
the attention output and mid in f32 where K2 then K1 round them, so in bf16
the two differ by the rounding of those tensors.  Prints the card's name and
power limit, the cooperative grid, then one JSON line per dtype (the bound,
the MMA bound, the parent and the kernel).
"""

from __future__ import annotations

import argparse
import json
import sys

from tapclip_tpu_torch.scripts._bench_util import ab, attn_work, card_line, mlp_work, vit_layer

# The variants of scripts/fused_layer_ab.py::main: run_fused_layer's keyword arguments.
VARIANTS = {
    "fused bB8": {"bB": 8},
    "fused bB4": {"bB": 4},
    "fused bB8 hc1536": {"bB": 8, "h_chunk": 1536},
}
REPLACES = "scripts/fused_layer_ab.py:49"


def run(B: int = 8, model: str = "ViT-B-16", reps: int = 5, dtype=None, device: str = "cuda",
        seed: int = 0) -> dict:
    """The A/B table (see ``_bench_util.ab``) at one dtype; on the card also
    the cooperative grid the launch took."""
    import torch

    from tapclip_tpu_torch.ops.fused_layer import fused_layer, fused_layer_max_grid, fused_layer_reference
    from tapclip_tpu_torch.ops.fused_mha import attn_block_reference, fused_attn_block
    from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block, fused_mlp_reference
    from tapclip_tpu_torch.scripts._bench_util import vit_shape

    _, valid, W, heads, H = vit_shape(model)
    x, ln1, attn, ln2, mlp = vit_layer(B, model, dtype or torch.float32, device, seed)

    def parent():
        return fused_mlp_block(fused_attn_block(x, ln1, attn, heads, valid_len=valid), ln2, mlp)

    def parent_plain():
        mid = attn_block_reference(x, ln1["scale"], ln1["bias"], *attn.values(), heads, valid, 1e-5)
        return fused_mlp_reference(mid, ln2["scale"], ln2["bias"], *mlp.values())

    variants = {name: (lambda: fused_layer(x, ln1, attn, ln2, mlp, heads, valid),
                       lambda: fused_layer_reference(x, ln1, attn, ln2, mlp, heads, valid), ())
                for name in VARIANTS}
    a_bytes, a_flops = attn_work(x, valid)
    m_bytes, m_flops = mlp_work(x, H)
    work = (a_bytes + m_bytes - 2 * x.numel() * x.element_size(), a_flops + m_flops)
    out = ab((parent, parent_plain), variants, work=work, reps=reps)
    if x.is_cuda:
        out["grid"] = fused_layer_max_grid(x.shape[1], W, x.dtype)
    return out


def main(argv=None) -> int:
    import torch

    a = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    a.add_argument("--batch", type=int, default=8)
    a.add_argument("--model", default="ViT-B-16")
    a.add_argument("--reps", type=int, default=5)
    args = a.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_layer_ab: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        print(json.dumps(run(args.batch, args.model, args.reps, dtype)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
