"""Time the forward half-block kernels K1 and K2 of one checkout of the port.

    python3 tapclip_tpu_torch/scripts/time_half_blocks.py [--root DIR] [--runs N]

Imports ``tapclip_tpu_torch`` from the checkout at ``DIR`` (default: the one
holding this file), builds its kernels, and prints one JSON line: the card's
name and power limit, then CUDA-event ms (mean of 20 calls after 3 warm-up
calls, ``--runs`` readings each) at ViT-B/16's image shape (8 x 200 rows,
W 768, 12 heads, valid 197), float32 and bfloat16, of

* ``fused_mlp_block`` and ``fused_attn_block``, the wrappers the model calls;
* their launches alone through the C interface, on buffers allocated once:
  K1 (``tapclip_fused_mlp``), K2's core (``tapclip_attn_block_core``) and its
  out-projection (``tapclip_gemm_bias_residual``).

To compare two commits on one card, unpack both and run this file against
each in turn within one machine: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

SHAPE = (8, 200, 768, 12, 197)  # B, T, W, heads, valid: ViT-B/16 at batch 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("time_half_blocks: needs a CUDA device", file=sys.stderr)
        return 1
    from tapclip_tpu_torch.ops import _build
    from tapclip_tpu_torch.ops.fused_mha import fused_attn_block
    from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block

    # This file's own helpers, whichever checkout the package comes from.
    sys.path.append(str(Path(__file__).resolve().parent))
    from _bench_util import card_line, time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _build.library()
    B, T, W, nh, valid = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    readings = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        code = _build.dtype_code(dtype)
        x = rn(B, T, W).to(dtype)
        ln = {"scale": 1.0 + rn(W, s=0.1), "bias": rn(W, s=0.1)}
        mlp = {"w_fc": rn(W, 4 * W, s=W ** -0.5), "b_fc": rn(4 * W, s=0.1),
               "w_proj": rn(4 * W, W, s=(4 * W) ** -0.5), "b_proj": rn(W, s=0.1)}
        attn = {"w_qkv": rn(W, 3 * W, s=W ** -0.5), "b_qkv": rn(3 * W, s=0.1),
                "w_out": rn(W, W, s=W ** -0.5), "b_out": rn(W, s=0.1)}
        wd = {k: v.to(dtype) for k, v in {**mlp, **attn}.items() if k.startswith("w_")}
        out, a_buf = torch.empty_like(x), torch.empty_like(x)
        ws = torch.empty((B, nh, 3, T, W // nh), device="cuda")
        stream = _build.stream_handle(x.device)

        def k1():
            lib.tapclip_fused_mlp(x.data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(),
                                  wd["w_fc"].data_ptr(), mlp["b_fc"].data_ptr(), wd["w_proj"].data_ptr(),
                                  mlp["b_proj"].data_ptr(), out.data_ptr(), B * T, W, 4 * W, 1e-5, code, stream)

        def k2_core():
            lib.tapclip_attn_block_core(x.data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(),
                                        wd["w_qkv"].data_ptr(), attn["b_qkv"].data_ptr(), ws.data_ptr(),
                                        a_buf.data_ptr(), B, T, W, nh, valid, 1e-5, code, stream)

        def k2_gemm():
            lib.tapclip_gemm_bias_residual(a_buf.data_ptr(), wd["w_out"].data_ptr(), attn["b_out"].data_ptr(),
                                           x.data_ptr(), out.data_ptr(), B * T, W, W, code, stream)

        calls = {"K1 wrapper": lambda: fused_mlp_block(x, ln, mlp),
                 "K2 wrapper": lambda: fused_attn_block(x, ln, attn, nh, valid_len=valid),
                 "K1 launch": k1, "K2 core launch": k2_core, "K2 out-projection launch": k2_gemm}
        with torch.inference_mode():
            for name, fn in calls.items():
                readings[f"{name} {dname}"] = [time_ms(fn, 20, 3) for _ in range(args.runs)]
    print(json.dumps({"root": args.root, "card": card_line(), "shape": "8x200x768 h12 valid197",
                      "ms": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
