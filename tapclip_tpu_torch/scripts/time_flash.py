"""Time K3 and the flash backward chain of one checkout of the port.

    python3 tapclip_tpu_torch/scripts/time_flash.py [--root DIR] [--runs N]

Imports ``tapclip_tpu_torch`` from the checkout at ``DIR`` (default: the one
holding this file), builds its kernels, and prints one JSON line: the card's
name and power limit, then CUDA-event ms (the median of ``--runs`` readings,
each the mean of 20 calls after 3 warm-up calls; 5 calls past T 2048), in
float32 and bfloat16, at K3's and the chain's four shapes (the text
attribution pass 8 x 8 heads at T 88, valid 82; the idiomatic causal layer
8 x 8 at T 77; ViT-L/14-336, 4 x 16 at T 584, valid 577; a long 1 x 16 at
T 4096, valid 4000, causal and not), head dim 64, of

* K3: ``fused_attention`` with the aux column (the wrapper the model
  calls), its launch alone through the C interface on buffers allocated
  once, and SDPA's forward on the same inputs;
* the chain: each kernel's wrapper (``_flash_lse_cuda``,
  ``_flash_bwd_dkv_cuda``, ``_flash_bwd_dq_cuda``), the whole backward
  (``flash_attention_bwd_cuda``: delta, the allocations, three launches), and
  SDPA's backward through autograd on the same inputs.

Each reading also carries the bounds of its shape (``--bounds`` prints them
alone, without a card): the least time of K3 and of the chain (the sum of
its three kernels) by their bytes (each input read once, each output written
once) over 3.35 TB/s or their operations over the dtype's peak (67 TFLOP/s
f32 outside the tensor cores, 989 bf16), and at the rate of the bf16 MMAs
they run (``MMA_PRODUCTS``: six per f32 product, one or two per bf16 one, at
989 TFLOP/s).

To compare two commits on one card, unpack both and run this file against
each in turn within one machine: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

# label: (B, H, T, valid, causal, eot)
SHAPES = {
    "text 8x8x88 valid82": (8, 8, 88, 82, False, 81),
    "idiomatic 8x8x77 causal": (8, 8, 77, 77, True, [11, 12, 13, 14, 15, 16, 17, 76]),
    "vit-l-336 4x16x584 valid577": (4, 16, 584, 577, False, 576),
    "long 1x16x4096 valid4000": (1, 16, 4096, 4000, False, 3999),
    "long 1x16x4096 valid4000 causal": (1, 16, 4096, 4000, True, 3999),
}


# This file's own helpers, whichever checkout the package comes from.
sys.path.append(str(Path(__file__).resolve().parent))
from _bench_util import bound, card_line, time_ms  # noqa: E402

# bf16 MMAs per product on the tensor cores (csrc/flash_mma.cuh), (f32, bf16),
# as chip_smoke.py's MMA_PRODUCTS: six per f32 product; in bf16 one for q k^T,
# dO v^T and K3's rounded p v, two for the chain's p and ds products.
MMA_PRODUCTS = {"k3": (6, 1), "lse": (6, 1), "dkv": (6, 1.5), "dq": (6, 4 / 3)}


def bounds(B, H, T, valid, causal, dtype: str, Dh: int = 64) -> dict:
    """``{"k3"|"chain": {"bound_ms", "mma_bound_ms"}}`` of one shape; the
    chain's is the sum of its three kernels'."""
    pairs = H * sum(min(i + 1, valid) if causal else valid for i in range(T)) * B
    es = 4 if dtype == "float32" else 2
    x, rows = B * H * T * Dh * es, 4 * B * H * T  # one operand, one f32 row vector
    work = {"k3": (4 * x + 4 * B * T, 4 * Dh * pairs), "lse": (2 * x + rows, 2 * Dh * pairs),
            "dkv": (6 * x + 2 * rows, 8 * Dh * pairs), "dq": (5 * x + 2 * rows, 6 * Dh * pairs)}
    bf = dtype == "bfloat16"

    def pair(name):
        n_bytes, flops = work[name]
        return (bound(n_bytes, flops, dtype)["bound_ms"],
                bound(n_bytes, flops * MMA_PRODUCTS[name][bf], "bfloat16")["bound_ms"])

    chain = [pair(name) for name in ("lse", "dkv", "dq")]
    k3 = pair("k3")
    return {"k3": {"bound_ms": k3[0], "mma_bound_ms": k3[1]},
            "chain": {"bound_ms": sum(c[0] for c in chain), "mma_bound_ms": sum(c[1] for c in chain)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--bounds", action="store_true", help="print the shapes' bounds only (no card needed)")
    args = ap.parse_args()
    if args.bounds:
        print(json.dumps({f"{label} {dtype}": bounds(B, H, T, valid, causal, dtype)
                          for dtype in ("float32", "bfloat16")
                          for label, (B, H, T, valid, causal, _) in SHAPES.items()}))
        return 0
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_flash: needs a CUDA device", file=sys.stderr)
        return 1
    from tapclip_tpu_torch.ops import _build
    from tapclip_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _build.library()
    # The checkout's C signature of K3: 15 arguments before the int-or-pointer
    # valid/eot pair, 17 after.
    k3_args = len(_build._SIGNATURES["tapclip_attn_aux"])
    gen = torch.Generator(device="cuda").manual_seed(3)
    readings = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        code = _build.dtype_code(dtype)
        for label, (B, H, T, valid, causal, eot) in SHAPES.items():
            iters = 5 if T > 2048 else 20
            q, k, v, g = (torch.randn((B, H, T, 64), generator=gen, device="cuda").to(dtype) for _ in range(4))
            valid_t = torch.full((B,), valid, dtype=torch.int32, device="cuda")
            eot_t = torch.tensor(eot if isinstance(eot, list) else [eot] * B, dtype=torch.int32, device="cuda")
            keys = torch.arange(T, device="cuda")
            mask = keys.view(1, 1, 1, T) < valid_t.view(B, 1, 1, 1)
            if causal:
                mask = mask & (keys.view(1, 1, 1, T) <= keys.view(1, 1, T, 1))
            out_buf = torch.empty_like(q)
            aux_buf = torch.empty((B, H, T), dtype=torch.float32, device="cuda")
            stream = _build.stream_handle(q.device)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_t.data_ptr(), eot_t.data_ptr())
            if k3_args == 15:
                k3_call = (*ptrs, out_buf.data_ptr(), aux_buf.data_ptr(), B, H, T, 64, 1, int(causal), code, stream)
            else:
                k3_call = (*ptrs, 0, 0, out_buf.data_ptr(), aux_buf.data_ptr(), B, H, T, 64, 1, int(causal),
                           code, stream)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            with torch.enable_grad():
                sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
            with torch.no_grad():
                out, _ = fa.fused_attention(q, k, v, causal=causal, kv_valid_len=valid_t)
                lse = fa.attention_lse_reference(q, k, valid_t, causal)
                delta = fa.attention_delta(out, g)
                dq, dk, dv = (torch.empty_like(q) for _ in range(3))
                calls = {
                    "k3": lambda: fa.fused_attention(q, k, v, causal=causal, kv_valid_len=valid_t,
                                                     attn_to_idx=eot_t),
                    "k3_launch": lambda: lib.tapclip_attn_aux(*k3_call),
                    "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                    "lse": lambda: fa._flash_lse_cuda(q, k, valid_t, causal),
                    "dkv": lambda: fa._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, valid_t, causal, dk, dv),
                    "dq": lambda: fa._flash_bwd_dq_cuda(q, k, v, g, lse, delta, valid_t, causal, dq),
                    "chain": lambda: fa.flash_attention_bwd_cuda(q, k, v, out, g, valid_t, causal),
                    "sdpa_bwd": lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True),
                }
                readings[f"{label} {dname}"] = {
                    name: statistics.median(time_ms(fn, iters, 3) for _ in range(args.runs))
                    for name, fn in calls.items()}
                readings[f"{label} {dname}"]["bounds"] = bounds(B, H, T, valid, causal, dname)
            del q, k, v, g, out, lse, delta, dq, dk, dv, leaves, sdpa_out, out_buf, aux_buf
            torch.cuda.empty_cache()
    print(json.dumps({"root": str(Path(args.root).resolve()), "card": card_line(),
                      "build_s": _build.build_log["seconds"], "ms": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
