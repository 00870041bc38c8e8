"""Time the attention-block backward kernel (B4) of one checkout of the port.

    python3 tapclip_tpu_torch/time_attn_block_bwd.py [--root DIR] [--runs N]

Imports ``tapclip_tpu_torch`` from the checkout at ``DIR`` (default: the one
holding this file), builds its kernels, and prints one JSON line with the
card's name and power limit and B4's CUDA-event ms (mean of 20 calls after 3
warm-up calls, with weight gradients), ``--runs`` readings each, at the
shapes ``chip_smoke.py`` holds it at: text (8 x 88 rows, W 512, 8 heads,
valid 82) and image (8 x 200, W 768, 12 heads, valid 197), float32 and
bfloat16.  To compare two commits on one card, unpack both and run this file
against each in turn within one machine: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = (("text 8x88x512 h8 valid82", (8, 88, 512, 8, 82)),
          ("image 8x200x768 h12 valid197", (8, 200, 768, 12, 197)))


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("time_attn_block_bwd: needs a CUDA device", file=sys.stderr)
        return 1
    from tapclip_tpu_torch.ops import _build
    from tapclip_tpu_torch.ops.fused_mha import _attn_block_bwd_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    card = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    readings = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for label, (B, T, W, nh, valid) in SHAPES:
            x, g = rn(B, T, W).to(dtype), rn(B, T, W).to(dtype)
            ln = (1.0 + rn(W, s=0.1), rn(W, s=0.1))
            attn = (rn(W, 3 * W, s=W ** -0.5), rn(3 * W, s=0.1), rn(W, W, s=W ** -0.5))
            with torch.no_grad():
                readings[f"{label} {dname}"] = [
                    time_ms(lambda: _attn_block_bwd_cuda(x, g, *ln, *attn, nh, valid, 1e-5))
                    for _ in range(args.runs)]
    print(json.dumps({"root": args.root, "card": card, "ms": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
