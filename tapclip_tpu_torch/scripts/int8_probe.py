"""Probe the int8 product (S6) on the card against its yardsticks.

    python3 -m tapclip_tpu_torch.scripts.int8_probe [--rows R] [--width W] [--hidden H]

Counterpart of ``scripts/int8_probe.py`` (which timed its Pallas
``mm_kernel`` in int8 -> int32, int8 -> f32 and bf16 on a TPU).  At the
probe's shape (R 51,200 = 256 images x 200 tokens, W 768, H 3,072) it holds
the hand-written int8 kernel (``csrc/int8_gemm.cu``) exactly against its
float64 plain version, in both output forms, and times with CUDA events:

* the int8 kernel, int32 and f32 out;
* ``csrc/gemm.cu`` (``ops/gemm.py::gemm_f32``) on the same values in bf16;
* ``torch._int_mm`` (cuBLAS int8, the library yardstick; the port never
  calls it) and ``torch.matmul`` in bf16;
* the plain version (float64 product).

Prints the card's name and power limit, then one JSON line of the readings,
with the kernel's time over ``torch._int_mm``'s (``ratio_to_int_mm``).
"""

from __future__ import annotations

import argparse
import json
import sys

from tapclip_tpu_torch.scripts._bench_util import HBM_BYTES_PER_S, card_line, time_ms

PROBE_SHAPE = (51_200, 768, 3_072)  # scripts/int8_probe.py::main: 256 * 200 rows
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak


def probe(R: int, W: int, H: int, iters: int = 5, seed: int = 0) -> dict:
    """The readings at ``[R, W] x [W, H]``; raises if the kernel is not exact."""
    import torch

    from tapclip_tpu_torch.ops.gemm import gemm_f32
    from tapclip_tpu_torch.ops.int8_gemm import int8_gemm, int8_gemm_reference

    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randint(-127, 128, (R, W), generator=gen, device="cuda", dtype=torch.int8)
    b = torch.randint(-127, 128, (W, H), generator=gen, device="cuda", dtype=torch.int8)
    out = {"shape": f"{R}x{W}x{H}"}
    with torch.inference_mode():
        for name, dt in (("int32", torch.int32), ("f32", torch.float32)):
            got, want = int8_gemm(a, b, out_dtype=dt), int8_gemm_reference(a, b, dt)
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            if err != 0.0:
                raise RuntimeError(f"int8_gemm {name} out differs from its plain version by {err}")
            out[f"max_abs_err_{name}"] = err
            del got, want
        ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
        out["ms"] = time_ms(lambda: int8_gemm(a, b), iters)
        out["ms_f32_out"] = time_ms(lambda: int8_gemm(a, b, out_dtype=torch.float32), iters)
        out["plain_ms"] = time_ms(lambda: int8_gemm_reference(a, b), max(1, iters // 2), 1)
        out["library_ms"] = time_ms(lambda: torch._int_mm(a, b), iters)
        out["matmul_bf16_ms"] = time_ms(lambda: ab @ bb, iters)
        out["gemm_cu_bf16_ms"] = time_ms(lambda: gemm_f32(ab, bb), max(1, iters // 2), 1)
    ops = 2 * R * W * H
    by_bytes = 1e3 * (R * W + W * H + 4 * R * H) / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / INT8_OPS_PER_S
    out.update(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations",
               tops=ops / out["ms"] / 1e9, ratio_to_int_mm=out["ms"] / out["library_ms"])
    return out


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rows", type=int, default=PROBE_SHAPE[0])
    p.add_argument("--width", type=int, default=PROBE_SHAPE[1])
    p.add_argument("--hidden", type=int, default=PROBE_SHAPE[2])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_probe: needs a CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    print(json.dumps(probe(args.rows, args.width, args.hidden)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
