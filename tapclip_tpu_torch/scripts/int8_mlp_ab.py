"""A/B of the int8 MLP half-block's variants (S5) on the card.

    python3 -m tapclip_tpu_torch.scripts.int8_mlp_ab [--batch B] [--model NAME] [--reps N]

Counterpart of ``scripts/int8_mlp_ab.py``: B13 (``ops/int8_mlp.py::
int8_mlp_block``, ``csrc/int8_mlp.cu``: the port of that script's
production kernel, the parent) against the variants of that script's
``main()``, each as B13's own four launches with the switch applied
(``int8_mlp_variant``, ``tapclip_int8_mlp_variant``), in the stochastic
mode:

* ``erf3`` -> the A&S 3-term erf (|err| <= 2.5e-5) in the fc epilogue's GELU;
* ``recipmul`` -> both row passes quantize by ``v * (127 / amax)`` in place of
  ``v / (amax / 127)``;
* ``both`` -> the two together.

``base`` is B13's configuration, run through the variant entry (it must equal
the parent bit for bit).  At the model's vision widths (default ViT-B/16,
batch 8: rows 8 x 200, W 768, H 3,072), f32 and bf16, each variant is held
against the parent and against its own plain version (errors of the output
and of the update out - x), and timed in turns with CUDA events: through the
wrappers, which quantize the weights and lay them out on every call as
``int8_mlp_block`` does, and (``launch_ms``) the launches alone on weights
laid out once.  The bound is the int8 products' 4 R W H operations at the
card's int8 rate against the bytes of x in and out and the int8 weights.
Prints the card's name and power limit, then one JSON line per dtype.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from tapclip_tpu_torch.scripts._bench_util import ab, card_line, time_ms, vit_layer

# The variants of scripts/int8_mlp_ab.py::main: run_variant's keyword
# arguments ("base" is its "production", no switch).
VARIANTS = {"base": {}, "erf3": {"erf3": True}, "recipmul": {"recipmul": True},
            "both": {"erf3": True, "recipmul": True}}
REPLACES = "scripts/int8_mlp_ab.py:63"


def port_flags(jax_kwargs: dict) -> dict:
    """int8_mlp_variant's switches for the JAX script's run_variant arguments
    (``row_tile`` changes only the TPU kernel's schedule)."""
    return {"erf3": bool(jax_kwargs.get("erf3", False)), "recipmul": bool(jax_kwargs.get("recipmul", False))}


def int8_work(x, q) -> tuple:
    """(bytes, operations) of the half-block on ``x [..., W]``: x in and out, the
    int8 weights and the f32 LayerNorm parameters, scales and biases; two
    int8 products of 2 R W H operations."""
    W, H = q["w_fc"].shape
    R = x.numel() // W
    return 2 * x.numel() * x.element_size() + 2 * W * H + 4 * (4 * W + 2 * H), 4 * R * W * H


def launch_args(x, gamma, beta, q, deterministic: bool = False) -> tuple:
    """``tapclip_int8_mlp``'s arguments on weights laid out once and scratch
    allocated once (``tapclip_int8_mlp_variant`` takes the variant before
    the last two), and the tensors they point into, to keep alive."""
    import torch

    from tapclip_tpu_torch.ops import _build
    from tapclip_tpu_torch.ops.int8_mlp import k_major

    lib = _build.library()
    W, H = q["w_fc"].shape
    R = x.numel() // W
    Wp, Hp = lib.tapclip_int8_gemm_kp(W), lib.tapclip_int8_gemm_kp(H)
    dev = x.device
    keep = (k_major(q["w_fc"], Wp), k_major(q["w_proj"], Hp), torch.empty_like(x),
            torch.empty((R, H), device=dev), torch.empty((R, Wp), dtype=torch.int8, device=dev),
            torch.empty((R, Hp), dtype=torch.int8, device=dev), torch.empty((3, R), device=dev))
    w_fc, w_proj, out, h, yq, hq, scales = keep
    args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w_fc.data_ptr(), q["s_fc"].data_ptr(),
            q["b_fc"].data_ptr(), w_proj.data_ptr(), q["s_proj"].data_ptr(), q["b_proj"].data_ptr(), out.data_ptr(),
            h.data_ptr(), yq.data_ptr(), hq.data_ptr(), scales.data_ptr(), R, W, H, 1e-5, 0, int(deterministic),
            _build.dtype_code(x.dtype), _build.stream_handle(dev))
    return args, keep


def launch_ms(x, gamma, beta, q, reps: int = 5, iters: int = 10) -> dict:
    """CUDA-event ms of the launches alone on weights laid out once, in turns:
    ``parent`` B13's entry (``tapclip_int8_mlp``), each variant S5's
    (``tapclip_int8_mlp_variant``); the medians and, under ``reps``, every
    reading."""
    from tapclip_tpu_torch.ops import _build
    from tapclip_tpu_torch.ops.int8_mlp import variant_code

    lib = _build.library()
    args, keep = launch_args(x, gamma, beta, q)
    calls = {"parent": lambda: lib.tapclip_int8_mlp(*args)}
    for name, kw in VARIANTS.items():
        code = variant_code(**port_flags(kw))
        calls[name] = lambda code=code: lib.tapclip_int8_mlp_variant(*args[:-2], code, *args[-2:])
    for name, fn in calls.items():
        _build.check(fn(), f"int8_mlp_ab {name}")
    readings = {name: [] for name in calls}
    for _ in range(reps):
        for name, fn in calls.items():
            readings[name].append(time_ms(fn, iters, 1))
    return {"ms": {name: statistics.median(r) for name, r in readings.items()}, "reps": readings}


def run(B: int = 8, model: str = "ViT-B-16", reps: int = 5, dtype=None, device: str = "cuda",
        seed: int = 0) -> dict:
    """The A/B table (see ``_bench_util.ab``) at one dtype, with ``launch_ms``
    on a card."""
    import torch

    from tapclip_tpu_torch.ops.int8_mlp import int8_mlp_block, int8_mlp_plain, int8_mlp_variant, quantize_mlp

    x, _, _, ln, mlp = vit_layer(B, model, dtype or torch.float32, device, seed)
    g, b = ln["scale"], ln["bias"]
    q = quantize_mlp(mlp)
    variants = {}
    for name, kw in VARIANTS.items():
        f = port_flags(kw)
        variants[name] = (lambda f=f: int8_mlp_variant(x, g, b, quantize_mlp(mlp), **f),
                          lambda f=f: int8_mlp_plain(x, g, b, q, **f), tuple(sorted(f.items())))
    out = ab((lambda: int8_mlp_block(x, ln, mlp), lambda: int8_mlp_plain(x, g, b, q)), variants,
             parent_keys=(variants["base"][2],), work=int8_work(x, q), reps=reps, ops="int8", residual=x)
    if x.is_cuda:
        with torch.inference_mode():
            out["launch_ms"] = launch_ms(x, g, b, q, reps)
    return out


def main(argv=None) -> int:
    import torch

    a = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    a.add_argument("--batch", type=int, default=8)
    a.add_argument("--model", default="ViT-B-16")
    a.add_argument("--reps", type=int, default=5)
    args = a.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_mlp_ab: needs a CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        print(json.dumps(run(args.batch, args.model, args.reps, dtype)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
