"""Shared pieces of the port's card drivers (counterpart of ``scripts/_bench_util.py``).

* :func:`card_line`: the card's name and power limit, as ``nvidia-smi`` gives them;
* :func:`time_ms`: the mean CUDA-event time of a call;
* :func:`bound`: the least time the card could take for a call's work;
* :func:`vit_layer`: random weights of one ViT layer at a model preset's
  vision widths, from a seed;
* :func:`ab`: an A/B table of variants against their parent: errors against
  the parent and against each variant's own plain version, CUDA-event times
  taken in turns (parent, variant, variant, ..., repeated), the bound.

Timing needs a card; on a CPU tensor :func:`ab` runs the plain versions and
reports the errors only (the tests use that).
"""

from __future__ import annotations

import statistics
import subprocess

# The card's published peaks (H100 SXM data sheet, dense): memory 3.35 TB/s;
# f32 outside the tensor cores 67 TFLOP/s, bf16 989 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean CUDA-event ms of ``iters`` calls after ``warmup`` calls."""
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


def mlp_work(x, H: int):
    """(bytes, flops) of the MLP half-block on ``x [..., W]``: x in and out and
    the two weight matrices in x's dtype, the f32 LayerNorm parameters and
    biases; two products of 2 R W H operations."""
    W, es = x.shape[-1], x.element_size()
    R = x.numel() // W
    return 2 * x.numel() * es + 2 * W * H * es + (3 * W + H) * 4, 4 * R * W * H


def attn_work(x, valid: int):
    """(bytes, flops) of the attention half-block on ``x [B, T, W]``: x in and out
    and w_qkv, w_out in x's dtype, the f32 LayerNorm parameters and biases; the
    projections (8 B T W^2) and the attention products over the B T valid
    (query, key) pairs (4 W each)."""
    B, T, W = x.shape
    es = x.element_size()
    return 2 * x.numel() * es + 4 * W * W * es + 6 * W * 4, 8 * B * T * W * W + 4 * W * B * T * valid


def bound(n_bytes: int, flops: float, dtype: str) -> dict:
    """The larger of the bytes (each input read once, each output written once)
    over the memory rate and the operations over the dtype's peak."""
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def vit_shape(model: str):
    """(T, valid, W, heads, H) of a preset's vision tower: T the token count
    padded to a multiple of 8, as the JAX scripts run it."""
    from tapclip_tpu_torch.config import MODEL_PRESETS

    cfg = MODEL_PRESETS[model]
    valid = cfg.vision_seq_len
    return (valid + 7) // 8 * 8, valid, cfg.vision_width, cfg.vision_heads, cfg.mlp_ratio * cfg.vision_width


def vit_layer(B: int, model: str, dtype, device: str, seed: int = 0):
    """x [B, T, W] in ``dtype`` and one layer's f32 parameters (ln_1, attn, ln_2,
    mlp), random from ``seed``, on ``device``."""
    import torch

    T, _, W, _, H = vit_shape(model)
    gen = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=device) * s

    def ln():
        return {"scale": 1.0 + rn(W, s=0.1), "bias": rn(W, s=0.1)}

    x = rn(B, T, W).to(dtype)
    attn = {"w_qkv": rn(W, 3 * W, s=W ** -0.5), "b_qkv": rn(3 * W, s=0.1),
            "w_out": rn(W, W, s=W ** -0.5), "b_out": rn(W, s=0.1)}
    mlp = {"w_fc": rn(W, H, s=W ** -0.5), "b_fc": rn(H, s=0.1),
           "w_proj": rn(H, W, s=H ** -0.5), "b_proj": rn(W, s=0.1)}
    return x, ln(), attn, ln(), mlp


def _errors(got, want) -> dict:
    """Max abs error, norm-relative error, and the least atol = rtol that
    ``torch.allclose`` would pass (max |d| / (1 + |want|))."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    return {"max_abs_err": float(d.max()),
            "rel_err": float((got - want).norm() / want.norm().clamp_min(1e-30)),
            "tol_needed": float((d / (1.0 + want.abs())).max()),
            "finite": bool(got.isfinite().all())}


def ab(parent, variants: dict, *, parent_key, work, reps: int = 5, iters: int = 10, columns=None) -> dict:
    """The A/B table.  ``parent``: (kernel, plain) callables of the production
    half-block(s).  ``variants``: name -> (kernel, plain, key), ``key`` the
    variant's port switches as sorted (name, value) pairs; variants with the
    same ``key`` run the same kernel, and each after the first is reported
    ``same_as`` the first (not run or timed again).  ``parent_key`` is the key
    of the variant configuration that is the parent's own: such a variant
    should equal the parent bit for bit (``bit_equal_parent``).
    ``work``: (bytes, flops) of one call.  ``columns``: name -> (kernel,
    plain) of other kernels of the same function, reported under
    ``"columns"`` like a variant but apart from the variants (no flags, no
    ``bit_equal_parent``).  On a CUDA tensor the kernels and their plain
    versions are timed, the kernels in turns."""
    import torch

    p_kernel, p_plain = parent
    with torch.inference_mode():
        want_parent = p_kernel()
        cuda = want_parent.is_cuda
        dt = str(want_parent.dtype).replace("torch.", "")
        out = {"dtype": dt, "shape": "x".join(map(str, want_parent.shape)), **bound(*work, dt),
               "parent": _errors(want_parent, p_plain()), "variants": {}}
        first = {}
        for name, (kernel, plain, key) in variants.items():
            if key in first:
                out["variants"][name] = {"same_as": first[key], "flags": dict(key)}
                continue
            first[key] = name
            got = kernel()
            v = {"flags": dict(key), "vs_parent": _errors(got, want_parent), "vs_plain": _errors(got, plain())}
            if key == parent_key:
                v["bit_equal_parent"] = bool(torch.equal(got, want_parent))
            out["variants"][name] = v
        columns = columns or {}
        out["columns"] = {}
        for name, (kernel, plain) in columns.items():
            got = kernel()
            out["columns"][name] = {"vs_parent": _errors(got, want_parent), "vs_plain": _errors(got, plain())}
        if not cuda:
            return out
        torch.cuda.synchronize()
        out["parent"]["plain_ms"] = time_ms(p_plain, max(1, iters // 2), 1)
        timed = {name: variants[name] for name, v in out["variants"].items() if "same_as" not in v}
        for name in timed:
            out["variants"][name]["plain_ms"] = time_ms(timed[name][1], max(1, iters // 2), 1)
        for name, (_, plain) in columns.items():
            out["columns"][name]["plain_ms"] = time_ms(plain, max(1, iters // 2), 1)
        kernels = {**{name: timed[name][0] for name in timed}, **{name: fn for name, (fn, _) in columns.items()}}
        reps_ms = {"parent": [], **{name: [] for name in kernels}}
        for _ in range(reps):
            reps_ms["parent"].append(time_ms(p_kernel, iters, 1))
            for name, fn in kernels.items():
                reps_ms[name].append(time_ms(fn, iters, 1))
    out["parent"].update(ms=statistics.median(reps_ms["parent"]), ms_reps=reps_ms["parent"])
    for name in kernels:
        ms = statistics.median(reps_ms[name])
        table = out["columns"] if name in columns else out["variants"]
        table[name].update(ms=ms, ms_reps=reps_ms[name], ratio=ms / out["parent"]["ms"])
    return out
