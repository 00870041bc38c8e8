"""Device time of each CUDA kernel behind K1, K2, B5, B4, B13, B14, B7, B6 and S6, read from a profiler trace.

    python3 tapclip_tpu_torch/scripts/profile_kernels.py [--root DIR] [--iters N] [--kernels B6,step,...]

Imports ``tapclip_tpu_torch`` from the checkout at ``DIR`` (default: the one
holding this file), builds its kernels, and runs ``torch.profiler`` over
``--iters`` calls (after warm-up) of

* K1 (``fused_mlp_block``) at ViT-B/16's image shape (8 x 200 rows, W 768),
  the 64-text batch (64 x 80, W 512) and the text shape (8 x 88, W 512), in
  float32 and bfloat16;
* K2 (``fused_attn_block``) at the image shape (12 heads, valid 197) and
  the text shape (8 x 88, W 512, 8 heads, valid 82), both dtypes;
* B5 (``_fused_mlp_bwd_cuda``, dx alone and all seven gradients) at the
  text shape (H 2,048) and the image shape (H 3,072), both dtypes;
* B4 (``_attn_block_bwd_cuda``, dx alone and all seven gradients) at the
  text shape (8 x 88, W 512, 8 heads, valid 82) and the image shape (8 x
  200, W 768, 12 heads, valid 197), both dtypes;
* B13 (``int8_mlp_cuda`` on weights quantized once) at the image shape
  (8 x 200, W 768, H 3,072), stochastic and round to nearest, both dtypes;
* B14 (``int8_attn_cuda`` on weights quantized once) at the image shape
  (8 x 200, W 768, 12 heads, valid 197), stochastic and round to nearest,
  both dtypes;
* B7 (``_fused_mha_bwd_cuda``) at the idiomatic step's shape (8 x 77, W
  512, 8 heads, causal) and the 64-text batch (64 x 80, valid 77, causal),
  both dtypes;
* B6 (``_fused_mha_cuda``) at B7's two shapes and the fused_split image
  shape (8 x 200, W 768, 12 heads, valid 197), both dtypes;
* S6 (``int8_gemm``) at the probe's shape (51,200 x 768 x 3,072) and at
  B13's two products (1,600 x 768 x 3,072 and 1,600 x 3,072 x 768);
* ``step``: the idiomatic (CoOp-style) prompt-tune step on cached features
  at ViT-B/16 with random weights from seed 0, float32 (batch 32, five
  classes in a bank of 8, as ``time_paths.py``): see :func:`step_trace`.

A wrapper call launches several kernels (K1: LayerNorm, fc, proj; K2:
LayerNorm, QKV, attention, out-projection; B5: LayerNorm, z, dh_pre, dy, the
LayerNorm backward, and with all gradients gemm.cu's products and column
sums; B4 likewise its LayerNorm, products, attention core and LayerNorm
backward; B13 and B14 their launches and the wrapper's weight layout; B7
its launches; S6: the
transpose of B, the product); the trace splits the call's
device time among them (launches of one kernel and template list summed).  Prints the card's name and power limit, then one JSON line per case:
each kernel's device microseconds per call (``us``, by kernel name), their
sum, and the wall-clock ms per call between the first and the last event
(``span_ms``), so the gaps between launches show as ``span_ms`` minus the sum.
``--kernels`` keeps only the named ones (default: all ten).  Exits 1
without a card, or when the trace holds no device time.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

K1_SHAPES = {"image 8x200x768": (8, 200, 768), "text batch 64x80x512": (64, 80, 512), "text 8x88x512": (8, 88, 512)}
K2_SHAPES = {"image 8x200x768 h12 valid197": (8, 200, 768, 12, 197), "text 8x88x512 h8 valid82": (8, 88, 512, 8, 82)}
B5_SHAPES = {"text 8x88x512": (8, 88, 512), "image 8x200x768": (8, 200, 768)}
B4_SHAPES = {"text 8x88x512 h8 valid82": (8, 88, 512, 8, 82), "image 8x200x768 h12 valid197": (8, 200, 768, 12, 197)}
B13_SHAPES = {"image 8x200x768 H3072": (8, 200, 768)}
B14_SHAPES = {"image 8x200x768 h12 valid197": (8, 200, 768, 12, 197)}
B7_SHAPES = {"idiomatic 8x77x512 h8 causal": (8, 77, 512, 8, 77, True),
             "text 64x80x512 h8 valid77 causal": (64, 80, 512, 8, 77, True)}
B6_SHAPES = {**B7_SHAPES, "image 8x200x768 h12 valid197": (8, 200, 768, 12, 197, False)}
STEP_CLASSES = ["Backpack", "Alarm_Clock", "Laptop", "Pen", "Mug"]
S6_SHAPES = {"probe": (51_200, 768, 3_072), "b13 fc": (1_600, 768, 3_072), "b13 proj": (1_600, 3_072, 768)}


def _short(name: str) -> str:
    """A kernel's name without its template arguments' noise: the function and its template list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0] if "<" not in name else name[: name.index(">") + 1]


def profile(fn, iters: int) -> dict:
    """Per-kernel device microseconds per call of ``fn`` and the span per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels, first, last = {}, None, None
    for ev in prof.events():  # device events: one per kernel launch, timed on the card
        if str(getattr(ev, "device_type", "")) != "DeviceType.CUDA" or ev.name.startswith(("Memcpy", "Memset")):
            continue
        start, end = ev.time_range.start, ev.time_range.end
        kernels[_short(ev.name)] = kernels.get(_short(ev.name), 0.0) + (end - start) / iters
        first = start if first is None else min(first, start)
        last = end if last is None else max(last, end)
    if not kernels:
        raise RuntimeError("the profiler trace holds no device time")
    return {"us": kernels, "sum_us": sum(kernels.values()), "span_ms": (last - first) / 1e3 / iters}


def _union_us(spans) -> float:
    """Microseconds covered by the union of ``(start, end)`` spans."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total, end = total + (b - a), b
        elif b > end:
            total, end = total + (b - end), b
    return total


def step_trace(iters: int) -> dict:
    """One ``torch.profiler`` trace of ``iters`` idiomatic prompt-tune steps
    (ViT-B/16, float32, cached features, batch 32), each step, its forward
    (``full_model_forward``), its backward (``torch.autograd.grad``) and its
    optimizer step (``AdamW.step``) marked as host spans.  Returns per step:
    the wall ms (``step_ms``, the host span of the step); the device's busy
    share (the union of its kernels' intervals over the steps' window) and
    its idle share; the step's CUDA-event ms without the profiler
    (``step_ms_unprofiled``: the profiler's own host work per operator
    lengthens the traced step) and the kernels' busy time over it
    (``busy_share_unprofiled``); each kernel's device microseconds (``kernels_us``, the
    20 largest, by name) and their sum; the host spans' ms (``host_ms``:
    forward, backward, optimizer, and the rest of the step); the number of
    aten operators and of kernel launches; and the 12 aten operators with
    the most host time of their own (``top_ops``: ms and calls per step)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    from tapclip_tpu_torch.config import VIT_B_16, PromptConfig, TrainConfig
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.parallel import train_step as ts
    from tapclip_tpu_torch.serve import build_model

    params = build_model(VIT_B_16, STEP_CLASSES, "cuda", seed=0).clip_params
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((32, VIT_B_16.embed_dim)).astype(np.float32)
    labels = rng.integers(0, len(STEP_CLASSES), 32)
    mask = np.ones(32, bool)
    pcfg = PromptConfig(text_mode="idiomatic")
    model = FullModel(STEP_CLASSES, params, VIT_B_16, prompt_cfg=pcfg)
    step = ts.make_train_step(VIT_B_16, pcfg)
    state = [ts.init_train_state(model.trainable, ts.make_optimizer(TrainConfig(batch_size=32)))]

    def marked(name, fn):
        def call(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return call

    forward, grad = ts.full_model_forward, torch.autograd.grad

    def one():
        with record_function("step"):
            state[0] = step(params, state[0], model.prompt_learner.bank, feats, labels, mask)[0]

    sys.path.append(str(Path(__file__).resolve().parent))
    from _bench_util import time_ms

    plain_ms = time_ms(one, iters, 3)  # the step without the profiler's host overhead
    ts.full_model_forward, torch.autograd.grad = marked("step.forward", forward), marked("step.backward", grad)
    try:
        for _ in range(3):
            one()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                one()
            torch.cuda.synchronize()
    finally:
        ts.full_model_forward, torch.autograd.grad = forward, grad
    host, kernels, dev_spans, ops, launches = {}, {}, [], {}, 0
    window = [None, None]
    marks = ("step", "step.forward", "step.backward")
    for ev in prof.events():
        a, b = ev.time_range.start, ev.time_range.end
        if str(getattr(ev, "device_type", "")) == "DeviceType.CUDA":
            # The marks' device-side copies (user annotations) are no kernel time.
            if getattr(ev, "is_user_annotation", False) or ev.name in marks or ev.name.startswith("Optimizer."):
                continue
            if not ev.name.startswith(("Memcpy", "Memset")):
                kernels[_short(ev.name)] = kernels.get(_short(ev.name), 0.0) + (b - a) / iters
            dev_spans.append((a, b))
            continue
        if ev.name in marks or ev.name.startswith("Optimizer.step#"):
            key = "optimizer" if ev.name.startswith("Optimizer.step#") else ev.name
            host[key] = host.get(key, 0.0) + (b - a) / 1e3 / iters
            if ev.name == "step":
                window = [a if window[0] is None else min(window[0], a), b if window[1] is None else max(window[1], b)]
        elif ev.name == "cudaLaunchKernel":
            launches += 1
        elif ev.name.startswith("aten::"):
            own = ev.self_cpu_time_total
            n, t = ops.get(ev.name, (0, 0.0))
            ops[ev.name] = (n + 1, t + own)
    if not kernels or window[0] is None:
        raise RuntimeError("the profiler trace holds no device time")
    span_us = window[1] - window[0]
    busy_us = _union_us([(max(a, window[0]), min(b, window[1])) for a, b in dev_spans if b > window[0] and a < window[1]])
    host["rest"] = host["step"] - host.get("step.forward", 0.0) - host.get("step.backward", 0.0) - host.get(
        "optimizer", 0.0)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:20]
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][1])[:12]
    return {"step_ms": host["step"], "busy_share": busy_us / span_us, "idle_share": 1.0 - busy_us / span_us,
            "step_ms_unprofiled": plain_ms, "busy_share_unprofiled": busy_us / iters / 1e3 / plain_ms,
            "kernels_sum_us": sum(kernels.values()), "kernels_us": dict(top), "host_ms": host,
            "aten_ops_per_step": sum(n for n, _ in ops.values()) / iters, "launches_per_step": launches / iters,
            "top_ops": {k: {"self_ms": t / 1e3 / iters, "calls": n / iters} for k, (n, t) in top_ops}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--kernels", default="K1,K2,B5,B4,B13,B14,B7,B6,S6,step")
    args = ap.parse_args()
    want = set(args.kernels.split(","))
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("profile_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    from tapclip_tpu_torch.ops import _build
    from tapclip_tpu_torch.ops.fused_mha import (
        _attn_block_bwd_cuda,
        _fused_mha_bwd_cuda,
        _fused_mha_cuda,
        fused_attn_block,
    )
    from tapclip_tpu_torch.ops.fused_mlp import _fused_mlp_bwd_cuda, fused_mlp_block
    from tapclip_tpu_torch.ops.int8_attn import int8_attn_cuda, quantize_attn
    from tapclip_tpu_torch.ops.int8_gemm import int8_gemm
    from tapclip_tpu_torch.ops.int8_mlp import int8_mlp_cuda, quantize_mlp

    sys.path.append(str(Path(__file__).resolve().parent))
    from _bench_util import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    print(card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    def emit(kernel, case, dtype, res):
        dt = {} if dtype is None else {"dtype": str(dtype).replace("torch.", "")}
        print(json.dumps({"kernel": kernel, "case": case, **dt, **res}), flush=True)

    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for label, (B, T, W) in K1_SHAPES.items() if "K1" in want else ():
                x = rn(B, T, W).to(dtype)
                ln = {"scale": 1.0 + rn(W, s=0.1), "bias": rn(W, s=0.1)}
                mlp = {"w_fc": rn(W, 4 * W, s=W ** -0.5), "b_fc": rn(4 * W, s=0.1),
                       "w_proj": rn(4 * W, W, s=(4 * W) ** -0.5), "b_proj": rn(W, s=0.1)}
                res = profile(lambda: fused_mlp_block(x, ln, mlp), args.iters)
                emit("K1", label, dtype, res)
            for label, (B, T, W, nh, valid) in K2_SHAPES.items() if "K2" in want else ():
                x = rn(B, T, W).to(dtype)
                ln = {"scale": 1.0 + rn(W, s=0.1), "bias": rn(W, s=0.1)}
                attn = {"w_qkv": rn(W, 3 * W, s=W ** -0.5), "b_qkv": rn(3 * W, s=0.1),
                        "w_out": rn(W, W, s=W ** -0.5), "b_out": rn(W, s=0.1)}
                res = profile(lambda: fused_attn_block(x, ln, attn, nh, valid_len=valid), args.iters)
                emit("K2", label, dtype, res)
            for label, (B, T, W) in B5_SHAPES.items() if "B5" in want else ():
                x, g = rn(B, T, W).to(dtype), rn(B, T, W).to(dtype)
                prm = (1.0 + rn(W, s=0.1), rn(W, s=0.1), rn(W, 4 * W, s=W ** -0.5), rn(4 * W, s=0.1),
                       rn(4 * W, W, s=(4 * W) ** -0.5))
                for mode, want_w in (("dx", False), ("all", True)):
                    res = profile(lambda: _fused_mlp_bwd_cuda(x, g, *prm, eps=1e-5, weight_grads=want_w), args.iters)
                    emit(f"B5 {mode}", label, dtype, res)
            for label, (B, T, W, nh, valid) in B4_SHAPES.items() if "B4" in want else ():
                x, g = rn(B, T, W).to(dtype), rn(B, T, W).to(dtype)
                prm = (1.0 + rn(W, s=0.1), rn(W, s=0.1), rn(W, 3 * W, s=W ** -0.5), rn(3 * W, s=0.1),
                       rn(W, W, s=W ** -0.5))
                for mode, want_w in (("dx", False), ("all", True)):
                    res = profile(lambda: _attn_block_bwd_cuda(x, g, *prm, nh, valid, 1e-5, weight_grads=want_w),
                                  args.iters)
                    emit(f"B4 {mode}", label, dtype, res)
            for label, (B, T, W) in B13_SHAPES.items() if "B13" in want else ():
                x = rn(B, T, W).to(dtype)
                gamma, beta = 1.0 + rn(W, s=0.1), rn(W, s=0.1)
                q = quantize_mlp({"w_fc": rn(W, 4 * W, s=W ** -0.5), "b_fc": rn(4 * W, s=0.1),
                                  "w_proj": rn(4 * W, W, s=(4 * W) ** -0.5), "b_proj": rn(W, s=0.1)})
                for mode, det in (("stochastic", False), ("round-to-nearest", True)):
                    res = profile(lambda: int8_mlp_cuda(x, gamma, beta, q, deterministic=det), args.iters)
                    emit(f"B13 {mode}", label, dtype, res)
            for label, (B, T, W, nh, valid) in B14_SHAPES.items() if "B14" in want else ():
                x = rn(B, T, W).to(dtype)
                gamma, beta = 1.0 + rn(W, s=0.1), rn(W, s=0.1)
                q = quantize_attn({"w_qkv": rn(W, 3 * W, s=W ** -0.5), "b_qkv": rn(3 * W, s=0.1),
                                   "w_out": rn(W, W, s=W ** -0.5), "b_out": rn(W, s=0.1)})
                for mode, det in (("stochastic", False), ("round-to-nearest", True)):
                    res = profile(lambda: int8_attn_cuda(x, gamma, beta, q, nh, valid, deterministic=det),
                                  args.iters)
                    emit(f"B14 {mode}", label, dtype, res)
            for label, (B, T, W, nh, valid, causal) in B7_SHAPES.items() if "B7" in want else ():
                qkv, g = (0.5 * rn(B, T, 3 * W)).to(dtype), rn(B, T, W).to(dtype)
                res = profile(lambda: _fused_mha_bwd_cuda(qkv, g, nh, valid, causal), args.iters)
                emit("B7", label, dtype, res)
            for label, (B, T, W, nh, valid, causal) in B6_SHAPES.items() if "B6" in want else ():
                qkv = (0.5 * rn(B, T, 3 * W)).to(dtype)
                res = profile(lambda: _fused_mha_cuda(qkv, nh, valid, causal), args.iters)
                emit("B6", label, dtype, res)
        for label, (M, K, N) in S6_SHAPES.items() if "S6" in want else ():
            a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
            b = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
            res = profile(lambda: int8_gemm(a, b), args.iters)
            emit("S6", f"{label} {M}x{K}x{N}", None, res)
    if "step" in want:
        emit("step", "idiomatic ViT-B/16 batch 32 cached features", torch.float32, step_trace(args.iters))
    return 0


if __name__ == "__main__":
    sys.exit(main())
