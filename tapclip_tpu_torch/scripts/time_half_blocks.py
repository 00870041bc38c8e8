"""Time the kernels K1, K2, B5, B4, B13, B14, B7 and B6 of one checkout of the port.

    python3 tapclip_tpu_torch/scripts/time_half_blocks.py [--root DIR] [--runs N] [--kernels B14,B7]

Imports ``tapclip_tpu_torch`` from the checkout at ``DIR`` (default: the one
holding this file), builds its kernels, and prints one JSON line: the card's
name and power limit, then CUDA-event ms (mean of 20 calls after 3 warm-up
calls, ``--runs`` readings each), float32 and bfloat16, of

* ``fused_mlp_block`` and ``fused_attn_block``, the wrappers the model calls,
  and B5's wrapper (``_fused_mlp_bwd_cuda``) for dx alone and for all seven
  gradients;
* their launches alone through the C interface, on buffers allocated once:
  K1 (``tapclip_fused_mlp``); K2 (``tapclip_attn_block``, or in a checkout
  from before its tensor-core design its core ``tapclip_attn_block_core``
  and its out-projection ``tapclip_gemm_bias_residual``, each alone and
  together); B5 for dx alone (``tapclip_mlp_bwd``, or before
  ``tapclip_mlp_bwd_rows``), at the split of dy's depth it chooses and, where
  it takes a ``split``, at each of 1, 2 and 4;
* B4's wrapper (``_attn_block_bwd_cuda``) for dx alone and for all seven
  gradients, and its launches alone for dx (``tapclip_attn_block_bwd``, in
  a checkout that has it) at its split of dy's depth and at 1, 2 and 4;
* B13's wrapper (``int8_mlp_cuda`` on weights quantized once: it lays them
  out on every call) and its launches alone on weights laid out once
  (``tapclip_int8_mlp``: in a checkout from before its tensor-core design the
  one ``__dp4a`` launch on packed weights), stochastic and round to nearest;
* B14's wrapper (``int8_attn_cuda`` on weights quantized once: it lays them
  out on every call) and its launches alone on weights laid out once
  (``tapclip_int8_attn``: in a checkout from before its tensor-core design
  its three launches ``tapclip_int8_qkv``, ``tapclip_int8_attn_core`` and
  ``tapclip_int8_out`` on packed weights), stochastic and round to nearest;
* B7's wrapper (``_fused_mha_bwd_cuda``) and its launches alone
  (``tapclip_mha_bwd``, with its lse / delta scratch where it takes one);
  at ViT-L/14's lengths (``B7_LONG_SHAPES``) its launches alone and, in a
  checkout whose autograd Function sent them to the flash chain on the
  packed strides (``_mha_flash_bwd_cuda``, on the forward's output computed
  once), the chain beside them;
* B6's wrapper (``_fused_mha_cuda``) and its launch alone (``tapclip_mha``).

K1 at ViT-B/16's image shape (8 x 200 rows, W 768) and the text tower's
shapes (a 64-text batch, 64 x 80 rows, and 8 x 88 rows, W 512); K2 at the
image shape (12 heads, valid 197) and the text shape (8 x 88, W 512, 8
heads, valid 82); B5 at the text shape (H 2,048) and the image shape (H
3,072); B4 at K2's two shapes; B13 at the image shape (H 3,072) and the
pruned one (8 x 96 rows); B14 at the image shape (12 heads, valid 197) and
the pruned one (8 x 96, no mask); B7 at the idiomatic step's shape (8 x 77,
W 512, 8 heads, causal), the 64-text batch (64 x 80, valid 77, causal) and
the fused_split image shape (8 x 200, W 768, 12 heads, valid 197), and
at ViT-L/14's 4 x 257 and 4 x 584 (W 1,024, 16 heads); B6 at B7's first
three shapes.  Each launcher's C signature is read from the checkout's own
``_build._SIGNATURES``: where K1 takes a scratch pointer (h and y, R (H + W)
elements of the dtype) the scratch is allocated once beside the buffers.

``--kernels`` times only the named kernels (default: all eight).  To
compare two commits on one card, unpack both and run this file against
each in turn within one machine: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

K2_SHAPES = {"image 8x200x768 h12 valid197": (8, 200, 768, 12, 197), "text 8x88x512 h8 valid82": (8, 88, 512, 8, 82)}
K1_SHAPES = {"image 8x200x768": (8, 200, 768), "text batch 64x80x512": (64, 80, 512), "text 8x88x512": (8, 88, 512)}
B5_SHAPES = {"text 8x88x512": (8, 88, 512), "image 8x200x768": (8, 200, 768)}
B13_SHAPES = {"image 8x200x768 H3072": (8, 200, 768), "pruned 8x96x768 H3072": (8, 96, 768)}
B13_WALK_ARGS = 19  # tapclip_int8_mlp's arguments in the __dp4a design (packed weights, no scratch)
B14_SHAPES = {"image 8x200x768 h12 valid197": (8, 200, 768, 12, 197), "pruned 8x96x768 h12": (8, 96, 768, 12, 96)}
B7_SHAPES = {"idiomatic 8x77x512 h8 causal": (8, 77, 512, 8, 77, True),
             "text 64x80x512 h8 valid77 causal": (64, 80, 512, 8, 77, True),
             "image 8x200x768 h12 valid197": (8, 200, 768, 12, 197, False)}
# ViT-L/14 at 224 and 336 px (T 257 and 577 + 7 pad keys, not causal): past B4's routing limit.
B7_LONG_SHAPES = {"vit-l 4x257x1024 h16": (4, 257, 1024, 16, 257, False),
                  "vit-l336 4x584x1024 h16 valid577": (4, 584, 1024, 16, 577, False)}
B6_SHAPES = B7_SHAPES
B7_CORE_ARGS = 11  # tapclip_mha_bwd's arguments in the [T, T]-core design (no lse / delta scratch)
B5_SPLITS = (1, 2, 4)  # the splits of dy's depth that tapclip_mlp_bwd takes, each timed where it takes one
K1_ARGS = 14  # tapclip_fused_mlp's arguments without a scratch pointer


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--kernels", default="K1,K2,B5,B4,B13,B14,B7,B6")
    args = ap.parse_args()
    want = set(args.kernels.split(","))
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("time_half_blocks: needs a CUDA device", file=sys.stderr)
        return 1
    from tapclip_tpu_torch.ops import _build
    from tapclip_tpu_torch.ops import int8_attn, int8_mlp
    from tapclip_tpu_torch.ops import fused_mha as fm
    from tapclip_tpu_torch.ops.fused_mha import (
        _attn_block_bwd_cuda,
        _fused_mha_bwd_cuda,
        _fused_mha_cuda,
        fused_attn_block,
    )
    from tapclip_tpu_torch.ops.fused_mlp import _fused_mlp_bwd_cuda, fused_mlp_block

    # This file's own helpers, whichever checkout the package comes from.
    sys.path.append(str(Path(__file__).resolve().parent))
    from _bench_util import card_line, time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _build.library()
    sig = _build._SIGNATURES
    k1_scratch = len(sig["tapclip_fused_mlp"]) > K1_ARGS
    stream = _build.stream_handle(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    def ln_params(W):
        return {"scale": 1.0 + rn(W, s=0.1), "bias": rn(W, s=0.1)}

    def mlp_params(W):
        return {"w_fc": rn(W, 4 * W, s=W ** -0.5), "b_fc": rn(4 * W, s=0.1),
                "w_proj": rn(4 * W, W, s=(4 * W) ** -0.5), "b_proj": rn(W, s=0.1)}

    readings = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        code = _build.dtype_code(dtype)
        calls = {}
        for label, (B, T, W) in K1_SHAPES.items():
            x, ln, mlp = rn(B, T, W).to(dtype), ln_params(W), mlp_params(W)
            wd = {k: mlp[k].to(dtype) for k in ("w_fc", "w_proj")}
            R, H = B * T, 4 * W
            out = torch.empty_like(x)
            ws = torch.empty(R * (H + W), dtype=dtype, device="cuda") if k1_scratch else None
            scratch = (ws.data_ptr(),) if k1_scratch else ()
            k1_args = (x.data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(), wd["w_fc"].data_ptr(),
                       mlp["b_fc"].data_ptr(), wd["w_proj"].data_ptr(), mlp["b_proj"].data_ptr(), out.data_ptr(),
                       *scratch, R, W, H, 1e-5, code, _build.stream_handle(x.device))
            # Default arguments keep each case's buffers alive with its closure.
            calls[f"K1 wrapper {label}"] = lambda x=x, ln=ln, mlp=mlp: fused_mlp_block(x, ln, mlp)
            calls[f"K1 launch {label}"] = lambda a=k1_args, keep=(x, out, wd, ws): lib.tapclip_fused_mlp(*a)

        for label, (B, T, W, nh, valid) in K2_SHAPES.items():
            x, ln = rn(B, T, W).to(dtype), ln_params(W)
            attn = {"w_qkv": rn(W, 3 * W, s=W ** -0.5), "b_qkv": rn(3 * W, s=0.1),
                    "w_out": rn(W, W, s=W ** -0.5), "b_out": rn(W, s=0.1)}
            wd = {k: v.to(dtype) for k, v in attn.items() if k.startswith("w_")}
            out, a_buf = torch.empty_like(x), torch.empty_like(x)
            ws = torch.empty((B * T * 3 * W,), device="cuda")
            p = (x.data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(), wd["w_qkv"].data_ptr(),
                 attn["b_qkv"].data_ptr())
            keep = (x, out, a_buf, ws, wd, ln, attn)
            calls[f"K2 wrapper {label}"] = lambda x=x, ln=ln, attn=attn, nh=nh, v=valid: fused_attn_block(
                x, ln, attn, nh, valid_len=v)
            if "tapclip_attn_block" in sig:
                a = (*p, wd["w_out"].data_ptr(), attn["b_out"].data_ptr(), out.data_ptr(), ws.data_ptr(),
                     a_buf.data_ptr(), B, T, W, nh, valid, 1e-5, code, stream)
                calls[f"K2 launches {label}"] = lambda a=a, keep=keep: lib.tapclip_attn_block(*a)
            else:
                core = (*p, ws.data_ptr(), a_buf.data_ptr(), B, T, W, nh, valid, 1e-5, code, stream)
                proj = (a_buf.data_ptr(), wd["w_out"].data_ptr(), attn["b_out"].data_ptr(), x.data_ptr(),
                        out.data_ptr(), B * T, W, W, code, stream)

                def both(core=core, proj=proj, keep=keep):
                    lib.tapclip_attn_block_core(*core)
                    lib.tapclip_gemm_bias_residual(*proj)

                calls[f"K2 launches {label}"] = both
                calls[f"K2 core launch {label}"] = lambda a=core, keep=keep: lib.tapclip_attn_block_core(*a)
                calls[f"K2 out-projection launch {label}"] = lambda a=proj, keep=keep: lib.tapclip_gemm_bias_residual(*a)

        for label, (B, T, W) in B5_SHAPES.items():
            x, g, ln, mlp = rn(B, T, W).to(dtype), rn(B, T, W).to(dtype), ln_params(W), mlp_params(W)
            prm = (ln["scale"], ln["bias"], mlp["w_fc"], mlp["b_fc"], mlp["w_proj"])
            R, H = B * T, 4 * W
            wd = {k: mlp[k].to(dtype) for k in ("w_fc", "w_proj")}
            dx = torch.empty_like(x)
            head = (x.data_ptr(), g.data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(), wd["w_fc"].data_ptr(),
                    mlp["b_fc"].data_ptr(), wd["w_proj"].data_ptr(), dx.data_ptr())
            if "tapclip_mlp_bwd" in sig:
                auto = lib.tapclip_mlp_bwd_split(R, W, H, code)
                for i, S in enumerate((auto, *B5_SPLITS)):
                    ws = torch.empty(R * H + S * R * W + 2 * R, device="cuda")
                    wsd = torch.empty(R * (H + W), dtype=dtype, device="cuda")
                    a = (*head, ws.data_ptr(), wsd.data_ptr(), None, None, R, W, H, 1e-5, S, 0, code, stream)
                    keep = (x, g, dx, ws, wsd, wd, ln, mlp)
                    name = f"B5 dx launches split {S} {label}" if i else f"B5 dx launches {label}"
                    calls[name] = lambda a=a, keep=keep: lib.tapclip_mlp_bwd(*a)
            else:
                a = (*head, None, None, None, None, R, W, H, 1e-5, 0, code, stream)
                keep = (x, g, dx, wd, ln, mlp)
                calls[f"B5 dx launches {label}"] = lambda a=a, keep=keep: lib.tapclip_mlp_bwd_rows(*a)
            calls[f"B5 dx wrapper {label}"] = lambda x=x, g=g, prm=prm: _fused_mlp_bwd_cuda(
                x, g, *prm, eps=1e-5, weight_grads=False)
            calls[f"B5 all wrapper {label}"] = lambda x=x, g=g, prm=prm: _fused_mlp_bwd_cuda(x, g, *prm, eps=1e-5)
        for label, (B, T, W, nh, valid) in K2_SHAPES.items():
            x, g, ln = rn(B, T, W).to(dtype), rn(B, T, W).to(dtype), ln_params(W)
            prm = (ln["scale"], ln["bias"], rn(W, 3 * W, s=W ** -0.5), rn(3 * W, s=0.1), rn(W, W, s=W ** -0.5))
            R = B * T
            if "tapclip_attn_block_bwd" in sig:
                wd = (prm[2].to(dtype), prm[4].to(dtype))
                dx = torch.empty_like(x)
                auto = lib.tapclip_attn_block_bwd_split(R, W, code)
                for i, S in enumerate((auto, *B5_SPLITS)):
                    ws = torch.empty(R * (4 * W + S * W + 2 + 2 * nh), device="cuda")
                    wsd = torch.empty(R * 4 * W, dtype=dtype, device="cuda")
                    a = (x.data_ptr(), g.data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(), wd[0].data_ptr(),
                         prm[3].data_ptr(), wd[1].data_ptr(), dx.data_ptr(), ws.data_ptr(), wsd.data_ptr(), None,
                         B, T, W, nh, valid, 1e-5, S, 0, code, stream)
                    keep = (x, g, dx, ws, wsd, wd, prm)
                    name = f"B4 dx launches split {S} {label}" if i else f"B4 dx launches {label}"
                    calls[name] = lambda a=a, keep=keep: lib.tapclip_attn_block_bwd(*a)
            for mode, want_w in (("dx", False), ("all", True)):
                calls[f"B4 {mode} wrapper {label}"] = lambda x=x, g=g, prm=prm, nh=nh, v=valid, w=want_w: (
                    _attn_block_bwd_cuda(x, g, *prm, nh, v, 1e-5, weight_grads=w))

        for label, (B, T, W) in B13_SHAPES.items():
            x, ln, H = rn(B, T, W).to(dtype), ln_params(W), 4 * W
            q = int8_mlp.quantize_mlp(mlp_params(W))
            R = B * T
            out = torch.empty_like(x)
            vec = (q["s_fc"], q["b_fc"], q["s_proj"], q["b_proj"])
            if len(sig["tapclip_int8_mlp"]) == B13_WALK_ARGS:
                w = (int8_mlp.pack_k4(q["w_fc"]), int8_mlp.pack_k4(q["w_proj"]))
                scratch, tail = (), (0,)  # the variant switch
            else:
                Wp, Hp = lib.tapclip_int8_gemm_kp(W), lib.tapclip_int8_gemm_kp(H)
                w = (int8_mlp.k_major(q["w_fc"], Wp), int8_mlp.k_major(q["w_proj"], Hp))
                bufs = (torch.empty((R, H), device="cuda"), torch.empty((R, Wp), dtype=torch.int8, device="cuda"),
                        torch.empty((R, Hp), dtype=torch.int8, device="cuda"), torch.empty((3, R), device="cuda"))
                scratch, tail = tuple(t.data_ptr() for t in bufs), ()
                w = (*w, bufs)
            for mode, det in (("stochastic", 0), ("round-to-nearest", 1)):
                a = (x.data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(), w[0].data_ptr(),
                     vec[0].data_ptr(), vec[1].data_ptr(), w[1].data_ptr(), vec[2].data_ptr(), vec[3].data_ptr(),
                     out.data_ptr(), *scratch, R, W, H, 1e-5, 0, det, *tail, code, stream)
                keep = (x, out, w, vec, ln, q)
                calls[f"B13 launches {label} {mode}"] = lambda a=a, keep=keep: lib.tapclip_int8_mlp(*a)
                calls[f"B13 wrapper {label} {mode}"] = lambda x=x, ln=ln, q=q, det=bool(det): int8_mlp.int8_mlp_cuda(
                    x, ln["scale"], ln["bias"], q, deterministic=det)

        for label, (B, T, W, nh, valid) in B14_SHAPES.items():
            x, ln, R = rn(B, T, W).to(dtype), ln_params(W), B * T
            q = int8_attn.quantize_attn({"w_qkv": rn(W, 3 * W, s=W ** -0.5), "b_qkv": rn(3 * W, s=0.1),
                                         "w_out": rn(W, W, s=W ** -0.5), "b_out": rn(W, s=0.1)})
            out = torch.empty_like(x)
            vec = tuple(q[k].data_ptr() for k in ("s_qkv", "b_qkv", "s_out", "b_out"))
            g_b = (ln["scale"].data_ptr(), ln["bias"].data_ptr())
            if "tapclip_int8_attn" in sig:
                Wp = lib.tapclip_int8_gemm_kp(W)
                w = (int8_mlp.k_major(q["w_qkv"], Wp), int8_mlp.k_major(q["w_out"], Wp))
                bufs = (torch.empty((R, 3 * W), device="cuda"), torch.empty((R, W), device="cuda"),
                        torch.empty((R, Wp), dtype=torch.int8, device="cuda"), torch.empty((3, R), device="cuda"))
            else:  # the three launches of the __dp4a / FMA design, on packed weights
                w = (int8_mlp.pack_k4(q["w_qkv"]), int8_mlp.pack_k4(q["w_out"]))
                bufs = (torch.empty((R, 3 * W), device="cuda"), torch.empty((R, W), device="cuda"))
            for mode, det in (("stochastic", 0), ("round-to-nearest", 1)):
                keep = (x, out, w, bufs, ln, q)
                if "tapclip_int8_attn" in sig:
                    a = (x.data_ptr(), *g_b, w[0].data_ptr(), vec[0], vec[1], w[1].data_ptr(), vec[2], vec[3],
                         out.data_ptr(), *(t.data_ptr() for t in bufs), B, T, W, nh, valid, 1e-5, 0, det, code,
                         stream)
                    calls[f"B14 launches {label} {mode}"] = lambda a=a, keep=keep: lib.tapclip_int8_attn(*a)
                else:
                    qkv, att = bufs
                    round_p = int(not det and dtype == torch.bfloat16)
                    a3 = ((x.data_ptr(), *g_b, w[0].data_ptr(), vec[0], vec[1], qkv.data_ptr(), R, W, 1e-5, 0, det,
                           code, stream),
                          (qkv.data_ptr(), att.data_ptr(), B, T, W, nh, valid, round_p, stream),
                          (att.data_ptr(), w[1].data_ptr(), vec[2], vec[3], x.data_ptr(), out.data_ptr(), R, W, 0,
                           det, code, stream))

                    def three(a3=a3, keep=keep):
                        lib.tapclip_int8_qkv(*a3[0])
                        lib.tapclip_int8_attn_core(*a3[1])
                        lib.tapclip_int8_out(*a3[2])

                    calls[f"B14 launches {label} {mode}"] = three
                calls[f"B14 wrapper {label} {mode}"] = lambda x=x, ln=ln, q=q, nh=nh, v=valid, det=bool(det): (
                    int8_attn.int8_attn_cuda(x, ln["scale"], ln["bias"], q, nh, v, deterministic=det))

        for label, (B, T, W, nh, valid, causal) in {**B7_SHAPES, **B7_LONG_SHAPES}.items():
            qkv, g = (0.5 * rn(B, T, 3 * W)).to(dtype), rn(B, T, W).to(dtype)
            dqkv = torch.empty_like(qkv)
            scratch = ()
            if len(sig["tapclip_mha_bwd"]) > B7_CORE_ARGS:  # lse and delta, f32 [B H, T] each
                ws = torch.empty(2 * B * nh * T, device="cuda")
                scratch = (ws.data_ptr(),)
            a = (qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), *scratch, B, T, W, nh, valid, int(causal), code,
                 stream)
            keep = (qkv, g, dqkv, ws if scratch else None)
            calls[f"B7 launches {label}"] = lambda a=a, keep=keep: lib.tapclip_mha_bwd(*a)
            if label in B7_LONG_SHAPES:
                if hasattr(fm, "_mha_flash_bwd_cuda"):
                    out = _fused_mha_cuda(qkv, nh, valid, causal)
                    calls[f"B7 chain {label}"] = lambda qkv=qkv, g=g, out=out, nh=nh, v=valid, c=causal: (
                        fm._mha_flash_bwd_cuda(qkv, g, out, nh, v, c))
                continue
            calls[f"B7 wrapper {label}"] = lambda qkv=qkv, g=g, nh=nh, v=valid, c=causal: _fused_mha_bwd_cuda(
                qkv, g, nh, v, c)
        for label, (B, T, W, nh, valid, causal) in B6_SHAPES.items():
            qkv = (0.5 * rn(B, T, 3 * W)).to(dtype)
            out = torch.empty((B, T, W), dtype=dtype, device="cuda")
            a = (qkv.data_ptr(), out.data_ptr(), B, T, W, nh, valid, int(causal), code, stream)
            calls[f"B6 launch {label}"] = lambda a=a, keep=(qkv, out): lib.tapclip_mha(*a)
            calls[f"B6 wrapper {label}"] = lambda qkv=qkv, nh=nh, v=valid, c=causal: _fused_mha_cuda(qkv, nh, v, c)
        with torch.inference_mode():
            for name, fn in calls.items():
                if name.split()[0] not in want:
                    continue
                readings[f"{name} {dname}"] = [time_ms(fn, 20, 3) for _ in range(args.runs)]
    print(json.dumps({"root": args.root, "card": card_line(), "k1_scratch": k1_scratch, "ms": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
