"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), all started together, and the
objects are linked into ONE shared library with a plain C interface, loaded
with ``ctypes``.  Nothing includes PyTorch's headers, so a build takes
seconds instead of minutes.

The library lands in ``build/tapclip_kernels/<hash>/`` beside the package
(``.gitignore`` lists ``build/``), keyed by a hash of the sources and the
flags: a changed source builds anew, an unchanged one loads the earlier
build.  The build runs at first use, never at import.  A missing ``nvcc`` or
a failed build raises.

Each launcher returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when it is not 0 (a refused launch never runs, and a
later ``synchronize`` would not report it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "tapclip_kernels"
NVCC_FALLBACK = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint
F = ctypes.c_float

# C signature of every launcher: argument types in order.  Pointers and the
# stream are c_void_p (ctypes would cut a Python int to 32 bits otherwise).
_SIGNATURES = {
    # x, gamma, beta, w_fc, b_fc, w_proj, b_proj, out, ws (scratch: R * (H + W)
    # elements of the dtype), R, W, H, eps, dtype, stream
    "tapclip_fused_mlp": (P, P, P, P, P, P, P, P, P, I, I, I, F, I, P),
    # x, gamma, beta, w_qkv, b_qkv, w_out, b_out, out, qkv (f32 workspace
    # R * 3W), ya (scratch: R * W elements of the dtype), B, T, W, n_heads,
    # valid, eps, dtype, stream
    "tapclip_attn_block": (P,) * 10 + (I,) * 5 + (F, I, P),
    # q, k, v, valid, eot, valid_all, eot_all, out, aux, B, H, T, Dh, with_aux,
    # causal, dtype, stream (valid / eot null: valid_all / eot_all in every row)
    "tapclip_attn_aux": (P, P, P, P, P, I, I, P, P, I, I, I, I, I, I, I, P),
    # a, b, bias, c, M, N, K, trans_a, trans_b, dtype, stream (the rows unsplit)
    "tapclip_gemm_f32": (P, P, P, P, I, I, I, I, I, I, P),
    # M, N, K, dtype -> the split of the rows taken there
    "tapclip_gemm_f32_split": (I, I, I, I),
    # a, b, bias, c, ws (f32 [split, M, N] when split > 1), M, N, K, trans_a,
    # trans_b, dtype, split, stream
    "tapclip_gemm_f32_ws": (P, P, P, P, P, I, I, I, I, I, I, I, P),
    # in, out, R, N, rows_per_chunk, dtype, stream
    "tapclip_col_sum": (P, P, I, I, I, I, P),
    # R, W, H, dtype -> the split of dy's depth that B5 takes there
    "tapclip_mlp_bwd_split": (I, I, I, I),
    # x, g, gamma, beta, w_fc, b_fc, w_proj, dx, ws (f32 workspace
    # R H + split R W + 2 R), wsd (scratch: R (H + W) elements of the dtype),
    # h_out, part, R, W, H, eps, split, want_w, dtype, stream
    "tapclip_mlp_bwd": (P,) * 12 + (I, I, I, F, I, I, I, P),
    # the partial modes (tensor parallelism): x, gamma, beta, w_fc, b_fc,
    # w_proj, out (f32 [R, W]), ws, R, W, H (the rank's), eps, dtype, stream
    "tapclip_fused_mlp_partial": (P,) * 8 + (I, I, I, F, I, P),
    # x, gamma, beta, w_qkv, b_qkv, w_out, out (f32 [R, W]), qkv (f32
    # R * 3 Wl), ya, B, T, W, Wl, n_heads (the rank's), valid, eps, dtype, stream
    "tapclip_attn_block_partial": (P,) * 9 + (I,) * 6 + (F, I, P),
    # x, g, gamma, beta, w_fc, b_fc, w_proj, ws, wsd, h_out, R, W, H, eps,
    # split, want_w, dtype, stream (tapclip_mlp_bwd's launches 1-4)
    "tapclip_mlp_bwd_partial": (P,) * 10 + (I, I, I, F, I, I, I, P),
    # x, g, gamma, beta, w_qkv, b_qkv, w_out, ws, wsd, B, T, W, Wl, n_heads,
    # valid, eps, split, want_w, dtype, stream (tapclip_attn_block_bwd's 1-6)
    "tapclip_attn_block_bwd_partial": (P,) * 9 + (I,) * 6 + (F, I, I, I, P),
    # x, g, dy (f32 [split, R, W]), gamma, mean, rstd, dx, part, R, W, split,
    # want_w, dtype, stream (the LayerNorm backward that ends both)
    "tapclip_ln_bwd": (P,) * 8 + (I, I, I, I, I, P),
    # Dh
    "tapclip_attn_bwd_max_seq": (I,),
    # R, W, dtype -> the split of dy's depth that B4 takes there
    "tapclip_attn_block_bwd_split": (I, I, I),
    # x, g, gamma, beta, w_qkv, b_qkv, w_out, dx, ws (f32 workspace
    # R (4W + split W + 2 + 2 n_heads)), wsd (scratch: R (4W + W want_w)
    # elements of the dtype), part, B, T, W, n_heads, valid, eps, split,
    # want_w, dtype, stream
    "tapclip_attn_block_bwd": (P,) * 11 + (I,) * 5 + (F, I, I, I, P),
    # qkv, out, B, T, W, n_heads, valid, causal, dtype, stream
    "tapclip_mha": (P, P, I, I, I, I, I, I, I, P),
    # qkv, g, dqkv, ws (f32 scratch: lse and delta, 2 B n_heads T), B, T, W,
    # n_heads, valid, causal, dtype, stream
    "tapclip_mha_bwd": (P, P, P, P, I, I, I, I, I, I, I, P),
    # q, k, valid, lse, B, H, T, Dh, sq_b, sq_h, sq_t, causal, dtype, stream
    "tapclip_flash_lse": (P, P, P, P, I, I, I, I, I, I, I, I, I, P),
    # q, k, v, g, lse, delta, valid, dk, dv, B, H, T, Dh, sq_b, sq_h, sq_t,
    # sg_b, sg_h, sg_t, causal, dtype, stream
    "tapclip_flash_bwd_dkv": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, P),
    # q, k, v, g, lse, delta, valid, dq, B, H, T, Dh, sq_b, sq_h, sq_t,
    # sg_b, sg_h, sg_t, causal, dtype, stream
    "tapclip_flash_bwd_dq": (P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, P),
    # x, gamma, beta, w_fc, s_fc, b_fc, w_proj, s_proj, b_proj, out, h, yq, hq,
    # scales, R, W, H, eps, seed, deterministic, dtype, stream
    "tapclip_int8_mlp": (P,) * 14 + (I, I, I, F, U, I, I, P),
    # tapclip_int8_mlp's arguments with variant (bit 0 erf3, bit 1 recipmul)
    # before dtype
    "tapclip_int8_mlp_variant": (P,) * 14 + (I, I, I, F, U, I, I, I, P),
    # x, gamma, beta, w_qkv, s_qkv, b_qkv, w_out, s_out, b_out, out, qkv, a,
    # codes, scales, B, T, W, n_heads, valid, eps, seed, deterministic, dtype,
    # stream
    "tapclip_int8_attn": (P,) * 14 + (I, I, I, I, I, F, U, I, I, P),
    # the partial modes of B13 and B14 (tensor parallelism): x, gamma, beta,
    # w_fc, s_fc, b_fc, h (f32 [R, H]), yq, t1, hmax (f32 [R]), R, W, H (the
    # rank's), eps, seed, deterministic, dtype, stream
    "tapclip_int8_mlp_front": (P,) * 10 + (I, I, I, F, U, I, I, P),
    # x, gamma, beta, w_qkv, s_qkv, b_qkv, qkv, a (f32 [B T, Wl]), codes, t1,
    # amax (f32 [B T]), B, T, W, Wl, n_heads (the rank's), valid, eps, seed,
    # deterministic, dtype, stream
    "tapclip_int8_attn_front": (P,) * 11 + (I,) * 6 + (F, U, I, I, P),
    # v, rmax, w, codes, t, acc (int32 [R, N]), R, K, N, col0, seed, stream_id,
    # deterministic, stream
    "tapclip_int8_partial_out": (P,) * 6 + (I, I, I, I, U, I, I, P),
    # acc, rmax, s_col, b_col, x, out, R, N, dtype, stream
    "tapclip_int8_epilogue": (P,) * 6 + (I, I, I, P),
    # a, b, bt (scratch), c, M, N, K, out_f32, stream
    "tapclip_int8_gemm": (P, P, P, P, I, I, I, I, P),
    # K -> Kp, the depth of int8_gemm's transposed B scratch [N, Kp]
    "tapclip_int8_gemm_kp": (I,),
    # b, bt, K, N, stream: b [K, N] int8 -> bt [N, Kp] K-major
    "tapclip_int8_transpose": (P, P, I, I, P),
    # x, gamma, beta, w_fc, b_fc, w_proj, b_proj, out, ws (K1's scratch:
    # R * (H + W) elements of the dtype), part (f32 [chunks, R, W] or null),
    # R, W, H, eps, row_tile, erf3, ln1pass, chunks, dtype, stream
    "tapclip_fused_mlp_variant": (P,) * 10 + (I, I, I, F, I, I, I, I, I, P),
    # x, gamma, beta, w_qkv, b_qkv, w_out, b_out, out, qkv (K2's f32 workspace
    # R * 3W, or null with smem_qkv), ya (scratch: R * W elements of the dtype,
    # 2 R W with smem_qkv), part (f32 [n_heads / group, R, W] or null), B, T, W,
    # n_heads, valid, eps, form, sum_rounded, tail_split, smem_qkv,
    # interleaved, ln1pass, qk_round, fold_q, mask, group, dtype, stream
    "tapclip_attn_variant": (P,) * 11 + (I,) * 5 + (F,) + (I,) * 11 + (P,),
    # T, dtype -> the shared memory of perhead_qkv's block
    "tapclip_attn_variant_smem_bytes": (I, I),
    # x, gamma1, beta1, w_qkv, b_qkv, w_out32 (f32), b_out, gamma2, beta2,
    # w_fc, b_fc, w_proj, b_proj, ws (f32 workspace 5 B T W), wsd (scratch:
    # B T (2W + H) elements of the dtype), out, B, T, W, n_heads, H, valid,
    # eps, grid, dtype, stream
    "tapclip_fused_layer": (P,) * 16 + (I,) * 6 + (F, I, I, P),
    # T, W, dtype
    "tapclip_fused_layer_max_grid": (I, I, I),
}

build_log: dict = {}  # "seconds", "path", "cached", "ptxas", "ptxas_by_source" of the last load


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_FALLBACK.exists():
        return str(NVCC_FALLBACK)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of tapclip_tpu_torch are built from "
        "source with the CUDA toolkit (put nvcc on PATH)"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    out_dir = BUILD_ROOT / _digest()
    so = out_dir / "libtapclip_kernels.so"
    t0 = time.perf_counter()
    cached = so.exists()
    ptxas_by_source = {}
    if not cached:
        nvcc = _nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
            # One nvcc per source, all started together, then one link.
            procs = []
            for src in sorted(CSRC.glob("*.cu")):
                obj = os.path.join(tmp_dir, src.stem + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", obj]
                procs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            outputs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, _, proc in procs]
            for cmd, out, rc in outputs:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
            ptxas_by_source = {Path(cmd[-3]).name: out for cmd, out, _ in outputs}
            tmp_so = os.path.join(tmp_dir, "lib.so")
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                   "-o", tmp_so, *(obj for _, obj, _ in procs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp_so, so)  # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    build_log.update(
        seconds=time.perf_counter() - t0, path=str(so), cached=cached,
        ptxas="".join(ptxas_by_source.values()), ptxas_by_source=ptxas_by_source,
    )
    return lib


def refuse_graph(name: str, *tensors) -> None:
    """Eval-only kernels (no backward in the JAX package): raise where
    autograd would record a graph."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is eval only (the JAX package gives it no gradient): run it under "
            "torch.no_grad() or on inputs that do not require grad"
        )


def run(op, plain, launcher, x, *args):
    """``op(x, *args)`` for a wrapper's forward, with the dispatcher left out
    where nothing traces the call: on a plain CPU or CUDA tensor, outside
    ``torch.export`` / ``torch.compile`` and every dispatch mode, the op's
    own CPU implementation ``plain`` or CUDA implementation ``launcher`` is
    called directly.  Both ways run the same function, so the bits and the
    launch counts are the same; the direct call saves the dispatcher's
    round trip into Python, several µs of host time a call.  A traced call
    (fake tensors, a mode) goes through ``op`` and stays one node."""
    import torch

    if not torch.compiler.is_compiling() and type(x) is torch.Tensor and not torch._C._len_torch_dispatch_stack():
        if x.is_cuda:
            return launcher(x, *args)
        if x.device.type == "cpu":
            return plain(x, *args)
    return op(x, *args)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def dtype_code(dtype) -> int:
    """0 for float32, 1 for bfloat16: the ``dtype`` argument of the launchers."""
    import torch

    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the CUDA kernels take float32 or bfloat16, got {dtype}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_cuda_operand(name: str, t, dtype=None, shape=None, contiguous=True) -> None:
    """Raise unless ``t`` is a CUDA tensor of ``dtype``/``shape``, contiguous
    unless the kernel reads it through strides (``contiguous=False``)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

