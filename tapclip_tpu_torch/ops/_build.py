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
    # a, w, bias, residual, out, M, N, K, dtype, stream
    "tapclip_gemm_bias_residual": (P, P, P, P, P, I, I, I, I, P),
    # q, k, v, valid, eot, valid_all, eot_all, out, aux, B, H, T, Dh, with_aux,
    # causal, dtype, stream (valid / eot null: valid_all / eot_all in every row)
    "tapclip_attn_aux": (P, P, P, P, P, I, I, P, P, I, I, I, I, I, I, I, P),
    # a, b, bias, c, M, N, K, trans_a, trans_b, dtype, stream
    "tapclip_gemm_f32": (P, P, P, P, I, I, I, I, I, I, P),
    # in, out, R, N, rows_per_chunk, dtype, stream
    "tapclip_col_sum": (P, P, I, I, I, I, P),
    # R, W, H, dtype -> the split of dy's depth that B5 takes there
    "tapclip_mlp_bwd_split": (I, I, I, I),
    # x, g, gamma, beta, w_fc, b_fc, w_proj, dx, ws (f32 workspace
    # R H + split R W + 2 R), wsd (scratch: R (H + W) elements of the dtype),
    # h_out, part, R, W, H, eps, split, want_w, dtype, stream
    "tapclip_mlp_bwd": (P,) * 12 + (I, I, I, F, I, I, I, P),
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
    # x, gamma, beta, w_fc, s_fc, b_fc, w_proj, s_proj, b_proj, out, R, W, H,
    # eps, seed, deterministic, variant, dtype, stream
    "tapclip_int8_mlp_walk": (P, P, P, P, P, P, P, P, P, P, I, I, I, F, U, I, I, I, P),
    # W, H
    "tapclip_int8_mlp_walk_smem_bytes": (I, I),
    # x, gamma, beta, w_qkv, s_qkv, b_qkv, w_out, s_out, b_out, out, qkv, a,
    # codes, scales, B, T, W, n_heads, valid, eps, seed, deterministic, dtype,
    # stream
    "tapclip_int8_attn": (P,) * 14 + (I, I, I, I, I, F, U, I, I, P),
    # a, b, bt (scratch), c, M, N, K, out_f32, stream
    "tapclip_int8_gemm": (P, P, P, P, I, I, I, I, P),
    # K -> Kp, the depth of int8_gemm's transposed B scratch [N, Kp]
    "tapclip_int8_gemm_kp": (I,),
    # b, bt, K, N, stream: b [K, N] int8 -> bt [N, Kp] K-major
    "tapclip_int8_transpose": (P, P, I, I, P),
    # x, gamma, beta, w_fc, b_fc, w_proj, b_proj, out, R, W, H, eps, rows,
    # erf3, ln1pass, ilv, dtype, stream
    "tapclip_fused_mlp_variant": (P, P, P, P, P, P, P, P, I, I, I, F, I, I, I, I, I, P),
    # x, gamma, beta, w_qkv, b_qkv, w_out, ws, attn, part, B, T, W, n_heads,
    # valid, eps, form, sum_rounded, tail_split, smem_qkv, interleaved,
    # ln1pass, qk_round, fold_q, mask, group, dtype, stream
    "tapclip_attn_variant_online": (P,) * 9 + (I,) * 5 + (F,) + (I,) * 11 + (P,),
    "tapclip_attn_variant_two_pass": (P,) * 9 + (I,) * 5 + (F,) + (I,) * 11 + (P,),
    # T, smem_qkv, interleaved
    "tapclip_attn_variant_smem_bytes": (I, I, I),
    # part, groups, b_out, x, out, R, W, dtype, stream
    "tapclip_attn_partials_reduce": (P, I, P, P, P, I, I, I, P),
    # x, gamma1, beta1, w_qkv, b_qkv, w_out, b_out, gamma2, beta2, w_fc, b_fc,
    # w_proj, b_proj, ws, attn, out, B, T, W, n_heads, H, valid, eps, grid,
    # dtype, stream
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

