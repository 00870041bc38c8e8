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
    # x, gamma, beta, w_fc, b_fc, w_proj, b_proj, out, R, W, H, eps, dtype, stream
    "tapclip_fused_mlp": (P, P, P, P, P, P, P, P, I, I, I, F, I, P),
    # x, gamma, beta, w_qkv, b_qkv, qkv_ws, attn, B, T, W, n_heads, valid,
    # eps, dtype, stream
    "tapclip_attn_block_core": (P, P, P, P, P, P, P, I, I, I, I, I, F, I, P),
    # a, w, bias, residual, out, M, N, K, dtype, stream
    "tapclip_gemm_bias_residual": (P, P, P, P, P, I, I, I, I, P),
    # q, k, v, valid, eot, out, aux, B, H, T, Dh, with_aux, causal, dtype, stream
    "tapclip_attn_aux": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, P),
    # a, b, bias, c, M, N, K, trans_a, trans_b, dtype, stream
    "tapclip_gemm_f32": (P, P, P, P, I, I, I, I, I, I, P),
    # in, out, R, N, rows_per_chunk, dtype, stream
    "tapclip_col_sum": (P, P, I, I, I, I, P),
    # W
    "tapclip_mlp_bwd_rows_per_block": (I,),
    # x, g, gamma, beta, w_fc, b_fc, w_proj, dx, y_out, h_out, dhp_out, part,
    # R, W, H, eps, want_w, dtype, stream
    "tapclip_mlp_bwd_rows": (P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, F, I, I, P),
    # Dh
    "tapclip_attn_bwd_max_seq": (I,),
    # x, gamma, beta, y, mean, rstd, R, W, eps, dtype, stream
    "tapclip_ln_rows": (P, P, P, P, P, P, I, I, F, I, P),
    # qkv, gh, attn, dqkv, B, T, W, n_heads, valid, dtype, stream
    "tapclip_attn_bwd_core": (P, P, P, P, I, I, I, I, I, I, P),
    # x, g, dy, gamma, mean, rstd, dx, part, R, W, want_w, dtype, stream
    "tapclip_ln_bwd_rows": (P, P, P, P, P, P, P, P, I, I, I, I, P),
    # qkv, out, B, T, W, n_heads, valid, causal, dtype, stream
    "tapclip_mha": (P, P, I, I, I, I, I, I, I, P),
    # qkv, g, dqkv, B, T, W, n_heads, valid, causal, dtype, stream
    "tapclip_mha_bwd": (P, P, P, I, I, I, I, I, I, I, P),
    # q, k, valid, lse, B, H, T, Dh, sq_b, sq_h, sq_t, causal, dtype, stream
    "tapclip_flash_lse": (P, P, P, P, I, I, I, I, I, I, I, I, I, P),
    # q, k, v, g, lse, delta, valid, dk, dv, B, H, T, Dh, sq_b, sq_h, sq_t,
    # sg_b, sg_h, sg_t, causal, round_p, dtype, stream
    "tapclip_flash_bwd_dkv": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, I, P),
    # q, k, v, g, lse, delta, valid, dq, B, H, T, Dh, sq_b, sq_h, sq_t,
    # sg_b, sg_h, sg_t, causal, dtype, stream
    "tapclip_flash_bwd_dq": (P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, P),
    # x, gamma, beta, w_fc, s_fc, b_fc, w_proj, s_proj, b_proj, out, R, W, H,
    # eps, seed, deterministic, variant, dtype, stream
    "tapclip_int8_mlp": (P, P, P, P, P, P, P, P, P, P, I, I, I, F, U, I, I, I, P),
    # W, H
    "tapclip_int8_mlp_smem_bytes": (I, I),
    # x, gamma, beta, w_qkv, s_qkv, b_qkv, qkv, R, W, eps, seed, deterministic,
    # dtype, stream
    "tapclip_int8_qkv": (P, P, P, P, P, P, P, I, I, F, U, I, I, P),
    # qkv, a, B, T, W, n_heads, valid, round_p, stream
    "tapclip_int8_attn_core": (P, P, I, I, I, I, I, I, P),
    # a, w_out, s_out, b_out, x, out, R, W, seed, deterministic, dtype, stream
    "tapclip_int8_out": (P, P, P, P, P, P, I, I, U, I, I, P),
    # a, b, c, M, N, K, out_f32, stream
    "tapclip_int8_gemm": (P, P, P, I, I, I, I, P),
}

build_log: dict = {}  # "seconds", "path", "cached", "ptxas" of the last load


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
    ptxas = ""
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
            ptxas = "".join(out for _, out, _ in outputs)
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
        seconds=time.perf_counter() - t0, path=str(so), cached=cached, ptxas=ptxas
    )
    return lib


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

