"""Wrappers of ``csrc/gemm.cu``: the products and column sums that the
backward kernels B4 and B5 share (CUDA tensors only; no plain path, since
their callers run them only on the card)."""

from __future__ import annotations

import torch

from tapclip_tpu_torch.ops import _build


def gemm_f32(a, b, *, bias=None, trans_a=False, trans_b=False):
    """``op(a) @ op(b) (+ bias)`` in f32 by ``csrc/gemm.cu``: a is ``[M, K]``
    (``[K, M]`` with ``trans_a``), b is ``[K, N]`` (``[N, K]`` with ``trans_b``),
    both of one dtype, contiguous, on the card."""
    if trans_a and trans_b:
        raise ValueError("gemm_f32 takes at most one transposed operand")
    M, K = (a.shape[1], a.shape[0]) if trans_a else a.shape
    N = b.shape[0] if trans_b else b.shape[1]
    want_b = (N, K) if trans_b else (K, N)
    _build.check_cuda_operand("a", a)
    _build.check_cuda_operand("b", b, a.dtype, want_b)
    if bias is not None:
        _build.check_cuda_operand("bias", bias, torch.float32, (N,))
    c = torch.empty((M, N), dtype=torch.float32, device=a.device)
    err = _build.library().tapclip_gemm_f32(
        a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(), c.data_ptr(),
        M, N, K, int(trans_a), int(trans_b), _build.dtype_code(a.dtype),
        _build.stream_handle(a.device),
    )
    _build.check(err, "tapclip_gemm_f32")
    return c


_COL_CHUNK = 64


def col_sum(t, *, dtype=None):
    """Column sums of a 2-D CUDA tensor in f32 by ``csrc/gemm.cu``: row
    chunks of 64 first, then the chunks' partials, both in row order."""
    R, N = t.shape
    _build.check_cuda_operand("t", t, dtype)
    lib, stream = _build.library(), _build.stream_handle(t.device)
    chunks = -(-R // _COL_CHUNK)
    part = torch.empty((chunks, N), dtype=torch.float32, device=t.device)
    err = lib.tapclip_col_sum(t.data_ptr(), part.data_ptr(), R, N, _COL_CHUNK,
                              _build.dtype_code(t.dtype), stream)
    _build.check(err, "tapclip_col_sum")
    out = torch.empty((1, N), dtype=torch.float32, device=t.device)
    err = lib.tapclip_col_sum(part.data_ptr(), out.data_ptr(), chunks, N, chunks, 0, stream)
    _build.check(err, "tapclip_col_sum")
    return out[0]
