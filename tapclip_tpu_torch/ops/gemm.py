"""Wrappers of ``csrc/gemm.cu``: the products and column sums that the
backward kernels B4 and B5 share when a weight gradient is wanted
(pretraining), and their plain versions.

:func:`gemm_f32` and :func:`col_sum` take CUDA tensors only, since their
callers run them only on the card; each counts its calls in ``.launches``.
:func:`gemm_reference` and :func:`col_sum_reference` compute the same
functions in plain torch: the plain backwards of B4 and B5
(``attn_block_bwd_reference``, ``fused_mlp_bwd_reference``) take their
weight gradients and bias sums from them, and the card's tests and
``chip_smoke.py`` hold the kernels against them.
"""

from __future__ import annotations

import torch

from tapclip_tpu_torch.ops import _build

_INVALID_VALUE = 1  # cudaErrorInvalidValue: what gemm.cu refuses


def gemm_reference(a, b, *, bias=None, trans_a=False, trans_b=False):
    """Plain version of :func:`gemm_f32`: ``op(a) @ op(b) (+ bias)`` on the
    operands widened to f32."""
    a32, b32 = a.float(), b.float()
    c = (a32.T if trans_a else a32) @ (b32.T if trans_b else b32)
    return c if bias is None else c + bias.float()


def col_sum_reference(t):
    """Plain version of :func:`col_sum`: the column sums of ``t`` in f32."""
    return t.float().sum(0)


def _refusal(a, b, N):
    """Why ``csrc/gemm.cu`` refuses these operands, or None: N or a stored
    row length not a multiple of 4, an operand not 16-byte (f32) or 8-byte
    (bf16) aligned."""
    if N % 4:
        return f"N = {N} is not a multiple of 4"
    for name, t in (("a", a), ("b", b)):
        if t.shape[1] % 4:
            return f"{name}'s rows hold {t.shape[1]} elements, not a multiple of 4"
        align = 16 if t.dtype == torch.float32 else 8
        if t.data_ptr() % align:
            return f"{name} is not {align}-byte aligned"
    return None


def gemm_f32(a, b, *, bias=None, trans_a=False, trans_b=False, split=None):
    """``op(a) @ op(b) (+ bias)`` in f32 by ``csrc/gemm.cu`` on the tensor
    cores: a is ``[M, K]`` (``[K, M]`` with ``trans_a``), b is ``[K, N]``
    (``[N, K]`` with ``trans_b``), both of one dtype, contiguous, on the card.
    The K rows split ``split`` ways into f32 partials summed in order
    (default: the dispatcher's split for the shape); a hook for tests and
    timing: every split gives the product."""
    if trans_a and trans_b:
        raise ValueError("gemm_f32 takes at most one transposed operand")
    M, K = (a.shape[1], a.shape[0]) if trans_a else a.shape
    N = b.shape[0] if trans_b else b.shape[1]
    want_b = (N, K) if trans_b else (K, N)
    _build.check_cuda_operand("a", a)
    _build.check_cuda_operand("b", b, a.dtype, want_b)
    if bias is not None:
        _build.check_cuda_operand("bias", bias, torch.float32, (N,))
    reason = _refusal(a, b, N)
    if reason is not None:
        raise ValueError(f"gemm_f32 refuses these operands: {reason}")
    lib, code = _build.library(), _build.dtype_code(a.dtype)
    S = lib.tapclip_gemm_f32_split(M, N, K, code) if split is None else int(split)
    c = torch.empty((M, N), dtype=torch.float32, device=a.device)
    ws = torch.empty((S, M, N), dtype=torch.float32, device=a.device) if S > 1 else None
    err = lib.tapclip_gemm_f32_ws(
        a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(), c.data_ptr(),
        None if ws is None else ws.data_ptr(), M, N, K, int(trans_a), int(trans_b), code, S,
        _build.stream_handle(a.device),
    )
    if err == _INVALID_VALUE:
        raise ValueError(f"gemm_f32 refuses split {S} for {M} x {N} x {K}")
    _build.check(err, "tapclip_gemm_f32_ws")
    gemm_f32.launches += 1
    return c


gemm_f32.launches = 0


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
    col_sum.launches += 1
    return out[0]


col_sum.launches = 0  # wrapper calls (two kernel launches each)
