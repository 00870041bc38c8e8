"""The bare int8 product (S6): ``[M, K] x [K, N]`` int8 summed exactly in int32.

Counterpart of ``scripts/int8_probe.py::mm_kernel``, the probe that timed the
product B13 and B14 are built from, in its int8 -> int32 and int8 -> f32
forms (``make_mm``).  :func:`int8_gemm` launches the hand-written CUDA kernels
(``csrc/int8_gemm.cu``: B transposed to K-major into a scratch the wrapper
allocates, then the product on the int8 tensor cores) on CUDA tensors and runs
:func:`int8_gemm_reference`, the float64 product cast to the output type
(exact at these sizes), on CPU tensors.  No serving path calls it:
``tapclip_tpu_torch/scripts/int8_probe.py`` times it, and ``chip_smoke.py``
holds it against its plain version.
"""

from __future__ import annotations

import torch

from tapclip_tpu_torch.ops import _build

_OUT_DTYPES = (torch.int32, torch.float32)


def int8_gemm_reference(a: torch.Tensor, b: torch.Tensor, out_dtype=torch.int32) -> torch.Tensor:
    """Plain version: the float64 product (exact for int8 sums below 2^53) in ``out_dtype``."""
    return (a.double() @ b.double()).to(out_dtype)


def int8_gemm(a: torch.Tensor, b: torch.Tensor, *, out_dtype=torch.int32) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` for int8 ``a``, ``b``, as int32 or float32."""
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_gemm returns int32 or float32, not {out_dtype}")
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.shape[0] != a.shape[1]:
        raise ValueError(f"int8_gemm takes int8 [M, K] and [K, N], got {a.dtype} {tuple(a.shape)} "
                         f"and {b.dtype} {tuple(b.shape)}")
    if a.device.type == "cpu":
        return int8_gemm_reference(a, b, out_dtype)
    M, K = a.shape
    N = b.shape[1]
    if K % 4 or a.data_ptr() % 4:
        raise ValueError(f"int8_gemm kernel reads rows of A as aligned 4-byte words: K={K} must be a "
                         "multiple of 4 and A 4-byte aligned")
    _build.check_cuda_operand("a", a, torch.int8, (M, K))
    _build.check_cuda_operand("b", b, torch.int8, (K, N))
    lib = _build.library()
    # Scratch for B transposed to K-major, [N, Kp], Kp = K rounded up to the kernel's depth step.
    bt = torch.empty((N, lib.tapclip_int8_gemm_kp(K)), dtype=torch.int8, device=a.device)
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    err = lib.tapclip_int8_gemm(a.data_ptr(), b.data_ptr(), bt.data_ptr(), c.data_ptr(), M, N, K,
                                int(out_dtype == torch.float32), _build.stream_handle(a.device))
    _build.check(err, "tapclip_int8_gemm")
    int8_gemm.launches += 1
    return c


int8_gemm.launches = 0
