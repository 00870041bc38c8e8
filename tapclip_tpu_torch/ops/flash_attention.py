"""Attention with the attribution aux column: kernel K3.

Counterpart of ``tapclip_tpu/ops/flash_attention.py::fused_attention``.
On a CUDA tensor :func:`fused_attention` launches the hand-written kernel
``csrc/attn_aux.cu`` (which replaces the Pallas ``_attn_kernel`` with
``with_aux=True``); on a CPU tensor it runs the plain
:func:`tapclip_tpu_torch.ops.attention.attention_reference`.  The kernel
emits the per-head normalised probability column ``[B, H, T]``; this wrapper
takes its mean over heads, as the JAX wrapper does.  The kernel walks keys in
64-key tiles, so every T runs (T = 584, ViT-L/14 at 336 px, included).
``causal`` is the Pallas kernel's static flag (the idiomatic text mode's aux
layer): a row whose attribution key lies after it gets an aux of exactly 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tapclip_tpu_torch.ops import _build
from tapclip_tpu_torch.ops.attention import IntOrTensor, attention_reference


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_valid_len: IntOrTensor = None,
    attn_to_idx: IntOrTensor = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Same contract as ``attention_reference``: K3 on CUDA, plain on CPU."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, kv_valid_len=kv_valid_len,
                                   attn_to_idx=attn_to_idx)
    return _fused_attention_cuda(q, k, v, causal, kv_valid_len, attn_to_idx)


fused_attention.launches = 0  # every launch of K3
fused_attention.causal_launches = 0  # the causal ones among them


def _per_batch(x: IntOrTensor, batch: int, default: int, device) -> torch.Tensor:
    if x is None:
        x = default
    if isinstance(x, int):
        return torch.full((batch,), x, dtype=torch.int32, device=device)
    return x.to(device=device, dtype=torch.int32).reshape(batch).contiguous()


def _fused_attention_cuda(q, k, v, causal, kv_valid_len, attn_to_idx):
    _build.refuse_grad(q, k, v)
    B, H, T, Dh = q.shape
    dtype = q.dtype
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_cuda_operand(name, t, dtype, (B, H, T, Dh))
    if Dh not in (16, 32, 64, 128):
        raise ValueError(f"attention kernel takes head dims 16/32/64/128, got {Dh}")
    valid = _per_batch(kv_valid_len, B, T, q.device)
    eot = _per_batch(attn_to_idx, B, 0, q.device)
    with_aux = attn_to_idx is not None
    out = torch.empty_like(q)
    aux = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if with_aux else None
    err = _build.library().tapclip_attn_aux(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), eot.data_ptr(),
        out.data_ptr(), aux.data_ptr() if with_aux else None,
        B, H, T, Dh, int(with_aux), int(causal), _build.dtype_code(dtype),
        _build.stream_handle(q.device),
    )
    _build.check(err, "tapclip_attn_aux")
    fused_attention.launches += 1
    fused_attention.causal_launches += int(causal)
    return out, (aux.mean(dim=1) if with_aux else None)
