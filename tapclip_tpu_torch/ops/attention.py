"""Multi-head attention with an optional attribution aux output.

Counterpart of ``tapclip_tpu/ops/attention.py``.  Attention returns the
head-averaged probability column ``P[:, :, :, attn_to_idx]`` as an aux
``[B, T]`` output when asked, in place of the reference's forward hook; only
that slice is produced, never the ``[B, H, T, T]`` map, by the kernel.

Two implementations share one interface:
  * ``xla``    -- :func:`attention_reference`, plain PyTorch (the name is the
                  JAX package's, so configs compare equal).
  * ``pallas`` -- :func:`tapclip_tpu_torch.ops.flash_attention.fused_attention`,
                  the hand-written CUDA kernel K3 on a CUDA tensor, whose
                  backward is the flash chain (``csrc/flash_bwd.cu``).

``causal`` masks key > query (the CLIP text tower).

``auto`` sends aux-bearing calls to the kernel and the rest to the plain
version, as the JAX package routes them on its TPU.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

IntOrTensor = Union[int, torch.Tensor, None]


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_valid_len: IntOrTensor = None,
    attn_to_idx: IntOrTensor = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain attention over ``q, k, v [B, H, T, Dh]``.

    ``causal`` masks every key after the query; ``kv_valid_len`` (int or
    ``[B]``) masks keys at or past the valid length; ``attn_to_idx`` (int or
    ``[B]``) also returns the head-averaged probability of every query
    attending to that key, ``[B, T]`` f32.  Logits and softmax
    in f32; ``p`` is rounded to ``v.dtype`` before ``p @ v`` and the output
    returned in ``q.dtype``, as in the JAX version.
    """
    B, H, T, Dh = q.shape
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (Dh ** -0.5)
    ki = torch.arange(k.shape[2], device=q.device)
    neg = torch.finfo(torch.float32).min
    if causal:
        qi = torch.arange(T, device=q.device)[:, None]
        logits = torch.where(ki <= qi, logits, torch.full_like(logits, neg))
    if kv_valid_len is not None:
        valid = torch.as_tensor(kv_valid_len, device=q.device).reshape(-1, 1, 1, 1)
        logits = torch.where(ki < valid, logits, torch.full_like(logits, neg))
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)

    aux = None
    if attn_to_idx is not None:
        head_mean = probs.mean(dim=1)  # [B, T, Tk]
        if isinstance(attn_to_idx, int):
            aux = head_mean[:, :, attn_to_idx]
        else:
            idx = attn_to_idx.to(device=q.device, dtype=torch.long).reshape(B, 1, 1)
            aux = torch.take_along_dim(head_mean, idx.expand(B, T, 1), dim=2)[:, :, 0]
    return out, aux


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_valid_len: IntOrTensor = None,
    attn_to_idx: IntOrTensor = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dispatching attention entry point; shapes as in :func:`attention_reference`."""
    if impl == "auto":
        impl = "pallas" if attn_to_idx is not None else "xla"
    kw = dict(causal=causal, kv_valid_len=kv_valid_len, attn_to_idx=attn_to_idx)
    if impl == "xla":
        return attention_reference(q, k, v, **kw)
    if impl == "pallas":
        from tapclip_tpu_torch.ops.flash_attention import fused_attention

        return fused_attention(q, k, v, **kw)
    raise ValueError(f"unknown attention impl {impl!r}")
