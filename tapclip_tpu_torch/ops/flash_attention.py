"""Attention with the attribution aux column (K3) and its backward.

Counterpart of ``tapclip_tpu/ops/flash_attention.py::fused_attention`` with
its ``custom_vjp``.  :func:`fused_attention` is one ``torch.autograd.Function``
on every device.

Its forward is the op ``tapclip::attn_aux`` (``ops/_library.py``, through
``_build.run``; the
valid length and the attribution key each as an optional ``[B]`` tensor
beside the int every row takes without one, as K3's C entry takes them).
On a CUDA tensor the op is the hand-written kernel K3
(``csrc/attn_aux.cu``, which replaces the Pallas ``_attn_kernel`` and, past
T = 2048, ``_blocked_attn_kernel``: K3 walks keys in 64-key online-softmax
tiles, so every T runs in the same shared memory).  The kernel emits the
per-head normalised probability column ``[B, H, T]``; the wrapper takes its
mean over heads, as the JAX wrapper does.  ``causal`` is the Pallas kernel's
static flag (the idiomatic text mode): a row whose attribution key lies after
it gets an aux of exactly 0.

Its backward on a CUDA tensor is the blockwise chain of ``csrc/flash_bwd.cu``
(which replaces ``_blocked_lse_kernel``, ``_blocked_bwd_dkv_kernel`` and
``_blocked_bwd_dq_kernel``, and computes the function of the single-block
``_attn_bwd_kernel`` at every T): ``delta = rowsum(dO * O)`` in plain
PyTorch, as JAX computes it outside any kernel, then three launches: the row
LSE, dK/dV over query tiles, dQ over key tiles.  The forward saves q, k, v,
the per-row valid length and the output (delta needs it).  The aux column
is consumed under ``no_grad`` (the reference detaches it): it is marked
non-differentiable and its cotangent never enters the backward.

On a CPU tensor the forward is :func:`attention_reference` and the backward
:func:`attention_bwd_reference` (the single-block kernel's formula) at every
T.  :func:`attention_bwd_blocked_reference` (the LSE / delta form) and its
pieces are the plain versions the chain's kernels are held against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tapclip_tpu_torch.ops import _build
from tapclip_tpu_torch.ops.attention import IntOrTensor, attention_reference

_LOG2E = 1.4426950408889634  # the kernels' kLog2e: scores are exp2'd


def _per_batch(x: IntOrTensor, batch: int, default: int, device) -> torch.Tensor:
    if x is None:
        x = default
    if isinstance(x, int):
        return torch.full((batch,), x, dtype=torch.int32, device=device)
    return x.to(device=device, dtype=torch.int32).reshape(batch).contiguous()


# --- plain versions ---------------------------------------------------------------


def _masked_scores(q, k, valid, causal):
    """(log2-domain scores ``q k^T Dh^-1/2 log2 e`` with masked keys at -1e30,
    the ``[B, 1, T, T]`` visibility mask), in f32."""
    B, H, T, Dh = q.shape
    s2 = q.float() @ k.float().transpose(-1, -2) * (Dh ** -0.5 * _LOG2E)
    keys = torch.arange(T, device=q.device)
    mask = keys.view(1, 1, 1, T) < _per_batch(valid, B, T, q.device).view(B, 1, 1, 1)
    if causal:
        mask = mask & (keys.view(1, 1, 1, T) <= keys.view(1, 1, T, 1))
    return torch.where(mask, s2, torch.full_like(s2, -1e30)), mask


def _grads_from_ds(p, ds, q, k, g):
    """``dq = ds k, dk = ds^T q, dv = p^T g`` in f32."""
    return ds @ k.float(), ds.transpose(-1, -2) @ q.float(), p.transpose(-1, -2) @ g.float()


def attention_bwd_reference(q, k, v, g, valid: IntOrTensor = None, causal: bool = False):
    """Plain version of the single-block backward ``_attn_bwd_kernel``:
    recompute ``p = e / sum(e)`` from the masked scores, then ``dv = p^T g``,
    ``dp = g v^T``, ``ds = p (dp - rowsum(dp p)) Dh^-1/2``, ``dq = ds k``,
    ``dk = ds^T q``, all in f32.  ``q, k, v, g [B, H, T, Dh]``; ``valid`` an
    int or ``[B]`` (None: every key).  Returns ``(dq, dk, dv)`` in q's dtype."""
    s2, _ = _masked_scores(q, k, valid, causal)
    e = torch.exp2(s2 - s2.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = g.float() @ v.float().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * q.shape[-1] ** -0.5
    return tuple(t.to(q.dtype) for t in _grads_from_ds(p, ds, q, k, g))


def attention_lse_reference(q, k, valid: IntOrTensor = None, causal: bool = False):
    """Plain version of ``_blocked_lse_kernel``: ``lse2 = m2 + log2(l)`` over
    the masked log2-domain scores (masked keys at -1e30, ``l`` floored at
    1e-30), ``[B, H, T]`` f32."""
    s2, _ = _masked_scores(q, k, valid, causal)
    m = s2.amax(dim=-1, keepdim=True)
    l = torch.exp2(s2 - m).sum(dim=-1, keepdim=True)
    return (m + torch.log2(l.clamp_min(1e-30)))[..., 0]


def attention_delta(out, g):
    """``delta = rowsum(dO * O)`` in f32, ``[B, H, T]`` contiguous (any strides in)."""
    return (g.float() * out.float()).sum(dim=-1).contiguous()


def _blocked_p_ds(q, k, v, g, lse, delta, valid, causal):
    s2, mask = _masked_scores(q, k, valid, causal)
    p = torch.where(mask, torch.exp2(s2 - lse[..., None]), torch.zeros_like(s2))
    dp = g.float() @ v.float().transpose(-1, -2)
    return p, p * (dp - delta[..., None]) * q.shape[-1] ** -0.5


def attention_bwd_dkv_reference(q, k, v, g, lse, delta, valid: IntOrTensor = None,
                                causal: bool = False):
    """Plain version of ``_blocked_bwd_dkv_kernel``: ``(dk, dv)`` in q's dtype
    from the row ``lse`` and ``delta`` (``[B, H, T]`` f32)."""
    p, ds = _blocked_p_ds(q, k, v, g, lse, delta, valid, causal)
    _, dk, dv = _grads_from_ds(p, ds, q, k, g)
    return dk.to(q.dtype), dv.to(q.dtype)


def attention_bwd_dq_reference(q, k, v, g, lse, delta, valid: IntOrTensor = None,
                               causal: bool = False):
    """Plain version of ``_blocked_bwd_dq_kernel``: ``dq`` in q's dtype."""
    _, ds = _blocked_p_ds(q, k, v, g, lse, delta, valid, causal)
    return (ds @ k.float()).to(q.dtype)


def attention_bwd_blocked_reference(q, k, v, g, out, valid: IntOrTensor = None,
                                    causal: bool = False):
    """Plain version of the blockwise backward (``_pallas_attention_bwd_blocked``):
    the row LSE, ``delta = rowsum(g * out)``, then ``p = exp2(s2 - lse)``
    where visible and ``ds = p (dp - delta) Dh^-1/2``.  Returns
    ``(dq, dk, dv)`` in q's dtype."""
    lse = attention_lse_reference(q, k, valid, causal)
    delta = attention_delta(out, g)
    p, ds = _blocked_p_ds(q, k, v, g, lse, delta, valid, causal)
    return tuple(t.to(q.dtype) for t in _grads_from_ds(p, ds, q, k, g))


# --- the autograd Function ----------------------------------------------------------


class _FusedAttention(torch.autograd.Function):
    """K3 forward, the flash backward chain (plain versions on a CPU tensor)."""

    @staticmethod
    def forward(ctx, q, k, v, valid, eot, causal):
        valid_t, valid_all = _op_index(valid, q.shape[2])
        eot_t, eot_all = _op_index(eot, 0)
        out, aux = _build.run(torch.ops.tapclip.attn_aux.default, attn_aux_plain, attn_aux_cuda,
                              q, k, v, valid_t, valid_all, eot_t, eot_all, causal, eot is not None)
        aux = aux if eot is not None else None
        ctx.save_for_backward(q, k, v, out)
        ctx.valid, ctx.causal = valid, causal
        if aux is not None:
            ctx.mark_non_differentiable(aux)
        return out, aux

    @staticmethod
    def backward(ctx, g, _g_aux):
        q, k, v, out = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        valid, causal = ctx.valid, ctx.causal
        if q.device.type == "cpu":
            grads = attention_bwd_reference(q, k, v, g, valid, causal)
        else:
            grads = flash_attention_bwd_cuda(q, k, v, out, g, valid, causal)
        return (*grads, None, None, None)


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_valid_len: IntOrTensor = None,
    attn_to_idx: IntOrTensor = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Same contract as ``attention_reference``: K3 and the flash backward on
    CUDA, plain on CPU; differentiable in q, k, v (never through the aux)."""
    return _FusedAttention.apply(q, k, v, kv_valid_len, attn_to_idx, bool(causal))


fused_attention.launches = 0  # every launch of K3
fused_attention.causal_launches = 0  # the causal ones among them
fused_attention.lse_launches = 0  # the backward chain: LSE,
fused_attention.dkv_launches = 0  # dK/dV
fused_attention.dq_launches = 0  # and dQ


def _op_index(x: IntOrTensor, default: int) -> Tuple[Optional[torch.Tensor], int]:
    """``tapclip::attn_aux``'s pair for an :data:`IntOrTensor`: (the tensor or
    None, the int every row takes when it is None)."""
    if isinstance(x, torch.Tensor):
        return x, default
    return None, default if x is None else int(x)


def attn_aux_plain(q, k, v, valid, valid_all, eot, eot_all, causal, with_aux):
    """``tapclip::attn_aux`` on a CPU tensor: :func:`attention_reference` with
    the op's arguments (``valid`` / ``eot`` None: ``valid_all`` / ``eot_all``
    in every row); ``(out, aux [B, T] f32)``, aux empty without ``with_aux``."""
    kv = valid if valid is not None else (None if valid_all == q.shape[2] else valid_all)
    to = (eot if eot is not None else eot_all) if with_aux else None
    out, aux = attention_reference(q, k, v, causal=causal, kv_valid_len=kv, attn_to_idx=to)
    return out, aux if with_aux else q.new_empty((0,), dtype=torch.float32)


def attn_aux_cuda(q, k, v, valid, valid_all, eot, eot_all, causal, with_aux):
    """``tapclip::attn_aux`` on a CUDA tensor: one K3 launch."""
    out, aux = _fused_attention_cuda(q, k, v, causal, valid if valid is not None else valid_all,
                                     (eot if eot is not None else eot_all) if with_aux else None)
    return out, aux if with_aux else q.new_empty((0,), dtype=torch.float32)


def _valid_arg(x: IntOrTensor, batch: int, default: int, device) -> Tuple[Optional[torch.Tensor], int]:
    """(``[B]`` int32 tensor on the card or None, the int every row takes when
    it is None): an int or None passes as the int, an int32 ``[B]`` tensor on
    the card as itself, so neither costs a fill or cast launch."""
    if x is None or isinstance(x, int):
        return None, default if x is None else int(x)
    if x.dtype != torch.int32 or x.device != device or not x.is_contiguous() or x.numel() != batch:
        x = _per_batch(x, batch, default, device)
    return x.reshape(batch), 0


def _attn_aux_call(q, k, v, causal, kv_valid_len, attn_to_idx, out, aux):
    """The checked arguments of one K3 launch (``tapclip_attn_aux``) into
    ``out`` and ``aux`` (None without the column)."""
    B, H, T, Dh = q.shape
    dtype = q.dtype
    _check_head_dim(Dh)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _build.check_cuda_operand(name, t, dtype, (B, H, T, Dh))
        _check_aligned(name, t)
    valid, valid_all = _valid_arg(kv_valid_len, B, T, q.device)
    eot, eot_all = _valid_arg(attn_to_idx, B, 0, q.device)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr() if valid is not None else None,
            eot.data_ptr() if eot is not None else None, valid_all, eot_all, out.data_ptr(),
            aux.data_ptr() if aux is not None else None, B, H, T, Dh, int(aux is not None), int(causal),
            _build.dtype_code(dtype), _build.stream_handle(q.device))


def _fused_attention_cuda(q, k, v, causal, kv_valid_len, attn_to_idx):
    B, H, T, _ = q.shape
    out = torch.empty_like(q)
    aux = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if attn_to_idx is not None else None
    args = _attn_aux_call(q, k, v, causal, kv_valid_len, attn_to_idx, out, aux)
    _build.check(_build.library().tapclip_attn_aux(*args), "tapclip_attn_aux")
    fused_attention.launches += 1
    fused_attention.causal_launches += int(causal)
    return out, (aux.mean(dim=1) if aux is not None else None)


# --- the backward chain on the card ---------------------------------------------------


def _check_head_dim(Dh):
    if Dh not in (16, 32, 64, 128):
        raise ValueError(f"attention kernel takes head dims 16/32/64/128, got {Dh}")


def _check_aligned(name, t):
    """The kernels copy rows in 16-byte pieces: the pointer and the (batch,
    head, row) strides must be 16-byte multiples."""
    step = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % step for s in t.stride()[:3]):
        raise ValueError(f"{name} must have 16-byte aligned rows (pointer and strides in steps of "
                         f"{step} elements), got strides {t.stride()} at offset {t.data_ptr() % 16}")


def _strides(name, t, shape, dtype):
    """(batch, head, row) element strides of a ``[B, H, T, Dh]`` CUDA view
    whose rows are contiguous and 16-byte aligned."""
    _build.check_cuda_operand(name, t, dtype, shape, contiguous=False)
    if t.stride(3) != 1 or max(t.stride()[:3]) >= 2 ** 31:
        raise ValueError(f"{name} must have contiguous rows and 32-bit strides, got {t.stride()}")
    _check_aligned(name, t)
    return t.stride()[:3]


def _chain_operands(q, valid, shared, g=None):
    """Check the chain's operands: ``valid`` is ``[B]`` int32, the
    ``(name, tensor)`` pairs of ``shared`` (k, v, the outputs) share q's
    strides, ``g`` has its own; returns (shape, q strides, g strides, dtype
    code)."""
    shape, dtype = tuple(q.shape), q.dtype
    _check_head_dim(shape[3])
    _build.check_cuda_operand("valid", valid, torch.int32, shape[:1])
    sq = _strides("q", q, shape, dtype)
    for name, t in shared:
        if _strides(name, t, shape, dtype) != sq:
            raise ValueError(f"{name} must share q's strides {sq}, got {t.stride()[:3]}")
    sg = _strides("g", g, shape, dtype) if g is not None else None
    return shape, sq, sg, _build.dtype_code(dtype)


def _flash_lse_call(q, k, valid, causal, lse):
    """The checked arguments of one LSE launch (``tapclip_flash_lse``) into ``lse``."""
    (B, H, T, Dh), sq, _, code = _chain_operands(q, valid, (("k", k),))
    _build.check_cuda_operand("lse", lse, torch.float32, (B, H, T))
    return (q.data_ptr(), k.data_ptr(), valid.data_ptr(), lse.data_ptr(), B, H, T, Dh, *sq, int(causal), code,
            _build.stream_handle(q.device))


def _flash_bwd_dkv_call(q, k, v, g, lse, delta, valid, causal, dk, dv):
    """The checked arguments of one dK/dV launch (``tapclip_flash_bwd_dkv``)."""
    shape, sq, sg, code = _chain_operands(q, valid, (("k", k), ("v", v), ("dk", dk), ("dv", dv)), g)
    for name, t in (("lse", lse), ("delta", delta)):
        _build.check_cuda_operand(name, t, torch.float32, shape[:3])
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            valid.data_ptr(), dk.data_ptr(), dv.data_ptr(), *shape, *sq, *sg, int(causal), code,
            _build.stream_handle(q.device))


def _flash_bwd_dq_call(q, k, v, g, lse, delta, valid, causal, dq):
    """The checked arguments of one dQ launch (``tapclip_flash_bwd_dq``)."""
    shape, sq, sg, code = _chain_operands(q, valid, (("k", k), ("v", v), ("dq", dq)), g)
    for name, t in (("lse", lse), ("delta", delta)):
        _build.check_cuda_operand(name, t, torch.float32, shape[:3])
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            valid.data_ptr(), dq.data_ptr(), *shape, *sq, *sg, int(causal), code, _build.stream_handle(q.device))


def _launch(name, args, counter):
    _build.check(getattr(_build.library(), name)(*args), name)
    setattr(fused_attention, counter, getattr(fused_attention, counter) + 1)


def _flash_lse_cuda(q, k, valid, causal):
    """The LSE kernel: ``lse2 [B, H, T]`` f32 (``valid`` ``[B]`` int32 on the card)."""
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("tapclip_flash_lse", _flash_lse_call(q, k, valid, causal, lse), "lse_launches")
    return lse


def _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, valid, causal, dk, dv):
    """The dK/dV kernel, into ``dk`` / ``dv``."""
    _launch("tapclip_flash_bwd_dkv", _flash_bwd_dkv_call(q, k, v, g, lse, delta, valid, causal, dk, dv),
            "dkv_launches")
    return dk, dv


def _flash_bwd_dq_cuda(q, k, v, g, lse, delta, valid, causal, dq):
    """The dQ kernel, into ``dq``."""
    _launch("tapclip_flash_bwd_dq", _flash_bwd_dq_call(q, k, v, g, lse, delta, valid, causal, dq), "dq_launches")
    return dq


def flash_attention_bwd_cuda(q, k, v, out, g, valid: IntOrTensor, causal: bool):
    """The backward chain on the card: ``(dq, dk, dv)`` of attention over the
    ``[B, H, T, Dh]`` views q, k, v (any strides with contiguous rows) from
    the forward's output ``out`` and its cotangent ``g``."""
    B, T = q.shape[0], q.shape[2]
    valid = _per_batch(valid, B, T, q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = attention_delta(out, g)
    lse = _flash_lse_cuda(q, k, valid, causal)
    _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, valid, causal, dk, dv)
    _flash_bwd_dq_cuda(q, k, v, g, lse, delta, valid, causal, dq)
    return dq, dk, dv
