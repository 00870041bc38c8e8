"""Fused attention half-block: kernel K2.

Counterpart of ``tapclip_tpu/ops/fused_mha.py::fused_attn_block``.
``x + out_proj(mha(qkv_proj(layer_norm(x))))`` over ``x [B, T, W]`` with keys
at or past ``valid_len`` masked.  On a CUDA tensor :func:`fused_attn_block`
makes two hand-written launches (``csrc/attn_block.cu``, which replaces the
Pallas ``_attn_block_kernel``): LN + per-(batch, head) QKV projection +
attention into ``[B, T, W]``, then out-projection + bias + residual.  On a
CPU tensor it runs :func:`attn_block_reference`, the plain composition.

Numerics in bfloat16: the kernel keeps q and k in f32 and rounds v to the
compute dtype, as the JAX kernel does; the plain version rounds the whole qkv
product to the compute dtype, as the JAX package's plain path does
(``layers.py:130``).  In f32 the two agree to summation order.
"""

from __future__ import annotations

from typing import Optional

import torch

from tapclip_tpu_torch.ops import _build


def attn_block_reference(x, gamma, beta, w_qkv, b_qkv, w_out, b_out, n_heads, valid, eps):
    """Plain version: the composition of ``models/layers.py`` (``_attn_block_xla``)."""
    from tapclip_tpu_torch.models import layers

    p_ln = {"scale": gamma, "bias": beta}
    p_attn = {"w_qkv": w_qkv, "b_qkv": b_qkv, "w_out": w_out, "b_out": b_out}
    kv = None if valid == x.shape[1] else valid
    h, _ = layers.attn_forward(
        layers.layer_norm(x, p_ln, eps), p_attn, n_heads, kv_valid_len=kv, impl="xla"
    )
    return x + h


def fused_attn_block(
    x: torch.Tensor,
    ln_params,
    attn_params,
    n_heads: int,
    *,
    valid_len: Optional[int] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The attention half-block: K2 on CUDA, plain on CPU."""
    valid = valid_len if valid_len is not None else x.shape[1]
    args = (
        x, ln_params["scale"], ln_params["bias"], attn_params["w_qkv"],
        attn_params["b_qkv"], attn_params["w_out"], attn_params["b_out"],
    )
    if x.device.type == "cpu":
        return attn_block_reference(*args, n_heads, valid, eps)
    return _fused_attn_block_cuda(*args, n_heads, valid, eps)


fused_attn_block.launches = 0


def _fused_attn_block_cuda(x, gamma, beta, w_qkv, b_qkv, w_out, b_out, n_heads, valid, eps):
    _build.refuse_grad(x, gamma, beta, w_qkv, b_qkv, w_out, b_out)
    B, T, W = x.shape
    dtype = x.dtype
    Dh = W // n_heads
    if W % n_heads or Dh not in (16, 32, 64, 128):
        raise ValueError(f"attention block kernel takes head dims 16/32/64/128, got W={W}, heads={n_heads}")
    if not 1 <= valid <= T:
        raise ValueError(f"valid_len must be in [1, {T}], got {valid}")
    f32 = torch.float32
    ops = {
        "x": (x, dtype, (B, T, W)),
        "gamma": (gamma.to(f32), f32, (W,)),
        "beta": (beta.to(f32), f32, (W,)),
        "w_qkv": (w_qkv.to(dtype), dtype, (W, 3 * W)),
        "b_qkv": (b_qkv.to(f32), f32, (3 * W,)),
        "w_out": (w_out.to(dtype), dtype, (W, W)),
        "b_out": (b_out.to(f32), f32, (W,)),
    }
    for name, (t, dt, shape) in ops.items():
        _build.check_cuda_operand(name, t, dt, shape)
    t = {name: v[0] for name, v in ops.items()}
    ws = torch.empty((B, n_heads, 3, T, Dh), dtype=f32, device=x.device)
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    lib = _build.library()
    code = _build.dtype_code(dtype)
    stream = _build.stream_handle(x.device)
    err = lib.tapclip_attn_block_core(
        x.data_ptr(), t["gamma"].data_ptr(), t["beta"].data_ptr(), t["w_qkv"].data_ptr(),
        t["b_qkv"].data_ptr(), ws.data_ptr(), attn.data_ptr(),
        B, T, W, n_heads, int(valid), float(eps), code, stream,
    )
    _build.check(err, "tapclip_attn_block_core")
    err = lib.tapclip_gemm_bias_residual(
        attn.data_ptr(), t["w_out"].data_ptr(), t["b_out"].data_ptr(), x.data_ptr(),
        out.data_ptr(), B * T, W, W, code, stream,
    )
    _build.check(err, "tapclip_gemm_bias_residual")
    fused_attn_block.launches += 1
    return out
