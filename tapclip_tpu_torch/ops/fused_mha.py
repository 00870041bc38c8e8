"""Fused attention half-block: kernel K2 and its backward B4.

Counterpart of ``tapclip_tpu/ops/fused_mha.py::fused_attn_block``.
``x + out_proj(mha(qkv_proj(layer_norm(x))))`` over ``x [B, T, W]`` with keys
at or past ``valid_len`` masked.  :func:`fused_attn_block` is one
``torch.autograd.Function`` on every device.  On a CUDA tensor its forward
makes two hand-written launches (``csrc/attn_block.cu``, which replaces the
Pallas ``_attn_block_kernel``): LN + per-(batch, head) QKV projection +
attention into ``[B, T, W]``, then out-projection + bias + residual; its
backward is B4 (``csrc/attn_block_bwd.cu`` + ``csrc/gemm.cu``, which replace
``_attn_block_bwd_kernel``).  On a CPU tensor they run
:func:`attn_block_reference` and :func:`attn_block_bwd_reference`, the plain
versions.  The forward saves x and the parameters only; the backward
recomputes LN, QKV and the probabilities, as the TPU kernel does.

Numerics in bfloat16: the kernels keep q and k in f32 and round v to the
compute dtype, as the JAX kernels do; the plain forward rounds the whole qkv
product to the compute dtype, as the JAX package's plain path does
(``layers.py:130``), while the plain backward rounds where the JAX backward
kernel rounds.  In f32 they agree to summation order.
"""

from __future__ import annotations

from typing import Optional

import torch

from tapclip_tpu_torch.ops import _build
from tapclip_tpu_torch.ops.fused_mlp import _grads_like, _ln_parts, _rnd, ln_backward
from tapclip_tpu_torch.ops.gemm import col_sum, gemm_f32

_LOG2E = 1.4426950408889634  # the kernels' kLog2e: scores are exp2'd


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


def attn_block_bwd_reference(x, g, gamma, beta, w_qkv, b_qkv, w_out, n_heads, valid, eps):
    """Plain backward of :func:`attn_block_reference`, written out as
    ``_attn_block_bwd_kernel`` computes it (same roundings in bfloat16).

    ``x, g [B, T, W]`` in the compute dtype.  Returns ``(dx, dgamma, dbeta,
    dw_qkv, db_qkv, dw_out, db_out)``: dx in x.dtype, the rest f32.
    """
    dt = x.dtype
    B, T, W = x.shape
    Dh = W // n_heads
    scale = Dh ** -0.5
    n, rstd, y = _ln_parts(x, gamma, beta, eps)
    y32 = y.float()
    qkv = y32 @ _rnd(w_qkv, dt) + b_qkv.float()
    gc = _rnd(g.float(), dt)
    gh = gc @ _rnd(w_out, dt).T

    def heads(t):  # [B, T, W] -> [B, H, T, Dh]
        return t.reshape(B, T, n_heads, Dh).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(W, dim=-1))
    gh = heads(gh)
    s = q @ k.transpose(-1, -2) * (scale * _LOG2E)
    keys = torch.arange(T, device=x.device) < valid
    s = torch.where(keys, s, torch.full_like(s, -1e30))
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    pc = _rnd(p, dt)
    o = pc @ _rnd(v, dt)
    dv = pc.transpose(-1, -2) @ _rnd(gh, dt)
    dp = gh @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dq, dk = ds @ k, ds.transpose(-1, -2) @ q

    def merge(t):  # [B, H, T, Dh] -> [B*T, W], rounded to the compute dtype
        return _rnd(t.transpose(1, 2).reshape(B * T, W), dt)

    attn = merge(o)
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
    gc2 = gc.reshape(B * T, W)
    dy = (dqkv @ _rnd(w_qkv, dt).T).reshape(B, T, W)
    dx_ln, dgn, dbn = ln_backward(dy, n, rstd, gamma)
    dx = (g.float() + dx_ln).to(dt)
    return (dx, dgn.sum((0, 1)), dbn.sum((0, 1)), y32.reshape(B * T, W).T @ dqkv,
            dqkv.sum(0), attn.T @ gc2, gc2.sum(0))


class _FusedAttnBlock(torch.autograd.Function):
    """K2 forward and B4 backward (plain versions on a CPU tensor)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w_qkv, b_qkv, w_out, b_out, n_heads, valid, eps):
        ctx.save_for_backward(x, gamma, beta, w_qkv, b_qkv, w_out, b_out)
        ctx.cfg = (n_heads, valid, eps)
        args = (x, gamma, beta, w_qkv, b_qkv, w_out, b_out, n_heads, valid, eps)
        if x.device.type == "cpu":
            return attn_block_reference(*args)
        return _fused_attn_block_cuda(*args)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        x, gamma, beta, w_qkv, b_qkv, w_out, _ = saved
        need = ctx.needs_input_grad
        g = g.to(x.dtype).contiguous()
        args = (x, g, gamma, beta, w_qkv, b_qkv, w_out, *ctx.cfg)
        if x.device.type == "cpu":
            grads = attn_block_bwd_reference(*args)
        else:
            grads = _attn_block_bwd_cuda(*args, weight_grads=any(need[1:7]))
        return (*_grads_like(grads, saved, need), None, None, None)


def fused_attn_block(
    x: torch.Tensor,
    ln_params,
    attn_params,
    n_heads: int,
    *,
    valid_len: Optional[int] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The attention half-block: K2/B4 on CUDA, plain on CPU."""
    valid = valid_len if valid_len is not None else x.shape[1]
    return _FusedAttnBlock.apply(
        x, ln_params["scale"], ln_params["bias"], attn_params["w_qkv"],
        attn_params["b_qkv"], attn_params["w_out"], attn_params["b_out"],
        n_heads, valid, eps,
    )


fused_attn_block.launches = 0
fused_attn_block.bwd_launches = 0


def _check_heads(T, W, n_heads, valid):
    Dh = W // n_heads
    if W % n_heads or Dh not in (16, 32, 64, 128):
        raise ValueError(f"attention block kernel takes head dims 16/32/64/128, got W={W}, heads={n_heads}")
    if not 1 <= valid <= T:
        raise ValueError(f"valid_len must be in [1, {T}], got {valid}")
    return Dh


def _fused_attn_block_cuda(x, gamma, beta, w_qkv, b_qkv, w_out, b_out, n_heads, valid, eps):
    B, T, W = x.shape
    dtype = x.dtype
    Dh = _check_heads(T, W, n_heads, valid)
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


def _attn_block_bwd_cuda(x, g, gamma, beta, w_qkv, b_qkv, w_out, n_heads, valid, eps,
                         *, weight_grads=True):
    """B4 on the card (the launch chain of ``csrc/attn_block_bwd.cu``).
    Returns the seven gradients of :func:`attn_block_bwd_reference` (the six
    weight gradients None without ``weight_grads``)."""
    B, T, W = x.shape
    R = B * T
    Dh = _check_heads(T, W, n_heads, valid)
    lib = _build.library()
    max_t = lib.tapclip_attn_bwd_max_seq(Dh)
    if T > max_t:
        raise ValueError(
            f"attention block backward kernel holds a [T, T] f32 tile in shared memory: "
            f"T={T} exceeds its limit of {max_t} at head dim {Dh}"
        )
    dtype, f32, dev = x.dtype, torch.float32, x.device
    ops = {
        "x": (x, dtype, (B, T, W)),
        "g": (g, dtype, (B, T, W)),
        "gamma": (gamma.to(f32), f32, (W,)),
        "beta": (beta.to(f32), f32, (W,)),
        "w_qkv": (w_qkv.to(dtype), dtype, (W, 3 * W)),
        "b_qkv": (b_qkv.to(f32), f32, (3 * W,)),
        "w_out": (w_out.to(dtype), dtype, (W, W)),
    }
    for name, (t, dt, shape) in ops.items():
        _build.check_cuda_operand(name, t, dt, shape)
    t = {name: v[0] for name, v in ops.items()}
    code = _build.dtype_code(dtype)
    stream = _build.stream_handle(dev)

    y = torch.empty((R, W), dtype=dtype, device=dev)
    mean = torch.empty((R,), dtype=f32, device=dev)
    rstd = torch.empty((R,), dtype=f32, device=dev)
    err = lib.tapclip_ln_rows(x.data_ptr(), t["gamma"].data_ptr(), t["beta"].data_ptr(),
                              y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), R, W, float(eps),
                              code, stream)
    _build.check(err, "tapclip_ln_rows")
    g2 = g.reshape(R, W)
    qkv = gemm_f32(y, t["w_qkv"], bias=t["b_qkv"])
    gh = gemm_f32(g2, t["w_out"], trans_b=True)
    attn = torch.empty((R, W), dtype=dtype, device=dev)
    dqkv = torch.empty((R, 3 * W), dtype=dtype, device=dev)
    err = lib.tapclip_attn_bwd_core(qkv.data_ptr(), gh.data_ptr(), attn.data_ptr(), dqkv.data_ptr(),
                                    B, T, W, n_heads, int(valid), code, stream)
    _build.check(err, "tapclip_attn_bwd_core")
    dy = gemm_f32(dqkv, t["w_qkv"], trans_b=True)
    dx = torch.empty_like(x)
    part = torch.empty((-(-R // 16), 2 * W), dtype=f32, device=dev) if weight_grads else None
    err = lib.tapclip_ln_bwd_rows(
        x.data_ptr(), g.data_ptr(), dy.data_ptr(), t["gamma"].data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), None if part is None else part.data_ptr(), R, W,
        int(weight_grads), code, stream,
    )
    _build.check(err, "tapclip_ln_bwd_rows")
    fused_attn_block.bwd_launches += 1
    if not weight_grads:
        return dx, None, None, None, None, None, None
    ln_sums = col_sum(part)
    return (dx, ln_sums[:W], ln_sums[W:], gemm_f32(y, dqkv, trans_a=True), col_sum(dqkv),
            gemm_f32(attn, g2, trans_a=True), col_sum(g2))
