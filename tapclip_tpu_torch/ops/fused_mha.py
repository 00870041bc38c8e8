"""Fused attention: the half-block K2 with its backward B4, and the
packed-QKV attention core B6 with its backward B7.

**The half-block.** Counterpart of ``tapclip_tpu/ops/fused_mha.py::fused_attn_block``.
``x + out_proj(mha(qkv_proj(layer_norm(x))))`` over ``x [B, T, W]`` with keys
at or past ``valid_len`` masked.  :func:`fused_attn_block` is one
``torch.autograd.Function`` on every device.  On a CUDA tensor its forward
is K2 (``csrc/attn_block.cu``, which replaces the Pallas
``_attn_block_kernel``), four hand-written launches on the tensor cores: LN,
the QKV product into an f32 workspace ``[B*T, 3W]``, attention per (batch
row, head, query tile) into ``[B, T, W]``, then out-projection + bias +
residual; its backward is B4 (``csrc/attn_block_bwd.cu``, which replaces
``_attn_block_bwd_kernel``): LN, the QKV, gh and dy products and the
attention core on the tensor cores, seven launches, with the weight
gradients by ``csrc/gemm.cu``.  On a CPU tensor they run
:func:`attn_block_reference` and :func:`attn_block_bwd_reference`, the plain
versions.  The forward saves x and the parameters only; the backward
recomputes LN, QKV and the probabilities, as the TPU kernel does.  Past
the routing limit ``tapclip_attn_bwd_max_seq`` (T over 210 at head dim 64:
where the one-block ``[T, T]`` core B4 ran before its row and column
kernels held its tile) the backward differentiates the split composition
(plain projections around :func:`fused_mha`), as the JAX
``_attn_block_bwd`` does.

Numerics in bfloat16: the kernels keep q and k in f32 and round v to the
compute dtype, as the JAX kernels do; the plain forward rounds the whole qkv
product to the compute dtype, as the JAX package's plain path does
(``layers.py:130``), while the plain backward rounds where the JAX backward
kernel rounds.  In f32 they agree to summation order.

**The attention core.** Counterpart of ``tapclip_tpu/ops/fused_mha.py::fused_mha``:
attention over the packed ``qkv [B, T, 3W]`` (bias added) into ``[B, T, W]``,
keys at or past ``valid_len`` masked, optionally causal.  :func:`fused_mha` is
one ``torch.autograd.Function``: on a CUDA tensor its forward is B6
(``csrc/mha.cu``, which replaces ``_mha_kernel``: K2's attention walk on the
tensor cores, ``csrc/attn_core_mma.cuh``, reading qkv in the dtype, causal
or not) and its backward B7
(``csrc/mha_bwd.cu``, which replaces ``_mha_bwd_kernel``); on a CPU tensor
:func:`fused_mha_reference` (the counterpart of ``_xla_reference``) and
:func:`fused_mha_bwd_reference` (the TPU backward's formula).  The forward
saves qkv; the backward recomputes the probabilities.  B7 is two launches
on the tensor cores (B4's row and column kernels, ``csrc/attn_bwd_mma.cuh``,
on the packed strides) at any T, as the JAX ``_fused_mha_bwd_impl`` runs at
any T: at ViT-L/14's T 257 and 584 they beat the blockwise flash chain on
the same strides, in f32 and bf16 (``time_half_blocks.py``; ``PERF.md``).
"""

from __future__ import annotations

from typing import Optional

import torch

from tapclip_tpu_torch.ops import _build
from tapclip_tpu_torch.ops.fused_mlp import _grads_like, _ln_parts, _ln_rows, _rnd, ln_backward
from tapclip_tpu_torch.ops.gemm import col_sum, gemm_f32

_LOG2E = 1.4426950408889634  # the kernels' kLog2e: scores are exp2'd
_LN2_BF16 = 0.69140625  # ln 2 rounded to bf16 (attn_tile.cuh's kLn2Bf16)


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
        elif not _tile_fits(x.shape[1], x.shape[2] // ctx.cfg[0]):
            return (*_split_block_grads(saved, g, need, *ctx.cfg), None, None, None)
        else:
            grads = _attn_block_bwd_cuda(*args, weight_grads=any(need[1:7]))
        return (*_grads_like(grads, saved, need), None, None, None)


def _tile_fits(T, Dh):
    """Whether B4's autograd Function routes sequence length T to its
    kernels (``tapclip_attn_bwd_max_seq``: the limit of the ``[T, T]`` core
    it ran before, kept as a routing limit)."""
    return T <= _build.library().tapclip_attn_bwd_max_seq(Dh)


def _split_block(x, gamma, beta, w_qkv, b_qkv, w_out, b_out, n_heads, valid, eps):
    """The half-block as the split composition: LayerNorm and the projections
    in torch (products of compute-dtype values in f32) around :func:`fused_mha`."""
    dt = x.dtype
    y = _ln_parts(x, gamma, beta, eps)[2].float()
    qkv = (y @ _rnd(w_qkv, dt) + b_qkv.float()).to(dt)
    h = fused_mha(qkv, n_heads, valid_len=valid).float() @ _rnd(w_out, dt) + b_out.float()
    return x + h.to(dt)


def _split_block_grads(saved, g, need, n_heads, valid, eps):
    """The half-block's gradients past B4's tile: autograd through
    :func:`_split_block` (whose attention core differentiates on B7), as
    ``_attn_block_bwd`` falls back to ``jax.vjp`` of the split composition."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        out = _split_block(*leaves, n_heads, valid, eps)
        grads = iter(torch.autograd.grad(out, [t for t in leaves if t.requires_grad], g))
    return [next(grads) if n else None for n in need[:len(saved)]]


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
    _check_heads(T, W, n_heads, valid)
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
    align = 4 * x.element_size()  # the GEMMs copy 4 elements at a time at least
    for name in ("x", "w_qkv", "w_out"):
        if t[name].data_ptr() % align:
            raise ValueError(f"attention block kernel copies {name} in {align}-byte chunks: it must be "
                             f"{align}-byte aligned")
    qkv = torch.empty((B * T, 3 * W), dtype=f32, device=x.device)  # q | k | v, v rounded to the dtype
    ya = torch.empty_like(x)  # y = LN(x), then the attention output
    out = torch.empty_like(x)
    err = _build.library().tapclip_attn_block(
        x.data_ptr(), t["gamma"].data_ptr(), t["beta"].data_ptr(), t["w_qkv"].data_ptr(), t["b_qkv"].data_ptr(),
        t["w_out"].data_ptr(), t["b_out"].data_ptr(), out.data_ptr(), qkv.data_ptr(), ya.data_ptr(),
        B, T, W, n_heads, int(valid), float(eps), _build.dtype_code(dtype), _build.stream_handle(x.device),
    )
    _build.check(err, "tapclip_attn_block")
    fused_attn_block.launches += 1
    return out


def _attn_block_bwd_cuda(x, g, gamma, beta, w_qkv, b_qkv, w_out, n_heads, valid, eps,
                         *, weight_grads=True, split=None):
    """B4 on the card: the seven launches of ``csrc/attn_block_bwd.cu`` (dx,
    and with ``weight_grads`` o and the LayerNorm partials for the weight
    gradients), then the A^T.B products and column sums.  ``split``: the
    split of dy's depth into f32 partials (1, 2 or 4; None takes the
    kernel's choice for the shape).  Returns the seven gradients of
    :func:`attn_block_bwd_reference` (the six weight gradients None without
    ``weight_grads``)."""
    B, T, W = x.shape
    R = B * T
    Dh = _check_heads(T, W, n_heads, valid)
    lib = _build.library()
    if not _tile_fits(T, Dh):
        raise ValueError(
            f"attention block backward kernel runs up to its routing limit: "
            f"T={T} exceeds its limit of {lib.tapclip_attn_bwd_max_seq(Dh)} at head dim {Dh} "
            f"(the autograd Function differentiates the split composition there)"
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
    align = 4 * x.element_size()  # the GEMMs copy 4 elements at a time at least
    for name in ("x", "g", "w_qkv", "w_out"):
        if t[name].data_ptr() % align:
            raise ValueError(f"attention block backward kernel copies {name} in {align}-byte chunks: it must be "
                             f"{align}-byte aligned")
    code = _build.dtype_code(dtype)
    S = lib.tapclip_attn_block_bwd_split(R, W, code) if split is None else int(split)
    if S not in (1, 2, 4):
        raise ValueError(f"attention block backward kernel splits dy's depth 1, 2 or 4 ways, got {S}")
    dx = torch.empty_like(x)
    # qkv, gh, dy partials, mean, rstd, lse, delta
    ws = torch.empty(R * (4 * W + S * W + 2 + 2 * n_heads), dtype=f32, device=dev)
    wsd = torch.empty(R * (5 * W if weight_grads else 4 * W), dtype=dtype, device=dev)  # y, dqkv, o
    part = torch.empty((-(-R // 16), 2 * W), dtype=f32, device=dev) if weight_grads else None
    err = lib.tapclip_attn_block_bwd(
        x.data_ptr(), g.data_ptr(), t["gamma"].data_ptr(), t["beta"].data_ptr(), t["w_qkv"].data_ptr(),
        t["b_qkv"].data_ptr(), t["w_out"].data_ptr(), dx.data_ptr(), ws.data_ptr(), wsd.data_ptr(),
        None if part is None else part.data_ptr(), B, T, W, n_heads, int(valid), float(eps), S,
        int(weight_grads), code, _build.stream_handle(dev),
    )
    _build.check(err, "tapclip_attn_block_bwd")
    fused_attn_block.bwd_launches += 1
    if not weight_grads:
        return dx, None, None, None, None, None, None
    y, dqkv, attn = wsd[:R * W].view(R, W), wsd[R * W:4 * R * W].view(R, 3 * W), wsd[4 * R * W:].view(R, W)
    g2 = g.reshape(R, W)
    ln_sums = col_sum(part)
    return (dx, ln_sums[:W], ln_sums[W:], gemm_f32(y, dqkv, trans_a=True), col_sum(dqkv),
            gemm_f32(attn, g2, trans_a=True), col_sum(g2))


# --- the packed-QKV attention core: B6 forward, B7 backward -------------------


def _split_heads(t, n_heads):  # [B, T, W] -> [B, H, T, Dh]
    B, T, W = t.shape
    return t.reshape(B, T, n_heads, W // n_heads).transpose(1, 2)


def _merge_heads(t):  # [B, H, T, Dh] -> [B, T, W]
    B, H, T, Dh = t.shape
    return t.transpose(1, 2).reshape(B, T, H * Dh)


def fused_mha_reference(qkv, n_heads, valid, causal):
    """Plain version of B6: ``_xla_reference``, the plain attention over the
    three column blocks of ``qkv``."""
    from tapclip_tpu_torch.ops.attention import attention_reference

    T, W = qkv.shape[1], qkv.shape[2] // 3
    q, k, v = (_split_heads(t, n_heads) for t in qkv.split(W, dim=-1))
    out, _ = attention_reference(q, k, v, causal=causal, kv_valid_len=None if valid == T else valid)
    return _merge_heads(out)


def _mha_mask(T, valid, causal, device):
    """``[T, T]`` bool: key j is visible to query i."""
    keys = torch.arange(T, device=device)
    mask = (keys < valid)[None, :].expand(T, T)
    if causal:
        mask = mask & (keys[None, :] <= keys[:, None])
    return mask


def fused_mha_bwd_reference(qkv, g, n_heads, valid, causal):
    """Plain backward of B6, written out as ``_mha_bwd_kernel`` computes it
    (the same roundings in bfloat16): packed ``dqkv [B, T, 3W]`` in qkv's dtype."""
    dt = qkv.dtype
    T, W = qkv.shape[1], qkv.shape[2] // 3
    scale = (W // n_heads) ** -0.5
    q, k, v = (_split_heads(t.float(), n_heads) for t in qkv.split(W, dim=-1))
    gh = _split_heads(g.float(), n_heads)
    s = q @ k.transpose(-1, -2) * (scale * _LOG2E)
    s = torch.where(_mha_mask(T, valid, causal, qkv.device), s, torch.full_like(s, -1e30))
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = _rnd(p, g.dtype).transpose(-1, -2) @ gh
    dp = gh @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dq, dk = ds @ k, ds.transpose(-1, -2) @ q
    return torch.cat([_merge_heads(t) for t in (dq, dk, dv)], dim=-1).to(dt)


class _FusedMHA(torch.autograd.Function):
    """B6 forward and B7 backward (plain versions on a CPU tensor)."""

    @staticmethod
    def forward(ctx, qkv, n_heads, valid, causal):
        ctx.cfg = (n_heads, valid, causal)
        ctx.save_for_backward(qkv)
        if qkv.device.type == "cpu":
            return fused_mha_reference(qkv, n_heads, valid, causal)
        return _fused_mha_cuda(qkv, n_heads, valid, causal)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        g = g.to(qkv.dtype).contiguous()
        if qkv.device.type == "cpu":
            dqkv = fused_mha_bwd_reference(qkv, g, *ctx.cfg)
        else:
            dqkv = _fused_mha_bwd_cuda(qkv, g, *ctx.cfg)
        return dqkv, None, None, None


def fused_mha(
    qkv: torch.Tensor,
    n_heads: int,
    *,
    valid_len: Optional[int] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Packed-QKV multi-head self attention ``[B, T, 3W] -> [B, T, W]``:
    B6/B7 on CUDA, plain on CPU."""
    valid = valid_len if valid_len is not None else qkv.shape[1]
    return _FusedMHA.apply(qkv, n_heads, int(valid), bool(causal))


fused_mha.launches = 0
fused_mha.bwd_launches = 0


def _mha_operands(qkv, n_heads, valid, *more):
    B, T, W3 = qkv.shape
    W = W3 // 3
    Dh = _check_heads(T, W, n_heads, valid)
    _build.check_cuda_operand("qkv", qkv, qkv.dtype, (B, T, 3 * W))
    for name, t in more:
        _build.check_cuda_operand(name, t, qkv.dtype, (B, T, W))
    return B, T, W, Dh


def _fused_mha_cuda(qkv, n_heads, valid, causal):
    """B6 on the card (one launch: ``csrc/mha.cu``, K2's attention walk on
    the tensor cores with qkv in the dtype): ``[B, T, W]`` in qkv's dtype."""
    B, T, W, _ = _mha_operands(qkv, n_heads, valid)
    if qkv.data_ptr() % 16:
        raise ValueError("packed-QKV attention kernel copies qkv in 16-byte chunks: it must be 16-byte aligned")
    out = torch.empty((B, T, W), dtype=qkv.dtype, device=qkv.device)
    err = _build.library().tapclip_mha(
        qkv.data_ptr(), out.data_ptr(), B, T, W, n_heads, int(valid), int(causal),
        _build.dtype_code(qkv.dtype), _build.stream_handle(qkv.device),
    )
    _build.check(err, "tapclip_mha")
    fused_mha.launches += 1
    return out


def _fused_mha_bwd_cuda(qkv, g, n_heads, valid, causal):
    """B7 on the card (two launches: ``csrc/mha_bwd.cu``), at any T: packed
    ``dqkv`` in qkv's dtype."""
    B, T, W, _ = _mha_operands(qkv, n_heads, valid, ("g", g))
    for name, t in (("qkv", qkv), ("g", g)):
        if t.data_ptr() % 16:
            raise ValueError(f"packed-QKV backward kernel copies {name} in 16-byte chunks: it must be 16-byte aligned")
    dqkv = torch.empty_like(qkv)
    ws = torch.empty(2 * B * n_heads * T, dtype=torch.float32, device=qkv.device)  # lse, delta
    err = _build.library().tapclip_mha_bwd(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), ws.data_ptr(), B, T, W, n_heads, int(valid), int(causal),
        _build.dtype_code(qkv.dtype), _build.stream_handle(qkv.device),
    )
    _build.check(err, "tapclip_mha_bwd")
    fused_mha.bwd_launches += 1
    return dqkv


# --- S3, S4: the A/B variants of K2 -------------------------------------------
#
# ``form`` picks the TPU kernel a call stands for: "variant"
# (scripts/attn_kernel_ab.py::make_variant_kernel: group_heads, ln_1pass,
# perhead_qkv, softmax_opt in {False, True, "bf16"}), "interleaved" (its
# make_interleaved_kernel: group_heads) or "softmax"
# (scripts/attn_softmax_ab.py::make_kernel: qk_cast, fold_q, mask_mode in
# {"full", "tail", "zerokv"}, group_heads, sum_mxu, tail_split).
# ``group_heads`` is the FMA core's heads per block here (1 with no switch;
# the TPU scripts count heads per 128-lane step, 2 at head dim 64): a
# schedule switch, like tail_split.  The TPU switches with no counterpart on the card (swpipe, bB,
# vmem_mb) are not taken: the drivers drop them.

ATTN_VARIANT_FLAGS = {
    "variant": ("group_heads", "ln_1pass", "perhead_qkv", "softmax_opt"),
    "interleaved": ("group_heads",),
    "softmax": ("group_heads", "qk_cast", "fold_q", "mask_mode", "sum_mxu", "tail_split"),
}
_FORM_CODE = {"online": 0, "normalized": 1, "bf16": 2}  # attn_tile.cuh's AttnForm
_MASK_CODE = {"full": 0, "tail": 1, "zerokv": 2}


def attn_variant_switches(form, T, valid, n_heads, **flags):
    """The kernel switches (``attn_core.cuh``) of one variant; raises on a flag
    the form does not take, and on ``mask_mode="tail"`` where a pad key lies
    before the last 64-key tile or the last 128-key boundary (the TPU
    kernel's precondition, ``attn_softmax_ab.py:87-89``)."""
    if form not in ATTN_VARIANT_FLAGS:
        raise ValueError(f"unknown attention variant form {form!r}")
    bad = set(flags) - set(ATTN_VARIANT_FLAGS[form])
    if bad:
        raise ValueError(f"form {form!r} takes {ATTN_VARIANT_FLAGS[form]}, got {sorted(bad)}")
    group = int(flags.get("group_heads", 1))
    if group < 1 or n_heads % group:
        raise ValueError(f"group_heads {group} must divide the {n_heads} heads")
    sw = dict(softmax="online", sum_rounded=False, tail_split=False, smem_qkv=False, interleaved=False,
              ln1pass=False, qk_round=False, fold_q=False, mask="full", group=group)
    if form == "variant":
        opt = flags.get("softmax_opt", False)
        if opt not in (False, True, "bf16"):
            raise ValueError(f"softmax_opt must be False, True or 'bf16', got {opt!r}")
        perhead = bool(flags.get("perhead_qkv", False))
        sw.update(softmax={False: "normalized", True: "online", "bf16": "bf16"}[opt],
                  smem_qkv=perhead, qk_round=not perhead, ln1pass=bool(flags.get("ln_1pass", False)))
    elif form == "interleaved":
        sw.update(softmax="normalized", interleaved=True)
    else:
        mask = flags.get("mask_mode", "full")
        if mask not in _MASK_CODE:
            raise ValueError(f"mask_mode must be one of {sorted(_MASK_CODE)}, got {mask!r}")
        sum_mxu = bool(flags.get("sum_mxu", False))
        sw.update(qk_round=bool(flags.get("qk_cast", False)), fold_q=bool(flags.get("fold_q", False)),
                  mask=mask, sum_rounded=sum_mxu, tail_split=bool(flags.get("tail_split", False)) and not sum_mxu)
        first = max(T // 128 * 128, (T - 1) // 64 * 64)
        if mask == "tail" and valid < T and valid < first:
            raise ValueError(f"mask_mode='tail' selects only keys from {first} on (the last 64-key tile and "
                             f"the last 128-key boundary), but valid={valid} of T={T} pads keys before that")
    return sw


def attn_block_variant_reference(x, gamma, beta, w_qkv, b_qkv, w_out, b_out, n_heads, valid, *,
                                 eps=1e-5, form="variant", **flags):
    """Plain version of S3/S4, rounded where the TPU script's kernel rounds:
    LN(x) to x's dtype; q and k f32 unless the variant rounds them; v rounded;
    the softmax of the variant's form; the attention output rounded before the
    f32 out-projection, + b_out + x, one rounding of the result.  Schedule
    switches (group_heads, tail_split, perhead_qkv's storage) change nothing
    here.  In f32 the form "variant" with no flag is
    :func:`attn_block_reference` operation for operation."""
    B, T, W = x.shape
    sw = attn_variant_switches(form, T, valid, n_heads, **flags)
    dt = x.dtype
    Dh = W // n_heads
    scale = Dh ** -0.5
    x32 = x.float()
    y = (_ln_rows(x32, eps, sw["ln1pass"]) * gamma.float() + beta.float()).to(dt).float()
    qkv = torch.matmul(y, _rnd(w_qkv, dt)) + b_qkv.float()
    q, k, v = (_split_heads(t, n_heads) for t in qkv.split(W, dim=-1))
    if sw["fold_q"]:
        q = q * (scale * _LOG2E)
    pad = torch.arange(T, device=x.device) >= valid
    if sw["mask"] == "zerokv":
        k = k.masked_fill(pad[:, None], 0.0)
        v = v.masked_fill(pad[:, None], 0.0)
    if sw["qk_round"]:
        q, k = _rnd(q, dt), _rnd(k, dt)
    v = _rnd(v, dt)
    s = torch.matmul(q, k.transpose(-1, -2))
    neg = torch.full_like(s, -1e30)
    if sw["softmax"] == "normalized":
        # exp(s - m) / l, the division before the rounding; softmax() as in
        # attention_reference, so the flags-off f32 form is attn_block_reference.
        o = torch.matmul(_rnd(torch.softmax(torch.where(pad, neg, s * scale), dim=-1), dt), v)
    else:
        if not sw["fold_q"]:
            s = s * (scale * _LOG2E)
        if sw["mask"] != "zerokv":
            s = torch.where(pad, neg, s)
        m = s.amax(dim=-1, keepdim=True)
        if sw["softmax"] == "bf16":
            # XLA's exp2 of a bf16 array: exp(bf16(x * bf16(ln 2))), rounded.
            p = _rnd(torch.exp(_rnd(_rnd(s - m, torch.bfloat16) * _LN2_BF16, torch.bfloat16)), torch.bfloat16)
            l = p.sum(dim=-1, keepdim=True)
        else:
            p = torch.exp2(s - m)
            l = (_rnd(p, dt) if sw["sum_rounded"] else p).sum(dim=-1, keepdim=True)
        if sw["mask"] == "zerokv":
            l = l - (T - valid) * torch.exp2(-m)
        o = torch.matmul(_rnd(p, dt), v) / l
    attn = _rnd(_merge_heads(o), dt)
    out = torch.matmul(attn, _rnd(w_out, dt)) + b_out.float()
    return (out + x32).to(dt)


def attn_block_variant(x, ln_params, attn_params, n_heads, valid, *, eps=1e-5, form="variant", **flags):
    """S3/S4 (forward only): K2's earlier FMA core in the variant's
    configuration (``csrc/attn_variants_online.cu``, ``attn_variants_two_pass.cu``),
    then K2's out-projection (``tapclip_gemm_bias_residual``, or for the interleaved form
    the per-group partials reduced by ``tapclip_attn_partials_reduce``) on a
    CUDA tensor; :func:`attn_block_variant_reference` on a CPU tensor."""
    params = (ln_params["scale"], ln_params["bias"], attn_params["w_qkv"], attn_params["b_qkv"],
              attn_params["w_out"], attn_params["b_out"])
    _build.refuse_graph("attn_block_variant", x, *params)
    B, T, W = x.shape
    sw = attn_variant_switches(form, T, valid, n_heads, **flags)
    if x.device.type == "cpu":
        return attn_block_variant_reference(x, *params, n_heads, valid, eps=eps, form=form, **flags)
    Dh = _check_heads(T, W, n_heads, valid)
    if Dh != 64:
        raise ValueError(f"the attention variants take head dim 64 (ViT-B/16, ViT-L/14), got {Dh}")
    lib = _build.library()
    smem = lib.tapclip_attn_variant_smem_bytes(T, int(sw["smem_qkv"]), int(sw["interleaved"]))
    limit = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"perhead_qkv keeps q, k, v of T={T} in shared memory: {smem} bytes, past the "
                         f"card's {limit} a block")
    dtype, f32 = x.dtype, torch.float32
    ops = {
        "x": (x, dtype, (B, T, W)),
        "gamma": (params[0].to(f32), f32, (W,)),
        "beta": (params[1].to(f32), f32, (W,)),
        "w_qkv": (params[2].to(dtype), dtype, (W, 3 * W)),
        "b_qkv": (params[3].to(f32), f32, (3 * W,)),
        "w_out": (params[4].to(dtype), dtype, (W, W)),
        "b_out": (params[5].to(f32), f32, (W,)),
    }
    for name, (t, dt, shape) in ops.items():
        _build.check_cuda_operand(name, t, dt, shape)
    t = {name: v[0] for name, v in ops.items()}
    groups = n_heads // sw["group"]
    ws = None if sw["smem_qkv"] else torch.empty((B, n_heads, 3, T, Dh), dtype=f32, device=x.device)
    attn = torch.empty_like(x)
    part = torch.empty((groups, B, T, W), dtype=f32, device=x.device) if sw["interleaved"] else None
    out = torch.empty_like(x)
    code = _build.dtype_code(dtype)
    stream = _build.stream_handle(x.device)
    launcher = "tapclip_attn_variant_online" if sw["softmax"] == "online" else "tapclip_attn_variant_two_pass"

    def ptr(tensor):
        return None if tensor is None else tensor.data_ptr()

    err = getattr(lib, launcher)(
        x.data_ptr(), t["gamma"].data_ptr(), t["beta"].data_ptr(), t["w_qkv"].data_ptr(),
        t["b_qkv"].data_ptr(), t["w_out"].data_ptr(), ptr(ws), attn.data_ptr(), ptr(part),
        B, T, W, n_heads, int(valid), float(eps), _FORM_CODE[sw["softmax"]], int(sw["sum_rounded"]),
        int(sw["tail_split"]), int(sw["smem_qkv"]), int(sw["interleaved"]), int(sw["ln1pass"]),
        int(sw["qk_round"]), int(sw["fold_q"]), _MASK_CODE[sw["mask"]], sw["group"], code, stream,
    )
    _build.check(err, launcher)
    if sw["interleaved"]:
        err = lib.tapclip_attn_partials_reduce(part.data_ptr(), groups, t["b_out"].data_ptr(), x.data_ptr(),
                                               out.data_ptr(), B * T, W, code, stream)
        _build.check(err, "tapclip_attn_partials_reduce")
    else:
        err = lib.tapclip_gemm_bias_residual(attn.data_ptr(), t["w_out"].data_ptr(), t["b_out"].data_ptr(),
                                             x.data_ptr(), out.data_ptr(), B * T, W, W, code, stream)
        _build.check(err, "tapclip_gemm_bias_residual")
    attn_block_variant.launches += 1
    return out


attn_block_variant.launches = 0
