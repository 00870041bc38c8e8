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
gradients by ``csrc/gemm.cu``'s A^T.B products, also on the tensor cores.  On a CPU tensor they run
:func:`attn_block_reference` and :func:`attn_block_bwd_reference`, the plain
versions.  The forward saves x and the parameters only; the backward
recomputes LN, QKV and the probabilities, as the TPU kernel does.  The
forward is the op ``tapclip::attn_block`` (``ops/_library.py``, through ``_build.run``), whose
dispatch picks K2 or the plain version by the device.  Past
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

**Tensor parallelism** (``tp_group=``): the rank holds its heads' q, k and
v columns of ``w_qkv`` / ``b_qkv`` (``[W, 3 Wl]`` laid out ``[q_j | k_j |
v_j]``, ``parallel/sharding.py``'s per-head cut) and the matching rows of
``w_out``, and ``n_heads`` is its head count.  The forward is K2's partial
mode (``tapclip_attn_block_partial``: the out-projection alone in f32, or
:func:`attn_block_partial_reference` on a CPU tensor), all-reduced over the
group, then ``x + b_out`` added and rounded once.  The backward is B4's
partial mode: its launches up to dy, dy all-reduced over the group, then
``fused_mlp``'s LayerNorm backward (``tapclip_ln_bwd``), so dx, dgamma and
dbeta come out complete; the local weight gradients are exact and db_out is
complete on every rank.  Past B4's routing limit the backward differentiates
the partial split composition and all-reduces its dx, dgamma and dbeta.
Under sequence parallelism (``seq=True``) x is the rank's rows of the
sequence, gathered over T around K2 and B4, the partials and dy
reduce-scattered over T, as ``fused_mlp``'s module note says of K1 and B5.

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
saves qkv; the backward recomputes the probabilities.  The forward is the
op ``tapclip::mha``.  B7 is two launches
on the tensor cores (B4's row and column kernels, ``csrc/attn_bwd_mma.cuh``,
on the packed strides) at any T, as the JAX ``_fused_mha_bwd_impl`` runs at
any T: at ViT-L/14's T 257 and 584 they beat the blockwise flash chain on
the same strides, in f32 and bf16 (``time_half_blocks.py``; ``PERF.md``).
"""

from __future__ import annotations

from typing import Optional

import torch

from tapclip_tpu_torch.ops import _build, plain
from tapclip_tpu_torch.ops.attention import attention_reference
from tapclip_tpu_torch.ops.fused_mlp import (
    _grads_like, _ln_bwd_cuda, _ln_parts, _ln_rows, _partial_ln_bwd_cuda, _rnd, _summed_partials, ln_bwd_reference,
    partial_sum, seq_ln_bwd,
)
from tapclip_tpu_torch.ops.gemm import col_sum, col_sum_reference, gemm_f32, gemm_reference
from tapclip_tpu_torch.parallel import collectives
from tapclip_tpu_torch.parallel.collectives import all_reduce_, all_reduce_many_, gather_dim, reduce_scatter_dim

_LOG2E = 1.4426950408889634  # the kernels' kLog2e: scores are exp2'd
_LN2_BF16 = 0.69140625  # ln 2 rounded to bf16 (attn_variants.cuh's kLn2Bf16)


def attn_block_reference(x, gamma, beta, w_qkv, b_qkv, w_out, b_out, n_heads, valid, eps, partial=False):
    """Plain version: the composition of ``models/layers.py`` (``_attn_block_xla``):
    LayerNorm, the QKV product, :func:`attention_reference` over the heads,
    the out-projection and the residual (``partial``:
    :func:`attn_block_partial_reference`, ``b_out`` unused)."""
    if partial:
        return attn_block_partial_reference(x, gamma, beta, w_qkv, b_qkv, w_out, n_heads, valid, eps)
    B, T, W = x.shape
    kv = None if valid == T else valid
    qkv = plain.dense(plain.layer_norm(x, {"scale": gamma, "bias": beta}, eps), w_qkv, b_qkv)
    q, k, v = (_split_heads(t, n_heads).contiguous() for t in qkv.split(W, dim=-1))
    out, _ = attention_reference(q, k, v, kv_valid_len=kv)
    return x + plain.dense(out.transpose(1, 2).reshape(B, T, W), w_out, b_out)


def attn_block_partial_reference(x, gamma, beta, w_qkv, b_qkv, w_out, n_heads, valid, eps):
    """Plain version of K2's partial mode: over the rank's ``n_heads`` heads
    (``w_qkv [W, 3 Wl]``, ``w_out [Wl, W]``), ``attn . w_out`` in f32, no
    residual and no ``b_out``."""
    B, T, _ = x.shape
    Wl = w_out.shape[0]
    kv = None if valid == T else valid
    qkv = plain.dense(plain.layer_norm(x, {"scale": gamma, "bias": beta}, eps), w_qkv, b_qkv)
    q, k, v = (_split_heads(t, n_heads).contiguous() for t in qkv.split(Wl, dim=-1))
    out, _ = attention_reference(q, k, v, kv_valid_len=kv)
    return torch.matmul(out.transpose(1, 2).reshape(B, T, Wl).float(), w_out.to(x.dtype).float())


def attn_block_bwd_reference(x, g, gamma, beta, w_qkv, b_qkv, w_out, n_heads, valid, eps, tp_group=None,
                             seq=None):
    """Plain backward of :func:`attn_block_reference`, written out as
    ``_attn_block_bwd_kernel`` computes it (same roundings in bfloat16).
    With ``tp_group`` the weights are a rank's heads and dy is summed over
    the group before the LayerNorm backward (B4's partial mode); ``seq``:
    as ``fused_mlp.fused_mlp_bwd_reference``'s.

    ``x, g [B, T, W]`` in the compute dtype.  Returns ``(dx, dgamma, dbeta,
    dw_qkv, db_qkv, dw_out, db_out)``: dx in x.dtype, the rest f32.
    """
    dy, n, rstd, dw_qkv, db_qkv, dw_out = attn_block_bwd_partial_reference(
        x, g, gamma, beta, w_qkv, b_qkv, w_out, n_heads, valid, eps)
    db_out = col_sum_reference(g.reshape(dy.shape).float())
    if seq is not None:
        return (*seq_ln_bwd(seq, dy, n, rstd, gamma, tp_group), dw_qkv, db_qkv, dw_out, db_out)
    if tp_group is not None:
        all_reduce_(dy, tp_group)
    dx, dgamma, dbeta = ln_bwd_reference(x, g, dy, n, rstd, gamma)
    return dx, dgamma, dbeta, dw_qkv, db_qkv, dw_out, db_out


def attn_block_bwd_partial_reference(x, g, gamma, beta, w_qkv, b_qkv, w_out, n_heads, valid, eps):
    """Plain version of B4's launches up to dy (its partial mode's first
    call) over the heads given: ``(dy [R, W] f32, n, rstd, dw_qkv, db_qkv,
    dw_out)``, dy the LayerNorm output's gradient."""
    dt = x.dtype
    B, T, W = x.shape
    n, rstd, y = _ln_parts(x.reshape(B * T, W), gamma, beta, eps)
    n, rstd, y = n.reshape(B, T, W), rstd.reshape(B, T, 1), y.reshape(B, T, W)
    W = w_out.shape[0]  # the width of the heads given
    Dh = W // n_heads
    scale = Dh ** -0.5
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
    gc2 = gc.reshape(B * T, -1)
    dy = dqkv @ _rnd(w_qkv, dt).T
    return (dy, n.reshape(B * T, -1), rstd.reshape(B * T, 1),
            gemm_reference(y32.reshape(B * T, -1), dqkv, trans_a=True), col_sum_reference(dqkv),
            gemm_reference(attn, gc2, trans_a=True))


class _FusedAttnBlock(torch.autograd.Function):
    """K2 forward and B4 backward (plain versions on a CPU tensor)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w_qkv, b_qkv, w_out, b_out, n_heads, valid, eps):
        ctx.save_for_backward(x, gamma, beta, w_qkv, b_qkv, w_out, b_out)
        ctx.cfg = (n_heads, valid, eps)
        return _build.run(torch.ops.tapclip.attn_block.default, attn_block_reference, _fused_attn_block_cuda,
                          x, gamma, beta, w_qkv, b_qkv, w_out, b_out, n_heads, valid, eps)

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
            grads = _attn_block_bwd_cuda(*args, weight_grads=tuple(need[1:7]))
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


class _FusedAttnBlockPartial(torch.autograd.Function):
    """The tensor-parallel half-block: K2's and B4's partial modes around the
    all-reduces over ``group``, or with ``seq`` the all-gathers and
    reduce-scatters over T (plain versions on a CPU tensor)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w_qkv, b_qkv, w_out, b_out, n_heads, valid, eps, group, seq):
        ctx.save_for_backward(x, gamma, beta, w_qkv, b_qkv, w_out, b_out)
        ctx.cfg, ctx.group, ctx.seq = (n_heads, valid, eps), group, seq
        acc = _build.run(torch.ops.tapclip.attn_block.default, attn_block_reference, _fused_attn_block_cuda,
                         gather_dim(x, group, 1) if seq else x, gamma, beta, w_qkv, b_qkv, w_out, b_out, n_heads,
                         valid, eps, True)
        return (x.float() + (partial_sum(acc, x, group, seq) + b_out.float())).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        x, gamma, beta, w_qkv, b_qkv, w_out, _ = saved
        need = ctx.needs_input_grad
        g = g.to(x.dtype).contiguous()
        seq = (x, g) if ctx.seq else None
        if seq is not None:  # the whole rows, gathered again (the forward saved the rank's)
            x, g = gather_dim(x, ctx.group, 1), gather_dim(g, ctx.group, 1)
        args = (x, g, gamma, beta, w_qkv, b_qkv, w_out, *ctx.cfg)
        if x.device.type == "cpu":
            grads = attn_block_bwd_reference(*args, tp_group=ctx.group, seq=seq)
        elif not _tile_fits(x.shape[1], w_out.shape[0] // ctx.cfg[0]):
            grads = _split_block_partial_grads((x, *saved[1:]), g, need, *ctx.cfg, ctx.group, seq)
        else:
            grads = _attn_block_bwd_partial_cuda(*args, group=ctx.group, weight_grads=tuple(need[1:7]), seq=seq)
        return (*_grads_like(grads, saved, need), None, None, None, None, None)


def _split_block_partial_grads(saved, g, need, n_heads, valid, eps, group, seq=None):
    """The partial half-block's gradients past B4's tile: autograd through the
    rank's split composition (LayerNorm and the projections in torch around
    :func:`fused_mha`, differentiated on B7) with g as the cotangent of its
    f32 partial, then dx's LayerNorm part, dgamma and dbeta all-reduced over
    ``group`` and g added to dx once (``seq``: dx's part reduce-scattered
    over T, the rank's g added)."""
    x, gamma, beta, w_qkv, b_qkv, w_out, _ = saved
    dt = x.dtype
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True), *(t.detach().requires_grad_(True) for t in saved[1:6])]
        xx, gm, bt, wq, bq, wo = leaves
        y = _ln_parts(xx, gm, bt, eps)[2].float()
        qkv = (y @ _rnd(wq, dt) + bq.float()).to(dt)
        part = fused_mha(qkv, n_heads, valid_len=valid).float() @ _rnd(wo, dt)
        grads = list(torch.autograd.grad(part, leaves, g.float()))
    dx_ln, dgamma, dbeta = grads[0].float(), grads[1], grads[2]
    all_reduce_many_([dgamma, dbeta], group)
    g2 = g.reshape(-1, g.shape[-1]).float()
    if seq is not None:
        dx_ln, g = reduce_scatter_dim(dx_ln, group, 1), seq[1]
    else:
        all_reduce_(dx_ln, group)
    dx = (g.float() + dx_ln).to(dt)
    return [dx, dgamma, dbeta, grads[3], grads[4], grads[5], col_sum_reference(g2) if need[6] else None]


def fused_attn_block(
    x: torch.Tensor,
    ln_params,
    attn_params,
    n_heads: int,
    *,
    valid_len: Optional[int] = None,
    eps: float = 1e-5,
    tp_group=None,
    seq: bool = False,
) -> torch.Tensor:
    """The attention half-block: K2/B4 on CUDA, plain on CPU.  ``tp_group``:
    the rank holds its ``n_heads`` heads' columns of ``attn_params`` (the
    per-head cut) and the partial products are all-reduced over the group
    (K2's and B4's partial modes); ``seq``: x is the rank's rows of the
    sequence (``valid_len`` counts the whole sequence's), the partials
    reduce-scattered over T."""
    T = x.shape[1] * (collectives.size(tp_group) if seq else 1)
    valid = valid_len if valid_len is not None else T
    args = (x, ln_params["scale"], ln_params["bias"], attn_params["w_qkv"], attn_params["b_qkv"],
            attn_params["w_out"], attn_params["b_out"], n_heads, valid, eps)
    if tp_group is not None:
        return _FusedAttnBlockPartial.apply(*args, tp_group, seq)
    return _FusedAttnBlock.apply(*args)


fused_attn_block.launches = 0
fused_attn_block.bwd_launches = 0
fused_attn_block.partial_launches = 0
fused_attn_block.partial_bwd_launches = 0


def _check_heads(T, W, n_heads, valid):
    Dh = W // n_heads
    if W % n_heads or Dh not in (16, 32, 64, 128):
        raise ValueError(f"attention block kernel takes head dims 16/32/64/128, got W={W}, heads={n_heads}")
    if not 1 <= valid <= T:
        raise ValueError(f"valid_len must be in [1, {T}], got {valid}")
    return Dh


def _attn_operands(x, gamma, beta, w_qkv, b_qkv, w_out, Wl, **extra):
    """Cast the parameters as K2 / B4 take them (``Wl``: the heads' width,
    W or a rank's) and check every operand and its alignment."""
    B, T, W = x.shape
    dtype, f32 = x.dtype, torch.float32
    ops = {
        "x": (x, dtype, (B, T, W)),
        **{k: (v, dtype, (B, T, W)) for k, v in extra.items()},
        "gamma": (gamma.to(f32), f32, (W,)),
        "beta": (beta.to(f32), f32, (W,)),
        "w_qkv": (w_qkv.to(dtype), dtype, (W, 3 * Wl)),
        "b_qkv": (b_qkv.to(f32), f32, (3 * Wl,)),
        "w_out": (w_out.to(dtype), dtype, (Wl, W)),
    }
    for name, (t, dt, shape) in ops.items():
        _build.check_cuda_operand(name, t, dt, shape)
    t = {name: v[0] for name, v in ops.items()}
    align = 4 * x.element_size()  # the GEMMs copy 4 elements at a time at least
    for name in ("x", *extra, "w_qkv", "w_out"):
        if t[name].data_ptr() % align:
            raise ValueError(f"attention block kernel copies {name} in {align}-byte chunks: it must be "
                             f"{align}-byte aligned")
    return t


def _fused_attn_block_cuda(x, gamma, beta, w_qkv, b_qkv, w_out, b_out, n_heads, valid, eps, partial=False):
    """K2 (``partial``: its partial mode over the ``n_heads`` heads of the
    per-head cut weights, an f32 ``[B, T, W]`` of the out-projection alone;
    ``b_out`` unused)."""
    B, T, W = x.shape
    Wl = w_out.shape[0] if partial else W
    dtype, f32 = x.dtype, torch.float32
    _check_heads(T, Wl, n_heads, valid)
    t = _attn_operands(x, gamma, beta, w_qkv, b_qkv, w_out, Wl)
    qkv = torch.empty((B * T, 3 * Wl), dtype=f32, device=x.device)  # q | k | v, v rounded to the dtype
    ya = torch.empty_like(x)  # y = LN(x), then the attention output
    lib, code, stream = _build.library(), _build.dtype_code(dtype), _build.stream_handle(x.device)
    if partial:
        out = torch.empty(x.shape, dtype=f32, device=x.device)
        err = lib.tapclip_attn_block_partial(
            x.data_ptr(), t["gamma"].data_ptr(), t["beta"].data_ptr(), t["w_qkv"].data_ptr(), t["b_qkv"].data_ptr(),
            t["w_out"].data_ptr(), out.data_ptr(), qkv.data_ptr(), ya.data_ptr(), B, T, W, Wl, n_heads, int(valid),
            float(eps), code, stream,
        )
        _build.check(err, "tapclip_attn_block_partial")
        fused_attn_block.partial_launches += 1
        return out
    b_out = b_out.to(f32)
    _build.check_cuda_operand("b_out", b_out, f32, (W,))
    out = torch.empty_like(x)
    err = lib.tapclip_attn_block(
        x.data_ptr(), t["gamma"].data_ptr(), t["beta"].data_ptr(), t["w_qkv"].data_ptr(), t["b_qkv"].data_ptr(),
        t["w_out"].data_ptr(), b_out.data_ptr(), out.data_ptr(), qkv.data_ptr(), ya.data_ptr(),
        B, T, W, n_heads, int(valid), float(eps), code, stream,
    )
    _build.check(err, "tapclip_attn_block")
    fused_attn_block.launches += 1
    return out


def _attn_block_bwd_partial_cuda(x, g, gamma, beta, w_qkv, b_qkv, w_out, n_heads, valid, eps, *, group,
                                 weight_grads=True, split=None, seq=None):
    """B4's partial mode on the card: launches 1-6 over the rank's heads,
    dy's depth partials summed and all-reduced over ``group``, then the
    LayerNorm backward (``tapclip_ln_bwd``) and the weight gradients
    ``weight_grads`` asks for, as :func:`_attn_block_bwd_cuda` returns them.
    ``seq``: as ``fused_mlp._fused_mlp_bwd_partial_cuda``'s."""
    B, T, W = x.shape
    R, Wl = B * T, w_out.shape[0]
    Dh = _check_heads(T, Wl, n_heads, valid)
    want = (weight_grads,) * 6 if isinstance(weight_grads, bool) else tuple(weight_grads)
    weight_grads = any(want)
    lib = _build.library()
    if not _tile_fits(T, Dh):
        raise ValueError(f"attention block backward kernel runs up to its routing limit: T={T} exceeds "
                         f"{lib.tapclip_attn_bwd_max_seq(Dh)} at head dim {Dh}")
    t = _attn_operands(x, gamma, beta, w_qkv, b_qkv, w_out, Wl, g=g)
    dtype, f32, dev = x.dtype, torch.float32, x.device
    code, stream = _build.dtype_code(dtype), _build.stream_handle(dev)
    S = lib.tapclip_attn_block_bwd_split(R, W, code) if split is None else int(split)
    if S not in (1, 2, 4):
        raise ValueError(f"attention block backward kernel splits dy's depth 1, 2 or 4 ways, got {S}")
    # qkv, gh, dy partials, mean, rstd, lse, delta
    ws = torch.empty(R * (4 * Wl + S * W + 2 + 2 * n_heads), dtype=f32, device=dev)
    wsd = torch.empty(R * (W + (4 if weight_grads else 3) * Wl), dtype=dtype, device=dev)  # y, dqkv, o
    err = lib.tapclip_attn_block_bwd_partial(
        x.data_ptr(), g.data_ptr(), t["gamma"].data_ptr(), t["beta"].data_ptr(), t["w_qkv"].data_ptr(),
        t["b_qkv"].data_ptr(), t["w_out"].data_ptr(), ws.data_ptr(), wsd.data_ptr(), B, T, W, Wl, n_heads,
        int(valid), float(eps), S, int(weight_grads), code, stream,
    )
    _build.check(err, "tapclip_attn_block_bwd_partial")
    dy = _summed_partials(ws[R * 4 * Wl:R * (4 * Wl + S * W)], S)
    dx, ln_sums = _partial_ln_bwd_cuda(x, g, dy, ws[R * (4 * Wl + S * W):], t["gamma"], group, weight_grads,
                                       want[0] or want[1], code, stream, seq)
    fused_attn_block.partial_bwd_launches += 1
    if not weight_grads:
        return dx, None, None, None, None, None, None
    y = wsd[:R * W].view(R, W)
    dqkv = wsd[R * W:R * (W + 3 * Wl)].view(R, 3 * Wl)
    attn = wsd[R * (W + 3 * Wl):].view(R, Wl)
    g2 = g.reshape(R, W)
    return (dx, ln_sums[:W] if want[0] else None, ln_sums[W:] if want[1] else None,
            gemm_f32(y, dqkv, trans_a=True) if want[2] else None, col_sum(dqkv) if want[3] else None,
            gemm_f32(attn, g2, trans_a=True) if want[4] else None, col_sum(g2) if want[5] else None)


def _attn_block_bwd_cuda(x, g, gamma, beta, w_qkv, b_qkv, w_out, n_heads, valid, eps,
                         *, weight_grads=True, split=None):
    """B4 on the card: the seven launches of ``csrc/attn_block_bwd.cu`` (dx,
    and with any weight gradient o and the LayerNorm partials for them),
    then the A^T.B products and column sums of the weight gradients
    ``weight_grads`` asks for: True (all), False (none) or six flags in the
    order gamma, beta, w_qkv, b_qkv, w_out, b_out.  ``split``: the split of
    dy's depth into f32 partials (1, 2 or 4; None takes the kernel's choice
    for the shape).  Returns the seven gradients of
    :func:`attn_block_bwd_reference` (None for a weight gradient not
    computed)."""
    B, T, W = x.shape
    R = B * T
    Dh = _check_heads(T, W, n_heads, valid)
    want = (weight_grads,) * 6 if isinstance(weight_grads, bool) else tuple(weight_grads)
    weight_grads = any(want)
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
    ln_sums = col_sum(part) if want[0] or want[1] else None
    return (dx, ln_sums[:W] if want[0] else None, ln_sums[W:] if want[1] else None,
            gemm_f32(y, dqkv, trans_a=True) if want[2] else None, col_sum(dqkv) if want[3] else None,
            gemm_f32(attn, g2, trans_a=True) if want[4] else None, col_sum(g2) if want[5] else None)


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
        return _build.run(torch.ops.tapclip.mha.default, fused_mha_reference, _fused_mha_cuda, qkv, n_heads, valid, causal)

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
# ``group_heads`` is the walk's heads per block here (1 with no switch; the
# TPU scripts count heads per 128-lane step, 2 at head dim 64): a schedule
# switch, like tail_split.  The TPU switches with no counterpart on the card
# (swpipe, bB, vmem_mb) are not taken: the drivers drop them.

ATTN_VARIANT_FLAGS = {
    "variant": ("group_heads", "ln_1pass", "perhead_qkv", "softmax_opt"),
    "interleaved": ("group_heads",),
    "softmax": ("group_heads", "qk_cast", "fold_q", "mask_mode", "sum_mxu", "tail_split"),
}
_FORM_CODE = {"online": 0, "normalized": 1, "bf16": 2}  # attn_variants.cuh's Form
_MASK_CODE = {"full": 0, "tail": 1, "zerokv": 2}


def attn_variant_switches(form, T, valid, n_heads, **flags):
    """The kernel switches (``attn_variants.cuh``) of one variant; raises on a flag
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


# The card configurations (attn_variant_kernel) whose output is K2's bit for
# bit: K2's own code.  (perhead_qkv's online walk takes K2's product terms in
# K2's order and K2's walk arithmetic, and equals K2 in f32; its bf16 build
# differs from K2's in 2 of 1.2M attention elements by a bf16 step at
# ViT-B/16 batch 8, so it is not pinned.)
ATTN_K2_EQUAL = ("K2", "K2 group")


def attn_variant_kernel(sw, dtype) -> str:
    """The card's configuration of a variant's switches ``sw`` (from
    :func:`attn_variant_switches`) in ``dtype``, as ``tapclip_attn_variant``
    picks it (``csrc/attn_variants.cu``): "K2" (K2 itself,
    ``tapclip_attn_block``), "K2 group" (K2's launches around its tile function
    walking ``group`` heads a block: K2's output bit for bit), or K2's
    launches with the variant walk, "walk <softmax> qk<terms of q and k>" (and
    " tail_split", " interleaved") or "perhead <softmax>".  qk_round and
    sum_rounded round to f32 in f32, and mask "tail" selects where K2's walk
    selects: none changes a value there.  Raises ValueError on a combination
    the card does not take."""
    f32 = dtype == torch.float32
    qk1 = sw["qk_round"] and not f32
    sum_rounded = sw["sum_rounded"] and not f32
    zerokv = sw["mask"] == "zerokv"
    softmax = sw["softmax"]
    if softmax != "online" and (sum_rounded or sw["tail_split"] or sw["fold_q"] or zerokv):
        raise ValueError(f"the {softmax} softmax takes no sum_mxu, tail_split, fold_q or zerokv")
    if sw["smem_qkv"] and (softmax == "bf16" or qk1 or sw["fold_q"] or zerokv or sw["tail_split"]):
        raise ValueError("perhead_qkv takes the online and normalized softmax with q and k in f32, and no "
                         "fold_q, zerokv or tail_split")
    if softmax == "online" and not (sum_rounded or sw["tail_split"] or sw["smem_qkv"] or sw["ln1pass"] or qk1
                                    or sw["fold_q"] or zerokv):
        return "K2" if sw["group"] == 1 else "K2 group"
    if sw["smem_qkv"]:
        return f"perhead {softmax}"
    return (f"walk {softmax} qk{1 if qk1 else 3}" + (" tail_split" if sw["tail_split"] else "")
            + (" interleaved" if sw["interleaved"] else ""))


def attn_block_variant(x, ln_params, attn_params, n_heads, valid, *, eps=1e-5, form="variant", **flags):
    """S3/S4 (forward only): K2's four launches with the variant's switches
    (``csrc/attn_variants.cu``, the configuration :func:`attn_variant_kernel`
    names; every switch off is K2 itself) on a CUDA tensor;
    :func:`attn_block_variant_reference` on a CPU tensor."""
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
    attn_variant_kernel(sw, x.dtype)  # raises on what the card does not take
    lib = _build.library()
    dtype, f32 = x.dtype, torch.float32
    code = _build.dtype_code(dtype)
    if sw["smem_qkv"]:
        smem = lib.tapclip_attn_variant_smem_bytes(T, code)
        limit = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
        if smem > limit:
            raise ValueError(f"perhead_qkv keeps k and v of T={T} in shared memory: {smem} bytes, past the "
                             f"card's {limit} a block")
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
    R = B * T
    # K2's f32 workspace; y then (perhead_qkv) the attention output; the
    # interleaved form's partials, one a head group.
    qkv = None if sw["smem_qkv"] else torch.empty((R, 3 * W), dtype=f32, device=x.device)
    ya = torch.empty(((2 if sw["smem_qkv"] else 1) * R, W), dtype=dtype, device=x.device)
    part = (torch.empty((n_heads // sw["group"], R, W), dtype=f32, device=x.device) if sw["interleaved"]
            else None)
    out = torch.empty_like(x)

    def ptr(tensor):
        return None if tensor is None else tensor.data_ptr()

    err = lib.tapclip_attn_variant(
        x.data_ptr(), *(t[n].data_ptr() for n in ("gamma", "beta", "w_qkv", "b_qkv", "w_out", "b_out")),
        out.data_ptr(), ptr(qkv), ya.data_ptr(), ptr(part), B, T, W, n_heads, int(valid), float(eps),
        _FORM_CODE[sw["softmax"]], int(sw["sum_rounded"]), int(sw["tail_split"]), int(sw["smem_qkv"]),
        int(sw["interleaved"]), int(sw["ln1pass"]), int(sw["qk_round"]), int(sw["fold_q"]), _MASK_CODE[sw["mask"]],
        sw["group"], code, _build.stream_handle(x.device),
    )
    _build.check(err, "tapclip_attn_variant")
    attn_block_variant.launches += 1
    return out


attn_block_variant.launches = 0
