"""The error of the tensor-core kernels' split-operand products, emulated on the CPU.

    python3 -m tapclip_tpu_torch.scripts.split_error [--terms N]

K3, the flash backward chain (``csrc/flash_mma.cuh``) and K1
(``csrc/fused_mlp.cu``) run every product on the tensor cores in bf16 with
f32 accumulation.  An f32 operand is split
into bf16 terms, ``x = x0 + x1 + ...`` with ``x0 = bf16(x)`` and each later
term the bf16 rounding of what is left, and a product sums the partial
products of the term pairs ``(i, j)`` with ``i + j < max(terms)``.  A product
of two bf16 values is exact in f32, so this module computes the same sums in
torch's f32 matmul: only the order of the f32 additions differs from the
card.

:func:`emulated_errors` runs K3's forward and the chain's three kernels that
way at one shape and reports each result's error against the plain versions
of ``tapclip_tpu_torch.ops.flash_attention`` on the same inputs: the LSE's
max abs error, the norm-relative error of the output and of dq, dk, dv, and
the aux column's max abs error.  Run as a script it prints them, one JSON
line per shape, at the card tests' flash shapes (``FLASH_SHAPES`` of
``tests/port/test_torch_gpu.py``), in f32 with ``--terms`` terms per operand
(default 3, the kernels' choice) and in bf16 (q, k, v, dO exact; p and ds in
two terms).  :func:`emulated_mlp_errors` does the same for K1's two products,
y . w_fc and h . w_proj (LayerNorm, bias, GELU and the residual in f32, y
and h rounded to the dtype), against ``fused_mlp_reference``: the script
prints one JSON line per shape of ``MLP_SHAPES``, the card tests' K1 shapes
and the deep sums of W 768 / H 3,072 and W 1,024 / H 4,096.
:func:`emulated_attn_block_errors` emulates K2 (``csrc/attn_block.cu``): its
QKV product and out-projection (three terms an f32 operand, one in bf16),
q . k^T on three-term q and k in both dtypes (they are f32 values), p . v
with p and v in three terms in f32 and one in bf16 (p rounded, v a bf16
value), against ``attn_block_reference`` at ``ATTN_SHAPES`` (the card
tests' K2 shapes).  :func:`emulated_mlp_bwd_errors` emulates B5's dx
(``csrc/mlp_bwd.cu``): the fc recompute, dh = g . w_proj^T and
dy = dh_pre . w_fc^T on split operands, against ``fused_mlp_bwd_reference``
at ``MLP_BWD_SHAPES`` (the card tests' B5 shapes).
:func:`emulated_attn_block_bwd_errors` emulates B4 (``csrc/attn_block_bwd.cu``):
the QKV recompute, gh = g . w_out^T and dy = dqkv . w_qkv^T on split operands,
and its attention core (the row LSE, then p, o = p v and dv = p^T gh with p,
v and gh in three terms in f32 and their bf16 rounding in bf16, dp = gh v^T,
dq = ds k and dk = ds^T q in three terms in both dtypes, delta = sum(dp p)),
with the weight gradients as the plain products of its o and dqkv, against
``attn_block_bwd_reference`` at ``ATTN_BWD_SHAPES`` (the card tests' B4
shapes): the norm-relative error of each of the seven gradients.
:func:`emulated_mha_bwd_errors` emulates B7 (``csrc/mha_bwd.cu``, B4's row
and column kernels on the packed strides, causal or not: q, k, v and g in
three terms in f32 and one in bf16, p's bf16 rounding for dv in bf16, ds in
three terms) against ``fused_mha_bwd_reference`` at ``MHA_BWD_SHAPES``.
:func:`emulate_mha` emulates B6 (``csrc/mha.cu`` on K2's attention walk,
causal or not: q . k^T and p . v with q, k, p and v in three terms in f32
and one in bf16, where p is rounded and q, k, v are bf16 values):
:func:`emulated_mha_errors` holds it against ``fused_mha_reference`` at
``MHA_BWD_SHAPES`` (the card tests' B6 and B7 shapes).
:func:`emulate_dw` emulates ``csrc/gemm.cu``'s dW products A^T . B over
rows (three terms an f32 operand, one in bf16, a rounded f32 add per 16-row
step, the rows split in parts of whole stages summed in order), and
:func:`emulated_dw_errors` holds it against float64 at ``DW_SHAPES``.
:func:`emulate_attn_variant` emulates S3 and S4 (``csrc/attn_variants.cu``:
K2's launches with the switches of the A/B variants) and
:func:`emulated_attn_variant_errors` holds one variant against
``attn_block_variant_reference``.
:func:`emulate_int8_attn` emulates B14 (``csrc/int8_attn.cu``): its
attention step on split q and k, p and v in three terms or (the stochastic
mode in bf16) one, and the codes of the attention output from the row max
taken per head's column tile (:func:`int8_head_tiled_codes`).
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from tapclip_tpu_torch.ops.attention import attention_reference
from tapclip_tpu_torch.ops.flash_attention import (
    _LOG2E,
    _masked_scores,
    attention_bwd_reference,
    attention_lse_reference,
)
from tapclip_tpu_torch.ops.fused_mha import attn_block_bwd_reference, attn_block_reference, fused_mha_bwd_reference
from tapclip_tpu_torch.ops.fused_mlp import _ln_parts, fused_mlp_bwd_reference, fused_mlp_reference, ln_backward

# (B, H, T, Dh, per-row valid), as FLASH_SHAPES of tests/port/test_torch_gpu.py.
FLASH_SHAPES = [(2, 3, 1, 64, [1, 1]), (2, 2, 77, 64, [77, 60]), (3, 2, 88, 32, [82, 82, 40]),
                (1, 3, 130, 16, [130]), (1, 2, 577, 128, [577]), (1, 2, 2100, 64, [2000]),
                (2, 2, 15, 64, [15, 9]), (2, 2, 63, 32, [63, 40]), (1, 2, 65, 128, [64])]
# (rows, W) of K1 (H = 4 W), as the K1 shapes of tests/port/test_torch_gpu.py
# (test_fused_mlp_kernel, K1_EDGES), the image shape among them.
MLP_SHAPES = [(1, 64), (21, 128), (400, 256), (21, 80), (37, 96), (9, 68), (1, 512), (21, 768), (1601, 768),
              (1600, 768), (264, 1024)]
# (B, T, W, heads, valid) of K2, as K2_EDGES of tests/port/test_torch_gpu.py.
ATTN_SHAPES = [(3, 13, 128, 8, 1), (2, 33, 128, 1, 33), (2, 65, 256, 8, 40), (2, 77, 512, 8, 77),
               (8, 88, 512, 8, 82), (1, 129, 1024, 8, 100), (8, 200, 768, 12, 197), (1, 264, 1024, 16, 257)]
# (rows, W) of B5 (H = 4 W), as B5_EDGES of tests/port/test_torch_gpu.py.
MLP_BWD_SHAPES = [(21, 32), (37, 64), (90, 128), (300, 256), (704, 512), (1600, 768), (65, 1024)]
# (B, T, W, heads, valid) of B4, as the B4 shapes of tests/port/test_torch_gpu.py
# (test_fused_attn_block_bwd_kernel, B4_EDGES).
ATTN_BWD_SHAPES = [(2, 16, 128, 2, 13), (1, 65, 64, 4, 65), (3, 88, 256, 2, 82), (1, 40, 256, 8, 33),
                   (8, 88, 512, 8, 82), (2, 200, 768, 12, 197), (2, 33, 128, 4, 30), (1, 210, 512, 8, 205),
                   (1, 97, 256, 2, 90)]
# (B, T, W, heads, valid, causal) of B7, as MHA_SHAPES of tests/port/test_torch_gpu.py.
MHA_BWD_SHAPES = [(8, 77, 512, 8, 77, True), (8, 80, 512, 8, 77, True), (2, 200, 768, 12, 197, False),
                  (2, 200, 768, 12, 197, True), (3, 77, 128, 2, 77, False), (1, 70, 256, 2, 50, True),
                  (2, 65, 64, 4, 65, True), (1, 40, 256, 8, 33, False)]
F32_TERMS = 3  # bf16 terms of an f32 operand in the kernels (flash_mma.cuh kF32Terms)
ACC_TERMS_BF16 = 2  # of p and ds beside bf16 operands (kAccTerms)
# (rows, M, N, split) of gemm.cu's dW products: ragged row counts at small
# widths, the whole depth in one part and split.
DW_SHAPES = [(1, 24, 40, 1), (17, 24, 40, 1), (17, 24, 40, 3), (2049, 24, 40, 1), (2049, 24, 40, 3),
             (2049, 24, 40, 8)]
DW_STAGE = 32  # rows of a staged tile (gemm_mma.cuh kBK): a split of the rows takes whole stages


def split_terms(x: torch.Tensor, n: int) -> list:
    """``n`` f32 tensors holding bf16 values whose sum is ``x`` up to the last
    term's rounding: ``x0 = bf16(x)``, ``x1 = bf16(x - x0)``, ..."""
    terms, rest = [], x.float()
    for _ in range(n):
        t = rest.to(torch.bfloat16).float()
        terms.append(t)
        rest = rest - t
    return terms


def split_matmul(a: torch.Tensor, b: torch.Tensor, na: int, nb: int) -> torch.Tensor:
    """``a @ b`` as the kernels form it: the partial products of the terms
    ``(i, j)`` with ``i + j < max(na, nb)``, summed in f32, smallest first."""
    ta, tb, n = split_terms(a, na), split_terms(b, nb), max(na, nb)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for s in range(n - 1, -1, -1):
        for i in range(na):
            if 0 <= s - i < nb:
                out = out + ta[i] @ tb[s - i]
    return out


def _emulate(q, k, v, g, valid, causal, f32_terms):
    """(out, aux, lse, dq, dk, dv) in f32 as the kernels compute them."""
    B, H, T, Dh = q.shape
    f32 = q.dtype == torch.float32
    nt = f32_terms if f32 else 1  # terms of q, k, v, dO
    nacc = f32_terms if f32 else ACC_TERMS_BF16  # of p and ds
    mask = _masked_scores(q, k, valid, causal)[1]
    s2 = split_matmul(q, k.transpose(-1, -2), nt, nt) * (Dh ** -0.5 * _LOG2E)
    s2 = torch.where(mask, s2, torch.full_like(s2, -1e30))
    m = s2.amax(dim=-1, keepdim=True)
    e = torch.exp2(s2 - m)
    l = e.sum(dim=-1, keepdim=True)
    # The forward rounds p to the compute dtype before p v (one term in bf16).
    out = split_matmul(e, v, nt if f32 else 1, nt) / l
    aux = (e / l).mean(dim=1)  # every column; the caller picks the attribution key
    lse = (m + torch.log2(l.clamp_min(1e-30)))[..., 0]
    delta = (g.float() * out.to(q.dtype).float()).sum(dim=-1)
    p = torch.where(mask, torch.exp2(s2 - lse[..., None]), torch.zeros_like(s2))
    dp = split_matmul(g, v.transpose(-1, -2), nt, nt)
    ds = p * (dp - delta[..., None]) * Dh ** -0.5
    dv = split_matmul(p.transpose(-1, -2), g, nacc, nt)
    dk = split_matmul(ds.transpose(-1, -2), q, nacc, nt)
    dq = split_matmul(ds, k, nacc, nt)
    return out, aux, lse, dq, dk, dv


def _rel(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def emulate_dw(a, b, split=1, f32_terms=F32_TERMS):
    """``a^T . b`` over the rows as ``csrc/gemm.cu`` sums it (A transposed,
    ``a [rows, M]``, ``b [rows, N]``): each 16-row step's partial products of
    the operands' bf16 terms (three an f32 operand, one a bf16 one) summed
    from 0, smallest first, and added to the part's sum with a rounded f32
    add; the rows in ``split`` parts of whole 32-row stages, each summed from
    0, then the parts added in order."""
    rows, M = a.shape
    N = b.shape[1]
    nt = f32_terms if a.dtype == torch.float32 else 1
    steps = -(-rows // 16)
    pad = steps * 16 - rows
    a3 = torch.cat([a.float(), a.new_zeros(pad, M, dtype=torch.float32)]).view(steps, 16, M)
    b3 = torch.cat([b.float(), b.new_zeros(pad, N, dtype=torch.float32)]).view(steps, 16, N)
    prods = split_matmul(a3.transpose(1, 2), b3, nt, nt)  # [steps, M, N]
    stages = -(-rows // DW_STAGE)
    per = -(-stages // split) * (DW_STAGE // 16)  # 16-row steps a part
    out = None
    for s in range(split):
        part = torch.zeros(M, N)
        for k in range(s * per, min(steps, (s + 1) * per)):
            part = part + prods[k]
        out = part if out is None else out + part
    return out


def emulated_dw_errors(rows, M, N, dtype=torch.float32, split=1, f32_terms=F32_TERMS, seed=0) -> dict:
    """Errors of :func:`emulate_dw` against float64 on the same inputs (numpy
    normal draws from ``seed``, in ``dtype``): the max abs error beside
    ``chip_smoke.py``'s limit for the card's dW check, 1e-4 sqrt(rows), and
    the norm-relative error."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((rows, M)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal((rows, N)).astype(np.float32)).to(dtype)
    got = emulate_dw(a, b, split, f32_terms)
    want = a.double().T @ b.double()
    return {"max_abs": float((got.double() - want).abs().max()), "limit_abs": 1e-4 * rows ** 0.5,
            "rel": float((got.double() - want).norm() / want.norm().clamp_min(1e-300))}


def emulated_errors(B, H, T, Dh, valid, causal, dtype=torch.float32, f32_terms=F32_TERMS, seed=0) -> dict:
    """Errors of the emulated kernels against the plain versions on the same
    inputs (numpy normal draws from ``seed``, in ``dtype``): ``lse_abs``,
    ``out_rel``, ``aux_abs``, and for each of dq, dk, dv ``*_rel`` and
    ``*_abs`` (max abs), the output and the gradients in ``dtype`` as both
    sides return them."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, T, Dh), dtype=np.float32)).to(dtype)
                  for _ in range(4))
    valid_t = torch.tensor(valid, dtype=torch.int32)
    eot = valid_t - 1
    out, aux, lse, dq, dk, dv = _emulate(q, k, v, g, valid_t, causal, f32_terms)
    want_out, want_aux = attention_reference(q, k, v, causal=causal, kv_valid_len=valid_t, attn_to_idx=eot)
    want = attention_bwd_reference(q, k, v, g, valid_t, causal)
    aux = torch.take_along_dim(aux, eot.long().view(B, 1, 1).expand(B, T, 1), dim=2)[..., 0]
    errs = {"lse_abs": float((lse - attention_lse_reference(q, k, valid_t, causal)).abs().max()),
            "out_rel": _rel(out.to(dtype), want_out), "aux_abs": float((aux - want_aux).abs().max())}
    for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        errs[f"{n}_rel"] = _rel(a.to(dtype), b)
        errs[f"{n}_abs"] = float((a.to(dtype).float() - b.float()).abs().max())
    return errs


def emulate_mlp(x, gamma, beta, w_fc, b_fc, w_proj, b_proj, eps=1e-5, f32_terms=F32_TERMS):
    """K1 as the card computes it: LayerNorm in f32 (two-pass) rounded to x's
    dtype, the two products on split operands (``f32_terms`` terms each in
    f32, one in bf16), bias and exact GELU in f32, h rounded, the residual and
    b_proj added in f32, one rounding of the result."""
    dt = x.dtype
    nt = f32_terms if dt == torch.float32 else 1
    W = x.shape[-1]
    x32 = x.reshape(-1, W).float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()).to(dt).float()
    z = split_matmul(y, w_fc.to(dt).float(), nt, nt) + b_fc.float()
    h = (0.5 * z * (1.0 + torch.erf(z * 2.0 ** -0.5))).to(dt).float()
    out = split_matmul(h, w_proj.to(dt).float(), nt, nt) + b_proj.float()
    return (x32 + out).to(dt).reshape(x.shape)


def mlp_inputs(R, W, seed=0):
    """x [R, W] and K1's parameters (H = 4 W), f32 numpy normal draws from
    ``seed`` at the card tests' scales."""
    rng = np.random.default_rng(seed)
    H = 4 * W

    def f(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))

    return (f(R, W), 1.0 + f(W, scale=0.1), f(W, scale=0.1), f(W, H, scale=W ** -0.5), f(H, scale=0.1),
            f(H, W, scale=H ** -0.5), f(W, scale=0.1))


def emulated_mlp_errors(R, W, dtype=torch.float32, f32_terms=F32_TERMS, seed=0) -> dict:
    """K1's emulated output against ``fused_mlp_reference`` on the same inputs
    (x in ``dtype``): ``out_rel`` (norm-relative) and ``out_abs``."""
    x, *params = mlp_inputs(R, W, seed)
    x = x.to(dtype)
    got = emulate_mlp(x, *params, f32_terms=f32_terms)
    want = fused_mlp_reference(x, *params)
    return {"out_rel": _rel(got, want), "out_abs": float((got.float() - want.float()).abs().max())}


def _heads(t, n_heads):  # [B, T, W] -> [B, H, T, Dh]
    B, T, W = t.shape
    return t.reshape(B, T, n_heads, W // n_heads).transpose(1, 2)


def emulate_attn_block(x, gamma, beta, w_qkv, b_qkv, w_out, b_out, n_heads, valid, eps=1e-5,
                       f32_terms=F32_TERMS):
    """K2 as the card computes it: LayerNorm in f32 rounded to x's dtype;
    qkv = y . w_qkv + b_qkv on split operands (``f32_terms`` terms each in
    f32, one in bf16), v rounded to the dtype, q and k f32; scores
    q . k^T (``f32_terms`` terms of q and k in both dtypes) times
    Dh^-1/2 log2 e, keys at or past ``valid`` at -1e30, exp2 against the row
    max, l over the unrounded p; p . v (``f32_terms`` terms of p and v in
    f32; one in bf16, where that term is p's rounding and v's exact value)
    over l, rounded; the out-projection on split operands, + b_out + x in
    f32, one rounding of the result."""
    dt = x.dtype
    nt = f32_terms if dt == torch.float32 else 1
    B, T, W = x.shape
    Dh = W // n_heads
    y = _ln_parts(x, gamma, beta, eps)[2].float()
    qkv = split_matmul(y, w_qkv.to(dt).float(), nt, nt) + b_qkv.float()
    q, k, v = (_heads(t, n_heads) for t in qkv.split(W, dim=-1))
    v = v.to(dt).float()
    s = split_matmul(q, k.transpose(-1, -2), f32_terms, f32_terms) * (Dh ** -0.5 * _LOG2E)
    s = torch.where(torch.arange(T) < valid, s, torch.full_like(s, -1e30))
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = split_matmul(e, v, nt, nt) / e.sum(dim=-1, keepdim=True)
    attn = o.transpose(1, 2).reshape(B, T, W).to(dt).float()
    out = split_matmul(attn, w_out.to(dt).float(), nt, nt) + b_out.float()
    return (x.float() + out).to(dt)


def attn_block_inputs(B, T, W, seed=0):
    """x [B, T, W] and K2's parameters, f32 numpy normal draws from ``seed``
    at the card tests' scales."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))

    return (f(B, T, W), 1.0 + f(W, scale=0.1), f(W, scale=0.1), f(W, 3 * W, scale=W ** -0.5),
            f(3 * W, scale=0.1), f(W, W, scale=W ** -0.5), f(W, scale=0.1))


def emulated_attn_block_errors(B, T, W, n_heads, valid, dtype=torch.float32, f32_terms=F32_TERMS, seed=0) -> dict:
    """K2's emulated output against ``attn_block_reference`` on the same
    inputs (x in ``dtype``): ``out_rel`` (norm-relative) and ``out_abs``."""
    x, *params = attn_block_inputs(B, T, W, seed)
    x = x.to(dtype)
    got = emulate_attn_block(x, *params, n_heads, valid, f32_terms=f32_terms)
    want = attn_block_reference(x, *params, n_heads, valid, 1e-5)
    return {"out_rel": _rel(got, want), "out_abs": float((got.float() - want.float()).abs().max())}


def emulate_attn_variant(x, gamma, beta, w_qkv, b_qkv, w_out, b_out, n_heads, valid, eps=1e-5, *,
                         form="variant", f32_terms=F32_TERMS, **flags):
    """S3/S4 as the card computes them (``csrc/attn_variants.cu``: K2's
    launches with the variant's switches), as :func:`emulate_attn_block`
    computes K2: LayerNorm (``ln1pass``: one-pass statistics) rounded; the
    QKV product on split operands, v rounded; q times Dh^-1/2 log2 e in f32
    with ``fold_q``; pad rows of k and v zeroed with ``zerokv``; q . k^T on
    ``f32_terms`` terms of q and k, or one (their rounding) where the variant
    rounds them in bf16, the same in both passes of the two-pass forms; the
    normalised softmax's p = exp(s - m) / l before p . v, the "bf16" form's p
    = bf16(exp(bf16(bf16(s - m) bf16(ln 2)))) (one exact term), the online
    form's exp2 with l over p or (``sum_mxu``) its rounding, ``zerokv``'s
    l -= n_pad exp2(-m), ``tail_split``'s two online states over the key
    tiles before and from (T / 128) 128 (as far as the walk goes: the tiles
    that reach valid) merged; p . v on ``f32_terms`` terms of p and v in f32
    and one in bf16; the out-projection on split operands, or (interleaved)
    the f32 partials of each head group's rows of w_out summed in group
    order, + b_out + x, one rounding of the result."""
    from tapclip_tpu_torch.ops.fused_mha import _LN2_BF16, attn_variant_switches
    from tapclip_tpu_torch.ops.fused_mlp import _ln_rows

    dt = x.dtype
    f32 = dt == torch.float32
    nt = f32_terms if f32 else 1
    B, T, W = x.shape
    Dh = W // n_heads
    sw = attn_variant_switches(form, T, valid, n_heads, **flags)
    x32 = x.float()
    y = (_ln_rows(x32, eps, sw["ln1pass"]) * gamma.float() + beta.float()).to(dt).float()
    qkv = split_matmul(y, w_qkv.to(dt).float(), nt, nt) + b_qkv.float()
    q, k, v = (_heads(t, n_heads) for t in qkv.split(W, dim=-1))
    if sw["fold_q"]:
        q = q * (Dh ** -0.5 * _LOG2E)
    pad = torch.arange(T) >= valid
    zerokv = sw["mask"] == "zerokv"
    if zerokv:
        k = k.masked_fill(pad[:, None], 0.0)
        v = v.masked_fill(pad[:, None], 0.0)
    v = v.to(dt).float()
    nqk = 1 if sw["qk_round"] and not f32 else f32_terms
    s = split_matmul(q, k.transpose(-1, -2), nqk, nqk)
    neg = torch.full_like(s, -1e30)
    if sw["softmax"] == "normalized":
        s = torch.where(pad, neg, s * Dh ** -0.5)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = split_matmul(e / e.sum(dim=-1, keepdim=True), v, nt, nt)
    else:
        if not sw["fold_q"]:
            s = s * (Dh ** -0.5 * _LOG2E)
        if not zerokv:
            s = torch.where(pad, neg, s)
        if sw["softmax"] == "bf16":
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(((s - m).to(torch.bfloat16).float() * _LN2_BF16).to(torch.bfloat16).float())
            p = p.to(torch.bfloat16).float()
            o = split_matmul(p, v, 1, nt) / p.sum(dim=-1, keepdim=True)
        else:
            # The online states over [lo, hi) of the walked keys: (m, l, o).
            def state(lo, hi):
                m = s[..., lo:hi].amax(dim=-1, keepdim=True)
                p = torch.exp2(s[..., lo:hi] - m)
                l = (p.to(dt).float() if sw["sum_rounded"] else p).sum(dim=-1, keepdim=True)
                return m, l, split_matmul(p, v[..., lo:hi, :], nt, nt)

            end = T if zerokv else min(T, -(-valid // 64) * 64)
            split0 = T // 128 * 128 if sw["tail_split"] else 0
            parts = [state(lo, hi) for lo, hi in ((0, split0), (split0, end)) if hi > lo]
            m = torch.stack([pm for pm, _, _ in parts]).amax(dim=0)
            l = sum(pl * torch.exp2(pm - m) for pm, pl, _ in parts)
            o = sum(po * torch.exp2(pm - m) for pm, _, po in parts)
            if zerokv:
                l = l - (T - valid) * torch.exp2(-m)
            o = o / l
    attn = _merge(o).to(dt).float()
    w_o = w_out.to(dt).float()
    if sw["interleaved"]:
        gw = sw["group"] * Dh
        acc = None
        for g in range(n_heads // sw["group"]):
            part = split_matmul(attn[..., g * gw:(g + 1) * gw], w_o[g * gw:(g + 1) * gw], nt, nt)
            acc = part if acc is None else acc + part
        return ((acc + b_out.float()) + x32).to(dt)
    return (x32 + (split_matmul(attn, w_o, nt, nt) + b_out.float())).to(dt)


def emulated_attn_variant_errors(B, T, W, n_heads, valid, dtype=torch.float32, f32_terms=F32_TERMS, seed=0, *,
                                 form="variant", **flags) -> dict:
    """One S3/S4 variant's emulated output against
    ``attn_block_variant_reference`` on the same inputs (x in ``dtype``):
    ``out_rel``, ``out_abs`` and ``tol_needed`` (what ``chip_smoke.py`` holds
    at ``AB_TOL``)."""
    from tapclip_tpu_torch.ops.fused_mha import attn_block_variant_reference

    x, *params = attn_block_inputs(B, T, W, seed)
    x = x.to(dtype)
    got = emulate_attn_variant(x, *params, n_heads, valid, form=form, f32_terms=f32_terms, **flags).float()
    want = attn_block_variant_reference(x, *params, n_heads, valid, form=form, **flags).float()
    d = (got - want).abs()
    return {"out_rel": _rel(got, want), "out_abs": float(d.max()),
            "tol_needed": float((d / (1.0 + want.abs())).max())}


def emulate_mlp_bwd(x, g, gamma, beta, w_fc, b_fc, w_proj, eps=1e-5, f32_terms=F32_TERMS):
    """B5's dx as the card computes it: LayerNorm in f32, y rounded; the fc
    recompute z = y . w_fc + b_fc, dh = g . w_proj^T and dy = dh_pre . w_fc^T
    on split operands (``f32_terms`` terms each in f32, one in bf16);
    dh_pre = dh (Phi(z) + z phi(z)) rounded to the dtype; dx = g + the
    LayerNorm backward of dy, rounded."""
    dt = x.dtype
    nt = f32_terms if dt == torch.float32 else 1
    W = x.shape[-1]
    n, rstd, y = _ln_parts(x.reshape(-1, W), gamma, beta, eps)
    z = split_matmul(y.float(), w_fc.to(dt).float(), nt, nt) + b_fc.float()
    dgelu = 0.5 * (1.0 + torch.erf(z * 2.0 ** -0.5)) + z * torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    gc = g.reshape(-1, W).float()
    dhc = (split_matmul(gc, w_proj.to(dt).float().T, nt, nt) * dgelu).to(dt).float()
    dy = split_matmul(dhc, w_fc.to(dt).float().T, nt, nt)
    return (gc + ln_backward(dy, n, rstd, gamma)[0]).to(dt).reshape(x.shape)


def emulated_mlp_bwd_errors(R, W, dtype=torch.float32, f32_terms=F32_TERMS, seed=0) -> dict:
    """B5's emulated dx against ``fused_mlp_bwd_reference``'s on the same
    inputs (x and the cotangent, both numpy normal draws, in ``dtype``):
    ``dx_rel`` (norm-relative) and ``dx_abs``."""
    x, gamma, beta, w_fc, b_fc, w_proj, _ = mlp_inputs(R, W, seed)
    g = mlp_inputs(R, W, seed + 1)[0]
    x, g = x.to(dtype), g.to(dtype)
    got = emulate_mlp_bwd(x, g, gamma, beta, w_fc, b_fc, w_proj, f32_terms=f32_terms)
    want = fused_mlp_bwd_reference(x, g, gamma, beta, w_fc, b_fc, w_proj)[0]
    return {"dx_rel": _rel(got, want), "dx_abs": float((got.float() - want.float()).abs().max())}


def emulate_attn_block_bwd(x, g, gamma, beta, w_qkv, b_qkv, w_out, n_heads, valid, eps=1e-5,
                           f32_terms=F32_TERMS):
    """B4 as the card computes it: LayerNorm in f32, y rounded; the QKV
    recompute (f32 out, v unrounded) and gh = g . w_out^T on split operands
    (``f32_terms`` terms each in f32, one in bf16); the core on f32 q, k, v,
    gh in ``f32_terms`` terms, except where the TPU kernel rounds to the
    dtype (p and v for o, p and gh for dv: one term, their bf16 rounding, in
    bf16): the row LSE of the masked log2-domain scores, p = exp2(s - lse),
    delta = sum(dp p), ds = p (dp - delta) scale; o and dqkv rounded; dy on
    split operands; dx = g + the LayerNorm backward.  The weight gradients
    are the plain products of the emulated y, o and dqkv.  Returns the
    seven gradients of ``attn_block_bwd_reference``."""
    dt = x.dtype
    nt = f32_terms if dt == torch.float32 else 1
    B, T, W = x.shape
    Dh = W // n_heads
    scale = Dh ** -0.5
    n, rstd, y = _ln_parts(x, gamma, beta, eps)
    y32 = y.float()
    wq = w_qkv.to(dt).float()
    qkv = split_matmul(y32, wq, nt, nt) + b_qkv.float()
    gc = g.float()
    gh = _heads(split_matmul(gc, w_out.to(dt).float().T, nt, nt), n_heads)
    q, k, v = (_heads(t, n_heads) for t in qkv.split(W, dim=-1))
    s = split_matmul(q, k.transpose(-1, -2), f32_terms, f32_terms) * (scale * _LOG2E)
    keys = torch.arange(T) < valid
    s = torch.where(keys, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    lse = m + torch.log2(torch.exp2(s - m).sum(dim=-1, keepdim=True))
    p = torch.where(keys, torch.exp2(s - lse), torch.zeros_like(s))
    o = split_matmul(p, v, nt, nt)
    dp = split_matmul(gh, v.transpose(-1, -2), f32_terms, f32_terms)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dv = split_matmul(p.transpose(-1, -2), gh, nt, nt)
    dq = split_matmul(ds, k, f32_terms, f32_terms)
    dk = split_matmul(ds.transpose(-1, -2), q, f32_terms, f32_terms)

    def merge(t):  # [B, H, T, Dh] -> [B T, W], rounded to the dtype
        return t.transpose(1, 2).reshape(B * T, W).to(dt).float()

    attn = merge(o)
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
    dy = split_matmul(dqkv, wq.T, nt, nt).reshape(B, T, W)
    dx_ln, dgn, dbn = ln_backward(dy, n, rstd, gamma)
    g2 = gc.reshape(B * T, W)
    return ((gc + dx_ln).to(dt), dgn.sum((0, 1)), dbn.sum((0, 1)), y32.reshape(B * T, W).T @ dqkv,
            dqkv.sum(0), attn.T @ g2, g2.sum(0))


def emulated_attn_block_bwd_errors(B, T, W, n_heads, valid, dtype=torch.float32, f32_terms=F32_TERMS,
                                   seed=0) -> dict:
    """B4's emulated gradients against ``attn_block_bwd_reference``'s on the
    same inputs (x and the cotangent in ``dtype``): the norm-relative error
    of each (``dx_rel``, ``dgamma_rel``, ..., ``db_out_rel``), and
    ``dx_abs``."""
    x, gamma, beta, w_qkv, b_qkv, w_out, _ = attn_block_inputs(B, T, W, seed)
    g = attn_block_inputs(B, T, W, seed + 1)[0]
    x, g = x.to(dtype), g.to(dtype)
    got = emulate_attn_block_bwd(x, g, gamma, beta, w_qkv, b_qkv, w_out, n_heads, valid, f32_terms=f32_terms)
    want = attn_block_bwd_reference(x, g, gamma, beta, w_qkv, b_qkv, w_out, n_heads, valid, 1e-5)
    names = ("dx", "dgamma", "dbeta", "dw_qkv", "db_qkv", "dw_out", "db_out")
    errs = {f"{n}_rel": _rel(a, b) for n, a, b in zip(names, got, want)}
    errs["dx_abs"] = float((got[0].float() - want[0].float()).abs().max())
    return errs


def _merge(t):  # [B, H, T, Dh] -> [B, T, W]
    B, H, T, Dh = t.shape
    return t.transpose(1, 2).reshape(B, T, H * Dh)


def emulate_mha_bwd(qkv, g, n_heads, valid, causal, f32_terms=F32_TERMS):
    """B7 as the card computes it (``csrc/mha_bwd.cu`` on B4's row and column
    kernels): q, k, v and g in ``f32_terms`` terms in f32 and one (exact) in
    bf16; the row LSE of the masked log2-domain scores (keys at or past
    ``valid``, and past the query when ``causal``, at -1e30), p = exp2(s -
    lse); dv = p^T g with p in ``f32_terms`` terms in f32 and its bf16
    rounding in bf16; dp = g v^T; delta = sum(dp p), ds = p (dp - delta)
    scale in f32; dq = ds k and dk = ds^T q with ds in ``f32_terms`` terms.
    Packed ``dqkv [B, T, 3W]`` in qkv's dtype."""
    dt = qkv.dtype
    nt = f32_terms if dt == torch.float32 else 1
    T, W = qkv.shape[1], qkv.shape[2] // 3
    scale = (W // n_heads) ** -0.5
    q, k, v = (_heads(t.float(), n_heads) for t in qkv.split(W, dim=-1))
    gh = _heads(g.float(), n_heads)
    keys = torch.arange(T)
    mask = (keys < valid)[None, :].expand(T, T)
    if causal:
        mask = mask & (keys[None, :] <= keys[:, None])
    s = split_matmul(q, k.transpose(-1, -2), nt, nt) * (scale * _LOG2E)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    lse = m + torch.log2(torch.exp2(s - m).sum(dim=-1, keepdim=True))
    p = torch.where(mask, torch.exp2(s - lse), torch.zeros_like(s))
    dv = split_matmul(p.transpose(-1, -2), gh, nt, nt)
    dp = split_matmul(gh, v.transpose(-1, -2), nt, nt)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dq = split_matmul(ds, k, f32_terms, nt)
    dk = split_matmul(ds.transpose(-1, -2), q, f32_terms, nt)
    return torch.cat([_merge(t) for t in (dq, dk, dv)], dim=-1).to(dt)


def emulated_mha_bwd_errors(B, T, W, n_heads, valid, causal, dtype=torch.float32, f32_terms=F32_TERMS,
                            seed=0) -> dict:
    """B7's emulated dqkv against ``fused_mha_bwd_reference``'s on the same
    inputs (qkv at half scale and the cotangent in ``dtype``): ``dqkv_rel``
    (norm-relative) and ``dqkv_abs``."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * W), dtype=np.float32) * np.float32(0.5)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((B, T, W), dtype=np.float32)).to(dtype)
    got = emulate_mha_bwd(qkv, g, n_heads, valid, causal, f32_terms)
    want = fused_mha_bwd_reference(qkv, g, n_heads, valid, causal)
    return {"dqkv_rel": _rel(got, want), "dqkv_abs": float((got.float() - want.float()).abs().max())}


def emulate_mha(qkv, n_heads, valid, causal, f32_terms=F32_TERMS):
    """B6 as the card computes it (``csrc/mha.cu``: K2's attention walk with
    qkv in the dtype): :func:`_emulate`'s forward on the split heads, q . k^T
    on ``f32_terms`` terms of q and k in f32 and one (exact) in bf16, keys at
    or past ``valid`` (and after the query when ``causal``) at -1e30, exp2
    against the row max, the sum over the unrounded p, p . v on
    ``f32_terms`` terms of p and v in f32 and one in bf16 (p's rounding, v's
    value), over the sum.  ``[B, T, W]`` in qkv's dtype."""
    B, W = qkv.shape[0], qkv.shape[2] // 3
    q, k, v = (_heads(t, n_heads) for t in qkv.split(W, dim=-1))
    valid_t = torch.full((B,), int(valid), dtype=torch.int32)
    out = _emulate(q, k, v, torch.zeros_like(q), valid_t, causal, f32_terms)[0]
    return _merge(out).to(qkv.dtype)


def emulated_mha_errors(B, T, W, n_heads, valid, causal, dtype=torch.float32, f32_terms=F32_TERMS,
                        seed=0) -> dict:
    """B6's emulated output against ``fused_mha_reference``'s on the same
    inputs (qkv at half scale in ``dtype``): ``out_rel`` (norm-relative) and
    ``out_abs``."""
    from tapclip_tpu_torch.ops.fused_mha import fused_mha_reference

    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * W), dtype=np.float32) * np.float32(0.5)).to(dtype)
    got = emulate_mha(qkv, n_heads, valid, causal, f32_terms)
    want = fused_mha_reference(qkv, n_heads, valid, causal)
    return {"out_rel": _rel(got, want), "out_abs": float((got.float() - want.float()).abs().max())}


def emulate_int8_attn_core(qkv, n_heads, valid, p_dtype, f32_terms=F32_TERMS):
    """B14's attention step (``csrc/attn_core_mma.cuh``) over the f32
    workspace ``qkv [B, T, 3W]``: q . k^T on ``f32_terms`` terms of q and k,
    times Dh^-1/2 log2 e, keys at or past ``valid`` at -1e30, exp2 against
    the row max, the sum over the unrounded p; p . v on ``f32_terms`` terms
    of p and v, or one where ``p_dtype`` is bfloat16 (p rounded, v a bf16
    value), over the sum.  f32 ``[B, T, W]``."""
    T, W = qkv.shape[1], qkv.shape[2] // 3
    q, k, v = (_heads(t, n_heads) for t in qkv.float().split(W, dim=-1))
    nt = 1 if p_dtype == torch.bfloat16 else f32_terms
    s = split_matmul(q, k.transpose(-1, -2), f32_terms, f32_terms) * ((W // n_heads) ** -0.5 * _LOG2E)
    s = torch.where(torch.arange(T) < valid, s, torch.full_like(s, -1e30))
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    return _merge(split_matmul(e, v, nt, nt) / e.sum(dim=-1, keepdim=True))


def int8_head_tiled_codes(a, n_heads, seed, deterministic):
    """The codes and scales of the attention output ``a [R, W]`` as B14's
    last steps form them: each row's largest |a| taken per head's column tile
    on the f32 bits and the largest over the tiles (the kernel's atomicMax),
    then the quantizer of stream 3 (``STREAM_ATTN_A``) from it."""
    from tapclip_tpu_torch.ops import int8_mlp

    R, W = a.shape
    tiles = a.abs().view(torch.int32).view(R, n_heads, W // n_heads)
    amax = tiles.amax(-1).amax(-1, keepdim=True).view(torch.float32)
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
    if deterministic:
        return torch.clamp(torch.round(a / scale), -127, 127), scale
    u = int8_mlp.uniform_from_bits(int8_mlp.rand_bits(seed, int8_mlp.STREAM_ATTN_A, R, W))
    return torch.clamp(torch.floor(a / scale + u), -127, 127), scale


def emulate_int8_attn(x, gamma, beta, q, n_heads, valid, *, seed=0, deterministic=False, f32_terms=F32_TERMS):
    """B14 as the card computes it: the QKV workspace as the plain version
    forms it (exact int32 sums; the card's equals it bit for bit), the
    attention step of :func:`emulate_int8_attn_core` (p rounded to bf16 only
    in the stochastic mode in bf16), the codes from the head-tiled row max
    (:func:`int8_head_tiled_codes`), the out product, b_out and the
    residual with one rounding.  x's dtype and shape."""
    from tapclip_tpu_torch.ops.int8_attn import int8_attn_plain_parts
    from tapclip_tpu_torch.ops.int8_mlp import int_dot

    B, T, W = x.shape
    qkv = int8_attn_plain_parts(x, gamma, beta, q, n_heads, valid, seed=seed, deterministic=deterministic)["qkv"]
    p_dtype = x.dtype if not deterministic else torch.float32
    a = emulate_int8_attn_core(qkv.reshape(B, T, 3 * W), n_heads, valid, p_dtype, f32_terms).reshape(B * T, W)
    aq, t2 = int8_head_tiled_codes(a, n_heads, seed, deterministic)
    out = int_dot(aq, q["w_out"]) * t2 * q["s_out"] + q["b_out"]
    return (out + x.reshape(B * T, W).float()).to(x.dtype).reshape(B, T, W)


def emulate_fused_layer(x, ln1, attn, ln2, mlp, n_heads, valid, eps=1e-5, f32_terms=F32_TERMS):
    """S1 as the card computes it (``csrc/fused_layer.cu``, one launch on K1's
    and K2's tiles): LN1 rounded to x's dtype; the QKV product on split
    operands (``f32_terms`` terms each in f32, one in bf16), v rounded; q . k^T
    on ``f32_terms`` terms of q and k in both dtypes, keys at or past
    ``valid`` at -1e30, exp2 against the row max, the sum over the unrounded
    p; p . v on ``f32_terms`` terms of p and v in f32 and one in bf16, over
    the sum, left f32; the out-projection on ``f32_terms`` terms of the f32
    attention output against ``f32_terms`` of w_out in f32 and one (its bf16
    value, exact) in bf16, mid = x + (. + b_out) in f32; LN2 of mid rounded;
    fc and proj on split operands, GELU rounded, out = mid + (. + b_proj),
    one rounding."""
    dt = x.dtype
    nt = f32_terms if dt == torch.float32 else 1
    B, T, W = x.shape
    Dh = W // n_heads
    x32 = x.float()
    y = _ln_parts(x, ln1["scale"], ln1["bias"], eps)[2].float()
    qkv = split_matmul(y, attn["w_qkv"].to(dt).float(), nt, nt) + attn["b_qkv"].float()
    q, k, v = (_heads(t, n_heads) for t in qkv.split(W, dim=-1))
    v = v.to(dt).float()
    s = split_matmul(q, k.transpose(-1, -2), f32_terms, f32_terms) * (Dh ** -0.5 * _LOG2E)
    s = torch.where(torch.arange(T) < valid, s, torch.full_like(s, -1e30))
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = _merge(split_matmul(e, v, nt, nt) / e.sum(dim=-1, keepdim=True))
    mid = x32 + (split_matmul(o, attn["w_out"].to(dt).float(), f32_terms, nt) + attn["b_out"].float())
    y2 = _ln_parts(mid, ln2["scale"], ln2["bias"], eps)[2].to(dt).float()
    z = split_matmul(y2, mlp["w_fc"].to(dt).float(), nt, nt) + mlp["b_fc"].float()
    h = (0.5 * z * (1.0 + torch.erf(z * 2.0 ** -0.5))).to(dt).float()
    return (mid + (split_matmul(h, mlp["w_proj"].to(dt).float(), nt, nt) + mlp["b_proj"].float())).to(dt)


def fused_layer_inputs(B, T, W, seed=0):
    """x [B, T, W] and one layer's parameters (ln1, attn, ln2, mlp; H = 4 W),
    f32 numpy normal draws from ``seed`` at the card tests' scales."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))

    def ln():
        return {"scale": 1.0 + f(W, scale=0.1), "bias": f(W, scale=0.1)}

    H = 4 * W
    x = f(B, T, W)
    attn = {"w_qkv": f(W, 3 * W, scale=W ** -0.5), "b_qkv": f(3 * W, scale=0.1),
            "w_out": f(W, W, scale=W ** -0.5), "b_out": f(W, scale=0.1)}
    mlp = {"w_fc": f(W, H, scale=W ** -0.5), "b_fc": f(H, scale=0.1),
           "w_proj": f(H, W, scale=H ** -0.5), "b_proj": f(W, scale=0.1)}
    return x, ln(), attn, ln(), mlp


def emulated_fused_layer_errors(B, T, W, n_heads, valid, dtype=torch.float32, f32_terms=F32_TERMS,
                                seed=0) -> dict:
    """S1's emulated output against ``fused_layer_reference`` on the same
    inputs (x in ``dtype``): ``out_rel`` (norm-relative), ``out_abs`` and
    ``tol_needed``, the least atol = rtol ``torch.allclose`` would pass (max
    |d| / (1 + |want|), what ``chip_smoke.py`` holds at ``AB_TOL``)."""
    from tapclip_tpu_torch.ops.fused_layer import fused_layer_reference

    x, ln1, attn, ln2, mlp = fused_layer_inputs(B, T, W, seed)
    x = x.to(dtype)
    got = emulate_fused_layer(x, ln1, attn, ln2, mlp, n_heads, valid, f32_terms=f32_terms).float()
    want = fused_layer_reference(x, ln1, attn, ln2, mlp, n_heads, valid).float()
    d = (got - want).abs()
    return {"out_rel": _rel(got, want), "out_abs": float(d.max()),
            "tol_needed": float((d / (1.0 + want.abs())).max())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--terms", type=int, default=F32_TERMS, help="bf16 terms of an f32 operand")
    args = ap.parse_args()
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, T, Dh, valid in FLASH_SHAPES:
            for causal in (False, True):
                errs = emulated_errors(B, H, T, Dh, valid, causal, dtype, args.terms)
                print(json.dumps({"dtype": str(dtype).replace("torch.", ""), "terms": args.terms,
                                  "shape": [B, H, T, Dh], "valid": valid, "causal": causal, **errs}))
        for R, W in MLP_SHAPES:
            errs = emulated_mlp_errors(R, W, dtype, args.terms)
            print(json.dumps({"dtype": str(dtype).replace("torch.", ""), "terms": args.terms, "kernel": "K1",
                              "rows": R, "W": W, "H": 4 * W, **errs}))
        for B, T, W, heads, valid in ATTN_SHAPES:
            errs = emulated_attn_block_errors(B, T, W, heads, valid, dtype, args.terms)
            print(json.dumps({"dtype": str(dtype).replace("torch.", ""), "terms": args.terms, "kernel": "K2",
                              "shape": [B, T, W], "heads": heads, "valid": valid, **errs}))
        for R, W in MLP_BWD_SHAPES:
            errs = emulated_mlp_bwd_errors(R, W, dtype, args.terms)
            print(json.dumps({"dtype": str(dtype).replace("torch.", ""), "terms": args.terms, "kernel": "B5",
                              "rows": R, "W": W, "H": 4 * W, **errs}))
        for B, T, W, heads, valid in ATTN_BWD_SHAPES:
            errs = emulated_attn_block_bwd_errors(B, T, W, heads, valid, dtype, args.terms)
            print(json.dumps({"dtype": str(dtype).replace("torch.", ""), "terms": args.terms, "kernel": "B4",
                              "shape": [B, T, W], "heads": heads, "valid": valid, **errs}))
        for B, T, W, heads, valid, causal in MHA_BWD_SHAPES:
            errs = emulated_mha_bwd_errors(B, T, W, heads, valid, causal, dtype, args.terms)
            print(json.dumps({"dtype": str(dtype).replace("torch.", ""), "terms": args.terms, "kernel": "B7",
                              "shape": [B, T, W], "heads": heads, "valid": valid, "causal": causal, **errs}))
            errs = emulated_mha_errors(B, T, W, heads, valid, causal, dtype, args.terms)
            print(json.dumps({"dtype": str(dtype).replace("torch.", ""), "terms": args.terms, "kernel": "B6",
                              "shape": [B, T, W], "heads": heads, "valid": valid, "causal": causal, **errs}))
        for rows, M, N, split in DW_SHAPES:
            errs = emulated_dw_errors(rows, M, N, dtype, split, args.terms)
            print(json.dumps({"dtype": str(dtype).replace("torch.", ""), "terms": args.terms, "kernel": "gemm.cu dW",
                              "rows": rows, "M": M, "N": N, "split": split, **errs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
