"""int8 W8A8 attention half-block for the frozen-tower eval path (B14).

Counterpart of ``tapclip_tpu/ops/int8_attn.py``: ``x + out_proj(attn(qkv(layer_norm(x))))``
with the qkv and output projections quantized as in :mod:`.int8_mlp` (int8
weights per output column, int8 activations per row, exact int32 sums) and
the attention core in f32, keys at or past ``valid_len`` masked, never
causal.  Eval only.

The two modes compute what the JAX package computes in each:

* **stochastic**: the Pallas kernel ``_int8_attn_kernel``'s function with
  the port's draws (:func:`.int8_mlp.rand_bits`): LayerNorm's output f32; q
  and k f32, v rounded to the compute dtype; p rounded to v's dtype before
  p.v, the sum of p unrounded, the output normalised after (exp2 softmax, as
  the kernel); the attention output f32 before its quantizer.
* **deterministic**: ``_xla_int8_attn_reference``'s function: LayerNorm's
  output rounded to the compute dtype before it is quantized, the attention
  core in f32 throughout (``attention_reference``).

:func:`int8_attn_block` makes the five launches of ``csrc/int8_attn.cu``
(the hand-written B14, on the tensor cores: LayerNorm and codes, the QKV
product on the int8 MMAs, the attention on the bf16 MMAs with each row's
|a| max, the attention output's codes, the out product) on a CUDA tensor in
either mode, on weights laid out K-major (:func:`.int8_mlp.k_major`), and
runs the plain version (:func:`int8_attn_plain`) on a CPU tensor, through
the op ``tapclip::int8_attn`` (``ops/_library.py``) after the weights are
quantized in torch.  The TPU kernel's
head-pair packing and its VMEM picker (``int8_attn.py:226-229``) are TPU
layout choices and are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from tapclip_tpu_torch.ops import _build
from tapclip_tpu_torch.ops.attention import attention_reference
from tapclip_tpu_torch.ops.fused_mha import _LOG2E, _check_heads, _merge_heads, _split_heads
from tapclip_tpu_torch.ops.int8_mlp import (
    STREAM_ATTN_A,
    STREAM_ATTN_Y,
    _f32_operand,
    int_dot,
    k_major,
    ln_f32,
    quantize_activations,
    quantize_cols_int8,
)


# The quantized weights in ``tapclip::int8_attn``'s argument order.
Q_ATTN = ("w_qkv", "s_qkv", "b_qkv", "w_out", "s_out", "b_out")


def quantize_attn(attn) -> Dict[str, torch.Tensor]:
    """The projections' weights as the kernels take them."""
    w_qkv, s_qkv = quantize_cols_int8(attn["w_qkv"])
    w_out, s_out = quantize_cols_int8(attn["w_out"])
    return {"w_qkv": w_qkv, "s_qkv": s_qkv, "b_qkv": attn["b_qkv"].float(),
            "w_out": w_out, "s_out": s_out, "b_out": attn["b_out"].float()}


def attn_core_exp2(qkv: torch.Tensor, n_heads: int, valid: int, p_dtype) -> torch.Tensor:
    """The TPU kernel's attention core over f32 ``qkv [B, T, 3W]``: scores in
    the log2 domain, keys at or past ``valid`` at -1e30, p rounded to
    ``p_dtype`` before p.v, normalised by the unrounded sum after.  f32 out."""
    T, W = qkv.shape[1], qkv.shape[2] // 3
    q, k, v = (_split_heads(t, n_heads) for t in qkv.split(W, dim=-1))
    s = (q @ k.transpose(-1, -2)) * ((W // n_heads) ** -0.5 * _LOG2E)
    keys = torch.arange(T, device=qkv.device) < valid
    s = torch.where(keys, s, torch.full_like(s, -1e30))
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = (p.to(p_dtype).float() @ v) / p.sum(dim=-1, keepdim=True)
    return _merge_heads(o)


def int8_attn_plain_parts(x, gamma, beta, q, n_heads: int, valid: int, *, eps=1e-5, seed=0,
                          deterministic=False) -> Dict[str, torch.Tensor]:
    """:func:`int8_attn_plain` with its intermediates: the codes and scale of
    LayerNorm's output (``yq``, ``t1``), the f32 workspace ``qkv [B T, 3W]``
    (v rounded to the dtype in the stochastic mode), the attention output
    ``a [B T, W]`` f32 and its codes and scale (``aq``, ``t2``), and ``out``
    in x's dtype and shape."""
    B, T, W = x.shape
    x2 = x.reshape(B * T, W)
    y = ln_f32(x2, gamma, beta, eps)
    yq, t1 = quantize_activations(y, x.dtype, seed, STREAM_ATTN_Y, deterministic, round_input=True)
    qkv = int_dot(yq, q["w_qkv"]) * t1 * q["s_qkv"] + q["b_qkv"]
    if deterministic:
        heads = [_split_heads(t, n_heads) for t in qkv.reshape(B, T, 3 * W).split(W, dim=-1)]
        a = _merge_heads(attention_reference(*heads, kv_valid_len=None if valid == T else valid)[0])
    else:
        qkv = torch.cat([qkv[:, :2 * W], qkv[:, 2 * W:].to(x.dtype).float()], dim=-1)
        a = attn_core_exp2(qkv.reshape(B, T, 3 * W), n_heads, valid, x.dtype)
    a = a.reshape(B * T, W)
    aq, t2 = quantize_activations(a, x.dtype, seed, STREAM_ATTN_A, deterministic)
    out = int_dot(aq, q["w_out"]) * t2 * q["s_out"] + q["b_out"]
    return {"yq": yq, "t1": t1, "qkv": qkv, "a": a, "aq": aq, "t2": t2,
            "out": (out + x2.float()).to(x.dtype).reshape(B, T, W)}


def int8_attn_plain(x, gamma, beta, q, n_heads: int, valid: int, *, eps=1e-5, seed=0,
                    deterministic=False):
    """Plain version of B14 on the quantized weights ``q`` (:func:`quantize_attn`)."""
    return int8_attn_plain_parts(x, gamma, beta, q, n_heads, valid, eps=eps, seed=seed,
                                 deterministic=deterministic)["out"]


def int8_attn_reference(x, ln_params, attn_params, n_heads: int, valid: int, eps: float = 1e-5):
    """The round-to-nearest model, as ``_xla_int8_attn_reference``."""
    return int8_attn_plain(x, ln_params["scale"], ln_params["bias"], quantize_attn(attn_params),
                           n_heads, valid, eps=eps, deterministic=True)


def int8_attn_sr_reference(x, ln_params, attn_params, n_heads: int, valid: int,
                           eps: float = 1e-5, seed: int = 0):
    """What the TPU kernel computes, fed the port's draws of ``seed``."""
    return int8_attn_plain(x, ln_params["scale"], ln_params["bias"], quantize_attn(attn_params),
                           n_heads, valid, eps=eps, seed=seed)


def int8_attn_block(x: torch.Tensor, ln_params, attn_params, n_heads: int, *,
                    valid_len: Optional[int] = None, eps: float = 1e-5, seed: int = 0,
                    deterministic: bool = False) -> torch.Tensor:
    """The int8 attention half-block over ``x [B, T, W]``: B14 on CUDA (either
    mode), plain on CPU.  Eval only."""
    _build.refuse_graph("int8_attn_block", x, *ln_params.values(), *attn_params.values())
    valid = valid_len if valid_len is not None else x.shape[1]
    q = quantize_attn(attn_params)
    return torch.ops.tapclip.int8_attn.default(x, ln_params["scale"], ln_params["bias"], *(q[k] for k in Q_ATTN),
                                               n_heads, valid, eps, seed, deterministic)


int8_attn_block.launches = 0


def int8_attn_op(impl):
    """``tapclip::int8_attn``'s implementation from a function of the weights'
    dict ``q`` (:func:`int8_attn_plain` or :func:`int8_attn_cuda`)."""
    def op(x, gamma, beta, w_qkv, s_qkv, b_qkv, w_out, s_out, b_out, n_heads, valid, eps, seed, deterministic):
        q = dict(zip(Q_ATTN, (w_qkv, s_qkv, b_qkv, w_out, s_out, b_out)))
        return impl(x, gamma, beta, q, n_heads, valid, eps=eps, seed=seed, deterministic=deterministic)
    return op


def int8_attn_cuda(x, gamma, beta, q, n_heads: int, valid: int, *, eps=1e-5, seed=0,
                   deterministic=False):
    """B14 on the card (five launches on the tensor cores) on the quantized
    weights ``q``."""
    B, T, W = x.shape
    R = B * T
    _check_heads(T, W, n_heads, valid)
    _build.check_cuda_operand("x", x, x.dtype, (B, T, W))
    for name, shape in (("w_qkv", (W, 3 * W)), ("w_out", (W, W))):
        _build.check_cuda_operand(name, q[name], torch.int8, shape)
    f = {name: _f32_operand(name, t, (n,)) for name, t, n in (
        ("gamma", gamma, W), ("beta", beta, W), ("s_qkv", q["s_qkv"], 3 * W),
        ("b_qkv", q["b_qkv"], 3 * W), ("s_out", q["s_out"], W), ("b_out", q["b_out"], W))}
    lib = _build.library()
    Wp = lib.tapclip_int8_gemm_kp(W)
    w_qkv, w_out = k_major(q["w_qkv"], Wp), k_major(q["w_out"], Wp)
    dev = x.device
    out = torch.empty_like(x)
    qkv = torch.empty((R, 3 * W), dtype=torch.float32, device=dev)  # q | k | v, v rounded in the stochastic mode
    a = torch.empty((R, W), dtype=torch.float32, device=dev)  # the attention output
    codes = torch.empty((R, Wp), dtype=torch.int8, device=dev)  # of LN(x), then of a
    scales = torch.empty((3, R), dtype=torch.float32, device=dev)  # t1, t2, max |a| of each row
    err = lib.tapclip_int8_attn(
        x.data_ptr(), f["gamma"].data_ptr(), f["beta"].data_ptr(), w_qkv.data_ptr(), f["s_qkv"].data_ptr(),
        f["b_qkv"].data_ptr(), w_out.data_ptr(), f["s_out"].data_ptr(), f["b_out"].data_ptr(), out.data_ptr(),
        qkv.data_ptr(), a.data_ptr(), codes.data_ptr(), scales.data_ptr(), B, T, W, n_heads, int(valid),
        float(eps), int(seed) & 0xFFFFFFFF, int(deterministic), _build.dtype_code(x.dtype), _build.stream_handle(dev),
    )
    _build.check(err, "tapclip_int8_attn")
    int8_attn_block.launches += 1
    return out
