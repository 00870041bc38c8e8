"""The port's three kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of ``tapclip_tpu_torch.ops`` runs its plain PyTorch
version; the JAX side runs the Pallas kernel in interpret mode, as the JAX
package's own tests do.  Geometry: W=128, 2 heads of 64, MLP hidden 512,
B=2, T=16 with 13 valid keys (it passes the JAX kernels' alignment guards).
f32 tolerance 1e-5: the difference is the JAX kernel's erf polynomial
(<= 1.5e-7) plus summation order.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/port/test_torch_gpu.py``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapclip_tpu.ops.flash_attention import fused_attention as jax_fused_attention
from tapclip_tpu.ops.fused_mha import _attn_block_bwd_impl
from tapclip_tpu.ops.fused_mha import fused_attn_block as jax_fused_attn_block
from tapclip_tpu.ops.fused_mlp import _fused_mlp_bwd_impl, _fused_mlp_vjp, _xla_composition

from tapclip_tpu_torch.ops import _build
from tapclip_tpu_torch.ops.attention import attention_reference, multi_head_attention
from tapclip_tpu_torch.ops.flash_attention import fused_attention
from tapclip_tpu_torch.ops.fused_mha import fused_attn_block
from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block, fused_mlp_reference
from tapclip_tpu_torch.scripts.split_error import (
    ATTN_BWD_SHAPES,
    ATTN_SHAPES,
    MLP_BWD_SHAPES,
    MLP_SHAPES,
    emulate_attn_block,
    emulate_attn_block_bwd,
    emulate_mlp,
    emulate_mlp_bwd,
    emulated_attn_block_bwd_errors,
    emulated_attn_block_errors,
    emulated_mlp_bwd_errors,
    emulated_mlp_errors,
)

TOL = dict(rtol=1e-5, atol=1e-5)
B, T, W, HEADS, HID, VALID = 2, 16, 128, 2, 512, 13


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return {
        "x": f(B, T, W),
        "ln": {"scale": 1.0 + f(W, scale=0.1), "bias": f(W, scale=0.1)},
        "mlp": {"w_fc": f(W, HID, scale=0.05), "b_fc": f(HID, scale=0.1),
                "w_proj": f(HID, W, scale=0.05), "b_proj": f(W, scale=0.1)},
        "attn": {"w_qkv": f(W, 3 * W, scale=W ** -0.5), "b_qkv": f(3 * W, scale=0.1),
                 "w_out": f(W, W, scale=W ** -0.5), "b_out": f(W, scale=0.1)},
    }


def _torch_tree(d):
    return {k: _torch_tree(v) if isinstance(v, dict) else _t(v) for k, v in d.items()}


def _jax_tree(d):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in d.items()}


# --- K1: fused MLP ----------------------------------------------------------


def test_fused_mlp_matches_pallas_interpret(weights):
    j = _jax_tree(weights)
    m = j["mlp"]
    want = _fused_mlp_vjp(j["x"], j["ln"]["scale"], j["ln"]["bias"], m["w_fc"], m["b_fc"],
                          m["w_proj"], m["b_proj"], 1e-5, 8, True)
    t = _torch_tree(weights)
    got = fused_mlp_block(t["x"], t["ln"], t["mlp"], eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# K1 on the card runs both products on bf16 tensor-core MMAs, each f32
# operand split into three bf16 terms (csrc/fused_mlp.cu).  Its emulation
# (scripts/split_error.py) against the plain version, norm-relative, at the
# card's limits F32_TOL / BF16_TOL; readings: at most 3.3e-7 in f32 (two
# terms would read 4.4e-6), 4.8e-3 in bf16.
K1_SPLIT_LIMITS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("R,W", MLP_SHAPES, ids=[f"r{r}-w{w}" for r, w in MLP_SHAPES])
def test_fused_mlp_split_products_meet_the_card_limits(R, W, dtype):
    errs = emulated_mlp_errors(R, W, dtype)
    assert errs["out_rel"] <= K1_SPLIT_LIMITS[dtype], errs


def test_fused_mlp_split_products_match_pallas_interpret(weights):
    """The same emulation against the JAX kernel in interpret mode (as the
    plain version is held above)."""
    j = _jax_tree(weights)
    m = j["mlp"]
    want = _fused_mlp_vjp(j["x"], j["ln"]["scale"], j["ln"]["bias"], m["w_fc"], m["b_fc"],
                          m["w_proj"], m["b_proj"], 1e-5, 8, True)
    t = _torch_tree(weights)
    got = emulate_mlp(t["x"], t["ln"]["scale"], t["ln"]["bias"], *t["mlp"].values())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rows", [(1, 5), (3, 7)])
def test_fused_mlp_plain_any_rows_matches_xla(weights, rows):
    """The port takes any row count (the CUDA kernel masks the ragged tile);
    its plain version equals the JAX package's XLA composition there."""
    b, tt = rows
    x = weights["x"][:b, :tt]
    m = weights["mlp"]
    args = (x, weights["ln"]["scale"], weights["ln"]["bias"], m["w_fc"], m["b_fc"], m["w_proj"], m["b_proj"])
    want = _xla_composition(*(jnp.asarray(a) for a in args), 1e-5)
    got = fused_mlp_reference(*(_t(a) for a in args), eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_mlp_plain_bf16_close_to_xla(weights):
    m = weights["mlp"]
    args = (weights["x"], weights["ln"]["scale"], weights["ln"]["bias"], m["w_fc"], m["b_fc"],
            m["w_proj"], m["b_proj"])
    jargs = [jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    want = np.asarray(_xla_composition(*jargs, 1e-5).astype(jnp.float32))
    targs = [_t(a) for a in args]
    targs[0] = targs[0].to(torch.bfloat16)
    got = fused_mlp_reference(*targs, eps=1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


# --- K2: fused attention block ----------------------------------------------


@pytest.mark.parametrize("valid", [VALID, T])
def test_fused_attn_block_matches_pallas_interpret(weights, valid):
    j = _jax_tree(weights)
    want = jax_fused_attn_block(j["x"], j["ln"], j["attn"], HEADS, valid_len=valid, interpret=True)
    t = _torch_tree(weights)
    got = fused_attn_block(t["x"], t["ln"], t["attn"], HEADS, valid_len=valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# K2 on the card runs its QKV product, q . k^T, p . v and its out-projection
# on bf16 tensor-core MMAs (csrc/attn_block.cu): f32 operands split into
# three bf16 terms, q and k split in both dtypes, p and v one term in bf16.
# Its emulation (scripts/split_error.py) against the plain version,
# norm-relative, at the card's forward limits F32_TOL / BF16_TOL; readings:
# at most 2.2e-7 in f32, 2.5e-3 in bf16 (where the plain version rounds q
# and k to bf16 and the kernel, as the TPU kernel, does not).
K2_SPLIT_LIMITS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,W,heads,valid", ATTN_SHAPES, ids=[f"t{s[1]}-w{s[2]}-h{s[3]}" for s in ATTN_SHAPES])
def test_fused_attn_block_split_products_meet_the_card_limits(B, T, W, heads, valid, dtype):
    errs = emulated_attn_block_errors(B, T, W, heads, valid, dtype)
    assert errs["out_rel"] <= K2_SPLIT_LIMITS[dtype], errs


@pytest.mark.parametrize("valid", [VALID, T])
def test_fused_attn_block_split_products_match_pallas_interpret(weights, valid):
    """The same emulation against the JAX kernel in interpret mode (as the
    plain version is held above)."""
    j = _jax_tree(weights)
    want = jax_fused_attn_block(j["x"], j["ln"], j["attn"], HEADS, valid_len=valid, interpret=True)
    t = _torch_tree(weights)
    got = emulate_attn_block(t["x"], t["ln"]["scale"], t["ln"]["bias"], *t["attn"].values(), HEADS, valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# B5 on the card runs dx's three products (the fc recompute, dh, dy) the same
# way (csrc/mlp_bwd.cu).  Its emulated dx against the plain backward,
# norm-relative, at the card's backward limits (chip_smoke.py's BWD_F32_TOL /
# BWD_BF16_TOL); readings: at most 3.5e-7 in f32; 0 in bf16, where the
# operands are exact and only the order of the sums differs on the card.
B5_SPLIT_LIMITS = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("R,W", MLP_BWD_SHAPES, ids=[f"r{r}-w{w}" for r, w in MLP_BWD_SHAPES])
def test_fused_mlp_bwd_split_products_meet_the_card_limits(R, W, dtype):
    errs = emulated_mlp_bwd_errors(R, W, dtype)
    assert errs["dx_rel"] <= B5_SPLIT_LIMITS[dtype], errs


def test_fused_mlp_bwd_split_products_match_pallas_interpret(weights):
    """B5's emulated dx against the JAX backward kernel in interpret mode
    (row tile 8 over the 32 rows: four grid steps)."""
    m = weights["mlp"]
    g = np.random.default_rng(1).standard_normal(weights["x"].shape).astype(np.float32)
    args = (weights["ln"]["scale"], weights["ln"]["bias"], m["w_fc"], m["b_fc"], m["w_proj"], m["b_proj"])
    want = _fused_mlp_bwd_impl(jnp.asarray(weights["x"]), *map(jnp.asarray, args), jnp.asarray(g), 1e-5, 8, True)[0]
    got = emulate_mlp_bwd(_t(weights["x"]), _t(g), *(_t(a) for a in args[:5]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# B4 on the card runs dx's three products (the QKV recompute, gh, dy) and its
# attention core on the tensor cores (csrc/attn_block_bwd.cu): f32 operands
# in three bf16 terms; q, k, v, gh f32 values in both dtypes, except the
# operands the TPU kernel rounds (p and v for o, p and gh for dv), one term
# in bf16.  Its emulated gradients (scripts/split_error.py) against the plain
# backward, norm-relative, each of the seven, at the card's backward limits
# (chip_smoke.py's BWD_F32_TOL / BWD_BF16_TOL); readings: at most 9.7e-7 in
# f32, 1.7e-4 in bf16.
B4_SPLIT_LIMITS = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,W,heads,valid", ATTN_BWD_SHAPES,
                         ids=[f"t{s[1]}-w{s[2]}-h{s[3]}-v{s[4]}" for s in ATTN_BWD_SHAPES])
def test_fused_attn_block_bwd_split_products_meet_the_card_limits(B, T, W, heads, valid, dtype):
    errs = emulated_attn_block_bwd_errors(B, T, W, heads, valid, dtype)
    worst = max(v for k, v in errs.items() if k.endswith("_rel"))
    assert worst <= B4_SPLIT_LIMITS[dtype], errs


@pytest.mark.parametrize("valid", [VALID, T])
def test_fused_attn_block_bwd_split_products_match_pallas_interpret(weights, valid):
    """B4's emulated gradients against the JAX backward kernel in interpret
    mode (block_b 1 over B = 2: two grid steps accumulate the weight grads)."""
    a = weights["attn"]
    g = np.random.default_rng(2).standard_normal(weights["x"].shape).astype(np.float32)
    args = (weights["ln"]["scale"], weights["ln"]["bias"], a["w_qkv"], a["b_qkv"], a["w_out"])
    want = _attn_block_bwd_impl(jnp.asarray(weights["x"]), *map(jnp.asarray, args), jnp.asarray(g),
                                n_heads=HEADS, valid=valid, eps=1e-5, block_b=1, interpret=True,
                                stage_batched=False)
    got = emulate_attn_block_bwd(_t(weights["x"]), _t(g), *(_t(v) for v in args), HEADS, valid)
    for name, a_, b_ in zip(("dx", "dgamma", "dbeta", "dw_qkv", "db_qkv", "dw_out", "db_out"), got, want):
        np.testing.assert_allclose(a_.numpy().reshape(-1), np.asarray(b_).reshape(-1), err_msg=name, **TOL)


def test_fused_attn_block_padded_rows_finite(weights):
    t = _torch_tree(weights)
    got = fused_attn_block(t["x"], t["ln"], t["attn"], HEADS, valid_len=VALID)
    assert torch.isfinite(got[:, VALID:]).all()


# --- K3: attention with the attribution column ------------------------------


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(1)
    return [rng.standard_normal((B, HEADS, T, 64)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize(
    "valid,eot",
    [([13, 9], [12, 5]), ([16, 16], [15, 0]), ([13, 13], [14, 3])],
    ids=["per-row", "full", "eot-past-valid"],
)
def test_fused_attention_aux_matches_pallas_interpret(qkv, valid, eot):
    q, k, v = qkv
    want_out, want_aux = jax_fused_attention(
        *(jnp.asarray(a) for a in qkv), kv_valid_len=jnp.asarray(valid),
        attn_to_idx=jnp.asarray(eot), interpret=True,
    )
    got_out, got_aux = fused_attention(
        _t(q), _t(k), _t(v), kv_valid_len=torch.tensor(valid), attn_to_idx=torch.tensor(eot)
    )
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(want_aux), **TOL)


def test_fused_attention_int_args_and_no_aux(qkv):
    q, k, v = (_t(a) for a in qkv)
    out_i, aux_i = fused_attention(q, k, v, kv_valid_len=VALID, attn_to_idx=T - 1)
    out_t, aux_t = fused_attention(
        q, k, v, kv_valid_len=torch.full((B,), VALID), attn_to_idx=torch.full((B,), T - 1)
    )
    torch.testing.assert_close(out_i, out_t)
    torch.testing.assert_close(aux_i, aux_t)
    out_n, aux_n = fused_attention(q, k, v, kv_valid_len=VALID)
    assert aux_n is None
    torch.testing.assert_close(out_n, out_i)


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas"])
def test_multi_head_attention_dispatch(qkv, impl):
    q, k, v = (_t(a) for a in qkv)
    out, aux = multi_head_attention(q, k, v, kv_valid_len=VALID, attn_to_idx=T - 1, impl=impl)
    want_out, want_aux = attention_reference(q, k, v, kv_valid_len=VALID, attn_to_idx=T - 1)
    torch.testing.assert_close(out, want_out)
    torch.testing.assert_close(aux, want_aux)
    with pytest.raises(ValueError):
        multi_head_attention(q, k, v, impl="nope")


# --- the build and the C interface ------------------------------------------


def _c_params(src: str, name: str) -> int:
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src, re.S)
    assert m, f"{name} not found"
    return len([p for p in m.group(1).split(",") if p.strip()])


def test_ctypes_signatures_match_sources():
    src = "\n".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    for name, argtypes in _build._SIGNATURES.items():
        assert _c_params(src, name) == len(argtypes), name


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    replaced = {
        "fused_mlp.cu": "tapclip_tpu/ops/fused_mlp.py::_mlp_kernel",
        "attn_block.cu": "tapclip_tpu/ops/fused_mha.py::_attn_block_kernel",
        "attn_aux.cu": "tapclip_tpu/ops/flash_attention.py::_attn_kernel",
        "mlp_bwd.cu": "tapclip_tpu/ops/fused_mlp.py::_mlp_bwd_kernel",
        "attn_block_bwd.cu": "tapclip_tpu/ops/fused_mha.py::_attn_block_bwd_kernel",
        "gemm.cu": "tapclip_tpu/ops/fused_mha.py::_attn_block_bwd_kernel",
        "mha.cu": "tapclip_tpu/ops/fused_mha.py::_mha_kernel",
        "mha_bwd.cu": "tapclip_tpu/ops/fused_mha.py::_mha_bwd_kernel",
        "flash_bwd.cu": "tapclip_tpu/ops/flash_attention.py::_blocked_lse_kernel",
        "int8_mlp.cu": "tapclip_tpu/ops/int8_mlp.py::_int8_mlp_kernel",
        "int8_attn.cu": "tapclip_tpu/ops/int8_attn.py::_int8_attn_kernel",
        "int8_gemm.cu": "scripts/int8_probe.py::mm_kernel",
        "fused_layer.cu": "scripts/fused_layer_ab.py::make_layer_kernel.kernel",
        "fused_mlp_variants.cu": "scripts/mlp_kernel_ab.py::make_kernel.kernel",
        "attn_variants_online.cu": "scripts/attn_softmax_ab.py::make_kernel.kernel",
        "attn_variants_two_pass.cu": "scripts/attn_kernel_ab.py::make_variant_kernel.kernel",
    }
    for fname, tpu in replaced.items():
        head = (_build.CSRC / fname).read_text()[:4000]
        assert tpu in head, fname
        assert "bounds it on the card" in head, fname


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", tmp_path / "no-nvcc")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library.__wrapped__()


def test_operand_checks():
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.check_cuda_operand("x", torch.zeros(2))
    with pytest.raises(TypeError):
        _build.dtype_code(torch.float16)
    assert (_build.dtype_code(torch.float32), _build.dtype_code(torch.bfloat16)) == (0, 1)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        _build.check(1, "k")


def test_gemm_wrappers_take_cuda_operands_only():
    from tapclip_tpu_torch.ops.gemm import col_sum, gemm_f32

    a = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="at most one transposed"):
        gemm_f32(a, a, trans_a=True, trans_b=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gemm_f32(a, torch.zeros(3, 5))
    with pytest.raises(ValueError, match="CUDA tensor"):
        col_sum(a)

