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
from tapclip_tpu.ops.fused_mha import fused_attn_block as jax_fused_attn_block
from tapclip_tpu.ops.fused_mlp import _fused_mlp_vjp, _xla_composition

from tapclip_tpu_torch.ops import _build
from tapclip_tpu_torch.ops.attention import attention_reference, multi_head_attention
from tapclip_tpu_torch.ops.flash_attention import fused_attention
from tapclip_tpu_torch.ops.fused_mha import fused_attn_block
from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block, fused_mlp_reference

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

