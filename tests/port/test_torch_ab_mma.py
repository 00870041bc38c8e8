"""S1 and S2 on the tensor cores, on the CPU: S1's split products emulated,
and S2's switches as configurations of K1.

S1 (``csrc/fused_layer.cu``) runs every product of the layer on K1's and
K2's tensor-core tiles: an f32 operand split into three bf16 terms (six MMAs
a product), the out-projection on the split f32 tile in both dtypes (the
attention output stays f32).  ``scripts/split_error.py::emulate_fused_layer``
forms the same sums in torch's f32 matmul; held against
``fused_layer_reference`` at the card's A/B limits (``chip_smoke.py``'s
``AB_TOL``: f32 1e-4, bf16 2e-2, on max |d| / (1 + |want|)).  Two terms an
f32 operand read 1.7e-5 to 2.0e-5 there, inside 1e-4, so the f32 cases also
hold the norm-relative error at 1e-6, which only three terms meet (readings:
three terms 2.5e-7 to 3.4e-7, two 3.8e-6 to 4.8e-6), as the dW products'
test does in ``test_torch_ops.py``.

``scripts/fused_layer_phases.py`` times S1's phases on the card from
stamped copies of its source: each of its variants must still apply to the
source as it stands.

S2 (``csrc/fused_mlp_variants.cu``) runs each switch of
``scripts/mlp_kernel_ab.py`` on K1's own launches: every JAX variant maps to
exactly one card configuration (``mlp_kernel_ab.port_flags``), which the
wrapper takes.
"""

import pytest
import torch

from tapclip_tpu_torch.ops.fused_mlp import _ln_rows, fused_mlp_variant, fused_mlp_variant_reference
from tapclip_tpu_torch.scripts import fused_layer_phases, mlp_kernel_ab, ptxas_compare
from tapclip_tpu_torch.scripts.split_error import emulated_fused_layer_errors, mlp_inputs

torch.set_num_threads(1)

AB_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SPLIT_REL_LIMIT = 1e-6  # f32, norm-relative: met by three terms an operand, not by two
# (B, T, W, heads, valid): the card test's S1 shapes but ViT-L/14's (its
# widths add nothing on the CPU but time), and the A/B tests' T 24 and 136.
S1_SHAPES = [(2, 200, 768, 12, 197), (3, 37, 128, 2, 30), (2, 24, 128, 2, 17), (2, 136, 128, 2, 130)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,W,heads,valid", S1_SHAPES, ids=[f"t{s[1]}-w{s[2]}" for s in S1_SHAPES])
def test_fused_layer_split_products_meet_the_card_limits(B, T, W, heads, valid, dtype):
    errs = emulated_fused_layer_errors(B, T, W, heads, valid, dtype)
    assert errs["tol_needed"] <= AB_TOL[dtype], errs
    if dtype == torch.float32:
        assert errs["out_rel"] <= SPLIT_REL_LIMIT, errs
        two = emulated_fused_layer_errors(B, T, W, heads, valid, dtype, f32_terms=2)
        assert two["out_rel"] > SPLIT_REL_LIMIT, two


def test_each_jax_variant_is_one_card_configuration():
    configs = {name: mlp_kernel_ab.port_flags(kw) for name, kw in mlp_kernel_ab.VARIANTS.items()}
    keys = [tuple(sorted(f.items())) for f in configs.values()]
    assert len(set(keys)) == len(keys), configs  # no two variants share a kernel configuration
    assert configs["base"] == {"row_tile": 0, "erf3": False, "ln1pass": False, "chunks": 1}
    assert configs["rt512"] == dict(configs["base"], row_tile=128)
    assert configs["ilv2"]["chunks"] == 2 and configs["ilv4"]["chunks"] == 4
    assert configs["ilv4_erf3"] == dict(configs["ilv4"], erf3=True)
    assert mlp_kernel_ab.SCHEDULE_ONLY == ("base", "rt512")


@pytest.mark.parametrize("name", list(mlp_kernel_ab.VARIANTS))
def test_the_wrapper_takes_each_card_configuration(name):
    """At ViT-B/16's widths (W 768, H 3,072: every chunk whole 128-column fc
    tiles) the wrapper takes each configuration; on the CPU it is the plain
    version with the same switches."""
    x, *params = mlp_inputs(5, 768, seed=1)
    flags = mlp_kernel_ab.port_flags(mlp_kernel_ab.VARIANTS[name])
    with torch.no_grad():
        got = fused_mlp_variant(x, *params, **flags)
    torch.testing.assert_close(got, fused_mlp_variant_reference(x, *params, **flags), rtol=0, atol=0)
    assert got.shape == x.shape and torch.isfinite(got).all()


@pytest.mark.parametrize("chunks", [2, 4])
def test_chunked_projection_sums_in_the_tpu_order(chunks):
    """The plain version's chunked projection: ((x + b_proj) + p_0) + p_1 ...,
    each p_j the product over the j-th slice of the hidden dimension."""
    x, gamma, beta, w_fc, b_fc, w_proj, b_proj = mlp_inputs(7, 128, seed=2)
    got = fused_mlp_variant_reference(x, gamma, beta, w_fc, b_fc, w_proj, b_proj, chunks=chunks)
    flat = fused_mlp_variant_reference(x, gamma, beta, w_fc, b_fc, w_proj, b_proj)
    y = _ln_rows(x, 1e-5, False) * gamma + beta
    g = torch.nn.functional.gelu(y @ w_fc + b_fc)
    want = x + b_proj
    hc = w_fc.shape[1] // chunks
    for j in range(chunks):
        want = want + g[:, j * hc:(j + 1) * hc] @ w_proj[j * hc:(j + 1) * hc]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, flat, rtol=1e-5, atol=1e-5)  # the same function, summed in another order


@pytest.mark.parametrize("flags,match", [
    (dict(row_tile=64), "row_tile 0 or 128"),
    (dict(chunks=3), "chunks 1, 2 or 4"),
    (dict(row_tile=128, erf3=True), "one switch"),
    (dict(ln1pass=True, chunks=2), "one switch"),
], ids=["row-tile-64", "chunks-3", "rt-with-erf3", "ln1pass-with-chunks"])
def test_the_wrapper_refuses_other_configurations(flags, match):
    x, *params = mlp_inputs(5, 128, seed=3)
    with torch.no_grad(), pytest.raises(ValueError, match=match):
        fused_mlp_variant(x, *params, **flags)


def test_chunks_take_whole_fc_tiles():
    x, *params = mlp_inputs(5, 96, seed=4)  # H 384: 2 chunks of 192 columns are not whole 128-column tiles
    with torch.no_grad(), pytest.raises(ValueError, match="divisible by 256"):
        fused_mlp_variant(x, *params, chunks=2)


@pytest.mark.parametrize("name", list(fused_layer_phases.VARIANTS))
def test_each_phase_variant_applies_to_the_source(name):
    """Each variant's substitution still finds its text in fused_layer.cu, and
    the stamped copy reads the timer at the start, after each of the six
    barriers and after the added seventh."""
    src = fused_layer_phases.stamped_source(fused_layer_phases.VARIANTS[name])
    for _, new in fused_layer_phases.VARIANTS[name]:
        assert new in src
    assert [k for k in range(9) if f"g_stamps[{k}] = t_" in src] == list(range(8))
    assert src.count("grid.sync();") == 7


def test_the_phase_timer_needs_a_card(capsys):
    assert fused_layer_phases.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err


F32_TILE = "_ZN7tapclip4gemm15gemm_f32_kernelILi64ELi64ELi1ELb0ELb0EEEvPKfS3_NS0_3EpiI{}EEPfiii"
PTXAS_REPORT = """ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 126 registers, used 1 barriers
"""


@pytest.mark.parametrize("epi", ["f", "ff"], ids=["parent-Epi<float>", "change-Epi<float,float>"])
def test_ptxas_compare_reads_both_spellings_as_one_kernel(epi):
    """The tile functions' Epi<float, float> is read as the parent's Epi<float>,
    so a kernel the refactor renamed is compared with itself."""
    got = ptxas_compare.kernels({"fused_mlp.cu": PTXAS_REPORT.format(name=F32_TILE.format(epi))})
    assert list(got.values()) == [(126, 4, 8)]
    ((src, name),) = got
    assert src == "fused_mlp.cu" and name.startswith("void tapclip::gemm::gemm_f32_kernel<64, 64, 1, false, false>")
    assert "Epi<float>" in name
