"""S1-S4 on the tensor cores, on the CPU: S1's and S3/S4's split products
emulated, S2's switches as configurations of K1 and S3/S4's as
configurations of K2.

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

S3 and S4 (``csrc/attn_variants.cu``) run each switch of
``scripts/attn_kernel_ab.py`` and ``attn_softmax_ab.py`` on K2's launches:
``scripts/split_error.py::emulate_attn_variant`` forms each distinct
configuration's split products (two passes of q . k^T for the normalised
form, the "bf16" softmax's roundings, ``sum_mxu``, ``fold_q`` before the
split, ``zerokv``'s walk to T, the ``tail_split`` merge, q and k in one term
where the variant rounds them in bf16, the interleaved partials summed in
group order), held against ``attn_block_variant_reference`` at ``AB_TOL``
(the "bf16" softmax in f32 at 1e-3, ``chip_smoke.py``'s
``AB_BF16_SOFTMAX_F32_TOL``).  Every JAX variant of both drivers maps to
exactly one card configuration (``fused_mha.attn_variant_kernel``).
"""

import pytest
import torch

from tapclip_tpu_torch.ops.fused_mha import ATTN_K2_EQUAL, attn_variant_kernel, attn_variant_switches
from tapclip_tpu_torch.ops.fused_mlp import _ln_rows, fused_mlp_variant, fused_mlp_variant_reference
from tapclip_tpu_torch.scripts import (
    attn_kernel_ab,
    attn_softmax_ab,
    fused_layer_phases,
    mlp_kernel_ab,
    ptxas_compare,
)
from tapclip_tpu_torch.scripts._bench_util import k2_keys
from tapclip_tpu_torch.scripts.split_error import emulated_attn_variant_errors, emulated_fused_layer_errors, mlp_inputs

torch.set_num_threads(1)

AB_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
AB_BF16_SOFTMAX_F32_TOL = 1e-3
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


def _attn_configs(heads):
    """Each distinct S3/S4 port configuration at ``heads`` heads: the name of
    its first JAX variant -> its flags."""
    first = {}
    for name, (runner, kw) in attn_kernel_ab.VARIANTS.items():
        first.setdefault(tuple(sorted(attn_kernel_ab.port_flags(runner, kw, heads).items())), f"s3-{name}")
    for name, kw in attn_softmax_ab.VARIANTS.items():
        first.setdefault(tuple(sorted(attn_softmax_ab.port_flags(kw, heads).items())), f"s4-{name}")
    return {name: dict(key) for key, name in first.items()}


ATTN_CONFIGS = sorted(_attn_configs(12))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,W,heads,valid", S1_SHAPES, ids=[f"t{s[1]}-w{s[2]}" for s in S1_SHAPES])
@pytest.mark.parametrize("name", ATTN_CONFIGS)
def test_attn_variant_split_products_meet_the_card_limits(name, B, T, W, heads, valid, dtype):
    flags = _attn_configs(heads)[name]
    limit = AB_TOL[dtype]
    if flags.get("softmax_opt") == "bf16" and dtype == torch.float32:
        limit = AB_BF16_SOFTMAX_F32_TOL
    errs = emulated_attn_variant_errors(B, T, W, heads, valid, dtype, **flags)
    assert errs["tol_needed"] <= limit, errs


# The JAX variants that run another's configuration (no counterpart of bB,
# vmem_mb or swpipe on the card).
SAME_AS = {"s3-v4_bb8": "s3-v0_default", "s3-bb8_ph_smopt_v64": "s3-bb8_ph_smopt",
           "s3-bb8_ph_smopt_v32": "s3-bb8_ph_smopt", "s4-swpipe": "s4-base", "s4-v10_swpipe": "s4-v6_summxu"}
# The card configuration of each distinct variant (f32, bf16).
ATTN_CARD = {
    "s3-v0_default": ("walk normalized qk3", "walk normalized qk1"),
    "s3-v1_group256": ("walk normalized qk3", "walk normalized qk1"),
    "s3-v2_ln1pass": ("walk normalized qk3", "walk normalized qk1"),
    "s3-v3_perhead_qkv": ("perhead normalized", "perhead normalized"),
    "s3-smopt": ("K2", "walk online qk1"),
    "s3-smopt_bf16": ("walk bf16 qk3", "walk bf16 qk1"),
    "s3-bb8_ph_smopt": ("perhead online", "perhead online"),
    "s3-interleaved": ("walk normalized qk3 interleaved", "walk normalized qk3 interleaved"),
    "s4-base": ("K2", "K2"),
    "s4-v1_qkcast": ("K2", "walk online qk1"),
    "s4-foldq": ("walk online qk3", "walk online qk3"),
    "s4-v2_foldq": ("walk online qk3", "walk online qk1"),
    "s4-tailsel": ("K2", "K2"),
    "s4-v3_tailsel": ("walk online qk3", "walk online qk1"),
    "s4-zerokv": ("walk online qk3", "walk online qk3"),
    "s4-v4_zerokv": ("walk online qk3", "walk online qk1"),
    "s4-summxu": ("K2", "walk online qk3"),
    "s4-v6_summxu": ("walk online qk3", "walk online qk1"),
    "s4-v6b_full": ("walk online qk3", "walk online qk1"),
    "s4-v6c_nofold": ("K2", "walk online qk1"),
    "s4-tail_split": ("walk online qk3 tail_split", "walk online qk3 tail_split"),
    "s4-group256": ("K2 group", "K2 group"),
}


@pytest.mark.parametrize("heads", [2, 12])
def test_each_jax_attention_variant_is_one_card_configuration(heads):
    """Each JAX variant of both drivers is one port configuration, which the
    card takes as one of its configurations (ops/fused_mha.py::
    attn_variant_kernel, the dispatch of csrc/attn_variants.cu): the JAX
    switches with no counterpart fold into the variant they equal, and the
    ones that change no value in the dtype run K2's own code."""
    T, valid = 200, 197
    configs = _attn_configs(heads)
    names = [f"s3-{n}" for n in attn_kernel_ab.VARIANTS] + [f"s4-{n}" for n in attn_softmax_ab.VARIANTS]
    assert sorted(set(names) - set(configs)) == sorted(SAME_AS) and sorted(configs) == sorted(ATTN_CARD)
    for name in configs:
        flags = dict(configs[name])
        sw = attn_variant_switches(flags.pop("form"), T, valid, heads, **flags)
        got = tuple(attn_variant_kernel(sw, dtype) for dtype in (torch.float32, torch.bfloat16))
        assert got == ATTN_CARD[name], name
    for name, first in SAME_AS.items():
        drv, key = (attn_kernel_ab, name[3:]) if name.startswith("s3") else (attn_softmax_ab, name[3:])
        flags = (drv.port_flags(*drv.VARIANTS[key], heads) if drv is attn_kernel_ab
                 else drv.port_flags(drv.VARIANTS[key], heads))
        assert flags == configs[first], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k2_keys_are_the_variants_k2_computes(dtype):
    """The drivers hold exactly the variants the card runs as K2's code bit for
    bit against K2, their parent."""
    for prefix, drv in (("s3", attn_kernel_ab), ("s4", attn_softmax_ab)):
        variants = {}
        for name, kw in drv.VARIANTS.items():
            flags = drv.port_flags(*kw, 12) if drv is attn_kernel_ab else drv.port_flags(kw, 12)
            variants[name] = (None, None, tuple(sorted(flags.items())))
        got = {n for n, v in variants.items() if v[2] in k2_keys(variants, 200, 197, 12, dtype)}
        card = {n: ATTN_CARD[SAME_AS.get(f"{prefix}-{n}", f"{prefix}-{n}")][dtype == torch.bfloat16]
                for n in drv.VARIANTS}
        want = {n for n, c in card.items() if c in ATTN_K2_EQUAL}
        assert got == want, (prefix, sorted(got), sorted(want))


@pytest.mark.parametrize("flags,match", [
    (dict(form="variant", perhead_qkv=True, softmax_opt="bf16"), "perhead_qkv takes"),
    (dict(form="softmax", mask_mode="zerokv", tail_split=True, qk_cast=True), None),
], ids=["perhead-bf16-softmax", "zerokv-tail-split-qkcast"])
def test_the_card_configuration_refuses_what_it_does_not_take(flags, match):
    form = flags.pop("form")
    sw = attn_variant_switches(form, 136, 130, 2, **flags)
    if match is None:  # S4's switches combine freely
        assert attn_variant_kernel(sw, torch.bfloat16) == "walk online qk1 tail_split"
        return
    with pytest.raises(ValueError, match=match):
        attn_variant_kernel(sw, torch.float32)
