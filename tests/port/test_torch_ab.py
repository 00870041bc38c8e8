"""The A/B variants S1-S5 of the TPU scripts against the port's plain versions, on the CPU.

The JAX side runs each script's own kernel (``scripts/fused_layer_ab.py``,
``mlp_kernel_ab.py``, ``attn_kernel_ab.py``, ``attn_softmax_ab.py``,
``int8_mlp_ab.py``) in Pallas interpret mode: the scripts call
``pl.pallas_call`` through the module attribute, so a fixture swaps in a
wrapper that drops the TPU compiler parameters and passes
``interpret=True``.  S5's kernel draws its random bits with
``pltpu.prng_random_bits``, which the port cannot reproduce: its S5 tests
swap the script's ``pltpu`` for the real module's members with a
``prng_seed`` / ``prng_random_bits`` that compute the port's counter hash
(``ops/int8_mlp.py::rand_bits``) inside the kernel, the streams in call
order, so both sides see the same draws.  Each call is compiled with
``xla_allow_excess_precision`` off, so XLA keeps every ``.astype(bf16)`` the
source writes (left on, it drops the rounding of the "bf16" softmax's
probabilities in f32 and moves that variant by 1.8e-3).  The port side runs
the plain versions (``ops/fused_layer.py``, ``ops/fused_mlp.py``,
``ops/fused_mha.py``) on the same numpy inputs, with each variant's switches
taken from the port's drivers (``tapclip_tpu_torch/scripts/``), so the tests
hold the drivers' translation too.

Geometry: W 128, 2 heads of 64, MLP hidden 512, batch 2; T 24 with 17 valid
keys, and T 136 with 130, which crosses the 128-key boundary of ``tail`` and
``tail_split``.  Schedule arguments the test batch cannot take are fitted to
it (``bB`` 2, ``row_tile`` all rows, ``group_heads`` at most the 2 heads,
``h_chunk`` scaled from H 3,072 to 512): they change only the order of the
TPU kernel's work.  S5 runs at W 128, H 512, B 2 x T 16 and B 3 x T 24 with
``row_tile`` all rows (one grid step, so the kernel's row index is the
global one the draws are keyed on).

Tolerances: f32 atol = rtol = 1e-5 (as ``test_torch_ops.py``: summation
order, erff against the TPU's erf polynomial), except the "bf16" softmax
(``smopt_bf16``), whose p is rounded to bf16 after (s - m) is: an f32 ulp of
difference in s moves that rounding by a bf16 step of p, so it is held at
1e-3 (reading 1.8e-4; the variant lies 4.6e-3 from K2's arithmetic).  bf16,
compared in f32: no output may differ by more than one bf16 step (2^-7 of
max(|x|, 1)), and at most a share of them at all: 5% for a half-block, 15%
for the whole layer.  Readings on this geometry: the plain versions differ
from the TPU kernels in at most 0.05% of the MLP outputs, 3.1% of the
attention half-block's and 6.6% of the layer's at T 136 (an f32 summation
order moves a few of the 130 bf16 p of a row across a rounding step, and the
out-projection spreads each such step over its row), while the parents'
roundings differ in 9.4-52% (S1 run as K2 then K1, the normalised softmax
run as K2's, sum_mxu's l from unrounded p, the "bf16" softmax's p at full
width): ``test_bf16_rounding_switches_are_held`` checks that those fail.
S5 reads at most 9.5e-7 in f32 (its erf3 switch left off, or turned on where
it is off, reads 3.2e-3 to 5.5e-3, so f32 tells the switches apart) and at
most 0.01% of the outputs differing in bf16, where the wrong erf3 switch
moves 1.2-3.4% of them by a step and would pass: bf16 holds the path, not
the switch.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from scripts import attn_kernel_ab as jax_s3
from scripts import attn_softmax_ab as jax_s4
from scripts import fused_layer_ab as jax_s1
from scripts import int8_mlp_ab as jax_s5
from scripts import mlp_kernel_ab as jax_s2
from tapclip_tpu_torch.ops.fused_layer import fused_layer, fused_layer_reference
from tapclip_tpu_torch.ops.fused_mha import (
    attn_block_reference,
    attn_block_variant,
    attn_block_variant_reference,
)
from tapclip_tpu_torch.ops.fused_mlp import (
    fused_mlp_reference,
    fused_mlp_variant,
    fused_mlp_variant_reference,
)
from tapclip_tpu_torch.ops.int8_mlp import int8_mlp_variant, quantize_mlp
from tapclip_tpu_torch.scripts import attn_kernel_ab, attn_softmax_ab, fused_layer_ab, int8_mlp_ab, mlp_kernel_ab
from tapclip_tpu_torch.scripts.split_error import emulate_fused_layer

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

B, W, HEADS, HID = 2, 128, 2, 512
SHAPES = [(24, 17), (136, 130)]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
F32_TOL_BF16_SOFTMAX = dict(rtol=1e-3, atol=1e-3)
BF16_FRAC = 0.05  # a half-block
BF16_FRAC_LAYER = 0.15  # the whole layer: two half-blocks in a chain
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def interpret():
    orig = pl.pallas_call

    def call(*args, **kw):
        kw.pop("compiler_params", None)
        return orig(*args, interpret=True, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call", call)
    yield
    mp.undo()


@functools.lru_cache(maxsize=None)
def _weights(T):
    rng = np.random.default_rng(T)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731

    def ln():
        return {"scale": 1.0 + f(W, scale=0.1), "bias": f(W, scale=0.1)}

    return {"x": f(B, T, W), "ln1": ln(), "ln2": ln(),
            "attn": {"w_qkv": f(W, 3 * W, scale=W ** -0.5), "b_qkv": f(3 * W, scale=0.1),
                     "w_out": f(W, W, scale=W ** -0.5), "b_out": f(W, scale=0.1)},
            "mlp": {"w_fc": f(W, HID, scale=W ** -0.5), "b_fc": f(HID, scale=0.1),
                    "w_proj": f(HID, W, scale=HID ** -0.5), "b_proj": f(W, scale=0.1)}}


def _tree(d, to):
    return {k: _tree(v, to) if isinstance(v, dict) else to(v) for k, v in d.items()}


def _port(T, dtype):
    w = _tree(_weights(T), torch.from_numpy)
    w["x"] = w["x"].to(dtype)
    return w


_JAX_CACHE = {}


def _jax(script, fn_name, T, dt, **kw):
    """The script's kernel on the test inputs, f32 numpy; identical calls once."""
    key = (script.__name__, fn_name, T, dt, tuple(sorted(kw.items())))
    if key not in _JAX_CACHE:
        w = _tree(_weights(T), jnp.asarray)
        x = w["x"].astype(DTYPES[dt][0])
        args = {"run_fused_layer": (w["ln1"], w["attn"], w["ln2"], w["mlp"], x),
                "run_interleaved": (w["ln1"], w["attn"], x),
                "run_variant": (w["ln2"], w["mlp"], x) if script is jax_s2 else (w["ln1"], w["attn"], x)}[fn_name]
        f = jax.jit(functools.partial(getattr(script, fn_name), **kw))
        out = f.lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)
        _JAX_CACHE[key] = np.asarray(out.astype(jnp.float32))
    return _JAX_CACHE[key]


def _bf16_close(got, want):
    """(fraction of outputs that differ, whether every one is within one bf16 step)."""
    got, want = got.float().numpy(), np.asarray(want)
    d = np.abs(got - want)
    return float(np.mean(d > 0)), bool(np.all(d <= 2.0 ** -7 * np.maximum(np.abs(want), 1.0)))


def _check(got, want, dt, frac_limit=BF16_FRAC, f32_tol=F32_TOL):
    assert torch.isfinite(got.float()).all()
    if dt == "f32":
        np.testing.assert_allclose(got.float().numpy(), want, **f32_tol)
    else:
        frac, within = _bf16_close(got, want)
        assert within and frac <= frac_limit, f"bf16: {frac:.4f} of the outputs differ (limit {frac_limit})"


# --- the JAX side of each variant: the script's runner and its arguments, fitted to the test batch ----


def _s2_jax(name, T, dt):
    kw = {k: v for k, v in mlp_kernel_ab.VARIANTS[name].items() if k != "row_tile"}
    return _jax(jax_s2, "run_variant", T, dt, row_tile=B * T, **kw)


def _s3_jax(name, T, dt):
    runner, kw = attn_kernel_ab.VARIANTS[name]
    kw = {k: v for k, v in kw.items() if k != "vmem_mb"}
    kw.update(bB=B, group_heads=min(kw.get("group_heads", 2), HEADS))
    return _jax(jax_s3, runner, T, dt, H=HEADS, valid=dict(SHAPES)[T], **kw)


# sum_mxu reads the tail select in the JAX kernel whatever mask_mode (with
# "full" it raises NameError: v6b_full cannot run there); where every pad key
# lies past the boundary, as here, full and tail select the same keys.
_S4_JAX_MASK = {"v6b_full": "tail", "summxu": "tail"}


def _s4_jax(name, T, dt):
    kw = dict(attn_softmax_ab.VARIANTS[name])
    if name in _S4_JAX_MASK:
        kw["mask_mode"] = _S4_JAX_MASK[name]
    kw["group_heads"] = min(kw.get("group_heads") or 2, HEADS)
    return _jax(jax_s4, "run_variant", T, dt, H=HEADS, valid=dict(SHAPES)[T], bB=B, **kw)


def _s1_jax(name, T, dt):
    kw = dict(fused_layer_ab.VARIANTS[name])
    kw["bB"] = B
    if "h_chunk" in kw:
        kw["h_chunk"] = kw["h_chunk"] * HID // 3072
    return _jax(jax_s1, "run_fused_layer", T, dt, H_heads=HEADS, valid=dict(SHAPES)[T], **kw)


def _s2_port(name, T, dt):
    w = _port(T, DTYPES[dt][1])
    return fused_mlp_variant(w["x"], w["ln2"]["scale"], w["ln2"]["bias"], *w["mlp"].values(),
                             **mlp_kernel_ab.port_flags(mlp_kernel_ab.VARIANTS[name]))


def _s3_port(name, T, dt):
    w = _port(T, DTYPES[dt][1])
    return attn_block_variant(w["x"], w["ln1"], w["attn"], HEADS, dict(SHAPES)[T],
                              **attn_kernel_ab.port_flags(*attn_kernel_ab.VARIANTS[name], HEADS))


def _s4_port(name, T, dt):
    w = _port(T, DTYPES[dt][1])
    return attn_block_variant(w["x"], w["ln1"], w["attn"], HEADS, dict(SHAPES)[T],
                              **attn_softmax_ab.port_flags(attn_softmax_ab.VARIANTS[name], HEADS))


def _s1_port(T, dt):
    w = _port(T, DTYPES[dt][1])
    return fused_layer(w["x"], w["ln1"], w["attn"], w["ln2"], w["mlp"], HEADS, dict(SHAPES)[T])


def _cases(names, skip=()):
    return [pytest.param(n, T, dt, id=f"{n}-T{T}-{dt}")
            for n in names for T, _ in SHAPES for dt in DTYPES if (n, T) not in skip]


@pytest.mark.parametrize("name,T,dt", _cases(mlp_kernel_ab.VARIANTS))
def test_mlp_variants_match_the_tpu_kernel(name, T, dt):
    _check(_s2_port(name, T, dt), _s2_jax(name, T, dt), dt)


@pytest.mark.parametrize("name,T,dt", _cases(attn_kernel_ab.VARIANTS))
def test_attn_kernel_variants_match_the_tpu_kernel(name, T, dt):
    bf16_softmax = attn_kernel_ab.VARIANTS[name][1].get("softmax_opt") == "bf16"
    _check(_s3_port(name, T, dt), _s3_jax(name, T, dt), dt,
           f32_tol=F32_TOL_BF16_SOFTMAX if bf16_softmax else F32_TOL)


# The TPU kernel's tail_split takes the keys before the last 128-key boundary
# as its main block: at T 24 that block is empty and the kernel cannot run.
@pytest.mark.parametrize("name,T,dt", _cases(attn_softmax_ab.VARIANTS, skip={("tail_split", 24)}))
def test_attn_softmax_variants_match_the_tpu_kernel(name, T, dt):
    _check(_s4_port(name, T, dt), _s4_jax(name, T, dt), dt)


# --- S5: the int8 MLP's variants, the script's kernel fed the port's draws ----------

S5_SHAPES = [(2, 16), (3, 24)]  # (B, T) at W 128, H 512


def _s5_pltpu():
    """The real ``pltpu`` with the port's random bits: ``prng_seed`` records
    the seed and restarts the streams, each ``prng_random_bits`` draws the
    next stream's ``mix32(mix32(mix32(mix32(seed ^ 0x9e3779b9) ^ stream) ^
    row) ^ col)`` in uint32 arithmetic inside the kernel."""
    u32 = jnp.uint32
    state = {}

    def mix32(h):
        h = h ^ (h >> 16)
        h = h * u32(0x7FEB352D)
        h = h ^ (h >> 15)
        h = h * u32(0x846CA68B)
        return h ^ (h >> 16)

    def prng_seed(seed):
        state.update(seed=jnp.asarray(seed).astype(u32), stream=0)

    def prng_random_bits(shape):
        key = mix32(mix32(state["seed"] ^ u32(0x9E3779B9)) ^ u32(state["stream"]))
        state["stream"] += 1
        rows = mix32(key ^ jax.lax.broadcasted_iota(u32, shape, 0))
        return jax.lax.bitcast_convert_type(mix32(rows ^ jax.lax.broadcasted_iota(u32, shape, 1)), jnp.int32)

    members = {k: getattr(pltpu, k) for k in dir(pltpu) if not k.startswith("__")}
    return types.SimpleNamespace(**{**members, "prng_seed": prng_seed, "prng_random_bits": prng_random_bits})


@functools.lru_cache(maxsize=None)
def _s5_weights(B, T):
    rng = np.random.default_rng(100 * B + T)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return {"x": f(B, T, W), "ln": {"scale": 1.0 + f(W, scale=0.1), "bias": f(W, scale=0.1)},
            "mlp": {"w_fc": f(W, HID, scale=W ** -0.5), "b_fc": f(HID, scale=0.1),
                    "w_proj": f(HID, W, scale=HID ** -0.5), "b_proj": f(W, scale=0.1)}}


@functools.lru_cache(maxsize=None)
def _s5_jax(name, B, T, dt):
    w = _tree(_s5_weights(B, T), jnp.asarray)
    x = w["x"].astype(DTYPES[dt][0])
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_s5, "pltpu", _s5_pltpu())
    try:
        f = jax.jit(functools.partial(jax_s5.run_variant, row_tile=B * T, **int8_mlp_ab.VARIANTS[name]))
        out = f.lower(w["ln"], w["mlp"], x).compile(
            compiler_options={"xla_allow_excess_precision": False})(w["ln"], w["mlp"], x)
    finally:
        mp.undo()
    return np.asarray(out.astype(jnp.float32))


def _s5_port(name, B, T, dt):
    w = _tree(_s5_weights(B, T), torch.from_numpy)
    return int8_mlp_variant(w["x"].to(DTYPES[dt][1]), w["ln"]["scale"], w["ln"]["bias"], quantize_mlp(w["mlp"]),
                            **int8_mlp_ab.port_flags(int8_mlp_ab.VARIANTS[name]))


@pytest.mark.parametrize("name,B,T,dt", [pytest.param(n, B, T, dt, id=f"{n}-B{B}xT{T}-{dt}")
                                         for n in int8_mlp_ab.VARIANTS for B, T in S5_SHAPES for dt in DTYPES])
def test_int8_mlp_variants_match_the_tpu_kernel(name, B, T, dt):
    _check(_s5_port(name, B, T, dt), _s5_jax(name, B, T, dt), dt)


@pytest.mark.parametrize("name,T,dt", _cases(fused_layer_ab.VARIANTS))
def test_fused_layer_matches_the_tpu_kernel(name, T, dt):
    _check(_s1_port(T, dt), _s1_jax(name, T, dt), dt, frac_limit=BF16_FRAC_LAYER)


@pytest.mark.parametrize("T", [T for T, _ in SHAPES])
def test_fused_layer_split_products_match_the_tpu_kernel(T):
    """S1's tensor-core products as the card forms them (three bf16 terms an
    f32 operand, ``split_error.emulate_fused_layer``) against the TPU kernel
    in interpret mode, in f32, as the plain version is held above."""
    w = _port(T, torch.float32)
    got = emulate_fused_layer(w["x"], w["ln1"], w["attn"], w["ln2"], w["mlp"], HEADS, dict(SHAPES)[T])
    _check(got, _s1_jax("fused bB8", T, "f32"), "f32")


def _k2_then_k1(T, dt):
    """The parents' roundings for S1: K2's arithmetic (the softmax form with no
    switch), then K1's (the MLP variant with none)."""
    w = _port(T, DTYPES[dt][1])
    mid = attn_block_variant_reference(w["x"], *w["ln1"].values(), *w["attn"].values(), HEADS,
                                       dict(SHAPES)[T], form="softmax")
    return fused_mlp_variant_reference(mid, *w["ln2"].values(), *w["mlp"].values())


def _s3_with(T, dt, **flags):
    w = _port(T, DTYPES[dt][1])
    return attn_block_variant_reference(w["x"], *w["ln1"].values(), *w["attn"].values(), HEADS,
                                        dict(SHAPES)[T], form="variant", **flags)


def _s4_with(T, dt, **flags):
    w = _port(T, DTYPES[dt][1])
    return attn_block_variant_reference(w["x"], *w["ln1"].values(), *w["attn"].values(), HEADS,
                                        dict(SHAPES)[T], form="softmax", **flags)


SUMMXU = dict(qk_cast=True, fold_q=True, mask_mode="tail")
# Each numeric bf16 switch: the JAX kernel, the port's plain version, and the
# same computation with the parent's roundings in place of the switch's.
ROUNDING_CASES = {
    "fused_layer_f32_mid": (lambda T: _s1_jax("fused bB8", T, "bf16"), lambda T: _s1_port(T, "bf16"),
                            lambda T: _k2_then_k1(T, "bf16")),
    "normalised_softmax": (lambda T: _s3_jax("v0_default", T, "bf16"), lambda T: _s3_with(T, "bf16"),
                           lambda T: _s3_with(T, "bf16", softmax_opt=True)),
    "sum_mxu": (lambda T: _s4_jax("v6_summxu", T, "bf16"), lambda T: _s4_with(T, "bf16", sum_mxu=True, **SUMMXU),
                lambda T: _s4_with(T, "bf16", **SUMMXU)),
    "softmax_bf16": (lambda T: _s3_jax("smopt_bf16", T, "bf16"), lambda T: _s3_with(T, "bf16", softmax_opt="bf16"),
                     lambda T: _s3_with(T, "bf16", softmax_opt=True)),
}


@pytest.mark.parametrize("T", [T for T, _ in SHAPES])
@pytest.mark.parametrize("case", sorted(ROUNDING_CASES))
def test_bf16_rounding_switches_are_held(case, T):
    """The bf16 limit tells each numeric switch from its parent's roundings: the
    port passes it, the parent's computation in the switch's place does not."""
    jax_fn, port_fn, parent_fn = ROUNDING_CASES[case]
    limit = BF16_FRAC_LAYER if case == "fused_layer_f32_mid" else BF16_FRAC
    want = jax_fn(T)
    with torch.no_grad():
        _check(port_fn(T), want, "bf16", frac_limit=limit)
        frac, _ = _bf16_close(parent_fn(T), want)
    assert frac > limit, f"{case}: the parent's roundings differ in only {frac:.4f} of the outputs"


@pytest.mark.parametrize("T", [T for T, _ in SHAPES])
def test_flags_off_variants_are_the_production_plain_versions(T):
    """In f32 the S2 and S3 plain versions with no switch are the production
    plain versions operation for operation.  (In bf16 they round where the TPU
    scripts' kernels round, the production ones where the JAX package's plain
    composition does.  S4 with no switch is K2's kernel arithmetic: it is held
    bit for bit against K2 on the card.)"""
    w = _port(T, torch.float32)
    valid = dict(SHAPES)[T]
    mlp_args = (w["x"], *w["ln2"].values(), *w["mlp"].values())
    torch.testing.assert_close(fused_mlp_variant(*mlp_args), fused_mlp_reference(*mlp_args), rtol=0, atol=0)
    attn_args = (w["x"], *w["ln1"].values(), *w["attn"].values(), HEADS, valid)
    torch.testing.assert_close(attn_block_variant_reference(*attn_args),
                               attn_block_reference(*attn_args, 1e-5), rtol=0, atol=0)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("driver", [mlp_kernel_ab, attn_kernel_ab, attn_softmax_ab, fused_layer_ab, int8_mlp_ab],
                         ids=lambda d: d.__name__.rsplit(".", 1)[1])
def test_drivers_run_on_the_cpu(driver, dt):
    """Each card driver's run() on the CPU (plain versions, no timing) at
    ViT-B/32's widths: every variant finite, its kernel call there is its plain
    version, and the variants with one configuration name the first."""
    out = driver.run(B=1, model="ViT-B-32", reps=1, dtype=DTYPES[dt][1], device="cpu")
    same = {n: v["same_as"] for n, v in out["variants"].items() if "same_as" in v}
    assert same == {mlp_kernel_ab: {},
                    attn_kernel_ab: {"v4_bb8": "v0_default", "bb8_ph_smopt_v64": "bb8_ph_smopt",
                                     "bb8_ph_smopt_v32": "bb8_ph_smopt"},
                    attn_softmax_ab: {"swpipe": "base", "v10_swpipe": "v6_summxu"},
                    fused_layer_ab: {"fused bB4": "fused bB8", "fused bB8 hc1536": "fused bB8"},
                    int8_mlp_ab: {}}[driver]
    for name, v in out["variants"].items():
        if "same_as" not in v:
            assert v["vs_plain"]["max_abs_err"] == 0.0 and v["vs_parent"]["finite"], name
    assert out["bound_ms"] > 0 and "ms" not in out["parent"]


@pytest.mark.parametrize("driver", [mlp_kernel_ab, attn_kernel_ab, attn_softmax_ab, fused_layer_ab, int8_mlp_ab],
                         ids=lambda d: d.__name__.rsplit(".", 1)[1])
def test_drivers_need_a_card(driver, capsys):
    assert driver.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err


def test_variant_wrappers_refuse():
    w = _port(136, torch.float32)
    attn_args = (w["x"], w["ln1"], w["attn"], HEADS)
    with pytest.raises(ValueError, match="tail"):  # pad keys 120.. lie before the last 64-key tile (128)
        attn_block_variant(*attn_args, 120, form="softmax", mask_mode="tail")
    attn_block_variant(*attn_args, 130, form="softmax", mask_mode="tail")
    with pytest.raises(ValueError, match="takes"):
        attn_block_variant(*attn_args, 130, form="variant", qk_cast=True)
    with pytest.raises(ValueError, match="softmax_opt"):
        attn_block_variant(*attn_args, 130, softmax_opt="fp8")
    with pytest.raises(ValueError, match="group_heads"):
        attn_block_variant(*attn_args, 130, group_heads=3)
    mlp_args = (w["x"], *w["ln2"].values(), *w["mlp"].values())
    with pytest.raises(ValueError, match="one switch"):
        fused_mlp_variant(*mlp_args, row_tile=128, erf3=True)
    with pytest.raises(RuntimeError, match="eval only"):
        fused_mlp_variant(w["x"].clone().requires_grad_(), *mlp_args[1:])
    q = quantize_mlp(w["mlp"])
    for flags in (dict(erf3=True), dict(recipmul=True)):
        with pytest.raises(ValueError, match="stochastic"):
            int8_mlp_variant(w["x"], *w["ln2"].values(), q, deterministic=True, **flags)
    with pytest.raises(RuntimeError, match="eval only"):
        int8_mlp_variant(w["x"].clone().requires_grad_(), *w["ln2"].values(), q)
    with pytest.raises(RuntimeError, match="eval only"):
        fused_layer(w["x"].clone().requires_grad_(), w["ln1"], w["attn"], w["ln2"], w["mlp"], HEADS, 130)
    with torch.no_grad():
        got = fused_layer(w["x"].clone().requires_grad_(), w["ln1"], w["attn"], w["ln2"], w["mlp"], HEADS, 130)
    torch.testing.assert_close(got, fused_layer_reference(w["x"], w["ln1"], w["attn"], w["ln2"], w["mlp"],
                                                          HEADS, 130), rtol=0, atol=0)
