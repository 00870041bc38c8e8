"""The port's int8 W8A8 eval tower (B13, B14), token pruning and two-path
evaluation against the JAX package, on the CPU.

The same numpy inputs (and JAX weights bridged with ``params_from_jax``) go
through both packages.  Off a TPU the JAX package runs the round-to-nearest
models (``_xla_int8_reference``, ``_xla_int8_attn_reference``) in both modes;
the port's wrappers run their plain versions on a CPU tensor, and its
deterministic mode is held against JAX's: 2e-3 norm-relative on the blocks'
update (out - x), since a code that lands on the other side of a rounding
step where LayerNorm's sums run in another order moves a row by about that
much, while the int8 noise itself is about 1e-2.  The stochastic mode has no
JAX counterpart off the TPU: its quantizer is held bit for bit against JAX's
``_row_quant_sr`` fed the port's random bits, and the tower statistically.

The CUDA kernels are held against these plain versions on the card by
``tests/port/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.config import PromptConfig as JPromptConfig
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models.model_wrapper import FullModel as JFullModel
from tapclip_tpu.ops.int8_attn import int8_attn_block as j_int8_attn_block
from tapclip_tpu.ops.int8_mlp import _row_quant_sr
from tapclip_tpu.ops.int8_mlp import int8_mlp_block as j_int8_mlp_block
from tapclip_tpu.ops.int8_mlp import quantize_cols_int8 as j_quantize_cols_int8
from tapclip_tpu.serve import PredictService as JPredictService
from tapclip_tpu.utils.adaptive_eval import adaptive_logits as j_adaptive_logits

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch.featurize import make_image_embed_fn
from tapclip_tpu_torch.models import clip as tclip
from tapclip_tpu_torch.models import layers as tlayers
from tapclip_tpu_torch.models.model_wrapper import FullModel
from tapclip_tpu_torch.ops import int8_attn, int8_mlp
from tapclip_tpu_torch.ops.fused_mha import attn_block_reference
from tapclip_tpu_torch.scripts.split_error import emulate_int8_attn, int8_head_tiled_codes
from tapclip_tpu_torch.serve import PredictService, main, server_config
from tapclip_tpu_torch.utils.adaptive_eval import adaptive_logits
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax, prompt_state_from_jax

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

W, HID, HEADS = 128, 512, 4
BLOCK_TOL = 2e-3
CLASSES = ["Backpack", "Pen", "Monitor"]
# 64 px images: 16 patches + the class token = 17 tokens, run at T 24 with 17
# valid, so pruning keeps 8 (ratio 0.5) or 16 (0.8) of the 17 real tokens.
J_PRUNE = J_TINY.replace(image_size=64)


def _port_cfg(jc):
    return tcfg.CLIPConfig(**{f: getattr(jc, f) for f in jc.__dataclass_fields__})


def _f(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _block_params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "ln": {"scale": 1.0 + _f(rng, W, scale=0.1), "bias": _f(rng, W, scale=0.1)},
        "mlp": {"w_fc": _f(rng, W, HID, scale=W ** -0.5), "b_fc": _f(rng, HID, scale=0.1),
                "w_proj": _f(rng, HID, W, scale=HID ** -0.5), "b_proj": _f(rng, W, scale=0.1)},
        "attn": {"w_qkv": _f(rng, W, 3 * W, scale=W ** -0.5), "b_qkv": _f(rng, 3 * W, scale=0.1),
                 "w_out": _f(rng, W, W, scale=W ** -0.5), "b_out": _f(rng, W, scale=0.1)},
    }


def _torch(d):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in d.items()}


def _jax(d):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in d.items()}


def _update_rel(got, want, x):
    """||got - want|| / ||want - x||: the error on the block's update."""
    got, want, x = (np.asarray(t, np.float64) for t in (got, want, x))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want - x))


def _cos_rows(a, b):
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


@pytest.fixture(scope="module")
def tiny():
    jp = jclip.init_clip_params(jax.random.PRNGKey(0), J_PRUNE)
    tc = _port_cfg(J_PRUNE)
    return J_PRUNE, jp, tc, params_from_jax(jax.tree.map(np.asarray, jp), tc)


def _images(cfg, n=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


# --- the quantizers ----------------------------------------------------------


@pytest.mark.parametrize("shape", [(128, 512), (512, 128), (33, 7)])
def test_quantize_cols_int8_bit_equal(shape):
    w = _f(np.random.default_rng(1), *shape)
    jq, js = j_quantize_cols_int8(jnp.asarray(w))
    tq, ts = int8_mlp.quantize_cols_int8(torch.from_numpy(w))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[0])


@pytest.mark.parametrize("mode", ["round_to_nearest", "stochastic"])
@pytest.mark.parametrize("shape", [(16, 128), (37, 512)])
def test_row_quantizers_bit_equal_to_jax(mode, shape):
    """Round to nearest: the row quantizer of ``_xla_int8_reference`` (written
    out here in jnp, since JAX keeps it inside the function).  Stochastic:
    JAX's ``_row_quant_sr`` fed the port's random bits."""
    y = _f(np.random.default_rng(2), *shape, scale=3.0)
    if mode == "round_to_nearest":
        amax = jnp.max(jnp.abs(jnp.asarray(y)), axis=-1, keepdims=True)
        js = jnp.maximum(amax, 1e-8) / 127.0
        jq = jnp.clip(jnp.round(jnp.asarray(y) / js), -127, 127)
        tq, ts = int8_mlp.row_quant_rtn(torch.from_numpy(y))
    else:
        bits = int8_mlp.rand_bits(7, int8_mlp.STREAM_MLP_H, *shape)
        jq, js = _row_quant_sr(jnp.asarray(y), jnp.asarray(bits.numpy().astype(np.uint32)))
        tq, ts = int8_mlp.row_quant_sr(torch.from_numpy(y), bits)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq, np.float32))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _mix32_int(h):
    h ^= h >> 16
    h = (h * 0x7FEB352D) & 0xFFFFFFFF
    h ^= h >> 15
    h = (h * 0x846CA68B) & 0xFFFFFFFF
    return h ^ (h >> 16)


def _bits_int(seed, stream, row, col):
    """The kernels' draw in Python integers (csrc/int8_common.cuh)."""
    key = _mix32_int(_mix32_int(_mix32_int((seed & 0xFFFFFFFF) ^ 0x9E3779B9) ^ stream) ^ row)
    return _mix32_int(key ^ col)


def test_rand_bits_golden_values():
    """Pins the definition the CUDA kernels and the plain versions share."""
    golden = {(0, 0, 0, 0): 1106484830, (0, 1, 0, 0): 335112171, (0, 0, 1, 0): 2968491419,
              (0, 0, 0, 1): 726357435, (5, 3, 1599, 767): 1738673903,
              (2 ** 32 - 1, 2, 12, 3071): 2425795965}
    for (seed, stream, row, col), want in golden.items():
        assert _bits_int(seed, stream, row, col) == want
        got = int8_mlp.rand_bits(seed, stream, row + 1, col + 1)[row, col]
        assert int(got) == want


def test_rand_bits_equal_the_integer_definition():
    bits = int8_mlp.rand_bits(123, 2, 9, 40).numpy()
    want = np.array([[_bits_int(123, 2, r, c) for c in range(40)] for r in range(9)])
    np.testing.assert_array_equal(bits, want)
    assert bits.min() >= 0 and bits.max() < 2 ** 32


def test_stochastic_quantizer_is_unbiased():
    """The mean of 256 independent draws of the dequantized rows lies within
    4 standard errors of the input, element by element."""
    y = torch.from_numpy(_f(np.random.default_rng(3), 2, 64))
    draws = [int8_mlp.row_quant_sr(y, int8_mlp.rand_bits(seed, 0, 2, 64)) for seed in range(256)]
    d = torch.stack([q * s for q, s in draws]).double()
    s = draws[0][1].double()
    # One draw of v/s = n + f is n + 1 with probability f: its standard
    # deviation is s sqrt(f (1 - f)).  An element on a code (f = 0, the row's
    # amax) has none: floor the error scale at the f32 rounding of q * s.
    f = y.double() / s - torch.floor(y.double() / s)
    se = (s * (f * (1 - f) / 256).sqrt()).clamp_min(1e-6)
    assert float(((d.mean(dim=0) - y.double()).abs() / se).max()) < 4.0


# --- the blocks: deterministic mode against JAX --------------------------------


@pytest.mark.parametrize("shape", [(4, 8), (2, 16)], ids=["4x8", "2x16"])
def test_int8_mlp_deterministic_matches_jax(shape):
    p = _block_params()
    x = _f(np.random.default_rng(4), *shape, W)
    want = j_int8_mlp_block(jnp.asarray(x), _jax(p["ln"]), _jax(p["mlp"]), deterministic=True)
    got = int8_mlp.int8_mlp_block(torch.from_numpy(x), _torch(p["ln"]), _torch(p["mlp"]),
                                  deterministic=True)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _update_rel(got, want, x) < BLOCK_TOL


@pytest.mark.parametrize("shape,valid", [((4, 8), None), ((2, 16), 13)], ids=["4x8", "2x16-valid13"])
def test_int8_attn_deterministic_matches_jax(shape, valid):
    p = _block_params()
    x = _f(np.random.default_rng(5), *shape, W)
    want = j_int8_attn_block(jnp.asarray(x), _jax(p["ln"]), _jax(p["attn"]), HEADS, valid_len=valid,
                             deterministic=True)
    got = int8_attn.int8_attn_block(torch.from_numpy(x), _torch(p["ln"]), _torch(p["attn"]), HEADS,
                                    valid_len=valid, deterministic=True)
    assert _update_rel(got, want, x) < BLOCK_TOL


@pytest.mark.parametrize("block", ["mlp", "attn"])
def test_stochastic_blocks_draw_and_repeat(block):
    """The stochastic mode is not a silent round-to-nearest: it differs from
    it, repeats for one seed, changes with the seed, and stays within the
    int8 noise of the round-to-nearest model."""
    p = _block_params()
    x = torch.from_numpy(_f(np.random.default_rng(6), 2, 16, W))
    if block == "mlp":
        run = lambda **kw: int8_mlp.int8_mlp_block(x, _torch(p["ln"]), _torch(p["mlp"]), **kw)  # noqa: E731
    else:
        run = lambda **kw: int8_attn.int8_attn_block(  # noqa: E731
            x, _torch(p["ln"]), _torch(p["attn"]), HEADS, valid_len=13, **kw)
    rtn, a, b, c = run(deterministic=True), run(), run(), run(seed=1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - rtn).abs().max()) > 0 and float((a - c).abs().max()) > 0
    assert _update_rel(a, rtn, x) < 0.05


def test_plain_references_are_the_two_modes():
    p = _block_params()
    x = torch.from_numpy(_f(np.random.default_rng(7), 2, 8, W))
    ln, mlp, attn = _torch(p["ln"]), _torch(p["mlp"]), _torch(p["attn"])
    torch.testing.assert_close(int8_mlp.int8_mlp_reference(x, ln, mlp),
                               int8_mlp.int8_mlp_block(x, ln, mlp, deterministic=True), rtol=0, atol=0)
    torch.testing.assert_close(int8_mlp.int8_mlp_sr_reference(x, ln, mlp, seed=3),
                               int8_mlp.int8_mlp_block(x, ln, mlp, seed=3), rtol=0, atol=0)
    torch.testing.assert_close(int8_attn.int8_attn_reference(x, ln, attn, HEADS, 8),
                               int8_attn.int8_attn_block(x, ln, attn, HEADS, deterministic=True),
                               rtol=0, atol=0)
    torch.testing.assert_close(int8_attn.int8_attn_sr_reference(x, ln, attn, HEADS, 8, seed=3),
                               int8_attn.int8_attn_block(x, ln, attn, HEADS, seed=3), rtol=0, atol=0)


# --- B13 on the tensor cores, emulated: the column-tiled hidden rows ------------


def _emulate_b13(x, gamma, beta, q, *, seed, deterministic, col_tile=128, depth=64):
    """B13 as ``csrc/int8_mlp.cu`` computes it on the int8 tensor cores: the
    weights laid out K-major with zeros past K (``k_major``), each int32 sum
    over ``depth``-byte stages (exact), the fc epilogue per ``col_tile``-column
    tile of the hidden rows with each tile's largest |h| taken on the f32
    bits and the row's max the largest over its tiles (the kernel's
    atomicMax), the hidden codes from that max; then the proj product.
    Returns (yq, t1, h, hq, t2, out)."""
    W = x.shape[-1]
    H = q["w_fc"].shape[1]
    x2 = x.reshape(-1, W)
    R = x2.shape[0]
    Wp, Hp = -(-W // depth) * depth, -(-H // depth) * depth

    def stages(a, bt, K):  # a [R, K] integer-valued, bt [N, Kp] int8: the exact int32 sums
        a = torch.nn.functional.pad(a, (0, bt.shape[1] - K)).double()
        acc = torch.zeros(a.shape[0], bt.shape[0], dtype=torch.float64)
        for k0 in range(0, bt.shape[1], depth):
            acc += a[:, k0:k0 + depth] @ bt[:, k0:k0 + depth].double().T
        return acc.float()

    y = int8_mlp.ln_f32(x2, gamma, beta, 1e-5)
    yq, t1 = int8_mlp.quantize_activations(y, x.dtype, seed, int8_mlp.STREAM_MLP_Y, deterministic,
                                           round_input=True)
    h = int8_mlp.gelu(stages(yq, int8_mlp.k_major(q["w_fc"], Wp), W) * t1 * q["s_fc"] + q["b_fc"])
    tiles = torch.nn.functional.pad(h.abs().view(torch.int32), (0, -H % col_tile))
    amax = tiles.view(R, -1, col_tile).amax(-1).amax(-1, keepdim=True).view(torch.float32)
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
    if deterministic:
        hq = torch.clamp(torch.round(h / scale), -127, 127)
    else:
        u = int8_mlp.uniform_from_bits(int8_mlp.rand_bits(seed, int8_mlp.STREAM_MLP_H, R, H))
        hq = torch.clamp(torch.floor(h / scale + u), -127, 127)
    out = stages(hq, int8_mlp.k_major(q["w_proj"], Hp), H) * scale * q["s_proj"] + q["b_proj"]
    return yq, t1, h, hq, scale, (out + x2.float()).to(x.dtype).reshape(x.shape)


@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "nearest"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,width", [((2, 16), W), ((3, 7), 40), ((1, 9), 160)],
                         ids=["2x16-w128", "3x7-w40", "1x9-w160"])
def test_int8_mlp_column_tiled_codes_equal_the_plain_codes(deterministic, dtype, rows, width):
    """The hidden rows' max taken over column tiles, and the codes and output
    built from it, equal the plain version's bit for bit in both modes (H 4W:
    640 and 160 columns are not multiples of the 128-column tile)."""
    rng = np.random.default_rng(width + rows[1])
    H = 4 * width
    x = torch.from_numpy(_f(rng, *rows, width)).to(dtype)
    gamma, beta = torch.from_numpy(1.0 + _f(rng, width, scale=0.1)), torch.from_numpy(_f(rng, width, scale=0.1))
    q = int8_mlp.quantize_mlp({"w_fc": torch.from_numpy(_f(rng, width, H, scale=width ** -0.5)),
                               "b_fc": torch.from_numpy(_f(rng, H, scale=0.1)),
                               "w_proj": torch.from_numpy(_f(rng, H, width, scale=H ** -0.5)),
                               "b_proj": torch.from_numpy(_f(rng, width, scale=0.1))})
    want = int8_mlp.int8_mlp_plain_parts(x, gamma, beta, q, seed=3, deterministic=deterministic)
    got = _emulate_b13(x, gamma, beta, q, seed=3, deterministic=deterministic)
    for name, a, b in zip(("yq", "t1", "h", "hq", "t2", "out"), got, (want[k] for k in
                                                                     ("yq", "t1", "h", "hq", "t2", "out"))):
        assert torch.equal(a, b), name
    assert float(want["hq"].abs().max()) == 127  # the row max reaches the top code


# --- B14 on the tensor cores, emulated: split attention products, head tiles ---

# chip_smoke.py's INT8_TOL: norm-relative on the block's update.
INT8_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}


def _attn_case(dtype, rows, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(_f(rng, *rows, W)).to(dtype)
    gamma, beta = torch.from_numpy(1.0 + _f(rng, W, scale=0.1)), torch.from_numpy(_f(rng, W, scale=0.1))
    q = int8_attn.quantize_attn({"w_qkv": torch.from_numpy(_f(rng, W, 3 * W, scale=W ** -0.5)),
                                 "b_qkv": torch.from_numpy(_f(rng, 3 * W, scale=0.1)),
                                 "w_out": torch.from_numpy(_f(rng, W, W, scale=W ** -0.5)),
                                 "b_out": torch.from_numpy(_f(rng, W, scale=0.1))})
    return x, gamma, beta, q


@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "nearest"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,valid", [((2, 16), 13), ((3, 24), 24)], ids=["2x16-valid13", "3x24"])
def test_int8_attn_emulated_tensor_core_step_within_the_card_limit(deterministic, dtype, rows, valid):
    """B14 as the card forms it (``split_error.emulate_int8_attn``: q . k^T on
    three bf16 terms, p . v on three or, where the stochastic mode rounds p
    to bf16, one; the codes from the head-tiled row max) against
    ``int8_attn_plain`` within the card's INT8_TOL."""
    x, gamma, beta, q = _attn_case(dtype, rows, 9 + valid)
    want = int8_attn.int8_attn_plain(x, gamma, beta, q, HEADS, valid, seed=3, deterministic=deterministic)
    got = emulate_int8_attn(x, gamma, beta, q, HEADS, valid, seed=3, deterministic=deterministic)
    assert got.dtype == dtype and got.shape == x.shape
    assert _update_rel(got.float(), want.float(), x.float()) <= INT8_TOL[dtype]


@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "nearest"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,valid", [((2, 16), 13), ((3, 24), 24)], ids=["2x16-valid13", "3x24"])
def test_int8_attn_head_tiled_codes_equal_the_plain_codes(deterministic, dtype, rows, valid):
    """The attention output's row max taken over per-head column tiles (B14's
    atomicMax in the attention epilogue), and the codes and scale built from
    it, equal the plain version's bit for bit in both modes."""
    x, gamma, beta, q = _attn_case(dtype, rows, 17 + valid)
    want = int8_attn.int8_attn_plain_parts(x, gamma, beta, q, HEADS, valid, seed=3, deterministic=deterministic)
    aq, t2 = int8_head_tiled_codes(want["a"], HEADS, 3, deterministic)
    assert torch.equal(aq, want["aq"]) and torch.equal(t2, want["t2"])
    assert float(want["aq"].abs().max()) == 127  # the row max reaches the top code


def test_k_major_layout():
    w = torch.arange(-60, 60, dtype=torch.int8).view(10, 12)  # [K, N]
    bt = int8_mlp.k_major(w, 64)
    assert bt.shape == (12, 64) and bt.dtype == torch.int8
    assert torch.equal(bt[:, :10], w.t()) and not bt[:, 10:].any()


@pytest.mark.parametrize("block", ["mlp", "attn"])
def test_int8_blocks_refuse_a_graph(block):
    p = _block_params()
    x = torch.from_numpy(_f(np.random.default_rng(8), 2, 8, W)).requires_grad_()
    ln, mlp, attn = _torch(p["ln"]), _torch(p["mlp"]), _torch(p["attn"])
    call = ((lambda: int8_mlp.int8_mlp_block(x, ln, mlp)) if block == "mlp"
            else (lambda: int8_attn.int8_attn_block(x, ln, attn, HEADS)))
    with pytest.raises(RuntimeError, match="eval only"):
        call()
    with torch.no_grad():
        assert torch.isfinite(call()).all()


# --- routing -------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "fused", "fused_split", "xla", "pallas"])
def test_block_forward_quantizes_whatever_the_impl(impl):
    p = _torch(_block_params())
    blk = {"ln_1": p["ln"], "attn": p["attn"], "ln_2": p["ln"], "mlp": p["mlp"]}
    x = torch.from_numpy(_f(np.random.default_rng(9), 2, 16, W))
    got, aux = tlayers.block_forward(x, blk, HEADS, act="gelu", kv_valid_len=13, impl=impl,
                                     quantize=True, quantize_deterministic=True)
    h = int8_attn.int8_attn_block(x, p["ln"], p["attn"], HEADS, valid_len=13, deterministic=True)
    want = int8_mlp.int8_mlp_block(h, p["ln"], p["mlp"], deterministic=True)
    assert aux is None
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_causal_and_attribution_blocks_keep_float_attention():
    """As ``quantize_attn`` in the JAX package: a causal block, and the block
    with the attribution column, run float attention and the int8 MLP."""
    p = _torch(_block_params())
    blk = {"ln_1": p["ln"], "attn": p["attn"], "ln_2": p["ln"], "mlp": p["mlp"]}
    x = torch.from_numpy(_f(np.random.default_rng(10), 2, 16, W))
    for kw in (dict(causal=True), dict(attn_to_idx=15)):
        got, aux = tlayers.block_forward(x, blk, HEADS, act="gelu", quantize=True,
                                         quantize_deterministic=True, **kw)
        h, want_aux = tlayers.attn_forward(tlayers.layer_norm(x, p["ln"]), p["attn"], HEADS, **kw)
        want = int8_mlp.int8_mlp_block(x + h, p["ln"], p["mlp"], deterministic=True)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert (aux is None) == (want_aux is None)
    # The float block differs from the quantized one.
    plain = attn_block_reference(x, p["ln"]["scale"], p["ln"]["bias"], p["attn"]["w_qkv"],
                                 p["attn"]["b_qkv"], p["attn"]["w_out"], p["attn"]["b_out"],
                                 HEADS, 16, 1e-5)
    assert float((plain - int8_attn.int8_attn_block(x, p["ln"], p["attn"], HEADS)).abs().max()) > 0


# --- the tower ----------------------------------------------------------------


def _spy_keep(monkeypatch):
    """Record the kept indices of both packages' pruning."""
    seen = {"jax": [], "port": []}
    j_top_k, t_keep = jax.lax.top_k, tclip.token_keep_indices

    def j_spy(scores, k):
        out = j_top_k(scores, k)
        seen["jax"].append(np.sort(np.asarray(out[1]), axis=-1))
        return out

    def t_spy(*args):
        idx = t_keep(*args)
        seen["port"].append(np.sort(idx.numpy(), axis=-1))
        return idx

    monkeypatch.setattr(jax.lax, "top_k", j_spy)
    monkeypatch.setattr(tclip, "token_keep_indices", t_spy)
    return seen


@pytest.mark.parametrize("prune", [False, True], ids=["full", "pruned"])
def test_encode_image_int8_deterministic_matches_jax(tiny, prune, monkeypatch):
    jc, jp, tc, tp = tiny
    kw = dict(quantize_tower=True, int8_deterministic=True)
    if prune:
        kw.update(token_keep_ratio=0.8, token_prune_layer=1)
    x = _images(jc)
    seen = _spy_keep(monkeypatch)
    want = jclip.encode_image(jp, jc.replace(**kw), jnp.asarray(x))
    got = tclip.encode_image(tp, tc.replace(**kw), torch.from_numpy(x))
    assert (_cos_rows(got.numpy(), want) >= 0.9999).all()
    if prune:
        assert seen["port"][0].shape == (3, 16)
        np.testing.assert_array_equal(seen["port"][0], seen["jax"][0])


@pytest.mark.parametrize("ratio,n_keep", [(0.5, 8), (0.8, 16)])
def test_token_pruning_matches_jax(tiny, ratio, n_keep, monkeypatch):
    jc, jp, tc, tp = tiny
    x = _images(jc, seed=1)
    seen = _spy_keep(monkeypatch)
    kw = dict(token_keep_ratio=ratio, token_prune_layer=1)
    want = np.asarray(jclip.encode_image(jp, jc.replace(**kw), jnp.asarray(x)))
    got = tclip.encode_image(tp, tc.replace(**kw), torch.from_numpy(x)).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
    assert seen["port"][0].shape == (3, n_keep) and (seen["port"][0][:, 0] == 0).all()
    np.testing.assert_array_equal(seen["port"][0], seen["jax"][0])
    full = tclip.encode_image(tp, tc, torch.from_numpy(x)).numpy()
    assert np.abs(got - full).max() > 0  # pruning is not a no-op


def test_prune_layer_past_the_tower_is_the_full_tower(tiny):
    jc, jp, tc, tp = tiny
    x = torch.from_numpy(_images(jc, seed=2))
    torch.testing.assert_close(tclip.encode_image(tp, tc.replace(token_keep_ratio=0.5, token_prune_layer=9), x),
                               tclip.encode_image(tp, tc, x), rtol=0, atol=0)


def test_stochastic_tower_close_to_float(tiny):
    """As ``tests/test_int8.py``: the int8 tower's features keep cosine > 0.99
    against the float tower (and > 0.98 under pruning)."""
    jc, jp, tc, tp = tiny
    x = torch.from_numpy(_images(jc, n=4, seed=3))
    f = tclip.encode_image(tp, tc, x).numpy()
    q = tclip.encode_image(tp, tc.replace(quantize_tower=True), x).numpy()
    assert (_cos_rows(q, f) > 0.99).all()
    pruned = tc.replace(token_keep_ratio=0.8, token_prune_layer=1)
    fp = tclip.encode_image(tp, pruned, x).numpy()
    qp = tclip.encode_image(tp, pruned.replace(quantize_tower=True), x).numpy()
    assert (_cos_rows(qp, fp) > 0.98).all() and np.abs(qp - fp).max() > 0


def test_image_embed_fn_follows_the_int8_tower(tiny):
    jc, jp, tc, tp = tiny
    from tapclip_tpu.featurize import make_image_embed_fn as j_make_image_embed_fn

    x = _images(jc, n=2, seed=4)
    cfg_q = dict(quantize_tower=True, int8_deterministic=True)
    want = np.asarray(j_make_image_embed_fn(jc.replace(**cfg_q))(jp, jnp.asarray(x)))
    got = make_image_embed_fn(tc.replace(**cfg_q))(tp, x).numpy()
    assert (_cos_rows(got, want) >= 0.9999).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(quantize_tower=True), dict(token_keep_ratio=0.5)])
def test_flags_rejected_for_the_resnet_tower(kw):
    cfg = tcfg.MODEL_PRESETS["RN50"].replace(image_size=64, **kw)
    with pytest.raises(NotImplementedError, match="ViT towers only"):
        tclip.encode_image({"visual": {}}, cfg, torch.zeros(1, 64, 64, 3))


# --- serving and two-path evaluation -----------------------------------------------


def _pair(tiny, **cfg_kw):
    jc, jp, tc, tp = tiny
    jm = JFullModel(CLASSES, jp, jc.replace(**cfg_kw), prompt_cfg=JPromptConfig())
    tm = FullModel(CLASSES, tp, tc.replace(**cfg_kw))
    tm.trainable, tm.prompt_learner.bank = prompt_state_from_jax(
        jax.tree.map(np.asarray, jm.trainable), jax.tree.map(np.asarray, jm.prompt_learner.bank))
    return jm, tm


def test_serve_parses_int8_and_pruning_flags():
    import argparse

    def parsed(*argv):
        ns = argparse.Namespace(model="ViT-B-16", preset=None, int8=False, int8_deterministic=False,
                                token_keep_ratio=1.0)
        for k, v in argv:
            setattr(ns, k, v)
        return server_config(ns)

    cfg = parsed(("int8", True), ("int8_deterministic", True), ("token_keep_ratio", 0.5))
    assert cfg.quantize_tower and cfg.int8_deterministic and cfg.token_keep_ratio == 0.5
    assert not parsed(("int8_deterministic", True)).int8_deterministic  # only with --int8
    assert parsed(("preset", "tiny"), ("int8", True)).name == tcfg.TINY_TEST.name
    dp = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match=f"needs {dp} devices"):  # the flags parse; the replicas need devices
        main(["--int8", "--token-keep-ratio", "0.5", "--dp", str(dp)])


def test_predict_service_int8_matches_jax(tiny):
    """A CPU ``PredictService`` over the quantized deterministic tower serves
    the probabilities of the JAX service (which rounds to nearest off a TPU)."""
    jm, tm = _pair(tiny, quantize_tower=True, int8_deterministic=True)
    jsvc = JPredictService(jm, batch_size=4, max_latency_ms=5.0)
    tsvc = PredictService(tm, batch_size=4, max_latency_ms=5.0)
    try:
        for seed in range(2):
            px = np.random.default_rng(20 + seed).integers(0, 256, (64, 64, 3), dtype=np.uint8)
            want, got = jsvc.predict(px, timeout=300), tsvc.predict(px, timeout=300)
            np.testing.assert_allclose([got["probs"][n] for n in CLASSES],
                                       [want["probs"][n] for n in CLASSES], atol=2e-3)
            assert got["index"] == want["index"]
    finally:
        jsvc.close()
        tsvc.close()


@pytest.mark.parametrize("margin", [np.inf, -np.inf], ids=["inf-full", "minus-inf-cheap"])
def test_adaptive_logits_extremes(tiny, margin):
    from tapclip_tpu_torch.models.model_wrapper import full_model_forward

    _, tm = _pair(tiny, token_prune_layer=1)
    x = _images(tm.clip_cfg, n=4, seed=5)
    logits, stats = adaptive_logits(tm, x, margin=margin, rescue_batch=3)
    cfg = tm.clip_cfg if margin > 0 else tm.clip_cfg.replace(token_keep_ratio=0.5)
    want = full_model_forward(tm.clip_params, tm.trainable, tm.prompt_learner.bank, torch.from_numpy(x),
                              None, clip_cfg=cfg, prompt_cfg=tm.prompt_cfg)["logits"].numpy()
    np.testing.assert_allclose(logits, want, rtol=1e-6, atol=1e-6)
    assert stats["n_rescued"] == (4 if margin > 0 else 0) and stats["n"] == 4


def test_adaptive_logits_matches_jax_at_a_finite_margin(tiny):
    jm, tm = _pair(tiny, token_prune_layer=1)
    x = _images(tm.clip_cfg, n=4, seed=6)
    cheap = np.asarray(j_adaptive_logits(jm, x, margin=-np.inf)[0])[:, :len(CLASSES)]
    full = np.asarray(j_adaptive_logits(jm, x, margin=np.inf)[0])[:, :len(CLASSES)]
    assert np.abs(cheap - full).max() > 1e-3  # the two paths differ
    top2 = np.sort(cheap, axis=-1)[:, -2:]
    margins = np.sort(top2[:, 1] - top2[:, 0])
    margin = float(margins[1] + margins[2]) / 2  # two samples below it, two above
    mask = np.array([True, True, True, False])
    want, jstats = j_adaptive_logits(jm, x, margin=margin, mask=mask)
    got, stats = adaptive_logits(tm, x, margin=margin, mask=mask)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    assert stats == jstats
