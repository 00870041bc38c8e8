"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The file
imports neither jax nor the JAX package, so on a machine with a card and no
jax it runs alone:

    python -m pytest tests/port/test_torch_gpu.py --noconftest -q

The shapes are ragged on purpose (rows and sequence lengths that are not
multiples of the kernels' 16- and 64-wide tiles, every head dim the kernels
take) so that the masked tile edges are exercised.  Tolerances: forward
kernels f32 1e-4 (TF32 off on both sides), bf16 2e-2 compared in f32.  The
backward kernels (B4, B5) are held on each of their seven outputs by the
norm-relative error ||got - want|| / ||want||: f32 1e-5 (only the order of
the f32 sums differs, over up to 1,600 rows and 3,072 hidden columns), bf16
2e-2 (both sides round the same intermediates, but a value on the other side
of a rounding step moves by one bf16 ulp, 2^-8 relative).  B7 is held the
same way on its packed dqkv, and so are the flash backward chain's kernels
(LSE at 1e-5 absolute in both dtypes: f32 math on the same inputs).  The
int8 kernels (B13, B14) are held against their plain versions with the same
random draws, in both modes, by the norm-relative error of the block's
update (out - x): f32 2e-3 (an activation code on the other side of a
rounding step, where LayerNorm's or erf's last bit differs, moves its row by
about 5e-4), bf16 2e-2; the int8 product (S6) exactly.
"""

import numpy as np
import pytest
import torch

from tapclip_tpu_torch.ops.attention import attention_reference
from tapclip_tpu_torch.ops.flash_attention import (
    _flash_bwd_dkv_cuda,
    _flash_bwd_dq_cuda,
    _flash_lse_cuda,
    attention_bwd_dkv_reference,
    attention_bwd_dq_reference,
    attention_bwd_reference,
    attention_delta,
    attention_lse_reference,
    flash_attention_bwd_cuda,
    fused_attention,
)
from tapclip_tpu_torch.ops.fused_mha import (
    _attn_block_bwd_cuda,
    _fused_mha_bwd_cuda,
    attn_block_bwd_reference,
    attn_block_reference,
    fused_attn_block,
    fused_mha,
    fused_mha_bwd_reference,
    fused_mha_reference,
)
from tapclip_tpu_torch.ops.fused_mlp import (
    _fused_mlp_bwd_cuda,
    fused_mlp_block,
    fused_mlp_bwd_reference,
    fused_mlp_reference,
)
from tapclip_tpu_torch.ops.int8_attn import int8_attn_block, int8_attn_plain, quantize_attn
from tapclip_tpu_torch.ops.int8_gemm import int8_gemm, int8_gemm_reference
from tapclip_tpu_torch.ops.int8_mlp import int8_mlp_block, int8_mlp_cuda, int8_mlp_plain, quantize_mlp

DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
BWD_DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def _close(got, want, tol):
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _close_rel(name, got, want, tol):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), name
    err = float((got - want).norm() / want.norm().clamp_min(1e-30))
    assert err <= tol, f"{name}: norm-relative error {err:.3e} > {tol}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,T,W", [(1, 1, 64), (3, 7, 128), (2, 200, 256)])
def test_fused_mlp_kernel(cuda, dtype, tol, B, T, W):
    gen = torch.Generator(device=cuda).manual_seed(B * T + W)
    H = 4 * W
    x = _randn(gen, B, T, W).to(dtype)
    ln = {"scale": 1 + _randn(gen, W, scale=0.1), "bias": _randn(gen, W, scale=0.1)}
    mlp = {"w_fc": _randn(gen, W, H, scale=W ** -0.5), "b_fc": _randn(gen, H, scale=0.1),
           "w_proj": _randn(gen, H, W, scale=H ** -0.5), "b_proj": _randn(gen, W, scale=0.1)}
    with torch.inference_mode():
        n = fused_mlp_block.launches
        got = fused_mlp_block(x, ln, mlp)
        assert fused_mlp_block.launches == n + 1
        want = fused_mlp_reference(x, ln["scale"], ln["bias"], *mlp.values())
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, want, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize(
    "B,T,W,heads,valid",
    [(2, 16, 128, 2, 13), (1, 65, 64, 4, 65), (3, 88, 256, 2, 82), (1, 40, 256, 8, 33),
     (2, 24, 256, 1, 20)],
    ids=["dh64", "dh16-full", "dh128", "dh32", "dh256-unsupported"],
)
def test_fused_attn_block_kernel(cuda, dtype, tol, B, T, W, heads, valid):
    gen = torch.Generator(device=cuda).manual_seed(T + W)
    x = _randn(gen, B, T, W).to(dtype)
    ln = {"scale": 1 + _randn(gen, W, scale=0.1), "bias": _randn(gen, W, scale=0.1)}
    attn = {"w_qkv": _randn(gen, W, 3 * W, scale=W ** -0.5), "b_qkv": _randn(gen, 3 * W, scale=0.1),
            "w_out": _randn(gen, W, W, scale=W ** -0.5), "b_out": _randn(gen, W, scale=0.1)}
    with torch.inference_mode():
        if W // heads > 128:
            with pytest.raises(ValueError, match="head dims"):
                fused_attn_block(x, ln, attn, heads, valid_len=valid)
            return
        got = fused_attn_block(x, ln, attn, heads, valid_len=valid)
        want = attn_block_reference(x, ln["scale"], ln["bias"], *attn.values(), heads, valid, 1e-5)
    _close(got, want, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize(
    "B,H,T,Dh,valid,eot",
    [(2, 2, 16, 64, [13, 9], [12, 5]), (1, 3, 130, 32, [130], [129]),
     (2, 1, 70, 128, [50, 70], [60, 0]), (1, 2, 5, 16, [5], [2]),
     (2, 16, 584, 64, [577, 300], [576, 17])],
    ids=["small", "two-tiles", "eot-past-valid", "tiny", "vit-l-336"],
)
def test_attention_aux_kernel(cuda, dtype, tol, B, H, T, Dh, valid, eot):
    gen = torch.Generator(device=cuda).manual_seed(T * Dh)
    q, k, v = (_randn(gen, B, H, T, Dh).to(dtype) for _ in range(3))
    valid_t = torch.tensor(valid, device=cuda)
    eot_t = torch.tensor(eot, device=cuda)
    with torch.inference_mode():
        got = fused_attention(q, k, v, kv_valid_len=valid_t, attn_to_idx=eot_t)
        want = attention_reference(q, k, v, kv_valid_len=valid_t, attn_to_idx=eot_t)
        no_aux, none = fused_attention(q, k, v, kv_valid_len=valid_t)
    assert none is None and got[1].shape == (B, T) and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        _close(g, w, tol)
    _close(no_aux, got[0], 0.0)


@pytest.mark.gpu
def test_kernels_refuse_grad_and_bad_operands(cuda):
    """K1 and K2 differentiate (their backward is B5 / B4); K3 differentiates
    on the flash chain and its aux column carries no gradient; bad operands
    raise."""
    x = torch.randn(2, 8, 64, device=cuda, requires_grad=True)
    ln = {"scale": torch.ones(64, device=cuda), "bias": torch.zeros(64, device=cuda)}
    mlp = {"w_fc": torch.randn(64, 256, device=cuda), "b_fc": torch.zeros(256, device=cuda),
           "w_proj": torch.randn(256, 64, device=cuda), "b_proj": torch.zeros(64, device=cuda)}
    attn = {"w_qkv": torch.randn(64, 192, device=cuda) * 0.1, "b_qkv": torch.zeros(192, device=cuda),
            "w_out": torch.randn(64, 64, device=cuda) * 0.1, "b_out": torch.zeros(64, device=cuda)}
    n_mlp, n_attn = fused_mlp_block.bwd_launches, fused_attn_block.bwd_launches
    y = fused_mlp_block(fused_attn_block(x, ln, attn, 2, valid_len=7), ln, mlp)
    (dx,) = torch.autograd.grad(y.sum(), [x])
    assert torch.isfinite(dx).all()
    assert (fused_mlp_block.bwd_launches, fused_attn_block.bwd_launches) == (n_mlp + 1, n_attn + 1)
    q = torch.randn(1, 2, 8, 64, device=cuda, requires_grad=True)
    out, aux = fused_attention(q, q, q, attn_to_idx=3)
    assert not aux.requires_grad
    (dq,) = torch.autograd.grad(out.sum(), [q])
    qr = q.detach().clone().requires_grad_()
    (want,) = torch.autograd.grad(attention_reference(qr, qr, qr)[0].sum(), [qr])
    _close_rel("dq", dq, want, 1e-5)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            fused_mlp_block(torch.randn(2, 64, 8, device=cuda).transpose(1, 2), ln, mlp)
        with pytest.raises(TypeError):
            fused_mlp_block(torch.randn(2, 8, 64, device=cuda, dtype=torch.float16), ln, mlp)


NAMES = ("dx", "dgamma", "dbeta", "dw_1", "db_1", "dw_2", "db_2")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", BWD_DTYPES)
@pytest.mark.parametrize("B,T,W", [(1, 1, 64), (3, 7, 128), (2, 200, 256), (8, 88, 512)])
def test_fused_mlp_bwd_kernel(cuda, dtype, tol, B, T, W):
    gen = torch.Generator(device=cuda).manual_seed(B * T + W + 1)
    H = 4 * W
    x, g = _randn(gen, B, T, W).to(dtype), _randn(gen, B, T, W).to(dtype)
    p = (1 + _randn(gen, W, scale=0.1), _randn(gen, W, scale=0.1), _randn(gen, W, H, scale=W ** -0.5),
         _randn(gen, H, scale=0.1), _randn(gen, H, W, scale=H ** -0.5))
    n = fused_mlp_block.bwd_launches
    got = _fused_mlp_bwd_cuda(x, g, *p, eps=1e-5)
    again = _fused_mlp_bwd_cuda(x, g, *p, eps=1e-5)
    dx_only = _fused_mlp_bwd_cuda(x, g, *p, eps=1e-5, weight_grads=False)
    assert fused_mlp_block.bwd_launches == n + 3
    want = fused_mlp_bwd_reference(x, g, *p, 1e-5)
    assert got[0].dtype == dtype and dx_only[1:] == (None,) * 6
    for name, a, b, c in zip(NAMES, got, want, again):
        _close_rel(name, a, b, tol)
        torch.testing.assert_close(c, a, rtol=0, atol=0)  # deterministic: no atomics
    _close_rel("dx without weight grads", dx_only[0], want[0], tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", BWD_DTYPES)
@pytest.mark.parametrize(
    "B,T,W,heads,valid",
    [(2, 16, 128, 2, 13), (1, 65, 64, 4, 65), (3, 88, 256, 2, 82), (1, 40, 256, 8, 33),
     (8, 88, 512, 8, 82), (2, 200, 768, 12, 197)],
    ids=["dh64", "dh16-full", "dh128", "dh32", "text", "image"],
)
def test_fused_attn_block_bwd_kernel(cuda, dtype, tol, B, T, W, heads, valid):
    gen = torch.Generator(device=cuda).manual_seed(T + W + 1)
    x, g = _randn(gen, B, T, W).to(dtype), _randn(gen, B, T, W).to(dtype)
    p = (1 + _randn(gen, W, scale=0.1), _randn(gen, W, scale=0.1), _randn(gen, W, 3 * W, scale=W ** -0.5),
         _randn(gen, 3 * W, scale=0.1), _randn(gen, W, W, scale=W ** -0.5))
    got = _attn_block_bwd_cuda(x, g, *p, heads, valid, 1e-5)
    again = _attn_block_bwd_cuda(x, g, *p, heads, valid, 1e-5)
    dx_only = _attn_block_bwd_cuda(x, g, *p, heads, valid, 1e-5, weight_grads=False)
    want = attn_block_bwd_reference(x, g, *p, heads, valid, 1e-5)
    for name, a, b, c in zip(NAMES, got, want, again):
        _close_rel(name, a, b, tol)
        torch.testing.assert_close(c, a, rtol=0, atol=0)  # deterministic: no atomics
    _close_rel("dx without weight grads", dx_only[0], want[0], tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", BWD_DTYPES)
@pytest.mark.parametrize("B,T,W,heads,valid", [(1, 240, 128, 2, 240), (2, 257, 256, 4, 257),
                                               (1, 577, 256, 4, 577), (1, 584, 1024, 16, 577)],
                         ids=["T240", "vit-l-224", "T577", "vit-l-336"])
def test_fused_attn_block_bwd_long_sequences(cuda, dtype, tol, B, T, W, heads, valid):
    """Past B4's [T, T] tile the Function differentiates the split composition
    (plain projections around B6 and the flash chain); B4 itself refuses."""
    gen = torch.Generator(device=cuda).manual_seed(T + W + 2)
    x, g = _randn(gen, B, T, W).to(dtype), _randn(gen, B, T, W).to(dtype)
    p = [1 + _randn(gen, W, scale=0.1), _randn(gen, W, scale=0.1), _randn(gen, W, 3 * W, scale=W ** -0.5),
         _randn(gen, 3 * W, scale=0.1), _randn(gen, W, W, scale=W ** -0.5), _randn(gen, W, scale=0.1)]
    with pytest.raises(ValueError, match="exceeds its limit"):
        _attn_block_bwd_cuda(x, g, *p[:5], heads, valid, 1e-5)
    leaves = [t.clone().requires_grad_() for t in [x, *p]]
    n = (fused_attn_block.bwd_launches, fused_attention.dq_launches)
    out = fused_attn_block(leaves[0], {"scale": leaves[1], "bias": leaves[2]},
                           dict(zip(("w_qkv", "b_qkv", "w_out", "b_out"), leaves[3:])), heads,
                           valid_len=valid)
    got = torch.autograd.grad(out, leaves, g)
    assert (fused_attn_block.bwd_launches, fused_attention.dq_launches) == (n[0], n[1] + 1)
    want = attn_block_bwd_reference(x, g, *p[:5], heads, valid, 1e-5)
    for name, a, b in zip(NAMES, got, want):
        _close_rel(name, a, b, tol)


@pytest.mark.gpu
def test_tiny_model_train_step_kernel_path_matches_plain(cuda):
    """``loss.backward`` through the tiny model on the card (pixels in):
    kernel routing vs the plain composition, same weights and batches, f32."""
    from tapclip_tpu_torch.config import TINY_TEST, TrainConfig
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.parallel.train_step import init_train_state, make_optimizer, make_train_step
    from tapclip_tpu_torch.serve import build_model

    model = build_model(TINY_TEST, ["Backpack", "Pen", "Mug"], "cuda", seed=0)
    plain = FullModel(model.class_names, model.clip_params, TINY_TEST.replace(attn_impl="xla"))
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((4, 32, 32, 3)).astype(np.float32), rng.integers(0, 3, 4))
               for _ in range(3)]
    mask = np.ones(4, bool)
    results = []
    for m, cfg in ((model, TINY_TEST), (plain, TINY_TEST.replace(attn_impl="xla"))):
        state = init_train_state(model.trainable, make_optimizer(TrainConfig()))
        step = make_train_step(cfg, m.prompt_cfg, use_image_feats=False)
        metrics = []
        for x, labels in batches:
            state, out = step(m.clip_params, state, model.prompt_learner.bank, x, labels, mask)
            metrics.append((float(out["loss"]), float(out["grad_norm"])))
        results.append((metrics, state.params["ctx"].detach()))
    (km, kctx), (pm, pctx) = results
    np.testing.assert_allclose(km, pm, rtol=1e-4, atol=1e-5)
    _close(kctx, pctx, 1e-4)


@pytest.mark.gpu
def test_tiny_model_kernel_path_matches_plain(cuda):
    """The whole model on the card: kernel routing ("auto") vs the plain
    composition ("xla"), same weights, f32."""
    from tapclip_tpu_torch.config import TINY_TEST
    from tapclip_tpu_torch.serve import build_model

    from tapclip_tpu_torch.models.model_wrapper import FullModel

    model = build_model(TINY_TEST, ["Backpack", "Pen", "Mug"], "cuda", seed=0)
    plain = FullModel(model.class_names, model.clip_params, TINY_TEST.replace(attn_impl="xla"))
    px = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    with torch.inference_mode():
        got, want = model(px), plain(px)
    _close(got["logits"], want["logits"], 1e-4)
    _close(got["attribution"], want["attribution"], 1e-4)


# --- B6 / B7: the packed-QKV attention core and its backward; K3 causal ----------

MHA_SHAPES = [(8, 77, 512, 8, 77, True), (8, 80, 512, 8, 77, True), (2, 200, 768, 12, 197, False),
              (2, 200, 768, 12, 197, True), (3, 77, 128, 2, 77, False), (1, 70, 256, 2, 50, True),
              (2, 65, 64, 4, 65, True), (1, 40, 256, 8, 33, False)]
MHA_IDS = ["text77-causal", "text80-valid77-causal", "image200", "image200-causal", "dh64-77",
           "dh128-causal", "dh16-causal", "dh32"]


def _mha_case(cuda, dtype, B, T, W, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return _randn(gen, B, T, 3 * W, scale=0.5).to(dtype), _randn(gen, B, T, W).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,T,W,heads,valid,causal", MHA_SHAPES, ids=MHA_IDS)
def test_fused_mha_kernel(cuda, dtype, tol, B, T, W, heads, valid, causal):
    qkv, _ = _mha_case(cuda, dtype, B, T, W, T + W)
    with torch.inference_mode():
        n = fused_mha.launches
        got = fused_mha(qkv, heads, valid_len=valid, causal=causal)
        assert fused_mha.launches == n + 1
        want = fused_mha_reference(qkv, heads, valid, causal)
    assert got.dtype == dtype and got.shape == (B, T, W)
    _close(got, want, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", BWD_DTYPES)
@pytest.mark.parametrize("B,T,W,heads,valid,causal", MHA_SHAPES, ids=MHA_IDS)
def test_fused_mha_bwd_kernel(cuda, dtype, tol, B, T, W, heads, valid, causal):
    qkv, g = _mha_case(cuda, dtype, B, T, W, T + W + 1)
    n = fused_mha.bwd_launches
    got = _fused_mha_bwd_cuda(qkv, g, heads, valid, causal)
    again = _fused_mha_bwd_cuda(qkv, g, heads, valid, causal)
    assert fused_mha.bwd_launches == n + 2 and got.dtype == dtype and got.shape == qkv.shape
    _close_rel("dqkv", got, fused_mha_bwd_reference(qkv, g, heads, valid, causal), tol)
    torch.testing.assert_close(again, got, rtol=0, atol=0)  # deterministic: no atomics


@pytest.mark.gpu
def test_fused_mha_function_differentiates_on_the_card(cuda):
    """Autograd through B6 / B7 equals autograd through the plain forward."""
    qkv, g = _mha_case(cuda, torch.float32, 4, 77, 512, 3)
    qkv.requires_grad_()
    n = (fused_mha.launches, fused_mha.bwd_launches)
    (got,) = torch.autograd.grad(fused_mha(qkv, 8, causal=True), [qkv], g)
    assert (fused_mha.launches, fused_mha.bwd_launches) == (n[0] + 1, n[1] + 1)
    (want,) = torch.autograd.grad(fused_mha_reference(qkv, 8, 77, True), [qkv], g)
    _close_rel("dqkv", got, want, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", BWD_DTYPES)
@pytest.mark.parametrize("B,T,W,heads,valid,causal", [(1, 240, 128, 2, 240, True), (2, 257, 256, 4, 257, False),
                                                      (1, 577, 256, 4, 577, True), (1, 584, 1024, 16, 577, False)],
                         ids=["T240-causal", "vit-l-224", "T577-causal", "vit-l-336"])
def test_fused_mha_bwd_long_sequences(cuda, dtype, tol, B, T, W, heads, valid, causal):
    """Past B7's [T, T] tile the Function's backward runs the flash chain on
    the packed strides, from the output its forward saved."""
    qkv, g = _mha_case(cuda, dtype, B, T, W, T + 4)
    with pytest.raises(ValueError, match="forward output"):
        _fused_mha_bwd_cuda(qkv, g, heads, valid, causal)
    leaf = qkv.clone().requires_grad_()
    n = (fused_mha.bwd_launches, fused_attention.lse_launches, fused_attention.dkv_launches)
    (got,) = torch.autograd.grad(fused_mha(leaf, heads, valid_len=valid, causal=causal), [leaf], g)
    assert (fused_mha.bwd_launches, fused_attention.lse_launches, fused_attention.dkv_launches) == (
        n[0], n[1] + 1, n[2] + 1)
    assert got.dtype == dtype and got.shape == qkv.shape
    _close_rel("dqkv", got, fused_mha_bwd_reference(qkv, g, heads, valid, causal), tol)
    again = _fused_mha_bwd_cuda(qkv, g, heads, valid, causal,
                                out=fused_mha_reference(qkv, heads, valid, causal).to(dtype))
    _close_rel("dqkv from the plain output", again, got, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize(
    "B,H,T,Dh,valid,eot",
    [(8, 8, 77, 64, [77] * 8, [11, 12, 13, 14, 15, 16, 17, 76]), (2, 3, 130, 32, [130, 100], [129, 50]),
     (1, 2, 5, 16, [5], [2])],
    ids=["idiomatic", "two-tiles", "tiny"],
)
def test_attention_aux_kernel_causal(cuda, dtype, tol, B, H, T, Dh, valid, eot):
    gen = torch.Generator(device=cuda).manual_seed(T * Dh + 1)
    q, k, v = (_randn(gen, B, H, T, Dh).to(dtype) for _ in range(3))
    valid_t, eot_t = torch.tensor(valid, device=cuda), torch.tensor(eot, device=cuda)
    with torch.inference_mode():
        got = fused_attention(q, k, v, causal=True, kv_valid_len=valid_t, attn_to_idx=eot_t)
        want = attention_reference(q, k, v, causal=True, kv_valid_len=valid_t, attn_to_idx=eot_t)
    for g, w in zip(got, want):
        _close(g, w, tol)
    for b, e in enumerate(eot):  # queries before their attribution key: exactly 0
        assert not got[1][b, :e].any()


@pytest.mark.gpu
def test_tiny_model_idiomatic_train_step_kernel_path_matches_plain(cuda):
    """Idiomatic prompt tuning on the card (cached features): the causal
    tower on B6 / K3 / K1 and its backward on B7 / B5 vs the plain path."""
    from tapclip_tpu_torch.config import TINY_TEST, PromptConfig, TrainConfig
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.parallel.train_step import init_train_state, make_optimizer, make_train_step
    from tapclip_tpu_torch.serve import build_model

    pcfg = PromptConfig(text_mode="idiomatic")
    model = build_model(TINY_TEST, ["Backpack", "Pen", "Mug"], "cuda", seed=0)
    rng = np.random.default_rng(1)
    batches = [(rng.standard_normal((4, TINY_TEST.embed_dim)).astype(np.float32), rng.integers(0, 3, 4))
               for _ in range(3)]
    mask = np.ones(4, bool)
    results = []
    for cfg in (TINY_TEST, TINY_TEST.replace(attn_impl="xla")):
        m = FullModel(model.class_names, model.clip_params, cfg, prompt_cfg=pcfg)
        state = init_train_state(m.trainable, make_optimizer(TrainConfig()))
        step = make_train_step(cfg, pcfg)
        n = fused_mha.bwd_launches
        losses = [float(step(m.clip_params, state, m.prompt_learner.bank, x, y, mask)[1]["loss"])
                  for x, y in batches]
        results.append((losses, state.params["ctx"].detach(), fused_mha.bwd_launches - n))
    (kl, kctx, kb7), (pl, pctx, pb7) = results
    assert (kb7, pb7) == (3 * TINY_TEST.text_layers, 0)
    np.testing.assert_allclose(kl, pl, rtol=1e-4, atol=1e-5)
    _close(kctx, pctx, 1e-4)


# --- the flash backward chain: LSE, dK/dV, dQ ------------------------------------

FLASH_SHAPES = [(2, 3, 1, 64, [1, 1]), (2, 2, 77, 64, [77, 60]), (3, 2, 88, 32, [82, 82, 40]),
                (1, 3, 130, 16, [130]), (1, 2, 577, 128, [577]), (1, 2, 2100, 64, [2000])]
FLASH_IDS = ["T1", "T77", "T88-valid82", "T130-dh16", "T577-dh128", "T2100"]


def _flash_case(cuda, dtype, B, H, T, Dh, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [_randn(gen, B, H, T, Dh).to(dtype) for _ in range(4)]


def _close_flash(name, got, want, tol, T):
    """Norm-relative, except dq and dk at T = 1: over one key ds = p (dp - delta)
    is 0 up to rounding on both sides, so they are held at 1e-5 absolute."""
    if T == 1 and not name.endswith("dv"):
        assert float(got.float().abs().max()) <= 1e-5 and float(want.float().abs().max()) <= 1e-5, name
    else:
        _close_rel(name, got, want, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype,tol", BWD_DTYPES)
@pytest.mark.parametrize("B,H,T,Dh,valid", FLASH_SHAPES, ids=FLASH_IDS)
def test_flash_bwd_kernels(cuda, dtype, tol, B, H, T, Dh, valid, causal):
    """Each kernel of the chain against its plain version on the same inputs
    (the plain LSE and delta into both dK/dV and dQ), the chain against the
    single-block formula, and bit-for-bit repeats."""
    q, k, v, g = _flash_case(cuda, dtype, B, H, T, Dh, T * Dh + causal)
    valid_t = torch.tensor(valid, device=cuda, dtype=torch.int32)
    out, _ = attention_reference(q, k, v, causal=causal, kv_valid_len=valid_t)
    lse = attention_lse_reference(q, k, valid_t, causal)
    delta = attention_delta(out, g)
    n = (fused_attention.lse_launches, fused_attention.dkv_launches, fused_attention.dq_launches)
    got_lse = _flash_lse_cuda(q, k, valid_t, causal)
    torch.testing.assert_close(got_lse, lse, rtol=0, atol=1e-5)
    dk, dv = (torch.empty_like(q) for _ in range(2))
    _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, valid_t, causal, dk, dv)
    want_dk, want_dv = attention_bwd_dkv_reference(q, k, v, g, lse, delta, valid_t, causal)
    dq = _flash_bwd_dq_cuda(q, k, v, g, lse, delta, valid_t, causal, torch.empty_like(q))
    assert (fused_attention.lse_launches, fused_attention.dkv_launches, fused_attention.dq_launches) == (
        n[0] + 1, n[1] + 1, n[2] + 1)
    for name, a, b in (("dk", dk, want_dk), ("dv", dv, want_dv),
                       ("dq", dq, attention_bwd_dq_reference(q, k, v, g, lse, delta, valid_t, causal))):
        assert a.dtype == dtype
        _close_flash(name, a, b, tol, T)
    chain = flash_attention_bwd_cuda(q, k, v, out, g, valid_t, causal)
    for name, a, b, c in zip(("dq", "dk", "dv"), chain, attention_bwd_reference(q, k, v, g, valid_t, causal),
                             flash_attention_bwd_cuda(q, k, v, out, g, valid_t, causal)):
        _close_flash(f"chain {name}", a, b, tol, T)
        torch.testing.assert_close(c, a, rtol=0, atol=0)  # deterministic: no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fused_attention_function_differentiates_on_the_card(cuda, causal):
    """Autograd through K3 + the chain equals autograd through the plain
    forward, with the aux column requested and detached."""
    q, k, v, g = _flash_case(cuda, torch.float32, 3, 4, 88, 64, 7 + causal)
    valid = torch.tensor([82, 88, 50], device=cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, aux = fused_attention(*leaves, causal=causal, kv_valid_len=valid, attn_to_idx=81)
    assert not aux.requires_grad
    got = torch.autograd.grad(out, leaves, g)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_reference(*plain, causal=causal, kv_valid_len=valid)[0], plain, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close_rel(name, a, b, 1e-5)


@pytest.mark.gpu
def test_flash_chain_refuses_bad_operands(cuda):
    q, k, v, g = _flash_case(cuda, torch.float32, 1, 2, 16, 64, 9)
    valid = torch.full((1,), 16, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="share q's strides"):
        _flash_lse_cuda(q, torch.zeros(1, 2, 32, 64, device=cuda)[:, :, :16], valid, False)
    with pytest.raises(TypeError):
        _flash_lse_cuda(q, k.to(torch.bfloat16), valid, False)
    with pytest.raises(ValueError, match="head dims"):
        _flash_lse_cuda(q[..., :48].contiguous(), k[..., :48].contiguous(), valid, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _flash_lse_cuda(q.cpu(), k.cpu(), valid, False)
    with pytest.raises(TypeError):
        _flash_lse_cuda(q, k, valid.long(), False)


# --- the int8 eval tower: B13, B14 and the int8 product S6 ---------------------

INT8_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}


def _int8_case(cuda, B, T, W, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    H = 4 * W
    x = _randn(gen, B, T, W)
    ln = {"scale": 1 + _randn(gen, W, scale=0.1), "bias": _randn(gen, W, scale=0.1)}
    mlp = {"w_fc": _randn(gen, W, H, scale=W ** -0.5), "b_fc": _randn(gen, H, scale=0.1),
           "w_proj": _randn(gen, H, W, scale=H ** -0.5), "b_proj": _randn(gen, W, scale=0.1)}
    attn = {"w_qkv": _randn(gen, W, 3 * W, scale=W ** -0.5), "b_qkv": _randn(gen, 3 * W, scale=0.1),
            "w_out": _randn(gen, W, W, scale=W ** -0.5), "b_out": _randn(gen, W, scale=0.1)}
    return x, ln, mlp, attn


def _close_update(name, got, want, x, tol):
    got, want, x = got.float(), want.float(), x.float()
    assert torch.isfinite(got).all(), name
    err = float((got - want).norm() / (want - x).norm())
    assert err <= tol, f"{name}: update norm-relative error {err:.3e} > {tol}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "nearest"])
@pytest.mark.parametrize("B,T,W", [(1, 1, 64), (3, 7, 40), (2, 200, 256), (1, 264, 1024)],
                         ids=["one-row", "ragged-w40", "image-t200", "vit-l-h4096"])
def test_int8_mlp_kernel(cuda, dtype, deterministic, B, T, W):
    x, ln, mlp, _ = _int8_case(cuda, B, T, W, B * T + W)
    x = x.to(dtype)
    q = quantize_mlp(mlp)
    with torch.inference_mode():
        n = int8_mlp_block.launches
        got = int8_mlp_block(x, ln, mlp, deterministic=deterministic)
        assert int8_mlp_block.launches == n + 1
        want = int8_mlp_plain(x, ln["scale"], ln["bias"], q, deterministic=deterministic)
        again = int8_mlp_cuda(x, ln["scale"], ln["bias"], q, deterministic=deterministic)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got, again, rtol=0, atol=0)  # no atomics: repeatable
    _close_update("int8_mlp", got, want, x, INT8_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [dict(erf3=True), dict(recipmul=True), dict(erf3=True, recipmul=True)],
                         ids=["erf3", "recipmul", "both"])
def test_int8_mlp_variants(cuda, variant):
    x, ln, mlp, _ = _int8_case(cuda, 2, 200, 256, 5)
    q = quantize_mlp(mlp)
    with torch.inference_mode():
        n = int8_mlp_block.variant_launches
        got = int8_mlp_cuda(x, ln["scale"], ln["bias"], q, **variant)
        assert int8_mlp_block.variant_launches == n + 1
        want = int8_mlp_plain(x, ln["scale"], ln["bias"], q, **variant)
        base = int8_mlp_cuda(x, ln["scale"], ln["bias"], q)
        with pytest.raises(ValueError, match="stochastic"):
            int8_mlp_cuda(x, ln["scale"], ln["bias"], q, deterministic=True, **variant)
    _close_update("int8_mlp variant", got, want, x, INT8_TOL[torch.float32])
    assert float((got - base).norm() / base.norm()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "nearest"])
@pytest.mark.parametrize("B,T,W,heads,valid", [(2, 16, 128, 2, 13), (1, 65, 64, 4, 65), (3, 96, 768, 12, 96),
                                               (1, 200, 768, 12, 197), (1, 40, 256, 8, 33)],
                         ids=["dh64", "dh16-full", "pruned-t96", "image-t200", "dh32"])
def test_int8_attn_kernel(cuda, dtype, deterministic, B, T, W, heads, valid):
    x, ln, _, attn = _int8_case(cuda, B, T, W, T + W)
    x = x.to(dtype)
    q = quantize_attn(attn)
    with torch.inference_mode():
        n = int8_attn_block.launches
        got = int8_attn_block(x, ln, attn, heads, valid_len=valid, deterministic=deterministic)
        assert int8_attn_block.launches == n + 1
        want = int8_attn_plain(x, ln["scale"], ln["bias"], q, heads, valid, deterministic=deterministic)
    assert got.dtype == dtype and got.shape == x.shape
    _close_update("int8_attn", got, want, x, INT8_TOL[dtype])


@pytest.mark.gpu
def test_int8_blocks_refuse_a_graph_and_bad_operands(cuda):
    x, ln, mlp, attn = _int8_case(cuda, 1, 8, 64, 3)
    with pytest.raises(RuntimeError, match="eval only"):
        int8_mlp_block(x.clone().requires_grad_(), ln, mlp)
    with pytest.raises(RuntimeError, match="eval only"):
        int8_attn_block(x, ln, {k: v.clone().requires_grad_() for k, v in attn.items()}, 2)
    with torch.no_grad():
        with pytest.raises(ValueError, match="head dims"):
            int8_attn_block(x, ln, attn, 3)
        with pytest.raises(TypeError):
            int8_mlp_block(x.half(), ln, mlp)
        with pytest.raises(ValueError, match="shared memory"):
            x2, ln2, mlp2, _ = _int8_case(cuda, 1, 8, 2048, 4)
            int8_mlp_block(x2, ln2, mlp2)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(1, 4, 1), (65, 68, 130), (1600, 768, 3072), (1600, 3072, 768)],
                         ids=["one", "ragged", "b13-fc", "b13-proj"])
def test_int8_gemm_kernel_is_exact(cuda, M, K, N):
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    a = torch.randint(-127, 128, (M, K), generator=gen, device=cuda, dtype=torch.int8)
    b = torch.randint(-127, 128, (K, N), generator=gen, device=cuda, dtype=torch.int8)
    n = int8_gemm.launches
    for out_dtype in (torch.int32, torch.float32):
        got = int8_gemm(a, b, out_dtype=out_dtype)
        assert got.dtype == out_dtype
        torch.testing.assert_close(got, int8_gemm_reference(a, b, out_dtype), rtol=0, atol=0)
    assert int8_gemm.launches == n + 2
    with pytest.raises(ValueError, match="multiple of 4"):
        int8_gemm(a[:, :1].contiguous(), b[:1].contiguous())

