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
of a rounding step moves by one bf16 ulp, 2^-8 relative).
"""

import numpy as np
import pytest
import torch

from tapclip_tpu_torch.ops.attention import attention_reference
from tapclip_tpu_torch.ops.flash_attention import fused_attention
from tapclip_tpu_torch.ops.fused_mha import (
    _attn_block_bwd_cuda,
    attn_block_bwd_reference,
    attn_block_reference,
    fused_attn_block,
)
from tapclip_tpu_torch.ops.fused_mlp import (
    _fused_mlp_bwd_cuda,
    fused_mlp_block,
    fused_mlp_bwd_reference,
    fused_mlp_reference,
)

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
    """K1 and K2 differentiate (their backward is B5 / B4); K3, whose
    backward is not ported, refuses a graph; bad operands raise."""
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
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_attention(q, q, q, attn_to_idx=3)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            fused_mlp_block(torch.randn(2, 64, 8, device=cuda).transpose(1, 2), ln, mlp)
        with pytest.raises(TypeError):
            fused_mlp_block(torch.randn(2, 8, 64, device=cuda, dtype=torch.float16), ln, mlp)


def _close_rel(name, got, want, tol):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), name
    err = float((got - want).norm() / want.norm().clamp_min(1e-30))
    assert err <= tol, f"{name}: norm-relative error {err:.3e} > {tol}"


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
def test_fused_attn_block_bwd_refuses_long_sequences(cuda):
    x = torch.randn(1, 240, 128, device=cuda)
    p = (torch.ones(128, device=cuda), torch.zeros(128, device=cuda), torch.randn(128, 384, device=cuda),
         torch.zeros(384, device=cuda), torch.randn(128, 128, device=cuda))
    with pytest.raises(ValueError, match="exceeds its limit"):
        _attn_block_bwd_cuda(x, x, *p, 2, 240, 1e-5)


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
