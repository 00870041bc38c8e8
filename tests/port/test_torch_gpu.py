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
(LSE at 1e-5 absolute in both dtypes: f32 math on the same inputs).  K3
and the chain run their products on the tensor cores (f32 operands split
into three bf16 terms, ``csrc/flash_mma.cuh``) and are also held at their
tile edges: the attribution key in a later key tile, at or past valid or
after the query, T where the query-tile height changes (15, 33, 63, 129),
every head dim in both dtypes, and B7's packed strides with p rounded at
T 584.  The
int8 kernels (B13, B14) are held against their plain versions with the same
random draws, in both modes, by the norm-relative error of the block's
update (out - x): f32 2e-3 (an activation code on the other side of a
rounding step, where LayerNorm's or erf's last bit differs, moves its row by
about 5e-4), bf16 2e-2; the int8 product (S6) exactly.  K1 and S6 run on the
tensor cores and are also held at their tile edges: K1 at the config widths
that are not multiples of 64 (80, 96), a width that is not a multiple of 8
(68, the 8-byte copies in bf16), ragged row counts and the deep projection
sums of W 768 / H 3,072 and W 1,024 / H 4,096 (where an accumulation bias
would show), both elementwise and by the norm-relative error, and bit for
bit against a second call; S6 at depths that are not multiples of 16 or 32,
M and N off its tiles, rows of A that are not 16-byte aligned, and K 4,096.
K2 and B5 run their products on the tensor cores too (K1's GEMM,
``csrc/gemm_mma.cuh``; K2's attention on K3's tile walk) and are held at
their tile edges: K2 at T not a multiple of 16 or 64, valid = 1, valid < T
and valid = T, every head dim, W 128 to 1,024; B5 at row counts off its
tiles, W 32 to 1,024, each split of dy's depth the wrapper can take, dx
alone and all gradients; each bit for bit against a second call.  K1's
output is held bit for bit against digests of its output taken before its
GEMM moved into the shared header.  B4 runs its three dx products and its
attention core on the tensor cores too and is held at its tiles' edges (T
off the 16-, 32- and 64-row tiles, every head dim, T at
``tapclip_attn_bwd_max_seq``, each split of dy's depth), dx alone bit for
bit against dx with every gradient.  B7 runs on B4's row and column kernels
(on the packed strides, causal or not) and is held at every head dim,
causal and not, T = 1, T off the tiles with valid < T and T at the routing
limit, and against digests of its output (a repeatability pin: its MMAs sum
in another order than the FMA core it replaced).  B13 runs its
two products on the int8 tensor cores and is held at row counts off its
tiles and at H 4,096 in both modes and dtypes, bit for bit against a second
call; its output, and S5's (B13's launches with the erf3 / recipmul
switches), against digests read from the one-launch __dp4a walk they
replaced (B13_BITS, S5_BITS).  B14 runs its two products on the same int8 tiles
and its attention on K2's tensor-core walk, and is held at the image,
pruned and ViT-L/14 shapes in both modes and dtypes, bit for bit against a
second call.  The CoCoOp step (both text modes, CE and kg + ProGrad) runs
its B*C text rows on the kernels against the plain path (1e-4), with the
backward kernels' launches per step; the RN tower's f32 features are held
against float64 convolutions of the same weights (1e-4 norm-relative) with
cuDNN's TF32 switch on before the call and on again after it.  gemm.cu's
products (B4's and B5's weight gradients, on the tensor cores) are held
against ``gemm_reference`` in each layout (none, A transposed, B
transposed), both dtypes, at ragged depths and row counts (1 to 6,401), C
off every tile edge, every split of the rows forced with a bias,
at chip_smoke.py's dW limit 1e-4 sqrt(K) absolute, bit for bit against a
second call; what they refuse raises ValueError.  An MoE block (B6 forward
and B7 backward around the expert bank, ``models/moe.py``) is held against
the plain path fed the kernel path's routing, by the norm-relative error of
its output, load-balance term and every gradient (f32 1e-5, bf16 2e-2).
"""

import hashlib

import numpy as np
import pytest
import torch

from tapclip_tpu_torch.ops import _build
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
    _fused_mha_cuda,
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
from tapclip_tpu_torch.ops.int8_attn import int8_attn_block, int8_attn_cuda, int8_attn_plain, quantize_attn
from tapclip_tpu_torch.ops.int8_gemm import int8_gemm, int8_gemm_reference
from tapclip_tpu_torch.ops.int8_mlp import (
    int8_mlp_block,
    int8_mlp_cuda,
    int8_mlp_plain,
    int8_mlp_variant,
    quantize_mlp,
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


# K1's tile edges: (B, T, W), H = 4 W.
K1_EDGES = [(1, 21, 80), (1, 37, 96), (1, 9, 68), (1, 1, 512), (3, 7, 768), (1, 1601, 768), (8, 200, 768),
            (1, 264, 1024)]
K1_EDGE_IDS = ["w80", "w96", "w68", "r1", "r21", "r1601", "image", "w1024"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,T,W", K1_EDGES, ids=K1_EDGE_IDS)
def test_fused_mlp_kernel_tile_edges(cuda, dtype, tol, B, T, W):
    gen = torch.Generator(device=cuda).manual_seed(B * T + W + 1)
    H = 4 * W
    x = _randn(gen, B, T, W).to(dtype)
    ln = {"scale": 1 + _randn(gen, W, scale=0.1), "bias": _randn(gen, W, scale=0.1)}
    mlp = {"w_fc": _randn(gen, W, H, scale=W ** -0.5), "b_fc": _randn(gen, H, scale=0.1),
           "w_proj": _randn(gen, H, W, scale=H ** -0.5), "b_proj": _randn(gen, W, scale=0.1)}
    with torch.inference_mode():
        n = fused_mlp_block.launches
        got = fused_mlp_block(x, ln, mlp)
        again = fused_mlp_block(x, ln, mlp)
        assert fused_mlp_block.launches == n + 2
        want = fused_mlp_reference(x, ln["scale"], ln["bias"], *mlp.values())
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, want, tol)
    _close_rel("out", got, want, tol)
    torch.testing.assert_close(got, again, rtol=0, atol=0)  # no atomics: repeatable


# sha256 (first 16 hex digits) of K1's output bytes on numpy-seeded inputs
# (``_k1_digest``), read on an NVIDIA H100 80GB HBM3 (CUDA 12.8) from K1 as
# it was before its GEMM moved into csrc/gemm_mma.cuh, which K2 and B5 share:
# the move must not change a bit of K1.  f32 and bf16 at the image shape, a
# ragged one, W 68 (the 8-byte copies in bf16) and the text shape (32-row
# tiles).
K1_BITS = {
    (torch.float32, 8, 200, 768): "65fe4e667d9e7e6c", (torch.float32, 3, 7, 128): "43b3a206802b6a4a",
    (torch.float32, 1, 9, 68): "bc15738254957f0a", (torch.float32, 8, 88, 512): "6ffbde6917f2cc3f",
    (torch.bfloat16, 8, 200, 768): "dbe55a5c9a347c96", (torch.bfloat16, 3, 7, 128): "e231a0354301bcb0",
    (torch.bfloat16, 1, 9, 68): "6640117c6cae8103", (torch.bfloat16, 8, 88, 512): "959ec63b386a7fdb",
}


def _k1_digest(dtype, B, T, W):
    rng = np.random.default_rng(B * T + W)
    H = 4 * W

    def f(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)).cuda()

    x = f(B, T, W).to(dtype)
    ln = {"scale": 1.0 + f(W, scale=0.1), "bias": f(W, scale=0.1)}
    mlp = {"w_fc": f(W, H, scale=W ** -0.5), "b_fc": f(H, scale=0.1), "w_proj": f(H, W, scale=H ** -0.5),
           "b_proj": f(W, scale=0.1)}
    with torch.inference_mode():
        out = fused_mlp_block(x, ln, mlp)
    return hashlib.sha256(out.cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


@pytest.mark.gpu
@pytest.mark.parametrize("key", list(K1_BITS), ids=[f"{str(k[0])[6:]}-{k[1]}x{k[2]}x{k[3]}" for k in K1_BITS])
def test_fused_mlp_kernel_bits_unchanged_by_the_shared_gemm(cuda, key):
    assert _k1_digest(*key) == K1_BITS[key]


@pytest.mark.gpu
def test_fused_mlp_kernel_refuses_unaligned_operands(cuda):
    W = 64
    gen = torch.Generator(device=cuda).manual_seed(5)
    ln = {"scale": 1 + _randn(gen, W, scale=0.1), "bias": _randn(gen, W, scale=0.1)}
    mlp = {"w_fc": _randn(gen, W, 4 * W), "b_fc": _randn(gen, 4 * W), "w_proj": _randn(gen, 4 * W, W),
           "b_proj": _randn(gen, W)}
    x = _randn(gen, 3 * W + 1)[1:].view(1, 3, W)  # contiguous, 4 bytes past a 16-byte boundary
    with torch.inference_mode(), pytest.raises(ValueError, match="aligned"):
        fused_mlp_block(x, ln, mlp)


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


# K2's tile edges (B, T, W, heads, valid): T not a multiple of 16 or 64,
# valid < T, valid = T and valid = 1, every head dim (16, 32, 64, 128), W 128
# to 1,024, and the query-tile heights 16, 32 and 64 (T up to 32, up to 128,
# past).
K2_EDGES = [(3, 13, 128, 8, 1), (2, 33, 128, 1, 33), (2, 65, 256, 8, 40), (2, 77, 512, 8, 77),
            (8, 88, 512, 8, 82), (1, 129, 1024, 8, 100), (8, 200, 768, 12, 197), (1, 264, 1024, 16, 257)]
K2_EDGE_IDS = ["T13-dh16-valid1", "T33-dh128-full", "T65-dh32", "T77-full", "text", "T129-dh128-w1024", "image",
               "vit-l"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,T,W,heads,valid", K2_EDGES, ids=K2_EDGE_IDS)
def test_fused_attn_block_kernel_tile_edges(cuda, dtype, tol, B, T, W, heads, valid):
    """K2 on the tensor cores against its plain version at its tile edges,
    elementwise and norm-relative, padded query rows finite, and bit for bit
    against a second call (no atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(T + W + heads)
    x = _randn(gen, B, T, W).to(dtype)
    ln = {"scale": 1 + _randn(gen, W, scale=0.1), "bias": _randn(gen, W, scale=0.1)}
    attn = {"w_qkv": _randn(gen, W, 3 * W, scale=W ** -0.5), "b_qkv": _randn(gen, 3 * W, scale=0.1),
            "w_out": _randn(gen, W, W, scale=W ** -0.5), "b_out": _randn(gen, W, scale=0.1)}
    with torch.inference_mode():
        n = fused_attn_block.launches
        got = fused_attn_block(x, ln, attn, heads, valid_len=valid)
        again = fused_attn_block(x, ln, attn, heads, valid_len=valid)
        assert fused_attn_block.launches == n + 2
        want = attn_block_reference(x, ln["scale"], ln["bias"], *attn.values(), heads, valid, 1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, want, tol)
    _close_rel("out", got, want, tol)
    torch.testing.assert_close(got, again, rtol=0, atol=0)


@pytest.mark.gpu
def test_fused_attn_block_kernel_refuses_unaligned_operands(cuda):
    W = 64
    gen = torch.Generator(device=cuda).manual_seed(6)
    ln = {"scale": 1 + _randn(gen, W, scale=0.1), "bias": _randn(gen, W, scale=0.1)}
    attn = {"w_qkv": _randn(gen, W, 3 * W, scale=0.1), "b_qkv": _randn(gen, 3 * W),
            "w_out": _randn(gen, W, W, scale=0.1), "b_out": _randn(gen, W)}
    x = _randn(gen, 3 * W + 1)[1:].view(1, 3, W)  # contiguous, 4 bytes past a 16-byte boundary
    with torch.inference_mode(), pytest.raises(ValueError, match="aligned"):
        fused_attn_block(x, ln, attn, 2)


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


# B5's tile edges (B, T, W), H = 4 W: row counts off the 32- and 64-row
# tiles, W 32 to 1,024, the text shape (where the wrapper splits dy's depth
# four ways) and the image shape (no split).
B5_EDGES = [(1, 21, 32), (1, 37, 64), (2, 45, 128), (1, 300, 256), (8, 88, 512), (8, 200, 768), (1, 65, 1024)]
B5_EDGE_IDS = ["w32", "w64", "w128", "w256-r300", "text", "image", "w1024"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", BWD_DTYPES)
@pytest.mark.parametrize("B,T,W", B5_EDGES, ids=B5_EDGE_IDS)
@pytest.mark.parametrize("split", [None, 1, 2, 4], ids=["split-auto", "split1", "split2", "split4"])
def test_fused_mlp_bwd_kernel_tile_edges(cuda, dtype, tol, B, T, W, split):
    """B5 on the tensor cores at its tile edges, with each split of dy's depth
    the wrapper can take: all seven outputs and dx alone against the plain
    backward (norm-relative), each bit for bit against a second call."""
    gen = torch.Generator(device=cuda).manual_seed(B * T + W + 2)
    H = 4 * W
    x, g = _randn(gen, B, T, W).to(dtype), _randn(gen, B, T, W).to(dtype)
    p = (1 + _randn(gen, W, scale=0.1), _randn(gen, W, scale=0.1), _randn(gen, W, H, scale=W ** -0.5),
         _randn(gen, H, scale=0.1), _randn(gen, H, W, scale=H ** -0.5))
    got = _fused_mlp_bwd_cuda(x, g, *p, eps=1e-5, split=split)
    again = _fused_mlp_bwd_cuda(x, g, *p, eps=1e-5, split=split)
    dx_only = _fused_mlp_bwd_cuda(x, g, *p, eps=1e-5, weight_grads=False, split=split)
    dx_again = _fused_mlp_bwd_cuda(x, g, *p, eps=1e-5, weight_grads=False, split=split)[0]
    want = fused_mlp_bwd_reference(x, g, *p, 1e-5)
    for name, a, b, c in zip(NAMES, got, want, again):
        _close_rel(name, a, b, tol)
        torch.testing.assert_close(c, a, rtol=0, atol=0)
    _close_rel("dx without weight grads", dx_only[0], want[0], tol)
    torch.testing.assert_close(dx_again, dx_only[0], rtol=0, atol=0)
    torch.testing.assert_close(dx_only[0], got[0], rtol=0, atol=0)  # the weight gradients' scratch changes no dx


@pytest.mark.gpu
def test_fused_mlp_bwd_kernel_refuses_unaligned_operands_and_splits(cuda):
    W = 64
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = _randn(gen, 1, 3, W)
    p = (1 + _randn(gen, W, scale=0.1), _randn(gen, W, scale=0.1), _randn(gen, W, 4 * W),
         _randn(gen, 4 * W), _randn(gen, 4 * W, W))
    g = _randn(gen, 3 * W + 1)[1:].view(1, 3, W)  # contiguous, 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        _fused_mlp_bwd_cuda(x, g, *p, eps=1e-5)
    with pytest.raises(ValueError, match="split"):
        _fused_mlp_bwd_cuda(x, x, *p, eps=1e-5, split=3)


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
    """Past B4's routing limit the Function differentiates the split
    composition (plain projections around B6, differentiated on B7); B4
    itself refuses."""
    gen = torch.Generator(device=cuda).manual_seed(T + W + 2)
    x, g = _randn(gen, B, T, W).to(dtype), _randn(gen, B, T, W).to(dtype)
    p = [1 + _randn(gen, W, scale=0.1), _randn(gen, W, scale=0.1), _randn(gen, W, 3 * W, scale=W ** -0.5),
         _randn(gen, 3 * W, scale=0.1), _randn(gen, W, W, scale=W ** -0.5), _randn(gen, W, scale=0.1)]
    with pytest.raises(ValueError, match="exceeds its limit"):
        _attn_block_bwd_cuda(x, g, *p[:5], heads, valid, 1e-5)
    leaves = [t.clone().requires_grad_() for t in [x, *p]]
    n = (fused_attn_block.bwd_launches, fused_mha.bwd_launches, fused_attention.dq_launches)
    out = fused_attn_block(leaves[0], {"scale": leaves[1], "bias": leaves[2]},
                           dict(zip(("w_qkv", "b_qkv", "w_out", "b_out"), leaves[3:])), heads,
                           valid_len=valid)
    got = torch.autograd.grad(out, leaves, g)
    assert (fused_attn_block.bwd_launches, fused_mha.bwd_launches, fused_attention.dq_launches) == (
        n[0], n[1] + 1, n[2])
    want = attn_block_bwd_reference(x, g, *p[:5], heads, valid, 1e-5)
    for name, a, b in zip(NAMES, got, want):
        _close_rel(name, a, b, tol)


# B4's tile edges on the tensor cores: the text and image shapes, T not a
# multiple of its 16-, 32- or 64-row query and key tiles (15, 33, 97, 129),
# valid = T and valid < T, every head dim; each split of dy's depth.
B4_EDGES = [(8, 88, 512, 8, 82), (2, 200, 768, 12, 197), (2, 33, 128, 4, 30), (1, 97, 256, 2, 90),
            (3, 15, 64, 4, 15), (1, 129, 512, 8, 129), (2, 65, 256, 2, 60)]
B4_EDGE_IDS = ["text-t88", "image-t200", "t33-dh32", "t97-dh128", "t15-dh16", "t129-dh64", "t65-dh128"]


def _b4_case(cuda, dtype, B, T, W, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x, g = _randn(gen, B, T, W).to(dtype), _randn(gen, B, T, W).to(dtype)
    p = (1 + _randn(gen, W, scale=0.1), _randn(gen, W, scale=0.1), _randn(gen, W, 3 * W, scale=W ** -0.5),
         _randn(gen, 3 * W, scale=0.1), _randn(gen, W, W, scale=W ** -0.5))
    return x, g, p


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", BWD_DTYPES)
@pytest.mark.parametrize("B,T,W,heads,valid", B4_EDGES, ids=B4_EDGE_IDS)
@pytest.mark.parametrize("split", [None, 1, 2, 4], ids=["split-auto", "split1", "split2", "split4"])
def test_fused_attn_block_bwd_kernel_tile_edges(cuda, dtype, tol, B, T, W, heads, valid, split):
    x, g, p = _b4_case(cuda, dtype, B, T, W, T * W + heads)
    got = _attn_block_bwd_cuda(x, g, *p, heads, valid, 1e-5, split=split)
    again = _attn_block_bwd_cuda(x, g, *p, heads, valid, 1e-5, split=split)
    dx_only = _attn_block_bwd_cuda(x, g, *p, heads, valid, 1e-5, weight_grads=False, split=split)
    want = attn_block_bwd_reference(x, g, *p, heads, valid, 1e-5)
    for name, a, b, c in zip(NAMES, got, want, again):
        _close_rel(name, a, b, tol)
        torch.testing.assert_close(c, a, rtol=0, atol=0)  # deterministic: no atomics
    torch.testing.assert_close(dx_only[0], got[0], rtol=0, atol=0)  # o is off dx's path


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", BWD_DTYPES)
@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
def test_fused_attn_block_bwd_kernel_at_its_longest_sequence(cuda, dtype, tol, Dh):
    """B4 at the longest T its autograd Function routes to it
    (``tapclip_attn_bwd_max_seq``), every head dim."""
    T = _build.library().tapclip_attn_bwd_max_seq(Dh)
    heads = 4
    x, g, p = _b4_case(cuda, dtype, 1, T, heads * Dh, T + Dh)
    got = _attn_block_bwd_cuda(x, g, *p, heads, T - 3, 1e-5)
    want = attn_block_bwd_reference(x, g, *p, heads, T - 3, 1e-5)
    for name, a, b in zip(NAMES, got, want):
        _close_rel(name, a, b, tol)


@pytest.mark.gpu
def test_fused_attn_block_bwd_kernel_refuses_unaligned_operands_and_splits(cuda):
    x, g, p = _b4_case(cuda, torch.float32, 1, 3, 64, 7)
    bad = _randn(torch.Generator(device=cuda).manual_seed(0), 3 * 64 + 1)[1:].view(1, 3, 64)
    with pytest.raises(ValueError, match="aligned"):
        _attn_block_bwd_cuda(x, bad, *p, 2, 3, 1e-5)
    with pytest.raises(ValueError, match="split"):
        _attn_block_bwd_cuda(x, g, *p, 2, 3, 1e-5, split=3)


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

# B6's walk on the tensor cores (attn_core_mma.cuh) takes query tiles of 16,
# 32 or 64 rows by T and 64-key tiles: the edges are T on either side of
# each (head dims in turn, causal and not), a valid that ends inside a key
# tile, and ViT-L/14 at 336 px under fused_split.
MHA_EDGES = [(2, T, 4 * Dh, 4, T, causal) for T, Dh in ((16, 16), (17, 32), (32, 64), (33, 128), (64, 16),
                                                       (65, 32), (128, 64), (129, 128)) for causal in (False, True)]
MHA_SHAPES = [(8, 77, 512, 8, 77, True), (8, 80, 512, 8, 77, True), (2, 200, 768, 12, 197, False),
              (2, 200, 768, 12, 197, True), (3, 77, 128, 2, 77, False), (1, 70, 256, 2, 50, True),
              (2, 65, 64, 4, 65, True), (1, 40, 256, 8, 33, False), *MHA_EDGES,
              (2, 150, 256, 4, 100, False), (2, 150, 256, 4, 100, True), (4, 584, 1024, 16, 577, False)]
MHA_IDS = ["text77-causal", "text80-valid77-causal", "image200", "image200-causal", "dh64-77",
           "dh128-causal", "dh16-causal", "dh32",
           *[f"t{c[1]}-dh{c[2] // 4}{'-causal' if c[5] else ''}" for c in MHA_EDGES],
           "t150-valid100", "t150-valid100-causal", "vit-l-336"]


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
def test_fused_mha_kernel_refuses_unaligned_rows(cuda):
    bad = _randn(torch.Generator(device=cuda).manual_seed(0), 8 * 3 * 64 + 1)[1:].view(1, 8, 3 * 64)
    with pytest.raises(ValueError, match="aligned"):
        _fused_mha_cuda(bad, 4, 8, False)


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


# sha256 (first 16 hex digits) of B7's dqkv on numpy-seeded inputs
# (``_b7_digest``, as chip_smoke.py's ``b7_digest``), read on an NVIDIA H100
# 80GB HBM3 (CUDA 12.8) from B7 on B4's row and column kernels: a pin of its
# bits from one build to the next.
B7_BITS = {
    (torch.float32, 8, 77, 512, 8, 77, True): "a82c3e9855c93e5f",
    (torch.float32, 64, 80, 512, 8, 77, True): "6d1e956c1290c697",
    (torch.float32, 8, 200, 768, 12, 197, False): "f0bdb2c3aefe73fa",
    (torch.float32, 3, 33, 128, 4, 30, True): "642afa731dcc659b",
    (torch.float32, 2, 65, 256, 2, 60, False): "ab5f43d16fec2403",
    (torch.float32, 1, 40, 64, 4, 40, False): "63c3861dc60d2846",
    (torch.bfloat16, 8, 77, 512, 8, 77, True): "cb6978e2085f246c",
    (torch.bfloat16, 64, 80, 512, 8, 77, True): "7df55fef41643ce0",
    (torch.bfloat16, 8, 200, 768, 12, 197, False): "222671cec5394ed2",
    (torch.bfloat16, 3, 33, 128, 4, 30, True): "c60fad2de845c8ce",
    (torch.bfloat16, 2, 65, 256, 2, 60, False): "ccca20d9035d3a2c",
    (torch.bfloat16, 1, 40, 64, 4, 40, False): "1716e3256b02dd10",
}


# B6's output on the same qkv (``_b6_digest``, as chip_smoke.py's
# ``b6_digest``), read on an NVIDIA H100 80GB HBM3 (CUDA 12.8) from B6 on
# K2's attention walk (attn_core_mma.cuh): a pin of its bits from one build
# to the next.
B6_BITS = {
    (torch.float32, 8, 77, 512, 8, 77, True): "9447e67875bbebb0",
    (torch.float32, 64, 80, 512, 8, 77, True): "33764a9576056d10",
    (torch.float32, 8, 200, 768, 12, 197, False): "84fd1f078214062a",
    (torch.float32, 3, 33, 128, 4, 30, True): "00661bfed5aaed6d",
    (torch.float32, 2, 65, 256, 2, 60, False): "94748c42073d11d6",
    (torch.float32, 1, 40, 64, 4, 40, False): "c635c9dcea4854a2",
    (torch.bfloat16, 8, 77, 512, 8, 77, True): "a8ca64fd7426702a",
    (torch.bfloat16, 64, 80, 512, 8, 77, True): "26e6b6a12b38aae0",
    (torch.bfloat16, 8, 200, 768, 12, 197, False): "03857513538494d1",
    (torch.bfloat16, 3, 33, 128, 4, 30, True): "2215e8d6e6a74be0",
    (torch.bfloat16, 2, 65, 256, 2, 60, False): "cd0937527bfb660a",
    (torch.bfloat16, 1, 40, 64, 4, 40, False): "fee2d073c94b8979",
}


def _core_case(dtype, B, T, W, valid):
    rng = np.random.default_rng(B * T + W + valid)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().to(dtype)

    return f(B, T, 3 * W), f(B, T, W)


def _sha16(t):
    return hashlib.sha256(t.cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


def _b7_digest(dtype, B, T, W, heads, valid, causal):
    qkv, g = _core_case(dtype, B, T, W, valid)
    with torch.no_grad():
        return _sha16(_fused_mha_bwd_cuda(qkv, g, heads, valid, causal))


def _b6_digest(dtype, B, T, W, heads, valid, causal):
    qkv, _ = _core_case(dtype, B, T, W, valid)
    with torch.no_grad():
        return _sha16(_fused_mha_cuda(qkv, heads, valid, causal))


@pytest.mark.gpu
@pytest.mark.parametrize("key", list(B7_BITS), ids=[f"{str(k[0])[6:]}-{k[1]}x{k[2]}x{k[3]}" for k in B7_BITS])
def test_fused_mha_bwd_kernel_bits_unchanged(cuda, key):
    assert _b7_digest(*key) == B7_BITS[key]


@pytest.mark.gpu
@pytest.mark.parametrize("key", list(B6_BITS), ids=[f"{str(k[0])[6:]}-{k[1]}x{k[2]}x{k[3]}" for k in B6_BITS])
def test_fused_mha_kernel_bits_unchanged(cuda, key):
    assert _b6_digest(*key) == B6_BITS[key]


# B7's tile edges on the tensor cores (B4's row and column kernels on the
# packed strides): every head dim, causal and not, T = 1, T off the 16-, 32-
# and 64-row tiles with valid < T, and T at B4's routing limit
# (``tapclip_attn_bwd_max_seq``).
B7_EDGE_CASES = ["t1", "t97-valid90", "limit"]


def _b7_edge(case, Dh):
    if case == "t1":
        return 2, 1, 1
    if case == "t97-valid90":
        return 2, 97, 90
    T = _build.library().tapclip_attn_bwd_max_seq(Dh)
    return 1, T, T - 3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", BWD_DTYPES)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
@pytest.mark.parametrize("case", B7_EDGE_CASES)
def test_fused_mha_bwd_kernel_tile_edges(cuda, dtype, tol, causal, Dh, case):
    B, T, valid = _b7_edge(case, Dh)
    heads = 2
    qkv, g = _mha_case(cuda, dtype, B, T, heads * Dh, T + Dh + int(causal))
    got = _fused_mha_bwd_cuda(qkv, g, heads, valid, causal)
    again = _fused_mha_bwd_cuda(qkv, g, heads, valid, causal)
    assert got.dtype == dtype and got.shape == qkv.shape
    _close_rel("dqkv", got, fused_mha_bwd_reference(qkv, g, heads, valid, causal), tol)
    torch.testing.assert_close(again, got, rtol=0, atol=0)  # deterministic: no atomics


@pytest.mark.gpu
def test_fused_mha_bwd_kernel_refuses_unaligned_rows(cuda):
    qkv, g = _mha_case(cuda, torch.float32, 1, 8, 64, 9)
    bad = _randn(torch.Generator(device=cuda).manual_seed(0), 8 * 64 + 1)[1:].view(1, 8, 64)
    with pytest.raises(ValueError, match="aligned"):
        _fused_mha_bwd_cuda(qkv, bad, 4, 8, False)


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
    """Past B4's routing limit the Function's backward still runs B7's
    kernels (they take every T), from qkv alone: no flash-chain launch."""
    qkv, g = _mha_case(cuda, dtype, B, T, W, T + 4)
    leaf = qkv.clone().requires_grad_()
    n = (fused_mha.bwd_launches, fused_attention.lse_launches, fused_attention.dkv_launches)
    (got,) = torch.autograd.grad(fused_mha(leaf, heads, valid_len=valid, causal=causal), [leaf], g)
    assert (fused_mha.bwd_launches, fused_attention.lse_launches, fused_attention.dkv_launches) == (
        n[0] + 1, n[1], n[2])
    assert got.dtype == dtype and got.shape == qkv.shape
    _close_rel("dqkv", got, fused_mha_bwd_reference(qkv, g, heads, valid, causal), tol)
    torch.testing.assert_close(_fused_mha_bwd_cuda(qkv, g, heads, valid, causal), got, rtol=0, atol=0)


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


# K3 on the tensor cores at its tile edges: the attribution key in the second
# key tile, at and past valid, after the query under causal; T 15, 33, 63 and
# 129, where the query-tile height (16, 32, 64 rows) and the key-tile count
# change.  The aux column is f32 math on both sides, held at the f32 limit in
# both dtypes.
K3_EDGES = [(2, 2, 100, 64, [100, 90], [70, 64], False), (2, 2, 100, 64, [80, 64], [80, 64], False),
            (2, 2, 100, 64, [80, 60], [99, 70], False), (2, 2, 200, 64, [200, 150], [150, 149], True),
            (2, 3, 15, 64, [15, 11], [14, 3], False), (2, 3, 15, 32, [15, 15], [10, 14], True),
            (2, 3, 63, 64, [63, 40], [62, 39], False), (2, 3, 63, 128, [63, 63], [30, 62], True),
            (1, 2, 33, 32, [33], [32], True), (1, 2, 129, 16, [129], [128], False)]
K3_EDGE_IDS = ["eot-tile2", "eot-at-valid", "eot-past-valid", "eot-after-query-causal", "T15", "T15-causal",
               "T63", "T63-causal", "T33-causal", "T129"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,H,T,Dh,valid,eot,causal", K3_EDGES, ids=K3_EDGE_IDS)
def test_attention_aux_kernel_tile_edges(cuda, dtype, tol, B, H, T, Dh, valid, eot, causal):
    gen = torch.Generator(device=cuda).manual_seed(T * Dh + 7)
    q, k, v = (_randn(gen, B, H, T, Dh).to(dtype) for _ in range(3))
    valid_t = torch.tensor(valid, device=cuda, dtype=torch.int32)
    eot_t = torch.tensor(eot, device=cuda, dtype=torch.int32)
    with torch.inference_mode():
        got = fused_attention(q, k, v, causal=causal, kv_valid_len=valid_t, attn_to_idx=eot_t)
        want = attention_reference(q, k, v, causal=causal, kv_valid_len=valid_t, attn_to_idx=eot_t)
    _close(got[0], want[0], tol)
    _close(got[1], want[1], DTYPES[0][1])
    for b, e in enumerate(eot):
        if e >= valid[b]:  # a masked attribution key: exactly 0
            assert not got[1][b].any()
        if causal:  # queries before their attribution key: exactly 0
            assert not got[1][b, :e].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_aux_kernel_takes_ints_and_int32_as_given(cuda, dtype):
    """An int or an int32 tensor on the card reaches K3 as it is (no fill or
    cast launch); every form gives the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (_randn(gen, 3, 2, 90, 64).to(dtype) for _ in range(3))
    with torch.inference_mode():
        want = fused_attention(q, k, v, kv_valid_len=80, attn_to_idx=79)
        for valid, eot in ((torch.full((3,), 80, device=cuda, dtype=torch.int32),
                            torch.full((3,), 79, device=cuda, dtype=torch.int32)),
                           (torch.full((3,), 80, device=cuda), torch.tensor([79] * 3))):
            got = fused_attention(q, k, v, kv_valid_len=valid, attn_to_idx=eot)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        _close(want[0], attention_reference(q, k, v, kv_valid_len=80)[0], DTYPES[dtype != torch.float32][1])


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

# T 15, 63 and 65: one row short of a 16- and a 64-row tile, and one past it.
FLASH_SHAPES = [(2, 3, 1, 64, [1, 1]), (2, 2, 77, 64, [77, 60]), (3, 2, 88, 32, [82, 82, 40]),
                (1, 3, 130, 16, [130]), (1, 2, 577, 128, [577]), (1, 2, 2100, 64, [2000]),
                (2, 2, 15, 64, [15, 9]), (2, 2, 63, 32, [63, 40]), (1, 2, 65, 128, [64])]
FLASH_IDS = ["T1", "T77", "T88-valid82", "T130-dh16", "T577-dh128", "T2100", "T15", "T63", "T65-dh128"]


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
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype,tol", BWD_DTYPES)
@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
def test_flash_kernels_every_head_dim(cuda, dtype, tol, Dh, causal):
    """K3 and the chain at every head dim, in both dtypes, at a ragged T with
    per-row valid lengths (three key tiles)."""
    B, H, T = 2, 2, 150
    q, k, v, g = _flash_case(cuda, dtype, B, H, T, Dh, Dh + causal)
    valid = torch.tensor([150, 101], device=cuda, dtype=torch.int32)
    eot = torch.tensor([149, 100], device=cuda, dtype=torch.int32)
    with torch.inference_mode():
        got = fused_attention(q, k, v, causal=causal, kv_valid_len=valid, attn_to_idx=eot)
        want = attention_reference(q, k, v, causal=causal, kv_valid_len=valid, attn_to_idx=eot)
    _close(got[0], want[0], DTYPES[dtype != torch.float32][1])
    _close(got[1], want[1], DTYPES[0][1])
    torch.testing.assert_close(_flash_lse_cuda(q, k, valid, causal), attention_lse_reference(q, k, valid, causal),
                               rtol=0, atol=1e-5)
    out = want[0]
    chain = flash_attention_bwd_cuda(q, k, v, out, g, valid, causal)
    for name, a, b in zip(("dq", "dk", "dv"), chain, attention_bwd_reference(q, k, v, g, valid, causal)):
        _close_rel(f"chain {name}", a, b, tol)


@pytest.mark.gpu
def test_flash_kernels_refuse_unaligned_rows(cuda):
    """The 16-byte copies need 16-byte aligned rows: a row stride or a start
    that is not raises."""
    valid = torch.full((1,), 16, device=cuda, dtype=torch.int32)
    q = torch.randn(1, 2, 16, 66, device=cuda)[..., :64]  # rows 264 bytes apart
    with pytest.raises(ValueError, match="16-byte aligned"):
        _flash_lse_cuda(q, q, valid, False)
    off = torch.randn(2 * 16 * 64 + 1, device=cuda)[1:].view(1, 2, 16, 64)  # starts 4 bytes in
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_attention(off, off, off)


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


# B13 at its tile edges: rows off the 64- and 128-row tiles (8 x 97, 5 x 33,
# 3 x 7), widths off the 128-column tile and the 64-byte depth (40, 64, 256:
# H 160, 256, 1,024), the image and pruned shapes and ViT-L/14's H 4,096.
B13_EDGES = [(8, 200, 768), (8, 96, 768), (8, 97, 256), (5, 33, 64), (3, 7, 40), (1, 264, 1024)]
B13_EDGE_IDS = ["image", "pruned-t96", "rows776", "rows165-w64", "rows21-w40", "vit-l-h4096"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "nearest"])
@pytest.mark.parametrize("B,T,W", B13_EDGES, ids=B13_EDGE_IDS)
def test_int8_mlp_kernel_tile_edges(cuda, dtype, deterministic, B, T, W):
    x, ln, mlp, _ = _int8_case(cuda, B, T, W, B * T + W + 1)
    x = x.to(dtype)
    q = quantize_mlp(mlp)
    with torch.inference_mode():
        n = (int8_mlp_block.launches, int8_mlp_block.variant_launches)
        got = int8_mlp_cuda(x, ln["scale"], ln["bias"], q, deterministic=deterministic)
        assert (int8_mlp_block.launches, int8_mlp_block.variant_launches) == (n[0] + 1, n[1])
        again = int8_mlp_cuda(x, ln["scale"], ln["bias"], q, deterministic=deterministic)
        want = int8_mlp_plain(x, ln["scale"], ln["bias"], q, deterministic=deterministic)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got, again, rtol=0, atol=0)  # the row max's atomicMax is order-free
    _close_update("int8_mlp", got, want, x, INT8_TOL[dtype])


# sha256 (first 16 hex digits) of B13's output and of S5's on numpy-seeded
# inputs (``_int8_digest``, chip_smoke.py's ``int8_digest``), read on an NVIDIA
# H100 80GB HBM3 (CUDA 12.8) from the one-launch __dp4a walk they replaced:
# B13 and its erf3 / recipmul variants compute the walk's output bit for bit.
B13_BITS = {
    (torch.float32, 8, 200, 768, False): "8c913bffae042f87", (torch.float32, 8, 200, 768, True): "66947e655d7d0570",
    (torch.float32, 8, 96, 768, False): "3832de6fd320c93e", (torch.float32, 8, 96, 768, True): "14ad70f7ed2553c6",
    (torch.bfloat16, 8, 200, 768, False): "bd554d64868b2041", (torch.bfloat16, 8, 200, 768, True): "2e721ce47880fac7",
    (torch.bfloat16, 8, 96, 768, False): "7c5ebeb9c6e15878", (torch.bfloat16, 8, 96, 768, True): "9162abaa2145d705",
}
S5_BITS = {
    (torch.float32, 8, 200, 768, "erf3"): "e6a30f135cf95c4f",
    (torch.float32, 8, 200, 768, "recipmul"): "23d5e41277b55b60",
    (torch.float32, 8, 200, 768, "both"): "59107892337da71b",
    (torch.float32, 8, 96, 768, "erf3"): "2d607926aaf19fb4",
    (torch.float32, 8, 96, 768, "recipmul"): "1f7b4dbaa320a6aa",
    (torch.float32, 8, 96, 768, "both"): "63e45655e72025f6",
    (torch.bfloat16, 8, 200, 768, "erf3"): "46717f37f4bb3073",
    (torch.bfloat16, 8, 200, 768, "recipmul"): "0d4a91f9c211a865",
    (torch.bfloat16, 8, 200, 768, "both"): "ee55b90dbfd4a6fa",
    (torch.bfloat16, 8, 96, 768, "erf3"): "aec8d14576755f6c",
    (torch.bfloat16, 8, 96, 768, "recipmul"): "2effef75b68aa9c4",
    (torch.bfloat16, 8, 96, 768, "both"): "c3f1f07b23024927",
}
S5_FLAGS = {"erf3": dict(erf3=True), "recipmul": dict(recipmul=True), "both": dict(erf3=True, recipmul=True)}


def _int8_digest(dtype, B, T, W, **flags):
    rng = np.random.default_rng(B * T + W + 13)
    H = 4 * W

    def f(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)).cuda()

    x = f(B, T, W).to(dtype)
    gamma, beta = 1.0 + f(W, scale=0.1), f(W, scale=0.1)
    q = quantize_mlp({"w_fc": f(W, H, scale=W ** -0.5), "b_fc": f(H, scale=0.1), "w_proj": f(H, W, scale=H ** -0.5),
                      "b_proj": f(W, scale=0.1)})
    with torch.inference_mode():
        if flags.get("erf3") or flags.get("recipmul"):
            out = int8_mlp_variant(x, gamma, beta, q, **flags)
        else:
            out = int8_mlp_cuda(x, gamma, beta, q, **flags)
    return hashlib.sha256(out.cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


@pytest.mark.gpu
@pytest.mark.parametrize("key", list(B13_BITS), ids=[f"{str(k[0])[6:]}-{k[1]}x{k[2]}x{k[3]}-"
                                                      f"{'nearest' if k[4] else 'stochastic'}" for k in B13_BITS])
def test_int8_mlp_kernel_equals_the_walk_bit_for_bit(cuda, key):
    assert _int8_digest(*key[:4], deterministic=key[4]) == B13_BITS[key]


@pytest.mark.gpu
@pytest.mark.parametrize("key", list(S5_BITS), ids=[f"{str(k[0])[6:]}-{k[1]}x{k[2]}x{k[3]}-{k[4]}" for k in S5_BITS])
def test_int8_mlp_variants_equal_the_walk_bit_for_bit(cuda, key):
    assert _int8_digest(*key[:4], **S5_FLAGS[key[4]]) == S5_BITS[key]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", list(S5_FLAGS.values()), ids=list(S5_FLAGS))
def test_int8_mlp_variants(cuda, variant, dtype):
    x, ln, mlp, _ = _int8_case(cuda, 2, 200, 256, 5)
    x = x.to(dtype)
    q = quantize_mlp(mlp)
    with torch.inference_mode():
        n = (int8_mlp_block.launches, int8_mlp_block.variant_launches)
        got = int8_mlp_variant(x, ln["scale"], ln["bias"], q, **variant)
        assert (int8_mlp_block.launches, int8_mlp_block.variant_launches) == (n[0], n[1] + 1)
        again = int8_mlp_variant(x, ln["scale"], ln["bias"], q, **variant)
        want = int8_mlp_plain(x, ln["scale"], ln["bias"], q, **variant)
        b13 = int8_mlp_cuda(x, ln["scale"], ln["bias"], q)  # the parent
        base = int8_mlp_variant(x, ln["scale"], ln["bias"], q)  # no switch: B13's own launches
        with pytest.raises(ValueError, match="stochastic"):
            int8_mlp_variant(x, ln["scale"], ln["bias"], q, deterministic=True, **variant)
    torch.testing.assert_close(got, again, rtol=0, atol=0)
    torch.testing.assert_close(base, b13, rtol=0, atol=0)
    _close_update("int8_mlp variant", got, want, x, INT8_TOL[dtype])
    assert float((got.float() - b13.float()).norm() / b13.float().norm()) <= 1e-3


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


# B14 at the main path's shapes: ViT-B/16's image blocks (8 x 200, valid 197),
# the pruned back blocks (8 x 96, no mask) and ViT-L/14 (8 x 264, W 1,024, 16
# heads, valid 257), each repeatable bit for bit.
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "nearest"])
@pytest.mark.parametrize("B,T,W,heads,valid", [(8, 200, 768, 12, 197), (8, 96, 768, 12, 96),
                                               (8, 264, 1024, 16, 257)],
                         ids=["image", "pruned", "vit-l"])
def test_int8_attn_kernel_model_shapes(cuda, dtype, deterministic, B, T, W, heads, valid):
    x, ln, _, attn = _int8_case(cuda, B, T, W, T + W + 3)
    x = x.to(dtype)
    q = quantize_attn(attn)
    with torch.inference_mode():
        got = int8_attn_cuda(x, ln["scale"], ln["bias"], q, heads, valid, deterministic=deterministic)
        again = int8_attn_cuda(x, ln["scale"], ln["bias"], q, heads, valid, deterministic=deterministic)
        want = int8_attn_plain(x, ln["scale"], ln["bias"], q, heads, valid, deterministic=deterministic)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(again, got, rtol=0, atol=0)  # the row max's atomicMax is order-free
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
        # B13 keeps the hidden rows in device memory and takes the width.
        x2, ln2, mlp2, _ = _int8_case(cuda, 1, 8, 2048, 4)
        q2 = quantize_mlp(mlp2)
        _close_update("int8_mlp W 2048", int8_mlp_block(x2, ln2, mlp2),
                      int8_mlp_plain(x2, ln2["scale"], ln2["bias"], q2), x2, INT8_TOL[torch.float32])


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


# S6's tile edges: (M, K, N, offset of A's rows past a 16-byte boundary).
S6_EDGES = [(5, 4, 7, 0), (33, 36, 40, 0), (70, 100, 129, 0), (129, 64, 257, 0), (130, 4096, 200, 0),
            (64, 48, 64, 4), (300, 768, 96, 0), (2001, 100, 3001, 0)]
S6_EDGE_IDS = ["k4", "k36", "k100", "m129-n257", "k4096", "a-unaligned", "small-grid", "big-ragged"]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,off", S6_EDGES, ids=S6_EDGE_IDS)
def test_int8_gemm_kernel_tile_edges(cuda, M, K, N, off):
    gen = torch.Generator(device=cuda).manual_seed(M * K + N)
    a = torch.randint(-128, 128, (M * K + off,), generator=gen, device=cuda, dtype=torch.int8)[off:].view(M, K)
    b = torch.randint(-128, 128, (K, N), generator=gen, device=cuda, dtype=torch.int8)
    for out_dtype in (torch.int32, torch.float32):
        got = int8_gemm(a, b, out_dtype=out_dtype)
        again = int8_gemm(a, b, out_dtype=out_dtype)
        torch.testing.assert_close(got, int8_gemm_reference(a, b, out_dtype), rtol=0, atol=0)
        torch.testing.assert_close(got, again, rtol=0, atol=0)



# --- the A/B variants: S2 (K1's), S3/S4 (K2's), S1 (the fused layer) ---------------

from tapclip_tpu_torch.ops.fused_layer import fused_layer, fused_layer_reference  # noqa: E402
from tapclip_tpu_torch.ops.fused_mha import (  # noqa: E402
    ATTN_K2_EQUAL,
    attn_block_variant,
    attn_block_variant_reference,
    attn_variant_kernel,
    attn_variant_switches,
)
from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_variant, fused_mlp_variant_reference  # noqa: E402
from tapclip_tpu_torch.scripts import attn_kernel_ab, attn_softmax_ab, mlp_kernel_ab  # noqa: E402

# The "bf16" softmax rounds (s - m) to bf16 before exp2: an f32 ulp of
# difference in s moves p by a bf16 step, so in f32 it is held at 1e-3.
BF16_SOFTMAX_F32_TOL = 1e-3


def _layer_case(cuda, B, T, W, seed):
    x, ln, mlp, attn = _int8_case(cuda, B, T, W, seed)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    ln2 = {"scale": 1 + _randn(gen, W, scale=0.1), "bias": _randn(gen, W, scale=0.1)}
    return x, ln, attn, ln2, mlp


def _distinct(variants, flags_of):
    """The first variant of each port configuration."""
    seen = {}
    for name, kw in variants.items():
        seen.setdefault(tuple(sorted(flags_of(kw).items())), name)
    return sorted(seen.values())


S2_NAMES = _distinct(mlp_kernel_ab.VARIANTS, mlp_kernel_ab.port_flags)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,T,W", [(3, 7, 128), (2, 200, 768)], ids=["ragged", "image-t200"])
@pytest.mark.parametrize("name", S2_NAMES)
def test_mlp_variant_kernels(cuda, dtype, tol, B, T, W, name):
    x, ln, mlp, _ = _int8_case(cuda, B, T, W, T + W)
    x = x.to(dtype)
    args = (x, ln["scale"], ln["bias"], *mlp.values())
    flags = mlp_kernel_ab.port_flags(mlp_kernel_ab.VARIANTS[name])
    with torch.inference_mode():
        n = fused_mlp_variant.launches
        got = fused_mlp_variant(*args, **flags)
        assert fused_mlp_variant.launches == n + 1
        want = fused_mlp_variant_reference(*args, **flags)
        again = fused_mlp_variant(*args, **flags)
        parent = fused_mlp_block(x, ln, mlp)  # K1, S2's parent
    _close(got, want, tol)
    torch.testing.assert_close(got, again, rtol=0, atol=0)  # no atomics: repeatable
    if name in mlp_kernel_ab.SCHEDULE_ONLY:  # K1's own launches, or its schedule with 128-row tiles: K1 bit for bit
        torch.testing.assert_close(got, parent, rtol=0, atol=0)


def _attn_variant_cases():
    s3 = {n: attn_kernel_ab.port_flags(*attn_kernel_ab.VARIANTS[n], 12) for n in
          _distinct(attn_kernel_ab.VARIANTS, lambda v: attn_kernel_ab.port_flags(*v, 12))}
    s4 = {n: attn_softmax_ab.port_flags(attn_softmax_ab.VARIANTS[n], 12) for n in
          _distinct(attn_softmax_ab.VARIANTS, lambda v: attn_softmax_ab.port_flags(v, 12))}
    return [pytest.param(f, id=f"s3-{n}") for n, f in s3.items()] + [pytest.param(f, id=f"s4-{n}") for n, f in s4.items()]


# Variants the card runs as K2's code (ops/fused_mha.py::ATTN_K2_EQUAL: "K2",
# or "K2 group", its tile function over a head group): they equal K2
# (fused_attn_block) bit for bit.  S4's flags-off kernel is K2 itself;
# mask_mode "tail" selects where K2's walk selects; group_heads is the
# schedule alone.  In f32 also the variants whose only numeric switches round
# to the dtype (qk_cast, sum_mxu, S3's q and k with softmax_opt True):
# rounding to f32 changes nothing.
K2_EQUAL = [dict(form="softmax"), dict(form="softmax", mask_mode="tail"), dict(form="softmax", group_heads=2)]
K2_EQUAL_F32 = [dict(form="softmax", qk_cast=True), dict(form="softmax", sum_mxu=True),
                dict(form="softmax", qk_cast=True, mask_mode="tail", sum_mxu=True),
                dict(form="variant", softmax_opt=True)]
# perhead_qkv with K2's softmax runs its own kernel ("perhead online") on
# K2's arithmetic, l alpha summed with the first p in one fma as K2 sums them:
# K2 bit for bit in both dtypes.
K2_ARITHMETIC = [dict(form="variant", perhead_qkv=True, softmax_opt=True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,T,W,heads,valid", [(2, 136, 128, 2, 130), (1, 200, 768, 12, 197), (3, 24, 256, 4, 17)],
                         ids=["t136", "image-t200", "t24"])
@pytest.mark.parametrize("flags", _attn_variant_cases())
def test_attn_variant_kernels(cuda, dtype, tol, B, T, W, heads, valid, flags):
    flags = dict(flags, group_heads=min(flags["group_heads"], heads))
    x, ln, _, attn = _int8_case(cuda, B, T, W, T + W)
    x = x.to(dtype)
    if flags.get("softmax_opt") == "bf16" and dtype == torch.float32:
        tol = BF16_SOFTMAX_F32_TOL
    with torch.inference_mode():
        n = attn_block_variant.launches
        got = attn_block_variant(x, ln, attn, heads, valid, **flags)
        assert attn_block_variant.launches == n + 1
        want = attn_block_variant_reference(x, *ln.values(), *attn.values(), heads, valid, **flags)
        again = attn_block_variant(x, ln, attn, heads, valid, **flags)
        k2 = fused_attn_block(x, ln, attn, heads, valid_len=valid)  # the parent
    _close(got, want, tol)
    torch.testing.assert_close(got, again, rtol=0, atol=0)  # no atomics: repeatable
    rest = {k: v for k, v in flags.items() if k != "form"}
    config = attn_variant_kernel(attn_variant_switches(flags["form"], T, valid, heads, **rest), dtype)
    pinned = K2_EQUAL + (K2_EQUAL_F32 if dtype == torch.float32 else [])
    if any(flags == dict(attn_softmax_ab.port_flags({}, heads), **k) or
           flags == dict(attn_kernel_ab.port_flags("run_variant", {}, heads), **k) for k in pinned):
        assert config in ATTN_K2_EQUAL, config
    if config in ATTN_K2_EQUAL or any(flags == dict(attn_kernel_ab.port_flags("run_variant", {}, heads), **k)
                                      for k in K2_ARITHMETIC):
        torch.testing.assert_close(got, k2, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,T,W,heads,valid", [(2, 200, 768, 12, 197), (3, 37, 128, 2, 30), (1, 264, 1024, 16, 257)],
                         ids=["vit-b16", "ragged", "vit-l14"])
def test_fused_layer_kernel(cuda, dtype, tol, B, T, W, heads, valid):
    x, ln1, attn, ln2, mlp = _layer_case(cuda, B, T, W, T + W)
    x = x.to(dtype)
    with torch.inference_mode():
        n = fused_layer.launches
        got = fused_layer(x, ln1, attn, ln2, mlp, heads, valid)
        assert fused_layer.launches == n + 1
        want = fused_layer_reference(x, ln1, attn, ln2, mlp, heads, valid)
        again = fused_layer(x, ln1, attn, ln2, mlp, heads, valid)
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, want, tol)
    torch.testing.assert_close(got, again, rtol=0, atol=0)


@pytest.mark.gpu
def test_variant_refusals(cuda):
    from tapclip_tpu_torch.ops.fused_layer import fused_layer_max_grid

    x, ln1, attn, ln2, mlp = _layer_case(cuda, 1, 136, 128, 3)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="tail"):  # pad key 120 lies before the last 64-key tile
            attn_block_variant(x, ln1, attn, 2, 120, form="softmax", mask_mode="tail")
        big, bl, ba, _, _ = _layer_case(cuda, 1, 384, 128, 4)
        with pytest.raises(ValueError, match="shared memory"):  # k and v of T 384 do not fit a block
            attn_block_variant(big, bl, ba, 2, 384, perhead_qkv=True, softmax_opt=True)
        attn_block_variant(big, bl, ba, 2, 384, softmax_opt=True)  # the workspace form runs there
        fit, fl, fa, _, _ = _layer_case(cuda, 1, 320, 128, 5)  # the longest rows perhead_qkv holds
        flags = dict(perhead_qkv=True, softmax_opt=True)
        _close(attn_block_variant(fit, fl, fa, 2, 300, **flags),
               attn_block_variant_reference(fit, *fl.values(), *fa.values(), 2, 300, **flags), 1e-4)
        with pytest.raises(ValueError, match="perhead_qkv takes"):
            attn_block_variant(x, ln1, attn, 2, 136, perhead_qkv=True, softmax_opt="bf16")
        with pytest.raises(ValueError, match="head dim 64"):
            attn_block_variant(x, ln1, attn, 4, 136, form="softmax")
        with pytest.raises(ValueError, match="head dim 64"):
            fused_layer(x, ln1, attn, ln2, mlp, 4, 136)
        fit = fused_layer_max_grid(136, 128, torch.float32)
        assert fit >= 132
        with pytest.raises(RuntimeError, match="tapclip_fused_layer"):  # a cooperative grid the card cannot hold
            fused_layer(x, ln1, attn, ln2, mlp, 2, 136, grid=fit + 1)
        # The refused launch leaves no error behind for the next kernel's check.
        fused_attn_block(x, ln1, attn, 2, valid_len=136)
        with pytest.raises(ValueError, match="one switch"):
            fused_mlp_variant(x, *ln2.values(), *mlp.values(), row_tile=128, chunks=2)


# --- ProGrad: two pullbacks over one retained graph --------------------------------


@pytest.mark.gpu
def test_two_pullbacks_over_one_retained_graph(cuda):
    """ProGrad's step: one forward through K2/B4, K1/B5 and K3 (the flash
    chain's backward), then ``torch.autograd.grad`` of ``[L1, L2]`` with
    cotangent ``[1, 0]`` (``retain_graph``) and ``[0, 1]``.  Each pullback
    against autograd through the plain versions (norm-relative f32 1e-5);
    the second also bit for bit against the same pullback over a fresh
    graph, so the first left nothing the second reads changed; every
    backward kernel launched twice."""
    B, T, W, heads, valid = 4, 88, 128, 2, 82
    gen = torch.Generator(device=cuda).manual_seed(11)
    x0 = _randn(gen, B, T, W)
    ln = {"scale": 1.0 + _randn(gen, W, scale=0.1), "bias": _randn(gen, W, scale=0.1)}
    attn = {"w_qkv": _randn(gen, W, 3 * W, scale=W ** -0.5), "b_qkv": _randn(gen, 3 * W, scale=0.1),
            "w_out": _randn(gen, W, W, scale=W ** -0.5), "b_out": _randn(gen, W, scale=0.1)}
    mlp = {"w_fc": _randn(gen, W, 4 * W, scale=W ** -0.5), "b_fc": _randn(gen, 4 * W, scale=0.1),
           "w_proj": _randn(gen, 4 * W, W, scale=(4 * W) ** -0.5), "b_proj": _randn(gen, W, scale=0.1)}
    g1, g2 = _randn(gen, B, T, W), _randn(gen, B, T, W)

    def heads_of(t):  # [B, T, W] -> [B, H, T, Dh]
        return t.reshape(B, T, heads, W // heads).transpose(1, 2).contiguous()

    def forward(x, plain):
        if plain:
            h = attn_block_reference(x, ln["scale"], ln["bias"], *attn.values(), heads, valid, 1e-5)
            h = fused_mlp_reference(h, ln["scale"], ln["bias"], *mlp.values(), eps=1e-5)
            o, _ = attention_reference(heads_of(h), heads_of(h * 0.5), heads_of(h), kv_valid_len=valid,
                                       attn_to_idx=T - 1)
        else:
            h = fused_attn_block(x, ln, attn, heads, valid_len=valid)
            h = fused_mlp_block(h, ln, mlp)
            o, _ = fused_attention(heads_of(h), heads_of(h * 0.5), heads_of(h), kv_valid_len=valid,
                                   attn_to_idx=T - 1)
        out = o.transpose(1, 2).reshape(B, T, W)
        return torch.stack([(out * g1).sum(), (out * g2).sum()])

    def pullbacks(plain):
        x = x0.clone().requires_grad_(True)
        vals = forward(x, plain)
        (d1,) = torch.autograd.grad(vals, [x], vals.new_tensor([1.0, 0.0]), retain_graph=True)
        (d2,) = torch.autograd.grad(vals, [x], vals.new_tensor([0.0, 1.0]))
        return d1, d2

    counters = ((fused_attn_block, "bwd_launches"), (fused_mlp_block, "bwd_launches"),
                (fused_attention, "dq_launches"))
    for fn, attr in counters:
        setattr(fn, attr, 0)
    k1, k2 = pullbacks(plain=False)
    assert [getattr(fn, attr) for fn, attr in counters] == [2, 2, 2]
    p1, p2 = pullbacks(plain=True)
    _close_rel("first pullback", k1, p1, 1e-5)
    _close_rel("second pullback", k2, p2, 1e-5)
    x = x0.clone().requires_grad_(True)
    vals = forward(x, plain=False)
    (fresh,) = torch.autograd.grad(vals, [x], vals.new_tensor([0.0, 1.0]))
    assert torch.equal(k2, fresh)


# --- CoCoOp: the image-conditioned step on B*C text rows ----------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["ref_compat", "idiomatic"])
@pytest.mark.parametrize("terms", [{}, {"kg_lambda": 0.5, "prograd_lambda": 1.0}], ids=["ce", "kg-prograd"])
def test_tiny_model_cocoop_train_step_kernel_path_matches_plain(cuda, mode, terms):
    """The image-conditioned step on the card (cached features, batch 4 at
    capacity 8: 32 text rows), ``ctx`` and ``meta_net`` trained, a meta-net
    that conditions: the kernel path vs the plain path, f32 (loss and grad
    norm at rtol 1e-4, the leaves at 1e-4), and the backward kernels'
    launches per step (B4 or B7, and B5, once per text block a pullback)."""
    from tapclip_tpu_torch.config import TINY_TEST, PromptConfig, TrainConfig
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.parallel.train_step import init_train_state, make_optimizer, make_train_step
    from tapclip_tpu_torch.serve import build_model

    pcfg = PromptConfig(image_conditioned=True, text_mode=mode)
    keys = ("ctx", "meta_net")
    model = build_model(TINY_TEST, ["Backpack", "Pen", "Mug"], "cuda", seed=0)
    rng = np.random.default_rng(2)
    anchor = rng.standard_normal((8, TINY_TEST.embed_dim)).astype(np.float32)
    anchor /= np.linalg.norm(anchor, axis=-1, keepdims=True)
    batches = [(rng.standard_normal((4, TINY_TEST.embed_dim)).astype(np.float32), rng.integers(0, 3, 4))
               for _ in range(3)]
    mask = np.ones(4, bool)
    w2 = torch.as_tensor(rng.standard_normal((8, TINY_TEST.text_width)).astype(np.float32) * 0.2, device=cuda)
    bwd = fused_mha if mode == "idiomatic" else fused_attn_block
    results = []
    for cfg in (TINY_TEST, TINY_TEST.replace(attn_impl="xla")):
        m = FullModel(model.class_names, model.clip_params, cfg, prompt_cfg=pcfg)
        m.trainable = dict(m.trainable, meta_net=dict(m.trainable["meta_net"], w2=w2))
        kw = dict(terms, kg_feats=anchor, anchor_scale=float(m.trainable["logit_scale"])) if terms else {}
        state = init_train_state(m.trainable, make_optimizer(TrainConfig()), keys)
        step = make_train_step(cfg, pcfg, trainable_keys=keys, **kw)
        n_attn, n_mlp = bwd.bwd_launches, fused_mlp_block.bwd_launches
        metrics = []
        for x, y in batches:
            _, out = step(m.clip_params, state, m.prompt_learner.bank, x, y, mask)
            metrics.append((float(out["loss"]), float(out["grad_norm"])))
        results.append((metrics, state.params["ctx"].detach(), state.params["meta_net"]["w2"].detach(),
                        (bwd.bwd_launches - n_attn, fused_mlp_block.bwd_launches - n_mlp)))
    (km, kctx, kw2, kl), (pm, pctx, pw2, pl) = results
    pulls = 2 if terms else 1
    assert kl == (3 * pulls * TINY_TEST.text_layers,) * 2 and pl == (0, 0)
    np.testing.assert_allclose(km, pm, rtol=1e-4, atol=1e-5)
    _close(kctx, pctx, 1e-4)
    _close(kw2, pw2, 1e-4)


@pytest.mark.gpu
def test_resnet_tower_runs_without_tf32_and_restores_the_switch(cuda):
    """The RN tower on the card at the RN50 widths of its first stage (64
    px, one block a stage): f32 features against float64 convolutions of
    the same weights (1e-4 relative: TF32 would round the operands to 10
    bits, about 1e-3), and cuDNN's TF32 switch restored after."""
    from tapclip_tpu_torch.config import RN50
    from tapclip_tpu_torch.models import resnet

    cfg = RN50.replace(image_size=64, resnet_layers=(1, 1, 1, 1))
    params = {"visual": resnet.init_resnet_params(torch.Generator(device=cuda).manual_seed(0), cfg)}
    x = _randn(torch.Generator(device=cuda).manual_seed(1), 2, 64, 64, 3)
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = resnet.resnet_encode_image(params, cfg, x)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    _close_rel("RN features", got, _resnet_f64(params, cfg, x), 1e-4)


def _to_f64(tree):
    if isinstance(tree, dict):
        return {k: _to_f64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f64(v) for v in tree]
    return tree.double()


def _resnet_f64(params, cfg, x):
    """The tower's arithmetic in float64 (the plain reference of the f32 run)."""
    import torch.nn.functional as F

    from tapclip_tpu_torch.models import resnet

    p = _to_f64(params["visual"])

    def conv(t, q, stride=1):
        return F.conv2d(t, q["w"], stride=stride, padding=(q["w"].shape[-1] - 1) // 2)

    def bn(t, q):
        scale = q["scale"] * torch.rsqrt(q["var"] + resnet.BN_EPS)
        return t * scale[:, None, None] + (q["bias"] - q["mean"] * scale)[:, None, None]

    t = x.double().permute(0, 3, 1, 2)
    t = torch.relu(bn(conv(t, p["conv1"], 2), p["bn1"]))
    t = torch.relu(bn(conv(t, p["conv2"]), p["bn2"]))
    t = F.avg_pool2d(torch.relu(bn(conv(t, p["conv3"]), p["bn3"])), 2)
    for li in range(4):
        for b, q in enumerate(p[f"layer{li + 1}"]):
            s = (1 if li == 0 else 2) if b == 0 else 1
            out = torch.relu(bn(conv(t, q["conv1"]), q["bn1"]))
            out = torch.relu(bn(conv(out, q["conv2"]), q["bn2"]))
            out = bn(conv(F.avg_pool2d(out, s) if s > 1 else out, q["conv3"]), q["bn3"])
            idn = t
            if "downsample" in q:
                idn = bn(conv(F.avg_pool2d(t, s) if s > 1 else t, q["downsample"]["conv"]), q["downsample"]["bn"])
            t = torch.relu(out + idn)
    ap = p["attnpool"]
    tok = t.flatten(2).transpose(1, 2)
    tok = torch.cat([tok.mean(1, keepdim=True), tok], 1) + ap["positional_embedding"][None]
    H = resnet.attnpool_heads(cfg)
    B, T, C = tok.shape

    def heads(a):
        return a.reshape(B, a.shape[1], H, C // H).transpose(1, 2)

    q = heads(tok[:, :1] @ ap["q_proj"]["w"].T + ap["q_proj"]["b"])
    k = heads(tok @ ap["k_proj"]["w"].T + ap["k_proj"]["b"])
    v = heads(tok @ ap["v_proj"]["w"].T + ap["v_proj"]["b"])
    o = torch.softmax(q @ k.transpose(-1, -2) * (C // H) ** -0.5, -1) @ v
    return (o.transpose(1, 2).reshape(B, C) @ ap["c_proj"]["w"].T + ap["c_proj"]["b"]).float()


# --- pretraining: B4 and B5 with their weight gradients (csrc/gemm.cu) ----------------

from tapclip_tpu_torch.ops.gemm import col_sum, gemm_f32  # noqa: E402

# The image tower's pretraining shapes at ViT-B/16, batch 8: T 200 (197
# valid), patch dropout 0.5 (99 valid, padded to 104) and VPT-deep at 8
# tokens (205 valid, padded to 208: inside B4's routing limit of 210).
PRETRAIN_SHAPES = [(8, 200, 197), (8, 104, 99), (8, 208, 205)]
PRETRAIN_IDS = ["T200", "T99-dropout", "T205-vpt8"]


def _pretrain_case(cuda, dtype, B, T, W, seed, attn):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x, g = _randn(gen, B, T, W).to(dtype), _randn(gen, B, T, W).to(dtype)
    width = 3 * W if attn else 4 * W
    p = (1 + _randn(gen, W, scale=0.1), _randn(gen, W, scale=0.1), _randn(gen, W, width, scale=W ** -0.5),
         _randn(gen, width, scale=0.1))
    return x, g, p + ((_randn(gen, W, W, scale=W ** -0.5),) if attn else (_randn(gen, width, W, scale=width ** -0.5),))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", BWD_DTYPES)
@pytest.mark.parametrize("B,T,valid", PRETRAIN_SHAPES, ids=PRETRAIN_IDS)
def test_b4_b5_every_gradient_at_the_pretraining_shapes(cuda, dtype, tol, B, T, valid):
    """B4 and B5 with all seven gradients at ViT-B/16's image widths (W 768,
    12 heads) against the plain backward (norm-relative), bit for bit on a
    second call; the dW products launch gemm_f32 twice per call."""
    W, heads = 768, 12
    x, g, p = _pretrain_case(cuda, dtype, B, T, W, T + 1, attn=True)
    n = gemm_f32.launches
    got = _attn_block_bwd_cuda(x, g, *p, heads, valid, 1e-5)
    assert gemm_f32.launches == n + 2
    for name, a, b, c in zip(NAMES, got, attn_block_bwd_reference(x, g, *p, heads, valid, 1e-5),
                             _attn_block_bwd_cuda(x, g, *p, heads, valid, 1e-5)):
        _close_rel(f"B4 {name}", a, b, tol)
        torch.testing.assert_close(c, a, rtol=0, atol=0)
    x, g, p = _pretrain_case(cuda, dtype, B, T, W, T + 2, attn=False)
    got = _fused_mlp_bwd_cuda(x, g, *p, eps=1e-5)
    for name, a, b in zip(NAMES, got, fused_mlp_bwd_reference(x, g, *p, 1e-5)):
        _close_rel(f"B5 {name}", a, b, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("attn", [True, False], ids=["B4", "B5"])
def test_backward_computes_only_the_wanted_weight_gradients(cuda, attn):
    """BitFit wants the biases and the LayerNorm's beta, not the weights: no
    dW product runs, and each wanted gradient equals the all-gradient call's."""
    W, heads, valid = 256, 4, 45
    x, g, p = _pretrain_case(cuda, torch.float32, 2, 48, W, 5, attn=attn)
    wanted = (False, True, False, True, False, True)

    def run(weight_grads):
        if attn:
            return _attn_block_bwd_cuda(x, g, *p, heads, valid, 1e-5, weight_grads=weight_grads)
        return _fused_mlp_bwd_cuda(x, g, *p, eps=1e-5, weight_grads=weight_grads)

    full = run(True)
    n_gemm, n_sum = gemm_f32.launches, col_sum.launches
    some = run(wanted)
    assert gemm_f32.launches == n_gemm and col_sum.launches == n_sum + 3
    for name, a, b, want in zip(NAMES[1:], some[1:], full[1:], wanted):
        if want:
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
        else:
            assert a is None, name
    torch.testing.assert_close(some[0], full[0], rtol=0, atol=0)


@pytest.mark.gpu
def test_remat_recomputes_the_kernels_with_equal_gradients(cuda):
    """A checkpointed block (``remat``): K1 and K2 launch twice, B4 and B5
    once, and the gradients equal those without remat bit for bit."""
    from tapclip_tpu_torch.models import layers

    W, heads = 256, 4
    gen = torch.Generator(device=cuda).manual_seed(11)
    blk = {"ln_1": {"scale": 1 + _randn(gen, W, scale=0.1), "bias": _randn(gen, W, scale=0.1)},
           "attn": {"w_qkv": _randn(gen, W, 3 * W, scale=W ** -0.5), "b_qkv": _randn(gen, 3 * W, scale=0.1),
                    "w_out": _randn(gen, W, W, scale=W ** -0.5), "b_out": _randn(gen, W, scale=0.1)},
           "ln_2": {"scale": 1 + _randn(gen, W, scale=0.1), "bias": _randn(gen, W, scale=0.1)},
           "mlp": {"w_fc": _randn(gen, W, 4 * W, scale=W ** -0.5), "b_fc": _randn(gen, 4 * W, scale=0.1),
                   "w_proj": _randn(gen, 4 * W, W, scale=0.03), "b_proj": _randn(gen, W, scale=0.1)}}
    leaves = [t.requires_grad_() for d in blk.values() for t in d.values()]
    x = _randn(gen, 2, 48, W)
    grads, counts = [], []
    for remat in ("none", "full"):
        before = (fused_mlp_block.launches, fused_attn_block.launches, fused_mlp_block.bwd_launches,
                  fused_attn_block.bwd_launches)
        out, _ = layers.transformer_forward(x, [blk, blk], heads, act="gelu", kv_valid_len=45, remat=remat)
        grads.append(torch.autograd.grad(out.square().sum(), leaves))
        after = (fused_mlp_block.launches, fused_attn_block.launches, fused_mlp_block.bwd_launches,
                 fused_attn_block.bwd_launches)
        counts.append(tuple(a - b for a, b in zip(after, before)))
    assert counts == [(2, 2, 2, 2), (4, 4, 2, 2)]
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


# --- gemm.cu on the tensor cores: every layout, tile and split of the rows ----------

from tapclip_tpu_torch.ops.gemm import gemm_reference  # noqa: E402

GEMM_LAYOUTS = ["none", "trans_a", "trans_b"]
GEMM_ROWS = [1, 15, 200, 1600, 6401]


def _gemm_case(cuda, dtype, layout, M, N, K, seed):
    """Operands of ``op(a) @ op(b)`` stored as the layout stores them."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    a = _randn(gen, *((K, M) if layout == "trans_a" else (M, K))).to(dtype)
    b = _randn(gen, *((N, K) if layout == "trans_b" else (K, N))).to(dtype)
    return a, b, {"trans_a": layout == "trans_a", "trans_b": layout == "trans_b"}


def _gemm_close(got, a, b, flags, K, bias=None):
    """Against the plain version at chip_smoke.py's dW limit, 1e-4 sqrt(K)
    absolute for unit-normal operands: f32 operands split into three bf16
    terms read about 1e-7 relative, bf16 ones are exact, and the f32 sums run
    in another order."""
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, gemm_reference(a, b, bias=bias, **flags), rtol=0, atol=1e-4 * K ** 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", GEMM_LAYOUTS)
@pytest.mark.parametrize("rows", GEMM_ROWS)
def test_gemm_kernel_every_layout_at_ragged_rows(cuda, dtype, layout, rows):
    """Each layout against the plain version, bit for bit on a second call,
    C 68 x 132 off every tile edge (bf16 rows of 68 and 132 elements take the
    8-byte copies).  rows: the depth K where A is transposed (dW: rows of
    both operands), else the rows M of A over a depth of 132."""
    M, N, K = (68, 132, rows) if layout == "trans_a" else (rows, 132, 132)
    a, b, flags = _gemm_case(cuda, dtype, layout, M, N, K, rows)
    n = gemm_f32.launches
    got = gemm_f32(a, b, **flags)
    assert gemm_f32.launches == n + 1 and got.shape == (M, N) and got.dtype == torch.float32
    _gemm_close(got, a, b, flags, K)
    torch.testing.assert_close(gemm_f32(a, b, **flags), got, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", GEMM_LAYOUTS)
@pytest.mark.parametrize("split", range(1, 9))
def test_gemm_kernel_each_split_with_a_bias(cuda, dtype, layout, split):
    """Every split of the rows the dispatcher can take, forced, with a bias,
    on 1,600 rows (50 stages: the split 8 leaves a short last part) and C
    200 x 136 (the 16-byte copies in bf16): against the plain version, bit
    for bit on a second call; the dispatcher's own choice beside them."""
    M, N, K = 200, 136, 1600
    a, b, flags = _gemm_case(cuda, dtype, layout, M, N, K, 7 * split)
    bias = _randn(torch.Generator(device=cuda).manual_seed(split), N)
    got = gemm_f32(a, b, bias=bias, split=split, **flags)
    _gemm_close(got, a, b, flags, K, bias)
    torch.testing.assert_close(gemm_f32(a, b, bias=bias, split=split, **flags), got, rtol=0, atol=0)
    _gemm_close(gemm_f32(a, b, bias=bias, **flags), a, b, flags, K, bias)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gemm_kernel_unsplit_entry_and_the_dispatchers_split(cuda, dtype):
    """``tapclip_gemm_f32`` (the rows unsplit) equals the wrapper at split 1
    bit for bit; the dispatcher splits the rows of the pretraining dW
    products 1 to 8 ways."""
    lib, code = _build.library(), _build.dtype_code(dtype)
    a, b, flags = _gemm_case(cuda, dtype, "trans_a", 200, 136, 1600, 3)
    c = torch.empty((200, 136), device=cuda)
    assert lib.tapclip_gemm_f32(a.data_ptr(), b.data_ptr(), None, c.data_ptr(), 200, 136, 1600, 1, 0, code,
                                _build.stream_handle(a.device)) == 0
    torch.testing.assert_close(c, gemm_f32(a, b, split=1, **flags), rtol=0, atol=0)
    for rows, M, N in ((6400, 768, 2304), (6400, 768, 768), (6400, 768, 3072), (6400, 3072, 768),
                       (2560, 512, 2048), (2560, 2048, 512)):
        assert 1 <= lib.tapclip_gemm_f32_split(M, N, rows, code) <= 8


@pytest.mark.gpu
def test_gemm_kernel_refusals(cuda):
    """What the kernels do not take raises ValueError, never a fallback: N
    not a multiple of 4, a stored row not a multiple of 4 elements, an
    operand off its 16-byte (f32) or 8-byte (bf16) alignment, both operands
    transposed, a split past 8; the C interface itself answers
    cudaErrorInvalidValue (1)."""
    a, b, _ = _gemm_case(cuda, torch.float32, "trans_a", 64, 130, 32, 1)
    with pytest.raises(ValueError, match="N = 130"):
        gemm_f32(a, b, trans_a=True)
    c = torch.empty((64, 130), device=cuda)
    assert _build.library().tapclip_gemm_f32_ws(a.data_ptr(), b.data_ptr(), None, c.data_ptr(), None, 64, 130, 32,
                                                1, 0, 0, 1, _build.stream_handle(a.device)) == 1
    a, b, _ = _gemm_case(cuda, torch.float32, "none", 64, 64, 15, 2)
    with pytest.raises(ValueError, match="rows hold 15"):
        gemm_f32(a, b)
    for dtype, off in ((torch.float32, 2), (torch.bfloat16, 2)):
        buf = torch.zeros(64 * 64 + off, device=cuda, dtype=dtype)
        a_off = buf[off:].view(64, 64)
        with pytest.raises(ValueError, match="aligned"):
            gemm_f32(a_off, torch.zeros((64, 64), device=cuda, dtype=dtype), trans_a=True)
    a, b, _ = _gemm_case(cuda, torch.float32, "trans_a", 64, 64, 64, 3)
    with pytest.raises(ValueError, match="at most one transposed"):
        gemm_f32(a, b, trans_a=True, trans_b=True)
    with pytest.raises(ValueError, match="split 9"):
        gemm_f32(a, b, trans_a=True, split=9)


# --- MoE blocks (models/moe.py): B6 forward and B7 backward around the expert bank ---

MOE_CASES = [(False, 200, 197), (True, 80, 77), (False, 40, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", BWD_DTYPES)
@pytest.mark.parametrize("causal,T,valid", MOE_CASES, ids=["image", "text-causal", "unpadded"])
def test_moe_block_kernel_path_matches_plain_with_the_routing_replayed(cuda, monkeypatch, dtype, tol, causal, T,
                                                                      valid):
    """One MoE block (``moe_block_forward``: E 4, W 256, 4 heads, batch 3)
    on B6 forward and B7 backward against ``impl="xla"``, the plain path
    fed the kernel path's routing decisions (expert, position, keep; its
    gates and statistics from its own router probabilities): the output,
    the load-balance term and the gradients of x and of every leaf, the
    router's included, by the norm-relative error (f32 1e-5, bf16 2e-2, as
    B7's own); one B6 and one B7 launch on the kernel path, none on the
    plain one."""
    from tapclip_tpu_torch.models import moe
    from tapclip_tpu_torch.pretrain import named_leaves

    W, heads = 256, 4
    gen = torch.Generator(device=cuda).manual_seed(21)
    blk = moe.init_moe_block(gen, W, 4, device=cuda)
    blk["moe"]["router"]["w"] = blk["moe"]["router"]["w"] * 25  # routing margins far above the paths' rounding
    leaves = [t.requires_grad_() for _, t in named_leaves(blk)]
    x = _randn(gen, 3, T, W).to(dtype).requires_grad_()
    gy = _randn(gen, 3, T, W).to(dtype)
    real, seen = moe.route, []

    def record(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    def replay(xx, p, capacity_factor=1.25, valid_len=None):
        mine, rec = real(xx, p, capacity_factor, valid_len), seen.pop(0)
        return rec._replace(gate=mine.probs.gather(-1, rec.expert[..., None])[..., 0], probs=mine.probs)

    runs = []
    for impl, route in (("auto", record), ("xla", replay)):
        monkeypatch.setattr(moe, "route", route)
        before = (fused_mha.launches, fused_mha.bwd_launches)
        y, lb, _ = moe.moe_block_forward(x, blk, heads, act="gelu", causal=causal, kv_valid_len=valid, impl=impl)
        grads = torch.autograd.grad([y, lb], [x, *leaves], [gy, torch.ones_like(lb)])
        runs.append((y, lb, grads, (fused_mha.launches - before[0], fused_mha.bwd_launches - before[1])))
    (yk, lbk, gk, nk), (yp, lbp, gp, np_) = runs
    assert nk == (1, 1) and np_ == (0, 0) and not seen
    _close_rel("moe block out", yk.detach(), yp.detach(), tol)
    _close_rel("moe lb", lbk.detach().reshape(1), lbp.detach().reshape(1), tol)
    for (path, _), a, b in zip([("x", x)] + named_leaves(blk), gk, gp):
        _close_rel(f"moe grad {path}", a, b, tol)


# --- the tapclip ops and the exported programs (utils/model_export.py) ---------

from tapclip_tpu_torch.utils import model_export as ME  # noqa: E402

_EXPORT_COUNTERS = {"K1": (fused_mlp_block, "launches"), "K2": (fused_attn_block, "launches"),
                    "B6": (fused_mha, "launches"), "K3": (fused_attention, "launches"),
                    "B13": (int8_mlp_block, "launches"), "B14": (int8_attn_block, "launches")}


def _export_counts(fn, *args):
    for w, attr in _EXPORT_COUNTERS.values():
        setattr(w, attr, 0)
    with torch.no_grad():
        out = fn(*args)
    torch.cuda.synchronize()
    return out, {k: getattr(w, attr) for k, (w, attr) in _EXPORT_COUNTERS.items()}


def _export_model(cuda, text_mode, **cfg_kw):
    from tapclip_tpu_torch import config as tcfg
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.models.model_wrapper import FullModel

    cfg = tcfg.TINY_TEST.replace(**cfg_kw)
    params = clip_model.init_clip_params(torch.Generator(device=cuda).manual_seed(5), cfg)
    return FullModel(["Backpack", "Pen", "Mug"], params, cfg,
                     prompt_cfg=tcfg.PromptConfig(max_classes=4, text_mode=text_mode))


@pytest.mark.gpu
@pytest.mark.parametrize("text_mode", ["ref_compat", "idiomatic"])
def test_exported_programs_equal_eager_and_launch_its_kernels(cuda, tmp_path, text_mode):
    """The four functions exported on the card (tiny widths), saved and
    loaded: each output equals the eager call's bit for bit and launches
    exactly the kernels it launches (K1, K2, B6, K3)."""
    m = _export_model(cuda, text_mode)
    cfg, pcfg, params, tr, bank = m.clip_cfg, m.prompt_cfg, m.clip_params, m.trainable, m.prompt_learner.bank
    out = ME.export_model(str(tmp_path / "exp"), params, cfg, pcfg, tr, bank, batch=3,
                          functions=ME.EXPORTABLE_FUNCTIONS)
    fns = ME.load_exported(out)
    gen = torch.Generator(device=cuda).manual_seed(6)
    images = _randn(gen, 3, cfg.image_size, cfg.image_size, 3)
    tokens = torch.randint(0, 200, (3, cfg.context_length), generator=gen, device=cuda, dtype=torch.int32)
    feats = torch.nn.functional.normalize(_randn(gen, bank.capacity, cfg.embed_dim), dim=-1)
    args = {"encode_image": (params, images), "encode_text": (params, tokens),
            "classify": (params, feats, tr["logit_scale"], bank.class_mask, images),
            "full_forward": (params, tr, ME._bank_to_plain(bank), images)}
    for name, a in args.items():
        want, n_eager = _export_counts(ME._build_fn(name, cfg, pcfg), *a)
        got, n_exported = _export_counts(fns[name], *a)
        assert n_exported == n_eager, (name, n_exported, n_eager)
        assert sum(n_eager.values()) > 0, name
        for g, w in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
            assert torch.equal(g, w), name


@pytest.mark.gpu
def test_cpu_export_moved_to_the_card_launches_k1_and_k2(cuda, tmp_path):
    m = _export_model(cuda, "ref_compat")
    cfg, params = m.clip_cfg, m.clip_params
    cpu_params = torch.utils._pytree.tree_map(lambda t: t.cpu(), params)
    out = ME.export_model(str(tmp_path / "cpu"), cpu_params, cfg, batch=2, functions=("encode_image",))
    fn = ME.load_exported(out, device="cuda")["encode_image"]
    images = _randn(torch.Generator(device=cuda).manual_seed(7), 2, cfg.image_size, cfg.image_size, 3)
    got, n = _export_counts(fn, params, images)
    want, n_eager = _export_counts(ME._build_fn("encode_image", cfg, m.prompt_cfg), params, images)
    assert n == n_eager and n["K1"] == n["K2"] == cfg.vision_layers
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "nearest"])
def test_exported_int8_tower_launches_b13_and_b14(cuda, tmp_path, deterministic):
    m = _export_model(cuda, "ref_compat", quantize_tower=True, int8_deterministic=deterministic)
    cfg, params = m.clip_cfg, m.clip_params
    fn = ME.load_exported(ME.export_model(str(tmp_path / "int8"), params, cfg, batch=2,
                                          functions=("encode_image",)))["encode_image"]
    images = _randn(torch.Generator(device=cuda).manual_seed(8), 2, cfg.image_size, cfg.image_size, 3)
    got, n = _export_counts(fn, params, images)
    want, n_eager = _export_counts(ME._build_fn("encode_image", cfg, m.prompt_cfg), params, images)
    assert n == n_eager and n["B13"] == n["B14"] == cfg.vision_layers and n["K1"] == n["K2"] == 0
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_ops_on_cuda_tensors_launch_the_kernels(cuda):
    """A CUDA tensor reaching a ``tapclip`` op launches its kernel (the
    counter rises by one), as the wrapper's direct call does, bit for bit;
    operands on two devices raise."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    W, H = 64, 256
    x = _randn(gen, 2, 24, W)
    g, b = torch.ones(W, device=cuda), torch.zeros(W, device=cuda)
    wf, bf, wp, bp = _randn(gen, W, H, scale=W ** -0.5), torch.zeros(H, device=cuda), _randn(gen, H, W), b
    before = fused_mlp_block.launches
    got = torch.ops.tapclip.fused_mlp(x, g, b, wf, bf, wp, bp, 1e-5)
    assert fused_mlp_block.launches == before + 1
    torch.testing.assert_close(got, fused_mlp_reference(x, g, b, wf, bf, wp, bp), rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        direct = fused_mlp_block(x, {"scale": g, "bias": b}, {"w_fc": wf, "b_fc": bf, "w_proj": wp, "b_proj": bp})
    assert fused_mlp_block.launches == before + 2 and torch.equal(direct, got)
    with pytest.raises(ValueError, match="CUDA tensor"):
        torch.ops.tapclip.fused_mlp(x, g.cpu(), b, wf, bf, wp, bp, 1e-5)
