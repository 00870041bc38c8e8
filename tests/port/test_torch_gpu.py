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
two products on the int8 tensor cores and equals the walk it replaced (S5's
flags-off kernel) bit for bit, in both modes and dtypes, at row counts off
its tiles and at H 4,096.  B14 runs its two products on the same int8 tiles
and its attention on K2's tensor-core walk, and is held at the image,
pruned and ViT-L/14 shapes in both modes and dtypes, bit for bit against a
second call.
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
from tapclip_tpu_torch.ops.int8_mlp import int8_mlp_block, int8_mlp_cuda, int8_mlp_plain, int8_mlp_walk, quantize_mlp

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


# B13 on the int8 tensor cores equals the walk (S5's flags-off kernel, the
# earlier B13) bit for bit: rows off the 64- and 128-row tiles (8 x 97,
# 5 x 33, 3 x 7), widths off the 128-column tile and the 64-byte depth (40,
# 64, 256: H 160, 256, 1,024), the image and pruned shapes and ViT-L/14's
# H 4,096.
B13_EDGES = [(8, 200, 768), (8, 96, 768), (8, 97, 256), (5, 33, 64), (3, 7, 40), (1, 264, 1024)]
B13_EDGE_IDS = ["image", "pruned-t96", "rows776", "rows165-w64", "rows21-w40", "vit-l-h4096"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "nearest"])
@pytest.mark.parametrize("B,T,W", B13_EDGES, ids=B13_EDGE_IDS)
def test_int8_mlp_kernel_equals_the_walk_bit_for_bit(cuda, dtype, deterministic, B, T, W):
    x, ln, mlp, _ = _int8_case(cuda, B, T, W, B * T + W + 1)
    x = x.to(dtype)
    q = quantize_mlp(mlp)
    with torch.inference_mode():
        n = (int8_mlp_block.launches, int8_mlp_block.variant_launches)
        got = int8_mlp_cuda(x, ln["scale"], ln["bias"], q, deterministic=deterministic)
        walk = int8_mlp_walk(x, ln["scale"], ln["bias"], q, deterministic=deterministic)
        assert (int8_mlp_block.launches, int8_mlp_block.variant_launches) == (n[0] + 1, n[1] + 1)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got, walk, rtol=0, atol=0)


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
        # The walk keeps 8 hidden rows in shared memory; B13 keeps them in
        # device memory and takes the width.
        x2, ln2, mlp2, _ = _int8_case(cuda, 1, 8, 2048, 4)
        q2 = quantize_mlp(mlp2)
        with pytest.raises(ValueError, match="shared memory"):
            int8_mlp_walk(x2, ln2["scale"], ln2["bias"], q2)
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
from tapclip_tpu_torch.ops.fused_mha import attn_block_variant, attn_block_variant_reference  # noqa: E402
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
S2_SCHEDULE_ONLY = {"base", "rt512", "ilv2"}  # every row's arithmetic is the flags-off walk's


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
        parent = fused_mlp_variant(*args)  # the flags-off FMA walk, S2's parent
    _close(got, want, tol)
    if name in S2_SCHEDULE_ONLY:  # the flags-off launcher, 8 rows and the pipelined walk: the parent bit for bit
        torch.testing.assert_close(got, parent, rtol=0, atol=0)


def _attn_variant_cases():
    s3 = {n: attn_kernel_ab.port_flags(*attn_kernel_ab.VARIANTS[n], 12) for n in
          _distinct(attn_kernel_ab.VARIANTS, lambda v: attn_kernel_ab.port_flags(*v, 12))}
    s4 = {n: attn_softmax_ab.port_flags(attn_softmax_ab.VARIANTS[n], 12) for n in
          _distinct(attn_softmax_ab.VARIANTS, lambda v: attn_softmax_ab.port_flags(v, 12))}
    return [pytest.param(f, id=f"s3-{n}") for n, f in s3.items()] + [pytest.param(f, id=f"s4-{n}") for n, f in s4.items()]


# Variants with the arithmetic of the FMA core's flags-off online kernel (K2's
# until it moved to the tensor cores): their launchers equal that kernel bit
# for bit.
K2_EQUAL = [dict(form="softmax"), dict(form="softmax", mask_mode="tail"), dict(form="softmax", group_heads=2),
            dict(form="variant", perhead_qkv=True, softmax_opt=True)]


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
        online = attn_block_variant(x, ln, attn, heads, valid, form="softmax")  # S4's flags-off kernel
    _close(got, want, tol)
    torch.testing.assert_close(got, again, rtol=0, atol=0)  # no atomics: repeatable
    if any(flags == dict(attn_softmax_ab.port_flags({}, heads), **k) or
           flags == dict(attn_kernel_ab.port_flags("run_variant", {}, heads), **k) for k in K2_EQUAL):
        torch.testing.assert_close(got, online, rtol=0, atol=0)


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
        big, bl, ba, _, _ = _layer_case(cuda, 1, 300, 128, 4)
        with pytest.raises(ValueError, match="shared memory"):  # q, k, v of T 300 do not fit a block
            attn_block_variant(big, bl, ba, 2, 300, perhead_qkv=True, softmax_opt=True)
        attn_block_variant(big, bl, ba, 2, 300, softmax_opt=True)  # the workspace form runs there
        with pytest.raises(ValueError, match="head dim 64"):
            attn_block_variant(x, ln1, attn, 4, 136, form="softmax")
        with pytest.raises(ValueError, match="head dim 64"):
            fused_layer(x, ln1, attn, ln2, mlp, 4, 136)
        fit = fused_layer_max_grid(136, 128, torch.float32)
        assert fit >= 132
        with pytest.raises(RuntimeError, match="tapclip_fused_layer"):  # a cooperative grid the card cannot hold
            fused_layer(x, ln1, attn, ln2, mlp, 2, 136, grid=fit + 1)
        with pytest.raises(ValueError, match="rows"):
            fused_mlp_variant(x, *ln2.values(), *mlp.values(), rows=8, ilv=True)
