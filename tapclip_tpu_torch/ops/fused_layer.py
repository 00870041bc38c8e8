"""S1: a whole pre-LN ViT layer in one kernel launch.

Counterpart of ``scripts/fused_layer_ab.py::run_fused_layer``, an A/B
variant that the JAX package's ``block_forward`` never reaches (nor does the
port's).  :func:`fused_layer` launches the hand-written CUDA kernel
``csrc/fused_layer.cu`` (one cooperative launch of a persistent grid on the
tensor cores: LN1 rows, QKV tiles, attention items, out-projection tiles into
an f32 ``mid``, LN2 rows, fc tiles, proj tiles, a grid-wide barrier between
phases; the tiles are K1's and K2's) on a CUDA tensor, and
:func:`fused_layer_reference` on a CPU tensor.  Forward only, as in the JAX
package.

Numerics as the TPU kernel: LN1(x) rounded to x's dtype; q and k f32, v
rounded; exp2 with the folded constant, p rounded before p.v, 1/l after it;
the attention output f32 into the out-projection; ``mid = out + b_out + x``
f32 through LN2 and the second residual; LN2's and GELU's outputs rounded.
So in bf16 it differs from K2 then K1, which round the attention output and
the half-block's output.  GELU is exact (``erff``; the TPU kernel's 5-term
polynomial is within 1.5e-7 of it).
"""

from __future__ import annotations

import torch

from tapclip_tpu_torch.ops import _build
from tapclip_tpu_torch.ops.fused_mha import _LOG2E, _check_heads, _merge_heads, _split_heads
from tapclip_tpu_torch.ops.fused_mlp import _check_mlp_operands, _ln_parts, _rnd


def fused_layer_reference(x, ln1, attn, ln2, mlp, n_heads, valid, *, eps=1e-5):
    """Plain version of S1, rounded where ``fused_layer_ab.py``'s kernel rounds."""
    dt = x.dtype
    B, T, W = x.shape
    x32 = x.float()
    y = _ln_parts(x, ln1["scale"], ln1["bias"], eps)[2].float()
    qkv = torch.matmul(y, _rnd(attn["w_qkv"], dt)) + attn["b_qkv"].float()
    q, k, v = (_split_heads(t, n_heads) for t in qkv.split(W, dim=-1))
    s = torch.matmul(q, k.transpose(-1, -2)) * ((W // n_heads) ** -0.5 * _LOG2E)
    s = torch.where(torch.arange(T, device=x.device) < valid, s, torch.full_like(s, -1e30))
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(_rnd(p, dt), _rnd(v, dt)) / p.sum(dim=-1, keepdim=True)
    mid = (torch.matmul(_merge_heads(o), _rnd(attn["w_out"], dt)) + attn["b_out"].float()) + x32
    y2 = _ln_parts(mid, ln2["scale"], ln2["bias"], eps)[2].to(dt).float()
    h = torch.nn.functional.gelu(torch.matmul(y2, _rnd(mlp["w_fc"], dt)) + mlp["b_fc"].float())
    out = torch.matmul(h.to(dt).float(), _rnd(mlp["w_proj"], dt)) + mlp["b_proj"].float()
    return (out + mid).to(dt)


def fused_layer_max_grid(T: int, W: int, dtype) -> int:
    """Blocks of the cooperative grid the card holds at once at (T, W)."""
    return _build.library().tapclip_fused_layer_max_grid(T, W, _build.dtype_code(dtype))


def fused_layer(x, ln1, attn, ln2, mlp, n_heads, valid, *, eps=1e-5, grid=0):
    """``x [B, T, W]`` through one pre-LN layer: ``csrc/fused_layer.cu`` on a CUDA
    tensor (head dim 64, a hidden width divisible by 8), the plain version on a
    CPU tensor.  ``grid`` 0 takes as many blocks as the card holds at once; a
    larger one is refused (raises)."""
    leaves = [x, *ln1.values(), *attn.values(), *ln2.values(), *mlp.values()]
    _build.refuse_graph("fused_layer", *leaves)
    if x.device.type == "cpu":
        return fused_layer_reference(x, ln1, attn, ln2, mlp, n_heads, valid, eps=eps)
    B, T, W = x.shape
    Dh = _check_heads(T, W, n_heads, valid)
    H = mlp["w_fc"].shape[-1]
    if Dh != 64 or H % 8:
        raise ValueError(f"fused_layer takes head dim 64 and a hidden width divisible by 8, got {Dh}, {H}")
    dtype, f32 = x.dtype, torch.float32
    m = _check_mlp_operands(x, ln2["scale"], ln2["bias"], mlp["w_fc"], mlp["b_fc"], mlp["w_proj"])
    ops = {
        "gamma1": (ln1["scale"].to(f32), f32, (W,)),
        "beta1": (ln1["bias"].to(f32), f32, (W,)),
        "w_qkv": (attn["w_qkv"].to(dtype), dtype, (W, 3 * W)),
        "b_qkv": (attn["b_qkv"].to(f32), f32, (3 * W,)),
        # The out-projection multiplies the f32 attention output: w_out as f32,
        # holding the dtype's values.
        "w_out32": (_rnd(attn["w_out"], dtype).contiguous(), f32, (W, W)),
        "b_out": (attn["b_out"].to(f32), f32, (W,)),
        "b_proj": (mlp["b_proj"].to(f32), f32, (W,)),
    }
    for name, (t, dt, shape) in ops.items():
        _build.check_cuda_operand(name, t, dt, shape)
    t = {name: v[0] for name, v in ops.items()}
    R = B * T
    ws = torch.empty(5 * R * W, dtype=f32, device=x.device)  # qkv [R, 3W], attn [R, W], mid [R, W]
    wsd = torch.empty(R * (2 * W + H), dtype=dtype, device=x.device)  # y, y2 [R, W], h [R, H]
    out = torch.empty_like(x)
    err = _build.library().tapclip_fused_layer(
        x.data_ptr(), t["gamma1"].data_ptr(), t["beta1"].data_ptr(), t["w_qkv"].data_ptr(),
        t["b_qkv"].data_ptr(), t["w_out32"].data_ptr(), t["b_out"].data_ptr(), m["gamma"].data_ptr(),
        m["beta"].data_ptr(), m["w_fc"].data_ptr(), m["b_fc"].data_ptr(), m["w_proj"].data_ptr(),
        t["b_proj"].data_ptr(), ws.data_ptr(), wsd.data_ptr(), out.data_ptr(),
        B, T, W, n_heads, H, int(valid), float(eps), int(grid), _build.dtype_code(dtype),
        _build.stream_handle(x.device),
    )
    _build.check(err, "tapclip_fused_layer")
    fused_layer.launches += 1
    return out


fused_layer.launches = 0
