"""Fused transformer MLP half-block: LayerNorm -> fc -> GELU -> proj -> +residual.

Counterpart of ``tapclip_tpu/ops/fused_mlp.py``.  :func:`fused_mlp_block` is
one ``torch.autograd.Function`` on every device.  Its forward launches the
hand-written CUDA kernel K1 (``csrc/fused_mlp.cu``, which replaces the Pallas
``_mlp_kernel``) on a CUDA tensor and runs :func:`fused_mlp_reference`, the
plain PyTorch composition, on a CPU tensor.  Its backward launches B5
(``csrc/mlp_bwd.cu`` + ``csrc/gemm.cu``, which replace ``_mlp_bwd_kernel``)
on a CUDA tensor and runs :func:`fused_mlp_bwd_reference` on a CPU tensor.
Like the TPU kernels, the forward saves x and the parameters only and the
backward recomputes LN -> fc -> GELU.

The kernels keep the ``[R, 4W]`` hidden activation on chip and take any row
count R (they mask the ragged last tile), so the TPU kernel's alignment
guard (R % 256, W % 128) is not ported.  They use ``erff`` for the exact
GELU where the TPU kernels needed a polynomial.
"""

from __future__ import annotations

import math

import torch

from tapclip_tpu_torch.ops import _build
from tapclip_tpu_torch.ops.gemm import col_sum, gemm_f32


def fused_mlp_reference(x, gamma, beta, w_fc, b_fc, w_proj, b_proj, eps: float = 1e-5):
    """Plain version: ``x + mlp(layer_norm(x))`` as ``models/layers.py`` composes it."""
    from tapclip_tpu_torch.models import layers

    p_ln = {"scale": gamma, "bias": beta}
    p_mlp = {"w_fc": w_fc, "b_fc": b_fc, "w_proj": w_proj, "b_proj": b_proj}
    return x + layers.mlp_forward(layers.layer_norm(x, p_ln, eps), p_mlp, "gelu")


def _ln_parts(x, gamma, beta, eps):
    """(n, rstd, y): pre-affine normalised x and 1/std in f32, y = LN(x) in x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    n = (x32 - mean) * rstd
    return n, rstd, (n * gamma.float() + beta.float()).to(x.dtype)


def ln_backward(dy, n, rstd, gamma):
    """LayerNorm backward over the last axis: ``(dx_ln, dgamma rows, dbeta rows)``
    with the row sums left to the caller (f32 throughout)."""
    dn = dy * gamma.float()
    dx = rstd * (dn - dn.mean(dim=-1, keepdim=True) - n * (dn * n).mean(dim=-1, keepdim=True))
    return dx, dy * n, dy


def _rnd(t, dtype):
    """``t`` rounded to ``dtype`` and widened back to f32 (the kernels' round_to)."""
    return t.to(dtype).float()


def fused_mlp_bwd_reference(x, g, gamma, beta, w_fc, b_fc, w_proj, eps: float = 1e-5):
    """Plain backward of :func:`fused_mlp_reference`, written out as
    ``_mlp_bwd_kernel`` computes it (same roundings in bfloat16).

    ``x, g [..., W]`` in the compute dtype.  Returns ``(dx, dgamma, dbeta,
    dw_fc, db_fc, dw_proj, db_proj)``: dx in x.dtype, the rest f32.
    """
    dt = x.dtype
    W = x.shape[-1]
    x2, g32 = x.reshape(-1, W), g.reshape(-1, W).float()
    n, rstd, y = _ln_parts(x2, gamma, beta, eps)
    y32 = y.float()
    z = y32 @ _rnd(w_fc, dt) + b_fc.float()
    cdf = 0.5 * (1.0 + torch.erf(z * 2.0 ** -0.5))
    dgelu = cdf + z * torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    gc = _rnd(g32, dt)
    dh = gc @ _rnd(w_proj, dt).T
    dw_proj = _rnd(z * cdf, dt).T @ gc
    dh_pre = dh * dgelu
    dhc = _rnd(dh_pre, dt)
    dy = dhc @ _rnd(w_fc, dt).T
    dw_fc = y32.T @ dhc
    dx_ln, dgn, dbn = ln_backward(dy, n, rstd, gamma)
    dx = (g32 + dx_ln).to(dt).reshape(x.shape)
    return dx, dgn.sum(0), dbn.sum(0), dw_fc, dh_pre.sum(0), dw_proj, g32.sum(0)


def _grads_like(grads, inputs, needs_input_grad):
    """Each gradient in its input's shape and dtype, None where not wanted."""
    return [
        gr.reshape(t.shape).to(t.dtype) if want else None
        for gr, t, want in zip(grads, inputs, needs_input_grad)
    ]


class _FusedMLP(torch.autograd.Function):
    """K1 forward and B5 backward (plain versions on a CPU tensor)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w_fc, b_fc, w_proj, b_proj, eps):
        ctx.save_for_backward(x, gamma, beta, w_fc, b_fc, w_proj, b_proj)
        ctx.eps = eps
        args = (x, gamma, beta, w_fc, b_fc, w_proj, b_proj)
        if x.device.type == "cpu":
            return fused_mlp_reference(*args, eps=eps)
        return _fused_mlp_cuda(*args, eps=eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        x, gamma, beta, w_fc, b_fc, w_proj, _ = saved
        need = ctx.needs_input_grad
        g = g.to(x.dtype).contiguous()
        if x.device.type == "cpu":
            grads = fused_mlp_bwd_reference(x, g, gamma, beta, w_fc, b_fc, w_proj, ctx.eps)
        else:
            grads = _fused_mlp_bwd_cuda(
                x, g, gamma, beta, w_fc, b_fc, w_proj, eps=ctx.eps, weight_grads=any(need[1:7])
            )
        return (*_grads_like(grads, saved, need), None)


def fused_mlp_block(x: torch.Tensor, ln_params, mlp_params, *, eps: float = 1e-5) -> torch.Tensor:
    """``x + mlp(layer_norm(x))`` for ``x [B, T, W]``: K1/B5 on CUDA, plain on CPU."""
    return _FusedMLP.apply(
        x, ln_params["scale"], ln_params["bias"], mlp_params["w_fc"],
        mlp_params["b_fc"], mlp_params["w_proj"], mlp_params["b_proj"], eps,
    )


fused_mlp_block.launches = 0
fused_mlp_block.bwd_launches = 0


def _check_mlp_operands(x, gamma, beta, w_fc, b_fc, w_proj, **extra):
    """Cast the parameters as the kernels take them and check every operand."""
    W = x.shape[-1]
    H = w_fc.shape[-1]
    dtype, f32 = x.dtype, torch.float32
    ops = {
        "x": (x, dtype, tuple(x.shape)),
        **{k: (v, dtype, tuple(x.shape)) for k, v in extra.items()},
        "gamma": (gamma.to(f32), f32, (W,)),
        "beta": (beta.to(f32), f32, (W,)),
        "w_fc": (w_fc.to(dtype), dtype, (W, H)),
        "b_fc": (b_fc.to(f32), f32, (H,)),
        "w_proj": (w_proj.to(dtype), dtype, (H, W)),
    }
    for name, (t, dt, shape) in ops.items():
        _build.check_cuda_operand(name, t, dt, shape)
    return {name: v[0] for name, v in ops.items()}


def _fused_mlp_cuda(x, gamma, beta, w_fc, b_fc, w_proj, b_proj, *, eps):
    W = x.shape[-1]
    H = w_fc.shape[-1]
    R = x.numel() // W
    if W % 4 or H % 4:
        raise ValueError(f"fused_mlp kernel needs W and H divisible by 4, got W={W}, H={H}")
    t = _check_mlp_operands(x, gamma, beta, w_fc, b_fc, w_proj)
    b_proj = b_proj.to(torch.float32)
    _build.check_cuda_operand("b_proj", b_proj, torch.float32, (W,))
    out = torch.empty_like(x)
    err = _build.library().tapclip_fused_mlp(
        x.data_ptr(), t["gamma"].data_ptr(), t["beta"].data_ptr(), t["w_fc"].data_ptr(),
        t["b_fc"].data_ptr(), t["w_proj"].data_ptr(), b_proj.data_ptr(), out.data_ptr(),
        R, W, H, float(eps), _build.dtype_code(x.dtype), _build.stream_handle(x.device),
    )
    _build.check(err, "tapclip_fused_mlp")
    fused_mlp_block.launches += 1
    return out


def _fused_mlp_bwd_cuda(x, g, gamma, beta, w_fc, b_fc, w_proj, *, eps, weight_grads=True):
    """B5 on the card: the row pass (dx, and with ``weight_grads`` the scratch
    for the weight gradients), then the A^T.B products and column sums.
    Returns the seven gradients of :func:`fused_mlp_bwd_reference` (the six
    weight gradients None without ``weight_grads``)."""
    W = x.shape[-1]
    H = w_fc.shape[-1]
    R = x.numel() // W
    if W % 32:
        raise ValueError(f"fused_mlp backward kernel needs W divisible by 32, got W={W}")
    t = _check_mlp_operands(x, gamma, beta, w_fc, b_fc, w_proj, g=g)
    lib = _build.library()
    rows = lib.tapclip_mlp_bwd_rows_per_block(W)
    if rows == 0:
        raise ValueError(f"fused_mlp backward kernel: width W={W} does not fit in shared memory")
    code = _build.dtype_code(x.dtype)
    stream = _build.stream_handle(x.device)
    dev, dtype, f32 = x.device, x.dtype, torch.float32
    dx = torch.empty_like(x)
    if weight_grads:
        n_blocks = -(-R // rows)
        y = torch.empty((R, W), dtype=dtype, device=dev)
        h = torch.empty((R, H), dtype=dtype, device=dev)
        dhp = torch.empty((R, H), dtype=dtype, device=dev)
        part = torch.empty((n_blocks, 3 * W + H), dtype=f32, device=dev)
        scratch = (y.data_ptr(), h.data_ptr(), dhp.data_ptr(), part.data_ptr())
    else:
        scratch = (None, None, None, None)
    err = lib.tapclip_mlp_bwd_rows(
        x.data_ptr(), g.data_ptr(), t["gamma"].data_ptr(), t["beta"].data_ptr(),
        t["w_fc"].data_ptr(), t["b_fc"].data_ptr(), t["w_proj"].data_ptr(), dx.data_ptr(),
        *scratch, R, W, H, float(eps), int(weight_grads), code, stream,
    )
    _build.check(err, "tapclip_mlp_bwd_rows")
    fused_mlp_block.bwd_launches += 1
    if not weight_grads:
        return dx, None, None, None, None, None, None
    sums = col_sum(part, dtype=f32)
    dw_fc = gemm_f32(y, dhp, trans_a=True)
    dw_proj = gemm_f32(h, g.reshape(R, W), trans_a=True)
    return dx, sums[:W], sums[W:2 * W], dw_fc, sums[3 * W:], dw_proj, sums[2 * W:3 * W]
