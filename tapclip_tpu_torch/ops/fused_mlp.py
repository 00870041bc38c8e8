"""Fused transformer MLP half-block: LayerNorm -> fc -> GELU -> proj -> +residual.

Counterpart of ``tapclip_tpu/ops/fused_mlp.py``.  :func:`fused_mlp_block` is
one ``torch.autograd.Function`` on every device.  Its forward is the op
``tapclip::fused_mlp`` (``ops/_library.py``; ``_build.run`` calls its
implementation directly where nothing traces the call), which launches the
hand-written CUDA kernel K1 (``csrc/fused_mlp.cu``, which replaces the Pallas
``_mlp_kernel``) on a CUDA tensor and runs :func:`fused_mlp_reference`, the
plain PyTorch composition, on a CPU tensor; an exported program keeps the op
as one node.  Its backward launches B5
(``csrc/mlp_bwd.cu`` + ``csrc/gemm.cu``, which replace ``_mlp_bwd_kernel``)
on a CUDA tensor and runs :func:`fused_mlp_bwd_reference` on a CPU tensor.
Like the TPU kernels, the forward saves x and the parameters only and the
backward recomputes LN -> fc -> GELU.

K1 runs both products on the tensor cores (bf16 MMAs, f32 operands split
into three bf16 terms) in two tiled passes, with the ``[R, 4W]`` hidden
activation in a scratch the wrapper allocates (it stays in the card's L2);
B5 runs its three dx products the same way (the fc recompute, dh and dy),
with z and dh_pre in such scratch, and its weight gradients as
``csrc/gemm.cu``'s A^T.B products, the rows split in a fixed order.  Both
take any row count R (they mask the ragged last tile), so the TPU kernel's
alignment guard (R % 256, W % 128) is not ported.
They use ``erff`` for the exact GELU where the TPU kernels needed a
polynomial.
"""

from __future__ import annotations

import math

import torch

from tapclip_tpu_torch.ops import _build, plain
from tapclip_tpu_torch.ops.gemm import col_sum, col_sum_reference, gemm_f32, gemm_reference


def fused_mlp_reference(x, gamma, beta, w_fc, b_fc, w_proj, b_proj, eps: float = 1e-5):
    """Plain version: ``x + mlp(layer_norm(x))`` as ``models/layers.py`` composes it."""
    p_ln = {"scale": gamma, "bias": beta}
    p_mlp = {"w_fc": w_fc, "b_fc": b_fc, "w_proj": w_proj, "b_proj": b_proj}
    return x + plain.mlp_forward(plain.layer_norm(x, p_ln, eps), p_mlp, "gelu")


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
    dw_proj = gemm_reference(_rnd(z * cdf, dt), gc, trans_a=True)
    dh_pre = dh * dgelu
    dhc = _rnd(dh_pre, dt)
    dy = dhc @ _rnd(w_fc, dt).T
    dw_fc = gemm_reference(y32, dhc, trans_a=True)
    dx_ln, dgn, dbn = ln_backward(dy, n, rstd, gamma)
    dx = (g32 + dx_ln).to(dt).reshape(x.shape)
    return dx, dgn.sum(0), dbn.sum(0), dw_fc, col_sum_reference(dh_pre), dw_proj, col_sum_reference(g32)


def _grads_like(grads, inputs, needs_input_grad):
    """Each gradient in its input's shape and dtype, None where not wanted
    (or not computed)."""
    return [
        gr.reshape(t.shape).to(t.dtype) if want and gr is not None else None
        for gr, t, want in zip(grads, inputs, needs_input_grad)
    ]


class _FusedMLP(torch.autograd.Function):
    """K1 forward and B5 backward (plain versions on a CPU tensor)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w_fc, b_fc, w_proj, b_proj, eps):
        ctx.save_for_backward(x, gamma, beta, w_fc, b_fc, w_proj, b_proj)
        ctx.eps = eps
        return _build.run(torch.ops.tapclip.fused_mlp.default, fused_mlp_reference, _fused_mlp_cuda,
                          x, gamma, beta, w_fc, b_fc, w_proj, b_proj, eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        x, gamma, beta, w_fc, b_fc, w_proj, _ = saved
        need = ctx.needs_input_grad
        g = g.to(x.dtype).contiguous()
        if x.device.type == "cpu":
            grads = fused_mlp_bwd_reference(x, g, gamma, beta, w_fc, b_fc, w_proj, ctx.eps)
        else:
            grads = _fused_mlp_bwd_cuda(x, g, gamma, beta, w_fc, b_fc, w_proj, eps=ctx.eps,
                                        weight_grads=tuple(need[1:7]))
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


def _fused_mlp_cuda(x, gamma, beta, w_fc, b_fc, w_proj, b_proj, eps):
    W = x.shape[-1]
    H = w_fc.shape[-1]
    R = x.numel() // W
    if W % 4 or H % 4:
        raise ValueError(f"fused_mlp kernel needs W and H divisible by 4, got W={W}, H={H}")
    t = _check_mlp_operands(x, gamma, beta, w_fc, b_fc, w_proj)
    b_proj = b_proj.to(torch.float32)
    _build.check_cuda_operand("b_proj", b_proj, torch.float32, (W,))
    align = 4 * x.element_size()  # the kernels copy 4 elements at a time at least
    for name in ("x", "w_fc", "w_proj"):
        if t[name].data_ptr() % align:
            raise ValueError(f"fused_mlp kernel copies {name} in {align}-byte chunks: it must be "
                             f"{align}-byte aligned")
    out = torch.empty_like(x)
    ws = torch.empty(R * (H + W), dtype=x.dtype, device=x.device)  # h [R, H], then y [R, W]
    err = _build.library().tapclip_fused_mlp(
        x.data_ptr(), t["gamma"].data_ptr(), t["beta"].data_ptr(), t["w_fc"].data_ptr(),
        t["b_fc"].data_ptr(), t["w_proj"].data_ptr(), b_proj.data_ptr(), out.data_ptr(), ws.data_ptr(),
        R, W, H, float(eps), _build.dtype_code(x.dtype), _build.stream_handle(x.device),
    )
    _build.check(err, "tapclip_fused_mlp")
    fused_mlp_block.launches += 1
    return out


def _fused_mlp_bwd_cuda(x, g, gamma, beta, w_fc, b_fc, w_proj, *, eps, weight_grads=True, split=None):
    """B5 on the card: its five launches (dx, and with any weight gradient
    the scratch for them), then the A^T.B products and column sums of the
    weight gradients ``weight_grads`` asks for: True (all), False (none) or
    six flags in the order gamma, beta, w_fc, b_fc, w_proj, b_proj.
    ``split``: the split of dy's depth into f32 partials (1, 2 or 4; None
    takes the kernel's choice for the shape).  Returns the seven gradients
    of :func:`fused_mlp_bwd_reference` (None for a weight gradient not
    computed)."""
    W = x.shape[-1]
    H = w_fc.shape[-1]
    R = x.numel() // W
    if W % 4 or H % 4:
        raise ValueError(f"fused_mlp backward kernel needs W and H divisible by 4, got W={W}, H={H}")
    t = _check_mlp_operands(x, gamma, beta, w_fc, b_fc, w_proj, g=g)
    align = 4 * x.element_size()  # the GEMMs copy 4 elements at a time at least
    for name in ("g", "w_fc", "w_proj"):
        if t[name].data_ptr() % align:
            raise ValueError(f"fused_mlp backward kernel copies {name} in {align}-byte chunks: it must be "
                             f"{align}-byte aligned")
    want = (weight_grads,) * 6 if isinstance(weight_grads, bool) else tuple(weight_grads)
    weight_grads = any(want)
    lib = _build.library()
    code = _build.dtype_code(x.dtype)
    S = lib.tapclip_mlp_bwd_split(R, W, H, code) if split is None else int(split)
    if S not in (1, 2, 4):
        raise ValueError(f"fused_mlp backward kernel splits dy's depth 1, 2 or 4 ways, got {S}")
    dev, dtype, f32 = x.device, x.dtype, torch.float32
    dx = torch.empty_like(x)
    ws = torch.empty(R * H + S * R * W + 2 * R, dtype=f32, device=dev)  # z, dy partials, mean, rstd
    wsd = torch.empty(R * (H + W), dtype=dtype, device=dev)  # dh_pre, then y
    h = torch.empty((R, H), dtype=dtype, device=dev) if weight_grads else None
    part = torch.empty((-(-R // 16), 2 * W), dtype=f32, device=dev) if weight_grads else None
    err = lib.tapclip_mlp_bwd(
        x.data_ptr(), g.data_ptr(), t["gamma"].data_ptr(), t["beta"].data_ptr(), t["w_fc"].data_ptr(),
        t["b_fc"].data_ptr(), t["w_proj"].data_ptr(), dx.data_ptr(), ws.data_ptr(), wsd.data_ptr(),
        None if h is None else h.data_ptr(), None if part is None else part.data_ptr(),
        R, W, H, float(eps), S, int(weight_grads), code, _build.stream_handle(dev),
    )
    _build.check(err, "tapclip_mlp_bwd")
    fused_mlp_block.bwd_launches += 1
    if not weight_grads:
        return dx, None, None, None, None, None, None
    dhp, y = wsd[:R * H].view(R, H), wsd[R * H:].view(R, W)
    dh_pre = ws[:R * H].view(R, H)  # unrounded, for db_fc
    g2 = g.reshape(R, W)
    ln_sums = col_sum(part) if want[0] or want[1] else None
    return (dx, ln_sums[:W] if want[0] else None, ln_sums[W:] if want[1] else None,
            gemm_f32(y, dhp, trans_a=True) if want[2] else None, col_sum(dh_pre) if want[3] else None,
            gemm_f32(h, g2, trans_a=True) if want[4] else None, col_sum(g2) if want[5] else None)


# --- S2: the A/B variants of the MLP half-block (scripts/mlp_kernel_ab.py) ---


def erf3_poly(z):
    """The A&S 7.1.25 3-term erf of ``scripts/_bench_util.py::erf3`` (|err| <= 2.5e-5)."""
    az = z.abs()
    t = 1.0 / (1.0 + 0.47047 * az)
    y = 1.0 - ((0.7478556 * t + -0.0958798) * t + 0.3480242) * t * torch.exp(-az * az)
    return torch.sign(z) * y


def _ln_rows(x32, eps, one_pass):
    """(x32 - mean) * rstd over the last axis, f32; ``one_pass``: var = E[x^2] - mean^2."""
    mean = x32.mean(dim=-1, keepdim=True)
    if one_pass:
        var = (x32 * x32).mean(dim=-1, keepdim=True) - mean * mean
    else:
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps)


def fused_mlp_variant_reference(x, gamma, beta, w_fc, b_fc, w_proj, b_proj, *, eps=1e-5, erf3=False,
                                ln1pass=False, chunks=1, row_tile=0):
    """Plain version of S2, rounded where ``scripts/mlp_kernel_ab.py``'s kernel
    rounds: LN(x) and GELU's output to x's dtype; fc, GELU, the projection and
    the residual in f32; one rounding of the result.  ``erf3`` takes the
    3-term erf, ``ln1pass`` the one-pass variance; ``chunks`` > 1 sums the
    projection chunk by chunk in the TPU kernel's order,
    ``((x + b_proj) + h_0 . w_proj_0) + h_1 . w_proj_1 ...`` over ``chunks``
    equal slices of the hidden dimension; ``row_tile`` is a schedule switch
    and changes nothing here.  In f32 with every switch off it is
    :func:`fused_mlp_reference` operation for operation."""
    del row_tile
    dt = x.dtype
    x32 = x.float()
    y = (_ln_rows(x32, eps, ln1pass) * gamma.float() + beta.float()).to(dt).float()
    h = torch.matmul(y, _rnd(w_fc, dt)) + b_fc.float()
    if erf3:
        g = 0.5 * h * (1.0 + erf3_poly(h * 2.0 ** -0.5))
    else:
        g = torch.nn.functional.gelu(h)
    g, wp = g.to(dt).float(), _rnd(w_proj, dt)
    if chunks == 1:
        out = torch.matmul(g, wp) + b_proj.float()
        return (x32 + out).to(dt)
    acc = x32 + b_proj.float()
    for gc, wc in zip(g.chunk(chunks, dim=-1), wp.chunk(chunks, dim=0)):
        acc = acc + torch.matmul(gc, wc)
    return acc.to(dt)


def _check_variant_switches(W, H, erf3, ln1pass, chunks, row_tile):
    if row_tile not in (0, 128) or chunks not in (1, 2, 4):
        raise ValueError(f"fused_mlp_variant takes row_tile 0 or 128 and chunks 1, 2 or 4, got row_tile={row_tile}, "
                         f"chunks={chunks}")
    if (row_tile != 0) + bool(ln1pass) + (chunks > 1) + (bool(erf3) and chunks == 1) > 1:
        raise ValueError(f"fused_mlp_variant takes one switch at a time (erf3 may join chunks), got "
                         f"row_tile={row_tile}, erf3={erf3}, ln1pass={ln1pass}, chunks={chunks}")
    if chunks > 1 and H % (128 * chunks):
        raise ValueError(f"fused_mlp_variant with {chunks} chunks takes a hidden width divisible by "
                         f"{128 * chunks} (whole 128-column fc tiles a chunk), got {H}")
    if (row_tile or erf3 or ln1pass or chunks > 1) and (W % 8 or H % 8):
        raise ValueError(f"fused_mlp_variant's switches take W and H divisible by 8, got W={W}, H={H}")


def fused_mlp_variant(x, gamma, beta, w_fc, b_fc, w_proj, b_proj, *, eps=1e-5, erf3=False,
                      ln1pass=False, chunks=1, row_tile=0):
    """S2 (forward only): K1's launches (``csrc/fused_mlp_variants.cu``) with the
    A/B switches of ``scripts/mlp_kernel_ab.py`` on a CUDA tensor, the plain
    version on a CPU tensor.  Every switch off is K1 itself, the A/B's parent;
    ``row_tile`` 128 takes 128-row tiles (the schedule alone: K1's output bit
    for bit), ``erf3`` the 3-term erf in the fc epilogue, ``ln1pass`` the
    one-pass LayerNorm, ``chunks`` 2 or 4 the fc of one hidden chunk beside
    the projection of the last, its partials summed in order."""
    _build.refuse_graph("fused_mlp_variant", x, gamma, beta, w_fc, b_fc, w_proj, b_proj)
    W = x.shape[-1]
    H = w_fc.shape[-1]
    _check_variant_switches(W, H, erf3, ln1pass, chunks, row_tile)
    kw = dict(eps=eps, erf3=erf3, ln1pass=ln1pass, chunks=chunks, row_tile=row_tile)
    if x.device.type == "cpu":
        return fused_mlp_variant_reference(x, gamma, beta, w_fc, b_fc, w_proj, b_proj, **kw)
    if W % 4 or H % 4:
        raise ValueError(f"fused_mlp kernel needs W and H divisible by 4, got W={W}, H={H}")
    t = _check_mlp_operands(x, gamma, beta, w_fc, b_fc, w_proj)
    b_proj = b_proj.to(torch.float32)
    _build.check_cuda_operand("b_proj", b_proj, torch.float32, (W,))
    R = x.numel() // W
    out = torch.empty_like(x)
    ws = torch.empty(R * (H + W), dtype=x.dtype, device=x.device)  # K1's scratch: h [R, H], then y [R, W]
    part = torch.empty((chunks, R, W), dtype=torch.float32, device=x.device) if chunks > 1 else None
    err = _build.library().tapclip_fused_mlp_variant(
        x.data_ptr(), t["gamma"].data_ptr(), t["beta"].data_ptr(), t["w_fc"].data_ptr(),
        t["b_fc"].data_ptr(), t["w_proj"].data_ptr(), b_proj.data_ptr(), out.data_ptr(), ws.data_ptr(),
        None if part is None else part.data_ptr(), R, W, H, float(eps), int(row_tile), int(erf3), int(ln1pass),
        int(chunks), _build.dtype_code(x.dtype), _build.stream_handle(x.device),
    )
    _build.check(err, "tapclip_fused_mlp_variant")
    fused_mlp_variant.launches += 1
    return out


fused_mlp_variant.launches = 0
