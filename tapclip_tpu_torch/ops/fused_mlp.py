"""Fused transformer MLP half-block: LayerNorm -> fc -> GELU -> proj -> +residual.

Counterpart of ``tapclip_tpu/ops/fused_mlp.py``.  :func:`fused_mlp_block`
launches the hand-written CUDA kernel K1 (``csrc/fused_mlp.cu``, which
replaces the Pallas ``_mlp_kernel``) on a CUDA tensor and runs
:func:`fused_mlp_reference`, the plain PyTorch composition, on a CPU tensor.
The kernel keeps the ``[R, 4W]`` hidden activation on chip and takes any
row count R (it masks the ragged last tile), so the TPU kernel's alignment
guard (R % 256, W % 128) is not ported.  It uses ``erff`` for the exact
GELU where the TPU kernel needed a polynomial.
"""

from __future__ import annotations

import torch

from tapclip_tpu_torch.ops import _build


def fused_mlp_reference(x, gamma, beta, w_fc, b_fc, w_proj, b_proj, eps: float = 1e-5):
    """Plain version: ``x + mlp(layer_norm(x))`` as ``models/layers.py`` composes it."""
    from tapclip_tpu_torch.models import layers

    p_ln = {"scale": gamma, "bias": beta}
    p_mlp = {"w_fc": w_fc, "b_fc": b_fc, "w_proj": w_proj, "b_proj": b_proj}
    return x + layers.mlp_forward(layers.layer_norm(x, p_ln, eps), p_mlp, "gelu")


def fused_mlp_block(x: torch.Tensor, ln_params, mlp_params, *, eps: float = 1e-5) -> torch.Tensor:
    """``x + mlp(layer_norm(x))`` for ``x [B, T, W]``: K1 on CUDA, plain on CPU."""
    args = (
        x, ln_params["scale"], ln_params["bias"], mlp_params["w_fc"],
        mlp_params["b_fc"], mlp_params["w_proj"], mlp_params["b_proj"],
    )
    if x.device.type == "cpu":
        return fused_mlp_reference(*args, eps=eps)
    return _fused_mlp_cuda(*args, eps=eps)


fused_mlp_block.launches = 0


def _fused_mlp_cuda(x, gamma, beta, w_fc, b_fc, w_proj, b_proj, *, eps):
    _build.refuse_grad(x, gamma, beta, w_fc, b_fc, w_proj, b_proj)
    B, T, W = x.shape
    H = w_fc.shape[-1]
    R = B * T
    dtype = x.dtype
    if W % 4 or H % 4:
        raise ValueError(f"fused_mlp kernel needs W and H divisible by 4, got W={W}, H={H}")
    f32 = torch.float32
    ops = {
        "x": (x, dtype, (B, T, W)),
        "gamma": (gamma.to(f32), f32, (W,)),
        "beta": (beta.to(f32), f32, (W,)),
        "w_fc": (w_fc.to(dtype), dtype, (W, H)),
        "b_fc": (b_fc.to(f32), f32, (H,)),
        "w_proj": (w_proj.to(dtype), dtype, (H, W)),
        "b_proj": (b_proj.to(f32), f32, (W,)),
    }
    for name, (t, dt, shape) in ops.items():
        _build.check_cuda_operand(name, t, dt, shape)
    out = torch.empty_like(x)
    lib = _build.library()
    err = lib.tapclip_fused_mlp(
        *(t.data_ptr() for t, _, _ in ops.values()), out.data_ptr(),
        R, W, H, float(eps), _build.dtype_code(dtype), _build.stream_handle(x.device),
    )
    _build.check(err, "tapclip_fused_mlp")
    fused_mlp_block.launches += 1
    return out
