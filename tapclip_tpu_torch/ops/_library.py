"""The ``tapclip`` op namespace: the forward kernels as registered ops.

Every forward kernel that ``utils/model_export.py``'s functions reach is a
``torch.library`` op with a fixed schema, so that ``torch.export`` keeps it
as one opaque node of the exported graph and the dispatcher picks its
implementation when the graph runs:

* ``CPU``: the kernel's plain PyTorch version;
* ``CUDA``: the launcher of the hand-written kernel, which checks its
  operands, launches (and counts the launch on the wrapper's counter) or
  raises; never the plain version;
* a fake kernel (``torch.library.register_fake``) with the exact output
  shapes and dtypes, which is what ``torch.export`` traces.

======================  ====  ==========================================
op                      row   the wrapper whose forward calls it
======================  ====  ==========================================
``tapclip::fused_mlp``  B1    K1, ``fused_mlp.fused_mlp_block``
``tapclip::attn_block`` B2    K2, ``fused_mha.fused_attn_block``
``tapclip::attn_aux``   B3    K3, ``flash_attention.fused_attention``
``tapclip::mha``        B6    ``fused_mha.fused_mha``
``tapclip::int8_mlp``   B13   ``int8_mlp.int8_mlp_block`` (weights quantized)
``tapclip::int8_attn``  B14   ``int8_attn.int8_attn_block`` (weights quantized)
======================  ====  ==========================================

The autograd Functions' forwards reach the ops through ``_build.run``:
traced (``torch.export``, a dispatch mode) they call the op, and the graph
keeps it; on a plain tensor they call the op's own CPU or CUDA
implementation directly, the same function without the dispatcher's
round trip into Python.  Either way an eager call, a training step and an
exported program run the same kernels and count the same launches; the
backward kernels are unchanged (an export holds no backward).  The int8
wrappers, eval only, call their ops on every device.  ``attn_aux`` takes
the valid length and the attribution key each as an optional ``[B]``
tensor beside the int every row takes without one, as K3's C entry does,
and returns an empty aux without ``with_aux``.

The ops are defined with the low-level ``Library`` API rather than the
``torch.library.custom_op`` decorator: its Python wrapper costs several
times the dispatcher's own per call, which an exported program pays at
each of its nodes.  Importing :mod:`tapclip_tpu_torch.ops` registers them
(``ops/__init__.py``); an exported program needs this module and the
launchers it imports, no model code.
"""

from __future__ import annotations

import torch

from tapclip_tpu_torch.ops import flash_attention, fused_mha, fused_mlp, int8_attn, int8_mlp

_LIB = torch.library.Library("tapclip", "DEF")


def _late(module, name):
    """``module.name`` looked up at each call, so that a patched attribute
    (a profiler's host span around a launcher, a test's spy) takes effect."""
    def call(*args, **kwargs):
        return getattr(module, name)(*args, **kwargs)
    return call


def _like(x, *_):
    return torch.empty_like(x)


def _mha_fake(qkv, n_heads, valid, causal):
    B, T, W3 = qkv.shape
    return qkv.new_empty((B, T, W3 // 3))


def _attn_aux_fake(q, k, v, valid, valid_all, eot, eot_all, causal, with_aux):
    B, _, T, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, T) if with_aux else (0,), dtype=torch.float32)


# name: (schema, CPU implementation, CUDA implementation, fake kernel)
OPS = {
    "fused_mlp": (
        "fused_mlp(Tensor x, Tensor gamma, Tensor beta, Tensor w_fc, Tensor b_fc, Tensor w_proj, "
        "Tensor b_proj, float eps) -> Tensor",
        _late(fused_mlp, "fused_mlp_reference"),
        _late(fused_mlp, "_fused_mlp_cuda"),
        _like,
    ),
    "attn_block": (
        "attn_block(Tensor x, Tensor gamma, Tensor beta, Tensor w_qkv, Tensor b_qkv, Tensor w_out, "
        "Tensor b_out, int n_heads, int valid, float eps) -> Tensor",
        _late(fused_mha, "attn_block_reference"),
        _late(fused_mha, "_fused_attn_block_cuda"),
        _like,
    ),
    "mha": (
        "mha(Tensor qkv, int n_heads, int valid, bool causal) -> Tensor",
        _late(fused_mha, "fused_mha_reference"),
        _late(fused_mha, "_fused_mha_cuda"),
        _mha_fake,
    ),
    "attn_aux": (
        "attn_aux(Tensor q, Tensor k, Tensor v, Tensor? valid, int valid_all, Tensor? eot, int eot_all, "
        "bool causal, bool with_aux) -> (Tensor, Tensor)",
        _late(flash_attention, "attn_aux_plain"),
        _late(flash_attention, "attn_aux_cuda"),
        _attn_aux_fake,
    ),
    "int8_mlp": (
        "int8_mlp(Tensor x, Tensor gamma, Tensor beta, Tensor w_fc, Tensor s_fc, Tensor b_fc, Tensor w_proj, "
        "Tensor s_proj, Tensor b_proj, float eps, int seed, bool deterministic) -> Tensor",
        int8_mlp.int8_mlp_op(_late(int8_mlp, "int8_mlp_plain")),
        int8_mlp.int8_mlp_op(_late(int8_mlp, "int8_mlp_cuda")),
        _like,
    ),
    "int8_attn": (
        "int8_attn(Tensor x, Tensor gamma, Tensor beta, Tensor w_qkv, Tensor s_qkv, Tensor b_qkv, "
        "Tensor w_out, Tensor s_out, Tensor b_out, int n_heads, int valid, float eps, int seed, "
        "bool deterministic) -> Tensor",
        int8_attn.int8_attn_op(_late(int8_attn, "int8_attn_plain")),
        int8_attn.int8_attn_op(_late(int8_attn, "int8_attn_cuda")),
        _like,
    ),
}

for _name, (_schema, _cpu, _cuda, _fake) in OPS.items():
    _LIB.define(_schema)
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"tapclip::{_name}", _fake, lib=_LIB)
