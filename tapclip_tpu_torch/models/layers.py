"""Functional transformer building blocks.

Counterpart of ``tapclip_tpu/models/layers.py``: plain functions over
parameter dicts of tensors in the JAX package's layout (linear weights
``[in, out]``).  Parameters are stored in float32; compute runs in the
config's dtype, with LayerNorm and softmax statistics in f32 and every
product accumulated in f32, as in the JAX package.  A stack of blocks is a
list of per-block dicts (the JAX package stacks them along a leading axis).

Routing follows ``tapclip_tpu/models/layers.py`` as it routes on a TPU,
by ``impl``:

* ``"auto"`` / ``"fused"``: a non-causal block without the attribution aux
  runs the fused attention block (kernel K2); a causal block (the text
  tower) never does: its ``attn_forward`` runs the plain QKV projection, the
  packed-QKV attention core (B6, ``fused_mha``) and the plain
  out-projection.  The aux layer runs ``attn_forward`` around the attention
  kernel K3 (causal or not).
* ``"fused_split"``: every block runs the plain projections around B6 (K3
  for the aux layer), non-causal vision blocks included.
* ``"xla"``: the plain composition everywhere.

Every ``gelu`` MLP runs the fused MLP (K1) except under ``"xla"``.  As in the
JAX package, ``impl="fused"`` with ``attn_to_idx`` runs B6 and returns no
aux.  Each kernel wrapper launches its CUDA kernel on a CUDA tensor and its
plain version on a CPU tensor.  The QKV and out-projections stay
``torch.matmul``: the JAX package computes them outside any Pallas kernel.

``quantize`` (``CLIPConfig.quantize_tower``, the frozen tower's eval path)
routes as the JAX package does, whatever ``impl``: a non-causal block without
the attribution aux and with an int (or no) ``kv_valid_len`` runs the int8
attention half-block (B14, ``int8_attn_block``), and every ``gelu`` MLP the
int8 MLP (B13, ``int8_mlp_block``); ``quantize_deterministic``
(``int8_deterministic``) picks round-to-nearest in both.  Neither has a
gradient.

**Tensor parallelism** (``tp_group``, or the group
``parallel.collectives.tensor_parallel`` sets around a mesh step's
forward): each block holds its ranks' heads and hidden columns
(``parallel/sharding.py``'s cut; ``n_heads`` stays the tower's and must
divide by the group's size).  K2 and K1 run in their partial modes, whose
backwards are B4's and B5's (``fused_attn_block`` / ``fused_mlp_block``
with ``tp_group``); the other routes put Megatron's ``copy_to_model`` on the
LayerNorm output and ``reduce_from_model`` on the f32 out-projection, then
add the output bias once.  The attribution aux is the head mean over the
whole tower: each rank's local head sum, all-reduced, divided by
``n_heads``.  The int8 half-blocks run in B13's and B14's partial modes
(``int8_mlp_block`` / ``int8_attn_block`` with ``tp_group``: the rank's
columns and heads, the row maxima all-reduced MAX and the int32 sums SUM),
whose output is the whole block's bit for bit.

**Sequence parallelism** (``transformer_forward(seq_parallel=True)`` under a
``model`` group, Megatron-SP; JAX's ``act_sharding = P("data", "model",
None)``): between blocks the residual stream is a rank's ``[B, T/tp, W]``
rows.  The tower enters that layout with ``collectives.split_seq`` (T
padded to a multiple of tp first, the pad keys masked by ``kv_valid_len``,
so a pad row never reaches a key set) and leaves it with ``join_seq``
before the caller's ``ln_final``, pooling and projection.  K2 and K1 take
the rank's rows, all-gather them over T, run their partial modes on the
whole rows and reduce-scatter the f32 partials over T where tp alone
all-reduces them (B4's and B5's summed dy likewise).  The other routes
run the LayerNorm on the rank's rows, all-gather its output
(``gather_seq``) into the column-parallel product and reduce-scatter the
row-parallel product (``scatter_seq_sum``); the LayerNorm's scale and bias
and the output bias then pass through ``copy_to_model``, whose backward
sums their gradients, each of the rank's rows only, over the group.  An
int8 half-block (eval only) gathers the rank's rows (``join_seq``), runs in
its partial mode on the whole sequence and keeps the rank's rows after it
(``split_seq``), as the MoE blocks do.  Deep
prompts (VPT-deep, MaPLe's ``layer_prompts``) overwrite their slots on
whichever ranks hold them after the pad (a range may straddle two ranks);
the prompts pass through ``copy_to_model``, so their gradient, each rank's
slots' part, is summed over the group.

**FSDP** (``collectives.fully_sharded`` around a step's forward): each
block's leaves cut over ``data`` are all-gathered at the block's use
(``collectives.FullySharded.gathered``), inside the remat region, so a
rematerialised block gathers them again; their gradients reduce-scatter
back.

Every other kernel differentiates: ``fused_attn_block``, ``fused_mha``,
``fused_mlp_block`` and ``fused_attention`` are ``torch.autograd.Function`` s
whose backward is the hand-written B4 / B7 / B5 / flash chain on the card
(weight gradients only where a parameter requires one).  Under
``attn_impl="pallas"`` every block runs K3 between the plain projections and
the plain MLP, and differentiates through the flash chain; the attribution
pass runs under ``no_grad`` (the aux column is detached), so it saves nothing.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from tapclip_tpu_torch.ops.attention import IntOrTensor, multi_head_attention
from tapclip_tpu_torch.ops.fused_mha import fused_attn_block, fused_mha
from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block
from tapclip_tpu_torch.ops.int8_attn import int8_attn_block
from tapclip_tpu_torch.ops.int8_mlp import int8_mlp_block
from tapclip_tpu_torch.ops.plain import ACTS, dense, layer_norm, mlp_forward
from tapclip_tpu_torch.parallel import collectives

Params = Dict[str, Any]


def normal_init(generator: torch.Generator, shape, std: float, device=None) -> torch.Tensor:
    """``N(0, std^2)`` f32 values drawn on ``generator``'s device, moved to
    ``device`` (default: the generator's)."""
    t = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (t * std).to(device or generator.device)


def init_layer_norm(width: int, device=None) -> Params:
    return {"scale": torch.ones(width, device=device), "bias": torch.zeros(width, device=device)}


def init_attn(generator: torch.Generator, width: int, device=None) -> Params:
    """The attention half's weights, the JAX init's shapes and scales."""
    std = width ** -0.5
    return {
        "w_qkv": normal_init(generator, (width, 3 * width), std, device),
        "b_qkv": torch.zeros(3 * width, device=device),
        "w_out": normal_init(generator, (width, width), std, device),
        "b_out": torch.zeros(width, device=device),
    }


def attn_forward(
    x: torch.Tensor,
    p: Params,
    n_heads: int,
    *,
    causal: bool = False,
    kv_valid_len: IntOrTensor = None,
    attn_to_idx: IntOrTensor = None,
    impl: str = "auto",
    tp_group=None,
    seq: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused-QKV multi-head self attention over ``x [B, T, W]``.  With
    ``tp_group`` the weights are a rank's ``n_heads`` heads (the per-head
    cut): the out-projection's f32 partials are all-reduced before
    ``b_out`` (``seq``: reduce-scattered over T, the result this rank's
    rows), and the aux is the tower's head mean (local head sums
    all-reduced, divided by every rank's heads)."""
    B, T, _ = x.shape
    W = p["w_qkv"].shape[-1] // 3  # the heads' width (a rank's, under tp_group)
    Dh = W // n_heads
    qkv = dense(x, p["w_qkv"], p["b_qkv"])

    resolved = impl
    if impl in ("auto", "fused_split"):
        if attn_to_idx is not None:
            resolved = "pallas"  # needs the attribution aux column (K3)
        elif kv_valid_len is None or isinstance(kv_valid_len, int):
            resolved = "fused"  # the packed-QKV core (B6)
        else:
            resolved = "xla"
    if resolved == "fused":
        out = fused_mha(qkv, n_heads, valid_len=kv_valid_len, causal=causal)
        return _out_proj(out, p, tp_group, seq), None

    def heads(t):  # [B, T, W] -> [B, H, T, Dh]
        return t.reshape(B, T, n_heads, Dh).transpose(1, 2).contiguous()

    q, k, v = qkv.split(W, dim=-1)
    out, aux = multi_head_attention(
        heads(q), heads(k), heads(v), causal=causal,
        kv_valid_len=kv_valid_len, attn_to_idx=attn_to_idx, impl=resolved,
    )
    out = out.transpose(1, 2).reshape(B, T, W)
    if aux is not None and tp_group is not None:
        n = collectives.size(tp_group)
        aux = collectives.all_reduce_(aux * n_heads, tp_group) / (n_heads * n)
    return _out_proj(out, p, tp_group, seq), aux


def _out_proj(out, p, tp_group, seq=False):
    """``out . w_out + b_out``; under ``tp_group`` the f32 partials summed
    over the group first."""
    return _row_parallel(out, p["w_out"], p["b_out"], tp_group, seq)


def _row_parallel(h, w, b, tp_group, seq=False):
    """``dense(h, w, b)`` with the f32 product summed over ``tp_group``
    before ``b`` (Megatron's row-parallel product; ``dense`` itself, bit for
    bit, with no group).  ``seq``: reduce-scattered over T instead, ``b``
    added to this rank's rows (its gradient summed over the group)."""
    acc = torch.matmul(h.float(), w.to(h.dtype).float())
    if seq:
        return (collectives.scatter_seq_sum(acc, tp_group)
                + collectives.copy_to_model(b, tp_group).float()).to(h.dtype)
    return (collectives.reduce_from_model(acc, tp_group) + b.float()).to(h.dtype)


def _ln_in(x, ln, eps, tp_group, seq):
    """The LayerNorm output a column-parallel product reads: under
    ``tp_group`` through ``copy_to_model``; ``seq``: the LayerNorm of this
    rank's rows (scale and bias through ``copy_to_model``) all-gathered over
    T (``gather_seq``)."""
    if seq:
        ln = {k: collectives.copy_to_model(v, tp_group) for k, v in ln.items()}
        return collectives.gather_seq(layer_norm(x, ln, eps), tp_group)
    return collectives.copy_to_model(layer_norm(x, ln, eps), tp_group)


def _check_tp(n_heads: int, tp_group) -> int:
    """A rank's head count under ``tp_group`` (``n_heads`` without one)."""
    if tp_group is None:
        return n_heads
    n = collectives.size(tp_group)
    if n_heads % n:
        raise ValueError(f"n_heads {n_heads} is not divisible by tp={n}")
    return n_heads // n


def _int8_half(half, x, tp_group, seq: bool):
    """``half(x)``, an int8 half-block, on the whole sequence: under ``seq``
    the rank's rows gathered first and kept after (no gradient flows)."""
    if not seq:
        return half(x)
    return collectives.split_seq(half(collectives.join_seq(x, tp_group)), tp_group)


def block_forward(
    x: torch.Tensor,
    p: Params,
    n_heads: int,
    *,
    act: str,
    ln_eps: float = 1e-5,
    causal: bool = False,
    kv_valid_len: Optional[int] = None,
    attn_to_idx: IntOrTensor = None,
    impl: str = "auto",
    quantize: bool = False,
    quantize_deterministic: bool = False,
    tp_group=None,
    seq: bool = False,
    fsdp: Optional[collectives.FullySharded] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pre-LN residual attention block (open_clip ResidualAttentionBlock);
    ``tp_group``: tensor parallel over the group; ``seq``: ``x`` is this
    rank's rows of the sequence (sequence parallel over ``tp_group``);
    ``fsdp``: the block's leaves cut over ``data`` are gathered first (the
    module note)."""
    plain_attn_block = attn_to_idx is None and not causal and (
        kv_valid_len is None or isinstance(kv_valid_len, int)
    )
    n_heads = _check_tp(n_heads, tp_group)
    seq = seq and tp_group is not None
    if fsdp is not None:
        p = fsdp.gathered(p)
    if quantize and plain_attn_block:
        x = _int8_half(lambda t: int8_attn_block(
            t, p["ln_1"], p["attn"], n_heads, valid_len=kv_valid_len, eps=ln_eps,
            deterministic=quantize_deterministic, tp_group=tp_group,
        ), x, tp_group, seq)
        aux = None
    elif impl in ("auto", "fused") and plain_attn_block:
        x = fused_attn_block(
            x, p["ln_1"], p["attn"], n_heads, valid_len=kv_valid_len, eps=ln_eps, tp_group=tp_group, seq=seq
        )
        aux = None
    else:
        h, aux = attn_forward(
            _ln_in(x, p["ln_1"], ln_eps, tp_group, seq), p["attn"], n_heads, causal=causal,
            kv_valid_len=kv_valid_len, attn_to_idx=attn_to_idx, impl=impl, tp_group=tp_group, seq=seq,
        )
        x = x + h
    if quantize and act == "gelu":
        x = _int8_half(lambda t: int8_mlp_block(t, p["ln_2"], p["mlp"], eps=ln_eps,
                                                deterministic=quantize_deterministic, tp_group=tp_group),
                       x, tp_group, seq)
    elif act == "gelu" and impl in ("auto", "fused", "fused_split"):
        x = fused_mlp_block(x, p["ln_2"], p["mlp"], eps=ln_eps, tp_group=tp_group, seq=seq)
    else:
        m = p["mlp"]
        y = _ln_in(x, p["ln_2"], ln_eps, tp_group, seq)
        x = x + _row_parallel(ACTS[act](dense(y, m["w_fc"], m["b_fc"])), m["w_proj"], m["b_proj"], tp_group, seq)
    return x, aux


def transformer_forward(
    x: torch.Tensor,
    blocks: List[Params],
    n_heads: int,
    *,
    act: str,
    ln_eps: float = 1e-5,
    causal: bool = False,
    kv_valid_len: Optional[int] = None,
    attn_to_idx: IntOrTensor = None,
    impl: str = "auto",
    quantize: bool = False,
    quantize_deterministic: bool = False,
    layer_prompts: Optional[torch.Tensor] = None,
    prompt_offset: int = 1,
    prompt_mask=None,
    remat: str = "none",
    tp_group=None,
    seq_parallel: bool = False,
    runner=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the blocks in order; the attribution aux comes from the last one.

    ``tp_group`` (default: ``collectives.current_model_group()``, the group
    a mesh step sets): every block runs tensor parallel over it.
    ``seq_parallel`` (with a group): the blocks run sequence parallel over
    it (the module note); no-op without one.  Under
    ``collectives.fully_sharded`` each block gathers its FSDP leaves.
    ``runner`` (``parallel/pipeline.py``'s GPipe schedule) takes the place
    of the loop over the blocks, :func:`run_blocks`'s signature.

    The reference hooks the last text block's attention, so only the last
    block gets ``attn_to_idx`` (the JAX package runs it outside its scan).

    ``layer_prompts [n_layers-1, P, W]`` (MaPLe's deep prompts): row ``i``
    overwrites token slots ``prompt_offset .. prompt_offset+P`` of block
    ``i``'s output, so block ``i+1`` sees fresh prompts at its input; the
    last block's output is never overwritten.  ``prompt_mask [n_layers-1]``
    (bool; None: every row) leaves the rows it marks False inert.  The
    overwrite is out of place (a new tensor from ``torch.cat``, or a
    ``torch.where`` on the rank's rows under sequence parallelism): the
    kernels' autograd Functions save their inputs for the backward.

    ``remat`` (``CLIPConfig.remat``: "none", "dots" or "full") checkpoints
    each block under a graph (``torch.utils.checkpoint``, non-reentrant):
    the block's forward runs again in the backward, so its kernels launch
    twice.  Eager PyTorch has no policy that keeps the products' outputs, so
    "dots" recomputes the whole block, as "full" does; the gradients equal
    those without remat either way.
    """
    if remat not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat policy {remat!r}")
    if tp_group is None:
        tp_group = collectives.current_model_group()
    seq = seq_parallel and tp_group is not None
    T = x.shape[1]
    if seq:
        x, kv_valid_len = enter_seq(x, tp_group, kv_valid_len)
    kw = dict(act=act, ln_eps=ln_eps, causal=causal, kv_valid_len=kv_valid_len, impl=impl,
              quantize=quantize, quantize_deterministic=quantize_deterministic, tp_group=tp_group, seq=seq,
              fsdp=collectives.current_fsdp())
    x, aux = (runner or run_blocks)(x, blocks, n_heads, remat, kw, attn_to_idx=attn_to_idx,
                                    layer_prompts=layer_prompts, prompt_offset=prompt_offset, prompt_mask=prompt_mask)
    if seq:
        x = collectives.join_seq(x, tp_group)[:, :T]
        aux = None if aux is None else aux[:, :T]
    return x, aux


def enter_seq(x: torch.Tensor, tp_group, kv_valid_len):
    """``x [B, T, W]`` (every rank's) -> (this rank's ``T/n`` rows, the key
    length to mask): T padded to a multiple of the group's size first, the
    pad rows masked as keys (``kv_valid_len``, T when it was None) and
    sliced off after the tower."""
    T = x.shape[1]
    n = collectives.size(tp_group)
    Tp = -(-T // n) * n
    if Tp != T:
        x = torch.nn.functional.pad(x, (0, 0, 0, Tp - T))
        kv_valid_len = T if kv_valid_len is None else kv_valid_len
    return collectives.split_seq(x, tp_group), kv_valid_len


def _overwrite_rows(x: torch.Tensor, rows: torch.Tensor, offset: int, seq: bool, tp_group) -> torch.Tensor:
    """``x`` with token slots ``offset .. offset + P`` set to ``rows [P, W]``,
    out of place.  ``seq``: ``x`` is this rank's ``T/n`` rows, and only the
    slots it holds are set (a range may straddle two ranks); every rank
    selects from ``rows`` (a ``torch.where``), so every rank's graph holds
    it and its gradient, each rank's slots' part, meets the others in the
    caller's all-reduce."""
    P = rows.shape[0]
    if not seq:
        rows = rows.to(x.dtype).expand(x.shape[0], P, x.shape[-1])
        return torch.cat([x[:, :offset], rows, x[:, offset + P:]], dim=1)
    Tl = x.shape[1]
    pos = torch.arange(Tl, device=x.device) + collectives.rank_in(tp_group) * Tl - offset
    held = (pos >= 0) & (pos < P)
    return torch.where(held[None, :, None], rows[pos.clamp(0, P - 1)].to(x.dtype)[None], x)


def run_blocks(x, blocks: List[Params], n_heads: int, remat: str, kw: Dict[str, Any], *, attn_to_idx=None,
               layer_prompts=None, prompt_offset: int = 1, prompt_mask=None):
    """The loop over the blocks (:func:`block_forward` with ``kw``), the
    aux from the last one, each block checkpointed under ``remat`` (the
    arguments of :func:`transformer_forward`)."""
    active = [] if layer_prompts is None else (
        [True] * layer_prompts.shape[0] if prompt_mask is None else [bool(m) for m in prompt_mask])
    seq = kw.get("seq", False)
    if seq and any(active):  # each rank sets its slots: the prompts' gradient summed over the group
        layer_prompts = collectives.copy_to_model(layer_prompts, kw["tp_group"])
    checkpointed = remat != "none" and torch.is_grad_enabled()
    last, aux = len(blocks) - 1, None
    for i, blk in enumerate(blocks):
        to_idx = attn_to_idx if i == last else None
        if checkpointed:
            x, aux = checkpoint(block_forward, x, blk, n_heads, attn_to_idx=to_idx, use_reentrant=False, **kw)
        else:
            x, aux = block_forward(x, blk, n_heads, attn_to_idx=to_idx, **kw)
        if i < last and i < len(active) and active[i]:
            x = _overwrite_rows(x, layer_prompts[i], prompt_offset, seq, kw.get("tp_group"))
    return x, aux
