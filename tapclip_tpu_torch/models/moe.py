"""Mixture-of-experts MLP blocks for the transformer towers.

Counterpart of ``tapclip_tpu/models/moe.py``: Switch top-1 routing (Fedus
et al. 2021) with a static per-group capacity, in the spirit of LIMoE.  A
block's attention half is ``layers.attn_forward``, as in the JAX package
(the packed-QKV core B6, or K3 on the attribution layer); its MLP half is a
bank of ``E`` expert MLPs, ``w_fc [E, W, H]``, ``b_fc [E, H]``, ``w_proj
[E, H, W]``, ``b_proj [E, W]``, and a router ``router.w [W, E]``.  A stack
of blocks is a list of per-block dicts, as in ``models/layers.py``.

Routing (:func:`route`, in f32): the softmax of the router logits, the
argmax expert (the first maximum, as ``jnp.argmax``), each token's position
in its expert's queue by a cumulative sum over its group (one sequence),
and the token kept when that position is below ``C = expert_capacity(T, E,
capacity_factor)``.  With ``valid_len`` the rows from ``valid_len`` on (the
towers' pad rows) take no capacity and stay out of the load-balance
statistics.  A dropped or pad token outputs exactly 0, bias included, and
its residual passes through.

Dispatch and combine run by index (:func:`slots`, :func:`dispatch`,
:func:`combine`): each kept token's row is copied into slot ``(expert,
batch row, position)`` of an ``[E, B*C, W]`` bank whose other slots are 0,
the expert products run over every slot (one ``torch.bmm`` per product, as
the JAX package's einsums run every slot), and each kept token reads its
slot's output times its gate.  In the JAX
package's dense one-hot einsums each of those values is one product by 1
(dispatch) or by the gate (combine) plus exact zeros, so both forms give
the same values (``tests/port/test_torch_moe.py``).  The JAX package
computes all of this outside any Pallas kernel, so here it is plain
PyTorch.

Precision, as the JAX package's: the router in f32; the expert products on
operands rounded to the compute dtype, accumulated in f32; ``h + b_fc`` in
f32, rounded to the dtype before the activation, which runs in the dtype;
``out + b_proj`` and the combine in f32, the block's output rounded last.
Every product here is IEEE f32 (TF32 off in its forward and its backward,
whatever the process setting: :func:`ieee_f32_matmuls`), so a dispatch stays
exact and the f32 products match the plain path.

The load-balance term is the Switch one, ``E * sum_e f_e p_e`` (1 at
perfect balance), averaged over the groups; :func:`moe_transformer_forward`
sums it over the blocks, and the pretraining steps add it with weight
``CLIPConfig.moe_aux_weight``.

**Expert parallelism** (``tp_group``, or the group
``parallel.collectives.tensor_parallel`` sets): a rank holds ``E / tp``
experts of each bank, experts ``j * E/tp .. (j + 1) * E/tp - 1`` on model
rank ``j`` (``parallel/sharding.py``), and the router whole.  Every rank
routes the same (replicated) activations with the same router, so every
rank takes the same decisions; it dispatches only the tokens routed to its
own experts, runs their products, and combines them into an f32 partial
``[B, T, W]`` (0 for every other token) that is all-reduced over the group,
which is the sum XLA computes for the JAX package's combine einsum.  The
expert half sits in Megatron's pair: the dispatched input and the gate pass
through ``copy_to_model`` (their gradients, each a rank's experts' part,
summed over the group) and the partial through ``reduce_from_model``, so
the input's and the router's gradients come out whole.  The load-balance
term reads the router's probabilities, whole and equal on every rank: its
gradient is taken once, never summed over the group.  The attention half
runs on the rank's heads (``layers.attn_forward`` with the group: B6, or K3
with the head-sum all-reduce on the attribution layer).

**Sequence parallelism** (``seq_parallel``, JAX's ``act_sharding``, which
the JAX package's MoE scan keeps as a layout constraint): between blocks
the residual stream is the rank's rows, as in ``layers.transformer_forward``
(T padded to a multiple of tp, the pad rows masked as keys and kept out of
the routing).  Routing needs a whole sequence (the capacity queue is a
cumulative sum over it), so each block gathers the rows
(``collectives.join_seq``), runs as under tp alone, and keeps the rank's
rows of its output (``split_seq``).

**FSDP** (``collectives.fully_sharded``): each block gathers its leaves cut
over ``data`` (the banks' ``w_fc`` / ``w_proj`` along dimension 1, and the
attention weights) at its use, inside the remat region.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from tapclip_tpu_torch.models import layers
from tapclip_tpu_torch.ops.plain import ACTS
from tapclip_tpu_torch.parallel import collectives

Params = Dict[str, Any]

_TF32_LOCK = threading.Lock()


def expert_capacity(seq_len: int, n_experts: int, capacity_factor: float) -> int:
    """Static per-group capacity: ``ceil(seq_len * capacity_factor /
    n_experts)`` rounded up to a multiple of 8, never past the group (and at
    least ``min(8, seq_len)``)."""
    c = int(-(-seq_len * capacity_factor // n_experts))  # ceil
    c = -(-c // 8) * 8
    return max(min(c, seq_len), min(8, seq_len))


# --- init (random: the numbers differ from jax.random's; tests bridge JAX trees) ---


def init_moe_mlp(generator: torch.Generator, width: int, hidden: int, n_experts: int, device=None) -> Params:
    """An expert bank and its router, the JAX init's shapes and scales (a
    near-uniform router: ``N(0, 0.02^2)``)."""
    normal = functools.partial(layers.normal_init, generator, device=device)
    return {
        "router": {"w": normal((width, n_experts), 0.02)},
        "w_fc": normal((n_experts, width, hidden), width ** -0.5),
        "b_fc": torch.zeros(n_experts, hidden, device=device),
        "w_proj": normal((n_experts, hidden, width), hidden ** -0.5),
        "b_proj": torch.zeros(n_experts, width, device=device),
    }


def init_moe_block(generator: torch.Generator, width: int, n_experts: int, mlp_ratio: int = 4,
                   device=None) -> Params:
    return {
        "ln_1": layers.init_layer_norm(width, device),
        "attn": layers.init_attn(generator, width, device),
        "ln_2": layers.init_layer_norm(width, device),
        "moe": init_moe_mlp(generator, width, mlp_ratio * width, n_experts, device),
    }


def init_moe_blocks(generator: torch.Generator, n_layers: int, width: int, n_experts: int, mlp_ratio: int = 4,
                    device=None) -> List[Params]:
    return [init_moe_block(generator, width, n_experts, mlp_ratio, device) for _ in range(n_layers)]


# --- IEEE f32 products ------------------------------------------------------------


@contextlib.contextmanager
def ieee_f32_matmuls():
    """cuBLAS's TF32 off for the enclosed products, the caller's setting
    restored after.  The switch is process-wide, so one product at a time
    holds it (a lock)."""
    with _TF32_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


class _Bmm(torch.autograd.Function):
    """``torch.bmm`` with its forward and backward products in IEEE f32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with ieee_f32_matmuls():
            return torch.bmm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        with ieee_f32_matmuls():
            if ctx.needs_input_grad[0]:
                da = torch.bmm(g, b.transpose(1, 2))
            if ctx.needs_input_grad[1]:
                db = torch.bmm(a.transpose(1, 2), g)
        return da, db


def _f32_bmm(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` per batch entry on the operands rounded to ``dtype``,
    accumulated in f32 (``jnp.einsum(..., preferred_element_type=f32)``)."""
    return _Bmm.apply(a.to(dtype).float(), b.to(dtype).float())


# --- routing and the expert MLPs ---------------------------------------------------


class Routing(NamedTuple):
    """One routing decision per token of ``x [B, T, W]``."""

    expert: torch.Tensor  # [B, T] int64: the argmax expert (pad rows too)
    gate: torch.Tensor  # [B, T] f32: the chosen expert's probability, 0 on pad rows
    pos: torch.Tensor  # [B, T] int64: the position in the expert's queue, 0 on pad rows
    keep: torch.Tensor  # [B, T] bool: routed and within capacity
    probs: torch.Tensor  # [B, T, E] f32: the router's softmax, 0 on pad rows (the p_bar statistic)


def _one_hot(expert: torch.Tensor, n_experts: int) -> torch.Tensor:
    """``[..., E]`` int64 one-hot rows (no range check, so no device sync)."""
    return (expert[..., None] == torch.arange(n_experts, device=expert.device)).long()


def _valid_rows(T: int, valid_len: Optional[int], device) -> Optional[torch.Tensor]:
    if valid_len is None or valid_len >= T:
        return None
    return torch.arange(T, device=device) < valid_len


def route(x: torch.Tensor, p: Params, capacity_factor: float = 1.25, valid_len: Optional[int] = None) -> Routing:
    """Switch top-1 routing of ``x [B, T, W]`` under the MLP bank ``p``, in
    f32 (see the module docstring)."""
    B, T, W = x.shape
    E = p["router"]["w"].shape[-1]
    C = expert_capacity(valid_len or T, E, capacity_factor)
    logits = _f32_bmm(x.reshape(1, B * T, W), p["router"]["w"][None], torch.float32).view(B, T, E)
    probs = torch.softmax(logits, dim=-1)
    expert = probs.argmax(dim=-1)
    onehot = _one_hot(expert, E)
    valid = _valid_rows(T, valid_len, x.device)
    if valid is not None:
        onehot = onehot * valid[None, :, None]
        probs = probs * valid[None, :, None]
    gate = probs.gather(-1, expert[..., None])[..., 0]
    pos = (onehot.cumsum(dim=1) * onehot - onehot).sum(dim=-1)
    keep = (pos < C) & (onehot.sum(dim=-1) > 0)
    return Routing(expert, gate, pos, keep, probs)


def slots(r: Routing, capacity: int, n_experts: int, first: int = 0) -> torch.Tensor:
    """Each token's row ``[B*T]`` in the ``[E * B * C]`` bank of experts
    ``first .. first + E - 1``, ``(expert, batch row, position)`` in that
    order; a token not kept, or routed to another bank's expert, gets the
    spare row ``E * B * C``."""
    B = r.expert.shape[0]
    row_base = torch.arange(B, device=r.expert.device)[:, None] * capacity
    bank = n_experts * B * capacity
    local = r.expert - first
    mine = r.keep & (local >= 0) & (local < n_experts)
    return torch.where(mine, local * (B * capacity) + row_base + r.pos, bank).reshape(-1)


def dispatch(x: torch.Tensor, slot: torch.Tensor, n_experts: int, capacity: int) -> torch.Tensor:
    """``x [B, T, W]`` -> the experts' inputs ``[E, B*C, W]`` in x's dtype:
    each kept token's row at its slot, every other slot 0."""
    B, T, W = x.shape
    bank = n_experts * B * capacity
    return x.new_zeros(bank + 1, W).index_copy(0, slot, x.reshape(B * T, W))[:-1].view(n_experts, B * capacity, W)


def combine(out: torch.Tensor, slot: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """The experts' outputs ``[E, B*C, W]`` -> ``[B, T, W]``: each kept
    token's slot times its gate, 0 for every other token."""
    B, T = gate.shape
    W = out.shape[-1]
    rows = torch.cat([out.reshape(-1, W), out.new_zeros(1, W)])
    return rows.index_select(0, slot).view(B, T, W) * gate[..., None]


def moe_mlp_forward(x: torch.Tensor, p: Params, act: str, *, capacity_factor: float = 1.25,
                    valid_len: Optional[int] = None, tp_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 MoE MLP over ``x [B, T, W]`` -> (out ``[B, T, W]`` in x's
    dtype, the load-balance term, an f32 scalar averaged over the B groups).
    ``tp_group``: ``p``'s banks are this rank's experts (the module note)."""
    B, T, W = x.shape
    E = p["router"]["w"].shape[-1]
    E_local = p["w_fc"].shape[0]
    if E_local * collectives.size(tp_group) != E:
        raise ValueError(f"a bank of {E_local} experts under tp={collectives.size(tp_group)} for a router of {E}")
    C = expert_capacity(valid_len or T, E, capacity_factor)
    dtype = x.dtype
    r = route(x, p, capacity_factor, valid_len)
    slot = slots(r, C, E_local, collectives.rank_in(tp_group) * E_local)
    xin = dispatch(collectives.copy_to_model(x, tp_group), slot, E_local, C)
    h = _f32_bmm(xin, p["w_fc"], dtype) + p["b_fc"].float()[:, None]
    h = ACTS[act](h.to(dtype))
    out = _f32_bmm(h, p["w_proj"], dtype) + p["b_proj"].float()[:, None]
    y = combine(out, slot, collectives.copy_to_model(r.gate, tp_group))
    y = collectives.reduce_from_model(y, tp_group).to(dtype)

    # Switch load balance over the valid tokens: f_e the routed share, p_e
    # the mean router probability.
    routed = _one_hot(r.expert, E).float()
    valid = _valid_rows(T, valid_len, x.device)
    n_valid = T
    if valid is not None:
        routed = routed * valid[None, :, None]
        n_valid = valid_len
    f = routed.sum(dim=1) / n_valid
    pbar = r.probs.sum(dim=1) / n_valid
    lb = E * (f * pbar).sum(dim=-1).mean()
    return y, lb


def moe_block_forward(x: torch.Tensor, p: Params, n_heads: int, *, act: str, ln_eps: float = 1e-5,
                      causal: bool = False, kv_valid_len=None, attn_to_idx=None, impl: str = "auto",
                      capacity_factor: float = 1.25, tp_group=None, seq: bool = False,
                      fsdp: Optional[collectives.FullySharded] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Pre-LN residual block with an MoE MLP half -> (x, lb, the attention
    aux of ``attn_to_idx`` or None).  The rows route with ``valid_len`` only
    when ``kv_valid_len`` is an int (the towers' pad length): with a per-row
    tensor every row routes and takes capacity, as in the JAX package.
    ``tp_group``: the rank's heads and experts; ``seq``: ``x`` is the rank's
    rows (gathered in, the output's rows kept); ``fsdp``: the leaves cut
    over ``data`` gathered first (the module note)."""
    n_local = layers._check_tp(n_heads, tp_group)
    if fsdp is not None:
        p = fsdp.gathered(p)
    if seq:
        x = collectives.join_seq(x, tp_group)
    h, aux = layers.attn_forward(
        layers._ln_in(x, p["ln_1"], ln_eps, tp_group, False), p["attn"], n_local, causal=causal,
        kv_valid_len=kv_valid_len, attn_to_idx=attn_to_idx, impl=impl, tp_group=tp_group,
    )
    x = x + h
    y, lb = moe_mlp_forward(
        layers.layer_norm(x, p["ln_2"], ln_eps), p["moe"], act, capacity_factor=capacity_factor,
        valid_len=kv_valid_len if isinstance(kv_valid_len, int) else None, tp_group=tp_group,
    )
    x = x + y
    return (collectives.split_seq(x, tp_group) if seq else x), lb, aux


def moe_transformer_forward(
    x: torch.Tensor,
    blocks: List[Params],
    n_heads: int,
    *,
    act: str,
    ln_eps: float = 1e-5,
    causal: bool = False,
    kv_valid_len=None,
    attn_to_idx=None,
    impl: str = "auto",
    quantize: bool = False,
    quantize_deterministic: bool = False,
    remat: str = "none",
    capacity_factor: float = 1.25,
    tp_group=None,
    seq_parallel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the MoE blocks in order; ``layers.transformer_forward``'s
    signature, so the towers route here.  The second output follows the
    JAX package's contract:

    * ``attn_to_idx is None`` (pretraining, encoding): the load-balance term
      summed over the blocks, an f32 scalar (the towers' ``moe_loss_out``);
    * ``attn_to_idx`` given (the attribution pass of prompt tuning): the
      last block's attention aux ``[B, T]``, the last block through
      ``attn_forward(..., attn_to_idx=)`` (K3); the load-balance term is
      dropped (prompt tuning freezes the towers, the router included).

    ``remat`` checkpoints each block under a graph, as
    ``layers.transformer_forward`` does (the routing is recomputed from the
    same inputs, so it is the same).  ``quantize`` (the int8 tower) raises.
    ``tp_group`` (default: ``collectives.current_model_group()``),
    ``seq_parallel`` and FSDP (``collectives.fully_sharded``): the module
    note.
    """
    if quantize:
        raise NotImplementedError("int8 quantization of MoE towers")
    if remat not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat policy {remat!r}")
    if tp_group is None:
        tp_group = collectives.current_model_group()
    seq = seq_parallel and tp_group is not None
    T = x.shape[1]
    if seq:
        x, kv_valid_len = layers.enter_seq(x, tp_group, kv_valid_len)
    kw = dict(act=act, ln_eps=ln_eps, causal=causal, kv_valid_len=kv_valid_len, impl=impl,
              capacity_factor=capacity_factor, tp_group=tp_group, seq=seq, fsdp=collectives.current_fsdp())
    checkpointed = remat != "none" and torch.is_grad_enabled()
    last = len(blocks) - 1
    lb_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = None
    for i, blk in enumerate(blocks):
        to_idx = attn_to_idx if i == last else None
        if checkpointed and to_idx is None:
            x, lb, _ = checkpoint(moe_block_forward, x, blk, n_heads, use_reentrant=False, **kw)
        else:
            x, lb, aux = moe_block_forward(x, blk, n_heads, attn_to_idx=to_idx, **kw)
        lb_sum = lb_sum + lb
    if seq:
        x = collectives.join_seq(x, tp_group)[:, :T]
        aux = None if aux is None else aux[:, :T]
    if attn_to_idx is None:
        return x, lb_sum
    return x, aux
