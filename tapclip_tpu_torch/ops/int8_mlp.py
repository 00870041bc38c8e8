"""int8 W8A8 MLP half-block for the frozen-tower eval path (B13), and the
quantization pieces it shares with the int8 attention half-block (B14).

Counterpart of ``tapclip_tpu/ops/int8_mlp.py``: ``x + mlp(layer_norm(x))``
with the weights quantized per output column to int8 (on the fly, every
call, as the JAX package does), the activations quantized per row to int8,
the products summed exactly in int32 and dequantized with the product of the
row and column scales.  Eval only: the JAX kernels have no VJP by design, so
the wrappers raise where autograd would record a graph.

Two modes, each computing what the JAX package computes in it:

* **stochastic** (the default): the Pallas kernel ``_int8_mlp_kernel``'s
  function, ``q = floor(v / s + u)`` with ``s = max(amax, 1e-8) / 127`` and
  ``u = (bits >> 8) * 2^-24``; LayerNorm's output stays f32.  The card cannot
  give the TPU's ``prng_random_bits``, so the bits come from a counter-based
  hash of ``(seed, quantizer, row, column)`` (:func:`rand_bits`), computed
  the same way in the CUDA kernel and here: the kernel and its plain version
  see identical draws.  ``seed`` is 0 unless the caller passes one, as
  ``block_forward`` passes none in the JAX package.
* **deterministic** (``CLIPConfig.int8_deterministic``): round to nearest,
  ``_xla_int8_reference``'s function (LayerNorm's output rounded to the
  compute dtype before it is quantized).

:func:`int8_mlp_block` launches the hand-written CUDA kernels of B13
(``csrc/int8_mlp.cu``: LayerNorm and codes, the fc product, the hidden
rows' codes, the proj product, on the int8 tensor cores) on a CUDA tensor in
either mode, and runs the plain version (:func:`int8_mlp_plain`) on a CPU
tensor, through the op ``tapclip::int8_mlp`` (``ops/_library.py``) after the
weights are quantized in torch.  The TPU wrapper sends the
shapes its kernel rejects (``W % 128``, ``H % 128``, ``T % 8``, ``B*T % 32``)
to the round-to-nearest model; the card's kernel takes every shape, so the
port rounds stochastically wherever the stochastic mode is asked for
(``ROADMAP.md`` §C).  :func:`int8_mlp_variant` runs the A/B variants of
``scripts/int8_mlp_ab.py`` (S5: ``erf3``, the 3-term erf in GELU;
``recipmul``, the codes by ``v * (127 / amax)``) as B13's own launches with
those switches, stochastic mode only.

**The partial mode** (tensor parallelism, ``int8_mlp_block(tp_group=)``):
each rank holds fc's columns of its hidden slice and the same rows of proj
(``parallel/sharding.py``'s cut).  :func:`quantize_mlp` then takes proj's
per-column scales over the whole weight (the rank's column max all-reduced
MAX over the group), and the block runs in three stages with a collective
between each two (:func:`run_partial`):

1. the front, the op ``tapclip::int8_mlp`` with ``partial``: LayerNorm and
   its codes (replicated), fc + GELU on the rank's columns, each hidden
   row's local |h| max, as one f32 workspace ``[h (R x H/n) | max (R)]``;
2. the row max all-reduced MAX; ``tapclip::int8_partial_out``: the hidden
   codes from it, each column drawing the bits of its global index
   (``col0``), and proj's int32 sums over the rank's depth ``[R, W]``;
3. the sums all-reduced SUM (exact: 127^2 H is far below 2^31);
   ``tapclip::int8_epilogue``: ``(acc t2) s_proj + b_proj + x``.

Each stage computes what the whole block computes on the same values, so
the ranks' output is the whole block's bit for bit, in either mode.  On a
CPU tensor the stages are plain (:func:`int8_mlp_front_plain`,
:func:`partial_out_plain`, :func:`epilogue_plain`); on a CUDA tensor they
launch ``csrc/int8_mlp.cu``'s partial entries, each counting its launches.
The int8 attention half-block (:mod:`.int8_attn`) has a front of its own
and shares stages 2 and 3.
"""

from __future__ import annotations

from typing import Dict

import torch

from tapclip_tpu_torch.ops import _build
from tapclip_tpu_torch.parallel import collectives

# The activation quantizers' streams (csrc/int8_common.cuh).
STREAM_MLP_Y, STREAM_MLP_H, STREAM_ATTN_Y, STREAM_ATTN_A = 0, 1, 2, 3

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for int64 ``h`` in [0, 2^32) without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """The "lowbias32" finaliser of ``csrc/int8_common.cuh::mix32``."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def rand_bits(seed: int, stream: int, n_rows: int, n_cols: int, device=None, col0: int = 0) -> torch.Tensor:
    """``[n_rows, n_cols]`` int64 in [0, 2^32): the random bits of quantizer
    ``stream`` for each (row, column), as the CUDA kernels draw them:
    ``mix32(mix32(mix32(mix32(seed ^ 0x9e3779b9) ^ stream) ^ row) ^ col)``,
    the columns ``col0 .. col0 + n_cols`` (a rank's slice of the row)."""
    h = _mix32(torch.tensor((seed & _M32) ^ 0x9E3779B9, dtype=torch.int64, device=device))
    h = _mix32(h ^ stream)
    rows = _mix32(h ^ torch.arange(n_rows, dtype=torch.int64, device=device))
    cols = torch.arange(col0, col0 + n_cols, dtype=torch.int64, device=device)
    return _mix32(rows[:, None] ^ cols[None, :])


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``u = (bits >> 8) * 2^-24`` in f32, exactly as the TPU kernel."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _full(t: torch.Tensor, value: float) -> torch.Tensor:
    # A tensor operand, so that a division is the IEEE one (PyTorch turns a
    # division by a Python scalar into a multiplication by its reciprocal).
    return torch.full_like(t, value)


def quantize_cols_int8(w: torch.Tensor, group=None):
    """``[K, N]`` float -> (int8 values ``[K, N]``, f32 per-column scales ``[N]``):
    symmetric, ``round`` half to even, clipped to +-127.  ``group``: ``w`` is
    a rank's rows of the weight, and each column's max is taken over the
    whole weight's (all-reduced MAX), so its codes are the whole weight's."""
    w = w.float()
    amax = collectives.all_max_(w.abs().amax(dim=0), group)
    scale = amax.clamp_min(1e-8) / _full(amax, 127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def row_quant_rtn(v: torch.Tensor, amax=None):
    """Per-row round-to-nearest: (integer-valued f32 codes, ``[..., 1]`` scales).
    ``amax [..., 1]``: the rows' largest magnitude when ``v`` holds a part of
    each row (the partial mode's global max); by default ``v``'s own."""
    if amax is None:
        amax = v.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-8) / _full(amax, 127.0)
    return torch.clamp(torch.round(v / scale), -127, 127), scale


def row_quant_sr(v: torch.Tensor, bits: torch.Tensor, recipmul: bool = False, amax=None):
    """Per-row stochastic rounding ``floor(v / s + u)``: (integer-valued f32
    codes, ``[..., 1]`` scales).  ``recipmul`` (S5): ``v * (127 / amax)``
    with ``s = 1 / (127 / amax)``.  ``amax``: as :func:`row_quant_rtn`'s."""
    amax = (v.abs().amax(dim=-1, keepdim=True) if amax is None else amax).clamp_min(1e-8)
    u = uniform_from_bits(bits)
    if recipmul:
        inv = _full(amax, 127.0) / amax
        q, scale = torch.floor(v * inv + u), _full(inv, 1.0) / inv
    else:
        scale = amax / _full(amax, 127.0)
        q = torch.floor(v / scale + u)
    return torch.clamp(q, -127, 127), scale


def int_dot(codes: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Integer-valued codes ``[R, K]`` times int8 weights ``[K, N]``: the exact
    int32 sum (a float64 product is exact at these sizes), as f32."""
    return (codes.double() @ w_q.double()).float()


def ln_f32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in f32, ``models/layers.py``'s formula without its cast."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def quantize_activations(v, dtype, seed, stream, deterministic, *, round_input=False, recipmul=False, amax=None,
                         col0=0):
    """Codes and scales of the rows of ``v [R, N]`` (f32) in either mode.
    ``round_input`` rounds ``v`` to ``dtype`` first (the round-to-nearest
    model's LayerNorm output).  ``amax [R, 1]`` and ``col0``: ``v`` holds
    columns ``col0 ..`` of rows whose largest magnitude is ``amax``."""
    if deterministic:
        return row_quant_rtn(v.to(dtype).float() if round_input else v, amax)
    bits = rand_bits(seed, stream, v.shape[0], v.shape[1], device=v.device, col0=col0)
    return row_quant_sr(v, bits, recipmul, amax)


# The quantized weights in ``tapclip::int8_mlp``'s argument order.
Q_MLP = ("w_fc", "s_fc", "b_fc", "w_proj", "s_proj", "b_proj")


def quantize_mlp(mlp, tp_group=None) -> Dict[str, torch.Tensor]:
    """The MLP's weights as the kernel takes them: int8 per-column codes and
    scales, f32 biases.  ``tp_group``: the weights are a rank's cut (fc's
    columns, proj's rows), and proj's column scales are the whole weight's."""
    w_fc, s_fc = quantize_cols_int8(mlp["w_fc"])
    w_proj, s_proj = quantize_cols_int8(mlp["w_proj"], tp_group)
    return {"w_fc": w_fc, "s_fc": s_fc, "b_fc": mlp["b_fc"].float(),
            "w_proj": w_proj, "s_proj": s_proj, "b_proj": mlp["b_proj"].float()}


def erf_as3(x: torch.Tensor) -> torch.Tensor:
    """The A&S 3-term erf of ``scripts/_bench_util.py::erf3`` (S5's variant)."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.47047 * ax)
    y = 1.0 - ((0.7478556 * t + -0.0958798) * t + 0.3480242) * t * torch.exp(-ax * ax)
    return torch.sign(x) * y


def gelu(h: torch.Tensor, use_erf3: bool = False) -> torch.Tensor:
    """Exact GELU ``(0.5 h)(1 + erf(h / sqrt 2))`` in the kernel's order."""
    z = h * 2.0 ** -0.5
    return 0.5 * h * (1.0 + (erf_as3(z) if use_erf3 else torch.erf(z)))


def int8_mlp_plain_parts(x, gamma, beta, q, *, eps=1e-5, seed=0, deterministic=False,
                         erf3=False, recipmul=False) -> Dict[str, torch.Tensor]:
    """:func:`int8_mlp_plain` with its intermediates: the codes and scales of
    LayerNorm's output (``yq``, ``t1``) and of the hidden rows (``h``, ``hq``,
    ``t2``), and ``out`` in x's dtype and shape."""
    shape, W = x.shape, x.shape[-1]
    x2 = x.reshape(-1, W)
    y = ln_f32(x2, gamma, beta, eps)
    yq, t1 = quantize_activations(y, x.dtype, seed, STREAM_MLP_Y, deterministic,
                                  round_input=True, recipmul=recipmul)
    h = gelu(int_dot(yq, q["w_fc"]) * t1 * q["s_fc"] + q["b_fc"], erf3)
    hq, t2 = quantize_activations(h, x.dtype, seed, STREAM_MLP_H, deterministic, recipmul=recipmul)
    out = int_dot(hq, q["w_proj"]) * t2 * q["s_proj"] + q["b_proj"]
    return {"yq": yq, "t1": t1, "h": h, "hq": hq, "t2": t2,
            "out": (out + x2.float()).to(x.dtype).reshape(shape)}


def int8_mlp_plain(x, gamma, beta, q, *, eps=1e-5, seed=0, deterministic=False,
                   erf3=False, recipmul=False):
    """Plain version of B13 on the quantized weights ``q`` (:func:`quantize_mlp`):
    the TPU kernel's function with the port's draws, or (``deterministic``)
    ``_xla_int8_reference``'s.  ``erf3`` / ``recipmul``: S5's variants."""
    return int8_mlp_plain_parts(x, gamma, beta, q, eps=eps, seed=seed, deterministic=deterministic,
                                erf3=erf3, recipmul=recipmul)["out"]


def int8_mlp_reference(x, ln_params, mlp_params, eps: float = 1e-5):
    """The round-to-nearest model, as ``_xla_int8_reference``."""
    return int8_mlp_plain(x, ln_params["scale"], ln_params["bias"], quantize_mlp(mlp_params),
                          eps=eps, deterministic=True)


def int8_mlp_sr_reference(x, ln_params, mlp_params, eps: float = 1e-5, seed: int = 0):
    """What the TPU kernel computes, fed the port's draws of ``seed``."""
    return int8_mlp_plain(x, ln_params["scale"], ln_params["bias"], quantize_mlp(mlp_params),
                          eps=eps, seed=seed)


def int8_mlp_block(x: torch.Tensor, ln_params, mlp_params, *, eps: float = 1e-5, seed: int = 0,
                   deterministic: bool = False, tp_group=None) -> torch.Tensor:
    """``x + mlp_int8(layer_norm(x))`` for ``x [B, T, W]``: B13 on CUDA (either
    mode), plain on CPU.  Eval only.  ``tp_group``: ``mlp_params`` are the
    rank's cut, the block runs in the partial mode (the module note) and
    every rank returns the whole block's output."""
    _build.refuse_graph("int8_mlp_block", x, *ln_params.values(), *mlp_params.values())
    q = quantize_mlp(mlp_params, tp_group)
    args = (x, ln_params["scale"], ln_params["bias"], *(q[k] for k in Q_MLP), eps, seed, deterministic)
    if tp_group is None:
        return torch.ops.tapclip.int8_mlp.default(*args)
    return run_partial(torch.ops.tapclip.int8_mlp.default(*args, True), x, q["w_proj"], q["s_proj"], q["b_proj"],
                       seed=seed, stream=STREAM_MLP_H, deterministic=deterministic, group=tp_group)


int8_mlp_block.launches = 0
int8_mlp_block.partial_launches = 0  # the partial mode's front, one a half-block
int8_mlp_block.variant_launches = 0  # S5 (int8_mlp_variant), off the serving path


def run_partial(ws: torch.Tensor, x: torch.Tensor, w_q: torch.Tensor, s_col: torch.Tensor, b_col: torch.Tensor, *,
                seed: int, stream: int, deterministic: bool, group) -> torch.Tensor:
    """Stages 2 and 3 of an int8 half-block in the partial mode, from its
    front's workspace ``ws``, with the collectives over ``group`` around
    them: the row max all-reduced MAX, ``tapclip::int8_partial_out`` on the
    rank's rows ``w_q`` of the output weight (quantizer ``stream``), the
    int32 sums all-reduced SUM, ``tapclip::int8_epilogue`` with the whole
    weight's column scales ``s_col`` and the bias ``b_col``.  Every rank
    returns the whole block's output."""
    R, n_local = x.numel() // x.shape[-1], w_q.shape[0]
    collectives.all_max_(ws[R * n_local:], group)
    acc = torch.ops.tapclip.int8_partial_out.default(ws, w_q, seed, stream, deterministic,
                                                     collectives.rank_in(group) * n_local)
    collectives.all_reduce_(acc, group)
    return torch.ops.tapclip.int8_epilogue.default(acc, ws, s_col, b_col, x)


def partial_out_plain(ws: torch.Tensor, w_q: torch.Tensor, seed: int, stream: int, deterministic: bool,
                      col0: int) -> torch.Tensor:
    """Stage 2 of the partial mode, plain: from the front's workspace ``ws =
    [v (R x K) | max (R)]`` (the max all-reduced: each row's over the whole
    row), the codes of ``v`` (quantizer ``stream``, column c drawing the
    bits of column ``col0 + c``) times the rank's rows of the weight ``w_q
    [K, N]``: the exact int32 sums ``[R, N]``."""
    K = w_q.shape[0]
    R = ws.numel() // (K + 1)
    v, amax = ws[:R * K].view(R, K), ws[R * K:].view(R, 1)
    codes, _ = quantize_activations(v, None, seed, stream, deterministic, amax=amax, col0=col0)
    return (codes.double() @ w_q.double()).to(torch.int32)


def epilogue_plain(acc: torch.Tensor, ws: torch.Tensor, s_col: torch.Tensor, b_col: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Stage 3 of the partial mode, plain: ``(acc t) s_col + b_col + x`` with
    ``acc [R, N]`` the int32 sums summed over the group and ``t`` the scale
    of each row's max (the last ``R`` entries of ``ws``), one rounding to
    x's dtype."""
    R = acc.shape[0]
    amax = ws[-R:].view(R, 1).clamp_min(1e-8)
    out = acc.float() * (amax / _full(amax, 127.0)) * s_col + b_col
    return (out + x.reshape(R, -1).float()).to(x.dtype).reshape(x.shape)


def front_ws(rows: torch.Tensor) -> torch.Tensor:
    """The front's workspace: ``rows [R, N]`` f32, then each row's |.| max."""
    return torch.cat([rows.reshape(-1), rows.abs().amax(dim=-1)])


def int8_mlp_front_plain(x, gamma, beta, q, *, eps=1e-5, seed=0, deterministic=False):
    """Plain version of the front of B13's partial mode on a rank's
    quantized weights ``q`` (:func:`quantize_mlp` with the group):
    LayerNorm, its codes, fc + GELU on the rank's hidden columns, as the
    workspace ``[h | max]``."""
    y = ln_f32(x.reshape(-1, x.shape[-1]), gamma, beta, eps)
    yq, t1 = quantize_activations(y, x.dtype, seed, STREAM_MLP_Y, deterministic, round_input=True)
    return front_ws(gelu(int_dot(yq, q["w_fc"]) * t1 * q["s_fc"] + q["b_fc"]))


def _f32_operand(name, t, shape):
    t = t.to(torch.float32).contiguous()
    _build.check_cuda_operand(name, t, torch.float32, shape)
    return t


def k_major(w_q: torch.Tensor, Kp: int) -> torch.Tensor:
    """int8 ``[K, N]`` -> int8 ``[N, Kp]``: the transpose, zeros past K, the
    tensor cores' B operand layout (``csrc/int8_mma.cuh``).  On the card S6's
    transpose kernel lays it out (``Kp`` must then be the kernels' depth,
    ``tapclip_int8_gemm_kp(K)``); on the CPU, torch."""
    K, N = w_q.shape
    if w_q.device.type == "cpu":
        out = w_q.new_zeros((N, Kp))
        out[:, :K] = w_q.t()
        return out
    lib = _build.library()
    if Kp != lib.tapclip_int8_gemm_kp(K):
        raise ValueError(f"k_major lays out K={K} to depth {lib.tapclip_int8_gemm_kp(K)} on the card, not {Kp}")
    _build.check_cuda_operand("w_q", w_q, torch.int8, (K, N))
    out = torch.empty((N, Kp), dtype=torch.int8, device=w_q.device)
    _build.check(lib.tapclip_int8_transpose(w_q.data_ptr(), out.data_ptr(), K, N, _build.stream_handle(w_q.device)),
                 "tapclip_int8_transpose")
    return out


def _mlp_operands(x, gamma, beta, q):
    W = x.shape[-1]
    H = q["w_fc"].shape[1]
    _build.check_cuda_operand("x", x, x.dtype)
    for name, shape in (("w_fc", (W, H)), ("w_proj", (H, W))):
        _build.check_cuda_operand(name, q[name], torch.int8, shape)
    f = {name: _f32_operand(name, t, (n,)) for name, t, n in (
        ("gamma", gamma, W), ("beta", beta, W), ("s_fc", q["s_fc"], H), ("b_fc", q["b_fc"], H),
        ("s_proj", q["s_proj"], W), ("b_proj", q["b_proj"], W))}
    return x.numel() // W, W, H, f


def int8_mlp_op(impl, front_impl):
    """``tapclip::int8_mlp``'s implementation from functions of the weights'
    dict ``q``: the whole block (:func:`int8_mlp_plain` or
    :func:`int8_mlp_cuda`) and, with ``partial``, the partial mode's front
    (:func:`int8_mlp_front_plain` or :func:`int8_mlp_front_cuda`)."""
    def op(x, gamma, beta, w_fc, s_fc, b_fc, w_proj, s_proj, b_proj, eps, seed, deterministic, partial=False):
        q = dict(zip(Q_MLP, (w_fc, s_fc, b_fc, w_proj, s_proj, b_proj)))
        return (front_impl if partial else impl)(x, gamma, beta, q, eps=eps, seed=seed, deterministic=deterministic)
    return op


def int8_mlp_cuda(x, gamma, beta, q, *, eps=1e-5, seed=0, deterministic=False):
    """B13 on the card (four launches on the int8 tensor cores) on the
    quantized weights ``q``."""
    out = _launch(x, gamma, beta, q, eps, seed, deterministic, None)
    int8_mlp_block.launches += 1
    return out


def int8_mlp_front_cuda(x, gamma, beta, q, *, eps=1e-5, seed=0, deterministic=False):
    """The front of B13's partial mode on the card (:func:`int8_mlp_front_plain`'s
    function): ``tapclip_int8_mlp_front``, launches 1 and 2 on the rank's
    columns, counted as one partial launch."""
    R, W, H, f = _mlp_operands(x, gamma, beta, q)
    lib = _build.library()
    Wp = lib.tapclip_int8_gemm_kp(W)
    w_fc = k_major(q["w_fc"], Wp)
    dev = x.device
    ws = torch.empty(R * H + R, dtype=torch.float32, device=dev)  # h, then each row's |h| max
    yq = torch.empty((R, Wp), dtype=torch.int8, device=dev)
    t1 = torch.empty(R, dtype=torch.float32, device=dev)
    _build.check(lib.tapclip_int8_mlp_front(
        x.data_ptr(), f["gamma"].data_ptr(), f["beta"].data_ptr(), w_fc.data_ptr(), f["s_fc"].data_ptr(),
        f["b_fc"].data_ptr(), ws.data_ptr(), yq.data_ptr(), t1.data_ptr(), ws.data_ptr() + 4 * R * H, R, W, H,
        float(eps), int(seed) & 0xFFFFFFFF, int(deterministic), _build.dtype_code(x.dtype),
        _build.stream_handle(dev)), "tapclip_int8_mlp_front")
    int8_mlp_block.partial_launches += 1
    return ws


def partial_out_cuda(ws, w_q, seed, stream, deterministic, col0):
    """:func:`partial_out_plain` on the card (``tapclip_int8_partial_out``:
    the codes, then the int32 product on the int8 tensor cores)."""
    K, N = w_q.shape
    R = ws.numel() // (K + 1)
    _build.check_cuda_operand("ws", ws, torch.float32, (R * K + R,))
    _build.check_cuda_operand("w_q", w_q, torch.int8)
    lib = _build.library()
    Kp = lib.tapclip_int8_gemm_kp(K)
    w = k_major(w_q, Kp)
    dev = ws.device
    codes = torch.empty((R, Kp), dtype=torch.int8, device=dev)
    t = torch.empty(R, dtype=torch.float32, device=dev)
    acc = torch.empty((R, N), dtype=torch.int32, device=dev)
    _build.check(lib.tapclip_int8_partial_out(
        ws.data_ptr(), ws.data_ptr() + 4 * R * K, w.data_ptr(), codes.data_ptr(), t.data_ptr(), acc.data_ptr(), R,
        K, N, int(col0), int(seed) & 0xFFFFFFFF, int(stream), int(deterministic), _build.stream_handle(dev)),
        "tapclip_int8_partial_out")
    partial_out_cuda.launches += 1
    return acc


partial_out_cuda.launches = 0


def epilogue_cuda(acc, ws, s_col, b_col, x):
    """:func:`epilogue_plain` on the card (``tapclip_int8_epilogue``)."""
    R, N = acc.shape
    _build.check_cuda_operand("acc", acc, torch.int32)
    _build.check_cuda_operand("ws", ws, torch.float32)
    _build.check_cuda_operand("x", x, x.dtype)
    if x.numel() != R * N:
        raise ValueError(f"x of shape {tuple(x.shape)} does not hold the [{R}, {N}] rows of acc")
    s_col, b_col = _f32_operand("s_col", s_col, (N,)), _f32_operand("b_col", b_col, (N,))
    out = torch.empty_like(x)
    _build.check(_build.library().tapclip_int8_epilogue(
        acc.data_ptr(), ws.data_ptr() + 4 * (ws.numel() - R), s_col.data_ptr(), b_col.data_ptr(), x.data_ptr(),
        out.data_ptr(), R, N, _build.dtype_code(x.dtype), _build.stream_handle(x.device)), "tapclip_int8_epilogue")
    epilogue_cuda.launches += 1
    return out


epilogue_cuda.launches = 0


def int8_mlp_variant(x, gamma, beta, q, *, erf3=False, recipmul=False, eps=1e-5, seed=0, deterministic=False):
    """S5 (eval only) on the quantized weights ``q``: B13's launches with the
    switches of ``scripts/int8_mlp_ab.py`` (``tapclip_int8_mlp_variant``;
    none is B13 itself, the A/B's parent) on a CUDA tensor, the plain version
    on a CPU tensor.  The switches are stochastic-mode kernels:
    ``deterministic`` with one raises ValueError."""
    if deterministic and (erf3 or recipmul):
        raise ValueError("the erf3 / recipmul variants are stochastic-mode kernels")
    _build.refuse_graph("int8_mlp_variant", x, gamma, beta)
    if x.device.type == "cpu":
        return int8_mlp_plain(x, gamma, beta, q, eps=eps, seed=seed, deterministic=deterministic, erf3=erf3,
                              recipmul=recipmul)
    out = _launch(x, gamma, beta, q, eps, seed, deterministic, variant_code(erf3, recipmul))
    int8_mlp_block.variant_launches += 1
    return out


def variant_code(erf3: bool, recipmul: bool) -> int:
    """``tapclip_int8_mlp_variant``'s ``variant``: bit 0 erf3, bit 1 recipmul."""
    return int(erf3) | 2 * int(recipmul)


def _launch(x, gamma, beta, q, eps, seed, deterministic, variant):
    """B13's four launches (``variant`` None: ``tapclip_int8_mlp``; else S5's
    entry with that :func:`variant_code`): the weights laid out K-major, the
    scratch allocated."""
    R, W, H, f = _mlp_operands(x, gamma, beta, q)
    lib = _build.library()
    Wp, Hp = lib.tapclip_int8_gemm_kp(W), lib.tapclip_int8_gemm_kp(H)
    w_fc, w_proj = k_major(q["w_fc"], Wp), k_major(q["w_proj"], Hp)
    dev = x.device
    out = torch.empty_like(x)
    h = torch.empty((R, H), dtype=torch.float32, device=dev)  # the hidden rows, through L2
    yq = torch.empty((R, Wp), dtype=torch.int8, device=dev)
    hq = torch.empty((R, Hp), dtype=torch.int8, device=dev)
    scales = torch.empty((3, R), dtype=torch.float32, device=dev)  # t1, t2, max |h| of each row
    args = (x.data_ptr(), f["gamma"].data_ptr(), f["beta"].data_ptr(), w_fc.data_ptr(), f["s_fc"].data_ptr(),
            f["b_fc"].data_ptr(), w_proj.data_ptr(), f["s_proj"].data_ptr(), f["b_proj"].data_ptr(), out.data_ptr(),
            h.data_ptr(), yq.data_ptr(), hq.data_ptr(), scales.data_ptr(), R, W, H, float(eps),
            int(seed) & 0xFFFFFFFF, int(deterministic))
    tail = (_build.dtype_code(x.dtype), _build.stream_handle(dev))
    if variant is None:
        _build.check(lib.tapclip_int8_mlp(*args, *tail), "tapclip_int8_mlp")
    else:
        _build.check(lib.tapclip_int8_mlp_variant(*args, variant, *tail), "tapclip_int8_mlp_variant")
    return out
