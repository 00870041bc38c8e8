"""The MoE towers (``models/moe.py``) against the JAX package, on the CPU.

The same parameters (a JAX init, bridged with ``params_from_jax``) and the
same numpy inputs from a seed go through both packages, at ``TINY_TEST``
with ``moe_experts = 4`` (JAX's own ``tests/test_moe.py`` config) and at
small widths for the MLP alone.  JAX routes to XLA on the CPU; the port's
kernel wrappers run their plain versions.

* Routing: the expert, the queue position and the keep mask equal JAX's
  exactly (read off JAX's ``jax.nn.one_hot`` calls), on inputs whose
  smallest top-1/top-2 router-logit margin is asserted far above f32
  rounding, and where tokens overflow the capacity.
* ``moe_mlp_forward``: f32 at rtol 1e-5, atol 1e-6 (the summation order of
  the products); bf16 against JAX compiled with
  ``xla_allow_excess_precision`` off (XLA on the CPU drops the bf16
  roundings otherwise; its einsums on operands widened to f32, which XLA's
  CPU runtime needs) at rtol = atol = 1e-2, two bf16 steps: XLA rounds
  inside the bf16 erf where torch's GELU rounds once, and an f32 sum in
  another order may round h or the output the other way; the
  load-balance term at rtol 1e-6 (f32), 1e-3 (bf16).  Pad rows and dropped
  tokens output exactly 0; a zero router gives lb = 1 exactly; one expert
  is the dense MLP.  The index dispatch equals the one-hot einsums (JAX's
  form, written in torch) bit for bit.
* Blocks, towers, ``text_forward_embeds``, the gradients of InfoNCE + aux
  into every leaf, a pretraining step, a GradCache step from a bridged
  AdamW state, LoRA and the prompt-tuning pipeline: the tolerances of
  ``test_torch_model.py`` (rtol = atol = 1e-4) and
  ``test_torch_pretrain.py`` (gradients rtol 1e-4, atol 1e-5; trajectories
  ``TRAJ_TOL`` and ``_assert_tree``).
* ``pretrain_cli --moe-experts 2`` writes a CLIP tree that loads under the
  MoE config and is refused under the dense one; the refusals that remain.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tapclip_tpu import peft as jpeft
from tapclip_tpu import pretrain as jpre
from tapclip_tpu.config import PromptConfig as JPromptConfig
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models import layers as jlayers
from tapclip_tpu.models import model_wrapper as jmw
from tapclip_tpu.models import moe as jmoe

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import peft as tpeft
from tapclip_tpu_torch import pretrain as tpre
from tapclip_tpu_torch import pretrain_cli
from tapclip_tpu_torch.models import clip as tclip
from tapclip_tpu_torch.models import layers as tlayers
from tapclip_tpu_torch.models import model_wrapper as tmw
from tapclip_tpu_torch.models import moe as tmoe
from tapclip_tpu_torch.utils import checkpoint as ckpt_io
from tapclip_tpu_torch.utils import torch_convert
from tapclip_tpu_torch.utils.jax_bridge import (
    adamw_state_from_optax,
    lora_from_jax,
    params_from_jax,
    prompt_state_from_jax,
)

from test_torch_pretrain import LR, TRAJ_TOL, WD, _assert_tree, _np

torch.set_num_threads(1)

J_MOE = J_TINY.replace(moe_experts=4)
T_MOE = tcfg.TINY_TEST.replace(moe_experts=4)
TOL = dict(rtol=1e-4, atol=1e-4)
MLP_TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=1e-2, atol=1e-2)}
LB_TOL = {"float32": 1e-6, "bfloat16": 1e-3}
W, H, B, T, E = 16, 32, 2, 32, 4  # the MLP alone: C = expert_capacity(32, 4, 1.0) = 8, so tokens overflow


@pytest.fixture(scope="module")
def moe_tree():
    jp = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), J_MOE))
    return jp, params_from_jax(jp, T_MOE)


def _bank(seed=0, router_scale=1.0, n_experts=E):
    """A JAX MLP bank (NumPy leaves) and the port's, the router scaled so
    that routing margins are wide."""
    p = jax.tree.map(np.asarray, jmoe.init_moe_mlp(jax.random.PRNGKey(seed), W, H, n_experts))
    p["router"]["w"] = p["router"]["w"] * np.float32(router_scale)
    tp = {k: ({kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()} if isinstance(v, dict)
              else torch.from_numpy(np.array(v))) for k, v in p.items()}
    return p, tp


def _tokens(seed=0, valid=None):
    x = np.random.default_rng(seed).standard_normal((B, T, W)).astype(np.float32)
    if valid is not None:
        x[:, valid:] = 0.0  # the towers' zero pad rows
    return x


def _jax_mlp(x, p, dtype, **kw):
    """JAX's ``moe_mlp_forward`` in ``dtype``, compiled with
    ``xla_allow_excess_precision`` off so each bf16 rounding stays.  XLA's
    CPU runtime has no bf16 x bf16 -> f32 batched dot ("Unsupported element
    type for DotThunk"), so its einsums take the bf16 operands widened to
    f32: the same exact products, summed in f32."""
    real = jnp.einsum

    def einsum(spec, *ops, preferred_element_type=None, **k):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return real(spec, *ops, preferred_element_type=preferred_element_type, **k)

    fn = jax.jit(lambda xx, pp: jmoe.moe_mlp_forward(xx.astype(dtype), pp, "gelu", **kw))
    args = (jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    jnp.einsum = einsum
    try:
        y, lb = fn.lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)
    finally:
        jnp.einsum = real
    return np.asarray(y.astype(jnp.float32)), float(lb)


def _jax_routing(x, p, **kw):
    """JAX's routing, read off its two ``jax.nn.one_hot`` calls: (expert
    [B, T], position [B, T], keep [B, T])."""
    seen = []
    real = jax.nn.one_hot

    def spy(idx, n, **k):
        seen.append(np.asarray(idx))
        return real(idx, n, **k)

    jax.nn.one_hot = spy
    try:
        jmoe.moe_mlp_forward(jnp.asarray(x), jax.tree.map(jnp.asarray, p), "gelu", **kw)
    finally:
        jax.nn.one_hot = real
    expert, pos = seen
    C = jmoe.expert_capacity(kw.get("valid_len") or T, E, kw["capacity_factor"])
    valid = np.arange(T)[None, :] < (kw.get("valid_len") or T)
    pos_tok = pos.sum(-1)  # 0 off the chosen expert
    return expert, pos_tok, (pos_tok < C) & valid


# --- capacity and routing ------------------------------------------------------------


@pytest.mark.parametrize("case,want", [((32, 4, 1.0), 8), ((32, 4, 1.3), 16), ((8, 8, 1.0), 8), ((16, 1, 4.0), 16),
                                       ((12, 1, 4.0), 12), ((5, 4, 1.25), 5), ((197, 8, 1.25), 32),
                                       ((77, 8, 1.25), 16)])
def test_expert_capacity_matches_jax(case, want):
    """JAX's six cases (``tests/test_moe.py``), and ViT-B/16's vision and
    text groups at E 8."""
    assert tmoe.expert_capacity(*case) == jmoe.expert_capacity(*case) == want


@pytest.mark.parametrize("valid", [None, 28])
def test_route_equals_jax(valid):
    p, tp = _bank(router_scale=25.0)
    x = _tokens(valid=valid)
    logits = x.astype(np.float64) @ p["router"]["w"].astype(np.float64)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0])[:, :valid]
    assert margin.min() > 1e-3, margin.min()  # f32 rounds these logits at about 1e-6: no tie
    want = _jax_routing(x, p, capacity_factor=1.0, valid_len=valid)
    r = tmoe.route(torch.from_numpy(x), tp, 1.0, valid)
    np.testing.assert_array_equal(r.expert.numpy(), want[0])
    np.testing.assert_array_equal(r.pos.numpy(), want[1])
    np.testing.assert_array_equal(r.keep.numpy(), want[2])
    n_valid = valid or T
    assert not r.keep[:, :n_valid].all()  # tokens over capacity are in the inputs
    if valid is not None:  # pad rows: not kept, gate 0
        assert not r.keep[:, valid:].any() and float(r.gate[:, valid:].abs().max()) == 0.0
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    chosen = np.take_along_axis(probs, want[0][..., None], -1)[..., 0]
    np.testing.assert_allclose(r.gate.numpy()[:, :n_valid], chosen[:, :n_valid], rtol=1e-5)


# --- the MLP ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid", [None, 28])
def test_moe_mlp_forward_matches_jax(dtype, valid):
    p, tp = _bank(router_scale=25.0)
    x = _tokens(valid=valid)
    jy, jlb = _jax_mlp(x, p, getattr(jnp, dtype), capacity_factor=1.0, valid_len=valid)
    y, lb = tmoe.moe_mlp_forward(torch.from_numpy(x).to(getattr(torch, dtype)), tp, "gelu", capacity_factor=1.0,
                                 valid_len=valid)
    assert y.dtype == getattr(torch, dtype) and lb.dtype == torch.float32
    np.testing.assert_allclose(_np(y), jy, **MLP_TOL[dtype])
    np.testing.assert_allclose(float(lb), jlb, rtol=LB_TOL[dtype])
    r = tmoe.route(torch.from_numpy(x).to(getattr(torch, dtype)), tp, 1.0, valid)
    out = y.float().numpy()
    assert (out[~r.keep.numpy()] == 0.0).all()  # dropped and pad tokens: exactly 0, bias included
    assert (np.abs(out[r.keep.numpy()]).max(-1) > 0).all()


def test_zero_router_routes_all_to_the_first_expert_with_lb_one():
    p, tp = _bank()
    p["router"]["w"] = np.zeros_like(p["router"]["w"])
    tp["router"]["w"] = torch.zeros_like(tp["router"]["w"])
    x = _tokens()
    y, lb = tmoe.moe_mlp_forward(torch.from_numpy(x), tp, "gelu", capacity_factor=1.0)
    assert float(lb) == 1.0  # f = (1, 0, 0, 0), p_bar = 1/4: E * 1/4 exactly
    C = tmoe.expert_capacity(T, E, 1.0)
    assert C == 8 and float(y[:, C:].abs().max()) == 0.0 and float(y[:, :C].abs().max()) > 0
    jy, jlb = _jax_mlp(x, p, jnp.float32, capacity_factor=1.0)
    np.testing.assert_allclose(_np(y), jy, **MLP_TOL["float32"])
    assert jlb == 1.0


def test_single_expert_equals_the_dense_mlp():
    p, tp = _bank(n_experts=1)
    x = _tokens()
    y, lb = tmoe.moe_mlp_forward(torch.from_numpy(x), tp, "gelu", capacity_factor=2.0)
    dense = {k: tp[k][0] for k in ("w_fc", "b_fc", "w_proj", "b_proj")}
    np.testing.assert_allclose(_np(y), _np(tlayers.mlp_forward(torch.from_numpy(x), dense, "gelu")),
                               rtol=2e-5, atol=1e-5)
    jdense = {k: jnp.asarray(p[k][0]) for k in ("w_fc", "b_fc", "w_proj", "b_proj")}
    np.testing.assert_allclose(_np(y), np.asarray(jlayers.mlp_forward(jnp.asarray(x), jdense, "gelu")),
                               rtol=2e-5, atol=1e-5)
    assert abs(float(lb) - 1.0) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_index_dispatch_equals_the_one_hot_einsums(dtype):
    """The port's dispatch and combine by index against JAX's dense one-hot
    form (``dispatch [B, T, E, C]``, ``combine = gate * dispatch``, f32
    einsums) written in torch on the port's routing: the same values, bit
    for bit, pad and dropped tokens included."""
    _, tp = _bank(router_scale=25.0)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_tokens(valid=28)).to(dt)
    r = tmoe.route(x, tp, 1.0, 28)
    C = tmoe.expert_capacity(28, E, 1.0)
    slot = tmoe.slots(r, C, E)
    onehot = torch.zeros(B, T, E, C)
    b, t = torch.nonzero(r.keep, as_tuple=True)
    onehot[b, t, r.expert[b, t], r.pos[b, t]] = 1.0
    xin = torch.einsum("btec,btw->becw", onehot.to(dt).float(), x.float()).to(dt)  # [B, E, C, W]
    assert torch.equal(tmoe.dispatch(x, slot, E, C), xin.transpose(0, 1).reshape(E, B * C, W))
    out = torch.randn(E, B * C, W, generator=torch.Generator().manual_seed(1))
    want = torch.einsum("btec,becw->btw", onehot * r.gate[..., None, None],
                        out.view(E, B, C, W).transpose(0, 1))
    got = tmoe.combine(out, slot, r.gate)
    assert torch.equal(got, want) and float(got[~r.keep].abs().max()) == 0.0


def test_products_stay_ieee_f32_whatever_the_tf32_setting(monkeypatch):
    """Every MoE product runs with TF32 off, forward and backward, and the
    caller's setting comes back."""
    _, tp = _bank()
    tp = {k: ({kk: vv.requires_grad_() for kk, vv in v.items()} if isinstance(v, dict) else v.requires_grad_())
          for k, v in tp.items()}
    seen = []
    real = torch.bmm

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)

    prev = torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(torch, "bmm", spy)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y, lb = tmoe.moe_mlp_forward(torch.from_numpy(_tokens()), tp, "gelu")
        (y.square().sum() + lb).backward()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    # forward: router, fc, proj; backward: the router's and fc's weights (x
    # needs no gradient), proj's two operands
    assert len(seen) == 3 + 4 and not any(seen)
    assert float(tp["router"]["w"].grad.abs().max()) > 0


# --- blocks and towers -------------------------------------------------------------------


def _block_inputs(jp, tp, tower="visual", seed=1):
    jblk = jax.tree.map(lambda a: a[0], jp[tower]["blocks"])
    tblk = tp[tower]["blocks"][0]
    x = (np.random.default_rng(seed).standard_normal((3, 16, 64)) * 0.5).astype(np.float32)
    return jblk, tblk, x


@pytest.mark.parametrize("kv", ["none", "int", "per_row"])
def test_moe_block_forward_matches_jax(moe_tree, kv):
    """``kv_valid_len`` None, an int (pad rows stay out of routing) and a
    per-row tensor (every row routes and takes capacity, as in JAX)."""
    jp, tp = moe_tree
    jblk, tblk, x = _block_inputs(jp, tp)
    jkv, tkv = {"none": (None, None), "int": (13, 13),
                "per_row": (jnp.asarray([16, 13, 9]), torch.tensor([16, 13, 9]))}[kv]
    jy, jlb = jmoe.moe_block_forward(jnp.asarray(x), jblk, 4, act="gelu", kv_valid_len=jkv)
    ty, tlb, aux = tmoe.moe_block_forward(torch.from_numpy(x), tblk, 4, act="gelu", kv_valid_len=tkv)
    assert aux is None
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(tlb), float(jlb), rtol=1e-5)


@pytest.mark.parametrize("attr", [False, True])
def test_moe_transformer_forward_matches_jax(moe_tree, attr):
    """Without ``attn_to_idx``: the summed load-balance term; with it: the
    last block's attention aux (K3's plain version), the term dropped."""
    jp, tp = moe_tree
    x = (np.random.default_rng(2).standard_normal((3, 24, 64)) * 0.5).astype(np.float32)
    to_idx = 20 if attr else None
    jy, jsecond = jmoe.moe_transformer_forward(jnp.asarray(x), jp["text"]["blocks"], 4, act="gelu",
                                                kv_valid_len=21, attn_to_idx=to_idx)
    ty, tsecond = tmoe.moe_transformer_forward(torch.from_numpy(x), tp["text"]["blocks"], 4, act="gelu",
                                               kv_valid_len=21, attn_to_idx=to_idx)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    if attr:
        assert tsecond.shape == (3, 24)
        np.testing.assert_allclose(_np(tsecond), np.asarray(jsecond), **TOL)
    else:
        assert tsecond.shape == () and 1.0 < float(tsecond) < 4.0 * len(tp["text"]["blocks"])
        np.testing.assert_allclose(float(tsecond), float(jsecond), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="int8 quantization of MoE towers"):
        tmoe.moe_transformer_forward(torch.from_numpy(x), tp["text"]["blocks"], 4, act="gelu", quantize=True)


def test_towers_and_moe_loss_out_match_jax(moe_tree):
    jp, tp = moe_tree
    assert tp["visual"]["blocks"][0]["moe"]["w_fc"].shape == (4, 64, 256)
    assert tp["text"]["blocks"][1]["moe"]["router"]["w"].shape == (64, 4)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, J_MOE.vocab_size - 2, (4, J_MOE.context_length)).astype(np.int32)
    jaux, taux = [], []
    np.testing.assert_allclose(_np(tclip.encode_image(tp, T_MOE, torch.from_numpy(x), moe_loss_out=taux)),
                               np.asarray(jclip.encode_image(jp, J_MOE, jnp.asarray(x), moe_loss_out=jaux)), **TOL)
    np.testing.assert_allclose(_np(tclip.encode_text(tp, T_MOE, ids, moe_loss_out=taux)),
                               np.asarray(jclip.encode_text(jp, J_MOE, jnp.asarray(ids), moe_loss_out=jaux)), **TOL)
    assert len(taux) == 2
    np.testing.assert_allclose([float(a) for a in taux], [float(a) for a in jaux], rtol=1e-5)
    assert 0.5 * J_MOE.vision_layers < float(taux[0]) < 4.0 * J_MOE.vision_layers
    fresh = tclip.init_clip_params(torch.Generator().manual_seed(0), T_MOE)
    assert [(p, tuple(t.shape)) for p, t in tpre.named_leaves(fresh)] == [
        (p, tuple(t.shape)) for p, t in tpre.named_leaves(tp)]


@pytest.mark.parametrize("mode", ["ref_compat", "idiomatic"])
def test_text_forward_embeds_matches_jax(moe_tree, mode):
    jp, tp = moe_tree
    Tq = 5 + J_MOE.context_length if mode == "ref_compat" else J_MOE.context_length
    emb = (np.random.default_rng(4).standard_normal((3, Tq, 64)) * 0.1).astype(np.float32)
    to_idx = Tq - 1 if mode == "ref_compat" else jnp.asarray([5, 9, 15])
    jf, jaux = jclip.text_forward_embeds(jp, J_MOE, jnp.asarray(emb), mode=mode, attn_to_idx=to_idx)
    tf, taux = tclip.text_forward_embeds(tp, T_MOE, torch.from_numpy(emb), mode=mode,
                                         attn_to_idx=to_idx if mode == "ref_compat" else torch.tensor([5, 9, 15]))
    np.testing.assert_allclose(_np(tf), np.asarray(jf), **TOL)
    np.testing.assert_allclose(_np(taux), np.asarray(jaux), **TOL)
    jf2, jaux2 = jclip.text_forward_embeds(jp, J_MOE, jnp.asarray(emb), mode=mode, pool_idx=4)
    tf2, taux2 = tclip.text_forward_embeds(tp, T_MOE, torch.from_numpy(emb), mode=mode, pool_idx=4)
    assert taux2 is None and jaux2 is None  # the load-balance term is not an aux
    np.testing.assert_allclose(_np(tf2), np.asarray(jf2), **TOL)


# --- training --------------------------------------------------------------------------


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, J_MOE.vocab_size - 2, (n, J_MOE.context_length)).astype(np.int32)
    ids[:, 0] = J_MOE.vocab_size - 2
    ids[np.arange(n), rng.integers(3, J_MOE.context_length, n)] = J_MOE.vocab_size - 1
    return images, ids


def _objective_jax(p, x, ids):
    aux = []
    img = jclip.encode_image(p, J_MOE, jnp.asarray(x), moe_loss_out=aux)
    txt = jclip.encode_text(p, J_MOE, jnp.asarray(ids), moe_loss_out=aux)
    return jpre.contrastive_loss_local(img, txt, p["logit_scale"]) + J_MOE.moe_aux_weight * sum(aux)


def test_gradients_of_infonce_and_aux_match_jax(moe_tree):
    """Every leaf's gradient, the routers' included, rtol 1e-4, atol 1e-5."""
    jp, _ = moe_tree
    x, ids = _batch()
    jl, jg = jax.jit(jax.value_and_grad(lambda p: _objective_jax(p, x, ids)))(jax.tree.map(jnp.asarray, jp))
    tp = params_from_jax(jp, T_MOE)
    leaves = tpre.set_trainable(tp)
    aux = []
    tl = tpre.contrastive_loss_local(tclip.encode_image(tp, T_MOE, torch.from_numpy(x), moe_loss_out=aux),
                                     tclip.encode_text(tp, T_MOE, ids, moe_loss_out=aux), tp["logit_scale"])
    tl = tl + T_MOE.moe_aux_weight * sum(aux)
    tg = torch.autograd.grad(tl, [t for _, t in leaves])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    want = dict(tpre.named_leaves(params_from_jax(jax.tree.map(np.asarray, jg), T_MOE)))
    for (path, _), g in zip(leaves, tg):
        np.testing.assert_allclose(_np(g), _np(want[path]), rtol=1e-4, atol=1e-5, err_msg=path)
    routers = [g for (path, _), g in zip(leaves, tg) if path.endswith("router/w")]
    assert len(routers) == 4 and all(float(g.abs().max()) > 0 for g in routers)


def test_remat_gradients_equal_no_remat(moe_tree):
    _, tp0 = moe_tree
    x, ids = _batch()
    grads = []
    for cfg in (T_MOE, T_MOE.replace(remat="full")):
        tp = tpre.detached_copy(tp0)
        leaves = tpre.set_trainable(tp)
        aux = []
        loss = tpre.contrastive_loss_local(tclip.encode_image(tp, cfg, torch.from_numpy(x), moe_loss_out=aux),
                                           tclip.encode_text(tp, cfg, ids, moe_loss_out=aux), tp["logit_scale"])
        grads.append(torch.autograd.grad(loss + sum(aux), [t for _, t in leaves]))
    for a, b in zip(*grads):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-5, atol=1e-6)


def _jax_steps(step, opt, params, batches, state=None):
    params = jax.tree.map(jnp.asarray, params)
    state = opt.init(params) if state is None else state
    losses = []
    for x, ids in batches:
        params, state, m = step(params, state, jnp.asarray(x), jnp.asarray(ids))
        losses.append(float(m["loss"]))
    return losses, params, state


def test_pretrain_step_then_gradcache_from_a_bridged_state_match_jax(moe_tree):
    """One plain step (InfoNCE + aux) from the init in both packages; then
    one GradCache step (K = 2) from JAX's AdamW state bridged into the port.
    The port reports the objective whose gradient both take,
    ``contrastive + w / k * sum(lb_i)``; JAX reports ``contrastive + w / k^2
    * sum(lb_i)``: the difference is pinned."""
    jp, _ = moe_tree
    b0, b1 = _batch(8, seed=5), _batch(8, seed=6)
    opt = optax.adamw(LR, weight_decay=WD)
    jl, jmid, jstate = _jax_steps(jpre.make_pretrain_step(J_MOE, opt), opt, jp, [b0])
    tp = params_from_jax(jp, T_MOE)
    topt = tpre.PretrainOptimizer(tpre.set_trainable(tp), lr=LR, weight_decay=WD)
    tl = float(tpre.make_pretrain_step(T_MOE, topt)(tp, *b0)["loss"])
    np.testing.assert_allclose(tl, jl[0], **TRAJ_TOL)
    _assert_tree(tp, dict(tpre.named_leaves(params_from_jax(jax.tree.map(np.asarray, jmid), T_MOE))), TRAJ_TOL,
                 steps=1)

    k = 2
    mid, mid_state = jax.tree.map(np.asarray, jmid), jax.tree.map(np.asarray, jstate)  # before JAX donates them
    jl2, jout, _ = _jax_steps(jpre.make_accum_pretrain_step(J_MOE, opt, k), opt, mid, [b1],
                              state=jax.tree.map(jnp.asarray, mid_state))
    tp = params_from_jax(mid, T_MOE)
    lbs = []
    with torch.no_grad():
        for i in range(k):
            rows = slice(i * 4, (i + 1) * 4)
            aux = []
            tclip.encode_image(tp, T_MOE, torch.from_numpy(b1[0][rows]), moe_loss_out=aux)
            tclip.encode_text(tp, T_MOE, b1[1][rows], moe_loss_out=aux)
            lbs.append(float(sum(aux)))
    topt = tpre.PretrainOptimizer(tpre.set_trainable(tp), lr=LR, weight_decay=WD)
    topt.load_state_dict(adamw_state_from_optax(mid_state, T_MOE))
    assert topt.count == 1
    tl2 = float(tpre.make_accum_pretrain_step(T_MOE, topt, k)(tp, *b1)["loss"])
    w = T_MOE.moe_aux_weight
    assert abs(w / k * (1 - 1 / k) * sum(lbs)) > 1e-3 * abs(tl2)  # the two reports differ well past the tolerance
    np.testing.assert_allclose(tl2, jl2[0] + w / k * (1 - 1 / k) * sum(lbs), rtol=1e-5)
    _assert_tree(tp, dict(tpre.named_leaves(params_from_jax(jax.tree.map(np.asarray, jout), T_MOE))), TRAJ_TOL,
                 steps=2)


def test_lora_on_moe_towers_matches_jax(moe_tree):
    """Adapters on every expert bank (``[E, In, r]`` / ``[E, r, Out]``), none
    on the routers; 2 steps of InfoNCE + aux against JAX's."""
    jp, _ = moe_tree
    jl_tree = jax.tree.map(np.asarray, jpeft.init_lora_params(jax.random.PRNGKey(1), jp, rank=4))
    tl = lora_from_jax(jl_tree)
    blk = tl["visual"]["blocks"][0]
    assert sorted(blk) == ["attn", "moe"] and sorted(blk["moe"]) == ["w_fc", "w_proj"]
    assert blk["moe"]["w_fc"]["a"].shape == (4, 64, 4) and blk["moe"]["w_fc"]["b"].shape == (4, 4, 256)
    fresh = tpeft.init_lora_params(torch.Generator().manual_seed(0), params_from_jax(jp, T_MOE), rank=4)
    assert [(p, tuple(t.shape)) for p, t in tpre.named_leaves(fresh)] == [
        (p, tuple(t.shape)) for p, t in tpre.named_leaves(tl)]
    batches = [_batch(4, seed=s) for s in (7, 8)]
    opt = optax.adamw(LR, weight_decay=WD)
    jstep = jpeft.make_lora_pretrain_step(J_MOE, opt, alpha=8.0)
    jparams, jlora = jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, jl_tree)
    state = opt.init(jlora)
    jl = []
    for x, ids in batches:
        jlora, state, m = jstep(jparams, jlora, state, jnp.asarray(x), jnp.asarray(ids))
        jl.append(float(m["loss"]))
    tp = params_from_jax(jp, T_MOE)
    tpre.set_trainable(tp, {p: False for p, _ in tpre.named_leaves(tp)})
    step = tpeft.make_lora_pretrain_step(T_MOE, tpre.PretrainOptimizer(tpre.set_trainable(tl), lr=LR,
                                                                        weight_decay=WD), alpha=8.0)
    got = [float(step(tp, tl, x, ids)["loss"]) for x, ids in batches]
    np.testing.assert_allclose(got, jl, **TRAJ_TOL)
    _assert_tree(tl, dict(tpre.named_leaves(lora_from_jax(jax.tree.map(np.asarray, jlora)))), TRAJ_TOL, steps=2)


def test_prompt_tuning_on_moe_towers_matches_jax(moe_tree):
    """JAX's ``test_moe_prompt_tuning_full_pipeline``: the attribution pass,
    the class-batched encode and the CE loss on MoE towers; the loss, the
    logits and the ctx gradient against JAX's."""
    jp, tp = moe_tree
    classes = ["A", "B", "C"]
    jpc = JPromptConfig(max_classes=8)
    jm = jmw.FullModel(classes, jp, J_MOE, prompt_cfg=jpc, rng=jax.random.PRNGKey(1))

    trainable, bank = prompt_state_from_jax(jax.tree.map(np.asarray, jm.trainable),
                                            jax.tree.map(np.asarray, jm.prompt_learner.bank))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 4).astype(np.int32)

    def jloss(ctx):
        out = jmw.full_model_forward(jp, {**jm.trainable, "ctx": ctx}, jm.prompt_learner.bank, jnp.asarray(x),
                                     jnp.asarray(labels), clip_cfg=J_MOE, prompt_cfg=jpc, with_loss=True)
        return out["loss"], out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jm.trainable["ctx"])
    ctx = trainable["ctx"].clone().requires_grad_()
    out = tmw.full_model_forward(tp, {**trainable, "ctx": ctx}, bank, torch.from_numpy(x), torch.from_numpy(labels),
                                 clip_cfg=T_MOE, prompt_cfg=tcfg.PromptConfig(max_classes=8), with_loss=True)
    (g,) = torch.autograd.grad(out["loss"], [ctx])
    np.testing.assert_allclose(float(out["loss"]), float(jl), **TOL)
    live = np.asarray(jm.prompt_learner.bank.class_mask)
    np.testing.assert_allclose(_np(out["logits"])[:, live], np.asarray(jout["logits"])[:, live], **TOL)
    np.testing.assert_allclose(_np(out["attribution"]), np.asarray(jout["attribution"]), **TOL)
    np.testing.assert_allclose(_np(g), np.asarray(jg), rtol=1e-4, atol=1e-5)
    assert float(g.abs().max()) > 0
    model = tmw.FullModel(classes, tp, T_MOE, prompt_cfg=tcfg.PromptConfig(max_classes=8))
    assert model(torch.from_numpy(x), torch.from_numpy(labels))["logits"].shape == (4, 3)


# --- files, the CLI and the refusals -------------------------------------------------------


def test_clip_tree_round_trip_and_refusals(moe_tree, tmp_path):
    _, tp = moe_tree
    path = ckpt_io.save_clip_tree(str(tmp_path / "moe.pt"), tp, T_MOE)
    back = ckpt_io.load_clip_tree(path, T_MOE)
    for (pa, a), (pb, b) in zip(tpre.named_leaves(back), tpre.named_leaves(tp)):
        assert pa == pb and torch.equal(a, b), pa
    with pytest.raises(ValueError, match="an MoE tree .4 experts a block. does not fit"):
        ckpt_io.load_clip_tree(path, tcfg.TINY_TEST)
    dense = ckpt_io.save_clip_tree(str(tmp_path / "dense.pt"),
                                   tclip.init_clip_params(torch.Generator().manual_seed(0), tcfg.TINY_TEST),
                                   tcfg.TINY_TEST)
    with pytest.raises(ValueError, match="a dense tree .one MLP a block. does not fit"):
        ckpt_io.load_clip_tree(dense, T_MOE)
    with pytest.raises(ValueError, match="moe_experts"):
        ckpt_io.load_clip_tree(path, T_MOE.replace(moe_experts=2))
    with pytest.raises(ValueError, match="open_clip has no expert bank"):
        torch_convert.export_openclip_state_dict(tp, T_MOE)
    sd = torch_convert.export_openclip_state_dict(ckpt_io.load_clip_tree(dense, tcfg.TINY_TEST), tcfg.TINY_TEST)
    with pytest.raises(ValueError, match="no expert bank"):
        torch_convert.convert_openclip_state_dict(sd, T_MOE)


def test_pretrain_cli_moe_experts_writes_a_loadable_tree(tmp_path):
    out = pretrain_cli.main(["--preset", "tiny", "--synthetic-data", "--moe-experts", "2", "--epochs", "1",
                             "--batch-size", "8", "--device", "cpu", "--save-every", "1",
                             "--output-root", str(tmp_path / "run")])
    assert len(out["loss_history"]) == 1 and np.isfinite(out["loss_history"][0])
    cfg = tcfg.TINY_TEST.replace(moe_experts=2)
    tree = ckpt_io.load_clip_tree(out["ckpt"], cfg)
    assert tree["visual"]["blocks"][0]["moe"]["w_fc"].shape == (2, 64, 256)
    for (pa, a), (_, b) in zip(tpre.named_leaves(tree), tpre.named_leaves(out["params"])):
        assert torch.equal(a, b.detach()), pa
    with pytest.raises(ValueError, match="does not fit"):
        ckpt_io.load_clip_tree(out["ckpt"], tcfg.TINY_TEST)
    snap = ckpt_io.restore_pretrain_snapshot(f"{out['paths']['model_dir']}/pretrain_snapshot_e000001.pt")
    assert "moe" in snap["params"]["text"]["blocks"][1] and snap["opt_state"]["count"] > 0
    args = pretrain_cli.build_parser().parse_args(["--preset", "tiny", "--device", "cpu", "--moe-experts", "2",
                                                   "--tp", "2"])
    assert (args.moe_experts, args.tp) == (2, 2)  # expert parallelism: test_torch_expert_parallel.py


@pytest.mark.parametrize("what", ["maple", "vpt_deep", "pruning", "int8", "deep_text", "resnet", "saliency"])
def test_moe_refusals(moe_tree, what):
    """The JAX package's refusals for MoE towers, word for word where its
    messages are matched, and saliency's (its forward is the dense one)."""
    _, tp = moe_tree
    x = torch.zeros(1, 32, 32, 3)
    if what == "maple":
        with pytest.raises(NotImplementedError, match="maple prompts require the sequential block scan"):
            tclip.encode_image(tp, T_MOE, x, maple_prompts=(torch.zeros(2, 64), None, None))
    elif what == "vpt_deep":
        cfg = T_MOE.replace(vpt_tokens=2, vpt_deep=True)
        tree = dict(tp, visual=dict(tp["visual"], vpt=torch.zeros(tclip.vpt_shape(cfg))))
        with pytest.raises(NotImplementedError, match="vpt_deep requires the sequential block scan"):
            tclip.encode_image(tree, cfg, x)
    elif what == "pruning":
        with pytest.raises(NotImplementedError, match="token pruning is not supported"):
            tclip.encode_image(tp, T_MOE.replace(token_keep_ratio=0.5, token_prune_layer=1), x)
    elif what == "int8":
        with pytest.raises(NotImplementedError, match="int8 quantization of MoE towers"):
            tclip.encode_image(tp, T_MOE.replace(quantize_tower=True), x)
    elif what == "deep_text":
        with pytest.raises(NotImplementedError, match="deep text prompts .MaPLe. require the dense block scan"):
            tclip.text_forward_embeds(tp, T_MOE, torch.zeros(1, 8, 64), deep_prompts=torch.zeros(1, 2, 64))
    elif what == "resnet":
        with pytest.raises(NotImplementedError) as want:
            jclip.init_clip_params(jax.random.PRNGKey(0), J_MOE.replace(vision_tower="resnet",
                                                                        resnet_layers=(1, 1, 1, 1)))
        with pytest.raises(NotImplementedError) as got:
            tclip.init_clip_params(torch.Generator().manual_seed(0),
                                   dataclasses.replace(T_MOE, vision_tower="resnet", resnet_layers=(1, 1, 1, 1)))
        assert str(got.value) == str(want.value)
    else:
        from tapclip_tpu_torch.utils.saliency import vision_attention_forward

        with pytest.raises(NotImplementedError, match="MoE towers are not supported"):
            vision_attention_forward(tp, T_MOE, x)

