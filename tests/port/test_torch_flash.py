"""The port's flash attention backward against the JAX package, on the CPU.

* The single-block backward: :func:`attention_bwd_reference` against the JAX
  package's ``_pallas_attention_bwd`` (``_attn_bwd_kernel``) run in interpret
  mode, 2 x 2 heads of 64, T 77, 88 and 130 with per-row valid lengths,
  causal and not.
* The blockwise backward: :func:`attention_bwd_blocked_reference` and its
  pieces (the LSE, dK/dV and dQ plain versions) against
  ``_pallas_attention_bwd_blocked`` (``_blocked_lse_kernel``,
  ``_blocked_bwd_dkv_kernel``, ``_blocked_bwd_dq_kernel``) in interpret
  mode at T 600 (two 512-row blocks each way), 2 x 2 heads of 16.
* :func:`attention_lse_reference` against a numpy log2-sum-exp.
* The autograd Function: gradients through :func:`fused_attention` equal
  the single-block formula, and past the single-block cap (T 2100) the
  blockwise one; the aux column carries none.
* The split composition B4's Function differentiates past its tile: the
  half-block and B4's plain backward, through autograd.
* The kernels' split-operand products (``csrc/flash_mma.cuh``), emulated in
  torch (``tapclip_tpu_torch/scripts/split_error.py``: each f32 operand
  split into three bf16 terms, p and ds beside bf16 operands into two, the
  partial products summed in f32) at the card tests' flash shapes, against
  the plain f32 versions: the LSE within 1e-5 absolute and the gradients
  within 1e-5 norm-relative (the card's limits), the output within 1e-5 and
  the aux column within 1e-6 (K3 at T 4096's); in bf16 the card's bf16
  limits (gradients 5e-3, output 1e-2).  At T 1, dq and dk are 0 up to
  rounding and held at 1e-5 absolute, as on the card.
* The slice: a 3-step ``make_train_step`` trajectory with
  ``attn_impl="pallas"`` (cached features) in both text modes against JAX's,
  where JAX runs ``_attn_kernel`` and ``_attn_bwd_kernel`` in interpret mode.

f32 tolerances: the kernels' gradients at rtol = atol = 1e-5 (the same math
in another summation order); the trajectory at rtol 1e-4, atol 5e-6, as
``tests/port/test_torch_train.py``.  Batch 4 and capacity 8 throughout:
``tests/test_scale.py`` counts JAX compiles of a batch-2 forward at
capacity 16 in the same worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.config import PromptConfig as JPromptConfig
from tapclip_tpu.config import TrainConfig as JTrainConfig
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models import model_wrapper as jmw
from tapclip_tpu.ops import flash_attention as jfa
from tapclip_tpu.ops.flash_attention import _pallas_attention_bwd, _pallas_attention_bwd_blocked
from tapclip_tpu.parallel import train_step as jts

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch.ops import flash_attention as tfa
from tapclip_tpu_torch.ops.attention import attention_reference
from tapclip_tpu_torch.ops.flash_attention import (
    attention_bwd_blocked_reference,
    attention_bwd_dkv_reference,
    attention_bwd_dq_reference,
    attention_bwd_reference,
    attention_delta,
    attention_lse_reference,
    fused_attention,
)
from tapclip_tpu_torch.ops.fused_mha import _split_block, attn_block_bwd_reference, attn_block_reference
from tapclip_tpu_torch.parallel import train_step as tts
from tapclip_tpu_torch.scripts.split_error import FLASH_SHAPES, emulated_errors
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax, prompt_state_from_jax

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=5e-6)
CLASSES = ["Backpack", "Pen", "Mug"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _case(B, H, T, Dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, Dh)).astype(np.float32) for _ in range(4)]


# --- the single-block backward (B8) ---------------------------------------------------

SINGLE = [(77, [77, 60]), (88, [82, 82]), (88, [88, 71]), (130, [130, 113])]
SINGLE_IDS = ["T77-per-row", "T88-valid82", "T88-per-row", "T130-per-row"]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("T,valid", SINGLE, ids=SINGLE_IDS)
def test_attention_bwd_reference_matches_pallas_interpret(T, valid, causal):
    q, k, v, g = _case(2, 2, T, 64, T + causal)
    want = _pallas_attention_bwd(*(jnp.asarray(a) for a in (q, k, v, g)), jnp.asarray(valid, jnp.int32),
                                 causal=causal, interpret=True)
    got = attention_bwd_reference(*(torch.from_numpy(a) for a in (q, k, v, g)), torch.tensor(valid), causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == (2, 2, T, 64)
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **TOL)


# --- the blockwise backward (B10-B12) ---------------------------------------------------


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_attention_bwd_blocked_reference_matches_pallas_interpret(causal):
    """T 600 runs two 512-row query blocks and two 512-key blocks in JAX."""
    q, k, v, g = (torch.from_numpy(a) for a in _case(2, 2, 600, 16, 5 + causal))
    valid = torch.tensor([600, 583])
    out, _ = attention_reference(q, k, v, causal=causal, kv_valid_len=valid)
    want = _pallas_attention_bwd_blocked(*(jnp.asarray(_np(a)) for a in (q, k, v, g, out)),
                                         jnp.asarray(valid.numpy(), jnp.int32), causal=causal, interpret=True)
    got = attention_bwd_blocked_reference(q, k, v, g, out, valid, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **TOL)
    # the pieces each kernel's plain version computes compose to the same
    lse = attention_lse_reference(q, k, valid, causal)
    delta = attention_delta(out, g)
    dk, dv = attention_bwd_dkv_reference(q, k, v, g, lse, delta, valid, causal)
    dq = attention_bwd_dq_reference(q, k, v, g, lse, delta, valid, causal)
    for a, b in zip((dq, dk, dv), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # and the single-block formula agrees with the blockwise one
    for name, a, b in zip(("dq", "dk", "dv"), attention_bwd_reference(q, k, v, g, valid, causal), got):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_attention_lse_reference_matches_numpy(causal):
    q, k, _, _ = _case(3, 2, 70, 32, 11)
    valid = np.array([70, 41, 1])
    s2 = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) * (32 ** -0.5 * np.log2(np.e))
    keys = np.arange(70)
    mask = keys[None, None, None, :] < valid[:, None, None, None]
    if causal:
        mask = mask & (keys[None, :] <= keys[:, None])
    s2 = np.where(mask, s2, -1e30)
    m = s2.max(-1, keepdims=True)
    want = (m + np.log2(np.exp2(s2 - m).sum(-1, keepdims=True)))[..., 0]
    got = attention_lse_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(valid), causal)
    assert got.dtype == torch.float32 and got.shape == (3, 2, 70)
    np.testing.assert_allclose(_np(got), want, **TOL)


# --- the autograd Function -----------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fused_attention_grads_equal_single_block_reference_and_aux_carries_none(causal):
    q, k, v, g = (torch.from_numpy(a) for a in _case(2, 2, 88, 64, 13 + causal))
    valid = torch.tensor([82, 88])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, aux = fused_attention(*leaves, causal=causal, kv_valid_len=valid, attn_to_idx=81)
    assert not aux.requires_grad and aux.grad_fn is None
    got = torch.autograd.grad((out * g).sum() + aux.sum(), leaves)
    for name, a, b in zip(("dq", "dk", "dv"), got, attention_bwd_reference(q, k, v, g, valid, causal)):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **TOL)


def test_fused_attention_backward_past_the_single_block_cap():
    """Padded T over 2048, where JAX's ``_core_bwd`` turns blockwise: the
    gradients equal the blockwise plain version's."""
    q, k, v, g = (torch.from_numpy(a) for a in _case(1, 1, 2100, 16, 17))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, aux = fused_attention(*leaves, kv_valid_len=2000)
    assert aux is None
    got = torch.autograd.grad(out, leaves, g)
    want = attention_bwd_blocked_reference(q, k, v, g, out.detach(), 2000)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **TOL)


# --- B4 past its tile: the split composition ---------------------------------------------


# The card's limits the emulated split must meet: f32 (LSE absolute; the
# gradients' and K3's output norm-relative; the aux column absolute) and bf16.
SPLIT_LIMITS = {torch.float32: {"lse_abs": 1e-5, "grad_rel": 1e-5, "out_rel": 1e-5, "aux_abs": 1e-6},
                torch.bfloat16: {"lse_abs": 1e-5, "grad_rel": 5e-3, "out_rel": 1e-2, "aux_abs": 1e-6}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("B,H,T,Dh,valid", FLASH_SHAPES, ids=[f"T{s[2]}" for s in FLASH_SHAPES])
def test_split_operand_products_meet_the_card_limits(B, H, T, Dh, valid, causal, dtype):
    errs = emulated_errors(B, H, T, Dh, valid, causal, dtype)
    lim = SPLIT_LIMITS[dtype]
    assert errs["lse_abs"] <= lim["lse_abs"], errs
    assert errs["out_rel"] <= lim["out_rel"] and errs["aux_abs"] <= lim["aux_abs"], errs
    for name in ("dq", "dk", "dv"):
        if T == 1 and name != "dv":
            assert errs[f"{name}_abs"] <= 1e-5, (name, errs)
        else:
            assert errs[f"{name}_rel"] <= lim["grad_rel"], (name, errs)


@pytest.mark.parametrize("valid", [21, 24], ids=["valid<T", "valid=T"])
def test_split_block_equals_the_half_block_and_its_plain_backward(valid):
    """The composition B4's Function differentiates past its ``[T, T]`` tile
    (LayerNorm and projections around ``fused_mha``, as ``_attn_block_bwd``'s
    fallback) computes the half-block and, through autograd, B4's gradients."""
    rng = np.random.default_rng(23 + valid)
    B, T, W, heads = 2, 24, 64, 4
    arrays = [rng.standard_normal((B, T, W)), 1 + 0.1 * rng.standard_normal(W), 0.1 * rng.standard_normal(W),
              rng.standard_normal((W, 3 * W)) * W ** -0.5, 0.1 * rng.standard_normal(3 * W),
              rng.standard_normal((W, W)) * W ** -0.5, 0.1 * rng.standard_normal(W)]
    leaves = [torch.from_numpy(a.astype(np.float32)).requires_grad_() for a in arrays]
    g = torch.from_numpy(rng.standard_normal((B, T, W)).astype(np.float32))
    out = _split_block(*leaves, heads, valid, 1e-5)
    np.testing.assert_allclose(_np(out), _np(attn_block_reference(*leaves, heads, valid, 1e-5)), **TOL)
    got = torch.autograd.grad(out, leaves, g)
    x, *p = (t.detach() for t in leaves)
    want = attn_block_bwd_reference(x, g, *p[:5], heads, valid, 1e-5)
    for name, a, b in zip(("dx", "dgamma", "dbeta", "dw_qkv", "db_qkv", "dw_out", "db_out"), got, want):
        np.testing.assert_allclose(_np(a), _np(b).reshape(a.shape), err_msg=name, **TOL)


# --- the slice: prompt tuning with attn_impl="pallas" -------------------------------------


@pytest.fixture(scope="module")
def tiny_pallas():
    jc = J_TINY.replace(attn_impl="pallas")
    jp = jclip.init_clip_params(jax.random.PRNGKey(0), jc)
    tc = tcfg.CLIPConfig(**{f: getattr(jc, f) for f in jc.__dataclass_fields__})
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return jc, jp, tc, tp


@pytest.mark.parametrize("mode", ["ref_compat", "idiomatic"])
def test_pallas_train_step_trajectory_matches_jax(tiny_pallas, mode, monkeypatch):
    jc, jp, tc, tp = tiny_pallas
    assert tc.attn_impl == "pallas"
    # Both packages differentiate attention through the single-block backward.
    jax_bwd = _spy(monkeypatch, jfa, "_pallas_attention_bwd")
    port_bwd = _spy(monkeypatch, tfa, "attention_bwd_reference")
    jpc, tpc = JPromptConfig(text_mode=mode), tcfg.PromptConfig(text_mode=mode)
    jm = jmw.FullModel(CLASSES, jp, jc, prompt_cfg=jpc, rng=jax.random.PRNGKey(3))
    trainable, bank = prompt_state_from_jax(
        jax.tree.map(np.asarray, jm.trainable), jax.tree.map(np.asarray, jm.prompt_learner.bank)
    )
    rng = np.random.default_rng(19)
    batches = [(rng.standard_normal((4, jc.embed_dim)).astype(np.float32),
                rng.integers(0, len(CLASSES), 4).astype(np.int32)) for _ in range(3)]
    mask = np.array([True, True, True, False])
    jopt = jts.make_optimizer(JTrainConfig(lr=2e-3, weight_decay=0.01))
    jstate = jts.init_train_state(jm.trainable, jopt)
    jstep = jts.make_train_step(jc, jpc, jopt, use_image_feats=True)
    tstate = tts.init_train_state(trainable, tts.make_optimizer(tcfg.TrainConfig(lr=2e-3, weight_decay=0.01)))
    tstep = tts.make_train_step(tc, tpc, use_image_feats=True)
    for x, labels in batches:
        jstate, jm_ = jstep(jp, jstate, jm.prompt_learner.bank, jnp.asarray(x), jnp.asarray(labels),
                            jnp.asarray(mask))
        tstate, tm_ = tstep(tp, tstate, bank, x, labels, mask)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(_np(tm_[key]), _np(jm_[key]), err_msg=key, **TRAJ_TOL)
    np.testing.assert_allclose(_np(tstate.params["ctx"]), _np(jstate.params["ctx"]), **TRAJ_TOL)
    assert jax_bwd and len(port_bwd) == 3 * tc.text_layers
