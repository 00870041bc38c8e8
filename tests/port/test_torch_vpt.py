"""VPT and patch dropout in the port's image tower against the JAX package, on the CPU.

* ``encode_image`` with shallow (``[P, W]``) and deep (``[L, P, W]``) VPT
  tokens carried by ``params_from_jax``, against JAX's, at rtol 1e-5,
  atol 1e-6 (f32 summation order).
* Patch dropout with JAX's own index draw (``jax.lax.top_k`` of
  ``jax.random.uniform``) fed in: ``encode_image`` against JAX's at the same
  tolerance; the port's draw keeps ``max(1, round(n (1 - p)))`` distinct
  patches, the class token first; eval passes no generator and never drops.
* A 3-step VPT-deep fine-tune through an image-tower lock against JAX's
  (the prompts train, the tower stays bit-identical); losses rtol 1e-4,
  atol 5e-6, parameters as ``test_torch_pretrain._assert_tree``.
* ``ensure_vpt_params`` and every refusal of the JAX package (VPT x MaPLe,
  VPT x token pruning, patch dropout x token pruning, VPT and patch dropout
  on the RN tower).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tapclip_tpu import pretrain as jpre
from tapclip_tpu.config import MODEL_PRESETS as J_PRESETS
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.models import clip as jclip

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import pretrain as tpre
from tapclip_tpu_torch.models import clip as tclip
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

from test_torch_pretrain import LR, TRAJ_TOL, WD, _assert_tree, _batches, _np

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
T_TINY = tcfg.TINY_TEST


def _images(n=4, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 32, 32, 3)).astype(np.float32)


def _pair(vpt_tokens, deep, seed=0):
    jc = J_TINY.replace(vpt_tokens=vpt_tokens, vpt_deep=deep)
    tc = T_TINY.replace(vpt_tokens=vpt_tokens, vpt_deep=deep)
    jp = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(seed), jc))
    return jc, tc, jp, params_from_jax(jp, tc)


@pytest.mark.parametrize("tokens,deep", [(3, False), (2, True), (11, True)], ids=["shallow3", "deep2", "deep11"])
def test_vpt_encode_image_matches_jax(tokens, deep):
    jc, tc, jp, tp = _pair(tokens, deep)
    want_shape = (2, tokens, 64) if deep else (tokens, 64)
    assert tuple(tp["visual"]["vpt"].shape) == want_shape == tclip.vpt_shape(tc)
    x = _images()
    want = np.asarray(jclip.encode_image(jax.tree.map(jnp.asarray, jp), jc, jnp.asarray(x)))
    got = _np(tclip.encode_image(tp, tc, torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, **TOL)
    plain = _np(tclip.encode_image(tp, T_TINY, torch.from_numpy(x)))  # the prompts change the answer
    assert np.abs(plain - got).max() > 1e-3
    fresh = tclip.init_clip_params(torch.Generator().manual_seed(0), tc)
    assert tuple(fresh["visual"]["vpt"].shape) == want_shape


def _jax_idx(rng, b, n_patches, prob):
    n_keep = max(1, int(round(n_patches * (1.0 - prob))))
    return np.asarray(jax.lax.top_k(jax.random.uniform(rng, (b, n_patches)), n_keep)[1])


@pytest.mark.parametrize("prob,vpt", [(0.5, 0), (0.25, 2), (0.9, 0)])
def test_patch_dropout_with_jax_draw_matches_jax(prob, vpt):
    jc = J_TINY.replace(patch_dropout=prob, vpt_tokens=vpt)
    tc = T_TINY.replace(patch_dropout=prob, vpt_tokens=vpt)
    jp = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(1), jc))
    tp = params_from_jax(jp, tc)
    x = _images()
    rng = jax.random.PRNGKey(9)
    want = np.asarray(jclip.encode_image(jax.tree.map(jnp.asarray, jp), jc, jnp.asarray(x), rng=rng))
    idx = torch.from_numpy(_jax_idx(rng, 4, 4, prob))
    got = _np(tclip.encode_image(tp, tc, torch.from_numpy(x), patch_idx=idx))
    np.testing.assert_allclose(got, want, **TOL)
    # Eval (no generator, no indices) never drops: the full tower's answer.
    np.testing.assert_allclose(_np(tclip.encode_image(tp, tc, torch.from_numpy(x))),
                               np.asarray(jclip.encode_image(jax.tree.map(jnp.asarray, jp), jc, jnp.asarray(x))),
                               **TOL)


def test_patch_dropout_indices_draw():
    g = torch.Generator().manual_seed(3)
    idx = tclip.patch_dropout_indices(g, 6, 196, 0.5)
    assert tuple(idx.shape) == (6, 98)  # ViT-B/16: 1 + 98 tokens, T 99
    assert all(len(set(row.tolist())) == 98 and 0 <= min(row) and max(row) < 196 for row in idx)
    assert tclip.patch_dropout_indices(g, 2, 4, 0.1) is None  # round(3.6) = 4: every patch kept
    assert tuple(tclip.patch_dropout_indices(g, 2, 4, 0.99).shape) == (2, 1)
    x = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    out = tclip._patch_dropout(x, torch.tensor([[3, 0], [1, 2]]))
    torch.testing.assert_close(out, torch.stack([x[0, [0, 4, 1]], x[1, [0, 2, 3]]]), rtol=0, atol=0)


def test_vpt_through_an_image_lock_matches_jax():
    jc, tc, jp, tp = _pair(2, True, seed=2)
    batches = _batches(jc)
    opt = jpre.lock_tower_optimizer(optax.adamw(LR, weight_decay=WD), lock_image=True)
    step = jpre.make_pretrain_step(jc, opt, lock_image=True)
    params = jax.tree.map(jnp.asarray, jp)
    state = opt.init(params)
    jl = []
    for x, ids in batches:
        params, state, m = step(params, state, jnp.asarray(x), jnp.asarray(ids))
        jl.append(float(m["loss"]))
    before = tpre.detached_copy(tp)
    mask = tpre.lock_tower_trainable(tp, lock_image=True)
    assert mask["visual/vpt"] and not mask["visual/proj"]
    topt = tpre.PretrainOptimizer(tpre.set_trainable(tp, mask), lr=LR, weight_decay=WD)
    tstep = tpre.make_pretrain_step(tc, topt)
    tl = [float(tstep(tp, x, ids)["loss"]) for x, ids in batches]
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)
    _assert_tree(tp, dict(tpre.named_leaves(params_from_jax(jax.tree.map(np.asarray, params), tc))), TRAJ_TOL)
    old, new = dict(tpre.named_leaves(before)), dict(tpre.named_leaves(tp))
    assert not torch.equal(old["visual/vpt"], new["visual/vpt"])
    for path, trains in mask.items():
        assert trains or torch.equal(old[path], new[path]), path


def test_ensure_vpt_params():
    tc = T_TINY.replace(vpt_tokens=3)
    tp = params_from_jax(jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY)), T_TINY)
    assert tclip.ensure_vpt_params(tp, T_TINY) is tp
    added = tclip.ensure_vpt_params(tp, tc, seed=4)
    assert tuple(added["visual"]["vpt"].shape) == (3, 64) and "vpt" not in tp["visual"]
    assert tclip.ensure_vpt_params(added, tc) is added
    with pytest.raises(ValueError, match="load with the matching config"):
        tclip.ensure_vpt_params(added, tc.replace(vpt_deep=True))
    jadded = jclip.ensure_vpt_params(jax.tree.map(jnp.asarray, jclip.init_clip_params(jax.random.PRNGKey(0),
                                                                                        J_TINY)),
                                     J_TINY.replace(vpt_tokens=3))
    assert jadded["visual"]["vpt"].shape == added["visual"]["vpt"].shape


def test_vpt_and_patch_dropout_refusals_match_jax():
    jc, tc, jp, tp = _pair(2, False)
    x = _images(1)
    jpj = jax.tree.map(jnp.asarray, jp)
    first = np.zeros((2, 64), np.float32)
    with pytest.raises(NotImplementedError, match="both claim the prompt slots"):
        tclip.encode_image(tp, tc, torch.from_numpy(x), maple_prompts=(torch.from_numpy(first), None, None))
    with pytest.raises(NotImplementedError, match="both claim the prompt slots"):
        jclip.encode_image(jpj, jc, jnp.asarray(x), maple_prompts=(jnp.asarray(first), None, None))
    for mod, p, c, arr in ((tclip, tp, tc, torch.from_numpy(x)), (jclip, jpj, jc, jnp.asarray(x))):
        with pytest.raises(NotImplementedError, match="vpt_tokens does not compose with token_keep_ratio"):
            mod.encode_image(p, c.replace(token_keep_ratio=0.5), arr)
    pc = T_TINY.replace(patch_dropout=0.5, token_keep_ratio=0.5)
    with pytest.raises(NotImplementedError, match="do not compose"):
        tclip.encode_image(tp, pc, torch.from_numpy(x), generator=torch.Generator())
    with pytest.raises(NotImplementedError, match="do not compose"):
        jclip.encode_image(jpj, J_TINY.replace(patch_dropout=0.5, token_keep_ratio=0.5), jnp.asarray(x),
                           rng=jax.random.PRNGKey(0))
    rc = dataclasses.replace(J_PRESETS["RN50"], image_size=64, vision_width=64, resnet_layers=(1, 1, 1, 1),
                             text_width=64, text_layers=1, text_heads=4, embed_dim=32, vocab_size=520,
                             context_length=16)
    trc = tcfg.CLIPConfig(**{f.name: getattr(rc, f.name) for f in dataclasses.fields(rc)})
    with pytest.raises(NotImplementedError, match="vpt_tokens applies to ViT towers only"):
        tclip.init_clip_params(torch.Generator().manual_seed(0), trc.replace(vpt_tokens=2))
    rp = tclip.init_clip_params(torch.Generator().manual_seed(0), trc)
    with pytest.raises(NotImplementedError, match="patch_dropout applies to ViT towers only"):
        tclip.encode_image(rp, trc.replace(patch_dropout=0.5), torch.zeros(1, 64, 64, 3), generator=torch.Generator())
    from tapclip_tpu_torch.utils.saliency import vision_attention_forward

    with pytest.raises(NotImplementedError, match="VPT"):
        vision_attention_forward(tp, tc, x)
