"""Expert parallelism (MoE towers over ``model``, under ``data`` and FSDP),
LoRA and distillation under tp, and VPT-deep under sequence parallelism,
against the JAX package's mesh forms, on the CPU.

One gloo world of 4 ranks is spawned once for the module
(``parallel_ranks.expert_legs``: one torch thread a rank, never jax).  Each
form runs on the sub-mesh of its size (``make_mesh(dp, tp)`` over the first
``dp * tp`` ranks; the others wait), and beside it the same form in one
process on the whole batch, while this process runs the JAX package's form
of each on the suite's virtual devices (``make_mesh(dp=2, tp=2,
devices=jax.devices()[:4])``).  Both sides take the same weights (the
JAX package's inits, bridged by ``params_from_jax`` / ``lora_from_jax``) and
the same NumPy batches, two steps each:

* the MoE InfoNCE + load-balance step (4 experts a block) on tp 2, dp 2,
  dp 2 x tp 2, dp 2 + FSDP and tp 2 + SP, and GradCache (K = 2) on dp 2;
* LoRA on tp 2, dense and on the MoE banks (the adapters replicated, each
  delta cut as its base leaf);
* distillation on tp 2 from a teacher of its own heads and width;
* VPT-deep (8 tokens, the image tower locked) on tp 2 + SP, where the
  prompt rows 1..8 of the tower's 16 straddle the two ranks' halves.

The JAX side runs one program an input on dp 2 x tp 2
(``test_torch_parallel.py``'s rule: a GSPMD program's values do not depend
on its mesh, nor on FSDP's and SP's layout constraints): the MoE forms read
one plain MoE program, VPT-deep the ``seq_parallel=True``, locked-tower
step that ``pretrain_cli --vpt-deep --seq-parallel --lock-image-tower``
builds.

Losses at ``TRAJ_TOL`` against the JAX form's (GradCache: against the
port's one-process step, since the two packages report its load-balance
term differently, ``test_torch_moe.py``) and against one process, the trees
as ``test_torch_parallel.py`` holds them; each rank's expert banks cut to
``E / tp`` experts (and ``1/dp`` of dimension 1 under FSDP, moments too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import parallel_ranks as R
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.parallel import mesh as jmesh
from tapclip_tpu.parallel import sharding as jshard

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import pretrain as tpre
from tapclip_tpu_torch.utils.jax_bridge import lora_from_jax, params_from_jax

torch.set_num_threads(1)

TRAJ_TOL = dict(rtol=1e-4, atol=5e-6)
B, STEPS, E = 8, 2, 4
J_MOE = J_TINY.replace(moe_experts=E)
J_VPT = J_TINY.replace(vpt_tokens=8, vpt_deep=True)  # T 5 + 8 = 13, padded to 16: rows 1..8 over two halves
J_TEACHER = J_TINY.replace(embed_dim=48, vision_width=96, text_width=96, vision_heads=2, text_heads=2)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _entry(cfg, params, rng, n=B, **extra):
    ids = rng.integers(1, cfg.vocab_size - 2, (n, cfg.context_length)).astype(np.int32)
    ids[:, 0] = cfg.vocab_size - 2
    ids[np.arange(n), rng.integers(3, cfg.context_length, n)] = cfg.vocab_size - 1
    return {"cfg": _fields(cfg), "tree": _np_tree(params),
            "x": rng.integers(0, 256, (n, cfg.image_size, cfg.image_size, 3)).astype(np.uint8), "ids": ids, **extra}


def _inputs(out_dir):
    from tapclip_tpu import distill as jdist
    from tapclip_tpu import peft as jpeft

    rng = np.random.default_rng(0)
    tiny = jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY)
    moe = jclip.init_clip_params(jax.random.PRNGKey(1), J_MOE)
    return {
        "legs": tuple(R.EXPERT_FORMS), "out_dir": out_dir,
        "moe": _entry(J_MOE, moe, rng),
        "moe_gc": _entry(J_MOE, moe, rng, n=2 * B),
        "vpt_deep": _entry(J_VPT, jclip.init_clip_params(jax.random.PRNGKey(10), J_VPT), rng),
        "lora": _entry(J_TINY, tiny, rng, lora=_np_tree(jpeft.init_lora_params(jax.random.PRNGKey(1), tiny,
                                                                                   rank=R.LORA_RANK))),
        "lora_moe": _entry(J_MOE, moe, rng, lora=_np_tree(jpeft.init_lora_params(jax.random.PRNGKey(3), moe,
                                                                                     rank=R.LORA_RANK))),
        "distill": _entry(J_TINY, jdist.init_distill_params(jax.random.PRNGKey(2), tiny, 32, 48), rng,
                          teacher=_np_tree(jclip.init_clip_params(jax.random.PRNGKey(5), J_TEACHER)),
                          teacher_cfg=_fields(J_TEACHER)),
    }


def _jax_form(e, dp, tp, key, fsdp=False, seq_parallel=False, k=1, lock_image=False):
    """The JAX package's form on its virtual mesh: per-step losses and the
    trained tree in the port's layout."""
    from tapclip_tpu import distill as jdist
    from tapclip_tpu import peft as jpeft
    from tapclip_tpu import pretrain as jpre

    cfg = J_TINY.__class__(**e["cfg"])
    mesh = jmesh.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    opt = optax.adamw(R.LR_PRE, weight_decay=R.WD_PRE)
    losses = []
    with mesh:
        params = jshard.shard_params(jax.tree.map(jnp.asarray, e["tree"]), mesh, fsdp=fsdp)
        batch = jshard.shard_batch((jnp.asarray(e["x"]), jnp.asarray(e["ids"])), mesh)
        if key.startswith("lora"):
            lora = jshard.replicate(jax.tree.map(jnp.asarray, e["lora"]), mesh)
            state = jshard.replicate(opt.init(lora), mesh)
            step = jpeft.make_lora_pretrain_step(cfg, opt, mesh=mesh, alpha=R.LORA_ALPHA)
            for _ in range(STEPS):
                lora, state, m = step(params, lora, state, *batch)
                lora, state = jshard.replicate(lora, mesh), jshard.replicate(state, mesh)
                losses.append([float(m["loss"])])
            return {"loss": losses, "tree": dict(tpre.named_leaves(lora_from_jax(_np_tree(lora))))}
        if key == "distill":
            tcfg_j = J_TINY.__class__(**e["teacher_cfg"])
            teacher = jshard.shard_params(jax.tree.map(jnp.asarray, e["teacher"]), mesh)
            state = jshard.replicate(opt.init(params), mesh)
            step = jdist.make_distill_step(cfg, tcfg_j, opt, mesh, **R.DISTILL_KW)
            for _ in range(STEPS):
                params, state, m = step(params, teacher, state, *batch)
                params, state = jshard.shard_params(params, mesh), jshard.replicate(state, mesh)
                losses.append([float(m[n]) for n in ("loss", "task", "kd", "feat")])
        else:
            if lock_image:
                opt = jpre.lock_tower_optimizer(opt, lock_image=True)

            def place(p, s):
                s = jshard.shard_opt_state(s, mesh, fsdp=True) if fsdp else jshard.replicate(s, mesh)
                return jshard.shard_params(p, mesh, fsdp=fsdp), s

            state = place(params, opt.init(params))[1]
            if k > 1:
                step = jpre.make_accum_pretrain_step(cfg, opt, k, mesh=mesh)
            else:
                step = jpre.make_pretrain_step(cfg, opt, mesh=mesh, seq_parallel=seq_parallel, fsdp=fsdp,
                                               lock_image=lock_image)
            for _ in range(STEPS):
                params, state, m = step(params, state, *batch)
                params, state = place(params, state)  # the first step's placement: the second reuses its executable
                losses.append([float(m["loss"])])
    return {"loss": losses, "tree": dict(tpre.named_leaves(params_from_jax(_np_tree(params),
                                                                            tcfg.CLIPConfig(**e["cfg"]))))}


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """``(inputs, {form: jax result}, [rank results])``: the 4 ranks run while
    JAX computes; the join has a timeout."""
    d = tmp_path_factory.mktemp("expert")
    procs = []
    try:
        inp = _inputs(str(d))
        path = str(d / "inputs.pt")
        torch.save(inp, path)
        procs = R.spawn(4, 1, path, str(d / "ranks"), legs="expert_legs")
        # A GSPMD program's values do not depend on its mesh or its layout constraints: one JAX program a
        # input entry, on dp 2 x tp 2, with the options of the first form that names the entry (the MoE
        # forms on tp 2, dp 2, dp 2 x tp 2, with FSDP and with SP all read the plain MoE program).
        runs = {}
        for _, _, kw in R.EXPERT_FORMS.values():
            if kw["key"] not in runs:
                runs[kw["key"]] = _jax_form(inp[kw["key"]], 2, 2, **kw)
        want = {name: runs[kw["key"]] for name, (_, _, kw) in R.EXPERT_FORMS.items()}
        got = R.wait(procs, str(d / "ranks"), timeout=300.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return inp, want, got


def _assert_tree(got, want, steps=STEPS):
    """``test_torch_parallel.py``'s rule (every entry within 2 lr a step, at
    most one in a thousand outside ``TRAJ_TOL``, the key biases aside)."""
    assert sorted(got) == sorted(want)
    for path in sorted(want):
        g, w = np.asarray(got[path]).reshape(-1), np.asarray(want[path]).reshape(-1)
        diff = np.abs(g - w)
        assert diff.max(initial=0.0) <= 2 * R.LR_PRE * steps, (path, diff.max())
        if path.endswith("attn/b_qkv"):
            W = g.shape[0] // 3
            g, w, diff = (np.delete(a, np.s_[W:2 * W]) for a in (g, w, diff))
        outside = int((diff > TRAJ_TOL["atol"] + TRAJ_TOL["rtol"] * np.abs(w)).sum())
        assert outside <= max(2, g.size // 1000), (path, outside, g.size, diff.max(initial=0.0))


def _ranks_of(got, name):
    return [r[name] for r in got if name in r]


@pytest.mark.parametrize("form", sorted(R.EXPERT_FORMS))
def test_forms_match_jax_and_one_process(legs, form):
    """Each form's two steps on each of its ranks: the losses (distillation:
    loss, task, kd, feat) at TRAJ_TOL against the JAX package's same mesh
    form and against the port's step in one process on the whole batch, the
    trained tree against the JAX form's and the one process's."""
    _, want, got = legs
    dp, tp, kw = R.EXPERT_FORMS[form]
    ranks = _ranks_of(got, form)
    assert len(ranks) == dp * tp
    for r in ranks:
        np.testing.assert_allclose(r["mesh"]["loss"], r["one"]["loss"], **TRAJ_TOL)
        if kw.get("k", 1) == 1:  # GradCache: the packages report its load-balance term differently
            np.testing.assert_allclose(r["mesh"]["loss"], want[form]["loss"], **TRAJ_TOL)
        _assert_tree(r["mesh"]["tree"], want[form]["tree"])
        _assert_tree(r["mesh"]["tree"], r["one"]["tree"])


@pytest.mark.parametrize("form", ["moe_tp2", "moe_dp2tp2", "moe_dp2fsdp", "lora_moe_tp2"])
def test_each_rank_holds_its_experts(legs, form):
    """A rank's expert banks: ``E / tp`` experts (experts j*E/tp .. of model
    rank j), under FSDP ``1/dp`` of ``w_fc``'s and ``w_proj``'s dimension 1
    too, in the params and in the AdamW moments; the router whole."""
    _, _, got = legs
    dp, tp, kw = R.EXPERT_FORMS[form]
    fsdp = kw.get("fsdp", False)
    W, H = J_TINY.vision_width, 4 * J_TINY.vision_width
    d = dp if fsdp else 1
    for r in _ranks_of(got, form):
        shapes = [r["local_shapes"]] + ([] if form.startswith("lora") else [r["moment_shapes"]])
        for s in shapes:
            assert s["visual/blocks/0/moe/w_fc"] == (E // tp, W // d, H)
            assert s["visual/blocks/0/moe/w_proj"] == (E // tp, H // d, W)
            assert s["text/blocks/1/moe/b_fc"] == (E // tp, H)
            assert s["text/blocks/1/moe/b_proj"] == (E // tp, W)
        assert r["local_shapes"]["visual/blocks/0/moe/router/w"] == (W, E)


def test_moe_under_tp_equals_the_whole_bank_bit_for_bit():
    """One MoE block's expert half over two banks of 2 experts (the ranks'
    parts, summed as the all-reduce sums them) equals the 4-expert bank's
    output bit for bit: each token's value comes from one rank, the others
    add exact zeros."""
    from tapclip_tpu_torch.models import moe

    g = torch.Generator().manual_seed(0)
    p = moe.init_moe_mlp(g, 32, 128, 4)
    p["b_fc"] = torch.randn(4, 128, generator=g) * 0.1
    x = torch.randn(3, 24, 32, generator=g)
    whole, lb = moe.moe_mlp_forward(x, p, "gelu", valid_len=21)
    r = moe.route(x, p, valid_len=21)
    C = moe.expert_capacity(21, 4, 1.25)
    parts = []
    for j in range(2):
        bank = {k: (v if k == "router" else v[2 * j:2 * j + 2]) for k, v in p.items()}
        slot = moe.slots(r, C, 2, 2 * j)
        h = moe._f32_bmm(moe.dispatch(x, slot, 2, C), bank["w_fc"], x.dtype) + bank["b_fc"][:, None]
        out = moe._f32_bmm(moe.ACTS["gelu"](h), bank["w_proj"], x.dtype) + bank["b_proj"][:, None]
        parts.append(moe.combine(out, slot, r.gate))
    assert torch.equal(parts[0] + parts[1], whole)
    assert bool(((parts[0] != 0).any(-1) & (parts[1] != 0).any(-1)).sum() == 0)  # no token on both ranks
    assert lb.shape == ()
