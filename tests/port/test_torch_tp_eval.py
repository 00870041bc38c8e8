"""The forms that run last under tensor parallelism: the int8 tower (B13's
and B14's partial modes), token pruning and the RN-family image tower,
against the JAX package's forms and against the port in one process, on
the CPU.

One gloo world of 4 ranks is spawned once for the module
(``parallel_ranks.tp_eval_legs``: one torch thread a rank, never jax).
Each leg runs on tp 2 (ranks 0 and 1) and on dp 2 x tp 2 (all four), and
beside it the same form in one process, while this process runs the JAX
package's forms.  A GSPMD program's values do not depend on its mesh
(``test_torch_parallel.py``'s rule), so the JAX side runs each form as one
program on the whole batch.  Both sides take the same weights (the JAX
package's inits, bridged by ``params_from_jax``) and the same NumPy
batches.

* The image tower at 64 px (T 17, run at 24 with 17 valid keys, so
  pruning at ratio 0.5 keeps 8 tokens), ``TINY_TEST``'s widths: the int8
  tower in round-to-nearest (``make_image_encoder(mesh=)``, and the eval
  step pixels-in: logits against JAX's at ``test_torch_int8.py``'s
  cosine, counts against one process), the stochastic tower
  (``featurize.make_image_embed_fn(mesh=)``), pruning, int8 + pruning.
  The int8 blocks' partial stages are exact (int32 sums, the row maxima
  and the column scales all-reduced MAX, each code drawing its global
  column's bits), so the int8 tower's features equal one process's bit for
  bit on every mesh.  The pruned towers' float blocks run K1's and K2's
  partial modes, whose f32 sums over the two ranks' halves round in another
  order: held at ``FEAT_TOL``.
* Pruning's kept tokens: equal on every rank of a ``model`` group always;
  equal to one process's and to JAX's unless the pair that decides the cut
  lies within ``TIE_TOL`` of each other (a near tie the ranks' rounding
  may flip), which is reported.
* The RN tower (RN50 at ``resnet_layers=(1, 1, 1, 1)``, 64 px, with
  ``TINY_TEST``'s text tower): a prompt-tune step and an InfoNCE step, two
  steps each, losses and trees at ``TRAJ_TOL`` against JAX and one process
  (rank 0's, on the whole batch); the RN leaves whole on every rank, their
  gradients the one process's (not summed over ``model``).
* The plain partial stages of B13 and B14, two ranks summed, against the
  whole plain blocks bit for bit; the int8 blocks under sequence
  parallelism; the refusals the JAX package keeps.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import parallel_ranks as R
from tapclip_tpu.config import MODEL_PRESETS as J_PRESETS
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.config import PromptConfig as JPromptConfig
from tapclip_tpu.config import TrainConfig as JTrainConfig
from tapclip_tpu.data.tokenizer import get_tokenizer as j_tokenizer
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models.model_wrapper import full_model_forward as j_full_model_forward
from tapclip_tpu.models.model_wrapper import init_trainable as j_init_trainable
from tapclip_tpu.models.prompt_learner import PromptBank as JPromptBank
from tapclip_tpu.models.prompt_learner import PromptLearner as JPromptLearner
from tapclip_tpu.parallel import train_step as jts

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import pretrain as tpre
from tapclip_tpu_torch.ops import int8_attn, int8_mlp
from tapclip_tpu_torch.parallel.sharding import _qkv_parts
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

torch.set_num_threads(1)

TRAJ_TOL = dict(rtol=1e-4, atol=5e-6)
FEAT_TOL = 1e-5  # norm-relative, the float pruned tower: test_torch_int8.py's against JAX
COS_MIN = 0.9999  # the int8 tower against JAX's round-to-nearest model (test_torch_int8.py)
TIE_TOL = 1e-6  # a kept-token flip is a near tie if the deciding pair's scores lie this close
# The prompt context's displacement, norm-relative (chip_smoke.py's TRAIN_TOL "ctx_step" in f32): AdamW's
# update is about lr a step whatever the gradient's size, so an entry whose gradient is near zero moves by a
# step that summation order decides, and an entrywise rule reads that as a disagreement.
CTX_STEP_TOL = 1e-4
B, STEPS = 8, 2
CLASSES = R.CLASSES
J_EVAL = J_TINY.replace(image_size=64)
# RN50's image tower cut to one bottleneck a stage at 64 px; TINY_TEST's text tower.
J_RN = J_PRESETS["RN50"].replace(resnet_layers=(1, 1, 1, 1), image_size=64, vision_width=16, embed_dim=64,
                                 **{f: getattr(J_TINY, f) for f in ("vocab_size", "context_length", "text_width",
                                                                    "text_layers", "text_heads")})
GROUPS = {name: dp * tp for name, (dp, tp) in R.TP_EVAL_MESHES.items()}


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _prompt_entry(cfg, params, x, rng):
    pcfg = JPromptConfig(max_classes=8)
    learner = JPromptLearner(CLASSES, params, cfg, pcfg, j_tokenizer(context_length=cfg.context_length))
    trainable = j_init_trainable(jax.random.PRNGKey(1), learner, pcfg)
    bank = learner.bank
    mask = np.ones(len(x), bool)
    mask[1] = False
    return {"cfg": _fields(cfg), "tree": _np_tree(params), "trainable": _np_tree(trainable),
            "bank": {k: np.asarray(getattr(bank, k)) for k in ("ctx", "token_embs", "class_mask", "eot_pos")},
            "x": x, "labels": rng.integers(0, len(CLASSES), len(x)).astype(np.int32), "mask": mask}


def _np_init(cfg, seed):
    """A tree of the JAX package's ``init_clip_params(cfg)`` structure (by
    ``jax.eval_shape``: nothing compiles), its leaves drawn with numpy:
    weights ``N(0, 1/fan_in)``, scales and variances near 1, biases and
    means near 0, ``logit_scale`` log(1/0.07)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jclip.init_clip_params(jax.random.PRNGKey(0), cfg))

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['logit_scale']"):
            return np.float32(np.log(1 / 0.07))
        if name.endswith(("['scale']", "['var']")):
            return (1.0 + 0.1 * np.abs(rng.standard_normal(s.shape))).astype(np.float32)
        if name.endswith(("['bias']", "['mean']", "['b']")) or name.endswith(("b_qkv']", "b_out']", "b_fc']",
                                                                            "b_proj']")):
            return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[1:])) if len(s.shape) == 4 else s.shape[0]
        return (rng.standard_normal(s.shape) * fan_in ** -0.5).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs():
    rng = np.random.default_rng(0)
    ev = _np_init(J_EVAL, 1)
    rn = _np_init(J_RN, 2)
    pix = lambda cfg: rng.standard_normal((B, cfg.image_size, cfg.image_size, 3)).astype(np.float32)  # noqa: E731
    ids = rng.integers(1, J_RN.vocab_size - 2, (B, J_RN.context_length)).astype(np.int32)
    ids[:, 0] = J_RN.vocab_size - 2
    ids[np.arange(B), rng.integers(3, J_RN.context_length, B)] = J_RN.vocab_size - 1
    entry = _prompt_entry(J_EVAL, ev, pix(J_EVAL), rng)
    entry["seq_x"] = rng.standard_normal((2, 24, J_EVAL.vision_width)).astype(np.float32)
    return {
        "eval": entry,
        "rn_prompt": _prompt_entry(J_RN, rn, pix(J_RN), rng),
        "rn_pre": {"cfg": _fields(J_RN), "tree": _np_tree(rn),
                   "x": rng.integers(0, 256, (B, 64, 64, 3)).astype(np.uint8), "ids": ids},
    }


def _bank(e):
    return JPromptBank(**{k: jnp.asarray(v) for k, v in e["bank"].items()})


def _jax_forms(inp, monkeypatch):
    """The JAX package's forms, one program each on the whole batch."""
    from tapclip_tpu import pretrain as jpre

    e = inp["eval"]
    x = jnp.asarray(e["x"])
    out = {}
    j_top_k = jax.lax.top_k
    for form, kw in R.TP_EVAL_FORMS.items():
        if form == "int8_sr":
            continue  # the stochastic mode has no JAX counterpart off a TPU (test_torch_int8.py)
        kept = []

        def spy(scores, k, kept=kept):
            res = j_top_k(scores, k)
            kept.append(np.asarray(res[1]))
            return res

        monkeypatch.setattr(jax.lax, "top_k", spy)
        feats = np.asarray(jclip.encode_image(e["tree"], J_EVAL.replace(**kw), x))
        monkeypatch.setattr(jax.lax, "top_k", j_top_k)
        out[form] = {"feats": feats, "kept": kept}
    cfg = J_EVAL.replace(**R.TP_EVAL_FORMS["int8"])
    fwd = jax.jit(lambda p, t, bk, im: j_full_model_forward(p, t, bk, im, None, clip_cfg=cfg,
                                                            prompt_cfg=JPromptConfig(max_classes=8))["logits"])
    out["int8"]["logits"] = np.asarray(fwd(e["tree"], e["trainable"], _bank(e), x))

    p = inp["rn_prompt"]
    opt = jts.make_optimizer(JTrainConfig(lr=R.LR_PROMPT, weight_decay=0.01))
    state = jts.init_train_state(jax.tree.map(jnp.asarray, p["trainable"]), opt)
    step = jts.make_train_step(J_RN, JPromptConfig(max_classes=8), opt, use_image_feats=False)
    losses = []
    for _ in range(STEPS):
        state, m = step(p["tree"], state, _bank(p), jnp.asarray(p["x"]), jnp.asarray(p["labels"]),
                        jnp.asarray(p["mask"]))
        losses.append(float(m["loss"]))
    out["rn_prompt"] = {"loss": losses, "ctx": np.asarray(state.params["ctx"])}

    r = inp["rn_pre"]
    opt = optax.adamw(R.LR_PRE, weight_decay=R.WD_PRE)
    params = jax.tree.map(jnp.asarray, r["tree"])
    ostate = opt.init(params)
    step = jpre.make_pretrain_step(J_RN, opt)
    losses = []
    for _ in range(STEPS):
        params, ostate, m = step(params, ostate, jnp.asarray(r["x"]), jnp.asarray(r["ids"]))
        losses.append(float(m["loss"]))
    out["rn_infonce"] = {"loss": losses,
                         "tree": dict(tpre.named_leaves(params_from_jax(_np_tree(params), tcfg.CLIPConfig(**r["cfg"]))))}
    return out


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """``(inputs, jax results, [rank results])``: the 4 ranks run while JAX
    computes; the join has a timeout."""
    d = tmp_path_factory.mktemp("tp_eval")
    procs = []
    mp = pytest.MonkeyPatch()
    try:
        inp = _inputs()
        path = str(d / "inputs.pt")
        torch.save(inp, path)
        procs = R.spawn(4, 1, path, str(d / "ranks"), legs="tp_eval_legs")
        want = _jax_forms(inp, mp)
        got = R.wait(procs, str(d / "ranks"), timeout=300.0)
    finally:
        mp.undo()
        for p in procs:
            if p.poll() is None:
                p.kill()
    return inp, want, got


def _ranks(got, group):
    return [r[group] for r in got if group in r]


def _my_rows(group, res):
    """This rank's rows of the global batch: its ``data`` index's slice."""
    dp = R.TP_EVAL_MESHES[group][0]
    b = B // dp
    d = res["place"][0]
    return slice(d * b, (d + 1) * b)


def _cos_rows(a, b):
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def _rel(a, b):
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_every_rank_ran(legs, group):
    _, _, got = legs
    ranks = _ranks(got, group)
    assert len(ranks) == GROUPS[group]
    assert sorted(r["place"] for r in ranks) == sorted(
        (d, m) for d in range(R.TP_EVAL_MESHES[group][0]) for m in range(R.TP_EVAL_MESHES[group][1]))


@pytest.mark.parametrize("form", ["int8", "int8_sr"])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_int8_tower_equals_one_process_bit_for_bit(legs, group, form):
    """The int8 tower's features on each rank (its rows) equal the port's
    one-process tower on the same rows, bit for bit, in both modes."""
    _, _, got = legs
    for r in _ranks(got, group):
        res = r[form]
        np.testing.assert_array_equal(res["mesh"]["feats"], res["one"]["feats"])


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_int8_tower_matches_jax(legs, group):
    """The round-to-nearest tower's features and the eval step's logits
    (pixels in) against the JAX package's at ``test_torch_int8.py``'s
    cosine; the eval step's counts summed over ``data`` equal one
    process's."""
    _, want, got = legs
    for r in _ranks(got, group):
        rows = _my_rows(group, r)
        res = r["int8"]
        assert (_cos_rows(res["mesh"]["feats"], want["int8"]["feats"][rows]) >= COS_MIN).all()
        assert (_cos_rows(res["mesh"]["logits"], want["int8"]["logits"][rows]) >= COS_MIN).all()
        np.testing.assert_allclose(res["mesh"]["logits"], res["one"]["logits"][rows], rtol=1e-5, atol=1e-5)
        for k, v in res["one"]["counts"].items():
            np.testing.assert_array_equal(res["mesh"]["counts"][k], v)


def _flips(kept, ref, scores, n_keep):
    """Rows whose kept set differs from ``ref``'s; each must be a near tie
    of ``scores`` (the reference's) at the cut.  Returns the flipped rows."""
    kept, ref = np.sort(kept, axis=-1), np.sort(ref, axis=-1)
    bad = np.nonzero((kept != ref).any(-1))[0]
    for i in bad:
        s = np.sort(np.asarray(scores[i], np.float64)[1:])[::-1]  # the patches, the class token aside
        gap = s[n_keep - 2] - s[n_keep - 1]
        assert gap <= TIE_TOL, (i, gap)
    return bad.tolist()


@pytest.mark.parametrize("form", ["pruned", "int8_pruned"])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_pruned_tower_matches_jax_and_one_process(legs, group, form):
    """Pruning's kept tokens equal on every rank of a ``model`` group, and
    one process's and JAX's but for a reported near tie; the features at
    ``FEAT_TOL`` against one process and JAX (int8 + pruning: JAX's at the
    int8 cosine)."""
    _, want, got = legs
    ranks = _ranks(got, group)
    flipped = {}
    for r in ranks:
        rows = _my_rows(group, r)
        res = r[form]
        kept, scores = res["mesh"]["kept"][0], res["one"]["scores"][0]
        assert kept.shape == (rows.stop - rows.start, 8) and (kept[:, 0] == 0).all()
        flips = sorted(set(_flips(kept, res["one"]["kept"][0], scores, kept.shape[1]))
                       | set(_flips(kept, want[form]["kept"][0][rows], scores, kept.shape[1])))
        if flips:
            flipped[r["place"]] = flips
        keep = np.setdiff1d(np.arange(kept.shape[0]), flips)  # a flipped row keeps another token: not compared
        got_f, one_f, jax_f = res["mesh"]["feats"][keep], res["one"]["feats"][keep], want[form]["feats"][rows][keep]
        if form == "pruned":
            assert _rel(got_f, one_f) < FEAT_TOL and _rel(got_f, jax_f) < FEAT_TOL
        else:  # the int8 blocks are exact: only the kept tokens could move them
            np.testing.assert_array_equal(got_f, one_f)
            assert (_cos_rows(got_f, jax_f) >= COS_MIN).all()
    for d in {r["place"][0] for r in ranks}:  # the model group of each data index keeps the same tokens
        same = [r[form]["mesh"]["kept"][0] for r in ranks if r["place"][0] == d]
        for k in same[1:]:
            np.testing.assert_array_equal(k, same[0])
    if flipped:
        print(f"{group} {form}: kept-token near ties flipped (rank place: rows) {flipped}")


@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "nearest"])
def test_int8_blocks_under_sequence_parallelism(legs, deterministic):
    """The int8 tower's blocks with ``seq_parallel`` over tp 2 (each int8
    half-block gathers the rank's rows and keeps them after) equal the
    blocks in one process bit for bit."""
    _, _, got = legs
    for r in _ranks(got, "tp2"):
        res = r["int8_seq"][deterministic]
        np.testing.assert_array_equal(res["mesh"], res["one"])


def _assert_tree(got, want, steps=STEPS, lr=R.LR_PRE):
    """``test_torch_parallel.py``'s rule (every entry within 2 lr a step, at
    most one in a thousand outside ``TRAJ_TOL``, the key biases aside)."""
    assert sorted(got) == sorted(want)
    for path in sorted(want):
        g, w = np.asarray(got[path]).reshape(-1), np.asarray(want[path]).reshape(-1)
        diff = np.abs(g - w)
        assert diff.max(initial=0.0) <= 2 * lr * steps, (path, diff.max())
        if path.endswith("attn/b_qkv"):
            W = g.shape[0] // 3
            g, w, diff = (np.delete(a, np.s_[W:2 * W]) for a in (g, w, diff))
        if path.endswith("attnpool/k_proj/b"):  # the key bias of the RN tower's pooling: float noise, as above
            continue
        outside = int((diff > TRAJ_TOL["atol"] + TRAJ_TOL["rtol"] * np.abs(w)).sum())
        assert outside <= max(2, g.size // 1000), (path, outside, g.size, diff.max(initial=0.0))


def _one(got):
    return [r["one"] for r in got if "one" in r][0]


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_rn_prompt_step_matches_jax_and_one_process(legs, group):
    """The RN50 prompt-tune step (pixels in: the RN tower replicated, the
    text tower tensor parallel): losses and grad norms at ``TRAJ_TOL``, the
    context's displacement over the two steps at ``CTX_STEP_TOL``, against
    the JAX step and one process."""
    inp, want, got = legs
    one = _one(got)["rn_prompt"]
    ctx0 = np.asarray(inp["rn_prompt"]["trainable"]["ctx"], np.float64)
    for r in _ranks(got, group):
        res = r["rn_prompt"]
        for ref in (want["rn_prompt"], one):
            np.testing.assert_allclose(res["loss"], ref["loss"], **TRAJ_TOL)
            ctx = ref["ctx"] if "ctx" in ref else ref["params"]["ctx"]
            assert _rel(res["params"]["ctx"] - ctx0, ctx - ctx0) < CTX_STEP_TOL
        np.testing.assert_allclose(res["grad_norm"], one["grad_norm"], **TRAJ_TOL)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_rn_infonce_step_matches_jax_and_one_process(legs, group):
    """The RN50 InfoNCE step, every leaf trained: losses at ``TRAJ_TOL``
    against JAX and one process, the gathered tree as
    ``test_torch_parallel.py`` holds trees; the RN leaves whole on every
    rank, their first-step gradients the one process's (a sum over
    ``model`` would double them), the clip's norm the whole tree's."""
    _, want, got = legs
    one = _one(got)["rn_infonce"]
    whole = {p: tuple(v.shape) for p, v in want["rn_infonce"]["tree"].items() if p.startswith("visual/")}
    for r in _ranks(got, group):
        res = r["rn_infonce"]
        for ref in (want["rn_infonce"], one):
            np.testing.assert_allclose(res["loss"], ref["loss"], **TRAJ_TOL)
            _assert_tree(res["tree"], ref["tree"])
        assert res["rn_local_shapes"] == whole
        # the pooling's key bias aside: its gradient is float noise (adding it to every key moves no softmax)
        err = max(_rel(res["rn_grads"][p], g) for p, g in one["rn_grads"].items()
                  if np.linalg.norm(g) > 1e-12 and not p.endswith("attnpool/k_proj/b"))
        assert err < 1e-4, err
        np.testing.assert_allclose(res["norm"], one["norm"], rtol=1e-4)


@pytest.mark.parametrize("tp", [1, 2])
def test_rn_leaves_are_never_cut(tp):
    """Every leaf of the RN tower is a replica under ``model``, FSDP and
    both (as the JAX package's ``_spec_for_path``): none matches a cut."""
    from tapclip_tpu_torch.models import clip as tclip
    from tapclip_tpu_torch.parallel import sharding as S

    cfg = tcfg.CLIPConfig(**_fields(J_RN))
    tree = tclip.init_clip_params(torch.Generator().manual_seed(0), cfg)
    visual = [p for p, _ in tpre.named_leaves(tree) if p.startswith("visual/")]
    assert len(visual) > 50
    for path in visual:
        for fsdp in (False, True):
            assert S._spec_for_path(S.stacked_path(path), tp > 1, False, fsdp) == (), (path, fsdp)


# --- the plain partial stages, in one process ----------------------------------------------------------


def _block(seed, W=128):
    g = torch.Generator().manual_seed(seed)
    H = 4 * W

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=g) * s

    ln = {"scale": 1.0 + rn(W, s=0.1), "bias": rn(W, s=0.1)}
    mlp = {"w_fc": rn(W, H, s=W ** -0.5), "b_fc": rn(H, s=0.1), "w_proj": rn(H, W, s=H ** -0.5), "b_proj": rn(W, s=0.1)}
    attn = {"w_qkv": rn(W, 3 * W, s=W ** -0.5), "b_qkv": rn(3 * W, s=0.1), "w_out": rn(W, W, s=W ** -0.5),
            "b_out": rn(W, s=0.1)}
    return rn(2, 24, W), ln, mlp, attn


def _two_ranks(op, args, outs, stream, deterministic):
    """``int8_mlp.run_partial`` for ranks 0 and 1 in one process: each
    rank's front (``op`` on its ``args``), the fronts' row max, the int32
    partials on its out weights ``outs[j] = (w_q, s_col, b_col)`` summed,
    then the epilogue."""
    x, n_local = args[0][0], outs[0][0].shape[0]
    R_ = x.numel() // x.shape[-1]
    fronts = [op(*a, True) for a in args]
    top = torch.maximum(fronts[0][R_ * n_local:], fronts[1][R_ * n_local:])
    for f in fronts:
        f[R_ * n_local:] = top
    acc = sum(torch.ops.tapclip.int8_partial_out.default(f, w[0], 3, stream, deterministic, j * n_local)
              for j, (f, w) in enumerate(zip(fronts, outs)))
    return [torch.ops.tapclip.int8_epilogue.default(acc, f, w[1], w[2], x) for f, w in zip(fronts, outs)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "nearest"])
def test_int8_mlp_plain_partials_sum_to_the_whole_block(deterministic, dtype):
    """B13's plain partial stages over two ranks' cuts (fc's columns,
    proj's rows, proj's column scales over the whole weight) equal the
    whole plain block bit for bit."""
    x, ln, mlp, _ = _block(1)
    x = x.to(dtype)
    H = mlp["w_fc"].shape[1]
    whole = int8_mlp.int8_mlp_block(x, ln, mlp, deterministic=deterministic, seed=3)
    qfull = int8_mlp.quantize_mlp(mlp)
    args, outs = [], []
    for j in range(2):
        c = slice(j * H // 2, (j + 1) * H // 2)
        q = int8_mlp.quantize_mlp({"w_fc": mlp["w_fc"][:, c], "b_fc": mlp["b_fc"][c], "w_proj": mlp["w_proj"][c],
                                   "b_proj": mlp["b_proj"]})
        q.update(w_proj=qfull["w_proj"][c], s_proj=qfull["s_proj"])  # what quantize_mlp(tp_group=) gives
        args.append((x, ln["scale"], ln["bias"], *(q[k] for k in int8_mlp.Q_MLP), 1e-5, 3, deterministic))
        outs.append((q["w_proj"], q["s_proj"], q["b_proj"]))
    for o in _two_ranks(torch.ops.tapclip.int8_mlp.default, args, outs, int8_mlp.STREAM_MLP_H, deterministic):
        torch.testing.assert_close(o, whole, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "nearest"])
def test_int8_attn_plain_partials_sum_to_the_whole_block(deterministic, dtype):
    """B14's plain partial stages over two ranks' heads (the per-head qkv
    cut, w_out's rows with the whole weight's column scales), 21 valid keys
    of 24, equal the whole plain block bit for bit."""
    x, ln, _, attn = _block(2)
    x = x.to(dtype)
    W, nh = x.shape[-1], 4
    whole = int8_attn.int8_attn_block(x, ln, attn, nh, valid_len=21, deterministic=deterministic, seed=3)
    qfull = int8_attn.quantize_attn(attn)
    args, outs = [], []
    for j in range(2):
        q = int8_attn.quantize_attn({"w_qkv": _qkv_parts(attn["w_qkv"], 2, j), "b_qkv": _qkv_parts(attn["b_qkv"], 2, j),
                                     "w_out": attn["w_out"][j * W // 2:(j + 1) * W // 2], "b_out": attn["b_out"]})
        q.update(w_out=qfull["w_out"][j * W // 2:(j + 1) * W // 2], s_out=qfull["s_out"])
        args.append((x, ln["scale"], ln["bias"], *(q[k] for k in int8_attn.Q_ATTN), nh // 2, 21, 1e-5, 3,
                     deterministic))
        outs.append((q["w_out"], q["s_out"], q["b_out"]))
    for o in _two_ranks(torch.ops.tapclip.int8_attn.default, args, outs, int8_mlp.STREAM_ATTN_A, deterministic):
        torch.testing.assert_close(o, whole, rtol=0, atol=0)


def test_quantize_cols_over_a_group_of_one_is_the_whole_weight():
    """With no group the column scales are the rank's own (the whole
    weight's when the rank holds it all); the draws of a slice are the
    whole row's columns ``col0 ..``."""
    w = torch.randn(64, 32)
    torch.testing.assert_close(int8_mlp.quantize_cols_int8(w, None)[1], int8_mlp.quantize_cols_int8(w)[1], rtol=0,
                               atol=0)
    bits = int8_mlp.rand_bits(5, 1, 3, 40)
    torch.testing.assert_close(int8_mlp.rand_bits(5, 1, 3, 16, col0=24), bits[:, 24:], rtol=0, atol=0)


@pytest.mark.parametrize("stage,shape,dtype", [
    ("front", (48 * 256 + 48,), torch.float32), ("partial_out", (48, 128), torch.int32),
    ("epilogue", (2, 24, 128), torch.bfloat16)])
def test_int8_ops_fake_stages(stage, shape, dtype):
    """The ops' fake kernels give each stage's shape and dtype (what
    ``torch.export`` traces)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    x, ln, mlp, _ = _block(3)
    x = x.to(torch.bfloat16)
    q = int8_mlp.quantize_mlp({k: v[:, :256] if k == "w_fc" else v[:256] if k in ("b_fc", "w_proj") else v
                               for k, v in mlp.items()})
    ws = torch.zeros(48 * 256 + 48)
    with FakeTensorMode(allow_non_fake_inputs=True):
        if stage == "front":
            out = torch.ops.tapclip.int8_mlp.default(x, ln["scale"], ln["bias"], *(q[k] for k in int8_mlp.Q_MLP),
                                                     1e-5, 0, False, True)
        elif stage == "partial_out":
            out = torch.ops.tapclip.int8_partial_out.default(ws, q["w_proj"], 0, int8_mlp.STREAM_MLP_H, False, 0)
        else:
            out = torch.ops.tapclip.int8_epilogue.default(torch.zeros(48, 128, dtype=torch.int32), ws, q["s_proj"],
                                                          q["b_proj"], x)
    assert tuple(out.shape) == shape and out.dtype == dtype


# --- the refusals the JAX package keeps -----------------------------------------------------------------


def test_int8_refused_under_the_pipe_axis():
    """int8 towers under the pipe axis refuse in JAX's words (the GPipe
    runner and the tower runner)."""
    from types import SimpleNamespace

    from tapclip_tpu_torch.parallel import pipeline

    x = torch.zeros(2, 8, 64)
    with pytest.raises(NotImplementedError, match="int8 quantization is not supported under pipeline parallelism"):
        pipeline.make_pipeline_transformer_fn(SimpleNamespace(), 2)(x, [], 4, act="gelu", quantize=True)
    with pytest.raises(NotImplementedError, match="int8 eval quantization is not supported under pipeline"):
        pipeline.pipeline_transformer_forward(x, [], 4, mesh=SimpleNamespace(), n_microbatches=2, act="gelu",
                                              quantize=True)


@pytest.mark.parametrize("kw", [dict(moe_experts=4), dict(transformer_fn=True)], ids=["moe", "transformer_fn"])
def test_pruning_refused_with_moe_or_a_runner(kw):
    from tapclip_tpu_torch.models import clip as tclip

    cfg = tcfg.CLIPConfig(**_fields(J_EVAL)).replace(token_keep_ratio=0.5, token_prune_layer=1,
                                                     moe_experts=kw.get("moe_experts", 0))
    tree = tclip.init_clip_params(torch.Generator().manual_seed(0), cfg)
    fn = (lambda *a, **k: None) if "transformer_fn" in kw else None
    with pytest.raises(NotImplementedError, match=re.escape("token pruning is not supported with a transformer_fn")):
        tclip.encode_image(tree, cfg, torch.zeros(1, 64, 64, 3), transformer_fn=fn)


def test_patch_dropout_refused_on_the_rn_tower():
    from tapclip_tpu_torch.models import clip as tclip

    cfg = tcfg.CLIPConfig(**_fields(J_RN)).replace(patch_dropout=0.5)
    with pytest.raises(NotImplementedError, match="patch_dropout applies to ViT towers only"):
        tclip.encode_image({"visual": {}}, cfg, torch.zeros(1, 64, 64, 3), generator=torch.Generator())
