"""The port's ``data`` and ``model`` mesh axes against the JAX package's mesh
forms, on the CPU.

The port's ranks are processes of gloo groups (``parallel_ranks.py``: one
torch thread each, never jax): ``dp2`` (2 ranks on ``data``), ``tp2`` (2 on
``model``) and ``dp2xtp2`` (4).  They are spawned once for the module and
run every leg while this process runs the JAX package's form of each leg on
the suite's virtual 8-device mesh (``make_mesh(dp=2, tp=2,
devices=jax.devices()[:4])``; a GSPMD program's values do not depend on
its mesh).  Both sides take the same weights and batches (the JAX package's
inits, bridged by ``params_from_jax`` / ``prompt_state_from_jax``).  The
legs are the eight of ``__graft_entry__.dryrun_multichip`` on these two
axes, each two steps, plus idiomatic prompt tuning (the causal text tower
under tp: the plain projections around B6) and prompt tuning under
``attn_impl="pallas"`` (K3's aux through the head-sum all-reduce and the
flash chain's plain backward on the rank's heads; JAX runs its Pallas
kernels in interpret mode):

* prompt-tune (pixels in, ref_compat: K2 / K1 partial modes, the K3 aux
  through the head-sum all-reduce), anchored kg + scl + ProGrad (cached
  features, the global-gradient projection), MaPLe, the flagship geometry
  (ViT-B/16 widths, 2 layers, 224 px): losses, grad norms and the trained
  leaves at ``TRAJ_TOL`` (rtol 1e-4, atol 5e-6, ``test_torch_train.py``'s);
* InfoNCE (global-batch negatives), InfoNCE with ``--grad-clip``'s chain
  (the clip's norm over the whole tree), SigLIP (the ring), GradCache
  (K = 2, negatives over K·B·dp), VPT (locked image tower): losses at
  ``TRAJ_TOL``, the gathered tree as ``test_torch_pretrain.py`` holds
  trees (every entry within 2 lr a step, at most one in a thousand outside
  ``TRAJ_TOL``).

The batch masks one row of the prompt legs, so the ranks' shares of the
global count differ.  The file also holds the specs against JAX's for every
leaf, the per-head cut's round trip, the collectives' gradients, the global
losses against the local loss on the gathered batch, the ranks' trees bit
for bit over ``data``, the kernels' plain partial modes, and ``serve`` /
``featurize`` / ``predict`` over two replicas.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import parallel_ranks as R
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.config import VIT_B_16 as J_VIT_B_16
from tapclip_tpu.config import PromptConfig as JPromptConfig
from tapclip_tpu.config import TrainConfig as JTrainConfig
from tapclip_tpu.data.tokenizer import get_tokenizer as j_tokenizer
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models.model_wrapper import init_trainable as j_init_trainable
from tapclip_tpu.models.prompt_learner import PromptLearner as JPromptLearner
from tapclip_tpu.parallel import mesh as jmesh
from tapclip_tpu.parallel import sharding as jshard
from tapclip_tpu.parallel import train_step as jts

from tapclip_tpu_torch import NotPortedError
from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import pretrain as tpre
from tapclip_tpu_torch.parallel import mesh as tmesh
from tapclip_tpu_torch.parallel import sharding as tshard
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

torch.set_num_threads(1)

TRAJ_TOL = dict(rtol=1e-4, atol=5e-6)
GROUPS = {"dp2": (2, 1), "tp2": (1, 2), "dp2xtp2": (2, 2)}
PROMPT_LEGS = ("prompt", "idiomatic", "anchored", "maple", "flagship", "pallas")
PRETRAIN_LEGS = ("infonce", "clip", "siglip", "gradcache", "vpt")
B, STEPS = 8, 2
CLASSES = R.CLASSES


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _prompt_entry(cfg, pcfg, params, key_trainable, x, rng):
    learner = JPromptLearner(CLASSES, params, cfg, pcfg, j_tokenizer(context_length=cfg.context_length))
    trainable = j_init_trainable(jax.random.PRNGKey(key_trainable), learner, pcfg)
    bank = learner.bank
    mask = np.ones(len(x), bool)
    mask[1] = False  # rank 0 of dp2 holds one masked row: the ranks' shares differ
    return {"cfg": _fields(cfg), "tree": _np_tree(params), "trainable": _np_tree(trainable),
            "bank": {k: np.asarray(getattr(bank, k)) for k in ("ctx", "token_embs", "class_mask", "eot_pos")},
            "x": x, "labels": rng.integers(0, len(CLASSES), len(x)).astype(np.int32), "mask": mask}


def _pretrain_entry(cfg, params, n, rng, siglip=False):
    from tapclip_tpu.pretrain import add_siglip_params

    if siglip:
        params = add_siglip_params(params)
    ids = rng.integers(1, cfg.vocab_size - 2, (n, cfg.context_length)).astype(np.int32)
    ids[:, 0] = cfg.vocab_size - 2
    ids[np.arange(n), rng.integers(3, cfg.context_length, n)] = cfg.vocab_size - 1
    return {"cfg": _fields(cfg), "tree": _np_tree(params),
            "x": rng.integers(0, 256, (n, cfg.image_size, cfg.image_size, 3)).astype(np.uint8), "ids": ids}


def _inputs():
    rng = np.random.default_rng(0)
    pcfg = JPromptConfig(max_classes=8)
    pix = lambda cfg, n=B: rng.standard_normal((n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)  # noqa
    flag = J_VIT_B_16.replace(vision_layers=2, text_layers=2, dtype="float32")
    tiny = jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY)  # one tree for every TINY leg
    vpt = J_TINY.replace(vpt_tokens=4)
    inp = {
        "legs": ("collectives", "roundtrip", "global_losses", "peft_distill", "grads", "multihost") + PROMPT_LEGS
        + PRETRAIN_LEGS,
        "losses": {"img": rng.standard_normal((8, 16)).astype(np.float32),
                   "txt": rng.standard_normal((8, 16)).astype(np.float32),
                   "scale": np.float32(2.3), "bias": np.float32(-3.0)},
        "prompt": _prompt_entry(J_TINY, pcfg, tiny, 1, pix(J_TINY), rng),
        "idiomatic": _prompt_entry(J_TINY, JPromptConfig(max_classes=8, text_mode="idiomatic"), tiny, 1,
                                   pix(J_TINY), rng),
        "anchored": _prompt_entry(J_TINY, pcfg, tiny, 1, rng.standard_normal((B, J_TINY.embed_dim)).astype(np.float32),
                                  rng),
        "maple": _prompt_entry(J_TINY, JPromptConfig(max_classes=8, maple_depth=2, prompt_len=2), tiny, 11,
                               pix(J_TINY), rng),
        "maple_wd": 1e-4,  # optax.adamw's default, as the dryrun's MaPLe leg
        "flagship": _prompt_entry(flag, pcfg, jclip.init_clip_params(jax.random.PRNGKey(3), flag), 4, pix(flag),
                                  rng),
        "pallas": _prompt_entry(J_TINY.replace(attn_impl="pallas"), pcfg, tiny, 1, pix(J_TINY), rng),
        "infonce": _pretrain_entry(J_TINY, tiny, B, rng),
        "siglip": _pretrain_entry(J_TINY, tiny, B, rng, siglip=True),
        "gradcache": _pretrain_entry(J_TINY, tiny, 2 * B, rng),
        "vpt": _pretrain_entry(vpt, jclip.init_clip_params(jax.random.PRNGKey(10), vpt), B, rng),
    }
    # The anchor: the zero-shot features of another context draw.  (At the
    # trained context's own features, as the dryrun builds it, KL's gradient
    # is float noise of about 1e-5 whose square sits at ProGrad's relative
    # guard, 1e-12 |g_d|^2, so whether the projection fires depends on
    # summation order alone.)
    # (Both sides take this one array; the port's plain text pass computes it.)
    from tapclip_tpu_torch.models.model_wrapper import text_features_with_attribution
    from tapclip_tpu_torch.utils.jax_bridge import prompt_state_from_jax

    a = inp["anchored"]
    trainable, bank = prompt_state_from_jax(a["trainable"], _bank(a))
    other = torch.from_numpy(np.random.default_rng(7).standard_normal(tuple(bank.ctx.shape)).astype(np.float32))
    with torch.no_grad():
        a["kg_feats"] = text_features_with_attribution(
            params_from_jax(a["tree"], tcfg.TINY_TEST), other * 0.02, bank, tcfg.TINY_TEST, tcfg.PromptConfig(max_classes=8),
            trainable["adjustor"])[0].numpy()
    a["anchor_scale"] = float(a["trainable"]["logit_scale"])
    return inp


def _bank(e):
    from tapclip_tpu.models.prompt_learner import PromptBank

    return PromptBank(**{k: jnp.asarray(v) for k, v in e["bank"].items()})


def _jax_prompt(e, pcfg, mesh, keys=("ctx",), feats=False, lr=1e-2, wd=0.01, **extra):
    cfg = J_TINY.__class__(**e["cfg"])
    if extra.get("kg_feats") is not None:
        extra["kg_feats"] = jnp.asarray(extra["kg_feats"])
    with mesh:
        params = jshard.shard_params(jax.tree.map(jnp.asarray, e["tree"]), mesh)
        bank = jshard.replicate(_bank(e), mesh)
        x, labels, mask = jshard.shard_batch((jnp.asarray(e["x"]), jnp.asarray(e["labels"]),
                                              jnp.asarray(e["mask"])), mesh)
        trainable = jax.tree.map(jnp.asarray, e["trainable"])
        out = {"loss": [], "grad_norm": []}
        if keys == ("ctx",):
            opt = jts.make_optimizer(JTrainConfig(lr=lr, weight_decay=wd))
            state = jshard.replicate(jts.init_train_state(trainable, opt), mesh)
            step = jts.make_train_step(cfg, pcfg, opt, use_image_feats=feats, **extra)
            for _ in range(STEPS):
                state, m = step(params, state, bank, x, labels, mask)
                state = jshard.replicate(state, mesh)  # the first step's placement: no recompile
                out["loss"].append(float(m["loss"]))
                out["grad_norm"].append(float(m["grad_norm"]))
            out["metrics"] = {k: float(v) for k, v in m.items()}
            out["params"] = {"ctx": np.asarray(state.params["ctx"])}
            return out
        from tapclip_tpu.maple import make_maple_train_step

        opt = optax.adamw(lr, weight_decay=wd)
        opt_state = jshard.replicate(opt.init({k: trainable[k] for k in keys}), mesh)
        trainable = jshard.replicate(trainable, mesh)
        step = make_maple_train_step(cfg, pcfg, opt)
        del out["grad_norm"]  # the JAX MaPLe step returns its loss alone
        for _ in range(STEPS):
            trainable, opt_state, loss = step(params, trainable, opt_state, bank, x, labels, mask)
            trainable, opt_state = jshard.replicate(trainable, mesh), jshard.replicate(opt_state, mesh)
            out["loss"].append(float(loss))
        out["params"] = {k: _np_tree(trainable[k]) for k in keys}
        return out


def _jax_pretrain(e, mesh, loss="infonce", k=1, lock_image=False, grad_clip=0.0):
    from tapclip_tpu import pretrain as jpre

    cfg = J_TINY.__class__(**e["cfg"])
    opt = optax.adamw(R.LR_PRE, weight_decay=R.WD_PRE)
    if grad_clip > 0:  # pretrain_cli's chain
        opt = optax.chain(optax.clip_by_global_norm(grad_clip), opt)
    if lock_image:
        opt = jpre.lock_tower_optimizer(opt, lock_image=True)
    with mesh:
        params = jax.tree.map(jnp.asarray, e["tree"])
        state = jshard.replicate(opt.init(params), mesh)
        params = jshard.shard_params(params, mesh)
        if k > 1:
            step = jpre.make_accum_pretrain_step(cfg, opt, k, loss=loss, mesh=mesh)
        else:
            step = jpre.make_pretrain_step(cfg, opt, loss=loss, mesh=mesh, lock_image=lock_image)
        batch = jshard.shard_batch((jnp.asarray(e["x"]), jnp.asarray(e["ids"])), mesh)
        losses = []
        for _ in range(STEPS):
            params, state, m = step(params, state, *batch)
            # back to the first step's placement: the second step reuses its executable
            params, state = jshard.shard_params(params, mesh), jshard.replicate(state, mesh)
            losses.append(float(m["loss"]))
    return {"loss": losses, "tree": dict(tpre.named_leaves(params_from_jax(_np_tree(params),
                                                                              tcfg.CLIPConfig(**e["cfg"]))))}


def _jax_legs(inp):
    mesh = jmesh.make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    pcfg = JPromptConfig(max_classes=8)
    a = inp["anchored"]
    return {
        "prompt": _jax_prompt(inp["prompt"], pcfg, mesh),
        "idiomatic": _jax_prompt(inp["idiomatic"], JPromptConfig(max_classes=8, text_mode="idiomatic"), mesh),
        "anchored": _jax_prompt(a, pcfg, mesh, feats=True, kg_lambda=0.5, kg_feats=a["kg_feats"],
                                prograd_lambda=1.0, anchor_scale=a["anchor_scale"], scl_lambda=0.5),
        "maple": _jax_prompt(inp["maple"], JPromptConfig(max_classes=8, maple_depth=2, prompt_len=2), mesh,
                             keys=("ctx", "maple"), wd=inp["maple_wd"]),
        "flagship": _jax_prompt(inp["flagship"], pcfg, mesh),
        "pallas": _jax_prompt(inp["pallas"], pcfg, mesh),
        "infonce": _jax_pretrain(inp["infonce"], mesh),
        "clip": _jax_pretrain(inp["infonce"], mesh, grad_clip=R.GRAD_CLIP),
        "siglip": _jax_pretrain(inp["siglip"], mesh, loss="siglip"),
        "gradcache": _jax_pretrain(inp["gradcache"], mesh, k=2),
        "vpt": _jax_pretrain(inp["vpt"], mesh, lock_image=True),
    }


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """Every leg: ``(inputs, jax results, {group: [rank results]})``.  The
    port's groups run while JAX computes; each join has a timeout."""
    d = tmp_path_factory.mktemp("parallel")
    cli = _CliRuns(d / "cli")  # independent of the legs: the runs go on beside them
    procs = {}
    try:
        inp = _inputs()
        path = str(d / "inputs.pt")
        torch.save(inp, path)
        procs = {g: R.spawn(dp, tp, path, str(d / g)) for g, (dp, tp) in GROUPS.items()}
        want = _jax_legs(inp)
        got = {g: R.wait(p, str(d / g)) for g, p in procs.items()}
        got["cli"] = cli.join()
    finally:
        cli.stop()
        for p in (q for ps in procs.values() for q in ps):
            if p.poll() is None:
                p.kill()
    return inp, want, got


class _CliRuns:
    """``pretrain_cli --preset tiny`` on the CPU, one after another in a
    thread: one process, then ``torchrun --nproc-per-node 2`` (gloo) with
    ``--dp 2``, with ``--dp 1 --tp 2`` and a snapshot, and that run resumed
    for a second epoch under ``--tp 2``.  Each run has a timeout."""

    ARGS = ["-m", "tapclip_tpu_torch.pretrain_cli", "--preset", "tiny", "--synthetic-data", "--device", "cpu",
            "--batch-size", "8", "--lr", "1e-4"]

    def __init__(self, root):
        import threading

        self.root, self.out, self.procs = root, {}, []
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _cmd(self, name, mesh, *extra):
        launcher = ([] if mesh is None else ["-m", "torch.distributed.run", "--nproc-per-node", "2",
                                             "--master-port", str(R.free_port())])
        return [sys.executable, *launcher, *self.ARGS, *(mesh or []), "--output-root", str(self.root / name), *extra]

    def _run(self):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([R.ROOT, os.environ.get("PYTHONPATH", "")]),
                   OMP_NUM_THREADS="1")
        runs = [("one", None, "--epochs", "1"), ("dp2", ["--dp", "2"], "--epochs", "1"),
                ("tp2", ["--dp", "1", "--tp", "2"], "--epochs", "1", "--save-every", "1"),
                ("resumed", ["--dp", "1", "--tp", "2"], "--epochs", "2")]
        for name, mesh, *extra in runs:
            if name == "resumed":
                model_dir = self._model_dir("tp2")
                snap = [f for f in sorted(os.listdir(model_dir)) if f.startswith("pretrain_snapshot")][-1]
                extra += ["--resume", os.path.join(model_dir, snap)]
            p = subprocess.Popen(self._cmd(name, mesh, *extra), env=env, cwd=R.ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            self.procs.append(p)
            try:
                log = p.communicate(timeout=180)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                log = "timeout"
            self.out[name] = (p.returncode, log)
            if p.returncode != 0:
                return

    def _model_dir(self, name):
        (run,) = os.listdir(self.root / name)
        return os.path.join(self.root, name, run, "models")

    def join(self):
        self.thread.join(timeout=600)
        return {name: (rc, log, self._model_dir(name) if rc == 0 else None) for name, (rc, log) in self.out.items()}

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()


def _assert_tree(got: dict, want: dict, tol=TRAJ_TOL, lr=R.LR_PRE, steps=STEPS, share=1000):
    """``test_torch_pretrain.py``'s rule: every entry within 2 lr a step, at
    most one in ``share`` of a leaf's entries (at least two) outside ``tol``
    (AdamW moves a rounding-noise gradient entry by up to lr; the key third
    of ``attn/b_qkv`` always)."""
    assert sorted(got) == sorted(want)
    for path in sorted(want):
        g, w = np.asarray(got[path]).reshape(-1), np.asarray(want[path]).reshape(-1)
        diff = np.abs(g - w)
        assert diff.max(initial=0.0) <= 2 * lr * steps, (path, diff.max())
        if path.endswith("attn/b_qkv"):
            W = g.shape[0] // 3
            g, w, diff = (np.delete(a, np.s_[W:2 * W]) for a in (g, w, diff))
        outside = int((diff > tol["atol"] + tol["rtol"] * np.abs(w)).sum())
        assert outside <= max(2, g.size // share), (path, outside, g.size, diff.max(initial=0.0))


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("leg", PROMPT_LEGS)
def test_prompt_legs_match_jax_mesh(legs, leg, group):
    _, want, got = legs
    for rank in got[group]:
        out = rank[leg]
        np.testing.assert_allclose(out["loss"], want[leg]["loss"], **TRAJ_TOL)
        if "grad_norm" in want[leg]:
            np.testing.assert_allclose(out["grad_norm"], want[leg]["grad_norm"], **TRAJ_TOL)
        for k, v in want[leg]["params"].items():
            g = out["params"][k]
            _assert_tree(g if isinstance(v, dict) else {k: g}, v if isinstance(v, dict) else {k: v}, lr=R.LR_PROMPT)
    if leg == "anchored":
        for name in ("loss_kg", "loss_scl", "loss_prograd_kl", "prograd_conflict"):
            np.testing.assert_allclose(got[group][0][leg]["metrics"][-1][name], want[leg]["metrics"][name],
                                       err_msg=name, **TRAJ_TOL)


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("leg", PRETRAIN_LEGS)
def test_pretrain_legs_match_jax_mesh(legs, leg, group):
    _, want, got = legs
    for rank in got[group]:
        np.testing.assert_allclose(rank[leg]["loss"], want[leg]["loss"], **TRAJ_TOL)
        _assert_tree(rank[leg]["tree"], want[leg]["tree"])


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_ranks_stay_equal_over_data(legs, group):
    """The ranks of one ``model`` cell, over ``data``, hold their local
    trees bit for bit equal after the steps (the summed gradients are the
    same on every rank)."""
    _, _, got = legs
    dp, tp = GROUPS[group]
    for leg in PRETRAIN_LEGS:
        for j in range(tp):
            cell = [got[group][i * tp + j][leg]["local"] for i in range(dp)]
            for other in cell[1:]:
                for path in cell[0]:
                    np.testing.assert_array_equal(other[path], cell[0][path], err_msg=f"{leg} {path}")
    for leg in PROMPT_LEGS:
        ranks = [r[leg]["params"]["ctx"] for r in got[group]]
        for other in ranks[1:]:
            np.testing.assert_array_equal(other, ranks[0])


def test_collectives_gradients(legs):
    """The autograd all-gather (backward: all-reduce, own slice) and the ring
    shift (backward: the reverse shift) over two ranks, against their
    definitions."""
    _, _, got = legs
    w = np.linspace(-1.0, 1.0, 12, dtype=np.float32).reshape(6, 2)
    xs = [np.arange(6, dtype=np.float32).reshape(3, 2) + 10.0 * r for r in range(2)]
    for r, out in enumerate(got["dp2"]):
        c = out["collectives"]
        np.testing.assert_array_equal(c["gathered"], np.concatenate(xs))
        # d/dx_r of sum_s (s + 1) <gathered, w> = 3 w[rows of r]
        np.testing.assert_allclose(c["dx"], 3.0 * w[3 * r:3 * r + 3], rtol=1e-6)
        np.testing.assert_array_equal(c["shifted"], xs[(r - 1) % 2])
        # x_r reaches rank r + 1, whose term is weighted r + 2
        np.testing.assert_array_equal(c["dy"], np.full((3, 2), float((r + 1) % 2 + 1)))
    for out in got["tp2"]:  # a one-rank data axis: identities
        c = out["collectives"]
        np.testing.assert_array_equal(c["gathered"], xs[0])
        np.testing.assert_array_equal(c["shifted"], xs[0])


@pytest.mark.parametrize("group", ["tp2", "dp2xtp2"])
def test_shard_gather_round_trip_with_the_per_head_cut(legs, group):
    """``gather_params(shard_params(tree))`` is the tree bit for bit, and a
    rank's ``attn/w_qkv`` holds the q, k and v columns of its own heads."""
    inp, _, got = legs
    tp = GROUPS[group][1]
    w = inp["infonce"]["tree"]["visual"]["blocks"]
    whole = {k: np.asarray(w[sub][k][0]) for sub in ("attn", "mlp") for k in w[sub]}
    for r, out in enumerate(got[group]):
        assert out["roundtrip"]["equal"]
        j = r % tp
        blk = out["roundtrip"]["block0"]
        Wd = whole["w_out"].shape[0]
        c = Wd // tp
        want_qkv = np.concatenate([whole["w_qkv"][:, s * Wd + j * c:s * Wd + (j + 1) * c] for s in range(3)], axis=1)
        np.testing.assert_array_equal(blk["attn/w_qkv"], want_qkv)
        np.testing.assert_array_equal(blk["attn/w_out"], whole["w_out"][j * c:(j + 1) * c])
        h = whole["w_fc"].shape[1] // tp
        np.testing.assert_array_equal(blk["mlp/w_fc"], whole["w_fc"][:, j * h:(j + 1) * h])
        np.testing.assert_array_equal(blk["mlp/w_proj"], whole["w_proj"][j * h:(j + 1) * h])
        np.testing.assert_array_equal(blk["attn/b_out"], whole["b_out"])  # replicated


@pytest.mark.parametrize("loss", ["infonce", "siglip"])
def test_global_losses_equal_the_local_loss_on_the_gathered_batch(legs, loss):
    """The shares over two ranks sum to the local loss on the whole batch,
    and each rank's gradients (the all-gather's, or the ring's, backward
    carrying the other rank's part) are the whole batch's in its rows; the
    scale's and bias's sum over the ranks (as ``tests/test_siglip.py`` holds
    the JAX forms), at 1e-5."""
    inp, _, got = legs
    e = inp["losses"]
    img, txt = (torch.from_numpy(e[k]).requires_grad_(True) for k in ("img", "txt"))
    scale, bias = (torch.tensor(e[k]).requires_grad_(True) for k in ("scale", "bias"))
    want = tpre.pair_loss(loss, {"logit_scale": scale, "logit_bias": bias}, img, txt)
    wg = torch.autograd.grad(want, [img, txt, scale, bias], allow_unused=True)
    ranks = [out["global_losses"][loss] for out in got["dp2"]]
    np.testing.assert_allclose(sum(r["share"] for r in ranks), want.item(), rtol=1e-5)
    for k in range(2):  # image and text rows
        np.testing.assert_allclose(np.concatenate([r["grads"][k] for r in ranks]), wg[k].numpy(),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sum(r["grads"][2] for r in ranks), wg[2].numpy(), rtol=1e-5)
    if loss == "siglip":
        np.testing.assert_allclose(sum(r["grads"][3] for r in ranks), wg[3].numpy(), rtol=1e-5)
    one = got["tp2"][0]["global_losses"][loss]  # a one-rank data axis: the local loss itself
    np.testing.assert_allclose(one["share"], want.item(), rtol=1e-6)


def _meta_tree(jshapes):
    """The port's tree of ``meta`` tensors for a JAX ``eval_shape`` tree (a
    stacked block leaf ``[L, ...]`` becomes L leaves ``[...]``)."""
    def tree(n):
        return {k: tree(v) for k, v in n.items()} if isinstance(n, dict) else torch.empty(n.shape, device="meta")

    out = {}
    for k, v in jshapes.items():
        if isinstance(v, dict) and "blocks" in v:
            n = jax.tree.leaves(v["blocks"])[0].shape[0]
            blocks = [jax.tree.map(lambda a: torch.empty(a.shape[1:], device="meta"), v["blocks"]) for _ in range(n)]
            out[k] = {**tree({kk: vv for kk, vv in v.items() if kk != "blocks"}), "blocks": blocks}
        else:
            out[k] = tree(v)
    return out


@pytest.mark.parametrize("tp,pp,fsdp", [(a, b, c) for a in (False, True) for b in (False, True)
                                        for c in (False, True)])
def test_clip_param_specs_equal_jax(tp, pp, fsdp):
    """Every leaf's spec of the TINY, TINY-MoE (2 and 4 experts) and
    ViT-B/16 trees equals the JAX package's ``PartitionSpec`` for its
    stacked leaf, under each of (tp, pp, fsdp), and the shard
    ``shard_leaf`` cuts has the shape of JAX's shard of it (the expert banks
    their ``E / tp`` experts and, under FSDP, ``1/dp`` of dimension 1; a
    block leaf without the layer axis)."""
    shape = {"data": 2, **({"pipe": 2} if pp else {}), "model": 2 if tp else 1}
    jm = jmesh.make_mesh(dp=2, tp=shape["model"], pp=shape.get("pipe", 1),
                         devices=jax.devices()[:2 * shape["model"] * shape.get("pipe", 1)])
    tm = tmesh.Mesh(shape=shape, grid=np.zeros((1, 1)))
    for cfg in (J_TINY, J_TINY.replace(moe_experts=2), J_TINY.replace(moe_experts=4), J_VIT_B_16):
        jshapes = jax.eval_shape(lambda c=cfg: jclip.init_clip_params(jax.random.PRNGKey(0), c))
        want, sizes = {}, {}
        jax.tree_util.tree_map_with_path(
            lambda path, s: want.__setitem__(jshard._path_str(path), tuple(s)),
            jshard.clip_param_specs(jshapes, jm, fsdp=fsdp), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        jax.tree_util.tree_map_with_path(lambda path, s: sizes.__setitem__(jshard._path_str(path), s.shape), jshapes)
        meta = _meta_tree(jshapes)
        got = tshard.clip_param_specs(meta, tm, fsdp=fsdp)
        assert {tshard.stacked_path(p) for p in got} == set(want)
        leaves = dict(tpre.named_leaves(meta))
        for path, spec in got.items():
            stacked = tshard.stacked_path(path)
            assert spec == want[stacked], (cfg.name, path)
            shard = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec(*spec)).shard_shape(sizes[stacked])
            local = tshard.shard_leaf(path, leaves[path], spec, shape["model"], 0, 2 if fsdp else 1, 0)
            assert tuple(local.shape) == tuple(shard[1:] if stacked != path else shard), (cfg.name, path)


def test_partial_modes_sum_to_the_whole_block():
    """K1's, K2's, B5's and B4's plain partial modes in one process with no
    group: two halves' partials (hidden columns / heads, the per-head cut),
    summed and given the residual and bias, are the whole block at 1e-5 (f32
    summation order); the backward halves' dy sum to the whole dy, and the
    LayerNorm backward on it gives the whole block's dx, dgamma and dbeta."""
    from tapclip_tpu_torch.ops import fused_mha as A
    from tapclip_tpu_torch.ops import fused_mlp as M

    g = torch.Generator().manual_seed(0)
    r = lambda *s, sc=1.0: torch.randn(*s, generator=g) * sc  # noqa: E731
    B, T, W, H, heads = 2, 13, 32, 128, 4
    x, dy = r(B, T, W), r(B, T, W, sc=0.1)
    gm, bt = 1 + r(W, sc=0.1), r(W, sc=0.1)
    wf, bf, wp, bp = r(W, H, sc=W ** -0.5), r(H, sc=0.1), r(H, W, sc=H ** -0.5), r(W, sc=0.1)
    cols = [slice(0, H // 2), slice(H // 2, H)]
    parts = [M.fused_mlp_partial_reference(x, gm, bt, wf[:, c], bf[c], wp[c]) for c in cols]
    torch.testing.assert_close(x + (parts[0] + parts[1] + bp), M.fused_mlp_reference(x, gm, bt, wf, bf, wp, bp),
                               rtol=1e-5, atol=1e-5)
    whole = M.fused_mlp_bwd_reference(x, dy, gm, bt, wf, bf, wp)
    fronts = [M.fused_mlp_bwd_partial_reference(x, dy, gm, bt, wf[:, c], bf[c], wp[c]) for c in cols]
    _, n, rstd, *_ = fronts[0]
    got = M.ln_bwd_reference(x, dy, fronts[0][0] + fronts[1][0], n, rstd, gm)
    for a, b in zip(got, whole[:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([f[3] for f in fronts], 1), whole[3], rtol=1e-5, atol=1e-5)  # dw_fc
    wq, bq, wo, bo = r(W, 3 * W, sc=W ** -0.5), r(3 * W, sc=0.1), r(W, W, sc=W ** -0.5), r(W, sc=0.1)
    halves = [(tshard._qkv_parts(wq, 2, j), tshard._qkv_parts(bq, 2, j), wo[j * W // 2:(j + 1) * W // 2])
              for j in range(2)]
    parts = [A.attn_block_partial_reference(x, gm, bt, *h, heads // 2, 11, 1e-5) for h in halves]
    torch.testing.assert_close(x + (parts[0] + parts[1] + bo),
                               A.attn_block_reference(x, gm, bt, wq, bq, wo, bo, heads, 11, 1e-5),
                               rtol=1e-5, atol=1e-5)
    whole = A.attn_block_bwd_reference(x, dy, gm, bt, wq, bq, wo, heads, 11, 1e-5)
    fronts = [A.attn_block_bwd_partial_reference(x, dy, gm, bt, *h, heads // 2, 11, 1e-5) for h in halves]
    got = M.ln_bwd_reference(x, dy, fronts[0][0] + fronts[1][0], fronts[0][1], fronts[0][2], gm)
    for a, b in zip(got, whole[:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_predict_service_dp_matches_one_device_and_jax():
    """``PredictService(mesh=)`` over ``["cpu", "cpu"]``: each batch of 4
    splits in two; the served probabilities equal one device's (1e-6: the
    halves' CPU products) and the JAX service's over its ``--dp 2`` mesh."""
    from tapclip_tpu.models.model_wrapper import FullModel as JFullModel
    from tapclip_tpu.serve import PredictService as JPredictService

    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.serve import PredictService
    from tapclip_tpu_torch.utils.jax_bridge import prompt_state_from_jax

    jp = jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY)
    jm = JFullModel(CLASSES, jp, J_TINY, rng=jax.random.PRNGKey(3))
    tm = FullModel(CLASSES, params_from_jax(_np_tree(jp), tcfg.TINY_TEST), tcfg.TINY_TEST)
    tm.trainable, tm.prompt_learner.bank = prompt_state_from_jax(_np_tree(jm.trainable),
                                                                 _np_tree(jm.prompt_learner.bank))
    x = np.random.default_rng(4).integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)

    def served(svc):
        try:
            return np.stack([[svc.predict(img)["probs"][c] for c in CLASSES] for img in x])
        finally:
            svc.close()

    dp2 = served(PredictService(tm, batch_size=4, max_latency_ms=1.0, mesh=tmesh.make_mesh(2, devices=["cpu"] * 2)))
    one = served(PredictService(tm, batch_size=4, max_latency_ms=1.0))
    jax2 = served(JPredictService(jm, batch_size=4, max_latency_ms=1.0,
                                  mesh=jmesh.make_mesh(dp=2, tp=1, devices=jax.devices()[:2])))
    np.testing.assert_allclose(dp2, one, atol=1e-6, rtol=0)
    np.testing.assert_allclose(dp2, jax2, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="must be divisible by the mesh's data axis"):
        PredictService(tm, batch_size=3, mesh=tmesh.make_mesh(2, devices=["cpu"] * 2))


@pytest.mark.parametrize("run", ["dp2", "tp2"])
def test_pretrain_cli_under_torchrun_equals_one_process(legs, run):
    """``torchrun --nproc-per-node 2 -m tapclip_tpu_torch.pretrain_cli
    --preset tiny`` over gloo, ``--dp 2`` and ``--dp 1 --tp 2``: one epoch
    of the same batches as the one-process run (each rank its rows or its
    shards); the loss at TRAJ_TOL, and rank 0's whole tree, in the
    one-process layout, held as ``test_torch_pretrain.py`` holds trees."""
    from tapclip_tpu_torch.utils import checkpoint as ckpt_io

    cli = legs[2]["cli"]
    for name in ("one", run):
        assert cli[name][0] == 0, cli[name][1][-3000:]
    shape = {"dp2": "{'data': 2, 'model': 1}", "tp2": "{'data': 1, 'model': 2}"}[run]
    assert f"mesh: {shape} over 2 ranks (backend gloo)" in cli[run][1]

    def loss(log):
        return [float(line.rsplit(":", 1)[1]) for line in log.splitlines() if "contrastive loss:" in line]

    np.testing.assert_allclose(loss(cli[run][1]), loss(cli["one"][1]), **TRAJ_TOL)
    trees = [ckpt_io.load_clip_tree(os.path.join(cli[n][2], "clip_pretrained.pt"), tcfg.TINY_TEST)
             for n in ("one", run)]
    steps = 120 // 8  # the synthetic tree's 120 images in batches of 8
    _assert_tree(dict(tpre.named_leaves(trees[1])), dict(tpre.named_leaves(trees[0])), steps=steps)


def test_pretrain_cli_resumes_a_whole_snapshot_under_tp(legs):
    """``--resume`` of the tp = 2 run's snapshot (saved whole, gathered over
    ``model``) under ``--tp 2``: it loads, shards the tree and the moments,
    and trains the second epoch."""
    cli = legs[2]["cli"]
    rc, log, model_dir = cli["resumed"]
    assert rc == 0, log[-3000:]
    assert "resumed from" in log and "[Epoch 2] contrastive loss" in log and "[Epoch 1]" not in log
    assert os.path.isfile(os.path.join(model_dir, "clip_pretrained.pt"))


@pytest.mark.parametrize("argv,match", [
    (["--moe-experts", "2", "--pp", "2"], "pipeline parallelism over MoE towers is not supported"),
    (["--distill-teacher", "teacher.bin", "--moe-experts", "2"], "--distill-teacher with MoE students is not wired"),
    (["--fsdp", "--lora-rank", "2"], "--fsdp does not apply to --lora-rank runs"),
    (["--fsdp", "--pp", "2"], "--fsdp does not compose with --pp"),
    (["--distill-teacher", "teacher.bin", "--pp", "2"], "--distill-teacher does not compose with --pp/--fsdp"),
    (["--distill-teacher", "teacher.bin", "--fsdp"], "--distill-teacher does not compose with --pp/--fsdp"),
    (["--lora-rank", "2", "--pp", "2"], "--lora-rank does not compose with --pp"),
    (["--accum-full-negatives", "2", "--accum-steps", "2"], "--accum-full-negatives composes with dp/tp meshes"),
    (["--accum-full-negatives", "2", "--pp", "2"], "--accum-full-negatives composes with dp/tp meshes"),
    (["--accum-full-negatives", "2", "--fsdp"], "--accum-full-negatives composes with dp/tp meshes"),
    (["--accum-full-negatives", "2", "--seq-parallel"], "--accum-full-negatives composes with dp/tp meshes"),
])
def test_pretrain_cli_refuses_the_next_slices_flags(argv, match, capsys):
    """What stays refused, by name: the JAX CLI's refusals of the parallel
    forms' combinations (``tapclip_tpu/pretrain_cli.py``), MoE towers on
    the pipe axis and distillation into an MoE student among them."""
    from tapclip_tpu_torch import pretrain_cli

    with pytest.raises((SystemExit, ValueError)) as err:
        pretrain_cli.main(["--preset", "tiny", "--device", "cpu", *argv])
    assert match in str(err.value) + capsys.readouterr().err


@pytest.mark.parametrize("argv,want", [
    (["--pp", "2", "--pp-microbatches", "8"], dict(pp=2, pp_microbatches=8)),
    (["--seq-parallel", "--tp", "2"], dict(seq_parallel=True, tp=2)),
    (["--fsdp", "--dp", "4"], dict(fsdp=True, dp=4)),
    ([], dict(pp=1, pp_microbatches=0, seq_parallel=False, fsdp=False, sharded_snapshot=False)),
    (["--sharded-snapshot"], dict(sharded_snapshot=True)),
    (["--moe-experts", "2", "--tp", "2"], dict(moe_experts=2, tp=2)),
])
def test_pretrain_cli_parses_the_lifted_flags(argv, want):
    """``--pp``, ``--pp-microbatches``, ``--seq-parallel``, ``--fsdp``,
    ``--sharded-snapshot`` and ``--moe-experts`` with ``--tp`` parse as the
    JAX CLI's (their runs: ``test_torch_pipeline.py``,
    ``test_torch_expert_parallel.py``, ``test_torch_sharded_snapshot.py``)."""
    from tapclip_tpu_torch import pretrain_cli

    args = pretrain_cli.build_parser().parse_args(argv)
    assert {k: getattr(args, k) for k in want} == want


def test_refusals_of_the_next_slice():
    """The specs cut the MoE banks under tp > 1 (a rank's experts; an
    expert count that tp does not divide refused by name), and a head or
    hidden count that tp does not divide, an FSDP cut that dp does not
    divide, the pipe and model axes over a device list, and a mesh larger
    than the world are refused, each by name."""
    tree = params_from_jax(_np_tree(jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY)), tcfg.TINY_TEST)
    three_data = tmesh.Mesh(shape={"data": 3, "model": 1}, grid=np.zeros((3, 1)))
    with pytest.raises(ValueError, match="not divisible by dp=3 [(]FSDP[)]"):
        tshard.shard_params(tree, three_data, fsdp=True)
    with pytest.raises(NotPortedError, match="the pipe axis over a device list"):
        tmesh.make_mesh(dp=1, pp=2, devices=["cpu", "cpu"])
    with pytest.raises(NotPortedError, match="tensor parallelism over a device list"):
        tmesh.make_mesh(dp=1, tp=2, devices=["cpu", "cpu"])
    two = tmesh.Mesh(shape={"data": 1, "model": 2}, grid=np.zeros((1, 2)))
    moe = params_from_jax(_np_tree(jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY.replace(moe_experts=2))),
                          tcfg.TINY_TEST.replace(moe_experts=2))
    banks = tshard.shard_params(moe, tmesh.Mesh(shape={"data": 1, "model": 2}, grid=np.arange(2).reshape(1, 2),
                                                model_index=1))
    for path, t in tpre.named_leaves(banks):
        whole = dict(tpre.named_leaves(moe))[path]
        if "/moe/" in path and not path.endswith("router/w"):
            assert torch.equal(t, whole[1:]), path  # model rank 1: expert 1 of 2
        elif path.endswith("router/w"):
            assert torch.equal(t, whole), path
    moe3 = params_from_jax(_np_tree(jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY.replace(moe_experts=3))),
                           tcfg.TINY_TEST.replace(moe_experts=3))
    with pytest.raises(ValueError, match="moe_experts 3 is not divisible by tp=2"):
        tshard.shard_params(moe3, two)
    three = tmesh.Mesh(shape={"data": 1, "model": 3}, grid=np.zeros((1, 3)))
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        tshard.shard_params(tree, three)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmesh.make_mesh(dp=2)  # no process group: one rank
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        tmesh.make_mesh(dp=1, tp=2, pp=2)


def test_mesh_grid_matches_jax():
    """The rank grid and axis names of the JAX package's ``make_mesh``
    (``reshape(dp, tp)``, ``model`` innermost), and its refusals."""
    jm = jmesh.make_mesh(dp=2, tp=4, devices=jax.devices())
    tm = tmesh.make_mesh(dp=2, devices=["cpu"] * 2)
    assert tuple(jm.axis_names) == tm.axis_names == ("data", "model")
    np.testing.assert_array_equal(np.vectorize(lambda d: d.id)(jm.devices), np.arange(8).reshape(2, 4))
    assert tm.shape == {"data": 2, "model": 1} and tm.in_process
    assert tmesh.single_device_mesh().shape == {"data": 1, "model": 1}
    for dp, tp, n in ((-1, 3, 8), (3, 3, 8)):
        with pytest.raises(ValueError) as je:
            jmesh.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:n])
        with pytest.raises(ValueError) as te:
            tmesh._sizes(n, dp, tp, 1)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("form", ["lora", "distill", "stochastic"])
def test_lora_and_distillation_over_data_equal_one_process(legs, form):
    """``peft.make_lora_pretrain_step(mesh=)``,
    ``distill.make_distill_step(mesh=)`` and the InfoNCE step with
    ``augment`` and patch dropout (the draws made for the global batch, each
    rank keeping its rows) over two ranks: each rank's loss is the whole
    batch's, and the trained leaves after two steps are the one-process
    steps' (losses at TRAJ_TOL, leaves within 2 lr a step)."""
    _, _, got = legs
    for rank in got["dp2"]:
        out = rank["peft_distill"][form]
        np.testing.assert_allclose(out["losses"], out["one_losses"], **TRAJ_TOL)
        assert out["max_diff"] <= 2 * R.LR_PRE * STEPS, out["max_diff"]


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_mesh_step_gradients_are_the_global_batchs(legs, group):
    """The gradients an InfoNCE and a SigLIP step hand the optimizer on each
    mesh (summed over ``data``, gathered over ``model``) are the whole
    batch's gradients, leaf by leaf at 1e-4 norm-relative (summation order;
    the key biases' rounding-noise gradients aside).  An average over
    ``data`` on top of the all-gather's backward would read 0.5."""
    _, _, got = legs
    for rank in got[group]:
        for loss, err in rank["grads"]["errs"].items():
            assert err <= 1e-4, (loss, err)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_clip_norm_is_the_whole_trees(legs, group):
    """The global norm the clip reads on each rank is the whole batch's
    gradients' norm over the whole tree, at 1e-5 relative: under ``tp`` the
    shards' squares summed over ``model`` and the replicated leaves'
    counted once (a rank's own leaves alone read 0.98 of it here)."""
    _, _, got = legs
    for rank in got[group]:
        for loss, (norm, whole) in rank["grads"]["norms"].items():
            np.testing.assert_allclose(norm, whole, rtol=1e-5, err_msg=loss)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_eval_step_counts_are_the_global_batchs(legs, group):
    """``make_eval_step(mesh=)``: each rank's counts summed over ``data`` are
    one process's counts on the whole (masked) batch."""
    _, _, got = legs
    for rank in got[group]:
        for name, (mesh_counts, one_counts) in rank["prompt"]["eval"].items():
            np.testing.assert_array_equal(mesh_counts, one_counts, err_msg=name)


def test_multihost_mesh_keeps_model_groups_inside_a_node(legs):
    """Four ranks, two a node (``LOCAL_WORLD_SIZE=2``), tp = 2: each node's
    two ranks form a ``model`` group, the data axis stacked node-major."""
    _, _, got = legs
    for r, rank in enumerate(got["dp2xtp2"]):
        m = rank["multihost"]
        assert m["grid"] == [[0, 1], [2, 3]] and m["shape"] == {"data": 2, "model": 2}
        assert tuple(m["place"]) == (r // 2, r % 2)
