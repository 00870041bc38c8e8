"""The port's ``pipe`` mesh axis (GPipe), sequence parallelism and FSDP/ZeRO
against the JAX package's forms, on the CPU.

One gloo world of 8 ranks is spawned once for the module
(``parallel_ranks.pipeline_legs``: one torch thread a rank, never jax).  Each
leg runs on the sub-mesh of its size (``make_mesh(dp, tp, pp)`` over the
first ``dp * pp * tp`` ranks; the others wait, as JAX takes
``devices[:k]``), while this process runs the JAX package's form of each leg
on the suite's 8 virtual devices.  Both sides take the same weights (the JAX
package's inits, bridged by ``params_from_jax``) and the same NumPy batches:

* ``pipeline_transformer_forward`` over pp = 2 with M = 2 and 4
  microbatches: the output and each stage's blocks' gradients against the
  JAX pipeline and the sequential tower (JAX's
  ``test_pipeline_forward_matches_sequential`` / ``_grads_match_sequential``);
* ``layers.transformer_forward(seq_parallel=True)`` over tp = 2 at T 197,
  which tp does not divide (padded to 198 inside, the pad keys masked), in
  both attention routes (K2 and, causal, the plain projections around B6):
  output and gradients against JAX's sequential tower;
* the InfoNCE pretraining step, two steps, in ten forms of the
  ``(data, pipe, model)`` mesh: dp 2, dp 2 x pp 2, tp 2 + SP (at TINY's T
  and at a 224-px tower's T 197), pp 2 x tp 2 + SP, dp 2 + FSDP, dp 2 x tp 2
  + FSDP, the two 3-axis legs of ``__graft_entry__.dryrun_multichip`` (dp 2
  x pp 2 x tp 2 with SP, with FSDP) and pp 2 under ``attn_impl="pallas"``:
  losses at ``TRAJ_TOL`` against the JAX package's same form and its dp-only
  step, the gathered trees as ``test_torch_parallel.py`` holds them, and the
  gradients themselves (captured on their way to the optimizer, gathered)
  against one process's gradients of the whole batch at 1e-4 norm-relative,
  where AdamW would hide a constant factor; the clip's global norm as each
  rank reads it against the whole batch's; each FSDP rank's leaves and AdamW
  moments cut to ``1/dp`` where the spec names ``data``;
* the 3-axis mesh's rank grid against JAX's, the refusals by name, and
  ``torchrun --nproc-per-node 4 -m tapclip_tpu_torch.pretrain_cli --pp 2
  --tp 2 --seq-parallel`` beside a one-process run.
"""

import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import parallel_ranks as R
from tapclip_tpu.config import TINY_TEST as J_TINY
from tapclip_tpu.models import clip as jclip
from tapclip_tpu.models import layers as jlayers
from tapclip_tpu.parallel import mesh as jmesh
from tapclip_tpu.parallel import pipeline as jpipe
from tapclip_tpu.parallel import sharding as jshard

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import pretrain as tpre
from tapclip_tpu_torch.parallel import mesh as tmesh
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

torch.set_num_threads(1)

TRAJ_TOL = dict(rtol=1e-4, atol=5e-6)
LAYER_TOL = dict(rtol=2e-5, atol=1e-5)  # tests/test_pipeline.py's, values
# Gradients: tests/test_pipeline.py's rtol, and an atol of 1e-6 of the leaf's largest entry: the
# port's sums and XLA's run in different orders (JAX's test compares two XLA programs), which moves
# an entry by up to about 3e-7 of the leaf's scale here.
GRAD_RTOL, GRAD_ATOL_OF_MAX = 2e-4, 1e-6
B, STEPS, MICRO = 8, 2, (2, 4)
FSDP_FORMS = ("dp2fsdp", "dp2tp2fsdp", "3axis_fsdp")


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _pretrain_entry(cfg, params, rng):
    ids = rng.integers(1, cfg.vocab_size - 2, (B, cfg.context_length)).astype(np.int32)
    ids[:, 0] = cfg.vocab_size - 2
    ids[np.arange(B), rng.integers(3, cfg.context_length, B)] = cfg.vocab_size - 1
    return {"cfg": _fields(cfg), "tree": _np_tree(params),
            "x": rng.integers(0, 256, (B, cfg.image_size, cfg.image_size, 3)).astype(np.uint8), "ids": ids}


def _blocks(seed, L, W):
    stacked = _np_tree(jlayers.init_blocks(jax.random.PRNGKey(seed), L, W))
    return stacked, [jax.tree.map(lambda a, i=i: a[i], stacked) for i in range(L)]


def _inputs():
    rng = np.random.default_rng(0)
    tiny = jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY)
    t197 = J_TINY.replace(image_size=224)  # 14 x 14 patches + the class token: T 197, padded to 200
    pipe_stacked, pipe_blocks = _blocks(3, 2, 64)
    seq_stacked, seq_blocks = _blocks(4, 2, 64)
    return {
        "pipe_layers": {"blocks": pipe_blocks, "stacked": pipe_stacked, "heads": 4, "micro": MICRO,
                        "x": rng.standard_normal((B, 8, 64)).astype(np.float32)},
        "seq_layers": {"blocks": seq_blocks, "stacked": seq_stacked, "heads": 4,
                       "x": rng.standard_normal((2, 197, 64)).astype(np.float32)},
        "infonce": _pretrain_entry(J_TINY, tiny, rng),
        "t197": _pretrain_entry(t197, jclip.init_clip_params(jax.random.PRNGKey(5), t197), rng),
    }


def _jax_layers(inp):
    """The JAX pipeline (pp = 2, each M) and sequential tower: values and
    block gradients of ``sum(y ** 2)``; the sequential tower at T 197."""
    e = inp["pipe_layers"]
    blocks, x = jax.tree.map(jnp.asarray, e["stacked"]), jnp.asarray(e["x"])
    mesh = jmesh.make_mesh(dp=1, tp=1, pp=2, devices=jax.devices()[:2])

    def seq(b):
        return jlayers.transformer_forward(x, b, e["heads"], act="gelu")[0]

    out = {"seq": np.asarray(jax.jit(seq)(blocks)),
           "seq_grads": _np_tree(jax.jit(jax.grad(lambda b: jnp.sum(seq(b) ** 2)))(blocks))}
    for M in e["micro"]:
        def pp(b, M=M):
            return jpipe.pipeline_transformer_forward(x, b, e["heads"], mesh=mesh, n_microbatches=M, act="gelu")[0]

        out[M] = {"y": np.asarray(jax.jit(pp)(blocks)),
                  "grads": _np_tree(jax.jit(jax.grad(lambda b: jnp.sum(pp(b) ** 2)))(blocks))}
    s = inp["seq_layers"]
    sx, sblocks = jnp.asarray(s["x"]), jax.tree.map(jnp.asarray, s["stacked"])
    for causal in (False, True):
        def tower(b, causal=causal):
            return jlayers.transformer_forward(sx, b, s["heads"], act="gelu", causal=causal)[0]

        out["t197", causal] = {"y": np.asarray(jax.jit(tower)(sblocks)),
                               "grads": _np_tree(jax.jit(jax.grad(lambda b: jnp.sum(tower(b) ** 2)))(sblocks))}
    return out


def _jax_form(e, dp, pp, tp, pp_microbatches=0, seq_parallel=False, fsdp=False, attn_impl=None):
    from tapclip_tpu import pretrain as jpre

    cfg = J_TINY.__class__(**e["cfg"])
    if attn_impl:
        cfg = cfg.replace(attn_impl=attn_impl)
    mesh = jmesh.make_mesh(dp=dp, tp=tp, pp=pp, devices=jax.devices()[:dp * pp * tp])
    opt = optax.adamw(R.LR_PRE, weight_decay=R.WD_PRE)

    def place(params, state):
        state = jshard.shard_opt_state(state, mesh, fsdp=True) if fsdp else jshard.replicate(state, mesh)
        return jshard.shard_params(params, mesh, fsdp=fsdp), state

    with mesh:
        params = jax.tree.map(jnp.asarray, e["tree"])
        params, state = place(params, opt.init(params))
        step = jpre.make_pretrain_step(cfg, opt, mesh=mesh, pp_microbatches=pp_microbatches,
                                       seq_parallel=seq_parallel, fsdp=fsdp)
        batch = jshard.shard_batch((jnp.asarray(e["x"]), jnp.asarray(e["ids"])), mesh)
        losses = []
        for _ in range(STEPS):
            params, state, m = step(params, state, *batch)
            params, state = place(params, state)  # the first step's placement: the second reuses its executable
            losses.append(float(m["loss"]))
    return {"loss": losses, "tree": dict(tpre.named_leaves(params_from_jax(_np_tree(params),
                                                                            tcfg.CLIPConfig(**e["cfg"]))))}


def _jax_forms(inp):
    out = {}
    for name, (dp, pp, tp, kw) in R.PIPE_FORMS.items():
        kw = dict(kw)
        out[name] = _jax_form(inp[kw.pop("key", "infonce")], dp, pp, tp, **kw)
    return out


class _Cli:
    """``pretrain_cli --preset tiny`` on the CPU in a thread: one process
    with ``--fsdp`` (ignored there), then ``torchrun --nproc-per-node 4``
    with ``--pp 2 --tp 2 --seq-parallel`` (gloo), each with a timeout."""

    ARGS = ["-m", "tapclip_tpu_torch.pretrain_cli", "--preset", "tiny", "--synthetic-data", "--device", "cpu",
            "--batch-size", "8", "--lr", "1e-4", "--epochs", "1"]

    def __init__(self, root):
        self.root, self.out, self.procs = root, {}, []
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([R.ROOT, os.environ.get("PYTHONPATH", "")]),
                   OMP_NUM_THREADS="1")
        runs = [("one", ["--fsdp"]), ("pp2tp2sp", ["-m", "torch.distributed.run", "--nproc-per-node", "4", "--master-port",
                                          str(R.free_port())])]
        for name, launcher in runs:
            if launcher == ["--fsdp"]:  # one process: --fsdp warns and is ignored, as in the JAX CLI
                launcher, mesh = [], ["--fsdp"]
            else:
                mesh = ["--pp", "2", "--tp", "2", "--seq-parallel"]
            p = subprocess.Popen([sys.executable, *launcher, *self.ARGS, *mesh, "--output-root", str(self.root / name)],
                                 env=env, cwd=R.ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            self.procs.append(p)
            try:
                log = p.communicate(timeout=240)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                log = "timeout"
            self.out[name] = (p.returncode, log)

    def join(self):
        self.thread.join(timeout=500)
        return {name: (rc, log, self._model_dir(name) if rc == 0 else None) for name, (rc, log) in self.out.items()}

    def _model_dir(self, name):
        (run,) = os.listdir(self.root / name)
        return os.path.join(self.root, name, run, "models")

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """``(inputs, jax results, [rank results], cli runs)``: the 8 ranks run
    while JAX computes; each join has a timeout."""
    d = tmp_path_factory.mktemp("pipeline")
    cli = _Cli(d / "cli")
    procs = []
    try:
        inp = _inputs()
        path = str(d / "inputs.pt")
        torch.save(inp, path)
        procs = R.spawn(8, 1, path, str(d / "ranks"), legs="pipeline_legs")
        want = {"layers": _jax_layers(inp), "forms": _jax_forms(inp)}
        got = R.wait(procs, str(d / "ranks"), timeout=300.0)
        runs = cli.join()
    finally:
        cli.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
    return inp, want, got, runs


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


def _assert_grad(got, want, path):
    """A block leaf's gradient at GRAD_RTOL and GRAD_ATOL_OF_MAX, the key
    third of ``attn/b_qkv`` aside (the loss does not depend on the key bias:
    its gradient is rounding noise)."""
    got, want = np.asarray(got), np.asarray(want)
    if path.endswith("attn/b_qkv"):
        W = got.shape[0] // 3
        got, want = (np.delete(a, np.s_[W:2 * W]) for a in (got, want))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL_OF_MAX * np.abs(want).max(), err_msg=path)


@pytest.mark.parametrize("M", MICRO)
def test_pipeline_forward_matches_sequential(legs, M):
    """Every stage's output of the GPipe schedule equals the JAX pipeline's
    and the sequential tower's (tests/test_pipeline.py's tolerance)."""
    _, want, got, _ = legs
    ranks = _ranks_of(got, "pipe_layers")
    assert len(ranks) == 2
    for r in ranks:
        np.testing.assert_allclose(r[M]["y"], want["layers"][M]["y"], **LAYER_TOL)
        np.testing.assert_allclose(r[M]["y"], want["layers"]["seq"], **LAYER_TOL)


@pytest.mark.parametrize("M", MICRO)
def test_pipeline_grads_match_sequential(legs, M):
    """Each stage's blocks' gradients equal the JAX pipeline's and the
    sequential tower's for those layers: the masked output sum hands the
    last stage the cotangent once, and the ring carries it back (the key
    biases' rounding-noise gradients aside)."""
    _, want, got, _ = legs
    seen = set()
    for r in _ranks_of(got, "pipe_layers"):
        for path, g in r[M]["grads"].items():
            layer, sub, leaf = path.split("/")
            seen.add(int(layer))
            for ref in (want["layers"][M]["grads"], want["layers"]["seq_grads"]):
                _assert_grad(g, ref[sub][leaf][int(layer)], path)
    assert seen == {0, 1}


@pytest.mark.parametrize("causal", [False, True], ids=["k2", "causal"])
def test_seq_parallel_layers_at_t197(legs, causal):
    """Sequence parallelism over tp = 2 at T 197 (which 2 does not divide:
    padded to 198, the pad key masked, the pad row sliced off) equals JAX's
    sequential tower in values and gradients, in the K2 route and the causal
    route (LayerNorm on the rank's rows, the gathered rows into the plain
    projections around B6)."""
    _, want, got, _ = legs
    ref = want["layers"]["t197", causal]
    ranks = _ranks_of(got, "seq_layers")
    assert len(ranks) == 2
    for r in ranks:
        out = r[causal]
        assert out["y"].shape == (2, 197, 64)
        np.testing.assert_allclose(out["y"], ref["y"], **LAYER_TOL)
        for path, g in out["grads"].items():
            _, _, layer, sub, leaf = path.split("/")
            _assert_grad(g, ref["grads"][sub][leaf][int(layer)], path)


@pytest.mark.parametrize("form", sorted(R.PIPE_FORMS))
def test_forms_match_jax(legs, form):
    """Each form's two InfoNCE steps on each of its ranks: losses at
    TRAJ_TOL against the JAX package's same form and its dp-only step (the
    forms are the plain step's arithmetic), the gathered tree against the
    JAX form's."""
    _, want, got, _ = legs
    dp, pp, tp, kw = R.PIPE_FORMS[form]
    ranks = _ranks_of(got, form)
    assert len(ranks) == dp * pp * tp
    dp_only = want["forms"]["dp2" if kw.get("key", "infonce") == "infonce" else form]["loss"]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want["forms"][form]["loss"], **TRAJ_TOL)
        np.testing.assert_allclose(r["loss"], dp_only, **TRAJ_TOL)
        _assert_tree(r["tree"], want["forms"][form]["tree"])


@pytest.mark.parametrize("form", sorted(R.PIPE_FORMS))
def test_form_gradients_are_the_global_batchs(legs, form):
    """The gradients each form hands its optimizer (summed over ``data``,
    reduce-scattered for the FSDP leaves, gathered over every axis) are one
    process's gradients of the whole batch at 1e-4 norm-relative: a sum
    counted twice (an FSDP leaf summed again over ``data``, the last stage's
    cotangent taken S times) would read 2.  The clip's global norm each rank
    reads is the whole batch's at 1e-5."""
    _, _, got, _ = legs
    for r in _ranks_of(got, form):
        assert r["grad_err"] <= 1e-4, r["grad_err"]
        np.testing.assert_allclose(*r["norms"], rtol=1e-5)


@pytest.mark.parametrize("form", FSDP_FORMS)
def test_fsdp_shards_params_and_moments(legs, form):
    """Each FSDP rank holds ``1/dp`` of every leaf whose spec names ``data``
    (the GEMM weights along their non-TP dimension, the embeddings and
    projections along their first), in its params and in its AdamW moments
    (ZeRO), after the steps (tests/test_fsdp.py's
    ``_shards_params_and_moments`` / ``_composes_with_pipeline``)."""
    inp, _, got, _ = legs
    dp, pp, tp, _ = R.PIPE_FORMS[form]
    cfg = tcfg.TINY_TEST
    W, V, L = cfg.vision_width, cfg.vocab_size, cfg.vision_layers
    for r in _ranks_of(got, form):
        for shapes in (r["local_shapes"], r["moment_shapes"]):
            assert shapes["visual/blocks/0/attn/w_qkv"] == (W // dp, 3 * W // tp)
            assert shapes["visual/blocks/0/attn/w_out"] == (W // tp, W // dp)
            assert shapes["visual/blocks/0/mlp/w_fc"] == (W // dp, 4 * W // tp)
            assert shapes["visual/blocks/0/mlp/w_proj"] == (4 * W // tp, W // dp)
            assert shapes["text/token_embedding"] == (V // dp, cfg.text_width)
            assert shapes["visual/proj"] == (W // dp, cfg.embed_dim)
            assert shapes["visual/blocks/0/ln_1/scale"] == (W,)
            assert sum(p.startswith("visual/blocks/") and p.endswith("attn/w_qkv") for p in shapes) == L // pp


@pytest.mark.parametrize("fsdp", [False, True], ids=["dp_pp_tp", "fsdp"])
def test_gathers_are_the_exact_inverses_on_three_axes(legs, fsdp):
    """On dp 2 x pp 2 x tp 2, ``gather_params(shard_params(tree))`` and
    ``gather_opt_state(shard_opt_state(state))`` (moments and the MultiSteps
    accumulator, under the whole tree's paths) are the tree and the state
    bit for bit, with and without FSDP; each stage holds half the blocks."""
    _, _, got, _ = legs
    for r in got:
        out = r["roundtrip3"][fsdp]
        assert out["params"] and out["moments"] and out["acc"]
        assert out["local_blocks"] == tcfg.TINY_TEST.vision_layers // 2


def test_mesh_grid_3axis_matches_jax(legs):
    """The ``(data, pipe, model)`` grid of ``make_mesh(dp=2, tp=2, pp=2)``:
    JAX's ``reshape(dp, pp, tp)``, each rank placed at its cell."""
    _, _, got, _ = legs
    jm = jmesh.make_mesh(dp=2, tp=2, pp=2, devices=jax.devices())
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert tuple(jm.axis_names) == ("data", "pipe", "model")
    for rank, r in enumerate(got):
        assert tuple(r["3axis_sp"]["place"]) == tuple(int(v) for v in np.argwhere(ids == rank)[0])


def test_pipeline_refusals_by_name():
    """JAX's refusals under pp: the attribution aux, int8, deep prompts,
    MaPLe / deep VPT / token pruning through a ``transformer_fn``, MoE and
    the RN tower; the geometry; SP without ``model`` and FSDP without
    ``data``; the device-list mesh, prompt tuning and GradCache on a pipe
    axis."""
    from tapclip_tpu_torch.models import clip as tclip
    from tapclip_tpu_torch.parallel import pipeline as tpipe
    from tapclip_tpu_torch.parallel.train_step import make_train_step

    mesh = tmesh.Mesh(shape={"data": 1, "pipe": 2, "model": 1}, grid=np.arange(2).reshape(1, 2, 1), rank=0)
    _, blocks = _blocks(0, 2, 64)
    blocks = [jax.tree.map(torch.from_numpy, b) for b in blocks]
    x = torch.zeros(4, 8, 64)
    with pytest.raises(NotImplementedError, match="attribution aux is not supported under pipeline"):
        tpipe.pipeline_transformer_forward(x, blocks, 4, mesh=mesh, n_microbatches=2, act="gelu", attn_to_idx=3)
    with pytest.raises(NotImplementedError, match="int8 quantization is not supported under pipeline"):
        tpipe.make_pipeline_transformer_fn(mesh, 2)(x, blocks, 4, act="gelu", quantize=True)
    with pytest.raises(NotImplementedError, match="deep prompts require the sequential block scan"):
        tpipe.pipeline_transformer_forward(x, blocks, 4, mesh=mesh, n_microbatches=2, act="gelu",
                                           layer_prompts=torch.zeros(1, 2, 64))
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.check_pipeline_geometry(3, 2, batch=8, n_microbatches=2)
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.check_pipeline_geometry(4, 2, batch=6, n_microbatches=4)
    with pytest.raises(ValueError, match="batch 6 not divisible by 4 microbatches"):
        tpipe.pipeline_transformer_forward(torch.zeros(6, 8, 64), blocks, 4, mesh=mesh, n_microbatches=4, act="gelu")
    fn = tpipe.make_pipeline_transformer_fn(mesh, 2)
    cfg = tcfg.TINY_TEST
    tree = params_from_jax(_np_tree(jclip.init_clip_params(jax.random.PRNGKey(0), J_TINY)), cfg)
    img = torch.zeros(2, 32, 32, 3)
    for c, kw, match in ((cfg.replace(vpt_tokens=2, vpt_deep=True), {}, "vpt_deep requires the sequential"),
                         (cfg.replace(token_keep_ratio=0.5, token_prune_layer=1), {}, "token pruning is not supported"),
                         (cfg, dict(maple_prompts=(torch.zeros(2, 64), None, None)), "maple prompts require")):
        t = dict(tree, visual=dict(tree["visual"], vpt=torch.zeros(2, 2, 64))) if c.vpt_tokens else tree
        with pytest.raises(NotImplementedError, match=match):
            tclip.encode_image(t, c, img, transformer_fn=fn, **kw)
    with pytest.raises(NotImplementedError, match="pipeline parallelism over MoE towers"):
        tclip.encode_text(tree, cfg.replace(moe_experts=2), np.zeros((2, 16), np.int64), transformer_fn=fn)
    with pytest.raises(NotImplementedError, match="pipeline parallelism applies to transformer towers only"):
        tclip.encode_image(tree, tcfg.MODEL_PRESETS["RN50"], img, transformer_fn=fn)
    with pytest.raises(NotImplementedError, match="the pipe axis over a device list"):
        tmesh.make_mesh(dp=1, pp=2, devices=["cpu", "cpu"])
    opt = tpre.PretrainOptimizer(tpre.set_trainable(tree), lr=1e-4, weight_decay=0.1)
    two_data = tmesh.Mesh(shape={"data": 2, "model": 1}, grid=np.arange(2).reshape(2, 1), rank=0)
    two_model = tmesh.Mesh(shape={"data": 1, "model": 2}, grid=np.arange(2).reshape(1, 2), rank=0)
    with pytest.raises(ValueError, match="seq_parallel needs a mesh with a 'model' axis > 1"):
        tpre.make_pretrain_step(cfg, opt, mesh=two_data, seq_parallel=True)
    with pytest.raises(ValueError, match="fsdp needs a mesh with a 'data' axis > 1"):
        tpre.make_pretrain_step(cfg, opt, mesh=two_model, fsdp=True)
    with pytest.raises(ValueError, match="layers not divisible by 2 stages"):
        tpre.make_pretrain_step(cfg.replace(vision_layers=3), opt, mesh=mesh)
    with pytest.raises(ValueError, match="not with a pipe axis"):
        tpre.make_accum_pretrain_step(cfg, opt, 2, mesh=mesh)
    with pytest.raises(NotImplementedError, match="not on a pipe axis"):
        make_train_step(cfg, tcfg.PromptConfig(), mesh=mesh)


def test_pretrain_cli_pp2_tp2_seq_parallel_under_torchrun(legs):
    """``torchrun --nproc-per-node 4 -m tapclip_tpu_torch.pretrain_cli
    --preset tiny --pp 2 --tp 2 --seq-parallel`` (gloo) runs one epoch of
    the one-process run's batches: its loss at TRAJ_TOL, rank 0's whole
    tree (gathered over pipe and model) in the one-process layout, held as
    the trees above.  The one-process run's ``--fsdp`` warns and is
    ignored, as in the JAX CLI."""
    from tapclip_tpu_torch.utils import checkpoint as ckpt_io

    runs = legs[3]
    for name in ("one", "pp2tp2sp"):
        assert runs[name][0] == 0, runs[name][1][-3000:]
    assert "--fsdp ignored: single device, nothing to shard" in runs["one"][1]
    assert "mesh: {'data': 1, 'pipe': 2, 'model': 2} over 4 ranks (backend gloo)" in runs["pp2tp2sp"][1]

    def loss(log):
        return [float(line.rsplit(":", 1)[1]) for line in log.splitlines() if "contrastive loss:" in line]

    np.testing.assert_allclose(loss(runs["pp2tp2sp"][1]), loss(runs["one"][1]), **TRAJ_TOL)
    trees = [dict(tpre.named_leaves(ckpt_io.load_clip_tree(os.path.join(runs[n][2], "clip_pretrained.pt"),
                                                           tcfg.TINY_TEST))) for n in ("one", "pp2tp2sp")]
    _assert_tree(trees[1], trees[0], steps=120 // 8)
