"""The port's model export (``torch.export``) against the eager calls and the
JAX package's ``jax.export`` artifacts.

Mirrors ``tests/test_model_export.py`` for ``tapclip_tpu_torch.utils.model_export``
on the tiny preset: the exported programs equal the eager port calls bit for
bit on the CPU (the same plain versions run, behind the ``tapclip`` ops),
weights stay call-time inputs, the manifest holds what it documents, a
symbolic batch covers several batch sizes, and the refusals hold.  Beyond
those: the same bridged weights and numpy inputs through the JAX package's
``export_model`` -> ``load_exported`` and the port's agree within 1e-5
(f32; the two packages sum in different orders); the exported graphs hold
one ``tapclip::`` node per kernel call of the eager path and no plain
composition in their place; a loader in a fresh interpreter imports no
model code.
"""

import contextlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tapclip_tpu.config import PromptConfig as JPromptConfig
from tapclip_tpu.data.tokenizer import get_tokenizer as j_get_tokenizer
from tapclip_tpu.models.model_wrapper import init_trainable as j_init_trainable
from tapclip_tpu.models.prompt_learner import PromptLearner as JPromptLearner
from tapclip_tpu.utils import model_export as JME

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch.models import clip as clip_model
from tapclip_tpu_torch.models.model_wrapper import full_model_forward, text_features_with_attribution
from tapclip_tpu_torch.ops import _library
from tapclip_tpu_torch.serve import predict_batch
from tapclip_tpu_torch.utils import model_export as ME
from tapclip_tpu_torch.utils.jax_bridge import params_from_jax, prompt_state_from_jax

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

CLASSES = ["Backpack", "Pen", "Mug"]
BATCH = 3  # the JAX programs run at batch 3: tests/test_scale.py counts compiles at batch 2
JAX_TOL = dict(rtol=1e-5, atol=1e-5)
TC = tcfg.TINY_TEST
OPS = tuple(f"tapclip.{name}.default" for name in _library.OPS)


def _pair(tiny_cfg, tiny_params, text_mode="ref_compat"):
    """(JAX params, trainable, bank; port params, trainable, bank, prompt config)."""
    jp = JPromptConfig(max_classes=4, text_mode=text_mode)
    learner = JPromptLearner(CLASSES, tiny_params, tiny_cfg, jp,
                             j_get_tokenizer(context_length=tiny_cfg.context_length))
    jt = j_init_trainable(jax.random.PRNGKey(1), learner, jp)
    tp = params_from_jax(jax.tree.map(np.asarray, tiny_params), TC)
    tt, tb = prompt_state_from_jax(jax.tree.map(np.asarray, jt), jax.tree.map(np.asarray, learner.bank))
    pcfg = tcfg.PromptConfig(max_classes=4, text_mode=text_mode)
    return (jt, learner.bank), (tp, tt, tb, pcfg)


@pytest.fixture(scope="module")
def pair(tiny_cfg, tiny_params):
    return _pair(tiny_cfg, tiny_params)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory, pair):
    _, (tp, tt, tb, pcfg) = pair
    out = str(tmp_path_factory.mktemp("export"))
    ME.export_model(out, tp, TC, pcfg, tt, tb, batch=BATCH, functions=ME.EXPORTABLE_FUNCTIONS)
    return out


@pytest.fixture(scope="module")
def fns(artifact):
    return ME.load_exported(artifact)


def _images(B=BATCH, seed=3):
    return np.random.default_rng(seed).standard_normal((B, TC.image_size, TC.image_size, 3)).astype(np.float32)


def _tokens(B=BATCH, seed=7):
    return np.random.default_rng(seed).integers(0, 200, (B, TC.context_length)).astype(np.int32)


def _encode(params, cfg, name, x):
    with torch.no_grad():
        f = getattr(clip_model, name)(params, cfg, torch.from_numpy(x))
        return clip_model.l2_normalize(f).float()


def _reordered(tree):
    """``tree`` with every dict's keys in reverse order."""
    if isinstance(tree, dict):
        return {k: _reordered(tree[k]) for k in reversed(list(tree))}
    if isinstance(tree, list):
        return [_reordered(v) for v in tree]
    return tree


def test_encode_roundtrip_exact(fns, pair):
    _, (tp, _, _, _) = pair
    imgs, toks = _images(), _tokens()
    want = _encode(tp, TC, "encode_image", imgs)
    assert torch.equal(fns["encode_image"](tp, torch.from_numpy(imgs)), want)
    assert torch.equal(fns["encode_image"](_reordered(tp), torch.from_numpy(imgs)), want)  # any dict order
    assert torch.equal(fns["encode_text"](tp, torch.from_numpy(toks)), _encode(tp, TC, "encode_text", toks))


def test_full_forward_matches_model(fns, pair):
    _, (tp, tt, tb, pcfg) = pair
    imgs = torch.from_numpy(_images(seed=11))
    got = fns["full_forward"](tp, tt, ME._bank_to_plain(tb), imgs)
    with torch.no_grad():
        ref = full_model_forward(tp, tt, tb, imgs, None, clip_cfg=TC, prompt_cfg=pcfg)
    assert torch.equal(got["logits"], ref["logits"])
    assert torch.equal(got["attribution"], ref["attribution"])


def test_classify_matches_serving_semantics(fns, pair):
    _, (tp, tt, tb, pcfg) = pair
    with torch.no_grad():
        feats, _ = text_features_with_attribution(tp, tt["ctx"], tb, TC, pcfg, tt["adjustor"])
        imgs = torch.from_numpy(_images(seed=13))
        got = fns["classify"](tp, feats.float(), tt["logit_scale"], tb.class_mask, imgs)
        ref, _ = predict_batch(tp, TC, feats, tt["logit_scale"], tb.class_mask, imgs)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    assert np.all(got.numpy()[:, len(CLASSES):] < -1e29)  # padded class slots masked out


def _param_bytes(tree):
    return sum(t.numel() * t.element_size() for t in torch.utils._pytree.tree_leaves(tree))


def test_weights_not_baked(artifact, pair):
    """Artifacts stay program-sized: the parameters are call-time inputs,
    never state or constants of the program."""
    _, (tp, _, _, _) = pair
    manifest = ME.load_manifest(artifact)
    for name, meta in manifest["functions"].items():
        assert meta["bytes"] < 2 ** 20, (name, meta["bytes"])
        assert os.path.getsize(os.path.join(artifact, meta["file"])) == meta["bytes"]
        ep = torch.export.load(os.path.join(artifact, meta["file"]))
        assert not ep.state_dict
        assert sum(c.numel() for c in ep.constants.values() if torch.is_tensor(c)) < 64, name
    n_leaves = len(torch.utils._pytree.tree_leaves(tp))
    assert len(manifest["functions"]["encode_image"]["in_specs"]) == n_leaves + 1
    assert _param_bytes(tp) > 2 ** 20  # the tiny tree alone would not fit


def test_manifest_contents(artifact):
    manifest = ME.load_manifest(artifact)
    assert manifest["format"] == "tapclip_tpu_torch.model_export/1"
    assert manifest["torch_version"] == torch.__version__
    assert manifest["device"] == "cpu" and manifest["batch"] == BATCH
    assert manifest["model_config"]["image_size"] == TC.image_size
    assert set(manifest["functions"]) == set(ME.EXPORTABLE_FUNCTIONS)
    for meta in manifest["functions"].values():
        assert meta["device"] == "cpu" and meta["file"].endswith(".pt2")
        assert meta["in_specs"][-1] in (f"float32[{BATCH}, 32, 32, 3]", f"int32[{BATCH}, 16]")
        assert meta["out_specs"] and meta["tapclip_ops"]
    assert manifest["functions"]["encode_text"]["out_specs"] == [f"float32[{BATCH}, 32]"]
    with open(os.path.join(artifact, ME.MANIFEST_NAME)) as f:
        assert json.load(f) == manifest


def test_symbolic_batch_one_artifact_many_batches(tmp_path, pair):
    _, (tp, _, _, _) = pair
    cfg = TC.replace(attn_impl="xla")
    exported = ME.export_functions(tp, cfg, batch=3, functions=("encode_image", "encode_text"),
                                   symbolic_batch=True)
    out = ME.save_exported(str(tmp_path / "poly"), exported, cfg, {"batch": None})
    fns = ME.load_exported(out)
    for B in (2, 5):
        imgs, toks = _images(B=B, seed=B), _tokens(B=B, seed=B)
        assert torch.equal(fns["encode_image"](tp, torch.from_numpy(imgs)), _encode(tp, cfg, "encode_image", imgs))
        assert torch.equal(fns["encode_text"](tp, torch.from_numpy(toks)), _encode(tp, cfg, "encode_text", toks))
    assert ME.load_manifest(out)["functions"]["encode_image"]["tapclip_ops"] == []


@pytest.mark.parametrize("case", ["pallas-symbolic", "auto-symbolic", "unknown", "cocoop-classify", "resnet"])
def test_refusals(case, pair):
    _, (tp, tt, tb, _) = pair
    kw, match = dict(functions=("encode_image",)), None
    cfg, pcfg = TC, tcfg.PromptConfig(max_classes=4)
    if case.endswith("symbolic"):
        cfg, kw["symbolic_batch"], match = TC.replace(attn_impl=case.split("-")[0]), True, "attn_impl"
    elif case == "unknown":
        kw["functions"], match = ("nope",), "unknown export function"
    elif case == "cocoop-classify":
        pcfg, kw["functions"], match = tcfg.PromptConfig(image_conditioned=True), ("classify",), "image_conditioned"
    else:
        cfg, match = TC.replace(vision_tower="resnet"), "TF32"
    with pytest.raises(ValueError, match=match):
        ME.export_functions(tp, cfg, pcfg, tt, tb, batch=2, **kw)


def test_cli_end_to_end(tmp_path):
    from tapclip_tpu_torch.scripts import export_model as cli

    out = cli.main(["--preset", "tiny", "--device", "cpu", "--out", str(tmp_path / "cli"), "--batch", "2",
                    "--functions", "encode_image", "classify"])
    manifest = ME.load_manifest(out)
    assert set(manifest["functions"]) == {"encode_image", "classify"}
    npz = np.load(os.path.join(out, "class_features.npz"))
    assert npz["text_feats"].shape[0] == npz["class_mask"].shape[0]
    assert npz["class_names"].shape[0] == int(npz["class_mask"].sum())
    fns = ME.load_exported(out)
    params = clip_model.init_clip_params(torch.Generator().manual_seed(0), TC)
    logits = fns["classify"](params, torch.from_numpy(npz["text_feats"]), torch.tensor(float(npz["logit_scale"])),
                             torch.from_numpy(npz["class_mask"]), torch.from_numpy(_images(B=2)))
    assert logits.shape == (2, npz["class_mask"].shape[0]) and torch.isfinite(logits[:, npz["class_mask"]]).all()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_export_on_cpu_load_with_device(artifact, pair, device):
    """``load_exported(device=)`` moves each program and the devices its graph
    names; on ``meta`` the ops run their fake kernels (shapes only)."""
    _, (tp, _, _, _) = pair
    fns = ME.load_exported(artifact, device=device)
    imgs = _images()
    params = torch.utils._pytree.tree_map(lambda t: t.to(device), tp)
    got = fns["encode_image"](params, torch.from_numpy(imgs).to(device))
    assert got.device.type == device and got.shape == (BATCH, TC.embed_dim)
    if device == "cpu":
        assert torch.equal(got, _encode(tp, TC, "encode_image", imgs))
    ep = torch.export.load(os.path.join(artifact, "full_forward.pt2"))
    moved = torch.export.passes.move_to_device_pass(ep, device)
    devices = {str(a.type) for n in moved.graph.nodes for a in n.kwargs.values() if isinstance(a, torch.device)}
    assert devices <= {device}


def _jax_artifact(tmp_path, tiny_cfg, tiny_params, jt, jbank, text_mode):
    out = str(tmp_path / f"jax_{text_mode}")
    JME.export_model(out, tiny_params, tiny_cfg, JPromptConfig(max_classes=4, text_mode=text_mode), jt, jbank,
                     batch=BATCH, functions=JME.EXPORTABLE_FUNCTIONS)
    return JME.load_exported(out)


@pytest.mark.parametrize("text_mode", ["ref_compat", "idiomatic"])
def test_held_against_jax_export(tmp_path, tiny_cfg, tiny_params, text_mode):
    """The same weights and inputs through both packages' export -> load."""
    (jt, jbank), (tp, tt, tb, pcfg) = _pair(tiny_cfg, tiny_params, text_mode)
    jfns = _jax_artifact(tmp_path, tiny_cfg, tiny_params, jt, jbank, text_mode)
    out = ME.export_model(str(tmp_path / "port"), tp, TC, pcfg, tt, tb, batch=BATCH,
                          functions=ME.EXPORTABLE_FUNCTIONS)
    tfns = ME.load_exported(out)
    imgs, toks = _images(seed=21), _tokens(seed=22)
    np.testing.assert_allclose(tfns["encode_image"](tp, torch.from_numpy(imgs)).numpy(),
                               np.asarray(jfns["encode_image"](tiny_params, imgs)), **JAX_TOL)
    np.testing.assert_allclose(tfns["encode_text"](tp, torch.from_numpy(toks)).numpy(),
                               np.asarray(jfns["encode_text"](tiny_params, toks)), **JAX_TOL)
    got = tfns["full_forward"](tp, tt, ME._bank_to_plain(tb), torch.from_numpy(imgs))
    want = jfns["full_forward"](tiny_params, jt, JME._bank_to_plain(jbank), imgs)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["attribution"].numpy(), np.asarray(want["attribution"]), **JAX_TOL)
    C = tb.ctx.shape[0]
    feats = np.random.default_rng(23).standard_normal((C, TC.embed_dim)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    mask = np.arange(C) < len(CLASSES)
    got = tfns["classify"](tp, torch.from_numpy(feats), tt["logit_scale"], torch.from_numpy(mask),
                           torch.from_numpy(imgs))
    want = jfns["classify"](tiny_params, feats, np.float32(np.asarray(jt["logit_scale"])), mask, imgs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


class _OpCounter(TorchDispatchMode):
    """Counts the ``tapclip`` op calls of an eager run."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith("tapclip."):
            self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _graph_ops(ep):
    counts = {}
    for n in ep.graph.nodes:
        if n.op == "call_function":
            counts[str(n.target)] = counts.get(str(n.target), 0) + 1
    return counts


def _call(name, tp, tt, tb, pcfg, cfg=TC):
    imgs = torch.from_numpy(_images())
    if name == "encode_image":
        return lambda: clip_model.encode_image(tp, cfg, imgs)
    if name == "encode_text":
        return lambda: clip_model.encode_text(tp, cfg, torch.from_numpy(_tokens()))
    if name == "classify":
        return lambda: predict_batch(tp, cfg, torch.zeros(tb.ctx.shape[0], cfg.embed_dim), tt["logit_scale"], tb.class_mask, imgs)
    return lambda: full_model_forward(tp, tt, tb, imgs, None, clip_cfg=cfg, prompt_cfg=pcfg)


@pytest.mark.parametrize("text_mode", ["ref_compat", "idiomatic"])
@pytest.mark.parametrize("name", ME.EXPORTABLE_FUNCTIONS)
def test_graph_holds_one_op_node_per_kernel_call(tiny_cfg, tiny_params, name, text_mode):
    """Each exported graph holds exactly as many ``tapclip::`` nodes of each
    op as the eager path makes kernel calls, and none of the plain
    composition (GELU, softmax) that the ops replace."""
    _, (tp, tt, tb, pcfg) = _pair(tiny_cfg, tiny_params, text_mode)
    ep = ME.export_functions(tp, TC, pcfg, tt, tb, batch=BATCH, functions=(name,))[name]
    with torch.no_grad(), _OpCounter() as mode:
        _call(name, tp, tt, tb, pcfg)()
    graph = _graph_ops(ep)
    assert {k: v for k, v in graph.items() if k in OPS} == mode.counts
    L, Lt = TC.vision_layers, TC.text_layers
    image = {"tapclip.fused_mlp.default": L, "tapclip.attn_block.default": L}
    want = {
        "encode_image": image,
        "classify": image,
        "encode_text": {"tapclip.fused_mlp.default": Lt, "tapclip.mha.default": Lt},
    }.get(name)
    if name == "full_forward":  # the image tower, the attribution pass, the encode pass
        if text_mode == "ref_compat":
            want = {"tapclip.fused_mlp.default": L + 2 * Lt, "tapclip.attn_block.default": L + 2 * Lt - 1,
                    "tapclip.attn_aux.default": 1}
        else:
            want = {"tapclip.fused_mlp.default": L + 2 * Lt, "tapclip.attn_block.default": L,
                    "tapclip.mha.default": 2 * Lt - 1, "tapclip.attn_aux.default": 1}
    assert mode.counts == want
    assert not [k for k in graph if "gelu" in k or "softmax" in k] or name == "full_forward"
    if name == "full_forward":  # the attribution's softmax over the prompt slots is the only one
        assert [k for k in graph if "gelu" in k] == []
        assert sum(v for k, v in graph.items() if "softmax" in k) == 1


@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "nearest"])
def test_int8_tower_exports_its_ops(pair, deterministic):
    """``quantize_tower`` exports B13 / B14 as ``tapclip::int8_*`` nodes (the
    weights quantized in the graph), equal to the eager call."""
    _, (tp, _, _, _) = pair
    cfg = TC.replace(quantize_tower=True, int8_deterministic=deterministic)
    ep = ME.export_functions(tp, cfg, batch=BATCH, functions=("encode_image",))["encode_image"]
    ops = _graph_ops(ep)
    assert ops.get("tapclip.int8_mlp.default") == cfg.vision_layers
    assert ops.get("tapclip.int8_attn.default") == cfg.vision_layers
    assert "tapclip.fused_mlp.default" not in ops and "tapclip.attn_block.default" not in ops
    imgs = _images(seed=5)
    got = ME._Loaded(ep.module())(tp, torch.from_numpy(imgs))
    assert torch.equal(got, _encode(tp, cfg, "encode_image", imgs))


def test_ops_have_no_fallback():
    """Each ``tapclip`` op has a CPU and a CUDA kernel and no composite one,
    so a CUDA tensor reaches the launcher (which launches or raises), never
    a plain composition."""
    for name in _library.OPS:
        op = f"tapclip::{name}"
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CPU")
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
        assert not torch._C._dispatch_has_kernel_for_dispatch_key(op, "CompositeImplicitAutograd")
        assert not torch._C._dispatch_has_kernel_for_dispatch_key(op, "CompositeExplicitAutograd")


def test_loader_imports_no_model_code(artifact, pair, tmp_path):
    """A fresh interpreter loads and runs the programs with
    ``utils.model_export`` alone: ``tapclip_tpu_torch.models`` stays out of
    ``sys.modules`` before and after the calls (and so do jax and the JAX
    package)."""
    _, (tp, tt, tb, _) = pair
    imgs = _images()
    torch.save({"params": tp, "trainable": tt, "bank": ME._bank_to_plain(tb), "images": torch.from_numpy(imgs)},
               tmp_path / "inputs.pt")
    code = (
        "import sys, torch\n"
        "from tapclip_tpu_torch.utils.model_export import load_exported\n"
        "def bad(): return sorted(m for m in sys.modules if m.startswith('tapclip_tpu_torch.models') "
        "or m.split('.')[0] in ('jax', 'tapclip_tpu'))\n"
        "assert not bad(), bad()\n"
        f"fns = load_exported({artifact!r})\n"
        f"a = torch.load({str(tmp_path / 'inputs.pt')!r})\n"
        "f = fns['encode_image'](a['params'], a['images'])\n"
        "out = fns['full_forward'](a['params'], a['trainable'], a['bank'], a['images'])\n"
        f"torch.save({{'f': f, 'logits': out['logits']}}, {str(tmp_path / 'out.pt')!r})\n"
        "assert not bad(), bad()\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = torch.load(tmp_path / "out.pt")
    assert torch.equal(got["f"], _encode(tp, TC, "encode_image", imgs))
    with torch.no_grad():
        ref = full_model_forward(tp, tt, tb, torch.from_numpy(imgs), None, clip_cfg=TC,
                                 prompt_cfg=tcfg.PromptConfig(max_classes=4))
    assert torch.equal(got["logits"], ref["logits"])


@pytest.mark.parametrize("kind", ["maple", "cocoop"])
def test_full_forward_exports_coupled_and_conditioned_prompts(tmp_path, pair, kind):
    """``full_forward`` of a MaPLe model (deep prompts in both towers, their
    depth mask on the host) and of a CoCoOp model (the meta-net, text passes
    on B*C rows) exports and equals the eager call bit for bit."""
    from tapclip_tpu_torch.models.model_wrapper import FullModel

    _, (tp, _, _, _) = pair
    pcfg = tcfg.PromptConfig(max_classes=4, **({"maple_depth": 2} if kind == "maple" else {"image_conditioned": True}))
    m = FullModel(CLASSES, tp, TC, prompt_cfg=pcfg, generator=torch.Generator().manual_seed(2))
    out = ME.export_model(str(tmp_path / kind), tp, TC, pcfg, m.trainable, m.prompt_learner.bank, batch=BATCH,
                          functions=("full_forward",))
    imgs = torch.from_numpy(_images(seed=17))
    got = ME.load_exported(out)["full_forward"](tp, m.trainable, ME._bank_to_plain(m.prompt_learner.bank), imgs)
    with torch.no_grad():
        want = full_model_forward(tp, m.trainable, m.prompt_learner.bank, imgs, None, clip_cfg=TC, prompt_cfg=pcfg)
    assert torch.equal(got["logits"], want["logits"]) and torch.equal(got["attribution"], want["attribution"])


@pytest.mark.parametrize("route", ["direct", "op"])
def test_ops_call_the_modules_current_functions(monkeypatch, route):
    """The wrappers reach their implementations through the modules, called
    directly or through the op (under a dispatch mode), so a patched launcher
    or plain version (a profiler's host span, a spy) is the one that runs."""
    from tapclip_tpu_torch.ops import fused_mha, fused_mlp

    seen = []
    for module, name in ((fused_mlp, "fused_mlp_reference"), (fused_mha, "fused_mha_reference")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _fn=fn, _n=name, **k: seen.append(_n) or _fn(*a, **k))
    x = torch.randn(2, 8, 64)
    with _OpCounter() if route == "op" else contextlib.nullcontext() as mode:
        fused_mlp.fused_mlp_block(x, {"scale": torch.ones(64), "bias": torch.zeros(64)},
                                  {"w_fc": torch.randn(64, 256), "b_fc": torch.zeros(256),
                                   "w_proj": torch.randn(256, 64), "b_proj": torch.zeros(64)})
        fused_mha.fused_mha(torch.randn(2, 8, 192), 4, causal=True)
    assert seen == ["fused_mlp_reference", "fused_mha_reference"]
    if mode is not None:
        assert mode.counts == {"tapclip.fused_mlp.default": 1, "tapclip.mha.default": 1}


@pytest.mark.parametrize("case", ["cpu", "mode", "meta", "fake"])
def test_run_leaves_out_the_dispatcher_only_where_nothing_traces(case):
    """``_build.run`` calls the op's own CPU implementation on a plain CPU
    tensor, and the op itself under a dispatch mode, on a meta tensor and on
    a fake one (what ``torch.export`` traces with), so a trace keeps the op."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from tapclip_tpu_torch.ops import _build

    calls = []
    fns = [lambda x, _n=n: calls.append(_n) for n in ("op", "plain", "launcher")]
    if case == "cpu":
        _build.run(*fns, torch.zeros(2))
    elif case == "mode":
        with _OpCounter():
            _build.run(*fns, torch.zeros(2))
    elif case == "meta":
        _build.run(*fns, torch.zeros(2, device="meta"))
    else:
        with FakeTensorMode() as fake:
            x = fake.from_tensor(torch.zeros(2))
        _build.run(*fns, x)
    assert calls == (["plain"] if case == "cpu" else ["op"])
