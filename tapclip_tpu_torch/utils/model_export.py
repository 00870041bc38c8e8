"""Ahead-of-time model export: ``torch.export`` programs of the serving functions.

Counterpart of ``tapclip_tpu/utils/model_export.py``.  ``torch.export``
serializes the *computation* (an ATen graph with its calling convention) in
a ``.pt2`` file, so a serving host runs the model from the artifact without
the model code: no ``tapclip_tpu_torch.models``, no retracing.

Design choices, as the JAX module's:

* **Parameters stay call-time inputs**, never constants of the program:
  the artifact stays program-sized (a ViT-B/16 ``.pt2`` is far below its
  ~600 MB of weights) and one artifact serves many checkpoints.
* **Plain-container calling convention**: the functions take dicts and
  lists of tensors (the :class:`PromptBank` as a plain dict,
  :func:`_bank_to_plain`).  A program is traced with every dict's keys
  sorted, and the loaded functions sort their arguments' keys the same way
  (:func:`_canonical`), so a tree built in any order calls it.
* **Static shapes by default** (one artifact per batch size), with opt-in
  symbolic batch (``symbolic_batch=True``, a ``torch.export.Dim``) for
  ``attn_impl='xla'`` exports, the plain composition.

**The kernels stay in the artifact.**  Every forward kernel the functions
reach (K1, K2, K3, B6, and B13 / B14 under ``quantize_tower``) is a
``tapclip::`` op (``ops/_library.py``), traced through its fake kernel as one
opaque node.  When the program runs, the dispatcher launches the
hand-written kernel on a CUDA tensor and the plain version on a CPU tensor,
so an exported function launches exactly the kernels its eager call does.

Differences from the JAX module:

* **One device per artifact.**  A program is traced on the device its
  parameters live on.  ``load_exported(path, device=...)`` moves it to
  another (``torch.export.passes.move_to_device_pass``), the counterpart of
  the JAX module's multi-platform lowering: there is no ``platforms``
  argument.
* **What loading needs.**  A JAX artifact needs jax alone; a ``.pt2`` needs
  torch plus the ``tapclip`` op registrations (this module imports
  ``ops/_library.py`` and the launchers it registers, never the model code),
  and is tied to the ``.pt2`` format of the torch version that wrote it.

Artifact layout (:func:`save_exported`)::

    outdir/
      manifest.json     # format, torch version, device, functions, specs
      <function>.pt2    # torch.export.save (one per function)

Functions exported (``EXPORTABLE_FUNCTIONS``):

* ``encode_image(clip_params, images[B,H,W,3] f32) -> [B,E]`` unit-norm features
* ``encode_text(clip_params, tokens[B,T] int32) -> [B,E]`` unit-norm features
* ``classify(clip_params, text_feats[C,E], logit_scale, class_mask, images)
  -> logits [B,C]``: the serving fast path (cached class features)
* ``full_forward(clip_params, trainable, bank, images) -> {logits,
  attribution}``: the attribution forward (``full_model_forward``)
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Iterable, Optional

import torch

import tapclip_tpu_torch.ops._library  # noqa: F401  (registers the tapclip ops a program calls)
from tapclip_tpu_torch.config import CLIPConfig, PromptConfig

EXPORTABLE_FUNCTIONS = ("encode_image", "encode_text", "classify", "full_forward")

MANIFEST_NAME = "manifest.json"
FORMAT = "tapclip_tpu_torch.model_export/1"
_SUFFIX = ".pt2"


def _bank_to_plain(bank) -> Dict[str, torch.Tensor]:
    return {
        "ctx": bank.ctx,
        "token_embs": bank.token_embs,
        "class_mask": bank.class_mask,
        "eot_pos": bank.eot_pos,
    }


def _build_fn(name: str, cfg: CLIPConfig, pcfg: PromptConfig) -> Callable:
    """The pure function behind each exportable entry point."""
    from tapclip_tpu_torch.models import clip as clip_model

    if name == "encode_image":

        def encode_image(clip_params, images):
            f = clip_model.encode_image(clip_params, cfg, images)
            return clip_model.l2_normalize(f).float()

        return encode_image

    if name == "encode_text":

        def encode_text(clip_params, token_ids):
            f = clip_model.encode_text(clip_params, cfg, token_ids)
            return clip_model.l2_normalize(f).float()

        return encode_text

    if name == "classify":
        # Mirrors serve.py's predict path: frozen tower + cached class-text
        # features; padded class slots masked to -1e30.
        def classify(clip_params, text_feats, logit_scale, class_mask, images):
            f = clip_model.encode_image(clip_params, cfg, images)
            img = clip_model.l2_normalize(f).float()
            logits = torch.exp(logit_scale).float() * (img @ text_feats.float().T)
            return torch.where(class_mask[None, :], logits, torch.full_like(logits, -1e30))

        return classify

    if name == "full_forward":
        from tapclip_tpu_torch.models.model_wrapper import full_model_forward
        from tapclip_tpu_torch.models.prompt_learner import PromptBank

        def full_forward(clip_params, trainable, bank, images):
            out = full_model_forward(
                clip_params,
                trainable,
                PromptBank(bank["ctx"], bank["token_embs"], bank["class_mask"], bank["eot_pos"]),
                images,
                None,
                clip_cfg=cfg,
                prompt_cfg=pcfg,
            )
            return {"logits": out["logits"], "attribution": out["attribution"]}

        return full_forward

    raise ValueError(f"unknown export function {name!r}; expected one of {EXPORTABLE_FUNCTIONS}")


class _Program(torch.nn.Module):
    """A function as the module ``torch.export`` traces (no parameters of its own)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _example_args(name: str, cfg: CLIPConfig, clip_params, trainable, bank, batch: int, device):
    """Example inputs for tracing: the parameters themselves (inputs of the
    program, never baked in) and zero-filled data of the call's shapes."""
    images = torch.zeros((batch, cfg.image_size, cfg.image_size, 3), dtype=torch.float32, device=device)
    if name == "encode_image":
        return (clip_params, images)
    if name == "encode_text":
        return (clip_params, torch.zeros((batch, cfg.context_length), dtype=torch.int32, device=device))
    if name == "classify":
        if bank is None:
            raise ValueError("classify export needs a prompt bank (class count)")
        C = bank.ctx.shape[0]
        return (
            clip_params,
            torch.zeros((C, cfg.embed_dim), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.float32, device=device),
            torch.ones((C,), dtype=torch.bool, device=device),
            images,
        )
    if name == "full_forward":
        if trainable is None or bank is None:
            raise ValueError("full_forward export needs trainable + bank")
        return (clip_params, trainable, _bank_to_plain(bank), images)
    raise ValueError(name)


def _canonical(tree):
    """``tree`` with every dict's keys in sorted order: the order a program
    is traced and called in (an exported program's inputs must come in the
    order it was traced with, and the port builds trees in several orders:
    ``init_clip_params``, the open_clip converter, the JAX bridge)."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_canonical(v) for v in tree)
    return tree


def _device_of(clip_params) -> torch.device:
    return clip_params["logit_scale"].device


def export_functions(
    clip_params,
    cfg: CLIPConfig,
    pcfg: Optional[PromptConfig] = None,
    trainable=None,
    bank=None,
    *,
    batch: int = 8,
    functions: Iterable[str] = ("encode_image", "encode_text"),
    symbolic_batch: bool = False,
) -> Dict[str, "torch.export.ExportedProgram"]:
    """Trace + export the named functions under ``torch.no_grad()``;
    returns ``{name: ExportedProgram}``.

    The programs are traced on the device the parameters live on (a
    program is moved at load time, :func:`load_exported`).  ``symbolic_batch``
    makes the batch dimension symbolic so one artifact covers every batch
    size: it requires ``cfg.attn_impl='xla'``, as in the JAX module (the
    port's ``"xla"`` is the plain composition).
    """
    pcfg = pcfg or PromptConfig()
    functions = tuple(functions)
    for name in functions:
        if name not in EXPORTABLE_FUNCTIONS:
            raise ValueError(f"unknown export function {name!r}; expected one of {EXPORTABLE_FUNCTIONS}")
    device = _device_of(clip_params)
    if symbolic_batch and cfg.attn_impl not in ("xla",):
        raise ValueError(
            "symbolic_batch requires attn_impl='xla' (the kernels' exports are static-shape, one "
            f"artifact per batch size, as in the JAX package); got attn_impl={cfg.attn_impl!r}"
        )
    if pcfg.image_conditioned and "classify" in functions:
        raise ValueError(
            "classify cannot be exported for image_conditioned (CoCoOp) "
            "models: text features are per-(sample, class), so a cached "
            "class-feature program serves wrong logits — export "
            "'full_forward' instead (it applies the meta-net conditioning)"
        )
    if cfg.vision_tower == "resnet" and {"encode_image", "classify", "full_forward"} & set(functions):
        raise ValueError(
            "the RN-family image tower holds IEEE f32 convolutions by switching cuDNN's TF32 off around "
            "each eager call; an exported graph does not carry that switch, so it is not exported"
        )
    out: Dict[str, Any] = {}
    for name in functions:
        args = _canonical(_example_args(name, cfg, clip_params, trainable, bank, batch, device))
        dynamic = None
        if symbolic_batch:
            b = torch.export.Dim("batch", min=1)
            # images / tokens is always the last operand
            dynamic = (tuple(torch.utils._pytree.tree_map(lambda _: None, a) for a in args[:-1]) + ({0: b},),)
        with torch.no_grad():
            ep = torch.export.export(_Program(_build_fn(name, cfg, pcfg)), args, dynamic_shapes=dynamic,
                                     strict=False)
        ep.example_inputs = None  # torch.export.save would write them, the parameters with them
        out[name] = ep
    return out


def _specs(ep, kind: str):
    """``["float32[2, 32, 32, 3]", ...]``: the user inputs' or outputs' specs."""
    sig = ep.graph_signature
    names = set(sig.user_inputs if kind == "in" else sig.user_outputs)
    nodes = [n for n in ep.graph.nodes if n.op == "placeholder" and n.name in names] if kind == "in" else [
        a for a in ep.graph.output_node().args[0] if getattr(a, "name", None) in names]
    return [f"{str(n.meta['val'].dtype).replace('torch.', '')}{list(n.meta['val'].shape)}" for n in nodes]


def save_exported(
    outdir: str,
    exported: Dict[str, "torch.export.ExportedProgram"],
    cfg: Optional[CLIPConfig] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Serialize each program to ``outdir/<function>.pt2`` and write the manifest."""
    os.makedirs(outdir, exist_ok=True)
    manifest: Dict[str, Any] = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "functions": {},
    }
    if cfg is not None:
        manifest["model_config"] = dataclasses.asdict(cfg)
    if extra:
        manifest.update(extra)
    devices = set()
    for name, ep in exported.items():
        path = os.path.join(outdir, name + _SUFFIX)
        torch.export.save(ep, path)
        device = next((str(n.meta["val"].device.type) for n in ep.graph.nodes if n.op == "placeholder"), "cpu")
        devices.add(device)
        manifest["functions"][name] = {
            "file": name + _SUFFIX,
            "bytes": os.path.getsize(path),
            "device": device,
            "tapclip_ops": sorted({str(n.target) for n in ep.graph.nodes
                                   if n.op == "call_function" and str(n.target).startswith("tapclip.")}),
            "in_specs": _specs(ep, "in"),
            "out_specs": _specs(ep, "out"),
        }
    manifest["device"] = devices.pop() if len(devices) == 1 else sorted(devices)
    with open(os.path.join(outdir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return outdir


def load_exported(path: str, device=None, functions: Optional[Iterable[str]] = None) -> Dict[str, Callable]:
    """Load an export directory; returns ``{name: fn}``.

    Needs torch and the ``tapclip`` op registrations only: each fn calls the
    program's module (``fn.module``) with the plain-container arguments the
    manifest documents.  ``device`` (e.g. ``"cuda"``) moves every program
    there first, the devices its graph names included.  ``functions`` loads
    only those (default: every one in the manifest).
    """
    fns: Dict[str, Callable] = {}
    listed = load_manifest(path)["functions"]
    for name in listed if functions is None else functions:
        meta = listed[name]
        ep = torch.export.load(os.path.join(path, meta["file"]))
        if device is not None:
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, device)
        fns[name] = _Loaded(ep.module())
    return fns


class _Loaded:
    """A loaded program, called with its arguments' dict keys sorted."""

    def __init__(self, module):
        self.module = module

    def __call__(self, *args):
        return self.module(*_canonical(args))


def load_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        return json.load(f)


def export_model(
    outdir: str,
    clip_params,
    cfg: CLIPConfig,
    pcfg: Optional[PromptConfig] = None,
    trainable=None,
    bank=None,
    *,
    batch: int = 8,
    functions: Iterable[str] = ("encode_image", "encode_text"),
    symbolic_batch: bool = False,
) -> str:
    """One-call convenience: trace, export, serialize, manifest."""
    exported = export_functions(
        clip_params,
        cfg,
        pcfg,
        trainable,
        bank,
        batch=batch,
        functions=functions,
        symbolic_batch=symbolic_batch,
    )
    extra = {"batch": None if symbolic_batch else batch}
    return save_exported(outdir, exported, cfg, extra)
