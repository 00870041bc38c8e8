"""Weight conversion between open_clip / reference checkpoints and the port.

Counterpart of ``tapclip_tpu/utils/torch_convert.py`` for ViT towers (the
RN-family towers wait with ``models/resnet.py``):

* :func:`convert_openclip_state_dict` — open_clip state dict -> the port's
  parameter tree, straight into its layout: a tower's blocks are a list of
  per-block dicts (``utils/jax_bridge.py``), Linear weights transposed to
  the ``x @ w`` convention, the fused ``in_proj_weight`` transposed so its
  columns are ``[q | k | v]``, the patch convolution permuted to (ph, pw, c)
  row order.  It only transposes and copies, so it equals the JAX
  package's converter bridged by ``params_from_jax`` leaf by leaf, bit for
  bit; :func:`resize_pos_embed` is the same float64 numpy arithmetic.
* :func:`load_torch_file` / :func:`load_openclip_checkpoint` — ``.pt`` /
  ``.bin`` files (``weights_only=True``), the ``state_dict`` nesting and
  the ``module.`` prefix.
* :func:`convert_prompt_state_dict` — both reference prompt layouts (legacy
  stacked ``prompt_learner.context_emb``, per-class ``context_bank``).
* the exports, the exact inverses: :func:`export_openclip_state_dict`,
  :func:`save_openclip_checkpoint`, :func:`export_prompt_state_dict`,
  :func:`save_reference_prompt_checkpoint`.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tapclip_tpu_torch.config import CLIPConfig


def _numpy(v):
    if isinstance(v, dict):
        return {k: _numpy(x) for k, x in v.items()}
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def load_torch_file(path: str) -> Dict[str, Any]:
    """Load a torch checkpoint to a ``{key: np.ndarray}`` dict (a nested
    dict, such as a ``state_dict`` entry, stays a dict)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    return _numpy(state)


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A copy (never a view of the caller's array) as an f32 tensor on ``device``."""
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device)


def _convert_block(sd: Dict[str, np.ndarray], prefix: str, device) -> Dict[str, Any]:
    """One open_clip ResidualAttentionBlock -> the port's block dict."""

    def t(key, transpose=False):
        a = _f32(sd[f"{prefix}.{key}"])
        return _tensor(a.T if transpose else a, device)

    return {
        "ln_1": {"scale": t("ln_1.weight"), "bias": t("ln_1.bias")},
        "attn": {
            # torch packs [q; k; v] along the out dim of in_proj_weight
            # [3W, W]; transposed, its columns are [q | k | v].
            "w_qkv": t("attn.in_proj_weight", True),
            "b_qkv": t("attn.in_proj_bias"),
            "w_out": t("attn.out_proj.weight", True),
            "b_out": t("attn.out_proj.bias"),
        },
        "ln_2": {"scale": t("ln_2.weight"), "bias": t("ln_2.bias")},
        "mlp": {
            "w_fc": t("mlp.c_fc.weight", True),
            "b_fc": t("mlp.c_fc.bias"),
            "w_proj": t("mlp.c_proj.weight", True),
            "b_proj": t("mlp.c_proj.bias"),
        },
    }


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel with a=-0.75 (PyTorch's bicubic)."""
    x = np.abs(x)
    return np.where(
        x <= 1.0,
        (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0,
        np.where(x < 2.0, a * (x ** 3 - 5.0 * x ** 2 + 8.0 * x - 4.0), 0.0),
    )


def _resize_axis_cubic(arr: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """1-D cubic resample along ``axis`` with half-pixel centers and
    border-clamped taps (``F.interpolate(mode='bicubic',
    align_corners=False)`` applied separably), in float64."""
    in_size = arr.shape[axis]
    if in_size == out_size:
        return arr
    arr = np.moveaxis(np.asarray(arr, np.float64), axis, 0)
    scale = in_size / out_size
    coords = (np.arange(out_size) + 0.5) * scale - 0.5
    base = np.floor(coords).astype(np.int64)
    acc = np.zeros((out_size,) + arr.shape[1:], np.float64)
    for tap in (-1, 0, 1, 2):
        idx = np.clip(base + tap, 0, in_size - 1)
        w = _cubic_kernel(coords - (base + tap))
        acc += w.reshape((out_size,) + (1,) * (arr.ndim - 1)) * arr[idx]
    return np.moveaxis(acc, 0, axis)


def resize_pos_embed(pos: np.ndarray, target_len: int) -> np.ndarray:
    """Adapt a ``[1 + g*g, W]`` vision positional embedding to a new grid
    (``target_len = 1 + g'*g'``): the class-token row is kept, the grid rows
    are bicubic-resampled as a ``[g, g, W]`` image.  For checkpoints loaded
    at another resolution than they were trained at (ViT-L/14 224 px
    weights into ViT-L-14-336)."""
    if pos.shape[0] == target_len:
        return _f32(pos)
    g_in = int(round((pos.shape[0] - 1) ** 0.5))
    g_out = int(round((target_len - 1) ** 0.5))
    if g_in * g_in + 1 != pos.shape[0] or g_out * g_out + 1 != target_len:
        raise ValueError(
            f"cannot resize pos embed {pos.shape[0]} -> {target_len}: both must be 1 + square-grid"
        )
    cls_row, grid = pos[:1], pos[1:].reshape(g_in, g_in, -1)
    grid = _resize_axis_cubic(grid, g_out, 0)
    grid = _resize_axis_cubic(grid, g_out, 1)
    return np.concatenate([_f32(cls_row), grid.reshape(g_out * g_out, -1).astype(np.float32)])


def _ln(sd, key, device) -> Dict[str, torch.Tensor]:
    return {"scale": _tensor(_f32(sd[f"{key}.weight"]), device), "bias": _tensor(_f32(sd[f"{key}.bias"]), device)}


def convert_openclip_state_dict(sd: Dict[str, Any], cfg: CLIPConfig, device="cpu") -> Dict[str, Any]:
    """open_clip CLIP state dict (numpy or tensor values) -> the port's
    parameter tree (f32 tensors on ``device``)."""
    if cfg.vision_tower == "resnet":
        raise NotImplementedError("RN-family towers are not yet ported in tapclip_tpu_torch")
    conv_w = _f32(sd["visual.conv1.weight"])  # [O, C, kh, kw]
    O, C, kh, kw = conv_w.shape
    if kh != cfg.patch_size:
        raise ValueError(f"checkpoint patch size {kh} != config patch size {cfg.patch_size}")
    patch_w = conv_w.transpose(2, 3, 1, 0).reshape(kh * kw * C, O)
    visual = {
        "patch_embed": {"w": _tensor(patch_w, device)},
        "class_embedding": _tensor(_f32(sd["visual.class_embedding"]), device),
        "positional_embedding": _tensor(
            resize_pos_embed(_f32(sd["visual.positional_embedding"]), cfg.vision_seq_len), device),
        "ln_pre": _ln(sd, "visual.ln_pre", device),
        "blocks": [_convert_block(sd, f"visual.transformer.resblocks.{i}", device)
                   for i in range(cfg.vision_layers)],
        "ln_post": _ln(sd, "visual.ln_post", device),
        "proj": _tensor(_f32(sd["visual.proj"]), device),
    }
    text = {
        "token_embedding": _tensor(_f32(sd["token_embedding.weight"]), device),
        "positional_embedding": _tensor(_f32(sd["positional_embedding"]), device),
        "blocks": [_convert_block(sd, f"transformer.resblocks.{i}", device) for i in range(cfg.text_layers)],
        "ln_final": _ln(sd, "ln_final", device),
        "text_projection": _tensor(_f32(sd["text_projection"]), device),
    }
    return {"visual": visual, "text": text,
            "logit_scale": _tensor(_f32(sd["logit_scale"]).reshape(()), device)}


def load_openclip_checkpoint(path: str, cfg: CLIPConfig, device="cpu") -> Dict[str, Any]:
    """``torch.load`` + convert (the reference's ``clip_wrapper.py:13-15``).
    A directory (an Orbax tree of the JAX package) raises."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an Orbax tree of the JAX package); tapclip_tpu_torch "
                         "reads open_clip .pt/.bin state dicts")
    sd = load_torch_file(path)
    # open_clip sometimes nests under 'state_dict' and prefixes 'module.'.
    if "state_dict" in sd and not any(k.startswith("visual.") for k in sd):
        sd = sd["state_dict"]
    sd = {re.sub(r"^module\.", "", k): v for k, v in sd.items()}
    return convert_openclip_state_dict(sd, cfg, device)


# ---------------------------------------------------------------------------
# Prompt checkpoints (reference FullModel state dicts)
# ---------------------------------------------------------------------------


def convert_prompt_state_dict(
    sd: Dict[str, Any], seen_class_names: Sequence[str]
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Reference FullModel state dict -> ``(ctx_by_name, extras)``.

    Both layouts the reference reads (``test_cross_domain.py:44-61``): the
    legacy stacked ``prompt_learner.context_emb [n_cls, P, D]``, split over
    ``seen_class_names`` in order, and per-class
    ``prompt_learner.context_bank.{name}`` entries.  ``extras`` carries
    ``logit_scale`` when present.
    """
    ctx_by_name: Dict[str, np.ndarray] = {}
    if "prompt_learner.context_emb" in sd:
        old_ctx = _f32(sd["prompt_learner.context_emb"])
        if old_ctx.ndim == 2:
            old_ctx = old_ctx[None]
        for i, name in enumerate(seen_class_names):
            if i < old_ctx.shape[0]:
                ctx_by_name[name] = old_ctx[i]
    prefix = "prompt_learner.context_bank."
    for k, v in sd.items():
        if k.startswith(prefix):
            ctx_by_name[k[len(prefix):]] = _f32(v)
    extras: Dict[str, np.ndarray] = {}
    if "logit_scale" in sd:
        extras["logit_scale"] = _f32(sd["logit_scale"]).reshape(())
    return ctx_by_name, extras


def load_reference_prompt_checkpoint(
    path: str, seen_class_names: Sequence[str]
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    return convert_prompt_state_dict(load_torch_file(path), seen_class_names)


# ---------------------------------------------------------------------------
# Export (port -> open_clip): the exact inverse of convert_openclip_state_dict
# ---------------------------------------------------------------------------


def _export_block(blk: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """The port's block dict -> open_clip resblock keys."""
    return {
        f"{prefix}.ln_1.weight": _f32(blk["ln_1"]["scale"]),
        f"{prefix}.ln_1.bias": _f32(blk["ln_1"]["bias"]),
        f"{prefix}.attn.in_proj_weight": _f32(blk["attn"]["w_qkv"]).T,
        f"{prefix}.attn.in_proj_bias": _f32(blk["attn"]["b_qkv"]),
        f"{prefix}.attn.out_proj.weight": _f32(blk["attn"]["w_out"]).T,
        f"{prefix}.attn.out_proj.bias": _f32(blk["attn"]["b_out"]),
        f"{prefix}.ln_2.weight": _f32(blk["ln_2"]["scale"]),
        f"{prefix}.ln_2.bias": _f32(blk["ln_2"]["bias"]),
        f"{prefix}.mlp.c_fc.weight": _f32(blk["mlp"]["w_fc"]).T,
        f"{prefix}.mlp.c_fc.bias": _f32(blk["mlp"]["b_fc"]),
        f"{prefix}.mlp.c_proj.weight": _f32(blk["mlp"]["w_proj"]).T,
        f"{prefix}.mlp.c_proj.bias": _f32(blk["mlp"]["b_proj"]),
    }


def export_openclip_state_dict(params: Dict[str, Any], cfg: CLIPConfig) -> Dict[str, np.ndarray]:
    """The port's parameter tree -> open_clip CLIP state dict (numpy values),
    the inverse of :func:`convert_openclip_state_dict`.  Keys with no
    open_clip slot are refused."""
    if cfg.vision_tower == "resnet":
        raise NotImplementedError("RN-family towers are not yet ported in tapclip_tpu_torch")
    extras = set(params) - {"visual", "text", "logit_scale", "logit_bias"}
    if extras:
        raise ValueError(f"param tree has no open_clip slot for {sorted(extras)}")
    v, t = params["visual"], params["text"]
    k = cfg.patch_size
    patch_w = _f32(v["patch_embed"]["w"])  # [kh*kw*C, O]
    sd: Dict[str, np.ndarray] = {
        "visual.conv1.weight": patch_w.reshape(k, k, 3, patch_w.shape[1]).transpose(3, 2, 0, 1),
        "visual.class_embedding": _f32(v["class_embedding"]),
        "visual.positional_embedding": _f32(v["positional_embedding"]),
        "visual.ln_pre.weight": _f32(v["ln_pre"]["scale"]),
        "visual.ln_pre.bias": _f32(v["ln_pre"]["bias"]),
    }
    for i, blk in enumerate(v["blocks"]):
        sd.update(_export_block(blk, f"visual.transformer.resblocks.{i}"))
    sd["visual.ln_post.weight"] = _f32(v["ln_post"]["scale"])
    sd["visual.ln_post.bias"] = _f32(v["ln_post"]["bias"])
    sd["visual.proj"] = _f32(v["proj"])
    for i, blk in enumerate(t["blocks"]):
        sd.update(_export_block(blk, f"transformer.resblocks.{i}"))
    sd["token_embedding.weight"] = _f32(t["token_embedding"])
    sd["positional_embedding"] = _f32(t["positional_embedding"])
    sd["ln_final.weight"] = _f32(t["ln_final"]["scale"])
    sd["ln_final.bias"] = _f32(t["ln_final"]["bias"])
    sd["text_projection"] = _f32(t["text_projection"])
    sd["logit_scale"] = _f32(params["logit_scale"]).reshape(())
    if "logit_bias" in params:
        sd["logit_bias"] = _f32(params["logit_bias"]).reshape(())
    return sd


def _save_arrays(sd: Dict[str, np.ndarray], path: str) -> str:
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    return path


def save_openclip_checkpoint(params: Dict[str, Any], cfg: CLIPConfig, path: str) -> str:
    """Export + ``torch.save`` as a plain open_clip state dict."""
    return _save_arrays(export_openclip_state_dict(params, cfg), path)


def export_prompt_state_dict(
    ctx,
    class_names: Sequence[str],
    *,
    logit_scale=None,
    legacy: bool = False,
) -> Dict[str, np.ndarray]:
    """Trained context vectors -> a reference-format prompt state dict, the
    inverse of :func:`convert_prompt_state_dict`.  ``ctx`` is the padded
    ``[C_max, P, D]`` stack; its first ``len(class_names)`` rows are real.
    ``legacy=True`` writes the stacked ``prompt_learner.context_emb``."""
    ctx = _f32(ctx)[: len(class_names)]
    if legacy:
        sd: Dict[str, np.ndarray] = {"prompt_learner.context_emb": ctx}
    else:
        sd = {f"prompt_learner.context_bank.{name}": ctx[i] for i, name in enumerate(class_names)}
    if logit_scale is not None:
        sd["logit_scale"] = _f32(logit_scale).reshape(())
    return sd


def save_reference_prompt_checkpoint(
    ctx,
    class_names: Sequence[str],
    path: str,
    *,
    logit_scale=None,
    legacy: bool = False,
) -> str:
    """Export + ``torch.save`` (a ``.pt`` the reference can ``torch.load``)."""
    return _save_arrays(
        export_prompt_state_dict(ctx, class_names, logit_scale=logit_scale, legacy=legacy), path)
