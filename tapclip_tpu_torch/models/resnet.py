"""ModifiedResNet image tower (the CLIP RN50 family).

Counterpart of ``tapclip_tpu/models/resnet.py``: CLIP's ``ModifiedResNet``
as open_clip builds it for ``RN50``, ``RN101`` and the scaled ``RN50x*``: a
3-conv stem (the first at stride 2) and an average pool, Bottleneck blocks
whose stride-2 is an average pool before ``conv3`` (and on the identity
branch), and an ``AttentionPool2d`` head (a mean token prepended, a
positional embedding over ``(image_size // 32)^2 + 1`` tokens, separate
q/k/v/c projections, ``vision_width * 32 // 64`` heads, the port's plain
``ops/attention.attention_reference``).  BatchNorm is frozen (inference
mode) and applied as an f32-derived scale and shift, eps 1e-5.

Layout: images arrive NHWC ``[B, H, W, 3]`` as everywhere in the port and
are viewed as NCHW with channels-last strides; convolution weights are
OIHW ``[out, in, kh, kw]`` (open_clip's own layout; the JAX package stores
HWIO, and ``utils/jax_bridge`` transposes).  The JAX package computes the
convolutions outside any Pallas kernel (``lax.conv_general_dilated``), so
here they are ``torch.nn.functional.conv2d`` on operands widened to f32
with the weights rounded to the compute dtype first, as ``layers.dense``
does for products.

f32 semantics: cuDNN runs f32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is ``True``, unlike matmul), which
rounds the operands to 10 mantissa bits.  The tower turns TF32 off for its
own forward only (:func:`ieee_f32_convolutions`) and restores the caller's
setting on return, so its f32 features match the plain f32 reference to
f32 rounding, whatever the caller set.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict

import torch
import torch.nn.functional as F

from tapclip_tpu_torch.config import CLIPConfig
from tapclip_tpu_torch.models import layers

Params = Dict[str, Any]

BN_EPS = 1e-5
_TF32_LOCK = threading.Lock()


@contextlib.contextmanager
def ieee_f32_convolutions():
    """cuDNN's TF32 off for the enclosed convolutions, the caller's setting
    restored after.  The switch is process-wide, so one tower forward at a
    time holds it (a lock), and a second thread cannot restore it under a
    running forward."""
    with _TF32_LOCK:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Init (random: real weights come from utils/torch_convert)
# ---------------------------------------------------------------------------


def init_resnet_params(generator: torch.Generator, cfg: CLIPConfig, device=None) -> Params:
    """Random ModifiedResNet visual tree (``cfg.resnet_layers``), with the
    JAX init's shapes and scales: convolutions N(0, fan_in^-1/2), BatchNorm
    at identity statistics, the attention pool's projections N(0, C^-1/2)
    with zero biases.  Values are drawn on ``generator``'s device."""
    gen_device = generator.device
    device = gen_device if device is None else torch.device(device)

    def normal(*shape, std):
        t = torch.randn(shape, generator=generator, device=gen_device, dtype=torch.float32)
        return (t * std).to(device)

    def conv(cin, cout, k):
        return {"w": normal(cout, cin, k, k, std=(k * k * cin) ** -0.5)}

    def bn(c):
        return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device),
                "mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}

    width = cfg.vision_width
    p: Params = {
        "conv1": conv(3, width // 2, 3), "bn1": bn(width // 2),
        "conv2": conv(width // 2, width // 2, 3), "bn2": bn(width // 2),
        "conv3": conv(width // 2, width, 3), "bn3": bn(width),
    }
    inplanes = width
    for li, (n_blocks, planes, stride) in enumerate(
        zip(cfg.resnet_layers, (width, width * 2, width * 4, width * 8), (1, 2, 2, 2))
    ):
        blocks = []
        for b in range(n_blocks):
            s = stride if b == 0 else 1
            blk = {
                "conv1": conv(inplanes, planes, 1), "bn1": bn(planes),
                "conv2": conv(planes, planes, 3), "bn2": bn(planes),
                "conv3": conv(planes, planes * 4, 1), "bn3": bn(planes * 4),
            }
            if s > 1 or inplanes != planes * 4:
                blk["downsample"] = {"conv": conv(inplanes, planes * 4, 1), "bn": bn(planes * 4)}
            blocks.append(blk)
            inplanes = planes * 4
        p[f"layer{li + 1}"] = blocks
    embed = width * 32

    def linear(n_out):  # torch Linear layout [out, in]
        return {"w": normal(n_out, embed, std=embed ** -0.5), "b": torch.zeros(n_out, device=device)}

    p["attnpool"] = {
        "positional_embedding": normal((cfg.image_size // 32) ** 2 + 1, embed, std=embed ** -0.5),
        "q_proj": linear(embed), "k_proj": linear(embed), "v_proj": linear(embed),
        "c_proj": linear(cfg.embed_dim),
    }
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _conv(x: torch.Tensor, p: Params, stride: int = 1) -> torch.Tensor:
    """``x [B, C, H, W]`` convolved with ``p["w"]`` (OIHW), padding
    ``(k-1)//2``: f32 accumulation, the result in ``x.dtype``."""
    w = p["w"]
    y = F.conv2d(x.float(), w.to(x.dtype).float(), stride=stride, padding=(w.shape[-1] - 1) // 2)
    return y.to(x.dtype)


def _bn(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Frozen BatchNorm as a scale and shift computed in f32, applied in
    ``x.dtype``."""
    inv = torch.rsqrt(p["var"].float() + BN_EPS)
    scale = p["scale"].float() * inv
    shift = p["bias"].float() - p["mean"].float() * scale
    return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def _bottleneck(x: torch.Tensor, p: Params, stride: int) -> torch.Tensor:
    # F.avg_pool2d(x, k): window = stride = k, VALID (the tail rows and
    # columns are cropped), the JAX package's reshape-mean.
    out = torch.relu(_bn(_conv(x, p["conv1"]), p["bn1"]))
    out = torch.relu(_bn(_conv(out, p["conv2"]), p["bn2"]))
    if stride > 1:
        out = F.avg_pool2d(out, stride)
    out = _bn(_conv(out, p["conv3"]), p["bn3"])
    idn = x
    if "downsample" in p:
        idn = F.avg_pool2d(x, stride) if stride > 1 else x
        idn = _bn(_conv(idn, p["downsample"]["conv"]), p["downsample"]["bn"])
    return torch.relu(out + idn)


def pool_tokens(x: torch.Tensor, p: Params) -> torch.Tensor:
    """The attention pool's tokens: ``[B, C, h, w]`` -> ``[B, 1 + h*w, C]``,
    the spatial mean first, plus the positional embedding."""
    t = x.flatten(2).transpose(1, 2)  # [B, hw, C]
    t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1)
    return t + p["positional_embedding"].to(t.dtype)[None]


def pool_heads(t: torch.Tensor, p: Params, n_heads: int):
    """The mean token's query and every token's key and value,
    ``[B, heads, T, Dh]`` each."""
    B, T, C = t.shape

    def heads(a):
        return a.reshape(B, a.shape[1], n_heads, C // n_heads).transpose(1, 2)

    def proj(v, name):
        return layers.dense(v, p[name]["w"].T, p[name]["b"])

    return heads(proj(t[:, :1], "q_proj")), heads(proj(t, "k_proj")), heads(proj(t, "v_proj"))


def _attention_pool(x: torch.Tensor, p: Params, n_heads: int) -> torch.Tensor:
    """CLIP's AttentionPool2d: the mean token's query over the ``hw + 1``
    keys, then the output projection."""
    from tapclip_tpu_torch.ops.attention import attention_reference

    t = pool_tokens(x, p)
    out, _ = attention_reference(*pool_heads(t, p, n_heads))  # [B, heads, 1, Dh]
    return layers.dense(out.transpose(1, 2).reshape(t.shape[0], -1), p["c_proj"]["w"].T, p["c_proj"]["b"])


def resnet_feature_map(params: Params, cfg: CLIPConfig, images: torch.Tensor) -> torch.Tensor:
    """The backbone: preprocessed images ``[B, H, W, 3]`` -> the map before
    the attention pool, ``[B, C, h, w]`` (``h = w = image_size // 32``),
    for the saliency readout (``utils/saliency.py``) as for the pool."""
    p = params["visual"]
    x = images.to(cfg.compute_dtype).permute(0, 3, 1, 2)  # NCHW, channels-last strides
    with ieee_f32_convolutions():
        x = torch.relu(_bn(_conv(x, p["conv1"], stride=2), p["bn1"]))
        x = torch.relu(_bn(_conv(x, p["conv2"]), p["bn2"]))
        x = torch.relu(_bn(_conv(x, p["conv3"]), p["bn3"]))
        x = F.avg_pool2d(x, 2)
        for li in range(4):
            stride = 1 if li == 0 else 2
            for b, bp in enumerate(p[f"layer{li + 1}"]):
                x = _bottleneck(x, bp, stride if b == 0 else 1)
    return x


def attnpool_heads(cfg: CLIPConfig) -> int:
    return cfg.vision_width * 32 // 64


def resnet_encode_image(params: Params, cfg: CLIPConfig, images: torch.Tensor) -> torch.Tensor:
    """Preprocessed images ``[B, H, W, 3]`` -> features ``[B, embed_dim]``
    (the caller L2-normalizes)."""
    x = resnet_feature_map(params, cfg, images)
    return _attention_pool(x, params["visual"]["attnpool"], attnpool_heads(cfg))
