"""On-device image corruptions (the ImageNet-C robustness protocol).

Counterpart of ``tapclip_tpu/utils/corruptions.py``: Hendrycks & Dietterich
(2019) corruptions applied to a uint8 batch on the device (uint8 -> [0, 1]
-> corrupt -> CLIP normalization -> tower), so the val set is decoded and
copied once and re-corrupted for every (corruption, severity).  Severity is
1..5; the constants are the JAX package's (the reference implementation's,
github.com/hendrycks/robustness, where the operation translates directly).

The noise family (gaussian / shot / impulse) draws from an explicit
``torch.Generator`` on the batch's device; blur (gaussian) and the digital
family (contrast / brightness / saturate / pixelate) are deterministic.  Two
torch idioms stand in for JAX's: the blur pads by repeating the edge
(``jnp.pad(mode="edge")``), and ``pixelate`` shrinks with an antialiased
bilinear resize (``jax.image.resize(..., "linear")`` antialiases when it
shrinks: ``F.interpolate(mode="bilinear", antialias=True)``) and grows back
by nearest neighbour on half-pixel centres (``"nearest-exact"``, not
``"nearest"``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

SEVERITIES = (1, 2, 3, 4, 5)


def _sev(table, severity: int, like: torch.Tensor) -> torch.Tensor:
    """The f32 constant of ``severity`` (clamped to 1..len(table))."""
    return torch.tensor(table[min(max(int(severity), 1), len(table)) - 1], dtype=torch.float32, device=like.device)


def gaussian_noise(x, severity, rng):
    sigma = _sev((0.08, 0.12, 0.18, 0.26, 0.38), severity, x)
    noise = torch.randn(x.shape, generator=rng, device=x.device, dtype=x.dtype)
    return torch.clamp(x + sigma * noise, 0.0, 1.0)


def shot_noise(x, severity, rng):
    """Poisson photon counts at rate ``x * lam`` by their gaussian
    approximation ``N(x lam, x lam)`` (the JAX package's form), rescaled."""
    lam = _sev((60.0, 25.0, 12.0, 5.0, 3.0), severity, x)
    mean = x * lam
    noise = torch.randn(x.shape, generator=rng, device=x.device, dtype=x.dtype)
    noisy = mean + torch.sqrt(torch.clamp(mean, min=1e-6)) * noise
    return torch.clamp(noisy / lam, 0.0, 1.0)


def impulse_noise(x, severity, rng):
    p = _sev((0.03, 0.06, 0.09, 0.17, 0.27), severity, x)
    u = torch.rand(x.shape, generator=rng, device=x.device, dtype=x.dtype)
    salt = (torch.rand(x.shape, generator=rng, device=x.device, dtype=x.dtype) < 0.5).to(x.dtype)
    return torch.where(u < p, salt, x)


def gaussian_blur(x, severity, rng=None):
    """Separable gaussian blur with a 21-tap kernel (taps past about 3 sigma
    weigh about 0, so one width covers every severity), edges repeated."""
    sigma = _sev((1.0, 2.0, 3.0, 4.0, 6.0), severity, x)
    R = 10
    t = torch.arange(-R, R + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = k / k.sum()

    def blur_axis(img, axis):
        moved = img.movedim(axis, -1)  # [..., L]
        L = moved.shape[-1]
        idx = torch.arange(L, device=x.device)[:, None] + torch.arange(2 * R + 1, device=x.device)[None, :] - R
        windows = moved[..., idx.clamp(0, L - 1)]  # [..., L, 2R+1]: edge padding
        return (windows @ k).movedim(-1, axis)

    return torch.clamp(blur_axis(blur_axis(x, 1), 2), 0.0, 1.0)


def contrast(x, severity, rng=None):
    c = _sev((0.4, 0.3, 0.2, 0.1, 0.05), severity, x)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp((x - mean) * c + mean, 0.0, 1.0)


def brightness(x, severity, rng=None):
    return torch.clamp(x + _sev((0.1, 0.2, 0.3, 0.4, 0.5), severity, x), 0.0, 1.0)


def saturate(x, severity, rng=None):
    s = _sev((0.3, 0.1, 2.0, 5.0, 10.0), severity, x)
    gray = x.mean(dim=-1, keepdim=True)
    return torch.clamp(gray + (x - gray) * s, 0.0, 1.0)


def pixelate(x, severity, rng=None):
    """Shrink (antialiased bilinear) then grow back (nearest, half-pixel
    centres) to the input size."""
    factor = (0.6, 0.5, 0.4, 0.3, 0.25)[min(max(int(severity), 1), 5) - 1]
    B, H, W, C = x.shape
    h, w = max(1, int(H * factor)), max(1, int(W * factor))
    nchw = x.permute(0, 3, 1, 2)
    down = F.interpolate(nchw, size=(h, w), mode="bilinear", antialias=True, align_corners=False)
    up = F.interpolate(down, size=(H, W), mode="nearest-exact")
    return torch.clamp(up.permute(0, 2, 3, 1), 0.0, 1.0)


CORRUPTIONS: Dict[str, Callable] = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "gaussian_blur": gaussian_blur,
    "contrast": contrast,
    "brightness": brightness,
    "saturate": saturate,
    "pixelate": pixelate,
}

# Corruptions that consume randomness (rng is otherwise ignored).
STOCHASTIC = frozenset({"gaussian_noise", "shot_noise", "impulse_noise"})


def corrupt(images01: torch.Tensor, name: str, severity: int, rng=None) -> torch.Tensor:
    """Apply corruption ``name`` to a ``[B, H, W, 3]`` batch in [0, 1].
    The stochastic corruptions need ``rng``, a ``torch.Generator`` on the
    batch's device."""
    if name not in CORRUPTIONS:
        raise KeyError(f"unknown corruption {name!r}; have {sorted(CORRUPTIONS)}")
    if name in STOCHASTIC and rng is None:
        raise ValueError(f"corruption {name!r} requires an rng (a torch.Generator)")
    return CORRUPTIONS[name](images01, severity, rng)


def corrupt_uint8_normalized(images_u8: torch.Tensor, name: str, severity: int, rng=None) -> torch.Tensor:
    """uint8 batch -> corrupt in [0, 1] -> CLIP-normalized f32, the corrupt
    counterpart of ``data.preprocess.device_normalize``."""
    from tapclip_tpu_torch.data.preprocess import _MEAN, _STD

    x = corrupt(images_u8.to(torch.float32) / 255.0, name, severity, rng)
    return (x - torch.as_tensor(_MEAN, device=x.device)) / torch.as_tensor(_STD, device=x.device)
