"""On-device image augmentation: random resized crop + horizontal flip.

Counterpart of ``tapclip_tpu/data/augment.py``.  Every shape is static: each
sample's crop box varies by its sampling coordinates, not by array size, and
the resample is a separable bilinear gather (rows, then columns) with the
``align_corners=False`` convention and coordinates clamped to the image.
The box is clamped to the image instead of torchvision's retry loop.
``F.grid_sample`` is not used: its border handling and rounding differ.

The draw (:func:`draw_boxes`: area, log-ratio, x0, y0, flip) is apart from
the resample (:func:`resample_boxes`), so a caller can resample from boxes
drawn elsewhere.  The resample commutes with CLIP's per-channel
normalization (the bilinear weights sum to 1), so it runs on normalized
images too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Random-resized-crop + horizontal-flip parameters (open_clip's train
    transform by default: ``scale=(0.9, 1.0)``, no flip)."""

    scale: Tuple[float, float] = (0.9, 1.0)  # crop area fraction range
    ratio: Tuple[float, float] = (1.0, 1.0)  # aspect ratio range (log-uniform)
    hflip: float = 0.0  # horizontal flip probability


def _axis_coords(start: torch.Tensor, size: torch.Tensor, n_out: int) -> torch.Tensor:
    """``[B, n_out]`` source coordinates of one axis: output pixel ``j``
    samples ``start + (j + 0.5) * size / n_out - 0.5``."""
    j = torch.arange(n_out, dtype=torch.float32, device=start.device)[None, :]
    return start[:, None] + (j + 0.5) * (size[:, None] / n_out) - 0.5


def _gather_lerp(x: torch.Tensor, coords: torch.Tensor, axis: int) -> torch.Tensor:
    """Bilinear resample of ``x [B, H, W, C]`` along ``axis`` (1 or 2) at
    per-sample ``coords [B, n_out]``, clamped to the image."""
    n_src = x.shape[axis]
    c = coords.clamp(0.0, n_src - 1)
    i0 = torch.floor(c).long()
    i1 = (i0 + 1).clamp(max=n_src - 1)
    frac = (c - i0.float()).to(x.dtype)
    shape = [coords.shape[0], 1, 1, 1]
    shape[axis] = coords.shape[1]
    out_shape = list(x.shape)
    out_shape[axis] = coords.shape[1]
    lo = torch.gather(x, axis, i0.reshape(shape).expand(out_shape))
    hi = torch.gather(x, axis, i1.reshape(shape).expand(out_shape))
    return lo + (hi - lo) * frac.reshape(shape)


def draw_boxes(generator: torch.Generator, B: int, H: int, W: int, cfg: AugmentConfig,
               device=None) -> Dict[str, torch.Tensor]:
    """Per-sample crop boxes ``{"x0", "y0", "w", "h", "flip"}`` (each ``[B]``):
    area uniform in ``scale * H * W``, aspect ratio log-uniform in ``ratio``,
    the box clamped to the image, its corner uniform over the room left, a
    flip with probability ``hflip``.  Drawn on ``generator``'s device, moved
    to ``device``."""
    def uniform(lo=0.0, hi=1.0):
        u = torch.rand((B,), generator=generator, device=generator.device, dtype=torch.float32)
        return u * (hi - lo) + lo

    area = uniform(*cfg.scale) * (H * W)
    ar = torch.exp(uniform(math.log(cfg.ratio[0]), math.log(cfg.ratio[1])))
    w = torch.sqrt(area * ar).clamp(1.0, float(W))
    h = torch.sqrt(area / ar).clamp(1.0, float(H))
    x0 = uniform() * (W - w)
    y0 = uniform() * (H - h)
    flip = uniform() < cfg.hflip
    boxes = {"x0": x0, "y0": y0, "w": w, "h": h, "flip": flip}
    return {k: v.to(device or generator.device) for k, v in boxes.items()}


def resample_boxes(images: torch.Tensor, boxes: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Crop each sample of ``images [B, H, W, C]`` (float) to its box and
    resample it back to ``(H, W)``, rows then columns; flip where
    ``boxes["flip"]``."""
    B, H, W, _ = images.shape
    dev = images.device
    out = _gather_lerp(images, _axis_coords(boxes["y0"].to(dev), boxes["h"].to(dev), H), axis=1)
    out = _gather_lerp(out, _axis_coords(boxes["x0"].to(dev), boxes["w"].to(dev), W), axis=2)
    return torch.where(boxes["flip"].to(dev)[:, None, None, None], out.flip(2), out)


def augment_batch(generator: torch.Generator, images: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    """Random-resized-crop (+ optional h-flip) a batch per sample: the same
    shape out, the boxes drawn from ``generator``."""
    B, H, W, _ = images.shape
    return resample_boxes(images, draw_boxes(generator, B, H, W, cfg, device=images.device))
