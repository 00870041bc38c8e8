"""Image preprocessing (CLIP eval transform), host side and on the device.

The host-side functions are copies of ``tapclip_tpu/data/preprocess.py``
(PIL + NumPy, NHWC float32): ``Resize(n_px, bicubic)`` of the shorter side
with torchvision's truncating size rule -> ``CenterCrop(n_px)`` ->
``[0, 1]`` -> CLIP mean/std.  ``device_normalize`` is the torch form of the
JAX package's on-device normalization, bit-compatible with it: uint8 pixels
cross to the device and ``(x / 255 - mean) / std`` runs there in f32.
"""

from __future__ import annotations

import numpy as np
import torch

from tapclip_tpu_torch.config import IMAGE_MEAN, IMAGE_STD

try:
    from PIL import Image

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    Image = None
    _HAS_PIL = False

_MEAN = np.asarray(IMAGE_MEAN, np.float32)
_STD = np.asarray(IMAGE_STD, np.float32)


def resize_shorter_side(img: "Image.Image", size: int) -> "Image.Image":
    """torchvision.Resize(int) semantics: shorter side -> size, keep aspect."""
    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, int(size * h / w))
    else:
        new_w, new_h = max(1, int(size * w / h)), size
    return img.resize((new_w, new_h), Image.BICUBIC)


def center_crop(img: "Image.Image", size: int) -> "Image.Image":
    w, h = img.size
    left = round((w - size) / 2.0)
    top = round((h - size) / 2.0)
    return img.crop((left, top, left + size, top + size))


def normalize(arr01: np.ndarray) -> np.ndarray:
    """[0,1] float array (..., 3) -> CLIP-normalized."""
    return (arr01 - _MEAN) / _STD


def preprocess_pil(
    img: "Image.Image", image_size: int = 224, do_normalize: bool = True
) -> np.ndarray:
    """PIL image -> ``[image_size, image_size, 3]`` float32 NHWC slice."""
    img = img.convert("RGB")
    img = resize_shorter_side(img, image_size)
    img = center_crop(img, image_size)
    arr = np.asarray(img, np.float32) / 255.0
    if do_normalize:
        arr = normalize(arr)
    return arr.astype(np.float32)


def preprocess_path(path: str, image_size: int = 224, do_normalize: bool = True) -> np.ndarray:
    if not _HAS_PIL:
        raise RuntimeError("PIL is required for image loading")
    with Image.open(path) as img:
        return preprocess_pil(img, image_size, do_normalize)


def make_preprocess(image_size: int = 224, do_normalize: bool = True):
    """Path or PIL image -> preprocessed float32 NHWC slice."""

    def _fn(img):
        if isinstance(img, str):
            return preprocess_path(img, image_size, do_normalize)
        return preprocess_pil(img, image_size, do_normalize)

    return _fn


def preprocess_pil_uint8(img: "Image.Image", image_size: int = 224) -> np.ndarray:
    """PIL image -> ``[S, S, 3]`` uint8 (resize + crop only, no normalize)."""
    img = img.convert("RGB")
    img = resize_shorter_side(img, image_size)
    img = center_crop(img, image_size)
    return np.asarray(img, np.uint8)


def make_preprocess_uint8(image_size: int = 224):
    """Path or PIL image -> ``[S, S, 3]`` uint8 (resize + crop, no normalize);
    the loader's ``output_dtype="uint8"`` path, normalized on the device."""

    def _fn(img):
        if isinstance(img, str):
            if not _HAS_PIL:
                raise RuntimeError("PIL is required for image loading")
            with Image.open(img) as im:
                return preprocess_pil_uint8(im, image_size)
        return preprocess_pil_uint8(img, image_size)

    return _fn


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC batch -> CLIP-normalized f32 on the batch's device.

    ``(x / 255 - mean) / std`` in f32, the same operations in the same order
    as the host pipeline and the JAX package's ``device_normalize``.
    """
    x = images.to(torch.float32) / 255.0
    mean = torch.as_tensor(_MEAN, device=images.device)
    std = torch.as_tensor(_STD, device=images.device)
    return (x - mean) / std
