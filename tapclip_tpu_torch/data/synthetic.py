"""Synthetic data for tests and smoke runs.

Counterpart of ``tapclip_tpu/data/synthetic.py``.  No OfficeHome/DomainNet
data or pretrained weights ship with the repository, so tests run on
synthetic batches and on synthetic on-disk ImageFolder trees with the layout
the real datasets use (``root/ClassName/img.jpg``).  Both functions draw
from numpy's ``default_rng(seed)`` in the JAX package's order, so the two
packages write the same pixels.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np


def random_batch(
    rng: np.random.Generator,
    batch_size: int,
    image_size: int = 224,
    n_classes: int = 5,
) -> Tuple[np.ndarray, np.ndarray]:
    images = rng.standard_normal((batch_size, image_size, image_size, 3)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=(batch_size,)).astype(np.int32)
    return images, labels


def build_imagefolder(
    root: str,
    class_names: Sequence[str],
    per_class: int = 8,
    image_size: int = 32,
    seed: int = 0,
) -> str:
    """Write a tiny ImageFolder tree of random JPEGs; returns root."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for name in class_names:
        cdir = os.path.join(root, name)
        os.makedirs(cdir, exist_ok=True)
        for i in range(per_class):
            arr = rng.integers(0, 255, size=(image_size, image_size, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(cdir, f"{name.lower()}_{i:03d}.jpg"))
    return root
