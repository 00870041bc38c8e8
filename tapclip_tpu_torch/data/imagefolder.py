"""ImageFolder dataset + few-shot split + batching.

Counterpart of ``tapclip_tpu/data/imagefolder.py`` (the reference's data
layer, ``dataset.py``); splits and batch orders come from the same numpy
generators, so both packages see the same files in the same order:

* ``ImageFolderIndex``   — scan ``root/ClassName/*.jpg`` like torchvision's
  ``ImageFolder`` (``dataset.py:31``).
* ``relabel + filter``   — callers supply ``class_names``; raw folder labels
  are remapped to contiguous ids in *caller order* (``dataset.py:34``,
  ``RelabeledSubset.__getitem__`` at ``dataset.py:16-18``).
* ``few_shot_split``     — ``num_shots`` per class for train, up to 100 of the
  remainder per class for val (``dataset.py:47-57``) — but **seeded**: the
  reference uses unseeded ``random.sample`` (``dataset.py:50,57``), making
  exact split reproduction impossible; we fix that (SURVEY.md §7 hard part 5).
* ``Loader``             — drop-in style iterable yielding ``(images, labels)``
  NumPy batches with a background prefetch thread; batches are padded to the
  batch size (with a validity mask), so every step sees one shape.  Its two
  decode paths are the JAX package's pair: the native C++ pipeline
  (``data/native.py``) when no ``preprocess`` callable is given and the
  library builds, else the Python (PIL) path; ``Loader.decoder`` names the
  one taken and ``get_dataloaders`` logs it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tapclip_tpu_torch.data.preprocess import make_preprocess, make_preprocess_uint8

_log = logging.getLogger("tapclip_tpu_torch")

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff")


def _native_available() -> bool:
    try:
        from tapclip_tpu_torch.data import native

        return native.available()
    except Exception:
        return False


@dataclasses.dataclass
class ImageFolderIndex:
    root: str
    classes: List[str]
    class_to_idx: Dict[str, int]
    samples: List[Tuple[str, int]]  # (path, raw_label)

    @classmethod
    def scan(cls, root: str) -> "ImageFolderIndex":
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        class_to_idx = {c: i for i, c in enumerate(classes)}
        samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    samples.append((os.path.join(cdir, fname), class_to_idx[c]))
        if not samples:
            raise FileNotFoundError(f"no images found under {root}")
        return cls(root, classes, class_to_idx, samples)


@dataclasses.dataclass
class FewShotSplit:
    train: List[Tuple[str, int]]  # (path, new_label)
    val: List[Tuple[str, int]]
    label_map: Dict[int, int]  # raw -> new


def few_shot_split(
    index: ImageFolderIndex,
    class_names: Sequence[str],
    num_shots: int,
    seed: int = 0,
    max_val_per_class: int = 100,
) -> FewShotSplit:
    """Reference split semantics (dataset.py:34-57), seeded."""
    missing = [c for c in class_names if c not in index.class_to_idx]
    if missing:
        raise KeyError(f"classes not in dataset: {missing}")
    label_map = {index.class_to_idx[name]: i for i, name in enumerate(class_names)}

    per_class: Dict[int, List[str]] = {raw: [] for raw in label_map}
    for path, raw in index.samples:
        if raw in label_map:
            per_class[raw].append(path)

    rng = np.random.default_rng(seed)
    train, val = [], []
    for raw, paths in per_class.items():
        new = label_map[raw]
        paths = list(paths)
        perm = rng.permutation(len(paths))
        k = min(len(paths), num_shots) if num_shots > 0 else 0
        train_idx = set(perm[:k].tolist())
        train.extend((paths[i], new) for i in sorted(train_idx))
        rest = [i for i in range(len(paths)) if i not in train_idx]
        # reference: random.sample(rest, min(len(rest), 100)) (dataset.py:57)
        rest_perm = rng.permutation(len(rest))[: min(len(rest), max_val_per_class)]
        val.extend((paths[rest[i]], new) for i in sorted(rest_perm.tolist()))
    return FewShotSplit(train=train, val=val, label_map=label_map)


def eval_samples(index: ImageFolderIndex, val_root: Optional[str], split: FewShotSplit) -> List[Tuple[str, int]]:
    """The few-shot drivers' eval samples: ``val_root``'s images of
    ``index``'s classes, relabelled to ``index``'s order, else the split's
    held-out part."""
    if not val_root:
        return split.val
    val_index = ImageFolderIndex.scan(val_root)
    return [(path, index.class_to_idx[val_index.classes[raw]]) for path, raw in val_index.samples
            if val_index.classes[raw] in index.class_to_idx]


class Loader:
    """Iterable of ``(images [B,H,W,3] f32, labels [B] i32, mask [B] bool)``.

    The final partial batch is padded to ``batch_size`` (mask marks real
    rows) so downstream jitted functions see a single static shape.
    """

    def __init__(
        self,
        samples: Sequence[Tuple[str, int]],
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        image_size: int = 224,
        num_workers: int = 4,
        preprocess: Optional[Callable] = None,
        drop_remainder: bool = False,
        use_native: Optional[bool] = None,
        output_dtype: str = "float32",
        fast_decode: bool = False,
    ):
        self.samples = list(samples)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.image_size = image_size
        self.num_workers = max(1, num_workers)
        self.drop_remainder = drop_remainder
        self._epoch = 0
        self.skipped = 0  # undecodable files seen (skipped, not fatal)
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"output_dtype must be float32|uint8, got {output_dtype}")
        if output_dtype == "uint8" and preprocess is not None:
            raise ValueError(
                "output_dtype='uint8' requires the built-in pipeline "
                "(normalization moves on-device; see preprocess.device_normalize)"
            )
        self.output_dtype = output_dtype
        # Native C++ decode path (bit-exact with the PIL pipeline) is used
        # when no custom preprocess fn was supplied and the library builds.
        if use_native is None:
            use_native = preprocess is None and _native_available()
        self.use_native = bool(use_native) and preprocess is None
        # Opt-in DCT-scaled JPEG decode (native path only; see
        # native.decode_batch).  Near- but not bit-identical pixels, so the
        # exact path stays the default.
        self.fast_decode = bool(fast_decode) and self.use_native
        if output_dtype == "uint8":
            self.preprocess = make_preprocess_uint8(image_size)
        else:
            self.preprocess = preprocess or make_preprocess(image_size)

    @property
    def decoder(self) -> str:
        """The decode path this loader takes: ``"native"`` or ``"pil"``."""
        return "native" if self.use_native else "pil"

    def __len__(self) -> int:
        n = len(self.samples)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def num_samples(self) -> int:
        return len(self.samples)

    def _order(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            return rng.permutation(len(self.samples))
        return np.arange(len(self.samples))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        if self.use_native:
            yield from self._iter_native()
            return
        yield from self._iter_python()

    def _iter_native(self):
        """Batch decode through the C++ pipeline (threaded inside)."""
        from tapclip_tpu_torch.data import native

        order = self._order()
        self._epoch += 1
        B = self.batch_size
        for b in range(len(self)):
            idx = order[b * B : (b + 1) * B]
            paths = [self.samples[i][0] for i in idx]
            labels = np.asarray([self.samples[i][1] for i in idx], np.int32)
            if self.output_dtype == "uint8":
                # Direct uint8 output: the C++ resample's bytes verbatim —
                # no float buffer, no host-side quantization round-trip
                # (bit-identical to the old rint(f32*255) path).
                images, ok = native.decode_batch_u8(
                    paths,
                    self.image_size,
                    num_threads=self.num_workers,
                    fast_decode=self.fast_decode,
                )
            else:
                images, ok = native.decode_batch(
                    paths,
                    self.image_size,
                    num_threads=self.num_workers,
                    fast_decode=self.fast_decode,
                )
            mask = np.ones((len(idx),), bool)
            if not ok.all():
                # Formats the native decoder doesn't cover (webp/bmp/tiff)
                # or corrupt-but-PIL-readable files: fall back per image;
                # files neither decoder reads are masked out, not fatal.
                for j in np.nonzero(~ok)[0]:
                    try:
                        images[j] = self.preprocess(paths[j])
                    except Exception as e:
                        self.skipped += 1
                        mask[j] = False
                        _log.warning(
                            "skipping undecodable image %s: %s", paths[j], e
                        )
            if len(idx) < B:
                pad = B - len(idx)
                images = np.concatenate(
                    [images, np.zeros((pad,) + images.shape[1:], images.dtype)]
                )
                labels = np.concatenate([labels, np.zeros((pad,), np.int32)])
                mask = np.concatenate([mask, np.zeros((pad,), bool)])
            yield images, labels, mask

    def _iter_python(self):
        order = self._order()
        self._epoch += 1
        B = self.batch_size

        def load_one(i: int):
            path, label = self.samples[i]
            try:
                return self.preprocess(path), label
            except Exception as e:  # corrupt/unreadable file: skip, don't
                # kill the run (production corpora always contain a few)
                self.skipped += 1
                _log.warning("skipping undecodable image %s: %s", path, e)
                return None

        n_batches = len(self)
        # Threaded prefetch with a bounded window: decode up to PREFETCH
        # batches ahead while the current batch is on device.
        from concurrent.futures import ThreadPoolExecutor

        PREFETCH = 2
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = {}

            def submit(b):
                idx = order[b * B : (b + 1) * B]
                pending[b] = [pool.submit(load_one, i) for i in idx.tolist()]

            for b in range(min(PREFETCH + 1, n_batches)):
                submit(b)
            for b in range(n_batches):
                if b + PREFETCH + 1 < n_batches:
                    submit(b + PREFETCH + 1)
                items = [r for f in pending.pop(b) if (r := f.result()) is not None]
                if not items:
                    continue
                images = np.stack([im for im, _ in items])
                labels = np.asarray([lb for _, lb in items], np.int32)
                mask = np.ones((len(items),), bool)
                if len(items) < B:
                    pad = B - len(items)
                    images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
                    labels = np.concatenate([labels, np.zeros((pad,), np.int32)])
                    mask = np.concatenate([mask, np.zeros((pad,), bool)])
                yield images, labels, mask


def get_dataloaders(
    root_dir: str,
    class_names: Sequence[str],
    batch_size: int = 32,
    num_shots: int = 5,
    preprocess: Optional[Callable] = None,
    *,
    seed: int = 0,
    image_size: int = 224,
    num_workers: int = 4,
    verbose: bool = True,
    output_dtype: str = "float32",
) -> Tuple[Optional[Loader], Loader]:
    """Public API matching the reference ``get_dataloaders`` (dataset.py:21-71).

    Returns ``(train_loader | None, val_loader)``; ``num_shots=0`` yields
    ``train_loader=None`` (zero-shot, dataset.py:51-62).

    ``output_dtype="uint8"`` ships raw resized/cropped pixels across
    host->device (4x less transfer) and fuses CLIP normalization into the
    image tower's program (``encode_image`` handles uint8) — bit-identical.
    """
    index = ImageFolderIndex.scan(root_dir)
    split = few_shot_split(index, class_names, num_shots, seed=seed)

    train_loader = None
    if num_shots > 0:
        train_loader = Loader(
            split.train,
            batch_size,
            shuffle=True,
            seed=seed,
            image_size=image_size,
            num_workers=num_workers,
            preprocess=preprocess,
            output_dtype=output_dtype,
        )
    elif verbose:
        print("⚠️ [dataset.py] num_shots=0 → train set will be "
              "empty (zero-shot setting)")
    val_loader = Loader(
        split.val,
        batch_size,
        shuffle=False,
        image_size=image_size,
        num_workers=num_workers,
        preprocess=preprocess,
        output_dtype=output_dtype,
    )
    _log.info("loader: %s decode path (%d train / %d val images)", val_loader.decoder,
              len(split.train) if train_loader is not None else 0, len(split.val))
    if verbose:
        # Byte-identical to the reference's sanity prints (dataset.py:66-69).
        print("\U0001f50e Raw → New Label Map:", split.label_map)
        print("✅ Total Classes (Prompt):", len(class_names))
        print(
            "\U0001f9ea Train Label Distribution:",
            sorted({lb for _, lb in split.train}),
        )
    return train_loader, val_loader
