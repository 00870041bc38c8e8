"""CSV/TSV ``(image path, caption)`` manifests for contrastive pretraining.

Counterpart of ``tapclip_tpu/data/csv_dataset.py``: open_clip's other
training format beside webdataset (``--csv-img-key filepath
--csv-caption-key title``), a delimited manifest of image paths and
captions with the images as loose files.  The batch contract is
``data.shards.ShardLoader``'s: ``(images [B, H, W, 3] f32 | uint8,
token_ids [B, T] i32)``, a per-``(seed, epoch)`` shuffle, rank/world row
partitioning, full batches only, so ``pretrain_cli`` does not care which
loader it runs.
"""

from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Tuple

import numpy as np

from tapclip_tpu_torch.data.shards import decode_or_skip


class CsvLoader:
    """Iterable of ``(images, token_ids)`` batches from a CSV/TSV manifest.

    Relative image paths resolve against the manifest's directory (open_clip's
    convention).  One ``__iter__`` pass is one epoch; the epoch counter
    advances by itself and seeds the order.  Undecodable files are skipped
    and counted in ``skipped``.
    """

    def __init__(
        self,
        csv_path: str,
        batch_size: int,
        *,
        tokenize: Callable[[List[str]], np.ndarray],
        image_size: int = 224,
        img_key: str = "filepath",
        caption_key: str = "title",
        sep: str = "\t",
        seed: int = 0,
        rank: int = 0,
        world: int = 1,
        num_workers: int = 4,
        use_native: Optional[bool] = None,
        fast_decode: bool = False,
        output_dtype: str = "float32",
    ):
        if world < 1 or not (0 <= rank < world):
            raise ValueError(f"bad rank/world {rank}/{world}")
        root = os.path.dirname(os.path.abspath(csv_path))
        with open(csv_path, newline="") as f:
            reader = csv.DictReader(f, delimiter=sep)
            if reader.fieldnames is None or img_key not in reader.fieldnames \
                    or caption_key not in reader.fieldnames:
                raise ValueError(f"{csv_path}: need columns {img_key!r} and {caption_key!r}, "
                                 f"found {reader.fieldnames}")
            rows = [(r[img_key] if os.path.isabs(r[img_key]) else os.path.join(root, r[img_key]), r[caption_key])
                    for r in reader]
        if not rows:
            raise ValueError(f"{csv_path}: no data rows")
        self.samples: List[Tuple[str, str]] = rows[rank::world]
        if not self.samples:
            raise ValueError(f"rank {rank}/{world} got no rows ({len(rows)} total)")
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"output_dtype must be float32|uint8, got {output_dtype}")
        self.batch_size = batch_size
        self.tokenize = tokenize
        self.image_size = image_size
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self._epoch = 0
        self._use_native = use_native
        self.fast_decode = bool(fast_decode)  # DCT-scaled JPEG decode (native only)
        self.output_dtype = output_dtype
        self.skipped = 0

    def __len__(self) -> int:
        return len(self.samples) // self.batch_size

    @property
    def num_samples(self) -> int:
        return len(self.samples)

    def state(self) -> dict:
        return {"epoch": self._epoch}

    def restore(self, state: dict) -> None:
        self._epoch = int(state["epoch"])

    def __iter__(self):
        from PIL import Image

        from tapclip_tpu_torch.data import native
        from tapclip_tpu_torch.data.preprocess import preprocess_pil, preprocess_pil_uint8

        use_native = self._use_native is not False and native.available()
        to_uint8 = self.output_dtype == "uint8"
        pil_pre = preprocess_pil_uint8 if to_uint8 else preprocess_pil
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self._epoch]))
        order = rng.permutation(len(self.samples))
        self._epoch += 1

        def pil_open(path):
            with Image.open(path) as im:
                return pil_pre(im.convert("RGB"), self.image_size)

        def pil_decode(i: int):
            path, caption = self.samples[int(i)]
            arr = decode_or_skip(self, pil_open, path, path, "image")
            return None if arr is None else (arr, caption)

        def decode_window(idx):
            """One window of samples in order: natively when it builds (PIL
            for the formats it does not cover), PIL threads otherwise."""
            if not use_native:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    return [o for o in pool.map(pil_decode, idx) if o is not None]
            decode = native.decode_batch_u8 if to_uint8 else native.decode_batch
            arrs, ok = decode([self.samples[int(i)][0] for i in idx], self.image_size,
                              num_threads=self.num_workers, fast_decode=self.fast_decode)
            out = []
            for arr, good, i in zip(arrs, ok, idx):
                d = (arr, self.samples[int(i)][1]) if good else pil_decode(i)
                if d is not None:
                    out.append(d)
            return out

        B = self.batch_size
        buf: List[Tuple[np.ndarray, str]] = []
        for s in range(0, len(order), B):
            buf.extend(decode_window(order[s:s + B]))
            while len(buf) >= B:
                chunk, buf = buf[:B], buf[B:]
                yield np.stack([c[0] for c in chunk]), self.tokenize([c[1] for c in chunk])
