"""webdataset-style tar shards: write, list, stream and count.

Counterpart of the shard helpers of ``tapclip_tpu/data/shards.py``: a corpus
of ``(image, caption)`` pairs lives in ``.tar`` shards whose members pair by
basename stem (``000123.jpg`` + ``000123.txt``), read sequentially, member by
member.  ``featurize --shard-dir`` walks them in shard-name and in-tar order.
:class:`ShardLoader` streams shuffled, decoded, tokenized batches for
contrastive pretraining (``pretrain_cli --shard-dir``): a rank's shard
subset in a ``(seed, epoch)``-seeded order, samples through a bounded shuffle
buffer, full batches only, epoch-granular resume.  It decodes with the
native pipeline when it builds (``data/native.py``, PIL-bit-exact) and with
PIL otherwise; ``fast_decode`` (DCT-scaled JPEG decode) is the native
pipeline's, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import os
import tarfile
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_log = logging.getLogger("tapclip_tpu_torch")

_IMG_EXT = (".jpg", ".jpeg", ".png", ".webp", ".bmp")
_TXT_EXT = (".txt", ".caption", ".cls")


def write_shards(
    samples: Sequence[Tuple[bytes, str]],
    out_dir: str,
    *,
    shard_size: int = 1000,
    prefix: str = "shard",
) -> List[str]:
    """Pack ``(jpeg_bytes, caption)`` pairs into tar shards of ``shard_size``
    samples, keyed ``{index:09d}.jpg`` / ``.txt``; returns the shard paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for s in range(0, max(len(samples), 1), shard_size):
        chunk = samples[s:s + shard_size]
        if not chunk:
            break
        path = os.path.join(out_dir, f"{prefix}-{s // shard_size:06d}.tar")
        with tarfile.open(path, "w") as tf:
            for i, (img_bytes, caption) in enumerate(chunk):
                key = f"{s + i:09d}"
                for name, payload in ((f"{key}.jpg", img_bytes), (f"{key}.txt", caption.encode("utf-8"))):
                    info = tarfile.TarInfo(name)
                    info.size = len(payload)
                    tf.addfile(info, io.BytesIO(payload))
        paths.append(path)
    return paths


def list_shards(root: str) -> List[str]:
    """Sorted ``.tar`` shard paths under ``root``."""
    out = sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith(".tar"))
    if not out:
        raise FileNotFoundError(f"no .tar shards under {root}")
    return out


def _iter_shard(path: str) -> Iterator[Tuple[bytes, str]]:
    """Stream ``(image_bytes, caption)`` pairs from one tar, pairing members
    by basename stem.  Unpaired members (an image without a caption, or the
    reverse) are dropped, as webdataset drops them."""
    pending: Dict[str, Dict[str, bytes]] = {}
    with tarfile.open(path, "r") as tf:
        for member in tf:
            if not member.isfile():
                continue
            stem, ext = os.path.splitext(member.name)
            ext = ext.lower()
            if ext not in _IMG_EXT and ext not in _TXT_EXT:
                continue
            data = tf.extractfile(member).read()
            slot = pending.setdefault(stem, {})
            slot["img" if ext in _IMG_EXT else "txt"] = data
            if "img" in slot and "txt" in slot:
                del pending[stem]
                yield slot["img"], slot["txt"].decode("utf-8", "replace")


def count_samples(shards: Sequence[str]) -> int:
    """Complete ``(image, caption)`` pairs across ``shards``, from the tar
    headers alone (no member is read)."""
    total = 0
    for path in shards:
        stems: Dict[str, int] = {}
        with tarfile.open(path, "r") as tf:
            for member in tf:
                if not member.isfile():
                    continue
                stem, ext = os.path.splitext(member.name)
                ext = ext.lower()
                if ext in _IMG_EXT:
                    stems[stem] = stems.get(stem, 0) | 1
                elif ext in _TXT_EXT:
                    stems[stem] = stems.get(stem, 0) | 2
        total += sum(1 for v in stems.values() if v == 3)
    return total


@dataclasses.dataclass
class ShardLoaderState:
    epoch: int
    shards_done: int


def decode_or_skip(owner, decode: Callable, payload, label: str, what: str):
    """``decode(payload)``, or None after counting ``owner.skipped`` and a
    warning when it raises (a corrupt sample is skipped, never fatal)."""
    try:
        return decode(payload)
    except Exception as e:
        owner.skipped += 1
        _log.warning("skipping undecodable %s %s: %s", what, label, e)
        return None


class ShardLoader:
    """Iterable of ``(images [B, H, W, 3] f32 | uint8, token_ids [B, T] i32)``
    batches streamed from webdataset tar shards.

    One pass over ``__iter__`` is one epoch: the rank's shards
    (``shards[rank::world]``) in a ``(seed, epoch)``-seeded order, samples
    shuffled through a buffer of ``shuffle_buffer``, full batches only (the
    tail is dropped).  The epoch counter advances at the end of each pass;
    :meth:`state` / :meth:`restore` resume at an epoch (and a shard count).
    Undecodable members are skipped and counted in ``skipped``.
    """

    def __init__(
        self,
        shards: Sequence[str],
        batch_size: int,
        *,
        tokenize: Callable[[List[str]], np.ndarray],
        image_size: int = 224,
        shuffle_buffer: int = 1000,
        seed: int = 0,
        rank: int = 0,
        world: int = 1,
        use_native: Optional[bool] = None,
        fast_decode: bool = False,
        output_dtype: str = "float32",
    ):
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"output_dtype must be float32|uint8, got {output_dtype}")
        if world < 1 or not (0 <= rank < world):
            raise ValueError(f"bad rank/world {rank}/{world}")
        self.all_shards = list(shards)
        self.shards = self.all_shards[rank::world]
        if not self.shards:
            raise ValueError(f"rank {rank}/{world} got no shards ({len(self.all_shards)} total)")
        self.batch_size = batch_size
        self.tokenize = tokenize
        self.image_size = image_size
        self.shuffle_buffer = max(1, shuffle_buffer)
        self.seed = seed
        self._epoch = 0
        self._skip_shards = 0  # set by restore(); consumed by the next __iter__
        self._shards_done = 0
        self._n_samples = count_samples(self.shards)
        self.skipped = 0
        self._use_native = use_native  # None: the native decoder when it builds
        self.fast_decode = bool(fast_decode)  # DCT-scaled JPEG decode (native only)
        self.output_dtype = output_dtype

    def __len__(self) -> int:
        return self._n_samples // self.batch_size

    @property
    def num_samples(self) -> int:
        return self._n_samples

    def state(self) -> dict:
        return {"epoch": self._epoch, "shards_done": self._shards_done}

    def restore(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        self._skip_shards = int(state["shards_done"])

    def _sample_stream(self, order: np.ndarray, skip: int) -> Iterator[Tuple[bytes, str]]:
        for pos in range(skip, len(order)):
            yield from _iter_shard(self.shards[int(order[pos])])
            self._shards_done = pos + 1

    def __iter__(self):
        from PIL import Image

        from tapclip_tpu_torch.data import native
        from tapclip_tpu_torch.data.preprocess import preprocess_pil, preprocess_pil_uint8

        use_native = self._use_native is not False and native.available()
        to_uint8 = self.output_dtype == "uint8"
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self._epoch]))
        order = rng.permutation(len(self.shards))
        skip, self._skip_shards = self._skip_shards, 0
        self._shards_done = skip
        buf: List[Tuple[bytes, str]] = []
        imgs: List[np.ndarray] = []
        caps: List[str] = []
        pil_pre = preprocess_pil_uint8 if to_uint8 else preprocess_pil

        def pil_decode(img_bytes):
            with Image.open(io.BytesIO(img_bytes)) as im:
                return pil_pre(im.convert("RGB"), self.image_size)

        def keep_pil(img_bytes, caption):
            arr = decode_or_skip(self, pil_decode, img_bytes, f"({caption[:40]!r}...)", "shard member")
            if arr is not None:
                imgs.append(arr)
                caps.append(caption)

        def decode_many(items):
            """Decode in eviction order: natively when it builds (PIL for
            the formats it does not cover), PIL otherwise."""
            if not use_native:
                for img_bytes, caption in items:
                    keep_pil(img_bytes, caption)
                return
            decode = native.decode_bytes_batch_u8 if to_uint8 else native.decode_bytes_batch
            arrs, ok = decode([b for b, _ in items], self.image_size, fast_decode=self.fast_decode)
            for arr, good, (img_bytes, caption) in zip(arrs, ok, items):
                if good:
                    imgs.append(arr)
                    caps.append(caption)
                else:
                    keep_pil(img_bytes, caption)

        def drain_batches():
            B = self.batch_size
            while len(imgs) >= B:
                batch_i, batch_c = imgs[:B], caps[:B]
                del imgs[:B], caps[:B]
                yield np.stack(batch_i), self.tokenize(batch_c)

        pending: List[Tuple[bytes, str]] = []
        for item in self._sample_stream(order, skip):
            if len(buf) < self.shuffle_buffer:
                buf.append(item)
                continue
            j = int(rng.integers(len(buf)))
            out, buf[j] = buf[j], item
            pending.append(out)
            if len(pending) >= self.batch_size:
                decode_many(pending)
                pending = []
                yield from drain_batches()
        for j in rng.permutation(len(buf)):  # drain the buffer in random order
            pending.append(buf[int(j)])
        decode_many(pending)
        yield from drain_batches()
        self._epoch += 1
        self._shards_done = 0
