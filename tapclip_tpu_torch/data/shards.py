"""webdataset-style tar shards: write, list, stream and count.

Counterpart of the shard helpers of ``tapclip_tpu/data/shards.py``: a corpus
of ``(image, caption)`` pairs lives in ``.tar`` shards whose members pair by
basename stem (``000123.jpg`` + ``000123.txt``), read sequentially, member by
member.  ``featurize --shard-dir`` walks them in shard-name and in-tar order.
Plain ``tarfile``, no decode here.  The shuffling, batching ``ShardLoader``
of contrastive pretraining is not yet ported (it waits for pretraining).
"""

from __future__ import annotations

import io
import os
import tarfile
from typing import Dict, Iterator, List, Sequence, Tuple

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
