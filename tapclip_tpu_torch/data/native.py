"""ctypes binding of the native C++ image pipeline (``native/image_pipeline.cpp``).

Counterpart of ``tapclip_tpu/data/native.py``, ABI v4: JPEG/PNG decode,
PIL-compatible antialiased bicubic resize of the shorter side, center crop
and CLIP normalization in C++ with an internal thread pool, bit-exact with
the PIL path (``data/preprocess.py``).

The port compiles its own copy of the shared source (``g++ ... -ljpeg
-lpng``) into ``build/tapclip_image/<hash>/libtapclip_image.so`` beside the
package (``.gitignore`` lists ``build/``), keyed by a hash of the source and
the flags; it never loads the JAX package's ``native/libtapclip_image.so``.
The build runs at first use, never at import.  When the toolchain or the
libraries are missing, :func:`available` is false and the loader takes its
PIL path, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "native" / "image_pipeline.cpp"
BUILD_ROOT = _REPO_ROOT / "build" / "tapclip_image"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lpthread")
ABI_VERSION = 4

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None

_P = ctypes.POINTER
_c = ctypes
# C signature of every entry point of ABI v4: argument types in order.
_SIGNATURES = {
    # paths, n, size, normalize, fast_decode, threads, out f32, ok
    "tapclip_decode_batch_ex": (_P(_c.c_char_p), _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                                _P(_c.c_float), _P(_c.c_ubyte)),
    # path, size, normalize, out f32
    "tapclip_decode_one": (_c.c_char_p, _c.c_int, _c.c_int, _P(_c.c_float)),
    # blobs, lengths, n, size, normalize, fast_decode, threads, out f32, ok
    "tapclip_decode_bytes_batch_ex": (_P(_c.c_char_p), _P(_c.c_size_t), _c.c_int, _c.c_int, _c.c_int,
                                      _c.c_int, _c.c_int, _P(_c.c_float), _P(_c.c_ubyte)),
    # paths, n, size, fast_decode, threads, out u8, ok
    "tapclip_decode_batch_u8": (_P(_c.c_char_p), _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                                _P(_c.c_ubyte), _P(_c.c_ubyte)),
    # blobs, lengths, n, size, fast_decode, threads, out u8, ok
    "tapclip_decode_bytes_batch_u8": (_P(_c.c_char_p), _P(_c.c_size_t), _c.c_int, _c.c_int, _c.c_int,
                                      _c.c_int, _P(_c.c_ubyte), _P(_c.c_ubyte)),
}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libtapclip_image.so"


def _build(so: Path) -> Optional[str]:
    """Compile the shared library into ``so``; returns an error string or None.

    The compiler writes a temporary file in the same directory, renamed into
    place when it succeeds, so concurrent builds never load a partial file.
    """
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(SOURCE), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        return f"compile failed: {e}"
    if proc.returncode != 0:
        os.unlink(tmp)
        return f"compile failed: {proc.stderr[-2000:]}"
    os.replace(tmp, so)
    return None


def _load():
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if not SOURCE.exists():
            _build_error = f"source not found: {SOURCE}"
            return None
        so = library_path()
        if not so.exists():
            _build_error = _build(so)
            if _build_error:
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            _build_error = str(e)
            return None
        if not all(hasattr(lib, sym) for sym in (*_SIGNATURES, "tapclip_abi_version")):
            _build_error = "the library lacks an entry point of ABI v4"
            return None
        lib.tapclip_abi_version.restype = ctypes.c_int
        if lib.tapclip_abi_version() != ABI_VERSION:
            _build_error = f"ABI version {lib.tapclip_abi_version()} != {ABI_VERSION}"
            return None
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native pipeline unavailable: {_build_error}")
    return lib


def _threads(num_threads: int) -> int:
    return num_threads if num_threads > 0 else min(8, os.cpu_count() or 1)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def _blobs(blobs: Sequence[bytes]):
    # c_char_p rows carry binary payloads: lengths travel separately.
    n = len(blobs)
    return (ctypes.c_char_p * n)(*blobs), (ctypes.c_size_t * n)(*[len(b) for b in blobs])


def decode_batch(
    paths: Sequence[str],
    image_size: int = 224,
    *,
    do_normalize: bool = True,
    num_threads: int = 0,
    fast_decode: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode + preprocess files -> (images [N, S, S, 3] f32, ok [N] bool).

    ``fast_decode=True`` decodes JPEGs at a DCT scale (PIL ``draft``
    semantics): near- but not bit-identical pixels, opt-in.
    """
    lib = _require()
    n = len(paths)
    out = np.empty((n, image_size, image_size, 3), np.float32)
    ok = np.zeros((n,), np.uint8)
    lib.tapclip_decode_batch_ex(_paths(paths), n, image_size, int(do_normalize), int(fast_decode),
                                _threads(num_threads), _ptr(out, ctypes.c_float), _ptr(ok, ctypes.c_ubyte))
    return out, ok.astype(bool)


def decode_bytes_batch(
    blobs: Sequence[bytes],
    image_size: int = 224,
    *,
    do_normalize: bool = True,
    num_threads: int = 0,
    fast_decode: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode + preprocess in-memory encoded images -> (images f32, ok);
    bit-identical to :func:`decode_batch` on the same bytes."""
    lib = _require()
    n = len(blobs)
    out = np.empty((n, image_size, image_size, 3), np.float32)
    ok = np.zeros((n,), np.uint8)
    arr, lens = _blobs(blobs)
    lib.tapclip_decode_bytes_batch_ex(arr, lens, n, image_size, int(do_normalize), int(fast_decode),
                                      _threads(num_threads), _ptr(out, ctypes.c_float), _ptr(ok, ctypes.c_ubyte))
    return out, ok.astype(bool)


def decode_one(path: str, image_size: int = 224, do_normalize: bool = True) -> np.ndarray:
    lib = _require()
    out = np.empty((image_size, image_size, 3), np.float32)
    if lib.tapclip_decode_one(path.encode(), image_size, int(do_normalize), _ptr(out, ctypes.c_float)) != 1:
        raise IOError(f"failed to decode {path}")
    return out


def decode_batch_u8(
    paths: Sequence[str],
    image_size: int = 224,
    *,
    num_threads: int = 0,
    fast_decode: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode + resize + crop files -> (images [N, S, S, 3] uint8, ok [N] bool):
    the resample's bytes, normalized later on the device."""
    lib = _require()
    n = len(paths)
    out = np.empty((n, image_size, image_size, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    lib.tapclip_decode_batch_u8(_paths(paths), n, image_size, int(fast_decode), _threads(num_threads),
                                _ptr(out, ctypes.c_ubyte), _ptr(ok, ctypes.c_ubyte))
    return out, ok.astype(bool)


def decode_bytes_batch_u8(
    blobs: Sequence[bytes],
    image_size: int = 224,
    *,
    num_threads: int = 0,
    fast_decode: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 variant of :func:`decode_bytes_batch`."""
    lib = _require()
    n = len(blobs)
    out = np.empty((n, image_size, image_size, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    arr, lens = _blobs(blobs)
    lib.tapclip_decode_bytes_batch_u8(arr, lens, n, image_size, int(fast_decode), _threads(num_threads),
                                      _ptr(out, ctypes.c_ubyte), _ptr(ok, ctypes.c_ubyte))
    return out, ok.astype(bool)
