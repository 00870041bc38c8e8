"""Offline bulk feature extraction: an image/caption corpus -> embedding
matrices on disk.

Counterpart of ``tapclip_tpu/featurize.py``, the index builder for retrieval,
dedup and zero-shot search:

- one fixed batch size for the whole corpus, the final partial batch padded
  with zeros and masked (the ``imagefolder.Loader`` contract);
- uint8 host -> device transport by default (4x fewer bytes; CLIP
  normalization runs on the device, bit-identical);
- decode-ahead on a background thread and pinned, asynchronous copies to
  the card (``data/prefetch.prefetch_to_device``);
- the int8 tower on request (``--int8``: B13 and B14 in every block).

``make_image_embed_fn`` and ``make_text_embed_fn`` return functions
``(params, batch) -> [B, embed_dim]`` unit-norm f32 features, run under
``torch.inference_mode()``; ``serve.PredictService.embed_text`` uses the
text one, so served and offline embeddings come from the same code.

Outputs (``--out DIR``):
- ``image_embeddings.npy``  float16 ``[N, D]``, L2-normalized rows
- ``manifest.csv``          ``index,path,class`` (ImageFolder input) or
  ``index,caption`` (shard input)
- ``text_embeddings.npy``   float16 ``[N, D]`` (``--embed-text``, shard
  input: the caption of sample i embeds to row i)

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
without a card raises.  ``--dp N`` splits every batch over N replicas of
the tower in this process (CUDA devices 0 .. N - 1; the batch size must
divide by N); ``--rank`` / ``--world`` partition the corpus across
processes.

Usage:
    python -m tapclip_tpu_torch.featurize --image-root data/val --out feats/ \\
        --pretrained open_clip_pytorch_model.bin
    python -m tapclip_tpu_torch.featurize --shard-dir shards/ --embed-text --out feats/
"""

from __future__ import annotations

import argparse
import csv
import io
import logging
import os
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tapclip_tpu_torch.config import MODEL_PRESETS, CLIPConfig, preset
from tapclip_tpu_torch.models import clip as clip_model

log = logging.getLogger("tapclip_tpu_torch")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``cuda`` without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is present")
    return dev


def load_clip_params(cfg: CLIPConfig, pretrained: Optional[str], seed: int = 0, device="cuda"):
    """Tower params on ``device``: an open_clip ``.pt``/``.bin`` state dict
    or a CLIP tree ``pretrain_cli`` saved, else random weights drawn from
    ``seed`` (and fresh VPT tokens for a VPT config whose tree has none).
    An Orbax directory of the JAX package raises, as ``train`` does."""
    dev = resolve_device(device)
    if pretrained:
        from tapclip_tpu_torch.utils.torch_convert import load_openclip_checkpoint

        params = load_openclip_checkpoint(pretrained, cfg, device=dev)
    else:
        log.warning("no --pretrained given: using RANDOM CLIP weights")
        params = clip_model.init_clip_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    return clip_model.ensure_vpt_params(params, cfg, seed=seed)


# ---------------------------------------------------------------------------
# embed functions
# ---------------------------------------------------------------------------

def make_image_embed_fn(cfg: CLIPConfig, mesh=None) -> Callable:
    """``(params, images [B, H, W, 3] f32 | uint8) -> [B, D] f32 unit-norm``.
    With ``mesh`` (a device-list mesh, ``parallel.mesh.make_mesh(dp,
    devices=...)``) the batch splits over its replicas and the rows come
    back in order (``parallel.sharding.data_parallel``).  With a
    process-group mesh (``make_mesh(dp, tp)``) each rank passes its local
    tree and its rows and gets its rows' embeddings, the tower run by
    ``parallel.train_step.make_image_encoder(cfg, mesh)``."""
    from tapclip_tpu_torch.parallel.sharding import data_parallel

    if mesh is not None and not mesh.in_process:
        from tapclip_tpu_torch.parallel.train_step import make_image_encoder

        encode = make_image_encoder(cfg, mesh)

        def embed_on_mesh(params, images):
            with torch.inference_mode():
                return clip_model.l2_normalize(encode(params, images)).float()

        return embed_on_mesh

    def embed(params, images):
        with torch.inference_mode():
            x = torch.as_tensor(images, device=params["logit_scale"].device)
            return clip_model.l2_normalize(clip_model.encode_image(params, cfg, x)).float()

    return data_parallel(embed, mesh, 1)


def make_text_embed_fn(cfg: CLIPConfig, mesh=None) -> Callable:
    """``(params, token_ids [B, T] int) -> [B, D] f32 unit-norm`` (``mesh``:
    a device-list mesh, as :func:`make_image_embed_fn`'s)."""
    from tapclip_tpu_torch.parallel.sharding import data_parallel

    def embed(params, ids):
        with torch.inference_mode():
            ids = torch.as_tensor(ids, device=params["logit_scale"].device)
            return clip_model.l2_normalize(clip_model.encode_text(params, cfg, ids)).float()

    return data_parallel(embed, mesh, 1)


# ---------------------------------------------------------------------------
# corpus iterators
# ---------------------------------------------------------------------------

def iter_shard_samples_deterministic(
    shard_dir: str, image_size: int, output_dtype: str = "float32",
    rank: int = 0, world: int = 1,
) -> Iterator[Tuple[np.ndarray, str]]:
    """Every ``(decoded image, caption)`` of a shard dir, in shard-name and
    in-tar order (no shuffle, no dropped tail).  ``rank``/``world`` split the
    shard list into contiguous chunks, so the per-rank outputs concatenated
    in rank order are the ``world=1`` corpus row for row."""
    from PIL import Image

    from tapclip_tpu_torch.data.preprocess import preprocess_pil, preprocess_pil_uint8
    from tapclip_tpu_torch.data.shards import _iter_shard, list_shards

    if world < 1 or not (0 <= rank < world):
        raise ValueError(f"bad rank/world {rank}/{world}")
    pre = preprocess_pil if output_dtype == "float32" else preprocess_pil_uint8
    shards = list_shards(shard_dir)
    chunks = np.array_split(np.arange(len(shards)), world)
    for si in chunks[rank]:
        for img_bytes, caption in _iter_shard(shards[int(si)]):
            with Image.open(io.BytesIO(img_bytes)) as im:
                arr = pre(im.convert("RGB"), image_size)
            yield arr, caption


def _batched(
    samples: Iterator[Tuple[np.ndarray, str]], batch_size: int
) -> Iterator[Tuple[np.ndarray, List[str], np.ndarray]]:
    """Pack samples into ``(images [B, ...], metas, mask [B])``, the tail
    batch padded with zero images."""
    imgs: List[np.ndarray] = []
    metas: List[str] = []
    for arr, meta in samples:
        imgs.append(arr)
        metas.append(meta)
        if len(imgs) == batch_size:
            yield np.stack(imgs), metas, np.ones(batch_size, bool)
            imgs, metas = [], []
    if imgs:
        n = len(imgs)
        imgs.extend([np.zeros_like(imgs[0])] * (batch_size - n))
        mask = np.zeros(batch_size, bool)
        mask[:n] = True
        yield np.stack(imgs), metas, mask


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def featurize_images(
    params,
    cfg: CLIPConfig,
    batches,
    *,
    prefetch_depth: int = 2,
    embed_fn: Optional[Callable] = None,
) -> np.ndarray:
    """Embed the first ``mask.sum()`` rows of each ``(images, metas_or_labels,
    mask)`` batch -> float16 ``[N, D]`` unit-norm rows (``embed_fn``: a
    :func:`make_image_embed_fn`, e.g. over a mesh)."""
    from tapclip_tpu_torch.data.prefetch import prefetch_to_device

    embed_fn = embed_fn or make_image_embed_fn(cfg)
    out: List[np.ndarray] = []
    for images, _, mask in prefetch_to_device(batches, size=prefetch_depth,
                                              device=params["logit_scale"].device):
        f = embed_fn(params, images)[: int(mask.sum())]
        out.append(f.cpu().numpy().astype(np.float16))
    if not out:
        raise ValueError("empty corpus: no batches produced")
    return np.concatenate(out)


def featurize_texts(
    params,
    cfg: CLIPConfig,
    captions: Sequence[str],
    tokenize: Callable[[List[str]], np.ndarray],
    batch_size: int,
    embed_fn: Optional[Callable] = None,
) -> np.ndarray:
    """Embed captions -> float16 ``[N, D]`` unit-norm rows; the tail batch is
    padded with empty strings, whose rows are dropped."""
    embed_fn = embed_fn or make_text_embed_fn(cfg)
    out: List[np.ndarray] = []
    for i in range(0, len(captions), batch_size):
        chunk = list(captions[i : i + batch_size])
        n = len(chunk)
        chunk.extend([""] * (batch_size - n))
        f = embed_fn(params, tokenize(chunk))[:n]
        out.append(f.cpu().numpy().astype(np.float16))
    if not out:
        raise ValueError("no captions to embed")
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def add_tower_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The model flags ``featurize``, ``predict`` and ``search`` share."""
    p.add_argument("--model", default="ViT-B-16", choices=sorted(MODEL_PRESETS))
    p.add_argument("--preset", default=None,
                   help="experiment preset providing the model config (overrides --model; 'tiny' for tests)")
    p.add_argument("--pretrained", default=None, help="open_clip .pt/.bin state dict (random weights if unset)")
    p.add_argument("--bpe-path", default=None)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    return p


def tower_config(args, int8: bool = False, int8_deterministic: bool = False) -> CLIPConfig:
    """The model config ``--preset`` / ``--model`` name, with the int8 tower on request."""
    cfg = preset(args.preset).model if args.preset else MODEL_PRESETS[args.model]
    if int8:
        cfg = cfg.replace(quantize_tower=True, int8_deterministic=int8_deterministic)
    return cfg


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--image-root", help="ImageFolder tree (class subdirs)")
    src.add_argument("--shard-dir", help="webdataset tar shard directory")
    p.add_argument("--out", required=True, help="output directory")
    add_tower_args(p)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--embed-text", action="store_true", help="also embed captions (shard input only)")
    p.add_argument("--int8", action="store_true", help="quantized W8A8 tower (B13 and B14)")
    p.add_argument("--fast-decode", action="store_true",
                   help="DCT-scaled JPEG decode in the native pipeline (near- but not bit-identical "
                        "pixels; ImageFolder input only)")
    p.add_argument("--uint8-transfer", dest="uint8_transfer", action="store_true", default=True)
    p.add_argument("--no-uint8-transfer", dest="uint8_transfer", action="store_false")
    p.add_argument("--dp", type=int, default=0,
                   help="split every batch over this many replicas (CUDA devices 0 .. dp - 1; 0: one device)")
    p.add_argument("--rank", type=int, default=0,
                   help="this worker's corpus partition (each rank writes its own --out; search --index "
                        "takes all of them together)")
    p.add_argument("--world", type=int, default=1, help="total workers partitioning the corpus")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    mesh = None
    if args.dp:
        from tapclip_tpu_torch.parallel.mesh import device_mesh

        mesh = device_mesh(args.dp, args.device)
        if args.batch_size % args.dp:
            raise SystemExit("--batch-size must divide by --dp")
    cfg = tower_config(args, args.int8)
    if args.embed_text and not args.shard_dir:
        raise SystemExit("--embed-text requires --shard-dir (captions)")
    if args.world < 1 or not (0 <= args.rank < args.world):
        raise SystemExit(f"bad --rank {args.rank} for --world {args.world}")
    params = load_clip_params(cfg, args.pretrained, device=args.device)

    os.makedirs(args.out, exist_ok=True)
    dtype = "uint8" if args.uint8_transfer else "float32"
    manifest_rows: List[Tuple] = []
    captions: List[str] = []
    if args.image_root:
        from tapclip_tpu_torch.data.imagefolder import ImageFolderIndex, Loader

        index = ImageFolderIndex.scan(args.image_root)
        if args.world > 1:
            # contiguous chunks: the per-rank outputs concatenate to the world=1 corpus
            chunks = np.array_split(np.arange(len(index.samples)), args.world)
            index.samples = [index.samples[int(i)] for i in chunks[args.rank]]
        loader = Loader(index.samples, args.batch_size, shuffle=False, image_size=cfg.image_size,
                        output_dtype=dtype, fast_decode=args.fast_decode)
        feats = featurize_images(params, cfg, iter(loader), embed_fn=make_image_embed_fn(cfg, mesh))
        manifest_rows = [(i, path, index.classes[label]) for i, (path, label) in enumerate(index.samples)]
        header = ("index", "path", "class")
    else:
        # Streamed: decoded images are never all resident; the captions are
        # collected on the way through.
        def tee_captions(it):
            for arr, cap in it:
                captions.append(cap)
                yield arr, cap

        stream = iter_shard_samples_deterministic(args.shard_dir, cfg.image_size, dtype,
                                                  rank=args.rank, world=args.world)
        feats = featurize_images(params, cfg, _batched(tee_captions(stream), args.batch_size),
                                 embed_fn=make_image_embed_fn(cfg, mesh))
        manifest_rows = list(enumerate(captions))
        header = ("index", "caption")

    np.save(os.path.join(args.out, "image_embeddings.npy"), feats)
    with open(os.path.join(args.out, "manifest.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(manifest_rows)
    result = {"n": int(feats.shape[0]), "dim": int(feats.shape[1])}
    log.info("wrote %d image embeddings (dim %d) to %s", result["n"], result["dim"], args.out)

    if args.embed_text:
        from tapclip_tpu_torch.data.tokenizer import get_tokenizer

        tok = get_tokenizer(args.bpe_path, cfg.context_length)
        tfeats = featurize_texts(params, cfg, captions, tok.tokenize, args.batch_size,
                                 embed_fn=make_text_embed_fn(cfg, mesh))
        np.save(os.path.join(args.out, "text_embeddings.npy"), tfeats)
        result["n_text"] = int(tfeats.shape[0])
        log.info("wrote %d text embeddings", result["n_text"])
    return result


if __name__ == "__main__":
    main()
