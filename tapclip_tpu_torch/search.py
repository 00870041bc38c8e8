"""Similarity search over featurized corpora (the retrieval deployment).

Counterpart of ``tapclip_tpu/search.py``: load ``featurize``'s packed
``[N, D]`` unit-norm embedding matrix and its row-aligned manifest, and
answer exact top-k cosine queries by image, by text or by corpus row ("more
like this"), or list the near-duplicate pairs (``--dedup``).

The index lives on the device as one bf16 matrix (half the bytes of f32); a
query batch is one ``[Q, D] @ [D, N]`` product of the bf16 operands with f32
accumulation and f32 scores, then ``torch.topk``, as the JAX package's
``preferred_element_type=jnp.float32``.  Scores are never
rounded to bf16: that would reorder near-ties and move ``--dedup``
thresholds.  The JAX package pads the query batch to a power of two to bound
its compiled programs; eager PyTorch has none, so the port runs Q rows, with
the same results.

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
without a card raises.

Usage:
    python -m tapclip_tpu_torch.featurize --image-root corpus/ --out feats/
    python -m tapclip_tpu_torch.search --index feats/ --text "a red backpack" -k 5
    python -m tapclip_tpu_torch.search --index feats/ --dedup 0.96 --dedup-out pairs.csv
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

log = logging.getLogger("tapclip_tpu_torch")


class SearchIndex:
    """Exact cosine top-k over a ``featurize`` output directory.

    ``embeddings`` (``[N, D]``, a NumPy array or a tensor) rows are
    L2-normalized (``featurize`` writes them so), so cosine similarity is one
    product against the transposed index.
    """

    def __init__(self, embeddings, manifest: Sequence[Sequence[str]], device="cuda"):
        from tapclip_tpu_torch.featurize import resolve_device

        if embeddings.ndim != 2:
            raise ValueError(f"index must be [N, D], got {embeddings.shape}")
        if len(manifest) != embeddings.shape[0]:
            raise ValueError(f"manifest rows {len(manifest)} != index rows {embeddings.shape[0]}")
        self.manifest = manifest
        self.device = resolve_device(device)
        if not torch.is_tensor(embeddings):
            embeddings = torch.from_numpy(np.asarray(embeddings, np.float32))
        self._index = embeddings.to(self.device, torch.bfloat16)
        self.n, self.dim = embeddings.shape

    @classmethod
    def load(cls, index_dir, *, text: bool = False, device="cuda") -> "SearchIndex":
        """Load ``featurize`` output dir(s): ``image_embeddings.npy`` (or
        ``text_``) + ``manifest.csv``.  A list of dirs concatenates them in
        order (each rank of a partitioned ``featurize`` writes its own)."""
        dirs = [index_dir] if isinstance(index_dir, str) else list(index_dir)
        name = "text_embeddings.npy" if text else "image_embeddings.npy"
        embs, rows = [], []
        for d in dirs:
            embs.append(np.load(os.path.join(d, name)))
            with open(os.path.join(d, "manifest.csv")) as f:
                rows.extend(list(csv.reader(f))[1:])  # drop the header
        return cls(np.concatenate(embs) if len(embs) > 1 else embs[0], rows, device=device)

    def _scores(self, q: torch.Tensor) -> torch.Tensor:
        """``[Q, N]`` f32 cosines of bf16 ``q`` against the bf16 index.

        On the card one cuBLAS product reads the bf16 operands and writes
        f32 (``mm``'s ``out_dtype``); on the CPU, which has no such product,
        the operands are widened first.  Products of two bf16 values are
        exact in f32, so both are the f32 sum of the same terms."""
        if self._index.is_cuda:
            return torch.mm(q, self._index.T, out_dtype=torch.float32)
        return torch.matmul(q.float(), self._index.T.float())

    def search(self, queries, k: int = 5) -> Tuple[np.ndarray, np.ndarray]:
        """``[Q, D]`` unit-norm queries -> ``(scores [Q, k] f32, rows [Q, k])``;
        ``k`` is clamped to the corpus size."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[1] != self.dim:
            raise ValueError(f"query dim {queries.shape[1]} != index dim {self.dim}")
        k = min(int(k), self.n)
        q = torch.from_numpy(queries).to(self.device, torch.bfloat16)
        with torch.inference_mode():
            scores, rows = torch.topk(self._scores(q), k, dim=-1)
        return scores.cpu().numpy(), rows.cpu().numpy()

    def find_duplicates(self, threshold: float = 0.96, *, chunk: int = 1024) -> List[Tuple[int, int, float]]:
        """Near-duplicate pairs ``(i, j, cosine)`` with ``i < j`` and
        ``cosine >= threshold``, sorted by descending cosine.

        Data-curation dedup: a chunked self-product scores ``[chunk, N]`` at a
        time against the resident bf16 index (exact, no LSH), with the lower
        triangle masked on the device so only ``j > i`` pairs come back.  The
        last window is a full ``chunk`` rows ending at row N (the JAX
        package's one program shape), so pairs it shares with the window
        before are counted once.  Exact duplicates score about 0.996 and up
        through the bf16 index, so thresholds of 0.99 and above are not
        meaningful; 0.95-0.98 separates near-duplicates in practice.
        """
        pairs: List[Tuple[int, int, float]] = []
        cols = torch.arange(self.n, device=self.device)[None, :]
        with torch.inference_mode():
            for start in range(0, self.n, chunk):
                n_rows = min(chunk, self.n - start)
                if n_rows < chunk and self.n > chunk:
                    start, n_rows = self.n - chunk, chunk  # full-size tail window
                scores = self._scores(self._index[start:start + n_rows])
                rows = start + torch.arange(n_rows, device=self.device)[:, None]
                hit = torch.where(cols > rows, scores, torch.full_like(scores, -float("inf"))) >= threshold
                hi, hj = torch.nonzero(hit, as_tuple=True)
                s = scores[hi, hj].cpu().numpy()
                for a, b, v in zip(hi.cpu().tolist(), hj.cpu().tolist(), s.tolist()):
                    pairs.append((start + a, b, float(v)))
        return sorted(set(pairs), key=lambda t: -t[2])


def build_argparser() -> argparse.ArgumentParser:
    from tapclip_tpu_torch.featurize import add_tower_args

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--index", required=True, nargs="+", help="featurize output directory (several: in order)")
    p.add_argument("--text", help="text query (encoded by the text tower)")
    p.add_argument("--image", help="image-file query")
    p.add_argument("--row", type=int, help="corpus-row query (more-like-this)")
    p.add_argument("--dedup", type=float, default=None, metavar="THRESHOLD",
                   help="report near-duplicate pairs with cosine >= THRESHOLD instead of querying")
    p.add_argument("--dedup-out", default=None, help="write the duplicate pairs to this CSV")
    p.add_argument("--corpus", default="image", choices=["image", "text"],
                   help="which featurized matrix to search: the image embeddings (default) or the text "
                        "embeddings of featurize --embed-text")
    p.add_argument("-k", type=int, default=5)
    return add_tower_args(p)


def _dedup(index: SearchIndex, threshold: float, out_csv: Optional[str]) -> List[dict]:
    pairs = index.find_duplicates(threshold)

    def path(i):  # manifest rows are (index, path, ...) or (index, caption)
        m = index.manifest[i]
        return m[1] if len(m) > 1 else m[0]

    results = [{"row_a": i, "path_a": path(i), "row_b": j, "path_b": path(j), "score": round(s, 4)}
               for i, j, s in pairs]
    log.info("dedup: %d pairs >= %.3f over %d rows", len(results), threshold, index.n)
    for r in results[:20]:
        log.info("  %.4f  %s == %s", r["score"], r["path_a"], r["path_b"])
    if out_csv:
        with open(out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["row_a", "path_a", "row_b", "path_b", "score"])
            w.writeheader()
            w.writerows(results)
        log.info("dedup csv: %s", out_csv)
    return results


def _row_query(dirs: Sequence[str], row: int, corpus: str, n: int) -> np.ndarray:
    """Corpus row ``row`` (global across ``dirs``) read through a memory map,
    so one query row does not read the whole index again."""
    if row < 0:
        raise SystemExit(f"--row must be >= 0, got {row}")
    npy = "text_embeddings.npy" if corpus == "text" else "image_embeddings.npy"
    rest = row
    for d in dirs:
        emb = np.load(os.path.join(d, npy), mmap_mode="r")
        if rest < emb.shape[0]:
            return np.array(emb[rest : rest + 1], np.float32)
        rest -= emb.shape[0]
    raise SystemExit(f"--row {row} out of range ({n} rows)")


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if sum(x is not None for x in (args.text, args.image, args.row, args.dedup)) != 1:
        raise SystemExit("pass exactly one of --text / --image / --row / --dedup")
    index = SearchIndex.load(args.index, text=args.corpus == "text", device=args.device)
    if args.dedup is not None:
        return _dedup(index, args.dedup, args.dedup_out)

    if args.row is not None:
        q = _row_query(args.index, args.row, args.corpus, index.n)
    else:
        from tapclip_tpu_torch.featurize import (
            load_clip_params,
            make_image_embed_fn,
            make_text_embed_fn,
            tower_config,
        )

        cfg = tower_config(args)
        if cfg.embed_dim != index.dim:
            raise SystemExit(f"model embed_dim {cfg.embed_dim} != index dim {index.dim}")
        params = load_clip_params(cfg, args.pretrained, device=args.device)
        if args.text is not None:
            from tapclip_tpu_torch.data.tokenizer import get_tokenizer

            tok = get_tokenizer(args.bpe_path, cfg.context_length)
            q = make_text_embed_fn(cfg)(params, tok.tokenize([args.text])).cpu().numpy()
        else:
            from PIL import Image

            from tapclip_tpu_torch.data.preprocess import preprocess_pil

            with Image.open(args.image) as im:
                arr = preprocess_pil(im.convert("RGB"), cfg.image_size)
            q = make_image_embed_fn(cfg)(params, arr[None]).cpu().numpy()

    scores, rows = index.search(q, k=args.k)
    results = [{"rank": i, "row": int(r), "score": round(float(s), 4), "meta": index.manifest[int(r)]}
               for i, (s, r) in enumerate(zip(scores[0], rows[0]))]
    for r in results:
        print(f"#{r['rank']}  row={r['row']}  score={r['score']}  {r['meta']}")
    return results


if __name__ == "__main__":
    main()
