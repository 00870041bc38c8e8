"""CLIP BPE tokenizer: a copy of ``tapclip_tpu/data/tokenizer.py``.

The port carries its own copy because any ``tapclip_tpu`` import pulls in
jax.  The token ids must match the JAX package's exactly: the prompt bank's
template embeddings and the context init at positions ``5 : 5+P`` come from
them.  ``tests/port/test_torch_package.py`` holds the two equal.

* With a merges file (path via ``bpe_path=`` or the ``TAPCLIP_BPE_PATH`` env
  var) it reproduces CLIP token ids exactly.
* Without one it falls back to a *byte-level* tokenizer: the same byte
  encoder and special tokens but zero merges.

Output contract matches open_clip's tokenizer: ``tokenize(texts)`` returns an
``[N, context_length]`` int32 array, ``<|startoftext|>`` + ids +
``<|endoftext|>``, zero-padded, truncated-with-EOT when over length.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

try:
    import regex as _re  # supports \p{L}/\p{N} like the original CLIP pattern

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # the stdlib pattern approximates \p{L}/\p{N}
    import re as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+""",
        _re.IGNORECASE,
    )

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
DEFAULT_CONTEXT_LENGTH = 77
# Original CLIP merge-table truncation: merges[1 : 49152 - 256 - 2 + 1].
_FULL_MERGE_COUNT = 49152 - 256 - 2 + 1


@functools.lru_cache()
def bytes_to_unicode():
    """Byte -> printable-unicode mapping (GPT-2/CLIP byte-level BPE)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


try:  # ftfy is optional
    import ftfy as _ftfy
except ImportError:
    _ftfy = None


def basic_clean(text: str) -> str:
    # The original runs ftfy.fix_text first; gate on availability (it is a
    # no-op for well-formed input).
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    import re

    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """CLIP byte-level BPE tokenizer."""

    def __init__(
        self,
        bpe_path: Optional[str] = None,
        context_length: int = DEFAULT_CONTEXT_LENGTH,
    ):
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        if bpe_path is None:
            bpe_path = os.environ.get("TAPCLIP_BPE_PATH") or None
        merges: List[tuple] = []
        if bpe_path is not None and os.path.exists(bpe_path):
            if bpe_path.endswith(".gz"):
                data = gzip.open(bpe_path).read().decode("utf-8")
            else:
                with open(bpe_path, "r", encoding="utf-8") as f:
                    data = f.read()
            lines = data.split("\n")
            lines = lines[1 : _FULL_MERGE_COUNT]
            merges = [tuple(m.split()) for m in lines if m]
            self.is_fallback = False
        else:
            self.is_fallback = True

        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend([SOT_TEXT, EOT_TEXT])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {merge: i for i, merge in enumerate(merges)}
        self.cache = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}
        self.sot_token = self.encoder[SOT_TEXT]
        self.eot_token = self.encoder[EOT_TEXT]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )

    def tokenize(
        self,
        texts: Union[str, Sequence[str]],
        context_length: Optional[int] = None,
    ) -> np.ndarray:
        """Texts -> ``[N, context_length]`` int32 ids (CLIP layout)."""
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(tokens) > context_length:
                tokens = tokens[:context_length]
                tokens[-1] = self.eot_token
            result[i, : len(tokens)] = tokens
        return result

    # open_clip's tokenizer object is directly callable (clip_wrapper.py:27,
    # prompt_learner.py:32).
    __call__ = tokenize


@functools.lru_cache(maxsize=4)
def get_tokenizer(
    bpe_path: Optional[str] = None, context_length: int = DEFAULT_CONTEXT_LENGTH
) -> SimpleTokenizer:
    return SimpleTokenizer(bpe_path=bpe_path, context_length=context_length)
