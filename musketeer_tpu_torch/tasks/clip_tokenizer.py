"""CLIP text tokenizer, OpenAI's simple byte-level BPE with end-of-word
markers (port of ``musketeer_tpu/tasks/clip_tokenizer.py``).

The JAX package splits text with the ``regex`` module's pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
[^\\s\\p{L}\\p{N}]+`` under ``IGNORECASE``. Here the same pattern is written
for the standard library's ``re``, its letter, number and white-space classes
built as code-point ranges from ``unicodedata`` (``tokenization/bpe.py``'s
``unicode_classes``, as for GPT-2's pattern). ``tests/test_torch_port_image_gen.py``
holds the ids equal to the JAX package's. The vocabulary asset is the port's
own byte-for-byte copy of ``assets/clip_bpe_vocab.txt.gz``.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import Dict, List

import numpy as np

from ..tokenization.bpe import _char_class, bytes_to_unicode, unicode_classes

_VOCAB = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "assets", "clip_bpe_vocab.txt.gz"
)


@functools.lru_cache()
def clip_pattern() -> "re.Pattern[str]":
    """The JAX package's split pattern for ``re``. ``regex`` applies
    ``IGNORECASE`` to the literals (``'s`` also takes ``'S`` and ``'ſ``) and to
    the classes, where it only changes U+0345 (COMBINING GREEK YPOGEGRAMMENI,
    whose case variants are letters): neither class takes it, so it is
    dropped. Here the flag is scoped to the literals and U+0345 is left out
    of the last class."""
    c = {k: _char_class(v) for k, v in unicode_classes().items()}
    L, N, S = c["L"], c["N"], c["space"]
    return re.compile(
        r"(?i:<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d)"
        rf"|[{L}]+|[{N}]|[^{S}{L}{N}\u0345]+"
    )


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return " ".join(text.strip().split()).lower()


class ClipTokenizer:
    def __init__(self, bpe_path: str = _VOCAB):
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder: Dict[str, int] = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)

        def pairs_of(w):
            return {(w[i], w[i + 1]) for i in range(len(w) - 1)}

        pairs = pairs_of(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = pairs_of(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in clip_pattern().findall(_basic_clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids


@functools.lru_cache()
def _default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(texts: List[str], context_length: int = 77) -> np.ndarray:
    """Texts → [N, context_length] int32 (sot + bpe + eot, truncated)."""
    tok = _default_tokenizer()
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        ids = [tok.sot] + tok.encode(text)[: context_length - 2] + [tok.eot]
        out[i, : len(ids)] = ids
    return out
