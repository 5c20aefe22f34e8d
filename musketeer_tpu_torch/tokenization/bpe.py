"""GPT-2 byte-level BPE encoder (port of ``musketeer_tpu/tokenization/bpe.py``).

The JAX package splits text with the ``regex`` module's GPT-2 pattern, whose
``\\p{L}`` and ``\\p{N}`` classes the standard library's ``re`` lacks. Here the
same pattern is written for ``re``: the letter, number and white-space
classes are built once, as code-point ranges, from ``unicodedata``:

- ``\\p{L}``: general categories Lu, Ll, Lt, Lm, Lo;
- ``\\p{N}``: Nd, Nl, No;
- ``\\s``: Unicode's White_Space property (Zs, Zl, Zp, U+0009–U+000D and
  U+0085), as ``regex`` has it. ``re``'s own ``\\s`` also takes U+001C–U+001F,
  which ``regex`` does not.

``tests/test_torch_port_host.py`` holds each class equal to ``regex``'s on
every code point that ``unicodedata`` assigns, and the ids equal to the JAX
package's on a mixed corpus. Assets are the port's own copy of
``assets/bpe/`` (``encoder.json`` / ``vocab.bpe``, the upstream GPT-2
vocabulary).
"""

from __future__ import annotations

import functools
import json
import os
import re
import sys
import unicodedata
from typing import Dict, List, Tuple

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets", "bpe")

_WHITE_SPACE_CATEGORIES = ("Zs", "Zl", "Zp")
_WHITE_SPACE_EXTRA = tuple(range(0x09, 0x0E)) + (0x85,)


def _ranges(flags: List[bool]) -> List[Tuple[int, int]]:
    """Maximal runs [lo, hi] of code points whose flag is set."""
    out: List[Tuple[int, int]] = []
    lo = None
    for cp, on in enumerate(flags + [False]):
        if on and lo is None:
            lo = cp
        elif not on and lo is not None:
            out.append((lo, cp - 1))
            lo = None
    return out


def _char_class(ranges: List[Tuple[int, int]]) -> str:
    """Code-point ranges → the body of an ``re`` character class."""
    esc = lambda cp: f"\\U{cp:08x}"
    return "".join(esc(lo) if lo == hi else f"{esc(lo)}-{esc(hi)}" for lo, hi in ranges)


@functools.lru_cache()
def unicode_classes() -> Dict[str, List[Tuple[int, int]]]:
    """The pattern's classes as code-point ranges: ``L``, ``N`` and ``space``."""
    cats = [unicodedata.category(chr(cp)) for cp in range(sys.maxunicode + 1)]
    return {
        "L": _ranges([c in ("Lu", "Ll", "Lt", "Lm", "Lo") for c in cats]),
        "N": _ranges([c in ("Nd", "Nl", "No") for c in cats]),
        "space": _ranges([c in _WHITE_SPACE_CATEGORIES or cp in _WHITE_SPACE_EXTRA
                          for cp, c in enumerate(cats)]),
    }


@functools.lru_cache()
def gpt2_pattern() -> "re.Pattern[str]":
    """GPT-2's split pattern (contractions, words, numbers, punctuation, spaces):
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``."""
    c = {k: _char_class(v) for k, v in unicode_classes().items()}
    L, N, S = c["L"], c["N"], c["space"]
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{L}]+| ?[{N}]+| ?[^{S}{L}{N}]+|[{S}]+(?![^{S}])|[{S}]+"
    )


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Map bytes 0..255 to printable unicode chars (GPT-2's reversible scheme)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class GPT2BPE:
    """Byte-level BPE codec over the GPT-2 vocabulary."""

    def __init__(self, encoder_json: str | None = None, vocab_bpe: str | None = None):
        encoder_json = encoder_json or os.path.join(_ASSET_DIR, "encoder.json")
        vocab_bpe = vocab_bpe or os.path.join(_ASSET_DIR, "vocab.bpe")
        with open(encoder_json, "r", encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(vocab_bpe, "r", encoding="utf-8") as f:
            merges = f.read().split("\n")[1:-1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.pattern = gpt2_pattern()
        self._cache: Dict[str, str] = {}

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token)
        pairs = _get_pairs(word) if len(word) > 1 else set()
        if not pairs:
            return token
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
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text → list of GPT-2 ids."""
        ids: List[int] = []
        for token in self.pattern.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def decode(self, ids: List[int]) -> str:
        """List of GPT-2 ids → text."""
        text = "".join(self.decoder[i] for i in ids)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace"
        )

    def is_beginning_of_word(self, token_str: str) -> bool:
        if token_str in ("<s>", "<pad>", "</s>", "<unk>", "<mask>"):
            return True
        try:
            decoded = self.decode([int(token_str)])
        except ValueError:
            return True
        return decoded.startswith(" ") or decoded.startswith("\n")
