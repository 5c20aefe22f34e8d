"""Model vocabulary: fairseq-compatible dictionary with OFA extensions (a copy of
``musketeer_tpu/tokenization/dictionary.py`` over the port's own BPE assets).

Reproduces the exact vocab layout the reference builds in
tasks/ofa_task.py:93-116: 4 specials (<s>=0 <pad>=1 </s>=2 <unk>=3), the
50260 entries of utils/BPE/dict.txt, then ``<mask>``, ``<code_0..8191>``,
``<bin_0..999>`` — total 59457 ids. The text/code/bin region boundaries are
what constrained generation keys on (ref: models/sequence_generator.py:395-397
hardcodes 59457).

Checkpoint compatibility requires this layout verbatim; the output projection's
128-token blocks want a 128-multiple embedding table, so :attr:`padded_size` rounds up and the model
masks logits above :attr:`__len__`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .bpe import GPT2BPE

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets", "bpe")

DEFAULT_CODE_DICT_SIZE = 8192  # ref: tasks/ofa_task.py code_dict_size default
DEFAULT_NUM_BINS = 1000  # ref: tasks/ofa_task.py num_bins default


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Dictionary:
    """Token-string ↔ id mapping with fairseq's special-symbol conventions."""

    def __init__(
        self,
        bos: str = "<s>",
        pad: str = "<pad>",
        eos: str = "</s>",
        unk: str = "<unk>",
    ):
        self.symbols: List[str] = []
        self.counts: List[int] = []
        self.indices: Dict[str, int] = {}
        self.bos_index = self.add_symbol(bos)
        self.pad_index = self.add_symbol(pad)
        self.eos_index = self.add_symbol(eos)
        self.unk_index = self.add_symbol(unk)

    def __len__(self) -> int:
        return len(self.symbols)

    def __getitem__(self, idx: int) -> str:
        return self.symbols[idx] if idx < len(self.symbols) else "<unk>"

    def add_symbol(self, word: str, n: int = 1) -> int:
        if word in self.indices:
            idx = self.indices[word]
            self.counts[idx] += n
            return idx
        idx = len(self.symbols)
        self.indices[word] = idx
        self.symbols.append(word)
        self.counts.append(n)
        return idx

    def index(self, sym: str) -> int:
        return self.indices.get(sym, self.unk_index)

    def bos(self) -> int:
        return self.bos_index

    def pad(self) -> int:
        return self.pad_index

    def eos(self) -> int:
        return self.eos_index

    def unk(self) -> int:
        return self.unk_index

    @classmethod
    def load(cls, path: str) -> "Dictionary":
        """Load a fairseq ``dict.txt`` (one ``symbol count`` per line)."""
        d = cls()
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                sym, _, cnt = line.rpartition(" ")
                d.add_symbol(sym, n=int(cnt) if cnt else 1)
        return d

    def encode_symbols(self, symbols: Sequence[str]) -> np.ndarray:
        return np.array([self.index(s) for s in symbols], dtype=np.int32)

    def string(self, ids: Sequence[int], remove_special: bool = True) -> str:
        specials = {self.bos_index, self.pad_index, self.eos_index}
        syms = [
            self.symbols[i]
            for i in ids
            if not (remove_special and int(i) in specials)
        ]
        return " ".join(syms)


class OFAVocab:
    """The full OFA/Musketeer vocabulary: BPE codec + extended dictionary.

    Single object the rest of the framework uses for text↔ids. Region layout
    (for vocab defaults): text [0, 50265), codes [50265, 58457),
    bins [58457, 59457).
    """

    def __init__(
        self,
        dict_path: Optional[str] = None,
        code_dict_size: int = DEFAULT_CODE_DICT_SIZE,
        num_bins: int = DEFAULT_NUM_BINS,
    ):
        self.bpe = GPT2BPE()
        self.dict = Dictionary.load(dict_path or os.path.join(_ASSET_DIR, "dict.txt"))
        self.mask_index = self.dict.add_symbol("<mask>")
        self.code_dict_size = code_dict_size
        self.num_bins = num_bins
        self.code_start = len(self.dict)
        for i in range(code_dict_size):
            self.dict.add_symbol(f"<code_{i}>")
        self.bin_start = len(self.dict)
        for i in range(num_bins):
            self.dict.add_symbol(f"<bin_{i}>")
        self.vocab_size = len(self.dict)
        # TPU-friendly embedding rows; ids >= vocab_size are never produced.
        self.padded_size = _round_up(self.vocab_size, 128)

    # -- token id conveniences -------------------------------------------------
    @property
    def bos(self) -> int:
        return self.dict.bos_index

    @property
    def pad(self) -> int:
        return self.dict.pad_index

    @property
    def eos(self) -> int:
        return self.dict.eos_index

    @property
    def unk(self) -> int:
        return self.dict.unk_index

    def bin_token(self, b: int) -> int:
        return self.bin_start + b

    def code_token(self, c: int) -> int:
        return self.code_start + c

    # -- encode/decode ----------------------------------------------------------
    def encode_text(
        self,
        text: str,
        length: Optional[int] = None,
        append_bos: bool = False,
        append_eos: bool = False,
        use_bpe: bool = True,
    ) -> np.ndarray:
        """Text → model ids (ref semantics: data/ofa_dataset.py:31-43).

        The text is encoded VERBATIM — callers include leading spaces
        exactly like the reference datasets do (e.g. ``" what does the
        image describe?"`` vs TEP prompts that start unspaced).
        """
        if use_bpe:
            toks = [str(t) for t in self.bpe.encode(text)] if text else []
        else:
            toks = text.strip().split()
        if length is not None:
            toks = toks[:length]
        ids = [self.dict.index(t) for t in toks]
        if append_bos:
            ids = [self.dict.bos_index] + ids
        if append_eos:
            ids = ids + [self.dict.eos_index]
        return np.array(ids, dtype=np.int32)

    def decode_ids(self, ids: Sequence[int], strip_special: bool = True) -> str:
        """Model ids → text. Non-text symbols (<bin_k>/<code_k>) pass through."""
        out_parts: List[str] = []
        gpt2_ids: List[int] = []

        def flush():
            if gpt2_ids:
                out_parts.append(self.bpe.decode(gpt2_ids))
                gpt2_ids.clear()

        specials = {self.bos, self.pad, self.eos}
        for i in ids:
            i = int(i)
            if strip_special and i in specials:
                continue
            sym = self.dict[i]
            try:
                gpt2_ids.append(int(sym))
            except ValueError:
                flush()
                out_parts.append(" " + sym)
        flush()
        return "".join(out_parts).strip()


_DEFAULT_VOCAB: Optional[OFAVocab] = None


def default_vocab() -> OFAVocab:
    """Process-wide shared vocabulary (loading BPE assets takes ~1s)."""
    global _DEFAULT_VOCAB
    if _DEFAULT_VOCAB is None:
        _DEFAULT_VOCAB = OFAVocab()
    return _DEFAULT_VOCAB
