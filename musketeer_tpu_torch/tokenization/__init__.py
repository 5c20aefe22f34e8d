from .bpe import GPT2BPE
from .dictionary import Dictionary, OFAVocab, default_vocab

__all__ = ["GPT2BPE", "Dictionary", "OFAVocab", "default_vocab"]
