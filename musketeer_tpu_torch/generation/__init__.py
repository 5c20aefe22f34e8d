from .beam_search import beam_search, generate, tile_encoder_out
from .lexical import pack_constraints
from .trie import DenseTrie

__all__ = ["beam_search", "generate", "tile_encoder_out", "DenseTrie", "pack_constraints"]
