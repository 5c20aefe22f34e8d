from .beam_search import beam_search

__all__ = ["beam_search"]
