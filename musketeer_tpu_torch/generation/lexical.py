"""Lexically constrained decoding state, ordered constraints (port of
``musketeer_tpu/generation/lexical.py``).

A hypothesis's state is one pointer into a flat per-sentence sequence of
constraint tokens (Post & Vilar NAACL'18 dynamic beam allocation, Hu et al.
NAACL'19 ordered representation):

- constraints are phrases that must each appear, in order, in the output;
- ``ptr`` = number of constraint tokens consumed;
- generating ``cons[ptr]`` advances the pointer; generating anything else
  mid-phrase rewinds to the phrase start (partial phrases don't count);
- eos is blocked until ``ptr == total``;
- beam slots are allocated across "banks" (= ptr value) by stripe rank.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def pack_constraints(
    batch_constraints: Sequence[Sequence[Sequence[int]]], pad: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Phrase lists → (cons_tokens [B, C], phrase_start [B, C]).

    ``cons_tokens[b]`` is sentence b's phrases concatenated, pad-padded;
    ``phrase_start[b, c]`` is the flat index where the phrase containing
    position c begins (used for the mid-phrase rewind).
    """
    C = max(
        (sum(len(p) for p in sent) for sent in batch_constraints), default=1
    )
    C = max(C, 1)
    B = len(batch_constraints)
    cons = np.full((B, C), pad, np.int32)
    starts = np.zeros((B, C), np.int32)
    for b, sent in enumerate(batch_constraints):
        i = 0
        for phrase in sent:
            starts[b, i : i + len(phrase)] = i
            cons[b, i : i + len(phrase)] = np.asarray(phrase, np.int32)
            i += len(phrase)
        starts[b, i:] = i  # boundary: not mid-phrase
    return cons, starts


def constraint_transition(
    cons: torch.Tensor,  # [B, C] flat constraint tokens
    starts: torch.Tensor,  # [B, C] phrase-start index per position
    total: torch.Tensor,  # [B] number of constraint tokens
    ptr: torch.Tensor,  # [B, N] current pointers
    toks: torch.Tensor,  # [B, N] generated tokens
) -> torch.Tensor:
    """Ordered-constraint pointer update → new ptr [B, N]."""
    C = cons.shape[1]
    ptr_c = ptr.clamp_max(C - 1)
    expected = torch.gather(cons, 1, ptr_c)
    unfinished = ptr < total[:, None]
    advance = (toks == expected) & unfinished
    phrase_start = torch.gather(starts, 1, ptr_c)
    mid = (ptr > phrase_start) & unfinished
    # a mid-phrase mismatch that equals the phrase's first token restarts the
    # phrase with that token already consumed (fairseq's OrderedConstraintState)
    first = torch.gather(cons, 1, phrase_start.clamp_max(C - 1))
    rewind_to = torch.where(toks == first, phrase_start + 1, phrase_start)
    return torch.where(advance, ptr + 1, torch.where(mid, rewind_to, ptr))


def _better(score: torch.Tensor) -> torch.Tensor:
    """better[b, i, j]: candidate j outranks i (higher score, or equal and earlier)."""
    N = score.shape[1]
    ar = torch.arange(N, device=score.device)
    j_lt_i = (ar[None, :] < ar[:, None])[None]
    return (score[:, None, :] > score[:, :, None]) | (
        (score[:, None, :] == score[:, :, None]) & j_lt_i
    )


def stripe_rank(bank: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """Rank of each candidate within its bank by descending score
    (0 = best; ties broken by index) → [B, N] fp32."""
    same = bank[:, :, None] == bank[:, None, :]
    return (same & _better(score)).sum(dim=2).float()


def stripe_key(bank: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """Selection key: lexicographic (stripe rank asc, score desc) as one
    float — higher key = selected first: ``-(stripe_rank·N + global_rank)``,
    both ranks < N, so the key is an exact integer in fp32."""
    N = bank.shape[1]
    same = bank[:, :, None] == bank[:, None, :]
    better = _better(score)
    global_rank = better.sum(dim=2)  # unique 0..N-1 per row
    srank = (same & better).sum(dim=2)
    return -(srank * N + global_rank).float()
