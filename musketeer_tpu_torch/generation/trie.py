"""Token trie compiled to dense tables for constrained decoding (port of
``musketeer_tpu/generation/trie.py``).

The trie compiles once, at task set-up, into numpy tables, and into tensors
on the device given to it (none: host tables only, as a task builds it before
it knows its params' device; ``on(device)`` gives the trie on a device). The
beam search keeps an int cursor per hypothesis and updates it with a gather
and a binary search per step.

Semantics (the JAX package's): a dead cursor (a miss) allows exactly eos;
insertion is over ``answer_tokens + [eos]`` from the post-bos root. The
numpy copies of the tables serve the host-side walks of the batch builders
and of the allcand tables (``allowed_mask_np``, ``transition_np``).
"""

from __future__ import annotations

import copy
from typing import List, Sequence

import numpy as np
import torch

DEAD = -1
ROOT = 0
EOS = 2  # fixed by the OFA dictionary


class DenseTrie:
    """Static token trie as device tables.

    Attributes (tensors on ``device``; absent where ``device`` is None):
      root_mask:  [Vpad] bool — allowed first tokens
      root_next:  [Vpad] long — next node per first token (DEAD if absent)
      child_tokens: [N, Bmax] long — sorted children tokens per non-root node
                    (row i = node i+1), padded with Vpad (sorts last)
      child_next:   [N, Bmax] long
    """

    def __init__(self, sequences: Sequence[Sequence[int]], vocab_size: int, device):
        self.vocab_size = vocab_size
        children: List[dict] = [dict()]  # node id -> {token: node}
        for seq in sequences:
            cur = ROOT
            for tok in seq:
                nxt = children[cur].get(tok)
                if nxt is None:
                    nxt = len(children)
                    children.append(dict())
                    children[cur][tok] = nxt
                cur = nxt
        self.num_nodes = len(children)

        root_mask = np.zeros((vocab_size,), bool)
        root_next = np.full((vocab_size,), DEAD, np.int64)
        for tok, nxt in children[ROOT].items():
            root_mask[tok] = True
            root_next[tok] = nxt

        n_nonroot = max(1, self.num_nodes - 1)
        bmax = max([1] + [len(children[i]) for i in range(1, self.num_nodes)])
        child_tokens = np.full((n_nonroot, bmax), vocab_size, np.int64)
        child_next = np.full((n_nonroot, bmax), DEAD, np.int64)
        for i in range(1, self.num_nodes):
            for j, (tok, nxt) in enumerate(sorted(children[i].items())):
                child_tokens[i - 1, j] = tok
                child_next[i - 1, j] = nxt
        self.max_branch = bmax
        self._np_root_mask = root_mask
        self._np_root_next = root_next
        self._np_child_tokens = child_tokens
        self._np_child_next = child_next
        self._on = {}  # device → this trie with its tables there
        self.device = None
        if device is not None:
            self._place(torch.device(device))

    def _place(self, device: torch.device) -> "DenseTrie":
        as_t = lambda a: torch.from_numpy(a).to(device)
        self.root_mask = as_t(self._np_root_mask)
        self.root_next = as_t(self._np_root_next)
        self.child_tokens = as_t(self._np_child_tokens)
        self.child_next = as_t(self._np_child_next)
        self.device = self.root_mask.device  # e.g. cuda:0 for "cuda"
        return self

    def on(self, device) -> "DenseTrie":
        """This trie with its device tables on ``device``: itself where they
        are there already, else a copy made once per device and kept; this
        trie's own tables do not move."""
        device = torch.device(device)
        if device == self.device:
            return self
        if device not in self._on:
            twin = copy.copy(self)  # shares the numpy tables
            twin._on = {}
            self._on[device] = twin._place(device)
        return self._on[device]

    @classmethod
    def from_answers(cls, vocab, answers: Sequence[str], device) -> "DenseTrie":
        """Build from answer strings (ref encodes ``' ' + answer`` + eos,
        tasks/mm_tasks/vqa_gen.py:160-167)."""
        seqs = [
            list(vocab.encode_text(" " + answer.strip())) + [vocab.eos]
            for answer in answers
        ]
        return cls(seqs, vocab.padded_size, device)

    # -- device ops ------------------------------------------------------------

    def allowed_mask(self, nodes: torch.Tensor, V: int) -> torch.Tensor:
        """nodes [N] → [N, V] bool of allowed next tokens; DEAD → {eos}.

        Each row's children are scattered into a row of V + 1 columns (the
        last one takes the padding entries) and the extra column dropped; the
        root and dead rows are the root mask and the eos row."""
        if nodes.device != self.device:
            raise ValueError(f"the trie's tables are on {self.device}, the cursors on "
                             f"{nodes.device}: use trie.on(device)")
        n = nodes.shape[0]
        toks = self.child_tokens[nodes.clamp_min(1) - 1]  # [N, Bmax]
        cols = torch.where(toks < V, toks, V)
        mask = torch.zeros((n, V + 1), dtype=torch.bool, device=nodes.device)
        mask.scatter_(1, cols, True)
        mask = mask[:, :V]
        mask = torch.where((nodes == ROOT)[:, None], self.root_mask[None, :V], mask)
        eos_only = torch.arange(V, device=nodes.device) == EOS
        return torch.where((nodes == DEAD)[:, None], eos_only[None, :], mask)

    def transition(self, nodes: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """(nodes [N], chosen tokens [N]) → next nodes [N]."""
        row_of = nodes.clamp_min(1) - 1
        row = self.child_tokens[row_of]  # [N, Bmax]
        idx = torch.searchsorted(row, tokens[:, None].to(row.dtype))
        idx = idx.clamp_max(row.shape[1] - 1)
        hit = torch.gather(row, 1, idx)[:, 0] == tokens
        nxt = torch.gather(self.child_next[row_of], 1, idx)[:, 0]
        nonroot = torch.where(hit, nxt, DEAD)
        from_root = self.root_next[tokens.clamp_max(self.vocab_size - 1)]
        out = torch.where(nodes == ROOT, from_root, nonroot)
        return torch.where(nodes == DEAD, DEAD, out)

    # -- host ops (numpy; for batch builders) ------------------------------------

    def allowed_mask_np(self, node: int) -> np.ndarray:
        """Host equivalent of :meth:`allowed_mask` for one node."""
        V = self.vocab_size
        if node == DEAD:
            m = np.zeros((V,), bool)
            m[EOS] = True
            return m
        if node == ROOT:
            return self._np_root_mask.copy()
        row = self._np_child_tokens[node - 1]
        m = np.zeros((V,), bool)
        m[row[row < V]] = True
        return m

    def transition_np(self, node: int, token: int) -> int:
        """Host equivalent of :meth:`transition` for one (node, token)."""
        if node == DEAD:
            return DEAD
        if node == ROOT:
            return int(self._np_root_next[token]) if token < self.vocab_size else DEAD
        row = self._np_child_tokens[node - 1]
        j = int(np.searchsorted(row, token))
        if j < len(row) and row[j] == token:
            return int(self._np_child_next[node - 1, j])
        return DEAD
