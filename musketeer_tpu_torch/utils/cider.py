"""CIDEr-D metric (Vedantam et al., CVPR 2015) — pure numpy.
(A copy of ``musketeer_tpu/utils/cider.py``.)

Fresh implementation of the published formula (the reference vendors
pyciderevalcap at utils/cider/): tf-idf weighted n-gram (n=1..4) cosine
similarity, with CIDEr-D's count clipping and gaussian length penalty
(sigma=6). Document frequencies come from the reference corpus of the
evaluation set (the standard "corpus" mode the caption task uses,
ref: tasks/mm_tasks/caption.py:139-189).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple


def _ngrams(tokens: List[str], n_max: int = 4) -> Dict[Tuple[str, ...], int]:
    counts: Dict[Tuple[str, ...], int] = defaultdict(int)
    for n in range(1, n_max + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i : i + n])] += 1
    return counts


class CiderD:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def compute_score(
        self, gts: Dict[str, List[str]], res: Dict[str, str]
    ) -> Tuple[float, Dict[str, float]]:
        """gts: id → list of reference strings; res: id → candidate string."""
        ids = list(res.keys())
        # document frequency over reference sets
        doc_freq: Dict[Tuple[str, ...], int] = defaultdict(int)
        ref_counts = {}
        for iid in ids:
            refs = [_ngrams(r.split()) for r in gts[iid]]
            ref_counts[iid] = refs
            seen = set()
            for rc in refs:
                seen.update(rc.keys())
            for ng in seen:
                doc_freq[ng] += 1
        n_docs = max(1, len(ids))
        log_ndocs = math.log(float(n_docs))

        def vec_norm_len(counts):
            """per-n tf-idf vectors, norms, and length."""
            vecs = [defaultdict(float) for _ in range(self.n)]
            norms = [0.0] * self.n
            length = 0
            for ng, cnt in counts.items():
                df = math.log(max(1.0, doc_freq[ng]))
                n = len(ng) - 1
                vecs[n][ng] = float(cnt) * (log_ndocs - df)
                norms[n] += vecs[n][ng] ** 2
                if n == 0:
                    length += cnt
            return vecs, [math.sqrt(x) for x in norms], length

        scores = {}
        for iid in ids:
            cand = _ngrams(res[iid].split())
            cvec, cnorm, clen = vec_norm_len(cand)
            score_n = [0.0] * self.n
            for rc in ref_counts[iid]:
                rvec, rnorm, rlen = vec_norm_len(rc)
                delta = float(clen - rlen)
                for n in range(self.n):
                    num = 0.0
                    for ng, w in cvec[n].items():
                        # CIDEr-D clips candidate counts at reference counts
                        num += min(w, rvec[n].get(ng, 0.0)) * rvec[n].get(ng, 0.0)
                    denom = cnorm[n] * rnorm[n]
                    val = num / denom if denom > 1e-9 else 0.0
                    val *= math.exp(-(delta**2) / (2 * self.sigma**2))
                    score_n[n] += val
            n_refs = max(1, len(ref_counts[iid]))
            scores[iid] = 10.0 * sum(s / n_refs for s in score_n) / self.n
        mean = sum(scores.values()) / max(1, len(scores))
        return mean, scores
