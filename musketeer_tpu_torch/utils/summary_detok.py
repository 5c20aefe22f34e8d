"""Gigaword summary detokenization normalizer.
(A copy of ``musketeer_tpu/utils/summary_detok.py``.)

Behavioral parity with the reference's ``fix_tokenization`` (ref:
tasks/nlg_tasks/gigaword.py:42-120): PTB-style bracket escapes, quote
pairing, contraction re-splitting, digit/decimal/acronym rejoining and
dash merging. Applied to generated hypotheses before ROUGE so the scores
are comparable to the paper's (the raw-detok ROUGE differs measurably).

The reference's exact quirks are preserved deliberately, including the
acronym rule advancing the cursor by 2 (not to the scan end), which makes
trailing acronym periods re-emitted as standalone tokens.
"""

from __future__ import annotations

import string

_PTB = {
    "(": "-lrb-", ")": "-rrb-",
    "[": "-lsb-", "]": "-rsb-",
    "{": "-lcb-", "}": "-rcb-",
    "[UNK]": "UNK", "&": "&amp;", "<": "&lt;", ">": "&gt;",
}

_PUNCT = set(string.punctuation)


def _digitish(w: str) -> bool:
    """Digits possibly with grouping commas ("3,000")."""
    return all(c.isdigit() or c == "," for c in w)


def fix_tokenization(text: str) -> str:
    toks = text.split()
    out: list = []
    open_double = False  # toggles `` / ''
    open_single = False  # toggles ` / '

    i = 0
    glue_after_dash = False  # previous token ended in a merged hyphen
    while i < len(toks):
        t = toks[i]
        nxt = toks[i + 1] if i + 1 < len(toks) else None
        nxt2 = toks[i + 2] if i + 2 < len(toks) else None
        merged_dash = False

        if t in _PTB:
            out.append(_PTB[t])
            i += 1
        elif t == '"':
            out.append("''" if open_double else "``")
            open_double = not open_double
            i += 1
        elif t == "'" and out and out[-1].endswith("n") and nxt == "t":
            # "do n ' t" → "do n't"
            out[-1] = out[-1][:-1]
            out.append("n't")
            i += 2
        elif t == "'" and nxt in ("s", "d", "ll"):
            out.append("'" + nxt)
            i += 2
        elif t == "'":
            out.append("'" if open_single else "`")
            open_single = not open_single
            i += 1
        elif t == "." and nxt == "." and nxt2 == ".":
            out.append("...")
            i += 3
        elif t == "," and out and _digitish(out[-1]) and nxt is not None and _digitish(nxt):
            # "3 , 000" → "3,000"
            out[-1] += "," + nxt
            i += 2
        elif t == "." and out and out[-1].isdigit() and nxt is not None and nxt.isdigit():
            # "3 . 03" → "3.03"
            out[-1] += "." + nxt
            i += 2
        elif (
            t == "."
            and out
            and len(out[-1]) == 1
            and out[-1].isupper()
            and nxt is not None
            and len(nxt) == 1
            and nxt.isupper()
            and nxt2 == "."
        ):
            # "U . N ." → "U.N." (cursor advances 2, as in the reference)
            k = i + 3
            while k + 2 < len(toks):
                if len(toks[k + 1]) == 1 and toks[k + 1].isupper() and toks[k + 2] == ".":
                    k += 2
                else:
                    break
            out[-1] += "".join(toks[i:k])
            i += 2
        elif t == "-":
            if nxt == "-":
                out.append("--")
                i += 2
            elif i == len(toks) - 1 or i == 0:
                out.append("-")
                i += 1
            elif out[-1] not in string.punctuation and nxt is not None and nxt[0] not in _PUNCT:
                # NB: substring (not set) membership for the LHS, matching the
                # reference's `x in string.punctuation` on multi-char tokens
                out[-1] += "-"
                i += 1
                merged_dash = True
            else:
                out.append("-")
                i += 1
        elif glue_after_dash and out and t[0] not in _PUNCT:
            out[-1] += t
            i += 1
        else:
            out.append(t)
            i += 1
        glue_after_dash = merged_dash
    return " ".join(out)


def normalize_summary_hyp(hyp: str) -> str:
    """Full reference hypothesis normalization before ROUGE
    (ref: gigaword.py:283 — lower, fix_tokenization, <unk>→' unk', 1→#)."""
    h = fix_tokenization(hyp.lower().strip())
    return h.replace("<unk>", " unk").replace("1", "#")
