"""Pure-Python METEOR.

Parity target: the METEOR entry of
`CLIP_benchmark/clip_benchmark/metrics/captioning.py`
(pycocoevalcap, which shells out to the Java METEOR-1.5 jar). This is a
dependency-free reimplementation of the core algorithm (Banerjee & Lavie
2005 / Lavie & Agarwal 2007) with the standard exact + stem matcher stages
(no WordNet synonymy — the Java tool's third stage needs its bundled
resources):

  m unigram matches via staged alignment (exact first, then Porter stems),
  P = m/|cand|, R = m/|ref|, Fmean = P*R / (alpha*P + (1-alpha)*R),
  penalty = gamma * (chunks/m)^beta,  score = Fmean * (1 - penalty)

with alpha=0.9, beta=3, gamma=0.5; per segment the best reference is taken
and the corpus score is the segment mean.
"""
from __future__ import annotations

from typing import List, Sequence

__all__ = ["meteor", "meteor_segment", "porter_stem"]


# ----------------------------------------------------------------------------
# Porter stemmer (Porter 1980), classic definition
# ----------------------------------------------------------------------------
_VOWELS = "aeiou"


def _is_cons(w: str, i: int) -> bool:
    c = w[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(w, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences in [C](VC)^m[V]."""
    m, prev_v = 0, False
    for i in range(len(stem)):
        v = not _is_cons(stem, i)
        if prev_v and not v:
            m += 1
        prev_v = v
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _double_cons(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1)


def _cvc(w: str) -> bool:
    return (
        len(w) >= 3
        and _is_cons(w, len(w) - 3)
        and not _is_cons(w, len(w) - 2)
        and _is_cons(w, len(w) - 1)
        and w[-1] not in "wxy"
    )


def porter_stem(word: str) -> str:  # noqa: C901 — the algorithm is a rule list
    w = word.lower()
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _double_cons(w) and not w.endswith(("l", "s", "z")):
                w = w[:-1]
            elif _measure(w) == 1 and _cvc(w):
                w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # steps 2-4: suffix replacement tables, longest match first
    for suffixes, min_m in (
        (
            (
                ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
                ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
                ("alli", "al"), ("entli", "ent"), ("eli", "e"),
                ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
                ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
                ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
                ("iviti", "ive"), ("biliti", "ble"),
            ),
            0,
        ),
        (
            (
                ("icate", "ic"), ("ative", ""), ("alize", "al"),
                ("iciti", "ic"), ("ical", "ic"), ("ful", ""), ("ness", ""),
            ),
            0,
        ),
        (
            (
                ("al", ""), ("ance", ""), ("ence", ""), ("er", ""),
                ("ic", ""), ("able", ""), ("ible", ""), ("ant", ""),
                ("ement", ""), ("ment", ""), ("ent", ""), ("ou", ""),
                ("ism", ""), ("ate", ""), ("iti", ""), ("ous", ""),
                ("ive", ""), ("ize", ""),
            ),
            1,
        ),
    ):
        for suf, rep in sorted(suffixes, key=lambda p: -len(p[0])):
            if w.endswith(suf):
                stem = w[: len(w) - len(suf)]
                if _measure(stem) > min_m:
                    w = stem + rep
                break
        else:
            continue
    # step 4 special case: -ion only after s/t
    if w.endswith("ion") and len(w) > 4 and w[-4] in "st" and _measure(w[:-3]) > 1:
        w = w[:-3]
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        if _measure(stem) > 1 or (_measure(stem) == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ----------------------------------------------------------------------------
# alignment + score
# ----------------------------------------------------------------------------
def _align(cand: Sequence[str], ref: Sequence[str]):
    """Staged unigram alignment: exact matches first, Porter stems on the
    leftovers; each token matches at most once, earliest-available first.
    Returns [(cand_idx, ref_idx)]."""
    pairs = []
    used_c = [False] * len(cand)
    used_r = [False] * len(ref)
    for key in (lambda t: t, porter_stem):
        ref_keys = [key(t) for t in ref]
        for i, tok in enumerate(cand):
            if used_c[i]:
                continue
            k = key(tok)
            for j, rk in enumerate(ref_keys):
                if not used_r[j] and rk == k:
                    used_c[i] = used_r[j] = True
                    pairs.append((i, j))
                    break
    return sorted(pairs)


def _chunks(pairs) -> int:
    """Fewest runs of contiguous, identically-ordered matches."""
    n = 0
    prev = None
    for i, j in pairs:
        if prev is None or i != prev[0] + 1 or j != prev[1] + 1:
            n += 1
        prev = (i, j)
    return n


def meteor_segment(
    cand: Sequence[str],
    refs: Sequence[Sequence[str]],
    alpha: float = 0.9,
    beta: float = 3.0,
    gamma: float = 0.5,
) -> float:
    """Best-reference METEOR for one candidate (token lists)."""
    best = 0.0
    for ref in refs:
        if not cand or not ref:
            continue
        pairs = _align(cand, ref)
        m = len(pairs)
        if m == 0:
            continue
        p, r = m / len(cand), m / len(ref)
        fmean = p * r / (alpha * p + (1 - alpha) * r)
        penalty = gamma * (_chunks(pairs) / m) ** beta
        best = max(best, fmean * (1 - penalty))
    return best


def meteor(
    candidates: List[List[str]], references: List[List[List[str]]]
) -> float:
    """Corpus METEOR: mean of per-segment best-reference scores."""
    if not candidates:
        return 0.0
    return float(
        sum(meteor_segment(c, rs) for c, rs in zip(candidates, references))
        / len(candidates)
    )
