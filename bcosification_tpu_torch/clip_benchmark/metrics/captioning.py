"""Captioning metric (CoCa-style generative eval).

Parity target: `CLIP_benchmark/clip_benchmark/metrics/
captioning.py` — reference pipeline: ``model.generate(images)`` -> decode ->
pycocoevalcap scorers (BLEU-1..4, METEOR, ROUGE_L, CIDEr, SPICE).

pycocoevalcap shells out to Java (PTB tokenizer, METEOR, SPICE); this
implementation is dependency-free and computes the pure-Python scorers with
the same corpus-level semantics:

- BLEU-1..4: corpus-level clipped n-gram precision, "closest" reference
  length brevity penalty (pycocoevalcap Bleu default).
- ROUGE_L: LCS F-measure with beta=1.2, max over references, mean over images.
- CIDEr (CIDEr-D, as pycocoevalcap's Cider computes): tf-idf 1..4-gram cosine
  with count clipping and gaussian length penalty (sigma=6), x10.

METEOR uses pycocoevalcap's Meteor when the package is importable (as the
reference does), falling back to the native implementation (meteor.py);
SPICE uses pycocoevalcap's Spice when importable and is reported as the
string "unsupported" otherwise (the Java scene-graph toolchain cannot be
reimplemented dependency-free, but METEOR's core algorithm can).

The model bundle must expose ``generate(images) -> list[str]`` (decoded
captions); B-cosification never trains a captioner, so this is exercised by
CoCa-style models plugged into the same CLI (`--task captioning`).
"""
from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

import numpy as np

__all__ = [
    "evaluate",
    "bleu_scores",
    "rouge_l",
    "cider_d",
    "meteor_score",
    "spice_score",
    "ptb_tokenize",
]

_PUNCT = re.compile(r"[\"'`.,!?;:()\[\]{}<>@#$%^&*_\-+=/\\|~]")


def ptb_tokenize(s: str) -> List[str]:
    """Approximation of the PTBTokenizer normalisation (lowercase, strip
    punctuation, whitespace split)."""
    return _PUNCT.sub(" ", s.lower()).split()


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu_scores(
    candidates: List[List[str]], references: List[List[List[str]]], max_n: int = 4
) -> List[float]:
    """Corpus BLEU-1..max_n with closest-reference brevity penalty."""
    clipped = [0] * max_n
    total = [0] * max_n
    cand_len = 0
    ref_len = 0
    for cand, refs in zip(candidates, references):
        cand_len += len(cand)
        ref_len += min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            cn = _ngrams(cand, n)
            if not cn:
                continue
            max_ref = Counter()
            for r in refs:
                for g, c in _ngrams(r, n).items():
                    max_ref[g] = max(max_ref[g], c)
            clipped[n - 1] += sum(min(c, max_ref.get(g, 0)) for g, c in cn.items())
            total[n - 1] += sum(cn.values())
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    scores = []
    log_p_sum = 0.0
    for n in range(1, max_n + 1):
        # tiny epsilon mirrors pycocoevalcap's guard against zero counts
        p = (clipped[n - 1] + 1e-16) / max(total[n - 1], 1)
        log_p_sum += math.log(p)
        scores.append(bp * math.exp(log_p_sum / n))
    return scores


def _lcs(a: Sequence[str], b: Sequence[str]) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(
    candidates: List[List[str]], references: List[List[List[str]]], beta: float = 1.2
) -> float:
    """ROUGE-L F(beta) — max over references, mean over images."""
    vals = []
    for cand, refs in zip(candidates, references):
        best = 0.0
        for r in refs:
            if not cand or not r:
                continue
            l = _lcs(cand, r)
            prec, rec = l / len(cand), l / len(r)
            if prec and rec:
                f = (1 + beta**2) * prec * rec / (rec + beta**2 * prec)
                best = max(best, f)
        vals.append(best)
    return float(np.mean(vals)) if vals else 0.0


def cider_d(
    candidates: List[List[str]],
    references: List[List[List[str]]],
    max_n: int = 4,
    sigma: float = 6.0,
) -> float:
    """CIDEr-D: clipped tf-idf n-gram cosine + gaussian length penalty, x10."""
    n_images = len(references)
    doc_freq = [defaultdict(int) for _ in range(max_n)]
    for refs in references:
        for n in range(1, max_n + 1):
            seen = set()
            for r in refs:
                seen.update(_ngrams(r, n).keys())
            for g in seen:
                doc_freq[n - 1][g] += 1
    log_ref = math.log(max(n_images, 1))

    def vec(tokens, n):
        counts = _ngrams(tokens, n)
        length = sum(counts.values())
        out = {}
        norm = 0.0
        for g, c in counts.items():
            idf = log_ref - math.log(max(doc_freq[n - 1].get(g, 0), 1.0))
            w = (c / max(length, 1)) * idf if length else 0.0
            out[g] = w
            norm += w * w
        return out, math.sqrt(norm)

    scores = []
    for cand, refs in zip(candidates, references):
        per_n = []
        for n in range(1, max_n + 1):
            cv, cnorm = vec(cand, n)
            acc = 0.0
            for r in refs:
                rv, rnorm = vec(r, n)
                # CIDEr-D: clip candidate tf-idf at the reference's value
                num = sum(min(w, rv.get(g, 0.0)) * rv.get(g, 0.0) for g, w in cv.items())
                if cnorm and rnorm:
                    sim = num / (cnorm * rnorm)
                    delta = len(cand) - len(r)
                    sim *= math.exp(-(delta**2) / (2 * sigma**2))
                    acc += sim
            per_n.append(acc / max(len(refs), 1))
        scores.append(10.0 * float(np.mean(per_n)))
    return float(np.mean(scores)) if scores else 0.0


def meteor_score(
    candidates: List[List[str]], references: List[List[List[str]]]
) -> float:
    """METEOR via pycocoevalcap's Meteor when importable AND working
    (matching the reference's `captioning.py:9` scorer list; the Java
    METEOR-1.5 jar includes the WordNet-synonymy stage), falling back to the
    native pure-Python implementation (meteor.py: exact + Porter-stem
    stages). The two agree closely on corpora dominated by exact/stem
    matches (import-gated differential:
    tests/test_caption_metric_properties.py::test_meteor_differential)."""
    try:
        from pycocoevalcap.meteor.meteor import Meteor  # noqa: gated optional
    except ImportError:
        Meteor = None
    if Meteor is not None:
        gts = {i: [" ".join(r) for r in refs] for i, refs in enumerate(references)}
        res = {i: [" ".join(c)] for i, c in enumerate(candidates)}
        try:
            score, _ = Meteor().compute_score(gts, res)
            return float(score)
        except Exception as e:  # noqa: BLE001 — jar/JRE failures degrade to
            # the native scorer instead of crashing evaluate()
            import warnings

            warnings.warn(f"pycocoevalcap METEOR failed ({type(e).__name__}: "
                          f"{e}); falling back to the native implementation")
    from bcosification_tpu_torch.clip_benchmark.metrics.meteor import meteor

    return meteor(candidates, references)


def spice_score(
    candidates: List[List[str]], references: List[List[List[str]]]
):
    """SPICE via pycocoevalcap when importable (matching the reference's
    `captioning.py:12` scorer list); the Java scene-graph toolchain cannot be
    reimplemented dependency-free, so without the package this stays the
    honest string "unsupported" rather than a silent NaN."""
    try:
        from pycocoevalcap.spice.spice import Spice  # noqa: gated optional dep
    except ImportError:
        return "unsupported"
    gts = {i: [" ".join(r) for r in refs] for i, refs in enumerate(references)}
    res = {i: [" ".join(c)] for i, c in enumerate(candidates)}
    try:
        score, _ = Spice().compute_score(gts, res)
    except Exception as e:  # noqa: BLE001 — the pip package imports fine
        # without a JRE, but compute_score shells out to the Java scene-graph
        # toolchain; a missing/broken JVM must degrade like a missing package
        # instead of crashing the whole captioning evaluate()
        import warnings

        warnings.warn(f"SPICE scorer failed ({type(e).__name__}: {e}); "
                      "reporting 'unsupported'")
        return "unsupported"
    return float(score)


def evaluate(model_bundle, loader, verbose: bool = False) -> Dict[str, float]:
    """Generate a caption per image, score against references."""
    generate = getattr(model_bundle, "generate", None)
    if generate is None:
        raise NotImplementedError(
            "captioning requires a generative model bundle with .generate() "
            "(e.g. CoCa); B-cos CLIP bundles are contrastive-only"
        )
    candidates: List[List[str]] = []
    references: List[List[List[str]]] = []
    for images, captions in loader:
        gen = generate(images)
        for pred, refs in zip(gen, captions):
            refs = refs if isinstance(refs, (list, tuple)) else [refs]
            candidates.append(ptb_tokenize(pred))
            references.append([ptb_tokenize(t) for t in refs])
    bleus = bleu_scores(candidates, references)
    metrics = {
        **{f"Bleu_{i+1}": b for i, b in enumerate(bleus)},
        # pycocoevalcap's Java METEOR when importable, native otherwise
        "METEOR": meteor_score(candidates, references),
        "ROUGE_L": rouge_l(candidates, references),
        "CIDEr": cider_d(candidates, references),
        # real pycocoevalcap Spice when the package is importable; the
        # honest string "unsupported" otherwise (not a silent NaN)
        "SPICE": spice_score(candidates, references),
    }
    if verbose:
        for k, v in metrics.items():
            print(f"{k}: {v:.3f}" if isinstance(v, float) else f"{k}: {v}")
    return metrics
