"""COCO caption metrics: BLEU-1..4, ROUGE-L, CIDEr — a plain-Python copy of
``gpt2_image_captioning_tpu/evaluation/metrics.py``, so the port never
imports the JAX package (the tests hold the two to 1e-12).

Re-implementations matching ``pycocoevalcap`` to numerical precision:

- **BLEU** — corpus-level modified n-gram precision with the *closest*
  effective-reference-length brevity penalty, the ``tiny``/``small``
  smoothing constants, and per-item scores (``bleu_scorer.py`` semantics).
- **ROUGE-L** — LCS-based F-measure with beta=1.2, max over references,
  ``split(" ")`` tokenization quirk preserved.
- **CIDEr** — TF-IDF-weighted n-gram cosine consensus (n=1..4) with
  hypothesis-count clipping, the length-difference gaussian penalty
  (sigma=6), df computed over the reference corpus, and the historical
  quirk that sentence "length" is the *bigram* count.

All scorers expose ``compute_score(gts, res) -> (score, per_item_scores)``
with ``gts``/``res`` being ``{image_id: [caption, ...]}`` dicts, exactly like
pycocoevalcap, so they are drop-in for the reference's evaluation loop.
Captions are expected raw (the reference applies no PTB tokenization).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Mapping, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------

def _ngram_counts(words: Sequence[str], n: int) -> dict[tuple, int]:
    counts: dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i : i + k])] += 1
    return counts


def _closest_reflen(reflens: Sequence[int], testlen: int) -> int:
    return min((abs(l - testlen), l) for l in reflens)[1]


class Bleu:
    """Corpus BLEU-1..N with closest-length brevity penalty."""

    def __init__(self, n: int = 4):
        self._n = n

    def compute_score(
        self,
        gts: Mapping[int, Sequence[str]],
        res: Mapping[int, Sequence[str]],
    ) -> tuple[list[float], list[list[float]]]:
        n = self._n
        small, tiny = 1e-9, 1e-15
        total_guess = [0] * n
        total_correct = [0] * n
        total_testlen = 0
        total_reflen = 0.0
        per_item: list[list[float]] = [[] for _ in range(n)]

        for img_id in gts:
            hypo = res[img_id]
            refs = gts[img_id]
            assert isinstance(hypo, (list, tuple)) and len(hypo) == 1
            assert isinstance(refs, (list, tuple)) and len(refs) >= 1

            test_words = hypo[0].split()
            testlen = len(test_words)
            ref_words = [r.split() for r in refs]
            reflens = [len(w) for w in ref_words]

            # max reference count per n-gram (modified precision numerator cap)
            maxcounts: dict[tuple, int] = {}
            for rw in ref_words:
                for ngram, cnt in _ngram_counts(rw, n).items():
                    if cnt > maxcounts.get(ngram, 0):
                        maxcounts[ngram] = cnt

            guess = [max(0, testlen - k + 1) for k in range(1, n + 1)]
            correct = [0] * n
            for ngram, cnt in _ngram_counts(test_words, n).items():
                correct[len(ngram) - 1] += min(maxcounts.get(ngram, 0), cnt)

            reflen = _closest_reflen(reflens, testlen)
            total_testlen += testlen
            total_reflen += reflen
            for k in range(n):
                total_guess[k] += guess[k]
                total_correct[k] += correct[k]

            # per-item score (with its own brevity penalty)
            bleu = 1.0
            ratio = (testlen + tiny) / (reflen + small)
            for k in range(n):
                bleu *= (float(correct[k]) + tiny) / (float(guess[k]) + small)
                item = bleu ** (1.0 / (k + 1))
                if ratio < 1:
                    item *= math.exp(1 - 1 / ratio)
                per_item[k].append(item)

        scores: list[float] = []
        bleu = 1.0
        ratio = (total_testlen + tiny) / (total_reflen + small)
        for k in range(n):
            bleu *= (float(total_correct[k]) + tiny) / (float(total_guess[k]) + small)
            s = bleu ** (1.0 / (k + 1))
            if ratio < 1:
                s *= math.exp(1 - 1 / ratio)
            scores.append(s)
        return scores, per_item

    def method(self) -> str:
        return "Bleu"


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------

def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Length of the longest common subsequence (classic DP, O(len(a)*len(b)))."""
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, start=1):
            cur[j] = prev[j - 1] + 1 if x == y else max(cur[j - 1], prev[j])
        prev = cur
    return prev[len(b)]


class Rouge:
    """ROUGE-L F-measure (beta=1.2), max precision/recall over references."""

    def __init__(self):
        self.beta = 1.2

    def calc_score(self, candidate: Sequence[str], refs: Sequence[str]) -> float:
        assert len(candidate) == 1
        assert len(refs) > 0
        # NB: split(" ") — not split() — to match pycocoevalcap exactly
        # (consecutive spaces yield empty tokens there too).
        token_c = candidate[0].split(" ")
        prec, rec = [], []
        for reference in refs:
            token_r = reference.split(" ")
            lcs = _lcs_len(token_r, token_c)
            prec.append(lcs / float(len(token_c)))
            rec.append(lcs / float(len(token_r)))
        prec_max, rec_max = max(prec), max(rec)
        if prec_max != 0 and rec_max != 0:
            b2 = self.beta**2
            return ((1 + b2) * prec_max * rec_max) / (rec_max + b2 * prec_max)
        return 0.0

    def compute_score(
        self,
        gts: Mapping[int, Sequence[str]],
        res: Mapping[int, Sequence[str]],
    ) -> tuple[float, np.ndarray]:
        scores = [self.calc_score(res[img_id], gts[img_id]) for img_id in gts]
        return float(np.mean(scores)), np.array(scores)

    def method(self) -> str:
        return "Rouge"


# ---------------------------------------------------------------------------
# CIDEr
# ---------------------------------------------------------------------------

class Cider:
    """Consensus-based image description evaluation (TF-IDF n-gram cosine)."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self._n = n
        self._sigma = sigma

    def compute_score(
        self,
        gts: Mapping[int, Sequence[str]],
        res: Mapping[int, Sequence[str]],
    ) -> tuple[float, np.ndarray]:
        n, sigma = self._n, self._sigma
        img_ids = list(gts.keys())

        crefs = [[_ngram_counts(r.split(), n) for r in gts[i]] for i in img_ids]
        ctest = [_ngram_counts(res[i][0].split(), n) for i in img_ids]

        # document frequency over reference sets
        doc_freq: dict[tuple, float] = defaultdict(float)
        for refs in crefs:
            for ngram in {ng for ref in refs for ng in ref}:
                doc_freq[ngram] += 1

        ref_len = np.log(float(len(crefs)))

        def tfidf_vectors(cnts: Mapping[tuple, int]):
            vec = [defaultdict(float) for _ in range(n)]
            norm = [0.0] * n
            length = 0
            for ngram, term_freq in cnts.items():
                df = np.log(max(1.0, doc_freq[ngram]))
                k = len(ngram) - 1
                vec[k][ngram] = float(term_freq) * (ref_len - df)
                norm[k] += vec[k][ngram] ** 2
                if k == 1:  # historical quirk: "length" = bigram count
                    length += term_freq
            return vec, [np.sqrt(x) for x in norm], length

        def clipped_cosine(vec_h, vec_r, norm_h, norm_r, len_h, len_r) -> np.ndarray:
            delta = float(len_h - len_r)
            val = np.zeros(n)
            for k in range(n):
                for ngram, _ in vec_h[k].items():
                    # hypothesis counts clipped to the reference's
                    val[k] += min(vec_h[k][ngram], vec_r[k][ngram]) * vec_r[k][ngram]
                if norm_h[k] != 0 and norm_r[k] != 0:
                    val[k] /= norm_h[k] * norm_r[k]
                val[k] *= np.e ** (-(delta**2) / (2 * sigma**2))
            return val

        scores = []
        for test, refs in zip(ctest, crefs):
            vec, norm, length = tfidf_vectors(test)
            score = np.zeros(n)
            for ref in refs:
                vec_r, norm_r, len_r = tfidf_vectors(ref)
                score += clipped_cosine(vec, vec_r, norm, norm_r, length, len_r)
            scores.append(float(np.mean(score)) / len(refs) * 10.0)
        arr = np.array(scores)
        return float(np.mean(arr)), arr

    def method(self) -> str:
        return "CIDEr"
