"""Word n-gram LM estimation with count cutoffs.

Own copy of `count_ngrams` and `estimate_ngram_lm` of
old_kaldi_git_tpu/lm/ngram.py (the in-tree role of the reference's external
kaldi_lm / SRILM estimation): interpolated absolute discounting producing
an `ArpaLm` directly.  Rescoring estimates its full higher-order LM with it.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from old_kaldi_git_tpu_torch.lm.arpa import BOS, EOS, LOG10, UNK, ArpaLm
from old_kaldi_git_tpu_torch.utils.log import get_logger

log = get_logger("ngram")

NgramKey = Tuple[str, ...]


def count_ngrams(
    sentences: Iterable[Sequence[str]], order: int
) -> List[Dict[NgramKey, int]]:
    """Per-order ngram counts; index k holds (k+1)-gram counts.

    Sentences are padded with one <s> of history and a </s> event (the
    SRILM convention: <s> is context only, never predicted)."""
    counts: List[Dict[NgramKey, int]] = [defaultdict(int) for _ in range(order)]
    for sent in sentences:
        toks = [BOS] + list(sent) + [EOS]
        n = len(toks)
        for i in range(1, n):
            for k in range(1, order + 1):
                if i - k + 1 < 0:
                    break
                counts[k - 1][tuple(toks[i - k + 1 : i + 1])] += 1
    return [dict(c) for c in counts]


def estimate_ngram_lm(
    sentences: Iterable[Sequence[str]],
    order: int = 3,
    cutoffs: Optional[Sequence[int]] = None,
    discount: float = 0.7,
    vocab: Optional[Sequence[str]] = None,
    add_unk: bool = False,
) -> ArpaLm:
    """Interpolated absolute discounting → backoff ARPA (natural-log).

    cutoffs[k-1]: k-grams with count <= cutoff are dropped before
    estimation (SRILM -gtNmin); default (0, 0, 1, 1, ...) keeps all
    unigrams/bigrams and trigrams+ seen at least twice.
    vocab: closed vocabulary; every word gets a unigram (add-0.5 floor),
    so L∘G never loses lexicon words.
    """
    sentences = [list(s) for s in sentences]
    if cutoffs is None:
        cutoffs = [0, 0] + [1] * max(0, order - 2)
    if len(cutoffs) < order:
        cutoffs = list(cutoffs) + [cutoffs[-1]] * (order - len(cutoffs))
    counts = count_ngrams(sentences, order)
    for k in range(1, order):
        cut = cutoffs[k]
        if cut > 0:
            counts[k] = {g: c for g, c in counts[k].items() if c > cut}

    # ---- closed vocabulary for the unigram floor
    uni_counts = Counter()
    for (w,), c in counts[0].items():
        if w != BOS:
            uni_counts[w] += c
    vocab_set = set(uni_counts)
    if vocab is not None:
        vocab_set |= set(vocab)
    if add_unk:
        vocab_set.add(UNK)
    vocab_set.discard(BOS)
    vocab_set.add(EOS)
    V = len(vocab_set)
    total = sum(uni_counts.values())
    alpha = 0.5
    # p_uni sums to exactly 1 over vocab_set (add-alpha)
    p_uni: Dict[str, float] = {
        w: (uni_counts.get(w, 0) + alpha) / (total + alpha * V)
        for w in sorted(vocab_set)
    }

    ngrams: Dict[NgramKey, Tuple[float, float]] = {}
    for w, p in p_uni.items():
        ngrams[(w,)] = (math.log(p), 0.0)
    # <s>: context-only entry, tiny prob, backoff filled below
    ngrams[(BOS,)] = (-99.0 * LOG10, 0.0)

    def arpa_prob(ngram: NgramKey) -> float:
        """Backoff probability of ngram under what is built so far
        (orders below the one in progress are complete)."""
        while True:
            e = ngrams.get(ngram)
            if e is not None:
                return math.exp(e[0])
            if len(ngram) == 1:
                return p_uni.get(ngram[0], 1.0 / max(V, 1))
            hist = ngrams.get(ngram[:-1])
            bo = math.exp(hist[1]) if hist is not None else 1.0
            return bo * arpa_prob(ngram[1:])

    # ---- higher orders, bottom-up
    for k in range(2, order + 1):
        kcounts = counts[k - 1]
        by_hist: Dict[NgramKey, List[Tuple[str, int]]] = defaultdict(list)
        for g, c in kcounts.items():
            by_hist[g[:-1]].append((g[-1], c))
        for hist, items in sorted(by_hist.items()):
            ch = sum(c for _, c in items)
            if ch <= 0:
                continue
            lam = discount * len(items) / ch
            kept_p = 0.0
            lower_p = 0.0
            new_entries = []
            for w, c in items:
                if w == BOS:
                    continue
                pl = arpa_prob(hist[1:] + (w,))
                p = max(c - discount, 0.0) / ch + lam * pl
                new_entries.append(((hist + (w,)), p))
                kept_p += p
                lower_p += pl
            # numeric backoff weight: leftover mass / leftover lower mass
            bo = (1.0 - kept_p) / max(1.0 - lower_p, 1e-10)
            bo = min(max(bo, 1e-10), 10.0)
            for g, p in new_entries:
                ngrams[g] = (math.log(max(p, 1e-12)), 0.0)
            e = ngrams.get(hist)
            if e is None:
                # history was pruned at its own order (cutoff) but has
                # continuations: re-create it with its backoff estimate
                ngrams[hist] = (math.log(max(arpa_prob(hist), 1e-12)),
                                math.log(bo))
            else:
                ngrams[hist] = (e[0], math.log(bo))
    lm = ArpaLm(order=order, ngrams=ngrams)
    log.info(
        "estimate_ngram_lm: order %d, %s ngrams",
        order,
        "/".join(
            str(sum(1 for g in ngrams if len(g) == k))
            for k in range(1, order + 1)
        ),
    )
    return lm
