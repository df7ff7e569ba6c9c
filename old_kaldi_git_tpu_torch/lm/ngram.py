"""Word n-gram LM estimation with count cutoffs.

Own copy of old_kaldi_git_tpu/lm/ngram.py (the in-tree role of the
reference's external kaldi_lm / SRILM estimation): `count_ngrams` and
`estimate_ngram_lm` (interpolated absolute discounting producing an `ArpaLm`
directly; rescoring estimates its full higher-order LM with it), and what
the system build's LM stage needs besides: relative-entropy pruning
(`prune_ngram_lm`), an ARPA writer (`write_arpa`) and `perplexity`.
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


def prune_ngram_lm(lm: ArpaLm, threshold: float = 1e-7) -> ArpaLm:
    """SRILM `ngram -prune`-style relative-entropy pruning (Stolcke 1998).

    Drops an explicit n-gram (order ≥ 2, and never one that is the history
    of a surviving higher-order entry) when the weighted log-prob change of
    re-deriving it through the backoff path is below `threshold`; then
    renormalizes the affected histories' backoff weights numerically."""
    if lm.order == 1:
        return lm
    ngrams = dict(lm.ngrams)

    # unigram marginals for weighting p(h, w) ≈ p_uni(h0)·…  (SRILM uses
    # the LM's own marginals; the unigram product is the standard cheap
    # surrogate)
    def weight(g: NgramKey) -> float:
        p = 1.0
        for w in g:
            e = lm.ngrams.get((w,))
            p *= math.exp(e[0]) if e else 1e-6
        return p

    is_history = set()
    for g in ngrams:
        if len(g) > 1:
            is_history.add(g[:-1])

    def backoff_prob(g: NgramKey) -> float:
        hist = ngrams.get(g[:-1])
        bo = math.exp(hist[1]) if hist else 1.0
        sub = g[1:]
        while True:
            e = ngrams.get(sub)
            if e is not None:
                return bo * math.exp(e[0])
            if len(sub) == 1:
                return bo * 1e-12
            h = ngrams.get(sub[:-1])
            bo *= math.exp(h[1]) if h else 1.0
            sub = sub[1:]

    dropped = 0
    for g in sorted(ngrams, key=len, reverse=True):
        if len(g) < 2 or g in is_history or g[-1] in (BOS,):
            continue
        e = ngrams[g]
        d = weight(g) * abs(e[0] - math.log(max(backoff_prob(g), 1e-12)))
        if d < threshold:
            del ngrams[g]
            dropped += 1

    # renormalize backoffs of histories that still exist
    by_hist: Dict[NgramKey, List[NgramKey]] = defaultdict(list)
    for g in ngrams:
        if len(g) > 1:
            by_hist[g[:-1]].append(g)
    for hist, gs in by_hist.items():
        he = ngrams.get(hist)
        if he is None:
            continue
        kept = sum(math.exp(ngrams[g][0]) for g in gs if g[-1] != BOS)
        lower = 0.0
        for g in gs:
            if g[-1] == BOS:
                continue
            sub = g[1:]
            bo = 1.0
            while sub not in ngrams and len(sub) > 1:
                h = ngrams.get(sub[:-1])
                bo *= math.exp(h[1]) if h else 1.0
                sub = sub[1:]
            se = ngrams.get(sub)
            lower += bo * (math.exp(se[0]) if se else 1e-12)
        bo = (1.0 - kept) / max(1.0 - lower, 1e-10)
        ngrams[hist] = (he[0], math.log(min(max(bo, 1e-10), 10.0)))
    log.info("prune_ngram_lm: dropped %d of %d ngrams (threshold %g)",
             dropped, len(lm.ngrams), threshold)
    return ArpaLm(order=lm.order, ngrams=ngrams)


def write_arpa(lm: ArpaLm, path: str) -> None:
    """Standard ARPA text (log10), readable by lm.arpa.parse_arpa and the
    reference's arpa2fst."""
    by_order: Dict[int, List[NgramKey]] = defaultdict(list)
    for g in lm.ngrams:
        by_order[len(g)].append(g)
    with open(path, "w") as f:
        f.write("\\data\\\n")
        for k in range(1, lm.order + 1):
            f.write(f"ngram {k}={len(by_order.get(k, []))}\n")
        for k in range(1, lm.order + 1):
            f.write(f"\n\\{k}-grams:\n")
            for g in sorted(by_order.get(k, [])):
                logp, bo = lm.ngrams[g]
                line = f"{logp / LOG10:.6f}\t{' '.join(g)}"
                if bo != 0.0:
                    line += f"\t{bo / LOG10:.6f}"
                f.write(line + "\n")
        f.write("\n\\end\\\n")


def perplexity(lm: ArpaLm, sentences: Iterable[Sequence[str]]) -> float:
    """Corpus perplexity (scoring events = words + </s>, SRILM convention)."""
    total_lp = 0.0
    n = 0
    for sent in sentences:
        total_lp += lm.score_sequence(sent)
        n += len(sent) + 1
    return math.exp(-total_lp / max(n, 1))
