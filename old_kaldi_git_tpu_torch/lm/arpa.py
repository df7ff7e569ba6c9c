"""ARPA n-gram LMs: parsing and Katz-backoff scoring (the const-arpa role).

Own copy of the parts of old_kaldi_git_tpu/lm/arpa.py that lattice
rescoring uses (reference src/lm/{arpa-file-parser,const-arpa-lm}.{h,cc}):
read the \\data\\ / \\N-grams: sections (log10 probabilities and backoffs,
kept in natural log) and score a word after a history with Katz backoff.
Compiling G (`arpa_to_fst`) is graph building and stays with the JAX
package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("arpa")

LOG10 = math.log(10.0)

BOS, EOS, UNK = "<s>", "</s>", "<unk>"


@dataclasses.dataclass
class ArpaLm:
    """In-memory trie LM (the const-arpa equivalent)."""

    order: int
    # ngram (tuple of words) → (logprob_e, backoff_e) in natural log
    ngrams: Dict[Tuple[str, ...], Tuple[float, float]]

    def logprob(self, word: str, history: Tuple[str, ...]) -> float:
        """Katz backoff P(word | history), natural log."""
        history = tuple(history[-(self.order - 1):]) if self.order > 1 else ()
        backoff = 0.0
        while True:
            entry = self.ngrams.get(history + (word,))
            if entry is not None:
                return backoff + entry[0]
            if not history:
                unk = self.ngrams.get((UNK,))
                return backoff + (unk[0] if unk else -20.0)
            hist_entry = self.ngrams.get(history)
            backoff += hist_entry[1] if hist_entry else 0.0
            history = history[1:]

    def score_sequence(self, words: Sequence[str], bos: bool = True,
                       eos: bool = True) -> float:
        """Total natural-log probability of a sentence."""
        hist: Tuple[str, ...] = (BOS,) if bos else ()
        total = 0.0
        for w in list(words) + ([EOS] if eos else []):
            total += self.logprob(w, hist)
            hist = (hist + (w,))[-(self.order - 1):] if self.order > 1 else ()
        return total


def parse_arpa(text: str) -> ArpaLm:
    lines = iter(text.splitlines())
    counts: List[int] = []
    for ln in lines:
        if ln.strip() == "\\data\\":
            break
    else:
        raise KaldiError("ARPA: no \\data\\ section")
    for ln in lines:
        ln = ln.strip()
        if ln.startswith("ngram"):
            counts.append(int(ln.split("=")[1]))
        elif ln.endswith("-grams:"):
            current_order = int(ln.strip("\\").split("-")[0])
            break
        elif not ln:
            continue
    else:
        raise KaldiError("ARPA: no n-gram sections")
    order = len(counts)
    ngrams: Dict[Tuple[str, ...], Tuple[float, float]] = {}
    while True:
        done = False
        for ln in lines:
            ln = ln.strip()
            if not ln:
                continue
            if ln == "\\end\\":
                done = True
                break
            if ln.endswith("-grams:"):
                current_order = int(ln.strip("\\").split("-")[0])
                break
            parts = ln.split()
            logp = float(parts[0]) * LOG10
            words = tuple(parts[1 : 1 + current_order])
            backoff = (
                float(parts[1 + current_order]) * LOG10
                if len(parts) > 1 + current_order
                else 0.0
            )
            ngrams[words] = (logp, backoff)
        if done:
            break
    log.info("ARPA: order %d, %d ngrams", order, len(ngrams))
    return ArpaLm(order=order, ngrams=ngrams)
