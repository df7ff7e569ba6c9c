"""ARPA n-gram LMs: parsing and Katz-backoff scoring (the const-arpa role).

Own copy of the parts of old_kaldi_git_tpu/lm/arpa.py that lattice
rescoring and the chain graph use (reference
src/lm/{arpa-file-parser,const-arpa-lm}.{h,cc} and arpa-lm-compiler): read
the \\data\\ / \\N-grams: sections (log10 probabilities and backoffs, kept
in natural log), score a word after a history with Katz backoff, and
compile the grammar acceptor G (`arpa_to_fst`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from old_kaldi_git_tpu_torch.fst.symbols import SymbolTable
from old_kaldi_git_tpu_torch.fst.vector_fst import EPS, Arc, VectorFst
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


def arpa_to_fst(lm: ArpaLm, words: SymbolTable,
                backoff_symbol: Optional[int] = None) -> VectorFst:
    """ARPA → G acceptor (reference arpa-lm-compiler): states are
    histories, word arcs weigh −logprob, backoff arcs carry #0 on the input
    side and −backoff; <s> is the start state, </s> a final weight.  Words
    not in the table are skipped with a warning.  States and arcs in the
    JAX package's order (its mkgraph gives the same HCLG from it)."""
    if backoff_symbol is None:
        if "#0" not in words:
            raise KaldiError("word table lacks #0 for LM backoff arcs")
        backoff_symbol = words["#0"]
    fst = VectorFst()
    state_of: Dict[Tuple[str, ...], int] = {}

    def get_state(hist: Tuple[str, ...]) -> int:
        if hist not in state_of:
            state_of[hist] = fst.add_state()
        return state_of[hist]

    fst.set_start(get_state((BOS,) if lm.order > 1 else ()))
    get_state(())
    skipped = 0
    for ngram, (logp, _backoff) in lm.ngrams.items():
        hist, word = ngram[:-1], ngram[-1]
        if word == BOS:
            continue  # <s> is not an event; its entry only carries a backoff
        src = get_state(hist if lm.order > 1 else ())
        if word == EOS:
            if not fst.is_final(src) or -logp < fst.finals[src]:
                fst.set_final(src, -logp)
            continue
        if word not in words:
            skipped += 1
            continue
        nxt = (hist + (word,))[-(lm.order - 1):] if lm.order > 1 else ()
        while nxt and nxt not in lm.ngrams:
            nxt = nxt[1:]  # back off to a history that exists as a context
        fst.add_arc(src, Arc(words[word], words[word], -logp, get_state(nxt)))
    for hist in list(state_of):
        if not hist:
            continue
        entry = lm.ngrams.get(hist)
        shorter = hist[1:]
        while shorter and shorter not in state_of and shorter not in lm.ngrams:
            shorter = shorter[1:]
        dst = get_state(shorter if shorter in state_of or shorter == () else ())
        fst.add_arc(state_of[hist], Arc(backoff_symbol, EPS,
                                        -(entry[1] if entry else 0.0), dst))
    fst.connect()
    fst.arcsort("ilabel")
    if skipped:
        log.warning("arpa_to_fst: skipped %d ngrams with OOV words", skipped)
    log.info("G: %d states, %d arcs", fst.num_states, fst.num_arcs)
    return fst
