"""Un-smoothed phone n-gram LM for the chain denominator.

Counterpart of old_kaldi_git_tpu/chain/phone_lm.py (reference
src/chain/language-model.cc LanguageModelEstimator): an n-gram over the
training phone sequences without discounting; a history with no
continuation backs off to its longest suffix that has one.  Built as an
acceptor over phones, tropical weights −log p, whose `state_hist` maps
each state to its history (the biphone den graph reads the left context
from it).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from old_kaldi_git_tpu_torch.fst.vector_fst import Arc, VectorFst
from old_kaldi_git_tpu_torch.utils.log import get_logger

log = get_logger("phone-lm")


def estimate_phone_lm(phone_seqs: Sequence[Sequence[int]], ngram_order: int = 2
                      ) -> VectorFst:
    """Phone sequences → acceptor over phones; states are histories of
    length order − 1, <s> = −1 and </s> = −2 in the counts."""
    if ngram_order < 1:
        raise ValueError(f"ngram_order {ngram_order} < 1")
    counts: List[Dict[Tuple[int, ...], Dict[int, int]]] = [{} for _ in range(ngram_order)]
    for seq in phone_seqs:
        padded = [-1] * (ngram_order - 1) + list(seq) + [-2]
        for i in range(ngram_order - 1, len(padded)):
            target = padded[i]
            for order in range(1, ngram_order + 1):
                d = counts[order - 1].setdefault(tuple(padded[i - order + 1: i]), {})
                d[target] = d.get(target, 0) + 1

    fst = VectorFst()
    state_of: Dict[Tuple[int, ...], int] = {}

    def get_state(hist: Tuple[int, ...]) -> int:
        while hist not in counts[len(hist)] and len(hist) > 0:
            hist = hist[1:]
        if hist not in state_of:
            state_of[hist] = fst.add_state()
        return state_of[hist]

    fst.set_start(get_state((-1,) * (ngram_order - 1)))
    for hist, targets in counts[ngram_order - 1].items():
        src = get_state(hist)
        total = sum(targets.values())
        for phone, c in sorted(targets.items()):
            w = -math.log(c / total)
            if phone == -2:
                fst.set_final(src, min(w, fst.finals[src]) if fst.is_final(src) else w)
            else:
                nxt = (hist + (phone,))[-(ngram_order - 1):] if ngram_order > 1 else ()
                fst.add_arc(src, Arc(phone, phone, w, get_state(nxt)))
    fst.connect()
    remap = fst.last_connect_map
    fst.state_hist = {remap[s]: hist for hist, s in state_of.items() if s in remap}
    log.info("phone LM: order %d, %d states, %d arcs", ngram_order, fst.num_states,
             fst.num_arcs)
    return fst
