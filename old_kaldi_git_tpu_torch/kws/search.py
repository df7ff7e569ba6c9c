"""Keyword search (KWS) over decoded lattices.

Counterpart of old_kaldi_git_tpu/kws/search.py (reference src/kws/ and
kwsbin/lattice-to-kws-index, kws-index-union, kws-search), host code over
the port's lat/lattice.py.  Two query classes, as in the JAX package:

* single words: an inverted occurrence index word → [(utt, tbeg, tend,
  log posterior)] from each lattice's forward-backward arc posteriors,
  occurrences of a word sharing a start frame merged, mergeable across
  shards (kws-index-union is a dict merge);
* phrases: an exact (state × matched words × start frame) DP over the
  lattice that sums the posterior mass of every path realising the phrase,
  epsilon arcs allowed between its words, clustered by start frame.

The posterior of an arc weighs `lm_scale · graph + ac_scale · acoustic`.
A lattice read from an archive has no stored frame times: the
forward-backward recomputes them (`lattice_state_times`) before it uses
them.  The arithmetic and the number types are the JAX package's (numpy
float64 forward/backward arrays, np.logaddexp merges), so the pickled index
is its bytes; word ids and frames are stored as Python ints.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.lat.lattice import Lattice, _topo_order, lattice_state_times
from old_kaldi_git_tpu_torch.utils.log import get_logger

log = get_logger("kws")

NEG_INF = float("-inf")


@dataclasses.dataclass
class KwsHit:
    utt: str
    tbeg: int  # frames
    tend: int  # frames
    log_post: float  # log occurrence posterior (<= 0 up to rounding)


def _forward_backward(lat: Lattice, lm_scale: float, ac_scale: float
                      ) -> Tuple[np.ndarray, np.ndarray, float, List[int]]:
    """Log-domain total-path forward and backward scores over the lattice."""
    if any(t < 0 for t in lat.state_time):
        lattice_state_times(lat)
    order = _topo_order(lat)
    n = lat.num_states
    fwd = np.full(n, NEG_INF)
    fwd[lat.start] = 0.0
    for s in order:
        if fwd[s] == NEG_INF:
            continue
        for a in lat.arcs[s]:
            c = fwd[s] - lat.combined(a, lm_scale, ac_scale)
            fwd[a.nextstate] = np.logaddexp(fwd[a.nextstate], c)
    bwd = np.full(n, NEG_INF)
    for s in range(n):
        if lat.is_final(s):
            g, ac = lat.finals[s]
            bwd[s] = -(lm_scale * g + ac_scale * ac)
    for s in reversed(order):
        for a in lat.arcs[s]:
            c = -lat.combined(a, lm_scale, ac_scale) + bwd[a.nextstate]
            bwd[s] = np.logaddexp(bwd[s], c)
    return fwd, bwd, float(bwd[lat.start]), order


def search_phrase(lat: Lattice, keyword: Sequence[int], lm_scale: float = 1.0,
                  ac_scale: float = 0.1, min_log_post: float = np.log(1e-4)
                  ) -> List[Tuple[int, int, float]]:
    """[(tbeg, tend, log posterior)] of every occurrence of the word-id
    sequence, clustered by start frame.  DP state: (lattice state, words
    matched, tbeg) → log path mass from the start through the partial
    occurrence; a completed match at state s adds mass · β(s)."""
    k = len(keyword)
    if k == 0 or not set(keyword) <= {a.olabel for arcs in lat.arcs for a in arcs}:
        return []  # a word the lattice lacks: no path realises the phrase
    fwd, bwd, total, order = _forward_backward(lat, lm_scale, ac_scale)
    if total == NEG_INF:
        return []
    partial: List[Dict[Tuple[int, int], float]] = [{} for _ in range(lat.num_states)]
    hits: Dict[int, Tuple[float, int]] = {}  # tbeg -> (log mass, latest tend)

    def _add(d: Dict, key, val: float) -> None:
        old = d.get(key)
        d[key] = val if old is None else float(np.logaddexp(old, val))

    for s in order:
        for (j, tbeg), mass in list(partial[s].items()):
            if j == k:
                contrib = mass + bwd[s]
                if contrib - total >= min_log_post:
                    tend = int(lat.state_time[s])
                    old = hits.get(tbeg)
                    hits[tbeg] = ((contrib, tend) if old is None else
                                  (float(np.logaddexp(old[0], contrib)), max(old[1], tend)))
                del partial[s][(j, tbeg)]
        if fwd[s] == NEG_INF and not partial[s]:
            continue
        for a in lat.arcs[s]:
            w = -lat.combined(a, lm_scale, ac_scale)
            if a.olabel == 0:
                for key, mass in partial[s].items():
                    _add(partial[a.nextstate], key, mass + w)
            else:
                if a.olabel == keyword[0] and fwd[s] != NEG_INF:
                    _add(partial[a.nextstate], (1, int(lat.state_time[s])), fwd[s] + w)
                for (j, tbeg), mass in partial[s].items():
                    if j < k and keyword[j] == a.olabel:
                        _add(partial[a.nextstate], (j + 1, tbeg), mass + w)
    return [(tbeg, tend, min(mass - total, 0.0)) for tbeg, (mass, tend) in sorted(hits.items())]


def build_kws_index(lats: Dict[str, Lattice], lm_scale: float = 1.0, ac_scale: float = 0.1,
                    min_log_post: float = np.log(1e-4)) -> Dict[int, List[KwsHit]]:
    """word id → occurrences over a set of lattices (lattice-to-kws-index):
    each word arc's forward-backward posterior, occurrences of a word with
    one start frame merged (mass summed, the latest end kept)."""
    index: Dict[int, List[KwsHit]] = {}
    for utt, lat in lats.items():
        fwd, bwd, total, order = _forward_backward(lat, lm_scale, ac_scale)
        if total == NEG_INF:
            continue
        per: Dict[Tuple[int, int], Tuple[float, int]] = {}
        for s in order:
            if fwd[s] == NEG_INF:
                continue
            for a in lat.arcs[s]:
                if a.olabel == 0:
                    continue
                lp = fwd[s] - lat.combined(a, lm_scale, ac_scale) + bwd[a.nextstate] - total
                if lp < min_log_post:
                    continue
                key = (int(a.olabel), int(lat.state_time[s]))
                tend = int(lat.state_time[a.nextstate])
                old = per.get(key)
                per[key] = ((lp, tend) if old is None else
                            (float(np.logaddexp(old[0], lp)), max(old[1], tend)))
        for (word, tbeg), (lp, tend) in per.items():
            index.setdefault(word, []).append(KwsHit(utt, tbeg, tend, min(lp, 0.0)))
    return index


def merge_indexes(indexes: Sequence[Dict[int, List[KwsHit]]]) -> Dict[int, List[KwsHit]]:
    """kws-index-union: the shards' occurrence lists concatenated by word."""
    out: Dict[int, List[KwsHit]] = {}
    for idx in indexes:
        for word, hits in idx.items():
            out.setdefault(word, []).extend(hits)
    return out


def search_index(index: Dict[int, List[KwsHit]], word: int) -> List[KwsHit]:
    return sorted(index.get(word, []), key=lambda h: (h.utt, h.tbeg))


def save_index(index: Dict[int, List[KwsHit]], path: str) -> None:
    """The index as the JAX package pickles it: {word: [(utt, tbeg, tend,
    log_post)]}."""
    with open(path, "wb") as f:
        pickle.dump({w: [(h.utt, h.tbeg, h.tend, h.log_post) for h in hits]
                     for w, hits in index.items()}, f)


def load_index(path: str) -> Dict[int, List[KwsHit]]:
    with open(path, "rb") as f:
        raw = pickle.load(f)
    return {w: [KwsHit(*t) for t in hits] for w, hits in raw.items()}
