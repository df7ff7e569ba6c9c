"""Minimum Bayes Risk decoding (exact sausage statistics).

Own copy of old_kaldi_git_tpu/lat/mbr.py (reference src/lat/sausages.{h,cc}
MinimumBayesRisk, the lattice-mbr-decode / lattice-to-ctm-conf backend):
host code, plain Python and numpy, in the JAX package's order of
operations (float64), so it gives its numbers.  It implements the
expected-edit-distance recursion of Xu, Povey, Mangu & Zhu (2011), "Minimum
Bayes Risk decoding and system combination based on a recursion for edit
distance".

Given a word lattice (CompactLattice) and a current hypothesis
R = (r_1..r_Q):

  alpha_dash(s, q) = expected edit distance between R[1..q] and a random
  path prefix ending at state s (paths weighted by their posteriors);
  computed in topological order with the three edit moves per incoming
  arc (match/substitute, insert arc word, delete r_q), taking the min —
  eq. (22)-(25) of the paper / AccStats in the reference.

A backward occupancy pass retraces the argmin moves, distributing each
(state, q) posterior mass into gamma(q, w): the probability that sausage
position q holds word w (w = 0 is epsilon).  MbrDecode then replaces
r_q := argmax_w gamma(q, w) and iterates to convergence; the final gammas
are the sausage (confusion network) with confidences, and expected word
begin/end times come from the same occupancies.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.lat.determinize import CompactLattice
from old_kaldi_git_tpu_torch.lat.lattice import INF
from old_kaldi_git_tpu_torch.utils.log import get_logger

log = get_logger("mbr")


@dataclasses.dataclass
class MbrResult:
    words: List[int]  # MBR hypothesis (no epsilons)
    confidences: List[float]  # per output word
    # full sausage: per position, [(word-or-0, prob)] sorted desc
    sausage: List[List[Tuple[int, float]]]
    times: List[Tuple[float, float]]  # expected (begin, end) frame per word
    expected_wer: float  # expected edit distance of `words` vs the lattice


def _edit(a: int, b: int) -> float:
    """l(a, b): 0 for match, 1 otherwise; 0 for eps-eps."""
    if a == b:
        return 0.0
    return 1.0


def minimum_bayes_risk(
    clat: CompactLattice,
    lm_scale: float = 1.0,
    ac_scale: float = 0.1,
    max_iters: int = 4,
    frame_shift: float = 1.0,
) -> Optional[MbrResult]:
    if clat.num_states == 0:
        return None
    S = clat.num_states
    # --- topological order + incoming-arc lists ---------------------------
    indeg = [0] * S
    for s in range(S):
        for a in clat.arcs[s]:
            indeg[a.nextstate] += 1
    order = [s for s in range(S) if indeg[s] == 0]
    i = 0
    while i < len(order):
        for a in clat.arcs[order[i]]:
            indeg[a.nextstate] -= 1
            if indeg[a.nextstate] == 0:
                order.append(a.nextstate)
        i += 1
    if len(order) != S:
        log.warning("mbr: cyclic lattice")
        return None
    # incoming arcs: (src, word, -scaled-logprob, num_frames)
    arcs_in: List[List[Tuple[int, int, float, int]]] = [[] for _ in range(S)]
    for s in range(S):
        for a in clat.arcs[s]:
            w_cost = lm_scale * a.graph_cost + ac_scale * a.acoustic_cost
            arcs_in[a.nextstate].append((s, a.word, w_cost, len(a.tids)))

    # --- forward log-probs alpha + expected state times -------------------
    NEG = -math.inf
    alpha = np.full(S, NEG)
    alpha[clat.start] = 0.0
    tstart = np.zeros(S)  # posterior-expected frame index at state entry
    for s in order:
        if s == clat.start:
            continue
        terms = []
        times = []
        for src, _w, cost, nfrm in arcs_in[s]:
            if alpha[src] == NEG:
                continue
            terms.append(alpha[src] - cost)
            times.append(tstart[src] + nfrm)
        if not terms:
            continue
        m = max(terms)
        probs = np.exp(np.asarray(terms) - m)
        alpha[s] = m + math.log(probs.sum())
        tstart[s] = float((probs * np.asarray(times)).sum() / probs.sum())

    # total likelihood over finals
    fin_terms = []
    for s in range(S):
        g, ac, tids = clat.finals[s]
        if g != INF and alpha[s] != NEG:
            fin_terms.append((s, alpha[s] - (lm_scale * g + ac_scale * ac),
                              len(tids)))
    if not fin_terms:
        log.warning("mbr: no reachable final state")
        return None
    tot = max(t for _, t, _ in fin_terms)
    tot += math.log(sum(math.exp(t - tot) for _, t, _ in fin_terms))

    # --- initial hypothesis: MAP best path --------------------------------
    R, _tids, _cost = clat.best_path(lm_scale, ac_scale)

    def acc_stats(R: List[int]):
        """One forward+backward of the edit recursion; returns
        (expected_edit, gamma: [Q+1] dict word->prob, times per q).

        Forward (AccStats in the reference): per state, average the per-arc
        sub/insert rows under the arcs' posterior shares, THEN apply the
        state-level deletion move a_dash(s,q) = min(.., a_dash(s,q-1)+1)."""
        Q = len(R)
        a_dash = np.full((S, Q + 1), np.inf)
        # at the start state: only deletions of R[1..q]
        a_dash[clat.start] = np.arange(Q + 1, dtype=np.float64)
        for s in order:
            if s == clat.start or alpha[s] == NEG:
                continue
            acc = np.zeros(Q + 1)
            wsum = 0.0
            for src, w, cost, _n in arcs_in[s]:
                if alpha[src] == NEG:
                    continue
                p = math.exp(alpha[src] - cost - alpha[s])  # posterior share
                row = np.empty(Q + 1)
                row[0] = a_dash[src, 0] + _edit(w, 0)  # insert w
                for q in range(1, Q + 1):
                    row[q] = min(
                        a_dash[src, q - 1] + _edit(w, R[q - 1]),  # sub/match
                        a_dash[src, q] + _edit(w, 0),  # insert w
                    )
                acc += p * row
                wsum += p
            if wsum <= 0:
                continue
            acc /= wsum
            a_dash[s, 0] = acc[0]
            for q in range(1, Q + 1):
                a_dash[s, q] = min(acc[q], a_dash[s, q - 1] + 1.0)

        fin_p = [(s, math.exp(t - tot)) for s, t, _n in fin_terms]
        e_edit = sum(p * a_dash[s, Q] for s, p in fin_p)

        # --- backward occupancy ------------------------------------------
        gamma: List[Dict[int, float]] = [dict() for _ in range(Q + 1)]
        tsum = np.zeros(Q + 1)       # word begin-time mass
        tsum_end = np.zeros(Q + 1)   # word end-time mass
        tmass = np.zeros(Q + 1)
        mass: List[Dict[int, float]] = [dict() for _ in range(S)]
        for s, p in fin_p:
            mass[s][Q] = mass[s].get(Q, 0.0) + p
        eps = 1e-9
        for s in reversed(order):
            if not mass[s]:
                continue
            if s == clat.start:
                for q, m in mass[s].items():
                    for qq in range(q, 0, -1):
                        gamma[qq][0] = gamma[qq].get(0, 0.0) + m
                mass[s] = {}
                continue
            entries = []
            wsum = 0.0
            for src, w, cost, nfrm in arcs_in[s]:
                if alpha[src] == NEG:
                    continue
                p = math.exp(alpha[src] - cost - alpha[s])
                entries.append((src, w, p, nfrm))
                wsum += p
            if wsum <= 0:
                mass[s] = {}
                continue
            pending = dict(mass[s])
            mass[s] = {}
            while pending:
                q, m = pending.popitem()
                if m < 1e-12:
                    continue
                # state-level deletion chosen?
                if q > 0 and a_dash[s, q] >= a_dash[s, q - 1] + 1.0 - eps:
                    gamma[q][0] = gamma[q].get(0, 0.0) + m
                    pending[q - 1] = pending.get(q - 1, 0.0) + m
                    continue
                for src, w, p, _nfrm in entries:
                    share = m * p / wsum
                    if share < 1e-12:
                        continue
                    if q == 0:
                        # insert w before r_1
                        gamma[0][w] = gamma[0].get(w, 0.0) + share
                        tsum[0] += share * tstart[src]
                        tsum_end[0] += share * (tstart[src] + _nfrm)
                        tmass[0] += share
                        mass[src][0] = mass[src].get(0, 0.0) + share
                        continue
                    c_sub = a_dash[src, q - 1] + _edit(w, R[q - 1])
                    c_ins = a_dash[src, q] + _edit(w, 0)
                    if c_sub <= c_ins + eps:
                        gamma[q][w] = gamma[q].get(w, 0.0) + share
                        tsum[q] += share * tstart[src]
                        tsum_end[q] += share * (tstart[src] + _nfrm)
                        tmass[q] += share
                        mass[src][q - 1] = mass[src].get(q - 1, 0.0) + share
                    else:
                        gamma[q][w] = gamma[q].get(w, 0.0) + share
                        tsum[q] += share * tstart[src]
                        tsum_end[q] += share * (tstart[src] + _nfrm)
                        tmass[q] += share
                        mass[src][q] = mass[src].get(q, 0.0) + share
        return e_edit, gamma, tsum, tsum_end, tmass

    prev = None
    e_edit = 0.0
    gamma: List[Dict[int, float]] = []
    tsum = tsum_end = tmass = None
    for _ in range(max_iters):
        e_edit, gamma, tsum, tsum_end, tmass = acc_stats(R)
        newR = []
        for q in range(1, len(R) + 1):
            if not gamma[q]:
                newR.append(R[q - 1])
                continue
            w = max(gamma[q].items(), key=lambda kv: kv[1])[0]
            if w != 0:
                newR.append(w)
        if newR == prev or newR == R:
            R = newR
            break
        prev, R = R, newR
    # final stats for the converged R
    e_edit, gamma, tsum, tsum_end, tmass = acc_stats(R)

    words: List[int] = []
    confs: List[float] = []
    times: List[Tuple[float, float]] = []
    sausage: List[List[Tuple[int, float]]] = []
    for q in range(1, len(R) + 1):
        d = gamma[q]
        total_q = sum(d.values())
        items = sorted(d.items(), key=lambda kv: -kv[1])
        sausage.append([(w, p / max(total_q, 1e-12)) for w, p in items])
        r = R[q - 1]
        conf = d.get(r, 0.0) / max(total_q, 1e-12)
        t_beg = tsum[q] / max(tmass[q], 1e-12)
        t_end = tsum_end[q] / max(tmass[q], 1e-12)
        words.append(r)
        confs.append(min(1.0, conf))
        times.append((t_beg * frame_shift, max(t_end, t_beg) * frame_shift))
    return MbrResult(
        words=words, confidences=confs, sausage=sausage, times=times,
        expected_wer=float(e_edit),
    )
