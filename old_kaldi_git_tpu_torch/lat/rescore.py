"""Exact lattice LM rescoring over CompactLattices.

Own copy of `lmrescore_compact_lattice` of old_kaldi_git_tpu/lat/rescore.py
(reference latbin/lattice-lmrescore and lattice-lmrescore-const-arpa).  Both
LMs are deterministic over word histories, so composing the word lattice
with them is a DP over (lattice state, old-LM history, new-LM history)
tuples that adjusts each arc's graph cost by

    graph' = graph + old_scale·(−log P_old(w | h_old))
                   + new_scale·(−log P_new(w | h_new))

with old_scale = −1 (remove the LM baked into HCLG) and new_scale = +1 (add
the big LM); finals get the same treatment with </s>.  Every path's total
cost changes by exactly its LM-score delta, so no path is lost.

`compose_lattice_pruned` (reference lat/compose-lattice-pruned.cc,
lattice-lmrescore-pruned) is the same product expanded best-first under an
A* bound and cut at a beam.

`rescore_lattice_acoustics` (the JAX package's copy in the same file:
reference lattice-rescore-mapped / gmm-rescore-lattice) replaces a raw
lattice's acoustic costs by a model's current loglikes, in place.
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.lat.determinize import CompactLattice, CompactLatticeArc
from old_kaldi_git_tpu_torch.lat.lattice import INF, Lattice, LatticeArc
from old_kaldi_git_tpu_torch.lm.arpa import BOS, EOS, ArpaLm
from old_kaldi_git_tpu_torch.utils.log import get_logger

log = get_logger("lmrescore")

Hist = Tuple[str, ...]


def _advance(hist: Hist, word: str, order: int) -> Hist:
    return (hist + (word,))[-(order - 1):] if order > 1 else ()


def lmrescore_compact_lattice(
    clat: CompactLattice,
    words: Sequence[str],  # word id → word
    new_lm: ArpaLm,
    old_lm: Optional[ArpaLm] = None,
    new_scale: float = 1.0,
    old_scale: float = -1.0,
    max_states: int = 2000000,
) -> CompactLattice:
    """Compose with (old LM)^old_scale ⊗ (new LM)^new_scale, exactly.

    With old_lm=None only the new LM is applied (lattice-lmrescore-const-arpa
    after the old scores were already removed)."""
    out = CompactLattice()
    if clat.num_states == 0:
        return out
    o_ord = old_lm.order if old_lm else 1
    n_ord = new_lm.order
    # histories bounded by each LM's order; sentences start at <s>
    start_key = (
        clat.start,
        (BOS,) if o_ord > 1 else (),
        (BOS,) if n_ord > 1 else (),
    )
    ids: Dict[Tuple[int, Hist, Hist], int] = {start_key: out.add_state()}
    out.start = 0
    stack = [start_key]
    while stack:
        key = stack.pop()
        s, h_old, h_new = key
        s_out = ids[key]
        g, a, string = clat.finals[s]
        if g != INF:
            adj = new_scale * -new_lm.logprob(EOS, h_new)
            if old_lm is not None:
                adj += old_scale * -old_lm.logprob(EOS, h_old)
            out.finals[s_out] = (g + adj, a, string)
        for arc in clat.arcs[s]:
            w = words[arc.word]
            adj = new_scale * -new_lm.logprob(w, h_new)
            if old_lm is not None:
                adj += old_scale * -old_lm.logprob(w, h_old)
            nkey = (
                arc.nextstate,
                _advance(h_old, w, o_ord),
                _advance(h_new, w, n_ord),
            )
            if nkey not in ids:
                ids[nkey] = out.add_state()
                if out.num_states > max_states:
                    raise RuntimeError("lmrescore: state blow-up")
                stack.append(nkey)
            out.arcs[s_out].append(
                CompactLatticeArc(
                    arc.word, arc.graph_cost + adj, arc.acoustic_cost,
                    arc.tids, ids[nkey],
                )
            )
    log.info(
        "lmrescore: %d → %d states (%d arcs)",
        clat.num_states, out.num_states, out.num_arcs,
    )
    return out


def rescore_lattice_acoustics(lat: Lattice, loglikes: np.ndarray,
                              tid_to_pdf: Callable[[int], int]) -> None:
    """Replace each emitting arc's acoustic cost with −loglikes[t, pdf] in
    place, t the frame of the arc's source state (lat.state_time); the
    per-minibatch step of nnet3 discriminative training."""
    loglikes = np.asarray(loglikes)
    T = loglikes.shape[0]
    for s in range(lat.num_states):
        t = lat.state_time[s]
        new = []
        for a in lat.arcs[s]:
            ac = a.acoustic_cost
            if a.ilabel and 0 <= t < T:
                ac = float(-loglikes[t, tid_to_pdf(a.ilabel)])
            new.append(LatticeArc(a.ilabel, a.olabel, a.graph_cost, ac, a.nextstate))
        lat.arcs[s] = new


def compose_lattice_pruned(
    clat: CompactLattice,
    words,
    new_lm: ArpaLm,
    old_lm: Optional[ArpaLm] = None,
    new_scale: float = 1.0,
    old_scale: float = -1.0,
    lattice_beam: float = 6.0,
    max_arcs: int = 200000,
) -> CompactLattice:
    """Beam-pruned LM composition (reference lat/compose-lattice-pruned.{h,cc}
    ComposeCompactLatticePruned / latbin lattice-lmrescore-pruned): same
    product as lmrescore_compact_lattice, but product states expand
    best-first under an A* bound — forward cost so far + the INPUT
    lattice's backward best cost (the reference's heuristic) — and
    expansion stops beyond (best final estimate + lattice_beam) or the
    arc budget.  For big LMs this touches only the competitive part of
    the (lattice x LM-history) product instead of all of it."""
    out = CompactLattice()
    if clat.num_states == 0:
        return out
    n = clat.num_states
    # topological order (compact lattices are acyclic)
    indeg = [0] * n
    for s in range(n):
        for a in clat.arcs[s]:
            indeg[a.nextstate] += 1
    order = [s for s in range(n) if indeg[s] == 0]
    head = 0
    while head < len(order):
        s = order[head]
        head += 1
        for a in clat.arcs[s]:
            indeg[a.nextstate] -= 1
            if indeg[a.nextstate] == 0:
                order.append(a.nextstate)
    bwd = [INF] * n
    for s in reversed(order):
        g, ac, _ = clat.finals[s]
        best = g + ac if g != INF else INF
        for a in clat.arcs[s]:
            best = min(best,
                       a.graph_cost + a.acoustic_cost + bwd[a.nextstate])
        bwd[s] = best

    o_ord = old_lm.order if old_lm else 1
    n_ord = new_lm.order
    start_key = (
        clat.start,
        (BOS,) if o_ord > 1 else (),
        (BOS,) if n_ord > 1 else (),
    )
    ids: Dict[Tuple[int, Hist, Hist], int] = {start_key: out.add_state()}
    out.start = 0
    fwd = {start_key: 0.0}
    best_final = INF
    heap = [(bwd[clat.start], 0, start_key)]
    tie = 1
    expanded = set()
    arcs_done = 0
    while heap:
        est, _, key = heapq.heappop(heap)
        if key in expanded:
            continue
        if est > best_final + lattice_beam or arcs_done >= max_arcs:
            break
        expanded.add(key)
        s, h_old, h_new = key
        s_out = ids[key]
        f = fwd[key]
        g, ac, string = clat.finals[s]
        if g != INF:
            adj = new_scale * -new_lm.logprob(EOS, h_new)
            if old_lm is not None:
                adj += old_scale * -old_lm.logprob(EOS, h_old)
            out.finals[s_out] = (g + adj, ac, string)
            best_final = min(best_final, f + g + adj + ac)
        for arc in clat.arcs[s]:
            w = words[arc.word]
            adj = new_scale * -new_lm.logprob(w, h_new)
            if old_lm is not None:
                adj += old_scale * -old_lm.logprob(w, h_old)
            cost = arc.graph_cost + adj + arc.acoustic_cost
            nkey = (
                arc.nextstate,
                _advance(h_old, w, o_ord),
                _advance(h_new, w, n_ord),
            )
            nf = f + cost
            h = bwd[arc.nextstate]
            if nf + h > best_final + lattice_beam:
                continue  # pruned
            if nkey not in ids:
                ids[nkey] = out.add_state()
            if nf < fwd.get(nkey, INF):
                fwd[nkey] = nf
                if nkey not in expanded:
                    heapq.heappush(heap, (nf + h, tie, nkey))
                    tie += 1
            out.arcs[s_out].append(
                CompactLatticeArc(
                    arc.word, arc.graph_cost + adj, arc.acoustic_cost,
                    arc.tids, ids[nkey],
                )
            )
            arcs_done += 1
    # trim: pruning leaves dead-end product states (arcs into never-
    # expanded states); keep only states that reach a final
    coacc = [g != INF for (g, _a, _s) in out.finals]
    changed = True
    while changed:
        changed = False
        for s in range(out.num_states):
            if not coacc[s] and any(coacc[a.nextstate] for a in out.arcs[s]):
                coacc[s] = True
                changed = True
    remap = {}
    trimmed = CompactLattice()
    for s in range(out.num_states):
        if coacc[s]:
            remap[s] = trimmed.add_state()
    if not coacc[out.start]:
        log.warning("compose-pruned: no surviving path")
        return CompactLattice()
    trimmed.start = remap[out.start]
    for s, ns in remap.items():
        trimmed.finals[ns] = out.finals[s]
        trimmed.arcs[ns] = [
            CompactLatticeArc(a.word, a.graph_cost, a.acoustic_cost,
                              a.tids, remap[a.nextstate])
            for a in out.arcs[s] if coacc[a.nextstate]
        ]
    log.info(
        "compose-pruned: %d → %d states (%d arcs, beam %.1f)",
        clat.num_states, trimmed.num_states, trimmed.num_arcs, lattice_beam,
    )
    return trimmed
