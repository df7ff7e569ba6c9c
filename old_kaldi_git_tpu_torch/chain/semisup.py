"""Semi-supervised LF-MMI: decode lattices as numerators for unlabelled audio.

Counterpart of old_kaldi_git_tpu/chain/semisup.py (the fork's
semi-supervised chain pipeline: Manohar et al., "Semi-supervised training of
acoustic models using lattice-free MMI", ICASSP 2018; reference
src/chain/chain-supervision-splitter.{h,cc}): the numerator of an
unlabelled utterance is the seed model's decode lattice.  A raw lattice is
frame-synchronous (every emitting arc takes one subsampled frame), so it is
a generic numerator graph in the sense of chain/e2e.py: its product with
the den graph's normalisation weights, with the lattice's own graph (LM)
costs folded in at `lattice_lm_scale`, goes to the same forward.  Lattice
paths are a subset of the den graph's and the LM costs only lower them, so
num ≤ den still holds.  Host code, as in the JAX package.
"""

from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.chain.den_graph import DenominatorGraph
from old_kaldi_git_tpu_torch.chain.e2e import SimpleNumGraph, den_step, simple_num_graph


def lattice_to_numerator(lat, tm, den: DenominatorGraph, lattice_lm_scale: float = 1.0,
                         acoustic_scale: float = 0.0) -> SimpleNumGraph:
    """Decode lattice (tid level, frame-synchronous) → normalised numerator.

    States are (lattice state, den state) pairs in the order a breadth-first
    walk first meets them; an arc weighs the den graph's normalisation
    weight (chain/e2e.py den_step) minus `lattice_lm_scale` · graph cost
    minus `acoustic_scale` · acoustic cost.  The reference's recipe keeps
    the lattice's LM scores and drops its acoustic ones (they would count
    the model being trained twice), hence acoustic_scale 0.  Epsilon-input
    arcs (the chains `_emit` writes for multi-word output labels) take no
    frame: their costs fold into the emitting arcs and finals after them."""

    states: dict = {}

    def sid(ls: int, ds: int) -> int:
        key = (ls, ds)
        if key not in states:
            states[key] = len(states)
        return states[key]

    def eps_closure(ls: int) -> List[Tuple[int, float, float]]:
        """(state, graph cost, acoustic cost) reachable from ls by
        epsilon-input arcs, ls itself at (0, 0); the cheapest copy of each
        state (the guard also ends epsilon cycles)."""
        best = {ls: (0.0, 0.0)}
        stack = [(ls, 0.0, 0.0)]
        while stack:
            s, g, a = stack.pop()
            for arc in lat.arcs[s]:
                if int(arc.ilabel) != 0:
                    continue
                ns = int(arc.nextstate)
                g2 = g + float(arc.graph_cost)
                a2 = a + float(arc.acoustic_cost)
                old = best.get(ns)
                if old is None or g2 + a2 < old[0] + old[1]:
                    best[ns] = (g2, a2)
                    stack.append((ns, g2, a2))
        return [(s, g, a) for s, (g, a) in best.items()]

    start_key = (int(lat.start), -1)
    start = sid(*start_key)
    arcs: List[Tuple[int, int, int, float]] = []
    finals: dict = {}
    seen = {start_key}
    q = deque([start_key])
    while q:
        ls, ds = q.popleft()
        me = sid(ls, ds)
        closure = eps_closure(ls)
        for ls2, eg, ea in closure:
            fg, fa = lat.finals[ls2]
            if np.isfinite(fg) and ds >= 0:
                cand = (float(den.final_log_probs[ds]) - lattice_lm_scale * (fg + eg)
                        - acoustic_scale * (fa + ea))
                if me not in finals or cand > finals[me]:
                    finals[me] = cand
        for ls2, eg, ea in closure:
            for arc in lat.arcs[ls2]:
                tid = int(arc.ilabel)
                if tid == 0:
                    continue  # folded into the closure's costs
                w, nds = den_step(tm, den, tid, ds)
                w -= lattice_lm_scale * (arc.graph_cost + eg)
                w -= acoustic_scale * (arc.acoustic_cost + ea)
                nxt = (int(arc.nextstate), nds)
                arcs.append((me, sid(*nxt), int(tm.tid_to_pdf(tid)), w))
                if nxt not in seen:
                    seen.add(nxt)
                    q.append(nxt)
    return simple_num_graph(start, arcs, finals, len(states), "lattice numerator")
