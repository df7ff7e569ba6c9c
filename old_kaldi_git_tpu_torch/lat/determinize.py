"""Exact pruned lattice determinization → CompactLattice.

Own copy of old_kaldi_git_tpu/lat/determinize.py (reference
src/lat/determinize-lattice-pruned.{h,cc} DeterminizeLatticePruned, the
CompactLattice types of src/lat/kaldi-lattice.h, the CompactLatticeWeightTpl
semiring of src/fstext/lattice-weight.h, push-lattice.cc and
minimize-lattice.cc).  Host code.  `determinize_lattice` is the algorithm in
plain Python; `determinize_lattice_pruned` runs its C++ mirror,
cpp/lattice.cc, through lat/native.py (built at first use; a build or load
failure raises), and the Python algorithm only when asked
(`algorithm="python"`).  The C++ takes and returns float32 weights, so the
Python route rounds its input and output weights to float32 the same way:
both routes see the same numbers.

* A ``Lattice`` (transition-ids in, words out, (graph, acoustic) weight
  pairs) is viewed as an acceptor on word labels whose weights live in the
  CompactLatticeWeight semiring: (LatticeWeight, tid-string).  Word-epsilon
  arcs are removed by the determinization (their tids join the string).
* LatticeWeight natural order: w1 ≤ w2 iff (g1+a1, g1) ≤ (g2+a2, g2);
  Plus = min in that order, Times = component-wise add.
* CompactLatticeWeight common divisor of a set: (Plus over the weights,
  longest common prefix of the strings); each member's residual is
  (weight ⊖ divisor, string with the prefix removed).
* Subsets of (lattice-state, residual CompactLatticeWeight) pairs are the
  determinized states; per-label transitions gather + epsilon-close +
  normalize, the classical weighted subset construction in this semiring.
* Pruning: with beta[s] the best backward cost in the input lattice, a
  subset element whose forward-cost + residual + beta exceeds best +
  lattice_beam cannot lie on any lattice path within the beam and is
  dropped before subset hashing.

The determinization is exact: every surviving word sequence keeps exactly
its best (graph, acoustic) cost and its Viterbi tid alignment, which
lattice rescoring relies on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.lat.lattice import INF, Lattice, LatticeArc, _topo_order
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("lat-det")

Weight = Tuple[float, float]  # (graph_cost, acoustic_cost)
TidString = Tuple[int, ...]


def _w_times(a: Weight, b: Weight) -> Weight:
    return (a[0] + b[0], a[1] + b[1])


def _w_key(w: Weight) -> Tuple[float, float]:
    """Natural-order sort key of LatticeWeight (total, then graph)."""
    return (w[0] + w[1], w[0])


def _w_minus(a: Weight, b: Weight) -> Weight:
    return (a[0] - b[0], a[1] - b[1])


def _lcp(a: TidString, b: TidString) -> TidString:
    n = 0
    m = min(len(a), len(b))
    while n < m and a[n] == b[n]:
        n += 1
    return a[:n]



def _clat_topo_order(clat: "CompactLattice") -> List[int]:
    """Kahn topological order of a CompactLattice; KaldiError on cycles."""
    n = clat.num_states
    indeg = [0] * n
    for s in range(n):
        for a in clat.arcs[s]:
            indeg[a.nextstate] += 1
    order = [s for s in range(n) if indeg[s] == 0]
    i = 0
    while i < len(order):
        for a in clat.arcs[order[i]]:
            indeg[a.nextstate] -= 1
            if indeg[a.nextstate] == 0:
                order.append(a.nextstate)
        i += 1
    if len(order) != n:
        raise KaldiError("compact lattice has a cycle")
    return order


@dataclasses.dataclass
class CompactLatticeArc:
    word: int  # word id (0 only for the implicit "end" never stored)
    graph_cost: float
    acoustic_cost: float
    tids: TidString  # Viterbi transition-id sequence for this word
    nextstate: int


class CompactLattice:
    """Deterministic word acceptor; weights carry tid strings.

    ~ kaldi CompactLattice (VectorFst over CompactLatticeWeightTpl)."""

    def __init__(self):
        self.arcs: List[List[CompactLatticeArc]] = []
        # final weight per state: (graph, acoustic, tids); graph=INF → nonfinal
        self.finals: List[Tuple[float, float, TidString]] = []
        self.start = 0

    def add_state(self) -> int:
        self.arcs.append([])
        self.finals.append((INF, INF, ()))
        return len(self.arcs) - 1

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def is_final(self, s: int) -> bool:
        return self.finals[s][0] != INF

    def best_path(
        self, lm_scale: float = 1.0, ac_scale: float = 1.0
    ) -> Tuple[List[int], List[int], float]:
        """(words, tids, cost); the acceptor is acyclic and deterministic."""
        n = self.num_states
        order = _clat_topo_order(self)
        dist = [INF] * n
        back: List[Optional[Tuple[int, CompactLatticeArc]]] = [None] * n
        dist[self.start] = 0.0
        for s in order:
            if dist[s] == INF:
                continue
            for a in self.arcs[s]:
                nd = dist[s] + lm_scale * a.graph_cost + ac_scale * a.acoustic_cost
                if nd < dist[a.nextstate]:
                    dist[a.nextstate] = nd
                    back[a.nextstate] = (s, a)
        best_s, best_c = -1, INF
        for s in range(n):
            if self.is_final(s):
                g, ac, _ = self.finals[s]
                c = dist[s] + lm_scale * g + ac_scale * ac
                if c < best_c:
                    best_s, best_c = s, c
        if best_s < 0:
            return [], [], INF
        words: List[int] = []
        tids: List[int] = []
        s = best_s
        final_tids = list(self.finals[best_s][2])
        while back[s] is not None:
            ps, a = back[s]
            words.append(a.word)
            tids[:0] = a.tids
            s = ps
        return words[::-1], tids + final_tids, best_c


# ---------------------------------------------------------------------------
# determinization
# ---------------------------------------------------------------------------

# subset element: (lattice state, residual weight, residual tid string)
_Element = Tuple[int, Weight, TidString]


def _backward_costs(lat: Lattice, order: List[int], float32_sums: bool = False
                    ) -> List[float]:
    """Best cost from each state to a final.  float32_sums: each arc's and
    final's (graph + acoustic) summed in float32, as cpp/lattice.cc sums its
    float inputs, before the double accumulation."""
    n = lat.num_states
    f32 = np.float32
    beta = [INF] * n
    for s in range(n):
        if lat.is_final(s):
            g, a = lat.finals[s]
            beta[s] = float(f32(g) + f32(a)) if float32_sums else g + a
    for s in reversed(order):
        for arc in lat.arcs[s]:
            ga = (float(f32(arc.graph_cost) + f32(arc.acoustic_cost)) if float32_sums
                  else arc.graph_cost + arc.acoustic_cost)
            c = ga + beta[arc.nextstate]
            if c < beta[s]:
                beta[s] = c
    return beta


def _round6_native(v: float) -> float:
    """cpp/lattice.cc's Round6, std::round(v * 1e6) / 1e6: halves away from
    zero, and a small negative value rounds to −0.0."""
    r = v * 1e6
    k = math.floor(abs(r))
    if abs(r) - k >= 0.5:
        k += 1
    return math.copysign(float(k), r) / 1e6


def _native_identity(key: Tuple[_Element, ...]) -> tuple:
    """A subset key as cpp/lattice.cc compares keys (their bytes): −0.0 and
    0.0 differ."""
    return tuple((s, w, math.copysign(1.0, w[0]), math.copysign(1.0, w[1]), string)
                 for s, w, string in key)


def _epsilon_closure(
    lat: Lattice, elems: Dict[int, Tuple[Weight, TidString]],
    topo_index: List[int],
) -> Dict[int, Tuple[Weight, TidString]]:
    """Close over word-epsilon arcs (olabel == 0), tids joining the string.

    The input lattice is acyclic, so processing states in topological order
    visits each at most once with its fully-combined weight."""
    agenda = sorted(elems, key=lambda s: topo_index[s])
    i = 0
    closed = dict(elems)
    while i < len(agenda):
        s = agenda[i]
        i += 1
        w, string = closed[s]
        for arc in lat.arcs[s]:
            if arc.olabel != 0:
                continue
            nw = _w_times(w, (arc.graph_cost, arc.acoustic_cost))
            nstr = string + ((arc.ilabel,) if arc.ilabel else ())
            ns = arc.nextstate
            if ns in closed:
                # Plus in the CompactLatticeWeight semiring: keep the
                # natural-order min; tie on cost → lexicographic string
                # (matches CompactLatticeWeightTpl::Plus total order)
                ow, ostr = closed[ns]
                if (_w_key(nw), nstr) < (_w_key(ow), ostr):
                    closed[ns] = (nw, nstr)
                    # re-process: weights only improve along topo order, and
                    # ns is later in topo order than anything processed so far
                    if topo_index[ns] < topo_index[s]:
                        raise KaldiError("epsilon cycle in lattice")
            else:
                closed[ns] = (nw, nstr)
                # insert keeping agenda sorted by topo order
                lo, hi = i, len(agenda)
                ti = topo_index[ns]
                while lo < hi:
                    mid = (lo + hi) // 2
                    if topo_index[agenda[mid]] < ti:
                        lo = mid + 1
                    else:
                        hi = mid
                agenda.insert(lo, ns)
    return closed


def _normalize(
    elems: Dict[int, Tuple[Weight, TidString]], round6=lambda v: round(v, 6),
) -> Tuple[Weight, TidString, Tuple[_Element, ...]]:
    """Common divisor (min weight, LCP of strings) + canonical residual key."""
    items = sorted(elems.items())
    div_w = min((w for _, (w, _) in items), key=_w_key)
    div_s: Optional[TidString] = None
    for _, (_, string) in items:
        div_s = string if div_s is None else _lcp(div_s, string)
    assert div_s is not None
    residual = tuple(
        (s, (round6(w[0] - div_w[0]), round6(w[1] - div_w[1])), string[len(div_s):])
        for s, (w, string) in items
    )
    return div_w, div_s, residual


def determinize_lattice(
    lat: Lattice,
    lattice_beam: float = math.inf,
    max_states: int = 500000,
    max_arcs: int = 2000000,
    native_arithmetic: bool = False,
) -> CompactLattice:
    """Exact (optionally pruned) determinization of an acyclic lattice.

    ~ DeterminizeLatticePruned(lat, beam, opts) with the semantics described
    in the module docstring.  Weights are used exactly as stored; apply
    acoustic/LM scaling first (as the reference's decode wrapper does) if
    scaled pruning is wanted.  Raises KaldiError past max_states/max_arcs
    (the reference returns failure and the caller re-prunes; callers here
    should catch and retry with a tighter beam).

    native_arithmetic: round and compare as cpp/lattice.cc does (the
    backward costs' float32 sums, its Round6 and byte-wise subset keys, the
    start subset's weights rounded as they are rather than as residuals),
    so that on float32 weights the result is the native library's."""
    if lat.num_states == 0:
        return CompactLattice()
    round6 = _round6_native if native_arithmetic else (lambda v: round(v, 6))
    ident = _native_identity if native_arithmetic else (lambda k: k)
    order = _topo_order(lat)
    topo_index = [0] * lat.num_states
    for i, s in enumerate(order):
        topo_index[s] = i
    beta = _backward_costs(lat, order, float32_sums=native_arithmetic)
    if beta[lat.start] == INF:
        return CompactLattice()  # no successful path
    best_cost = beta[lat.start]
    cutoff = best_cost + lattice_beam

    out = CompactLattice()
    # det-state table: residual-subset key -> (state id, forward cost)
    subset_ids: Dict[tuple, int] = {}
    forward: List[float] = []
    total_arcs = 0  # running count: out.num_arcs is O(S) per call

    def prune_subset(
        elems: Dict[int, Tuple[Weight, TidString]], fwd: float
    ) -> Dict[int, Tuple[Weight, TidString]]:
        if lattice_beam == math.inf:
            return elems
        return {
            s: (w, string)
            for s, (w, string) in elems.items()
            if fwd + w[0] + w[1] + beta[s] <= cutoff + 1e-6
        }

    init = _epsilon_closure(lat, {lat.start: ((0.0, 0.0), ())}, topo_index)
    init = prune_subset(init, 0.0)
    if native_arithmetic:
        key = tuple((s, (round6(w[0]), round6(w[1])), string)
                    for s, (w, string) in sorted(init.items()))
    else:
        div_w, div_s, key = _normalize(init)
        # The initial divisor must be One for a start state (Kaldi keeps any
        # leading weight on the arcs out of the start state instead): fold it
        # back into the residuals.
        key = tuple(
            (s, (round(w[0] + div_w[0], 6), round(w[1] + div_w[1], 6)),
             div_s + string)
            for s, w, string in key
        )
    start = out.add_state()
    out.start = start
    subset_ids[ident(key)] = start
    forward.append(0.0)
    agenda: List[Tuple[int, Tuple[_Element, ...]]] = [(start, key)]

    while agenda:
        det_s, key = agenda.pop()
        fwd = forward[det_s]
        # re-expansion (after a forward-cost improvement) is idempotent:
        # rebuild this state's arcs/final from scratch
        total_arcs -= len(out.arcs[det_s])
        out.arcs[det_s] = []
        out.finals[det_s] = (INF, INF, ())
        elems: Dict[int, Tuple[Weight, TidString]] = {
            s: (w, string) for s, w, string in key
        }
        # final weight: Plus over elements at final lattice states
        final_best: Optional[Tuple[Weight, TidString]] = None
        for s, (w, string) in elems.items():
            if lat.is_final(s):
                fw = _w_times(w, lat.finals[s])
                if final_best is None or (_w_key(fw), string) < (
                    _w_key(final_best[0]), final_best[1]
                ):
                    final_best = (fw, string)
        if final_best is not None:
            (g, a), string = final_best
            out.finals[det_s] = (g, a, string)

        # gather per-label transitions
        by_label: Dict[int, Dict[int, Tuple[Weight, TidString]]] = {}
        for s, (w, string) in elems.items():
            for arc in lat.arcs[s]:
                if arc.olabel == 0:
                    continue
                nw = _w_times(w, (arc.graph_cost, arc.acoustic_cost))
                nstr = string + ((arc.ilabel,) if arc.ilabel else ())
                d = by_label.setdefault(arc.olabel, {})
                ns = arc.nextstate
                if ns not in d or (_w_key(nw), nstr) < (_w_key(d[ns][0]), d[ns][1]):
                    d[ns] = (nw, nstr)

        for word in sorted(by_label):
            nxt = _epsilon_closure(lat, by_label[word], topo_index)
            nxt = prune_subset(nxt, fwd)
            if not nxt:
                continue
            div_w, div_s, nkey = _normalize(nxt, round6)
            nfwd = fwd + div_w[0] + div_w[1]
            nid = ident(nkey)
            if nid in subset_ids:
                ns_id = subset_ids[nid]
                if nfwd < forward[ns_id] - 1e-9:
                    # tighter path in: earlier pruning used a looser bound,
                    # so re-expand the subset with the improved forward cost
                    forward[ns_id] = nfwd
                    agenda.append((ns_id, nkey))
            else:
                ns_id = out.add_state()
                if out.num_states > max_states:
                    raise KaldiError(
                        f"determinize_lattice: exceeded max_states={max_states}"
                    )
                subset_ids[nid] = ns_id
                forward.append(nfwd)
                agenda.append((ns_id, nkey))
            out.arcs[det_s].append(
                CompactLatticeArc(word, div_w[0], div_w[1], div_s, ns_id)
            )
            total_arcs += 1
            if total_arcs > max_arcs:
                raise KaldiError(
                    f"determinize_lattice: exceeded max_arcs={max_arcs}"
                )
    return out


def _round_weights(clat: CompactLattice) -> CompactLattice:
    """The weights rounded to float32 in place (what the native library's
    export does); returns clat."""
    for s in range(clat.num_states):
        for a in clat.arcs[s]:
            a.graph_cost = float(np.float32(a.graph_cost))
            a.acoustic_cost = float(np.float32(a.acoustic_cost))
        g, ac, string = clat.finals[s]
        if g != INF:
            clat.finals[s] = (float(np.float32(g)), float(np.float32(ac)), string)
    return clat


def determinize_lattice_pruned(
    lat: Lattice,
    lattice_beam: float = 10.0,
    acoustic_scale: float = 1.0,
    lm_scale: float = 1.0,
    max_states: int = 500000,
    beam_ratio: float = 0.75,
    retries: int = 4,
    algorithm: str = "native",
) -> CompactLattice:
    """~ DeterminizeLatticePhonePrunedWrapper's outer loop: scale weights,
    determinize within the beam, and on state blow-up retry with the beam
    tightened by beam_ratio (reference opts.retry_cutoff behavior); weights
    in the result are unscaled back.

    algorithm: "native" (cpp/lattice.cc) or "python" (`determinize_lattice`
    on the same float32 weights, its result rounded to float32 as the
    native library returns it)."""
    if algorithm not in ("native", "python"):
        raise ValueError(f"unknown determinization algorithm {algorithm!r}")
    from old_kaldi_git_tpu_torch.lat import native  # it imports this module
    f32 = lambda x: float(np.float32(x))  # noqa: E731  the ctypes boundary's rounding
    scaled = Lattice()
    for s in range(lat.num_states):
        scaled.add_state(lat.state_time[s])
        g, a = lat.finals[s]
        if g != INF:
            scaled.finals[s] = (f32(lm_scale * g), f32(acoustic_scale * a))
    scaled.start = lat.start
    for s in range(lat.num_states):
        for arc in lat.arcs[s]:
            scaled.arcs[s].append(
                LatticeArc(arc.ilabel, arc.olabel, f32(lm_scale * arc.graph_cost),
                           f32(acoustic_scale * arc.acoustic_cost), arc.nextstate)
            )
    beam = lattice_beam
    last_err: Optional[KaldiError] = None
    for _ in range(retries):
        try:
            if algorithm == "native":
                clat = native.determinize_lattice_native(scaled, beam, max_states)
            else:
                clat = _round_weights(determinize_lattice(
                    scaled, float(np.float32(beam)), max_states, native_arithmetic=True))
            break
        except KaldiError as e:
            last_err = e
            beam *= beam_ratio
            log.warning("determinization blew up; retrying with beam %.2f", beam)
    else:
        raise last_err  # type: ignore[misc]
    if lm_scale != 1.0 or acoustic_scale != 1.0:
        ig = 1.0 / lm_scale if lm_scale != 0 else 0.0
        ia = 1.0 / acoustic_scale if acoustic_scale != 0 else 0.0
        for s in range(clat.num_states):
            for a in clat.arcs[s]:
                a.graph_cost *= ig
                a.acoustic_cost *= ia
            g, ac, string = clat.finals[s]
            if g != INF:
                clat.finals[s] = (g * ig, ac * ia, string)
    return clat


def compact_lattice_to_lattice(clat: CompactLattice) -> Lattice:
    """~ ConvertLattice (CompactLattice → Lattice): each word arc's tid
    string becomes a chain of one-tid arcs, the word and weight on the
    first; a final tid string becomes a chain to a new final state."""
    lat = Lattice()
    for _ in range(clat.num_states):
        lat.add_state()
    lat.start = clat.start
    for s in range(clat.num_states):
        for a in clat.arcs[s]:
            tids = a.tids if a.tids else (0,)
            cur = s
            for i, tid in enumerate(tids):
                nxt = a.nextstate if i == len(tids) - 1 else lat.add_state()
                lat.arcs[cur].append(LatticeArc(
                    tid, a.word if i == 0 else 0, a.graph_cost if i == 0 else 0.0,
                    a.acoustic_cost if i == 0 else 0.0, nxt))
                cur = nxt
        g, ac, string = clat.finals[s]
        if g != INF:
            if string:
                cur = s
                for i, tid in enumerate(string):
                    nxt = lat.add_state()
                    lat.arcs[cur].append(LatticeArc(tid, 0, g if i == 0 else 0.0,
                                                    ac if i == 0 else 0.0, nxt))
                    cur = nxt
                lat.finals[cur] = (0.0, 0.0)
            else:
                lat.finals[s] = (g, ac)
    return lat


def push_compact_lattice(clat: CompactLattice) -> CompactLattice:
    """~ PushCompactLatticeStrings/Weights (src/lat/push-lattice.cc): each
    state's common (weight, tid-string) divisor of its outgoing arcs and
    final moves onto its incoming arcs, in reverse topological order, so
    weights and strings sit as early as they can (minimisation then merges
    more).  Returns a new lattice."""
    out = CompactLattice()
    for _ in range(clat.num_states):
        out.add_state()
    out.start = clat.start
    for s in range(clat.num_states):
        out.arcs[s] = [CompactLatticeArc(a.word, a.graph_cost, a.acoustic_cost, a.tids,
                                         a.nextstate) for a in clat.arcs[s]]
        out.finals[s] = clat.finals[s]
    order = _clat_topo_order(out)
    in_arcs: Dict[int, list] = {s: [] for s in range(out.num_states)}
    for s in range(out.num_states):
        for a in out.arcs[s]:
            in_arcs[a.nextstate].append(a)
    for s in reversed(order):
        if s == out.start or not in_arcs[s]:
            continue
        items = [((a.graph_cost, a.acoustic_cost), a.tids) for a in out.arcs[s]]
        g, ac, string = out.finals[s]
        if g != INF:
            items.append(((g, ac), string))
        if not items:
            continue
        div_w = min((w for w, _ in items), key=_w_key)
        div_s: Optional[TidString] = None
        for _, st in items:
            div_s = st if div_s is None else _lcp(div_s, st)
        if div_w == (0.0, 0.0) and not div_s:
            continue
        for a in out.arcs[s]:
            a.graph_cost -= div_w[0]
            a.acoustic_cost -= div_w[1]
            a.tids = a.tids[len(div_s):]
        if g != INF:
            out.finals[s] = (*_w_minus((g, ac), div_w), string[len(div_s):])
        for a in in_arcs[s]:
            a.graph_cost += div_w[0]
            a.acoustic_cost += div_w[1]
            a.tids = a.tids + div_s
    return out


def minimize_compact_lattice(clat: CompactLattice) -> CompactLattice:
    """~ MinimizeCompactLattice (src/lat/minimize-lattice.cc): after
    pushing, states with the same final (weight, string) and the same arcs
    into the same classes merge; one reverse topological pass assigns the
    classes (the lattice is acyclic).  Weights compare to 6 decimals."""
    pushed = push_compact_lattice(clat)
    order = _clat_topo_order(pushed)
    cls: Dict[int, int] = {}
    sig_to_cls: Dict[tuple, int] = {}
    for s in reversed(order):
        arc_sig = tuple(sorted(
            (a.word, round(a.graph_cost, 6), round(a.acoustic_cost, 6), a.tids,
             cls[a.nextstate])
            for a in pushed.arcs[s]))
        g, ac, string = pushed.finals[s]
        fin_sig = (round(g, 6) if g != INF else INF, round(ac, 6) if ac != INF else INF,
                   string)
        sig = (fin_sig, arc_sig)
        if sig not in sig_to_cls:
            sig_to_cls[sig] = len(sig_to_cls)
        cls[s] = sig_to_cls[sig]
    out = CompactLattice()
    cls_state: Dict[int, int] = {}

    def get(c: int) -> int:
        if c not in cls_state:
            cls_state[c] = out.add_state()
        return cls_state[c]

    out.start = get(cls[pushed.start])
    done = set()
    for s in order:
        c = cls[s]
        if c in done:
            continue
        done.add(c)
        sc = get(c)
        out.finals[sc] = pushed.finals[s]
        for a in pushed.arcs[s]:
            out.arcs[sc].append(CompactLatticeArc(a.word, a.graph_cost, a.acoustic_cost,
                                                  a.tids, get(cls[a.nextstate])))
    return out
