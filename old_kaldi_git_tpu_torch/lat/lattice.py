"""Lattices rebuilt from a decoder's kept tokens or records, and what users
read from them: best path, n-best, posteriors, confusion networks.

Own copy of old_kaldi_git_tpu/lat/lattice.py (reference src/lat: kaldi
Lattice, GetRawLattice, lattice-best-path, lattice-nbest, lattice-oracle,
lattice-prune, LatticeForwardBackward, lattice-to-post, lattice-interp):
host code, plain Python and numpy.

  Lattice                     ~ kaldi Lattice (tids in, words out, (graph,
                                acoustic) weight pair), stored topsorted by
                                frame
  lattice_from_decode         ~ GetRawLattice, from the per-frame kept
                                tokens of decode_batch's lattice mode
  lattice_from_token_records  ~ GetRawLattice, from the records the decoder
                                emitted on the device
  lattice_state_times         ~ LatticeStateTimes (frames from emitting arcs)
  lattice_prune               ~ lattice-prune (forward/backward cost pruning)
  lattice_best_path           ~ lattice-best-path (with lm/acoustic scales)
  lattice_arc_posteriors      ~ LatticeForwardBackward (log-semiring
                                posteriors)
  lattice_total_logprob       ~ the total path mass (the MMI denominator)
  lattice_oracle              ~ lattice-oracle (least edit distance of any
                                path against a reference)
  lattice_nbest_paths         ~ lattice-to-nbest (n best full paths)
  lattice_nbest               ~ lattice-nbest (n best distinct word
                                sequences)
  lattice_word_posteriors     ~ lattice-to-post projected on words
  lattice_to_word_fst         ~ the word-level view, determinized by the
                                native graph library's DeterminizeStar
  confusion_network           ~ sausages by time clustering (the common
                                approximation of MinimumBayesRisk's)
  rescore_nbest               ~ lattice-lmrescore through n-best lists
  lattice_depth, lattice_to_post, lattice_interp
                              ~ lattice-depth, lattice-to-post +
                                post-to-pdf-post, lattice-interp

The forward-backward functions keep the JAX package's order of operations
(`_topo_order`, the same loops in float64), so they give its numbers.
`lattice_to_word_fst` runs in the native library, whose weights are
float32: its weights, and those `lattice_interp` takes from it, are the JAX
package's to float32's precision.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph
from old_kaldi_git_tpu_torch.decoder.viterbi import TokenLattice, eps_walk, start_closure
from old_kaldi_git_tpu_torch.fst.vector_fst import Arc, VectorFst
from old_kaldi_git_tpu_torch.utils.log import KaldiError

INF = math.inf


@dataclasses.dataclass
class LatticeArc:
    ilabel: int  # transition-id (0 = eps)
    olabel: int  # word id (0 = eps)
    graph_cost: float
    acoustic_cost: float
    nextstate: int


class Lattice:
    """Topologically-ordered lattice (frame-synchronous states)."""

    def __init__(self):
        self.arcs: List[List[LatticeArc]] = []
        self.finals: List[Tuple[float, float]] = []  # (graph, acoustic), INF=not
        self.start = 0
        self.state_time: List[int] = []  # frame index per state (-1 unknown)

    def add_state(self, time: int = -1) -> int:
        self.arcs.append([])
        self.finals.append((INF, INF))
        self.state_time.append(time)
        return len(self.arcs) - 1

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def is_final(self, s: int) -> bool:
        return self.finals[s][0] != INF

    def combined(self, arc: LatticeArc, lm_scale: float, ac_scale: float) -> float:
        return lm_scale * arc.graph_cost + ac_scale * arc.acoustic_cost


def lattice_from_decode(
    graph: CsrGraph,
    loglikes: np.ndarray,  # [T, P] for this utterance
    frame_states: np.ndarray,  # [T, K] state ids (-1 dead)
    frame_costs: np.ndarray,  # [T, K] forward costs
    acoustic_scale: float,
    lattice_beam: float = 10.0,
) -> Optional[Lattice]:
    """Rebuild the raw lattice over surviving tokens.

    For each frame t and surviving state s', add an arc from every frame
    t-1 token s such that the decode graph has s→s' and the via-cost is
    within lattice_beam of s''s stored forward cost.  Arc weights keep the
    graph cost and the (unscaled) acoustic cost separately.
    """
    T = frame_states.shape[0]
    if T == 0:
        return None
    src_of_arc = np.repeat(
        np.arange(graph.num_states, dtype=np.int32), graph.out_degree()
    )
    lat = Lattice()
    start = lat.add_state(time=-1)
    lat.start = start

    # state id in the lattice for (t, slot)
    slot_state: List[Dict[int, int]] = []
    BIG = 1e10

    def get_lat_state(t: int, slot: int) -> int:
        d = slot_state[t]
        if slot not in d:
            d[slot] = lat.add_state(time=t)
        return d[slot]

    # the via-cost test below in the dtype that the scalar arithmetic
    # `np.float32 + float` takes under this numpy (float32 under NEP 50),
    # so that the arrays keep exactly the arcs a per-arc loop keeps
    dt = (np.float32(0) + 0.0).dtype
    slot_cur = np.full(graph.num_states, -1, np.int64)  # graph state -> slot at t
    prev_map: Dict[int, int] = {}  # graph state -> slot at t-1
    prev_s = prev_k = np.zeros(0, np.int64)
    for t in range(T):
        slot_state.append({})
        states_t = frame_states[t]
        costs_t = frame_costs[t]
        alive = np.nonzero((states_t >= 0) & (costs_t < BIG))[0]
        # graph state -> slot (a repeated state keeps its last slot)
        cur_map = dict(zip(states_t[alive].astype(np.int64).tolist(), alive.tolist()))
        if t == 0:
            # arcs from the virtual start (graph.start) to frame-0 tokens
            lo, hi = graph.row_ptr[graph.start], graph.row_ptr[graph.start + 1]
            for a in range(lo, hi):
                ns = int(graph.nextstate[a])
                if ns in cur_map:
                    k = cur_map[ns]
                    ac = -float(loglikes[0, graph.pdf[a]])
                    _emit(lat, graph, start, get_lat_state(0, k), a, ac)
        elif len(prev_s):
            # every arc out of the alive states of t-1, in their order
            slot_cur[list(cur_map)] = list(cur_map.values())
            lo = graph.row_ptr[prev_s].astype(np.int64)
            cnt = graph.row_ptr[prev_s + 1].astype(np.int64) - lo
            owner = np.repeat(np.arange(len(prev_s)), cnt)
            arcs = (np.arange(int(cnt.sum()), dtype=np.int64)
                    - np.repeat(np.cumsum(cnt) - cnt, cnt) + lo[owner])
            k = slot_cur[graph.nextstate[arcs]]
            hit = np.nonzero(k >= 0)[0]
            arcs, owner, k = arcs[hit], owner[hit], k[hit]
            ac = -loglikes[t, graph.pdf[arcs]].astype(np.float64)
            base = frame_costs[t - 1, prev_k[owner]] + graph.weight[arcs]
            via = base.astype(dt) + (acoustic_scale * ac).astype(dt)
            keep = np.nonzero(via <= costs_t[k].astype(dt) + dt.type(lattice_beam))[0]
            for i in keep.tolist():
                _emit(lat, graph, get_lat_state(t - 1, int(prev_k[owner[i]])),
                      get_lat_state(t, int(k[i])), int(arcs[i]), float(ac[i]))
            slot_cur[list(cur_map)] = -1
        prev_map = cur_map
        prev_s = np.fromiter(prev_map.keys(), np.int64, len(prev_map))
        prev_k = np.fromiter(prev_map.values(), np.int64, len(prev_map))

    # finals on the last frame's tokens
    any_final = False
    for s, k in prev_map.items():
        st = slot_state[T - 1].get(k)
        if st is None:
            continue
        fw = graph.final_weight[s]
        if np.isfinite(fw):
            lat.finals[st] = (float(fw), 0.0)
            any_final = True
    if not any_final:
        for s, k in prev_map.items():
            st = slot_state[T - 1].get(k)
            if st is not None:
                lat.finals[st] = (0.0, 0.0)
    _connect(lat)
    if lat.num_arcs == 0:
        return None
    return lat


def lattice_from_token_records(graph: CsrGraph, rec: TokenLattice
                               ) -> Optional[Lattice]:
    """Raw lattice from the token-sparse decoder's bounded device-emitted
    arc records (decoder/viterbi.py TokenLattice).

    TPU re-design of GetRawLattice (reference
    src/decoder/lattice-faster-decoder.cc): the lattice-beam pruning and
    ForwardLink discovery already happened ON DEVICE inside the decode
    scan; the host only materializes (t, slot) states and copies the
    (graph_cost, acoustic_cost) pairs — no loglikes matrix ever reaches
    the host and the transfer is O(T·L), not O(T·K·S)."""
    T = rec.src_slot.shape[0]
    if T == 0:
        return None
    lat = Lattice()
    start = lat.add_state(time=-1)
    lat.start = start
    slot_state: List[Dict[int, int]] = [dict() for _ in range(T)]

    def get(t: int, slot: int) -> int:
        if t < 0:
            return start
        d = slot_state[t]
        st = d.get(slot)
        if st is None:
            st = d[slot] = lat.add_state(time=t)
        return st

    split = graph.eps_ns is not None
    if split and rec.dst_state is None:
        return None  # split records require the post-hop dest states
    seeds = []
    if split:
        # the initial token set is the start state's eps closure (slot
        # k = k-th closure state); t=0 records must carry the seed
        # walk's words/weight from the true start state
        seeds = [s for s, _ in start_closure(graph, graph.eps_depth)]
    for t in range(T):
        arcs_t = rec.arc[t]
        live = np.nonzero(arcs_t >= 0)[0]
        srcs, dsts, acs = rec.src_slot[t], rec.dst_slot[t], rec.ac[t]
        for i in live:
            a = int(arcs_t[i])
            pre_words, pre_w = [], 0.0
            hop_words, hop_w = [], 0.0
            if split:
                # backoff words/weights along arc-target -> record dest
                walk = eps_walk(graph, int(graph.nextstate[a]),
                                int(rec.dst_state[t][i]))
                if walk is None:
                    continue  # inconsistent record; drop the arc
                hop_words, hop_w = walk
                if t == 0:
                    k = int(srcs[i])
                    if k >= len(seeds):
                        continue
                    seed_walk = eps_walk(graph, graph.start, seeds[k])
                    if seed_walk is None:
                        continue
                    pre_words, pre_w = seed_walk
            _emit(lat, graph, get(t - 1, int(srcs[i])),
                  get(t, int(dsts[i])), a, float(acs[i]),
                  pre_words=pre_words,
                  extra_words=hop_words, extra_gc=hop_w + pre_w)

    any_final = False
    last = slot_state[T - 1]
    for k, s in enumerate(rec.final_states):
        st = last.get(k)
        if st is None or s < 0:
            continue
        fw = graph.final_weight[int(s)]
        if np.isfinite(fw):
            lat.finals[st] = (float(fw), 0.0)
            any_final = True
    if not any_final:
        for k in last:
            lat.finals[last[k]] = (0.0, 0.0)
    _connect(lat)
    if lat.num_arcs == 0:
        return None
    return lat


def _emit(lat: Lattice, graph: CsrGraph, src: int, dst: int, arc_id: int,
          ac: float, extra_words=(), extra_gc: float = 0.0,
          pre_words=()):
    """Add a lattice arc for closed-graph arc arc_id, expanding multi-word
    output label chains; pre_words/extra_words/extra_gc fold a split-eps
    seed/backoff chain's labels and weight into the same lattice arc."""
    words = list(pre_words) + list(graph.arc_olabels[arc_id]) \
        + list(extra_words)
    tid = int(graph.tid[arc_id])
    gc = float(graph.weight[arc_id]) + float(extra_gc)
    if len(words) <= 1:
        lat.arcs[src].append(
            LatticeArc(tid, words[0] if words else 0, gc, ac, dst)
        )
    else:
        cur = src
        for i, w in enumerate(words):
            last = i == len(words) - 1
            nxt = dst if last else lat.add_state(time=lat.state_time[src])
            lat.arcs[cur].append(
                LatticeArc(
                    tid if i == 0 else 0, w,
                    gc if i == 0 else 0.0, ac if i == 0 else 0.0, nxt,
                )
            )
            cur = nxt


def _connect(lat: Lattice) -> None:
    """Trim states not on a start→final path (in place, preserves order)."""
    n = lat.num_states
    acc = np.zeros(n, bool)
    acc[lat.start] = True
    # states are roughly topsorted (start first, then by frame) — one pass
    # forward + fixpoint for the chain states
    changed = True
    while changed:
        changed = False
        for s in range(n):
            if acc[s]:
                for a in lat.arcs[s]:
                    if not acc[a.nextstate]:
                        acc[a.nextstate] = True
                        changed = True
    coacc = np.zeros(n, bool)
    for s in range(n):
        if lat.is_final(s):
            coacc[s] = True
    changed = True
    while changed:
        changed = False
        for s in range(n - 1, -1, -1):
            if not coacc[s]:
                if any(coacc[a.nextstate] for a in lat.arcs[s]):
                    coacc[s] = True
                    changed = True
    keep = acc & coacc
    remap = -np.ones(n, np.int64)
    new_arcs, new_finals, new_time = [], [], []
    for s in range(n):
        if keep[s]:
            remap[s] = len(new_arcs)
            new_arcs.append([a for a in lat.arcs[s] if keep[a.nextstate]])
            new_finals.append(lat.finals[s])
            new_time.append(lat.state_time[s])
    for lst in new_arcs:
        for a in lst:
            a.nextstate = int(remap[a.nextstate])
    lat.arcs = new_arcs
    lat.finals = new_finals
    lat.state_time = new_time
    lat.start = int(remap[lat.start]) if remap[lat.start] >= 0 else 0


def _topo_order(lat: Lattice) -> List[int]:
    n = lat.num_states
    indeg = np.zeros(n, np.int64)
    for s in range(n):
        for a in lat.arcs[s]:
            indeg[a.nextstate] += 1
    order = [s for s in range(n) if indeg[s] == 0]
    i = 0
    while i < len(order):
        s = order[i]
        i += 1
        for a in lat.arcs[s]:
            indeg[a.nextstate] -= 1
            if indeg[a.nextstate] == 0:
                order.append(a.nextstate)
    if len(order) != n:
        raise KaldiError("lattice has a cycle")
    return order


def lattice_state_times(lat: Lattice) -> List[int]:
    """Frame index per state, recomputed from emitting (ilabel != 0) arcs
    (reference lat/lattice-functions.cc LatticeStateTimes).  Fills and
    returns lat.state_time; where two paths disagree the larger count is
    kept."""
    times = [-1] * lat.num_states
    times[lat.start] = 0
    for s in _topo_order(lat):
        if times[s] < 0:
            continue
        for a in lat.arcs[s]:
            t = times[s] + (1 if a.ilabel != 0 else 0)
            if times[a.nextstate] < 0:
                times[a.nextstate] = t
            elif times[a.nextstate] != t:
                times[a.nextstate] = max(times[a.nextstate], t)
    lat.state_time = times
    return times


def lattice_best_path(
    lat: Lattice, lm_scale: float = 1.0, ac_scale: float = 0.1
) -> Tuple[List[int], List[int], float]:
    """(words, tids, cost) of the best path under the given scales."""
    order = _topo_order(lat)
    n = lat.num_states
    dist = np.full(n, INF)
    back: List[Optional[Tuple[int, LatticeArc]]] = [None] * n
    dist[lat.start] = 0.0
    for s in order:
        if dist[s] == INF:
            continue
        for a in lat.arcs[s]:
            nd = dist[s] + lat.combined(a, lm_scale, ac_scale)
            if nd < dist[a.nextstate]:
                dist[a.nextstate] = nd
                back[a.nextstate] = (s, a)
    best_s, best_c = -1, INF
    for s in range(n):
        if lat.is_final(s):
            g, ac = lat.finals[s]
            c = dist[s] + lm_scale * g + ac_scale * ac
            if c < best_c:
                best_s, best_c = s, c
    if best_s < 0:
        return [], [], INF
    words, tids = [], []
    s = best_s
    while back[s] is not None:
        ps, a = back[s]
        if a.olabel:
            words.append(a.olabel)
        if a.ilabel:
            tids.append(a.ilabel)
        s = ps
    return words[::-1], tids[::-1], best_c


def lattice_prune(
    lat: Lattice, lattice_beam: float = 10.0,
    lm_scale: float = 1.0, ac_scale: float = 0.1,
) -> Lattice:
    """A new lattice of the arcs and finals within lattice_beam of the best
    path (reference lattice-prune); states renumbered in order of first
    use, from the start."""
    order = _topo_order(lat)
    n = lat.num_states
    fwd = np.full(n, INF)
    fwd[lat.start] = 0.0
    for s in order:
        if fwd[s] == INF:
            continue
        for a in lat.arcs[s]:
            c = fwd[s] + lat.combined(a, lm_scale, ac_scale)
            if c < fwd[a.nextstate]:
                fwd[a.nextstate] = c
    bwd = np.full(n, INF)
    for s in range(n):
        if lat.is_final(s):
            g, ac = lat.finals[s]
            bwd[s] = lm_scale * g + ac_scale * ac
    for s in reversed(order):
        for a in lat.arcs[s]:
            c = lat.combined(a, lm_scale, ac_scale) + bwd[a.nextstate]
            if c < bwd[s]:
                bwd[s] = c
    best = min((fwd[s] + bwd[s] for s in range(n) if fwd[s] < INF and bwd[s] < INF),
               default=INF)
    out = Lattice()
    remap: Dict[int, int] = {}

    def get(s: int) -> int:
        if s not in remap:
            remap[s] = out.add_state(lat.state_time[s])
        return remap[s]

    out.start = get(lat.start)
    for s in range(n):
        if fwd[s] == INF or bwd[s] == INF:
            continue
        for a in lat.arcs[s]:
            c = fwd[s] + lat.combined(a, lm_scale, ac_scale) + bwd[a.nextstate]
            if c <= best + lattice_beam:
                out.arcs[get(s)].append(LatticeArc(a.ilabel, a.olabel, a.graph_cost,
                                                   a.acoustic_cost, get(a.nextstate)))
        if lat.is_final(s) and fwd[s] + bwd[s] <= best + lattice_beam:
            out.finals[get(s)] = lat.finals[s]
    return out


def _forward_backward(lat: Lattice, order: List[int], lm_scale: float, ac_scale: float
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Log-semiring forward and backward scores (negated costs) per state."""
    n = lat.num_states
    fwd = np.full(n, -INF)
    fwd[lat.start] = 0.0
    for s in order:
        if fwd[s] == -INF:
            continue
        for a in lat.arcs[s]:
            c = fwd[s] - lat.combined(a, lm_scale, ac_scale)
            fwd[a.nextstate] = np.logaddexp(fwd[a.nextstate], c)
    bwd = np.full(n, -INF)
    for s in range(n):
        if lat.is_final(s):
            g, ac = lat.finals[s]
            bwd[s] = -(lm_scale * g + ac_scale * ac)
    for s in reversed(order):
        for a in lat.arcs[s]:
            c = -lat.combined(a, lm_scale, ac_scale) + bwd[a.nextstate]
            bwd[s] = np.logaddexp(bwd[s], c)
    return fwd, bwd


def lattice_arc_posteriors(
    lat: Lattice, lm_scale: float = 1.0, ac_scale: float = 0.1
) -> List[List[float]]:
    """Per-arc posterior probabilities, [state][arc], from a log-semiring
    forward-backward (reference LatticeForwardBackward)."""
    fwd, bwd = _forward_backward(lat, _topo_order(lat), lm_scale, ac_scale)
    total = bwd[lat.start]  # log total path mass
    post: List[List[float]] = []
    for s in range(lat.num_states):
        row = []
        for a in lat.arcs[s]:
            lp = fwd[s] - lat.combined(a, lm_scale, ac_scale) + bwd[a.nextstate] - total
            row.append(float(np.exp(min(lp, 0.0))))
        post.append(row)
    return post


def lattice_total_logprob(
    lat: Lattice, lm_scale: float = 1.0, ac_scale: float = 0.1
) -> float:
    """log of the total path mass under the given scales (the normaliser of
    lattice_arc_posteriors; the MMI denominator's log-likelihood)."""
    n = lat.num_states
    fwd = np.full(n, -INF)
    fwd[lat.start] = 0.0
    total = -INF
    for s in _topo_order(lat):
        if fwd[s] == -INF:
            continue
        if lat.is_final(s):
            g, ac = lat.finals[s]
            total = np.logaddexp(total, fwd[s] - (lm_scale * g + ac_scale * ac))
        for a in lat.arcs[s]:
            c = fwd[s] - lat.combined(a, lm_scale, ac_scale)
            fwd[a.nextstate] = np.logaddexp(fwd[a.nextstate], c)
    return float(total)


def lattice_oracle(
    lat: Lattice, ref_words: Sequence[int]
) -> Tuple[int, List[int]]:
    """Oracle (minimum) edit distance of any lattice path against ref_words,
    and the words of an achieving path (reference latbin/lattice-oracle:
    composition with an edit-distance transducer; here the equivalent DP
    over (lattice state, ref position))."""
    order = _topo_order(lat)
    n = lat.num_states
    Q = len(ref_words)
    INF_I = 10 ** 9
    # dp[s][q] = min edits to reach s having consumed ref[:q]
    dp = np.full((n, Q + 1), INF_I, np.int64)
    back: Dict[Tuple[int, int], Tuple[int, int, int]] = {}
    # deletions of leading ref words at the start state
    dp[lat.start, :] = np.arange(Q + 1)
    for s in order:
        for q in range(Q + 1):
            d = dp[s, q]
            if d >= INF_I:
                continue
            # delete ref word (stay at state, advance q) — handled by the
            # initialization sweep below via in-state relaxation
            if q < Q and d + 1 < dp[s, q + 1]:
                dp[s, q + 1] = d + 1
                back[(s, q + 1)] = (s, q, -1)  # -1 = deletion
            for a in lat.arcs[s]:
                ns = a.nextstate
                if a.olabel == 0:
                    if d < dp[ns, q]:
                        dp[ns, q] = d
                        back[(ns, q)] = (s, q, 0)
                else:
                    # substitution / match
                    if q < Q:
                        c = d + (a.olabel != ref_words[q])
                        if c < dp[ns, q + 1]:
                            dp[ns, q + 1] = c
                            back[(ns, q + 1)] = (s, q, a.olabel)
                    # insertion of the arc word
                    if d + 1 < dp[ns, q]:
                        dp[ns, q] = d + 1
                        back[(ns, q)] = (s, q, a.olabel)
    best_s, best = -1, INF_I
    for s in range(n):
        if lat.is_final(s) and dp[s, Q] < best:
            best_s, best = s, int(dp[s, Q])
    if best_s < 0:
        return INF_I, []
    words: List[int] = []
    s, q = best_s, Q
    while (s, q) in back:
        ps, pq, w = back[(s, q)]
        if w > 0:
            words.append(w)
        s, q = ps, pq
    return best, words[::-1]


# ---------------------------------------------------------------------------
# n-best lists
# ---------------------------------------------------------------------------

def lattice_nbest_paths(
    lat: Lattice, n: int, lm_scale: float = 1.0, ac_scale: float = 0.1
) -> List[Tuple[List[LatticeArc], Tuple[float, float]]]:
    """The n best full paths as arc sequences (reference lattice-to-nbest:
    paths, not distinct word sequences): [(arcs, (final graph, final
    acoustic))], the best first."""
    order = _topo_order(lat)
    ns = lat.num_states
    # per state: up to n partial paths (cost, prev state, prev rank, arc index)
    entries: List[List[Tuple[float, int, int, int]]] = [[] for _ in range(ns)]
    entries[lat.start] = [(0.0, -1, -1, -1)]
    for s in order:
        if not entries[s]:
            continue
        for ai, a in enumerate(lat.arcs[s]):
            w = lat.combined(a, lm_scale, ac_scale)
            dst = a.nextstate
            add = [(c + w, s, r, ai) for r, (c, _, _, _) in enumerate(entries[s])]
            entries[dst] = sorted(entries[dst] + add, key=lambda e: e[0])[:n]
    cands: List[Tuple[float, int, int]] = []  # (total cost, state, rank)
    for s in range(ns):
        if lat.is_final(s):
            g, ac = lat.finals[s]
            fc = lm_scale * g + ac_scale * ac
            for r, (c, _, _, _) in enumerate(entries[s]):
                cands.append((c + fc, s, r))
    cands.sort(key=lambda e: e[0])
    out = []
    for _, s, r in cands[:n]:
        arcs: List[LatticeArc] = []
        cur, rank = s, r
        while True:
            _, ps, pr, ai = entries[cur][rank]
            if ps < 0:
                break
            arcs.append(lat.arcs[ps][ai])
            cur, rank = ps, pr
        out.append((arcs[::-1], lat.finals[s]))
    return out


def linear_lattice_from_path(arcs: Sequence[LatticeArc], final: Tuple[float, float]
                             ) -> Lattice:
    """A linear (single-path) lattice of an arc sequence."""
    lat = Lattice()
    t = 0
    cur = lat.add_state(t)
    lat.start = cur
    for a in arcs:
        if a.ilabel:
            t += 1
        nxt = lat.add_state(t)
        lat.arcs[cur].append(LatticeArc(a.ilabel, a.olabel, a.graph_cost,
                                        a.acoustic_cost, nxt))
        cur = nxt
    lat.finals[cur] = final
    return lat


def lattice_union(lats: Sequence[Lattice]) -> Lattice:
    """The union of lattices through a shared start state with free epsilon
    arcs (reference lattice-combine, fst::Union)."""
    out = Lattice()
    start = out.add_state(0)
    out.start = start
    for lat in lats:
        off = out.num_states
        for s in range(lat.num_states):
            out.add_state(lat.state_time[s])
        for s in range(lat.num_states):
            for a in lat.arcs[s]:
                out.arcs[off + s].append(LatticeArc(a.ilabel, a.olabel, a.graph_cost,
                                                    a.acoustic_cost, off + a.nextstate))
            out.finals[off + s] = lat.finals[s]
        out.arcs[start].append(LatticeArc(0, 0, 0.0, 0.0, off + lat.start))
    return out


def lattice_nbest(
    lat: Lattice, n: int, lm_scale: float = 1.0, ac_scale: float = 0.1
) -> List[Tuple[List[int], float]]:
    """The n best distinct word sequences with their costs: a k-best DP over
    the DAG keeping the best cost of each word prefix (4n a state)."""
    order = _topo_order(lat)
    ns = lat.num_states
    cap = 4 * n
    best: List[List[Tuple[float, Tuple[int, ...]]]] = [[] for _ in range(ns)]
    best[lat.start] = [(0.0, ())]
    for s in order:
        if not best[s]:
            continue
        for a in lat.arcs[s]:
            w = lat.combined(a, lm_scale, ac_scale)
            add = [(c + w, words + ((a.olabel,) if a.olabel else ()))
                   for c, words in best[s]]
            merged = best[a.nextstate] + add
            merged.sort(key=lambda x: x[0])
            seen = set()
            kept = []
            for c, words in merged:
                if words in seen:
                    continue
                seen.add(words)
                kept.append((c, words))
                if len(kept) >= cap:
                    break
            best[a.nextstate] = kept
    results: Dict[Tuple[int, ...], float] = {}
    for s in range(ns):
        if lat.is_final(s):
            g, ac = lat.finals[s]
            fc = lm_scale * g + ac_scale * ac
            for c, words in best[s]:
                tot = c + fc
                if words not in results or tot < results[words]:
                    results[words] = tot
    out = sorted(results.items(), key=lambda x: x[1])[:n]
    return [(list(words), cost) for words, cost in out]


def rescore_nbest(
    nbest: Sequence[Tuple[List[int], float]],
    old_lm_score: Callable[[List[int]], float],
    new_lm_score: Callable[[List[int]], float],
    new_lm_scale: float = 1.0,
) -> List[Tuple[List[int], float]]:
    """n-best LM rescoring, cost' = cost − old_lm + new_lm_scale · new_lm,
    re-sorted (reference lattice-lmrescore through n-best lists).  The
    scorers map a word-id list to −log P (the graph-cost convention)."""
    out = [(words, cost - old_lm_score(words) + new_lm_scale * new_lm_score(words))
           for words, cost in nbest]
    out.sort(key=lambda x: x[1])
    return out


# ---------------------------------------------------------------------------
# posteriors, the word-level view, confusion networks
# ---------------------------------------------------------------------------

def lattice_word_posteriors(
    lat: Lattice, lm_scale: float = 1.0, ac_scale: float = 0.1
) -> Dict[int, float]:
    """Expected count of each word id (lattice-to-post projected on words)."""
    post = lattice_arc_posteriors(lat, lm_scale, ac_scale)
    out: Dict[int, float] = {}
    for s in range(lat.num_states):
        for a, p in zip(lat.arcs[s], post[s]):
            if a.olabel:
                out[a.olabel] = out.get(a.olabel, 0.0) + p
    return out


def lattice_to_word_fst(lat: Lattice, lm_scale: float = 1.0, ac_scale: float = 0.1):
    """The lattice projected on its words (combined weights) and
    determinized in the tropical semiring: the best path of each word
    sequence (the CompactLattice-determinization role).  The
    determinization is the native graph library's DeterminizeStar (weights
    in float32); returns a VectorFst."""
    from old_kaldi_git_tpu_torch.fst.native import NativeFst

    fst = VectorFst()
    for _ in range(lat.num_states):
        fst.add_state()
    fst.set_start(lat.start)
    for s in range(lat.num_states):
        for a in lat.arcs[s]:
            fst.add_arc(s, Arc(a.olabel, a.olabel, lat.combined(a, lm_scale, ac_scale),
                               a.nextstate))
        if lat.is_final(s):
            g, ac = lat.finals[s]
            fst.set_final(s, lm_scale * g + ac_scale * ac)
    det = NativeFst.from_vector_fst(fst).determinize_star()
    start, row_ptr, il, ol, w, nxt, finals = det.to_raw_arrays()
    out = VectorFst()
    for s in range(len(finals)):
        out.add_state()
        out.arcs[s] = [Arc(int(il[a]), int(ol[a]), float(w[a]), int(nxt[a]))
                       for a in range(row_ptr[s], row_ptr[s + 1])]
        if np.isfinite(finals[s]):
            out.set_final(s, float(finals[s]))
    out.set_start(int(start))
    return out


def confusion_network(
    lat: Lattice, lm_scale: float = 1.0, ac_scale: float = 0.1
) -> List[List[Tuple[int, float]]]:
    """A sausage by clustering word arcs by time: arcs whose midpoints lie
    within 3 frames share a bin while its mass allows, bins ordered by
    time, each bin's (word, posterior) sorted by posterior (the common
    approximation of MinimumBayesRisk's exact alignment, lat/mbr.py)."""
    post = lattice_arc_posteriors(lat, lm_scale, ac_scale)
    events = []  # (midpoint frame, word, posterior)
    for s in range(lat.num_states):
        t0 = lat.state_time[s]
        for a, p in zip(lat.arcs[s], post[s]):
            if a.olabel and p > 1e-4:
                t1 = lat.state_time[a.nextstate]
                events.append(((t0 + t1) / 2.0 if t0 >= 0 else t1, a.olabel, p))
    if not events:
        return []
    events.sort()
    bins: List[Dict[int, float]] = []
    bin_times: List[float] = []
    for t, w, p in events:
        placed = False
        for i, bt in enumerate(bin_times):
            if abs(t - bt) <= 3.0:
                if w in bins[i] or sum(bins[i].values()) < 1.0 - p + 1e-3:
                    bins[i][w] = bins[i].get(w, 0.0) + p
                    bin_times[i] = (bin_times[i] + t) / 2.0
                    placed = True
                    break
        if not placed:
            bins.append({w: p})
            bin_times.append(t)
    return [sorted(b.items(), key=lambda x: -x[1]) for b in bins]


# ---------------------------------------------------------------------------
# depth, frame posteriors, interpolation
# ---------------------------------------------------------------------------

def lattice_depth(lat: Lattice) -> float:
    """Mean number of emitting arcs ending on each frame (lattice-depth)."""
    counts: Dict[int, int] = {}
    for s in range(lat.num_states):
        for a in lat.arcs[s]:
            if a.ilabel:
                t = lat.state_time[a.nextstate]
                if t >= 0:
                    counts[t] = counts.get(t, 0) + 1
    if not counts:
        return 0.0
    return sum(counts.values()) / (max(counts) + 1)


def lattice_to_post(
    lat: Lattice, tm, lm_scale: float = 1.0, ac_scale: float = 0.1,
    min_post: float = 0.01,
) -> List[List[Tuple[int, float]]]:
    """Per-frame pdf posteriors [(pdf, weight)], sorted by pdf
    (lattice-to-post + post-to-pdf-post): the arc posteriors of at least
    `min_post` summed by (frame of the arc's end, pdf)."""
    post = lattice_arc_posteriors(lat, lm_scale, ac_scale)
    T = max((t for t in lat.state_time if t >= 0), default=-1) + 1
    out: List[Dict[int, float]] = [dict() for _ in range(T)]
    for s in range(lat.num_states):
        for a, p in zip(lat.arcs[s], post[s]):
            if not a.ilabel or p < min_post:
                continue
            t = lat.state_time[a.nextstate]
            if 0 <= t < T:
                pdf = tm.tid_to_pdf(a.ilabel)
                out[t][pdf] = out[t].get(pdf, 0.0) + p
    return [sorted(d.items()) for d in out]


def lattice_interp(
    lat1: Lattice,
    lat2: Lattice,
    alpha: float = 0.5,
    lm_scale2: float = 1.0,
    ac_scale2: float = 0.1,
) -> Optional[Lattice]:
    """Score interpolation of two lattices of one utterance (reference
    latbin/lattice-interp.cc): lat1 scaled by alpha, composed with lat2's
    determinized word acceptor scaled by 1 − alpha.  A product over (lat1
    state, word-FST state): lat1's epsilon-word arcs move freely, its word
    arcs must match the acceptor, whose cost joins the graph cost.  None
    when the word sequences do not meet (the reference skips the
    utterance)."""
    wfst2 = lattice_to_word_fst(lat2, lm_scale2, ac_scale2)
    trans: List[Dict[int, Tuple[float, int]]] = [{} for _ in range(wfst2.num_states)]
    for s in wfst2.states():
        for a in wfst2.arcs[s]:
            trans[s][a.olabel] = (a.weight, a.nextstate)
    out = Lattice()
    smap: Dict[Tuple[int, int], int] = {}

    def get(s1: int, s2: int) -> int:
        key = (s1, s2)
        if key not in smap:
            smap[key] = out.add_state(lat1.state_time[s1])
        return smap[key]

    out.start = get(lat1.start, wfst2.start)
    stack = [(lat1.start, wfst2.start)]
    seen = {(lat1.start, wfst2.start)}
    any_final = False
    while stack:
        s1, s2 = stack.pop()
        src = get(s1, s2)
        if lat1.is_final(s1) and wfst2.is_final(s2):
            g, ac = lat1.finals[s1]
            out.finals[src] = (alpha * g + (1.0 - alpha) * wfst2.finals[s2], alpha * ac)
            any_final = True
        for a in lat1.arcs[s1]:
            if a.olabel == 0:
                n2, extra = s2, 0.0
            else:
                hit = trans[s2].get(a.olabel)
                if hit is None:
                    continue
                extra, n2 = hit
            key = (a.nextstate, n2)
            out.arcs[src].append(LatticeArc(
                a.ilabel, a.olabel, alpha * a.graph_cost + (1.0 - alpha) * extra,
                alpha * a.acoustic_cost, get(*key)))
            if key not in seen:
                seen.add(key)
                stack.append(key)
    if not any_final:
        return None
    _connect(out)
    return out if out.num_states and out.arcs[out.start] else None
