"""Core WFST algorithms on VectorFst, host Python (counterpart of
old_kaldi_git_tpu/fst/algorithms.py).  The graph builds run in the native
library (fst/native.py); these serve the fst* command-line tools, whose
output files must be byte-equal to the JAX package's.

Parity with reference src/fstext (SURVEY.md §2.4):
  compose            — OpenFst-style composition with the 3-state eps filter
                       (table-compose is a lookup optimization; dict suffices)
  determinize_star   — fstext/determinize-star-inl.h: epsilon-removing subset
                       determinization with output-string residuals; tropical
                       or log semiring ('--use-log')
  minimize_encoded   — fstbin/fstminimizeencoded: encode arcs as labels, then
                       partition-refinement minimization of the det. acceptor
  remove_eps_local   — fstext/remove-eps-local.h (safe local eps splicing)
  rm_symbols         — fstrmsymbols (disambig removal: label → eps)
  push_special       — fstext/push-special.cc (uniform per-state outflow via
                       power iteration, preserves equivalence mod constant)
  shortest_path, project — evaluation helpers
  fst_equivalent     — bounded-length weighted equivalence (RandEquivalent's
                       test role; fstequivalent)
  add_disambig_self_loops — fstbin/fstaddselfloops
  replace_fst        — static expansion of nonterminal arcs (GrammarFst's
                       build-time role; make-grammar-fst)
"""

from __future__ import annotations

import math
from typing import Dict, FrozenSet, List, Optional, Tuple

from old_kaldi_git_tpu_torch.fst.vector_fst import EPS, INF, NO_STATE, Arc, VectorFst
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("fst")


def _logadd(a: float, b: float) -> float:
    """Tropical-ish logadd in the -log domain: -log(e^-a + e^-b)."""
    if a == INF:
        return b
    if b == INF:
        return a
    m = min(a, b)
    return m - math.log1p(math.exp(-(abs(a - b))))


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------

def compose(fst1: VectorFst, fst2: VectorFst, connect: bool = True) -> VectorFst:
    """fst1 ∘ fst2 with the standard epsilon filter (Mohri); fst2 should be
    ilabel-sorted for the binary-search match (we index with a dict)."""
    if fst1.start == NO_STATE or fst2.start == NO_STATE:
        return VectorFst()
    out = VectorFst()
    # index fst2 arcs by (state, ilabel)
    idx2: List[Dict[int, List[Arc]]] = []
    for s in fst2.states():
        d: Dict[int, List[Arc]] = {}
        for a in fst2.arcs[s]:
            d.setdefault(a.ilabel, []).append(a)
        idx2.append(d)

    start = (fst1.start, fst2.start, 0)
    ids: Dict[Tuple[int, int, int], int] = {start: out.add_state()}
    out.set_start(0)
    stack = [start]
    while stack:
        key = stack.pop()
        s1, s2, f = key
        src = ids[key]
        w_final = fst1.finals[s1] + fst2.finals[s2]
        if w_final != INF:
            out.set_final(src, w_final)

        def emit(il, ol, w, n1, n2, nf):
            nkey = (n1, n2, nf)
            if nkey not in ids:
                ids[nkey] = out.add_state()
                stack.append(nkey)
            out.add_arc(src, Arc(il, ol, w, ids[nkey]))

        for a1 in fst1.arcs[s1]:
            if a1.olabel == EPS:
                # move fst1 only: allowed in filter 0,1
                if f != 2:
                    emit(a1.ilabel, EPS, a1.weight, a1.nextstate, s2, 1)
            else:
                for a2 in idx2[s2].get(a1.olabel, ()):
                    emit(
                        a1.ilabel, a2.olabel, a1.weight + a2.weight,
                        a1.nextstate, a2.nextstate, 0,
                    )
        # move fst2 only on its input-eps arcs: allowed in filter 0,2
        if f != 1:
            for a2 in idx2[s2].get(EPS, ()):
                emit(EPS, a2.olabel, a2.weight, s1, a2.nextstate, 2)
    if connect:
        out.connect()
    return out


# ---------------------------------------------------------------------------
# determinize-star
# ---------------------------------------------------------------------------

_MAX_DET_STATES = 5_000_000


def determinize_star(
    fst: VectorFst, use_log: bool = False, max_states: int = _MAX_DET_STATES
) -> VectorFst:
    """Epsilon-removing determinization with output strings.

    Subsets are frozensets of (state, residual_weight, residual_output_tuple).
    Output label sequences of length > 1 are emitted as chains of eps-input
    arcs, as in the reference.  Raises KaldiError on (likely) non-functional
    or non-determinizable input (subset blow-up).
    """
    if fst.start == NO_STATE:
        return VectorFst()
    plus = _logadd if use_log else min

    def closure(
        triples: List[Tuple[int, float, Tuple[int, ...]]],
    ) -> FrozenSet[Tuple[int, float, Tuple[int, ...]]]:
        """Epsilon-closure over input-eps arcs, merging weights per
        (state, string)."""
        best: Dict[Tuple[int, Tuple[int, ...]], float] = {}
        work = list(triples)
        while work:
            s, w, o = work.pop()
            key = (s, o)
            if key in best:
                merged = plus(best[key], w)
                if merged == best[key] and not use_log:
                    continue
                if use_log and abs(merged - best[key]) < 1e-12:
                    continue
                best[key] = merged
                w = merged
            else:
                best[key] = w
            for a in fst.arcs[s]:
                if a.ilabel == EPS:
                    no = o if a.olabel == EPS else o + (a.olabel,)
                    if len(no) > 10_000:
                        raise KaldiError("determinize_star: output string blow-up "
                                         "(epsilon cycle with output?)")
                    work.append((a.nextstate, w + a.weight, no))
        return frozenset((s, w, o) for (s, o), w in best.items())

    def normalize(subset):
        """Extract common weight and common output prefix."""
        items = sorted(subset)
        w_common = items[0][1]
        for _, w, _ in items[1:]:
            w_common = plus(w_common, w)
        strs = [o for _, _, o in items]
        prefix = strs[0]
        for o in strs[1:]:
            k = 0
            while k < len(prefix) and k < len(o) and prefix[k] == o[k]:
                k += 1
            prefix = prefix[:k]
        norm = frozenset(
            (s, w - w_common, o[len(prefix):]) for s, w, o in items
        )
        return w_common, prefix, norm

    out = VectorFst()
    start_closure = closure([(fst.start, 0.0, ())])
    w0, p0, norm0 = normalize(start_closure)
    # fold any start weight/prefix into an initial eps chain if needed
    ids: Dict[FrozenSet, int] = {norm0: out.add_state()}
    out.set_start(0)
    if w0 != 0.0 or p0:
        real_start = out.add_state()
        out.start = real_start
        cur = real_start
        labels = list(p0) or [EPS]
        for i, ol in enumerate(labels):
            w = w0 if i == 0 else 0.0
            nxt = ids[norm0] if i == len(labels) - 1 else out.add_state()
            out.add_arc(cur, Arc(EPS, ol, w, nxt))
            cur = nxt

    stack = [norm0]
    while stack:
        subset = stack.pop()
        src = ids[subset]
        # final weight: triples at final states must flush their strings
        final_items: Dict[Tuple[int, ...], float] = {}
        for s, w, o in subset:
            if fst.finals[s] != INF:
                wt = w + fst.finals[s]
                final_items[o] = plus(final_items.get(o, INF), wt)
        for o, w in sorted(final_items.items()):
            if not o:
                out.set_final(src, w)
            else:
                cur = src
                for i, ol in enumerate(o):
                    nxt = out.add_state()
                    out.add_arc(cur, Arc(EPS, ol, w if i == 0 else 0.0, nxt))
                    cur = nxt
                out.set_final(cur, 0.0)

        # group moves by ilabel
        moves: Dict[int, List[Tuple[int, float, Tuple[int, ...]]]] = {}
        for s, w, o in subset:
            for a in fst.arcs[s]:
                if a.ilabel != EPS:
                    no = o if a.olabel == EPS else o + (a.olabel,)
                    moves.setdefault(a.ilabel, []).append(
                        (a.nextstate, w + a.weight, no)
                    )
        for il in sorted(moves):
            closed = closure(moves[il])
            w_common, prefix, norm = normalize(closed)
            if norm not in ids:
                if len(ids) >= max_states:
                    raise KaldiError(
                        f"determinize_star: exceeded {max_states} states — "
                        "input may not be determinizable"
                    )
                ids[norm] = out.add_state()
                stack.append(norm)
            dest = ids[norm]
            labels = list(prefix)
            if len(labels) <= 1:
                out.add_arc(src, Arc(il, labels[0] if labels else EPS, w_common, dest))
            else:
                cur = src
                for i, ol in enumerate(labels):
                    last = i == len(labels) - 1
                    nxt = dest if last else out.add_state()
                    out.add_arc(
                        cur,
                        Arc(il if i == 0 else EPS, ol, w_common if i == 0 else 0.0, nxt),
                    )
                    cur = nxt
    return out


# ---------------------------------------------------------------------------
# minimization (encoded)
# ---------------------------------------------------------------------------

def minimize_encoded(fst: VectorFst) -> VectorFst:
    """Moore partition refinement treating (ilabel, olabel, weight) as one
    encoded label.  Valid for deterministic (post-determinize_star) FSTs;
    matches fstminimizeencoded semantics (weights/olabels not pushed)."""
    n = fst.num_states
    if n == 0:
        return fst.copy()
    # initial partition: by final weight
    part: Dict[int, int] = {}
    blocks: Dict[float, int] = {}
    for s in fst.states():
        key = fst.finals[s]
        if key not in blocks:
            blocks[key] = len(blocks)
        part[s] = blocks[key]
    changed = True
    while changed:
        changed = False
        sig2block: Dict[Tuple, int] = {}
        new_part: Dict[int, int] = {}
        for s in fst.states():
            sig = (
                part[s],
                tuple(
                    sorted(
                        (a.ilabel, a.olabel, round(a.weight, 9), part[a.nextstate])
                        for a in fst.arcs[s]
                    )
                ),
            )
            if sig not in sig2block:
                sig2block[sig] = len(sig2block)
            new_part[s] = sig2block[sig]
        if len(sig2block) != len(set(part.values())):
            changed = True
        part = new_part
    # rebuild
    out = VectorFst()
    reps: Dict[int, int] = {}
    for s in fst.states():
        b = part[s]
        if b not in reps:
            reps[b] = out.add_state()
    emitted = set()
    for s in fst.states():
        b = part[s]
        if b in emitted:
            continue
        emitted.add(b)
        for a in fst.arcs[s]:
            out.add_arc(reps[b], Arc(a.ilabel, a.olabel, a.weight, reps[part[a.nextstate]]))
        if fst.finals[s] != INF:
            out.set_final(reps[b], fst.finals[s])
    out.set_start(reps[part[fst.start]])
    out.connect()
    return out


# ---------------------------------------------------------------------------
# epsilon removal (local) and symbol removal
# ---------------------------------------------------------------------------

def remove_eps_local(fst: VectorFst) -> None:
    """Remove eps:eps arcs where splicing is equivalence-safe (reference
    RemoveEpsLocal).  In-place; ends with connect()."""
    changed = True
    while changed:
        changed = False
        incoming = [0] * fst.num_states
        for s in fst.states():
            for a in fst.arcs[s]:
                incoming[a.nextstate] += 1
        for s in fst.states():
            kept: List[Arc] = []
            for a in fst.arcs[s]:
                d = a.nextstate
                if (
                    a.ilabel == EPS
                    and a.olabel == EPS
                    and d != s
                    and incoming[d] == 1
                    and fst.finals[d] == INF
                    and d != fst.start
                ):
                    # splice d's arcs onto s
                    for b in fst.arcs[d]:
                        kept.append(Arc(b.ilabel, b.olabel, a.weight + b.weight, b.nextstate))
                    fst.arcs[d] = []
                    changed = True
                else:
                    kept.append(a)
            fst.arcs[s] = kept
    fst.connect()


def rm_symbols(fst: VectorFst, labels, side: str = "input") -> None:
    """Replace given labels with epsilon (fstrmsymbols).  In-place."""
    labels = set(labels)
    for s in fst.states():
        for a in fst.arcs[s]:
            if side == "input" and a.ilabel in labels:
                a.ilabel = EPS
            elif side == "output" and a.olabel in labels:
                a.olabel = EPS


def project(fst: VectorFst, side: str = "input") -> VectorFst:
    out = fst.copy()
    for s in out.states():
        for a in out.arcs[s]:
            if side == "input":
                a.olabel = a.ilabel
            else:
                a.ilabel = a.olabel
    return out


# ---------------------------------------------------------------------------
# push-special
# ---------------------------------------------------------------------------

def push_special(fst: VectorFst, delta: float = 1e-3, max_iters: int = 200) -> None:
    """Reweight (in place) so every state's total outflow (arcs + final, in
    probability domain) is the same constant; preserves path weights up to a
    global constant (reference push-special.cc, power-iteration form)."""
    n = fst.num_states
    if n == 0:
        return
    x = [1.0] * n
    lam = 1.0
    for _ in range(max_iters):
        nx = [0.0] * n
        for s in fst.states():
            acc = 0.0
            for a in fst.arcs[s]:
                acc += math.exp(-a.weight) * x[a.nextstate]
            if fst.finals[s] != INF:
                acc += math.exp(-fst.finals[s])
            nx[s] = acc
        norm = sum(nx) / n
        if norm <= 0:
            return
        nx = [v / norm for v in nx]
        diff = max(abs(a - b) for a, b in zip(nx, x))
        x = nx
        lam = norm
        if diff < delta:
            break
    logx = [math.log(max(v, 1e-30)) for v in x]
    for s in fst.states():
        for a in fst.arcs[s]:
            a.weight = a.weight + logx[s] - logx[a.nextstate]
        if fst.finals[s] != INF:
            fst.finals[s] = fst.finals[s] + logx[s]


# ---------------------------------------------------------------------------
# shortest path / equivalence (test & eval helpers)
# ---------------------------------------------------------------------------

def shortest_path(fst: VectorFst) -> Tuple[float, List[int], List[int]]:
    """Single tropical shortest path: (weight, ilabels, olabels).
    Bellman-Ford-ish label-correcting (handles negative weights, no neg
    cycles expected)."""
    import heapq

    if fst.start == NO_STATE:
        return INF, [], []
    n = fst.num_states
    dist = [INF] * n
    back: List[Optional[Tuple[int, Arc]]] = [None] * n
    dist[fst.start] = 0.0
    heap = [(0.0, fst.start)]
    while heap:
        d, s = heapq.heappop(heap)
        if d > dist[s] + 1e-12:
            continue
        for a in fst.arcs[s]:
            nd = d + a.weight
            if nd < dist[a.nextstate] - 1e-12:
                dist[a.nextstate] = nd
                back[a.nextstate] = (s, a)
                heapq.heappush(heap, (nd, a.nextstate))
    best_state, best_w = -1, INF
    for s in fst.states():
        if fst.finals[s] != INF and dist[s] + fst.finals[s] < best_w:
            best_w = dist[s] + fst.finals[s]
            best_state = s
    if best_state < 0:
        return INF, [], []
    ilabels: List[int] = []
    olabels: List[int] = []
    s = best_state
    while back[s] is not None:
        src, a = back[s]
        if a.ilabel != EPS:
            ilabels.append(a.ilabel)
        if a.olabel != EPS:
            olabels.append(a.olabel)
        s = src
    return best_w, ilabels[::-1], olabels[::-1]


def fst_sentence_cost(g: VectorFst, word_ids, backoff_ilabel: int) -> float:
    """Cost of a word sequence through a backoff G acceptor (reference
    BackoffDeterministicOnDemandFst, src/fstext/deterministic-fst.h): at each
    state the arc of the next word if there is one, else the #0 backoff arc
    and a retry; at the end, back off until a final state is reached."""
    s = g.start
    total = 0.0
    for w in word_ids:
        while True:
            hit = None
            bo = None
            for a in g.arcs[s]:
                if a.ilabel == w:
                    hit = a
                    break
                if a.ilabel == backoff_ilabel:
                    bo = a
            if hit is not None:
                total += hit.weight
                s = hit.nextstate
                break
            if bo is None:
                return INF
            total += bo.weight
            s = bo.nextstate
    while g.finals[s] == INF:
        bo = next((a for a in g.arcs[s] if a.ilabel == backoff_ilabel), None)
        if bo is None:
            return INF
        total += bo.weight
        s = bo.nextstate
    return total + g.finals[s]


def _string_weights(fst: VectorFst, max_len: int, use_log: bool, max_strings: int = 20000
                    ) -> Dict[Tuple[Tuple[int, ...], Tuple[int, ...]], float]:
    """Total weight of every (istring, ostring) pair of paths up to max_len
    arcs long, breadth first over (state, istring, ostring).  Exponential in
    the worst case: for test-sized FSTs."""
    plus = _logadd if use_log else min
    out: Dict[Tuple[Tuple[int, ...], Tuple[int, ...]], float] = {}
    if fst.start == NO_STATE:
        return out
    frontier: Dict[Tuple[int, Tuple[int, ...], Tuple[int, ...]], float] = {
        (fst.start, (), ()): 0.0}
    for _ in range(max_len + 1):
        new: Dict[Tuple[int, Tuple[int, ...], Tuple[int, ...]], float] = {}
        for (s, istr, ostr), w in frontier.items():
            if fst.finals[s] != INF:
                key = (istr, ostr)
                out[key] = plus(out.get(key, INF), w + fst.finals[s])
            for a in fst.arcs[s]:
                ni = istr + ((a.ilabel,) if a.ilabel != EPS else ())
                no = ostr + ((a.olabel,) if a.olabel != EPS else ())
                if len(ni) > max_len or len(no) > max_len:
                    continue
                k = (a.nextstate, ni, no)
                new[k] = plus(new.get(k, INF), w + a.weight)
                if len(new) > max_strings:
                    raise KaldiError("string-weight enumeration blow-up")
        frontier = new
        if not frontier:
            break
    return out


def fst_equivalent(a: VectorFst, b: VectorFst, max_len: int = 6, tol: float = 1e-4,
                   use_log: bool = False) -> bool:
    """Bounded-length weighted equivalence (the test role of OpenFst's
    RandEquivalent): every (istring, ostring) pair of up to max_len labels
    has the same total weight, within tol, in both."""
    wa = _string_weights(a, max_len, use_log)
    wb = _string_weights(b, max_len, use_log)
    for k in set(wa) | set(wb):
        x, y = wa.get(k, INF), wb.get(k, INF)
        if x == INF or y == INF:
            if x != y:
                return False
        elif abs(x - y) > tol:
            return False
    return True


def add_self_loops_from(*args, **kwargs):
    """Refuses, as the JAX package's stub does: self-loop addition needs the
    transition model and lives in hmm/hmm_utils.add_self_loops."""
    raise NotImplementedError(
        "self-loop addition lives in old_kaldi_git_tpu_torch.hmm.hmm_utils "
        "(needs the TransitionModel)")


def add_disambig_self_loops(fst: VectorFst, pairs) -> None:
    """Propagate disambiguation symbols through an FST by (ilabel, olabel)
    self-loops (reference fstbin/fstaddselfloops.cc, fstext-utils-inl.h
    AddSelfLoops), in place: a loop for every pair at the start state, at
    every final state and at every state with a non-epsilon output label on
    an outgoing arc."""
    targets = {fst.start}
    for s in fst.states():
        if fst.is_final(s) or any(a.olabel != 0 for a in fst.arcs[s]):
            targets.add(s)
    for s in targets:
        for il, ol in pairs:
            fst.add_arc(s, Arc(int(il), int(ol), 0.0, s))


def replace_fst(root: VectorFst, replacements, _active=frozenset()) -> VectorFst:
    """RTN expansion: sub-FSTs spliced in place of nonterminal arcs (the
    GrammarFst capability of reference src/decoder/grammar-fst.{h,cc},
    OpenFst Replace semantics), expanded at build time so that the decoder
    gets a static graph.

    `replacements` maps an olabel (a nonterminal word id) to the sub-FST
    its arcs expand into.  Each such arc (ilabel eps or equal to the
    olabel, as in an acceptor G) becomes an eps entry arc with its weight
    into a fresh copy of the (recursively expanded) sub-FST, and eps exit
    arcs from the copy's final states, with their final weights, to the
    arc's destination.  A nonterminal reachable from its own expansion is
    refused."""
    out = VectorFst()
    for _ in root.states():
        out.add_state()
    out.set_start(root.start)
    for s in root.states():
        if root.is_final(s):
            out.set_final(s, root.finals[s])
    expanded = {}  # label -> its expanded sub-FST, shared by every call site
    for s in root.states():
        for a in root.arcs[s]:
            if a.olabel not in replacements:
                out.add_arc(s, a.copy())
                continue
            if a.ilabel not in (0, a.olabel):
                raise KaldiError("nonterminal arc must be acceptor-like or eps-input, "
                                 f"got {a.ilabel}:{a.olabel}")
            if a.olabel in _active:
                raise KaldiError(f"recursive grammar at nonterminal {a.olabel}")
            if a.olabel not in expanded:
                expanded[a.olabel] = replace_fst(replacements[a.olabel], replacements,
                                                 _active | {a.olabel})
            sub = expanded[a.olabel]
            base = out.num_states
            for _ in sub.states():
                out.add_state()
            for ss in sub.states():
                for sa in sub.arcs[ss]:
                    out.add_arc(base + ss, Arc(sa.ilabel, sa.olabel, sa.weight,
                                               base + sa.nextstate))
                if sub.is_final(ss):
                    out.add_arc(base + ss, Arc(0, 0, sub.finals[ss], a.nextstate))
            out.add_arc(s, Arc(0, 0, a.weight, base + sub.start))
    out.connect()
    return out
