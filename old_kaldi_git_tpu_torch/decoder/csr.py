"""CSR arc-tensor form of a decoding graph (own numpy copy of the parts of
old_kaldi_git_tpu/decoder/csr.py that the decoder reads).

The decoder consumes graphs as CSR arrays whose epsilon arcs were eliminated
up front by forwarding: every state's outgoing arc set is
{ eps-closure ∘ emitting arc }, with closure weights folded in and the
closure's output labels remembered on the host for word recovery.  This
module holds the container, the flat output-label store, the per-state tile
layout and the conversions: folded from a native FST handle
(`fst_to_csr_native`) or from a VectorFst in host Python (`fst_to_csr`, the
JAX package's export, array for array the native one), and split-eps from an FST's
raw arrays (`fst_to_split_csr_arrays`, the chain graph's backoff shape).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.fst.vector_fst import EPS, INF
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("csr")


class FlatOlabels:
    """Per-arc (or per-state) output-label runs stored as flat (offsets,
    values) arrays — tuple-list protocol without millions of Python tuples."""

    __slots__ = ("offsets", "values")

    def __init__(self, offsets: np.ndarray, values: np.ndarray):
        self.offsets = offsets
        self.values = values

    def __len__(self):
        return len(self.offsets) - 1

    def __getitem__(self, i):
        return tuple(self.values[self.offsets[i]:self.offsets[i + 1]].tolist())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


Olabels = Union[List[Tuple[int, ...]], FlatOlabels]


@dataclasses.dataclass
class CsrGraph:
    """Emitting-arc CSR, plain numpy; the decoder moves its tile layout to
    the device once per graph and device.

    FOLDED regime (eps_ns is None): eps arcs are eliminated by closure
    forwarding — every arc's weight/olabels include its eps prefix.  SPLIT
    regime (eps_ns set): the emitting arcs only, plus at most one backoff
    eps arc a state (eps_ns/eps_w/eps_olab: its destination, weight and
    word, -1 / BIG / 0 without one; chains at most eps_depth deep), which
    the token-sparse decoder follows by hops after each frame."""

    start: int
    row_ptr: np.ndarray  # [S+1] int32
    tid: np.ndarray  # [A] int32 (transition-id, input label)
    pdf: np.ndarray  # [A] int32 (acoustic gather index)
    weight: np.ndarray  # [A] float32 (graph cost incl. folded eps prefix)
    nextstate: np.ndarray  # [A] int32
    final_weight: np.ndarray  # [S] float32 (+inf = not final)
    arc_olabels: Olabels  # per arc: word ids along eps prefix + arc
    final_olabels: Olabels  # per state: words on best eps path to final
    eps_ns: Optional[np.ndarray] = None
    eps_w: Optional[np.ndarray] = None
    eps_olab: Optional[np.ndarray] = None
    eps_depth: int = 0

    @property
    def num_states(self) -> int:
        return len(self.row_ptr) - 1

    @property
    def num_arcs(self) -> int:
        return len(self.tid)

    def out_degree(self) -> np.ndarray:
        return (self.row_ptr[1:] - self.row_ptr[:-1]).astype(np.int32)


@dataclasses.dataclass
class TileGraph:
    """Per-state MD-arc tile layout of a CsrGraph for the token-sparse
    decoder: every state's out-arcs are padded to a multiple of `md` and
    stored as [Ntile, md, 3] int32 rows (weight f32 bitcast, pdf,
    nextstate), so one gather per active token pulls a whole tile.  Padding
    arcs carry weight=BIG so their candidates cost >= BIG and die at the
    beam/keep gate.

    Padded arc id = tile_id * md + lane; `pad2orig` maps it back to the
    CsrGraph arc id (-1 on padding) so every id that leaves the decoder
    still refers to the original graph."""

    md: int
    tile_ptr: np.ndarray   # [S+1] int32 cumulative tiles per state
    tiles: np.ndarray      # [Ntile, md, 3] int32 (w bitcast, pdf, ns)
    pad2orig: np.ndarray   # [Ntile*md] int32, -1 = padding
    frm_pad: np.ndarray    # [Ntile*md] int32 source state (0 on padding)
    _dev: Dict[str, Tuple[torch.Tensor, ...]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def num_tiles(self) -> int:
        return len(self.tiles)

    def device_arrays(self, device: torch.device):
        """(tile_ptr, tiles, frm_pad) as tensors on `device`, uploaded once
        per device and kept.  The tiles stay int32: the weight column is a
        float32 bit pattern, reinterpreted with `.view(torch.float32)` after
        the gather — float arithmetic on it would flush the small integers
        of the other columns (denormals) to zero."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = tuple(
                torch.from_numpy(a).to(device)
                for a in (self.tile_ptr, self.tiles, self.frm_pad))
        return self._dev[key]


def build_tile_graph(graph: CsrGraph, md: int = 4,
                     big: float = 1e10) -> TileGraph:
    """Build (and cache on the graph) the MD-arc tile layout."""
    cached = getattr(graph, "_tile_graph", None)
    if cached is not None and cached.md == md:
        return cached
    deg = graph.out_degree().astype(np.int64)
    ntiles = -(-deg // md)  # ceil, 0 for dead states
    tile_ptr = np.zeros(len(deg) + 1, np.int64)
    np.cumsum(ntiles, out=tile_ptr[1:])
    ntile = int(tile_ptr[-1])
    ap = ntile * md
    w = np.full(ap, big, np.float32)
    pdf = np.zeros(ap, np.int32)
    ns = np.zeros(ap, np.int32)
    pad2orig = np.full(ap, -1, np.int32)
    frm_pad = np.zeros(ap, np.int32)
    # padded slot of arc i (state s, offset o) = (tile_ptr[s]*md) + o
    src = np.repeat(np.arange(graph.num_states, dtype=np.int64), deg)
    off = np.arange(graph.num_arcs, dtype=np.int64) - np.repeat(
        graph.row_ptr[:-1].astype(np.int64), deg)
    slot = tile_ptr[src] * md + off
    w[slot] = graph.weight
    pdf[slot] = graph.pdf
    ns[slot] = graph.nextstate
    pad2orig[slot] = np.arange(graph.num_arcs, dtype=np.int32)
    frm_pad[slot] = src.astype(np.int32)
    tiles = np.empty((ntile, md, 3), np.int32)
    tiles[:, :, 0] = w.view(np.int32).reshape(ntile, md)
    tiles[:, :, 1] = pdf.reshape(ntile, md)
    tiles[:, :, 2] = ns.reshape(ntile, md)
    tg = TileGraph(
        md=md,
        tile_ptr=tile_ptr.astype(np.int32),
        tiles=tiles,
        pad2orig=pad2orig,
        frm_pad=frm_pad,
    )
    graph._tile_graph = tg
    log.info(
        "tiles(md=%d): %d states / %d arcs -> %d tiles (%.0f%% pad)",
        md, graph.num_states, graph.num_arcs, ntile,
        100.0 * (ap - graph.num_arcs) / max(1, ap),
    )
    return tg


def fst_to_csr_native(nfst, tid_to_pdf: np.ndarray) -> CsrGraph:
    """CsrGraph of a native FST handle (fst/native.py NativeFst): its
    eps-forwarded CSR export, with each arc's pdf looked up from its tid."""
    (start, row_ptr, tid, weight, nextstate, final_weight, olab_off,
     olab_val, folab_off, folab_val) = nfst.to_csr_arrays()
    csr = CsrGraph(
        start=start,
        row_ptr=row_ptr,
        tid=tid,
        pdf=tid_to_pdf[tid].astype(np.int32) if len(tid) else tid.copy(),
        weight=weight,
        nextstate=nextstate,
        final_weight=np.where(np.isfinite(final_weight), final_weight,
                              np.inf).astype(np.float32),
        arc_olabels=FlatOlabels(olab_off, olab_val),
        final_olabels=FlatOlabels(folab_off, folab_val),
    )
    csr._olabel_mask = olab_off[1:] > olab_off[:-1]
    return csr


def _eps_closure(fst, s: int) -> List[Tuple[int, float, Tuple[int, ...]]]:
    """Dijkstra over the eps-input arcs from s: [(state, weight, olabels)],
    the least weight of each reachable state, its olabels those of the
    argmin path."""
    dist: Dict[int, float] = {s: 0.0}
    lab: Dict[int, Tuple[int, ...]] = {s: ()}
    heap: List[Tuple[float, int]] = [(0.0, s)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u] + 1e-12:
            continue
        for a in fst.arcs[u]:
            if a.ilabel != EPS:
                continue
            nd = d + a.weight
            if nd < dist.get(a.nextstate, INF) - 1e-12:
                dist[a.nextstate] = nd
                lab[a.nextstate] = lab[u] + ((a.olabel,) if a.olabel != EPS else ())
                heapq.heappush(heap, (nd, a.nextstate))
    return [(u, dist[u], lab[u]) for u in dist]


def fst_to_csr(fst, tid_to_pdf: np.ndarray) -> CsrGraph:
    """The folded CsrGraph of a VectorFst (input labels tids, 0 = eps), in
    host Python: each state's eps closure by Dijkstra in float64, each
    emitting arc reached through it kept once per (tid, destination) at its
    least weight, arcs in (tid, destination) order.  The JAX package's
    `fst_to_csr`, array for array; `decoder/graph.read_hclg_csr` gives the
    same arrays from the native export (tests/test_torch_fst_context.py)."""
    if fst.start < 0:
        raise KaldiError("fst has no start state")
    S = fst.num_states
    rows = []
    final_weight = np.full(S, np.inf, dtype=np.float32)
    final_olabels: List[Tuple[int, ...]] = [()] * S
    for s in range(S):
        arcs_out: Dict[Tuple[int, int], Tuple[float, Tuple[int, ...]]] = {}
        best_final, best_final_lab = INF, ()
        for u, w_eps, olab in _eps_closure(fst, s):
            if fst.finals[u] != INF and w_eps + fst.finals[u] < best_final:
                best_final, best_final_lab = w_eps + fst.finals[u], olab
            for a in fst.arcs[u]:
                if a.ilabel == EPS:
                    continue
                w = w_eps + a.weight
                key = (a.ilabel, a.nextstate)
                if key not in arcs_out or w < arcs_out[key][0]:
                    arcs_out[key] = (w, olab + ((a.olabel,) if a.olabel != EPS else ()))
        rows.append(sorted(arcs_out.items()))
        if best_final != INF:
            final_weight[s] = best_final
            final_olabels[s] = best_final_lab
    row_ptr = np.zeros(S + 1, dtype=np.int32)
    np.cumsum([len(r) for r in rows], out=row_ptr[1:])
    flat = [item for r in rows for item in r]
    A = len(flat)
    tid = np.fromiter((il for (il, _), _ in flat), np.int32, A)
    nextstate = np.fromiter((ns for (_, ns), _ in flat), np.int32, A)
    weight = np.fromiter((w for _, (w, _) in flat), np.float32, A)
    csr = CsrGraph(start=fst.start, row_ptr=row_ptr, tid=tid,
                   pdf=np.asarray(tid_to_pdf, np.int64)[tid].astype(np.int32),
                   weight=weight, nextstate=nextstate, final_weight=final_weight,
                   arc_olabels=[labs for _, (_, labs) in flat],
                   final_olabels=final_olabels)
    log.debug("csr: %d states, %d arcs", csr.num_states, csr.num_arcs)
    return csr


def fst_to_split_csr_arrays(start: int, row_ptr: np.ndarray, il: np.ndarray,
                            ol: np.ndarray, w: np.ndarray, ns: np.ndarray,
                            finals: np.ndarray, tid_to_pdf: np.ndarray,
                            max_depth: int = 8) -> CsrGraph:
    """A SPLIT-eps CsrGraph from raw FST arrays (il 0 = eps), the JAX
    package's export array for array.

    Every state must have at most one eps out-arc and the eps chains must
    be acyclic and at most max_depth deep (the LM-backoff shape: trigram
    state → bigram → unigram); otherwise KaldiError.  The emitting arcs
    stay un-duplicated, and each state's final weight is folded over its
    eps chain (the best of at most depth + 1 prefixes), with the chain's
    words as its final output labels."""
    S = len(row_ptr) - 1
    src = np.repeat(np.arange(S, dtype=np.int64), np.diff(row_ptr))
    eps = il == 0
    eps_out = np.bincount(src[eps], minlength=S)
    if eps_out.max(initial=0) > 1:
        raise KaldiError(f"split-eps export needs <=1 eps out-arc per state "
                         f"(max {int(eps_out.max())})")
    eps_ns = np.full(S, -1, np.int32)
    eps_w = np.full(S, np.float32(1e10), np.float32)
    eps_olab = np.zeros(S, np.int32)
    es = src[eps]
    eps_ns[es], eps_w[es], eps_olab[es] = ns[eps], w[eps], ol[eps]
    depth = 0
    cur = eps_ns.astype(np.int64)
    while (cur >= 0).any():
        depth += 1
        if depth > max_depth:
            raise KaldiError(f"eps chains deeper than {max_depth} (cycle?)")
        m = cur >= 0
        nxt = np.full(S, -1, np.int64)
        nxt[m] = eps_ns[cur[m]]
        cur = nxt
    keep = ~eps
    order = np.argsort(src[keep], kind="stable")
    e_src = src[keep][order]
    e_il = il[keep].astype(np.int32)[order]
    e_ol = ol[keep].astype(np.int32)[order]
    e_w = w[keep].astype(np.float32)[order]
    e_ns = ns[keep].astype(np.int32)[order]
    new_rp = np.zeros(S + 1, np.int64)
    np.cumsum(np.bincount(e_src, minlength=S), out=new_rp[1:])
    has = e_ol != 0
    olab_off = np.zeros(len(e_il) + 1, np.int64)
    np.cumsum(has.astype(np.int64), out=olab_off[1:])
    # final weights folded over the eps chain: an argmin over its prefixes
    fin = np.where(np.isfinite(finals), finals, np.inf).astype(np.float64)
    cand = np.full((depth + 1, S), np.inf)
    cand[0] = fin
    cum = np.zeros(S)
    u = np.arange(S, dtype=np.int64)
    alive = np.ones(S, bool)
    for k in range(1, depth + 1):
        alive = alive & (eps_ns[np.maximum(u, 0)] >= 0) & (u >= 0)
        cum = cum + np.where(alive, eps_w[np.maximum(u, 0)], np.inf)
        u = np.where(alive, eps_ns[np.maximum(u, 0)], -1)
        cand[k] = np.where(alive, cum + fin[np.maximum(u, 0)], np.inf)
    best_k = np.argmin(cand, axis=0)
    fw_folded = cand[best_k, np.arange(S)]
    folab: Dict[int, List[int]] = {}
    for s in np.nonzero((best_k > 0) & np.isfinite(fw_folded))[0].tolist():
        labs, u2 = [], s
        for _ in range(int(best_k[s])):
            if eps_olab[u2]:
                labs.append(int(eps_olab[u2]))
            u2 = int(eps_ns[u2])
        if labs:
            folab[s] = labs
    folab_off = np.zeros(S + 1, np.int64)
    for s, labs in folab.items():
        folab_off[s + 1] = len(labs)
    np.cumsum(folab_off, out=folab_off)
    folab_val = np.asarray([x for s in sorted(folab) for x in folab[s]], np.int32)
    csr = CsrGraph(
        start=int(start), row_ptr=new_rp.astype(np.int32), tid=e_il,
        pdf=tid_to_pdf[e_il].astype(np.int32) if len(e_il) else e_il.copy(),
        weight=e_w, nextstate=e_ns,
        final_weight=np.where(np.isfinite(fw_folded), fw_folded, np.inf).astype(np.float32),
        arc_olabels=FlatOlabels(olab_off.astype(np.int32), e_ol[has]),
        final_olabels=FlatOlabels(folab_off.astype(np.int32), folab_val),
        eps_ns=eps_ns, eps_w=eps_w, eps_olab=eps_olab, eps_depth=depth)
    csr._olabel_mask = has
    log.info("csr(split-eps): %d states, %d emit arcs + %d backoff arcs (depth %d, "
             "max emit out-degree %d)", S, csr.num_arcs, int((eps_ns >= 0).sum()),
             depth, int(csr.out_degree().max(initial=0)))
    return csr
