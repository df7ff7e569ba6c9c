"""Batched token-sparse Viterbi beam search on a shared decoding graph.

Counterpart of the token-sparse path of old_kaldi_git_tpu/decoder/viterbi.py
(`decode_batch_tokens` → `_decode_scan_tokens` → `_backtrace_scan` →
`results_from_arcs`; reference: LatticeFasterDecoder's ProcessEmitting over a
shared HCLG).  Per frame, for a whole utterance batch:

  tokens [B, K] (state id, cost), cost-sorted, slot 0 = best
  → TILE expansion of the K states into a static budget of ET per-state arc
    tiles (csr.build_tile_graph: MD arcs per tile; tiles beyond ET are
    dropped from the WORST tokens)
  → E = ET·MD candidate (dest, cost, arc) triples; the per-arc loglike lookup
    goes through the hand-written gather kernel (ops/gather_kernel.py)
  → stable sort by (dest, cost): the first entry of each dest run is its
    Viterbi min (the ε-free dedup)
  → stable sort by cost, first K, beam gate → next token set.

Split-eps graphs (the chain HCLG: emitting arcs plus at most one backoff
eps arc a state) seed the start state's eps closure and, after each frame's
top-K, let every kept token add its <= D hop states in one (1+D)K-wide merge
(`_hop_merge`); the host walks the backoff chains for their words
(`split_words_for_arc_seq`).  With `want_lattice=True` every frame also
emits bounded lattice-arc records on the device (on split graphs after
extending every candidate by its hops), compacted on the device to the live
rows before they reach the host (`TokenLattice`).

The frame loop is a Python loop over torch ops on the device; backpointers
stay on the device and only [T, B] winning-arc ids come to the host.

`decode_batch` is the entry point of every graph size: it picks one of three
regimes with the JAX package's thresholds (`decode_regime`).  Huge graphs
take the token-sparse search above; graphs whose [B, S] cost vector fits take
`_decode_and_backtrace`, a dense relaxation of every arc per frame:

  cand [B, A] = alpha[:, frm] + w − acoustic_scale·ll_t[:, pdf]
  → scatter-min into the next states, winning arc by scatter-max of arc ids
  → dense mode (K = S): beam gate only, [T, B, S] winning arcs stored;
    top-K mode (K < S): the K best states by (cost, state id), beam gate,
    [T, B, K] kept states and their winning arcs stored.

Its lattice mode (`_decode_scan`, K = min(max_active, S)) also keeps every
frame's kept states and costs for lat.lattice_from_decode.  `decode_batch`
takes folded graphs; split graphs decode through `decode_batch_tokens`.

`align_batch` is forced alignment (reference gmm-align-compiled): each
utterance against its own small training graph, the dense relaxation over
padded [B, A] arcs with all three per-arc lookups through the gather kernel,
and the backtrace on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph, build_tile_graph
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.ops.gather_kernel import batched_table_gather
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass
from old_kaldi_git_tpu_torch.utils.timing import StageClock

log = get_logger("viterbi")

BIG = 1e10  # pseudo-infinity that survives float32 arithmetic
TOKENS_ABOVE_BYTES = 2_000_000_000  # [B, S] float32 cost vector above this
DENSE_UP_TO_BYTES = 4_000_000_000  # [T, B, S] int32 winning-arc store up to this


@options_dataclass
class ViterbiOptions:
    beam: float = 16.0
    max_active: int = 7000
    acoustic_scale: float = 0.1


@dataclasses.dataclass
class TokenLattice:
    """Bounded per-utterance lattice-arc records of the token-sparse
    decoder (emitted on the device; see _decode_scan_tokens with L > 0).
    Slot ids refer to each frame's top-K token set; src slots at t=0 refer
    to the initial token set (slot 0 = start state)."""

    src_slot: np.ndarray  # [T, L] int32, -1 = empty record
    dst_slot: np.ndarray  # [T, L] int32
    arc: np.ndarray       # [T, L] int32 graph arc ids
    ac: np.ndarray        # [T, L] float32 unscaled acoustic costs
    final_states: np.ndarray  # [K] last-frame token state ids (-1 dead)
    final_costs: np.ndarray   # [K] their forward costs
    # post-hop destination state per record (-1 = empty); split-eps
    # lattices walk arc-target -> dst_state for backoff words/weights
    dst_state: Optional[np.ndarray] = None  # [T, L] int32


@dataclasses.dataclass
class DecodeResult:
    words: List[int]
    alignment: np.ndarray  # tids, [T]
    cost: float
    # per-frame surviving tokens of decode_batch's lattice mode: [T, K]
    # state ids (-1 = dead) and their forward costs
    frame_states: Optional[np.ndarray] = None
    frame_costs: Optional[np.ndarray] = None
    # bounded device-emitted lattice arcs (token-sparse lattice mode)
    token_lattice: Optional[TokenLattice] = None


def _token_budget(graph: CsrGraph, K: int, md: int = 4) -> int:
    """Static TILE-expansion budget ET: a 1.25x multiple of the expected
    active tiles-per-state (headroom for degree skew; overflow drops tiles
    from the worst-cost tokens only — they are cost-sorted), capped at the
    tile count, rounded up to a multiple of 128.  Per-frame cost is linear in
    E = ET·MD, so the budget is the main throughput knob after K."""
    tg = build_tile_graph(graph, md)
    NT = tg.num_tiles
    mean_tiles = max(1.0, NT / max(1, graph.num_states))
    ET = int(min(NT, max(1.25 * K * mean_tiles, 1.25 * K)))
    return max(128, (ET + 127) // 128 * 128)


def _dest_cost_key(dest: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """One int64 sort key per candidate, ordered as the pair (dest, cost):
    dest in the high 32 bits, an order-preserving map of the float32 cost in
    the low 32.  Costs can be negative (pseudo-loglikes may be positive), so
    the map handles both signs: a non-negative float orders as its bits, a
    negative one in reverse of them."""
    bits = cost.contiguous().view(torch.int32).long()
    ordered = torch.where(bits < 0, -(2 ** 31) - 1 - bits, bits) + 2 ** 31
    return (dest.long() << 32) | ordered


def _hop_merge(new_state: torch.Tensor, new_cost: torch.Tensor,
               new_arc: torch.Tensor, eps_hops: torch.Tensor, S: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SPLIT-EPS backoff hops (reference ProcessNonemitting for
    backoff-shaped graphs): each of the K selected tokens contributes its
    <= D precomputed eps-closure states (eps_hops[s, k] = (cumulative weight
    bits, k+1-hop dest), BIG on missing hops) as extra candidates carrying
    the same winning emit arc; one (1+D)K-wide dedup on (dest, cost) keeps
    the min per dest and a 1-key sort the K best.  Exact for chains up to
    depth D in one round.  The candidates are concatenated kept tokens
    first, then hops in [B, K, D] row-major order, and both sorts are
    stable, so ties resolve as the JAX package's concatenation order does."""
    B, K = new_state.shape
    D = eps_hops.shape[1]
    s1 = torch.where(new_cost < BIG, new_state, S)
    hop = eps_hops[s1.clamp(0, eps_hops.shape[0] - 1).long()]  # [B, K, D, 2]
    h_w = hop[..., 0].view(torch.float32)
    ok = (s1[:, :, None] < S) & (h_w < BIG)
    h_cost = torch.where(ok, (new_cost[:, :, None] + h_w).clamp(max=BIG), BIG)
    h_state = torch.where(ok, hop[..., 1], S)
    cs = torch.cat([s1, h_state.reshape(B, K * D)], dim=1)
    cc = torch.cat([new_cost, h_cost.reshape(B, K * D)], dim=1)
    ca = torch.cat([new_arc, new_arc[:, :, None].expand(B, K, D).reshape(B, K * D)],
                   dim=1)
    key, order = torch.sort(_dest_cost_key(cs, cc), dim=1, stable=True)
    ds2 = (key >> 32).to(torch.int32)
    cc2 = cc.gather(1, order)
    first = torch.ones_like(ds2, dtype=torch.bool)
    first[:, 1:] = ds2[:, 1:] != ds2[:, :-1]
    cand = torch.where(first & (ds2 < S), cc2, BIG)
    cost, sel = torch.sort(cand, dim=1, stable=True)
    sel = sel[:, :K]
    return ds2.gather(1, sel), cost[:, :K], ca.gather(1, order).gather(1, sel)


def _decode_scan_tokens(
    tile_ptr: torch.Tensor, tiles: torch.Tensor, start: int,
    loglikes: torch.Tensor, num_frames: torch.Tensor,
    acoustic_scale: float, beam: float, K: int, ET: int, S: int,
    L: int = 0, lattice_beam: float = 0.0,
    init_tokens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    eps_hops: Optional[torch.Tensor] = None, D: int = 0,
    bp_out: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           Optional[Tuple[torch.Tensor, ...]]]:
    """Token-sparse beam decode of folded (D = 0) or split-eps (D > 0,
    `eps_hops` the [S, D, 2] hop table) graphs.

    Returns (tok_state [B, K] int32, tok_cost [B, K] float32,
    bp_state [T, B, K] int32, bp_arc [T, B, K] int32, records).  Arc ids are
    PADDED tile-slot ids (tile*MD + lane); callers map them back to graph
    arcs via TileGraph.pad2orig.  The backpointer stores are allocated once
    and written per frame; frames past every utterance's end are not run.
    `init_tokens` (state [B, K] int32, cost [B, K] float32) replaces the
    start-state seed: a split graph's start closure, or a carried token set.
    `bp_out` (bp_state [rows, B, K], bp_arc [rows, B, K], t0): write the
    backpointers in place into rows t0 .. t0+T−1 of these stores (a
    streaming decoder's preallocated buffers) instead of new ones; the
    returned backpointers are then those rows.

    L > 0 also emits per-frame LATTICE-ARC RECORDS (GetRawLattice on the
    device): every expanded candidate whose via-cost is within
    `lattice_beam` of its destination's frame winner AND whose destination
    survived the top-K prune is a raw-lattice arc; the L best by via-cost
    per (utterance, frame) are kept.  `records` is then (src_slot, dst_slot,
    arc, ac, dst_state), each [t_end, B, L] (int32; ac float32, the unscaled
    acoustic cost), -1 / 0.0 on empty records; t_end is the longest
    utterance, since no later frame emits a record.  On a split graph the
    lattice mode extends EVERY emit candidate by its hops before selection
    (at (1+D)x sort width), so records can name post-hop destinations; the
    two-stage hop merge runs only without records."""
    B, T, P = loglikes.shape
    NT, MD, _ = tiles.shape
    E = ET * MD
    Ew = E * (1 + D) if L and D else E
    C = 4 if L else 3
    dev = loglikes.device
    j = torch.arange(ET, dtype=torch.int64, device=dev)
    lane = torch.arange(MD, dtype=torch.int32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    k_ids = torch.arange(K, dtype=torch.int64, device=dev).expand(B, K)
    w_ids = torch.arange(Ew, dtype=torch.int64, device=dev)

    if init_tokens is None:
        tok_state = torch.full((B, K), -1, dtype=torch.int32, device=dev)
        tok_state[:, 0] = start
        tok_cost = torch.full((B, K), BIG, dtype=torch.float32, device=dev)
        tok_cost[:, 0] = 0.0
    else:
        tok_state, tok_cost = init_tokens
    if bp_out is None:
        bp_state = torch.full((T, B, K), -1, dtype=torch.int32, device=dev)
        bp_arc = torch.full((T, B, K), -1, dtype=torch.int32, device=dev)
    else:
        bp_state, bp_arc = (x.narrow(0, bp_out[2], T) for x in bp_out[:2])
    t_end = min(T, int(num_frames.max().item())) if B else 0
    records = None
    if L:
        records = tuple(
            torch.full((t_end, B, L), fill, dtype=dtype, device=dev)
            for fill, dtype in ((-1, torch.int32), (-1, torch.int32),
                                (-1, torch.int32), (0.0, torch.float32),
                                (-1, torch.int32)))

    def expand_md(x):
        """[B, ET] per-tile value → [B, E] per-arc value (lane repeat)."""
        return x[:, :, None].expand(B, ET, MD).reshape(B, E)

    def with_hops(x):
        """[B, E] per-candidate value → [B, E·D], repeated for each hop."""
        return x[:, :, None].expand(B, E, D).reshape(B, E * D)

    def deltas(vals):
        return torch.diff(vals, dim=1, prepend=zero_col)

    for t in range(t_end):
        live = (tok_state >= 0) & (tok_cost < BIG)
        s_cl = tok_state.clamp(min=0).long()
        rp = tile_ptr[s_cl].long()  # [B, K]
        deg = torch.where(live, tile_ptr[s_cl + 1].long() - rp, 0)
        cum = torch.cumsum(deg, dim=1)  # [B, K] inclusive run ends
        prev = cum - deg  # run starts
        # ALL per-token run quantities ride ONE stacked scatter-add of deltas
        # at run starts + one cumsum:
        #   ch0: run-end bound cum_of (deltas of cum; colliding empty-run
        #        starts telescope, so the cumsum is the value of the LAST run
        #        start <= j — which also masks slots whose owner's run was
        #        truncated by the budget)
        #   ch1: tile-id base (deltas of rp - prev)
        #   ch2: token cost base (deltas of the cost BITS, carried as
        #        integers: exact for arbitrary values, no float arithmetic
        #        ever touches them)
        #   ch3 (records only): the owning token's slot k_of (deltas of k)
        # Sums are taken in int64, where nothing wraps.  Run starts >= ET
        # must DROP, not clamp onto the last slot: they go to a spare slot
        # ET that is cut off before the cumsum.
        chans = [deltas(cum), deltas(rp - prev),
                 deltas(tok_cost.view(torch.int32).long())]
        if L:
            chans.append(deltas(k_ids))
        stacked = torch.stack(chans, dim=1)
        # channels first, [B, C, ET]: the cumsum then runs along the
        # contiguous dim (a scan along a strided dim is several times slower)
        scat = torch.zeros((B, C, ET + 1), dtype=torch.int64, device=dev)
        scat.scatter_add_(
            2, prev.clamp(max=ET)[:, None, :].expand(B, C, K), stacked)
        bases = torch.cumsum(scat[:, :, :ET], dim=2)  # [B, C, ET]
        valid = j[None, :] < bases[:, 0]
        tile = (bases[:, 1] + j[None, :]).clamp(0, NT - 1)
        base_cost = bases[:, 2].to(torch.int32).view(torch.float32)
        # THE arc-data access: one [MD, 3] int32 tile per slot; the weight
        # column is reinterpreted, never converted
        rows = tiles[tile]  # [B, ET, MD, 3]
        w_arc = rows[..., 0].reshape(B, E).view(torch.float32)
        pdf_arc = rows[..., 1].reshape(B, E)
        ns_arc = rows[..., 2].reshape(B, E)
        arc = ((tile.to(torch.int32) * MD)[:, :, None] + lane).reshape(B, E)
        base_cost = expand_md(base_cost)
        valid = expand_md(valid)
        # the frame's [B, P] rows are read in place, through their stride
        ll_arc = batched_table_gather(loglikes[:, t], pdf_arc.clamp(max=P - 1))
        # tile-padding arcs carry w=BIG; a positive acoustic term could drag
        # their cost just under BIG, so they are masked like budget-invalid
        # slots, not merely cost-gated
        valid = valid & (w_arc < BIG)
        cost = base_cost + w_arc - acoustic_scale * ll_arc
        dest = torch.where(valid, ns_arc, S)  # sentinel sorts last
        cost = torch.where(valid, cost.clamp(max=BIG), BIG)
        if L:
            k_of = expand_md(bases[:, 3])
        if L and D:
            # split-eps lattice mode: every emit candidate also reaches its
            # <= D hop states, at the same arc, before any selection
            hop = eps_hops[dest.clamp(0, eps_hops.shape[0] - 1).long()]  # [B, E, D, 2]
            h_w = hop[..., 0].view(torch.float32)
            ok = (dest[:, :, None] < S) & (h_w < BIG) & (cost[:, :, None] < BIG)
            h_cost = torch.where(ok, (cost[:, :, None] + h_w).clamp(max=BIG), BIG)
            h_state = torch.where(ok, hop[..., 1], S)
            dest = torch.cat([dest, h_state.reshape(B, E * D)], dim=1)
            cost = torch.cat([cost, h_cost.reshape(B, E * D)], dim=1)
            arc, k_of, ll_arc = (torch.cat([x, with_hops(x)], dim=1)
                                 for x in (arc, k_of, ll_arc))
        # dedup: stable sort on (dest, cost); ties keep expansion order
        key_s, order = torch.sort(_dest_cost_key(dest, cost), dim=1, stable=True)
        dest_s = (key_s >> 32).to(torch.int32)
        cost_s = cost.gather(1, order)
        arc_s = arc.gather(1, order)
        first = torch.ones((B, Ew), dtype=torch.bool, device=dev)
        first[:, 1:] = dest_s[:, 1:] != dest_s[:, :-1]
        cand = torch.where(first & (dest_s < S), cost_s, BIG)
        # top-K: stable sort by cost, first K
        new_cost, sel = torch.sort(cand, dim=1, stable=True)
        new_cost, sel = new_cost[:, :K], sel[:, :K]
        new_state = dest_s.gather(1, sel)
        new_arc = arc_s.gather(1, sel)
        if D and not L:
            new_state, new_cost, new_arc = _hop_merge(
                new_state, new_cost, new_arc, eps_hops, S)
        # keep requires a REAL candidate: when a frame has zero valid
        # expansions everything is BIG and the sentinel dest S would
        # otherwise survive the beam gate (BIG <= BIG + beam)
        keep = ((new_cost <= new_cost[:, :1] + beam) & (new_cost < BIG)
                & (new_state < S))
        new_cost = torch.where(keep, new_cost, BIG)
        new_state = torch.where(keep, new_state, -1)
        new_arc = torch.where(keep, new_arc, -1)
        active = (t < num_frames)[:, None]
        tok_state = torch.where(active, new_state, tok_state)
        tok_cost = torch.where(active, new_cost, tok_cost)
        bp_state[t] = torch.where(active, new_state, -1)
        bp_arc[t] = torch.where(active, new_arc, -1)
        if not L:
            continue
        # ---- bounded lattice-arc emission ----
        # the winner of each sorted dest run sits at the run's first slot
        run_start = torch.cummax(torch.where(first, w_ids, 0), dim=1).values
        winner = cost_s.gather(1, run_start)
        # surviving-token slot of each dest: the kept slot index scattered
        # at its winner's sorted position (the selected positions are
        # distinct), -1 elsewhere
        slot_of = torch.full((B, Ew), -1, dtype=torch.int64, device=dev)
        slot_of.scatter_reduce_(1, sel, torch.where(keep, k_ids, -1), "amax",
                                include_self=True)
        dst_slot = slot_of.gather(1, run_start)
        flag = ((dest_s < S) & (cost_s < BIG) & (dst_slot >= 0)
                & (cost_s <= winner + lattice_beam) & active)
        score = torch.where(flag, cost_s, BIG)
        # the L best records: a stable sort keeps equal scores in index
        # order, as lax.top_k returns them
        score, pick = torch.sort(score, dim=1, stable=True)
        ok = score[:, :L] < BIG
        pick = pick[:, :L]
        kof_s, ll_s = k_of.gather(1, order), ll_arc.gather(1, order)
        for store, x, fill in zip(
                records,
                (kof_s, dst_slot, arc_s, -ll_s, dest_s),
                (-1, -1, -1, 0.0, -1)):
            store[t] = torch.where(ok, x.gather(1, pick), fill)
    return tok_state, tok_cost, bp_state, bp_arc, records


def _backtrace_scan(bp_state: torch.Tensor, bp_arc: torch.Tensor,
                    frm: torch.Tensor, end_state: torch.Tensor,
                    num_frames: torch.Tensor) -> torch.Tensor:
    """On-device backtrace: walk the winning-arc chain backwards for every
    utterance at once, so only [T, B] arc ids go to the host instead of the
    [T, B, K] backpointer tensors.  -1 on inactive/failed frames."""
    T, B, _ = bp_state.shape
    arcs = torch.full((T, B), -1, dtype=torch.int32, device=bp_state.device)
    state = end_state
    t_end = min(T, int(num_frames.max().item())) if B else 0
    for t in range(t_end - 1, -1, -1):
        match = bp_state[t] == state[:, None]
        slot = match.to(torch.int32).argmax(dim=1, keepdim=True)
        found = match.gather(1, slot)[:, 0]
        arc = bp_arc[t].gather(1, slot)[:, 0]
        active = (t < num_frames) & found & (arc >= 0)
        arcs[t] = torch.where(active, arc, -1)
        state = torch.where(active, frm[arc.clamp(min=0).long()], state)
    return arcs


def _eps_hop_table_host(graph: CsrGraph) -> Tuple[np.ndarray, int]:
    """([S, D, 2] int32 (cumulative-weight bits, k+1-hop destination), D)
    for a split-eps graph's backoff chains; BIG weight on missing hops.
    The weights are summed in float64 and cast to float32 once, as the JAX
    package sums them.  Cached on the graph."""
    cached = getattr(graph, "_eps_hops_host", None)
    if cached is not None:
        return cached
    S = graph.num_states
    D = max(1, int(graph.eps_depth))
    eps_ns = graph.eps_ns
    eps_w = graph.eps_w.astype(np.float64)
    hops = np.zeros((S, D, 2), np.int32)
    u = eps_ns.astype(np.int64)
    cum = np.where(u >= 0, eps_w, BIG)
    for k in range(D):
        valid = u >= 0
        wcol = np.where(valid, np.minimum(cum, BIG), BIG).astype(np.float32)
        hops[:, k, 0] = wcol.view(np.int32)
        hops[:, k, 1] = np.where(valid, u, 0)
        nxt = np.where(valid, eps_ns[np.maximum(u, 0)], -1)
        cum = np.where(
            nxt >= 0, cum + np.where(valid, eps_w[np.maximum(u, 0)], BIG), BIG)
        u = nxt
    graph._eps_hops_host = (hops, D)
    return graph._eps_hops_host


def _eps_hop_table(graph: CsrGraph, device: torch.device) -> Tuple[torch.Tensor, int]:
    """The hop table on `device`, uploaded once per device and kept."""
    cache = graph.__dict__.setdefault("_eps_hops_dev", {})
    key = str(device)
    if key not in cache:
        hops, D = _eps_hop_table_host(graph)
        cache[key] = (torch.from_numpy(hops).to(device), D)
    return cache[key]


def start_closure(graph: CsrGraph, D: int) -> List[Tuple[int, float]]:
    """The start state's eps closure on a split graph: (state, cost) of the
    start state and of up to D backoff hops from it, costs summed in float64
    (the decoder's hop merge runs only after a frame's expansion, so these
    seed the initial token set)."""
    seeds = [(graph.start, 0.0)]
    u, c = graph.start, 0.0
    while graph.eps_ns[u] >= 0 and len(seeds) <= D:
        c += float(graph.eps_w[u])
        u = int(graph.eps_ns[u])
        seeds.append((u, c))
    return seeds


def eps_walk(graph: CsrGraph, u: int, v: int) -> Optional[Tuple[List[int], float]]:
    """(word labels, total weight) along the (unique) backoff chain
    u -> v; None if v is not reachable within eps_depth hops
    (decoder/host inconsistency)."""
    words: List[int] = []
    w = 0.0
    for _ in range(graph.eps_depth + 1):
        if u == v:
            return words, w
        nxt = int(graph.eps_ns[u])
        if nxt < 0:
            return None
        if graph.eps_olab[u]:
            words.append(int(graph.eps_olab[u]))
        w += float(graph.eps_w[u])
        u = nxt
    return (words, w) if u == v else None


def _arc_src(graph: CsrGraph) -> np.ndarray:
    """arc id → source state (cached per graph)."""
    frm = getattr(graph, "_arc_src_cache", None)
    if frm is None or len(frm) != graph.num_arcs:
        frm = np.repeat(np.arange(graph.num_states, dtype=np.int64),
                        graph.out_degree().astype(np.int64))
        graph._arc_src_cache = frm
    return frm


def split_words_for_arc_seq(graph: CsrGraph, arc_seq: np.ndarray,
                            end_state: int) -> Optional[List[int]]:
    """Word labels for a split-eps winning EMIT-arc chain ending at
    end_state: emit-arc olabels plus the backoff words recovered by walking
    the unique eps chain between each arc's target and the next arc's
    source (the decoder records only the emit arc and the post-hop token
    state).  None if a hop walk fails (decoder/host inconsistency)."""
    frm = _arc_src(graph)
    nf = len(arc_seq)
    words: List[int] = []
    pre = eps_walk(graph, graph.start, int(frm[arc_seq[0]]))
    if pre is None:
        return None
    words.extend(pre[0])
    for t in range(nf):
        a = int(arc_seq[t])
        words.extend(graph.arc_olabels[a])
        tgt = int(frm[arc_seq[t + 1]]) if t + 1 < nf else int(end_state)
        hop = eps_walk(graph, int(graph.nextstate[a]), tgt)
        if hop is None:
            return None
        words.extend(hop[0])
    return words


def _results_from_arcs_split(
    graph: CsrGraph,
    arcs: np.ndarray,  # [T, B] winning EMIT arc ids (-1 = dead frame)
    end_states: np.ndarray,
    use_final: np.ndarray,
    costs: np.ndarray,
    num_frames: np.ndarray,
) -> List[Optional[DecodeResult]]:
    """Host tail of split-eps decodes: as results_from_arcs, but the words
    on backoff arcs are recovered by split_words_for_arc_seq."""
    results: List[Optional[DecodeResult]] = []
    for b in range(arcs.shape[1]):
        nf_b = int(num_frames[b])
        if costs[b] >= BIG:
            results.append(None)
            continue
        arc_seq = arcs[:nf_b, b]
        if (arc_seq < 0).any():
            results.append(None)
            continue
        if nf_b == 0:  # zero-frame (batch-padding) rows: empty result
            results.append(DecodeResult(words=[], alignment=np.zeros(0, np.int32),
                                        cost=float(costs[b])))
            continue
        words = split_words_for_arc_seq(graph, arc_seq, int(end_states[b]))
        if words is None:
            log.warning("split-eps backtrace walk failed for utt %d", b)
            results.append(None)
            continue
        if use_final[b]:
            words.extend(graph.final_olabels[int(end_states[b])])
        results.append(DecodeResult(words=words,
                                    alignment=graph.tid[arc_seq].astype(np.int32),
                                    cost=float(costs[b])))
    return results


def _compact_lat_records(records: Tuple[torch.Tensor, ...], R: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact the [T, B, L] record tensors to the live records only, ON
    THE DEVICE, before anything crosses to the host (a few percent of the
    slots are live).  Returns (packed [B, R, 6] int32: (t, src_slot,
    dst_slot, arc, ac_bits, dst_state) rows in (t, slot) order, -1 rows
    after them; counts [B]).  Records beyond R are dropped: counts[b] > R
    tells the host to fetch that utterance's full columns instead.  Padding
    frames hold no records (the emission is masked by `t < num_frames`), so
    they count nothing."""
    src, dst, arc, ac, ds = records
    T, B, L = arc.shape

    def flat(x):
        return x.transpose(0, 1).reshape(B, T * L)

    v = flat(arc >= 0)
    pos = torch.cumsum(v, dim=1, dtype=torch.int64) - 1
    pos = torch.where(v & (pos < R), pos, R)  # parked row R is sliced off
    t_of = torch.arange(T, dtype=torch.int32, device=arc.device)[:, None, None]
    stacked = torch.stack(
        [flat(t_of.expand(T, B, L)), flat(src), flat(dst), flat(arc),
         flat(ac.view(torch.int32)), flat(ds)], dim=-1)  # [B, T*L, 6]
    out = torch.full((B, R + 1, 6), -1, dtype=torch.int32, device=arc.device)
    out.scatter_(1, pos[:, :, None].expand(B, T * L, 6), stacked)
    return out[:, :R], v.sum(dim=1)


def _token_lattice_from_packed(rows: np.ndarray, nf_b: int, pad2orig: np.ndarray,
                               tok_state: np.ndarray, tok_cost: np.ndarray
                               ) -> Optional["TokenLattice"]:
    """Host side of the compacted records: regroup the flat (t, slot)-ordered
    rows into the per-frame [T, L'] arrays of a TokenLattice (L' = that
    utterance's most records in any frame)."""
    rows = rows[rows[:, 0] < nf_b]
    t = rows[:, 0]
    if nf_b <= 0:
        return None
    per_frame = np.bincount(t, minlength=nf_b)
    Lb = max(1, int(per_frame.max()) if per_frame.size else 1)
    src = np.full((nf_b, Lb), -1, np.int32)
    dst = np.full((nf_b, Lb), -1, np.int32)
    arc = np.full((nf_b, Lb), -1, np.int32)
    ac = np.zeros((nf_b, Lb), np.float32)
    ds = np.full((nf_b, Lb), -1, np.int32)
    starts = np.zeros(nf_b + 1, np.int64)
    np.cumsum(per_frame, out=starts[1:])
    col = np.arange(len(rows), dtype=np.int64) - starts[t]
    src[t, col] = rows[:, 1]
    dst[t, col] = rows[:, 2]
    a = rows[:, 3]
    arc[t, col] = np.where(a >= 0, pad2orig[np.maximum(a, 0)], -1)
    ac[t, col] = np.ascontiguousarray(rows[:, 4]).view(np.float32)
    ds[t, col] = rows[:, 5]
    return TokenLattice(src, dst, arc, ac, tok_state, tok_cost, ds)


def decode_batch_tokens(
    graph: CsrGraph,
    loglikes: Union[np.ndarray, torch.Tensor],
    num_frames: Sequence[int],
    opts: Optional[ViterbiOptions] = None,
    want_lattice: bool = False,
    lattice_beam: float = 10.0,
    lattice_budget: int = 0,
    device: DeviceLike = None,
    timings: Optional[Dict[str, float]] = None,
) -> List[Optional[DecodeResult]]:
    """Beam-decode a batch [B, T, P] of pseudo-loglikes against a shared
    graph, folded or split-eps; one DecodeResult per row, None where the
    beam died (a row with no frames yields an empty result).

    want_lattice=True also emits bounded per-frame lattice-arc records on
    the device and attaches each row's TokenLattice (see
    lat.lattice.lattice_from_token_records); lattice_budget: records kept
    per (utterance, frame), 0 → min(E, max(512, 2K)) rounded up to 128.

    `device=None` means the GPU: a tensor that already lies on a CUDA device
    is decoded there, anything else is moved to the default one, and without
    a GPU this raises.  The CPU decodes only when asked by name.  timings:
    a dict that receives `search_seconds` (the frame loop, backtrace and
    host tail) and, with lattices, `record_transfer_seconds` (the records'
    compaction on the device, their copy and regrouping on the host),
    `lattice_records_live`, `lattice_record_slots` (L a decoded frame) and
    `lattice_overflow_fallbacks` (utterances whose records passed R)."""
    opts = opts or ViterbiOptions()
    if device is None and isinstance(loglikes, torch.Tensor) and loglikes.is_cuda:
        dev = loglikes.device
    else:
        dev = resolve_device(device)
    clock = StageClock(dev, timings)
    # contiguous rows: the gather reads each frame's [B, P] slice in place
    loglikes = torch.as_tensor(loglikes, dtype=torch.float32).to(dev).contiguous()
    B, T, P = loglikes.shape
    tg = build_tile_graph(graph)
    if tg.num_tiles == 0:
        raise KaldiError("decoding graph has no arcs")
    K = max(4, min(opts.max_active, graph.num_states))
    ET = _token_budget(graph, K, tg.md)
    E = ET * tg.md
    split = graph.eps_ns is not None
    L = 0
    if want_lattice:
        L = lattice_budget or min(E, max(512, 2 * K))
        L = min(E, (L + 127) // 128 * 128)
    num_frames = np.asarray(num_frames, np.int32)
    fw = np.where(np.isfinite(graph.final_weight), graph.final_weight, BIG)
    nf_dev = torch.from_numpy(num_frames).to(dev)
    tile_ptr_dev, tiles_dev, frm_dev = tg.device_arrays(dev)
    eps_hops, D, init_tokens = None, 0, None
    if split:
        eps_hops, D = _eps_hop_table(graph, dev)
        ts0 = np.full((B, K), -1, np.int32)
        tc0 = np.full((B, K), BIG, np.float32)
        for i, (s_i, c_i) in enumerate(start_closure(graph, D)[:K]):
            ts0[:, i] = s_i
            tc0[:, i] = c_i
        init_tokens = (torch.from_numpy(ts0).to(dev), torch.from_numpy(tc0).to(dev))
    tok_state, tok_cost, bp_state, bp_arc, records = _decode_scan_tokens(
        tile_ptr_dev, tiles_dev, graph.start, loglikes, nf_dev,
        float(opts.acoustic_scale), float(opts.beam), K, ET, graph.num_states,
        L, float(lattice_beam), init_tokens, eps_hops, D)
    tok_state_h = tok_state.cpu().numpy()
    tok_cost_h = tok_cost.cpu().numpy()
    end_states = np.zeros(B, np.int32)
    costs = np.zeros(B, np.float64)
    use_final = np.zeros(B, bool)
    for b in range(B):
        sb = tok_state_h[b]
        cb = np.where(sb >= 0, tok_cost_h[b], BIG)
        total = cb + fw[np.maximum(sb, 0)]
        if total.min() >= BIG:
            total = cb
        else:
            use_final[b] = True
        slot = int(np.argmin(total))
        costs[b] = float(total[slot])
        end_states[b] = sb[slot]
    arcs = _backtrace_scan(
        bp_state, bp_arc, frm_dev,
        torch.from_numpy(np.maximum(end_states, 0)).to(dev), nf_dev,
    ).cpu().numpy()
    del bp_state, bp_arc
    # the scan's arc ids are padded tile slots — map back to graph arcs
    arcs = np.where(arcs >= 0, tg.pad2orig[np.maximum(arcs, 0)], -1)
    tail = _results_from_arcs_split if split else results_from_arcs
    results = tail(graph, arcs, end_states, use_final, costs, num_frames)
    clock.lap("search_seconds")
    if not want_lattice:
        return results
    R = min(T * 64, T * L)
    packed, counts = _compact_lat_records(records, R)
    counts = counts.cpu().numpy()
    # the one lattice copy to the host: the live rows only
    packed = packed[:, :max(1, min(R, int(counts.max())))].cpu().numpy()
    clock.add("lattice_records_live", int(counts.sum()))
    clock.add("lattice_record_slots", L * int(num_frames.sum()))
    for b, res in enumerate(results):
        if res is None:
            continue
        nf_b = int(num_frames[b])
        if counts[b] > R:
            clock.add("lattice_overflow_fallbacks", 1)
            # budget overflow (a record-dense utterance): fetch this
            # utterance's full columns
            cols = [x[:, b].cpu().numpy() for x in records]
            arc_b = np.where(cols[2] >= 0, tg.pad2orig[np.maximum(cols[2], 0)], -1)
            res.token_lattice = TokenLattice(
                cols[0][:nf_b], cols[1][:nf_b], arc_b[:nf_b], cols[3][:nf_b],
                tok_state_h[b], tok_cost_h[b], cols[4][:nf_b])
            continue
        res.token_lattice = _token_lattice_from_packed(
            packed[b, : counts[b]], nf_b, tg.pad2orig, tok_state_h[b], tok_cost_h[b])
    clock.lap("record_transfer_seconds")
    return results


def results_from_arcs(
    graph: CsrGraph,
    arcs: np.ndarray,  # [T, B] winning arc ids (-1 = dead frame)
    end_states: np.ndarray,  # [B]
    use_final: np.ndarray,  # [B] bool
    costs: np.ndarray,  # [B]
    num_frames: np.ndarray,  # [B]
    frame_states: Optional[np.ndarray] = None,  # [T, B, K] (lattice mode)
    frame_costs: Optional[np.ndarray] = None,
) -> List[Optional[DecodeResult]]:
    """Host tail of a batched decode: winning-arc chains → words/alignments.

    Most arcs carry no output labels, so an arc→has-olabel mask is built
    once per graph and only the (few) word-bearing arcs of an utterance are
    touched in Python."""
    B = arcs.shape[1]
    mask = getattr(graph, "_olabel_mask", None)
    if mask is None or len(mask) != graph.num_arcs:
        mask = np.fromiter(
            (len(o) > 0 for o in graph.arc_olabels), bool, graph.num_arcs)
        graph._olabel_mask = mask
    results: List[Optional[DecodeResult]] = []
    for b in range(B):
        nf_b = int(num_frames[b])
        if costs[b] >= BIG:
            results.append(None)
            continue
        arc_seq = arcs[:nf_b, b]
        if (arc_seq < 0).any():
            results.append(None)
            continue
        tids = graph.tid[arc_seq]
        words: List[int] = []
        for a in arc_seq[mask[arc_seq]]:
            words.extend(graph.arc_olabels[a])
        if use_final[b]:
            words.extend(graph.final_olabels[int(end_states[b])])
        results.append(DecodeResult(
            words=words, alignment=tids.astype(np.int32), cost=float(costs[b]),
            frame_states=None if frame_states is None else frame_states[:nf_b, b],
            frame_costs=None if frame_costs is None else frame_costs[:nf_b, b]))
    return results


# ---------------------------------------------------------------------------
# dense / top-K decode over a shared graph (decode_batch)
# ---------------------------------------------------------------------------

def decode_regime(batch: int, frames: int, num_states: int, max_active: int,
                  want_lattice: bool = False) -> Tuple[str, int]:
    """("tokens" | "dense" | "topk", K), as the JAX package's decode_batch
    chooses: token-sparse when the [B, S] float32 cost vector would pass
    2 GB; dense (K = S) when the [T, B, S] int32 winning-arc store fits in
    4 GB and no lattice is wanted; else K = max(4, min(max_active, S)),
    which is dense mode again when that K reaches S."""
    S = num_states
    K = max(4, min(max_active, S))
    if batch * S * 4 > TOKENS_ABOVE_BYTES:
        return "tokens", K
    if not want_lattice and frames * batch * S * 4 <= DENSE_UP_TO_BYTES:
        return "dense", S
    return ("dense" if K >= S else "topk"), K


def _cost_state_key(cost: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """One int64 key per entry, ordered as the pair (cost, state id): an
    order-preserving map of the float32 cost (both signs) in the high 32
    bits, the state id in the low 32.  Keys are distinct, so a top-K on them
    has no ties to break: equal costs enter in state order, lowest first, as
    `lax.top_k` puts them."""
    bits = cost.contiguous().view(torch.int32).long()
    ordered = torch.where(bits < 0, -(2 ** 31) - 1 - bits, bits)
    del bits
    return ordered.bitwise_left_shift_(32).bitwise_or_(state)


def _relax(alpha: torch.Tensor, ll_t: torch.Tensor, frm: torch.Tensor,
           pdf: torch.Tensor, w: torch.Tensor, ns: torch.Tensor,
           ns_idx: torch.Tensor, arc_ids: torch.Tensor, acoustic_scale: float,
           S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame of every arc: (new_alpha [B, S] float32, best_arc [B, S]
    int32, −1 where no arc arrives).

    `cand` is computed ONCE and the same tensor feeds both the scatter-min
    and the winner test `cand <= new_alpha[ns] + 1e-6`: the test only works
    if both sides see the same bits.  Each [B, A] temporary is freed as soon
    as it is used (3.1 GB each at B = 256, A = 3.07M)."""
    B = alpha.shape[0]
    ac = ll_t.index_select(1, pdf).mul_(acoustic_scale)
    cand = alpha.index_select(1, frm).add_(w).sub_(ac)
    del ac
    cand.clamp_(max=BIG)
    new_alpha = torch.full((B, S), BIG, dtype=torch.float32, device=alpha.device)
    new_alpha.scatter_reduce_(1, ns_idx, cand, "amin")
    hit = cand <= new_alpha.index_select(1, ns).add_(1e-6)
    hit &= cand < BIG
    del cand
    arc_src = torch.where(hit, arc_ids, -1)
    del hit
    best_arc = torch.full((B, S), -1, dtype=torch.int32, device=alpha.device)
    best_arc.scatter_reduce_(1, ns_idx, arc_src, "amax")
    return new_alpha, best_arc


def _gate_frame(new_alpha: torch.Tensor, beam: float, K: int, S: int,
                state_ids: torch.Tensor):
    """Beam and max-active gating of one frame's [B, S] costs.  Dense mode
    (K >= S): the beam alone; returns (gated [B, S], None, gated, keep
    [B, S]).  Top-K mode: the K best states by (cost, state id), then the
    beam below the best; returns (gated [B, S] with BIG outside the kept
    set, their states [B, K] int64, their costs (BIG where not kept), keep
    [B, K]).  `new_alpha` is overwritten in top-K mode."""
    if K >= S:
        best = new_alpha.amin(dim=1, keepdim=True)
        keep = new_alpha <= best + beam
        gated = torch.where(keep, new_alpha, BIG)
        return gated, None, gated, keep
    top_key = torch.topk(_cost_state_key(new_alpha, state_ids), K, dim=1,
                         largest=False, sorted=True).values
    top_idx = top_key.bitwise_and_(0xFFFFFFFF)
    top_cost = new_alpha.gather(1, top_idx)
    keep = top_cost <= top_cost[:, :1] + beam
    top_cost = torch.where(keep, top_cost, BIG)
    gated = new_alpha.fill_(BIG).scatter_(1, top_idx, top_cost)
    return gated, top_idx, top_cost, keep


def _decode_scan_impl(
    frm: torch.Tensor, pdf: torch.Tensor, w: torch.Tensor, ns: torch.Tensor,
    alpha: torch.Tensor, loglikes: torch.Tensor, num_frames: torch.Tensor,
    acoustic_scale: float, beam: float, K: int, S: int,
    bp_out: Tuple[Optional[torch.Tensor], torch.Tensor, Optional[torch.Tensor]],
    t0: int = 0,
) -> torch.Tensor:
    """The dense frame-synchronous beam search from the cost vector `alpha`
    [B, S] over the loglike frames [B, T, P]: per frame `_relax` over every
    arc, then `_gate_frame`.  Graph arrays are per-arc [A] tensors (frm,
    pdf int64; w float32; ns int64).

    Backpointers go in place into the caller's buffers `bp_out` =
    (bp_state, bp_arc, bp_cost), at rows t0 + t: the kept states [B, K]
    (None: dense mode without them, where a row's index is its state),
    their winning arcs ([B, K], or [B, S] in dense mode), and their costs
    (None when not wanted); −1 / −1 / BIG where a state was not kept or
    the frame is past an utterance's end.  Frames past every utterance's
    end are not run, and their rows are not written.  Returns alpha after
    the last frame."""
    bp_state, bp_arc, bp_cost = bp_out
    B, T, _ = loglikes.shape
    A = frm.shape[0]
    dev = loglikes.device
    arc_ids = torch.arange(A, dtype=torch.int32, device=dev)
    ns_idx = ns[None, :].expand(B, A)
    state_ids = torch.arange(S, dtype=torch.int64, device=dev)
    t_end = min(T, int(num_frames.max().item())) if B else 0
    for t in range(t_end):
        new_alpha, best_arc = _relax(alpha, loglikes[:, t], frm, pdf, w, ns,
                                     ns_idx, arc_ids, acoustic_scale, S)
        gated, top_idx, top_cost, keep = _gate_frame(new_alpha, beam, K, S, state_ids)
        active = (t < num_frames)[:, None]
        alpha = torch.where(active, gated, alpha)
        kept = active & keep
        if top_idx is None:
            bp_arc[t0 + t] = torch.where(kept, best_arc, -1)
            if bp_state is not None:
                bp_state[t0 + t] = torch.where(kept, state_ids.to(torch.int32), -1)
        else:
            bp_arc[t0 + t] = torch.where(kept, best_arc.gather(1, top_idx), -1)
            bp_state[t0 + t] = torch.where(kept, top_idx.to(torch.int32), -1)
        if bp_cost is not None:
            bp_cost[t0 + t] = torch.where(kept, top_cost, BIG)
        del new_alpha, best_arc, gated, top_idx, top_cost, keep
    return alpha


def _start_alpha(B: int, S: int, start: int, device: torch.device) -> torch.Tensor:
    alpha = torch.full((B, S), BIG, dtype=torch.float32, device=device)
    alpha[:, start] = 0.0
    return alpha


def _top_tokens(alpha: torch.Tensor, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K best states of each row of `alpha` [B, S] and their costs,
    ordered by (cost, state id), as lax.top_k(−alpha, K) gives them."""
    state_ids = torch.arange(alpha.shape[1], dtype=torch.int64, device=alpha.device)
    key = torch.topk(_cost_state_key(alpha, state_ids), K, dim=1, largest=False,
                     sorted=True).values
    idx = key.bitwise_and_(0xFFFFFFFF)
    return idx, alpha.gather(1, idx)


def _decode_and_backtrace(
    frm: torch.Tensor, pdf: torch.Tensor, w: torch.Tensor, ns: torch.Tensor,
    start: int, loglikes: torch.Tensor, num_frames: torch.Tensor,
    acoustic_scale: float, beam: float, fw: torch.Tensor, K: int, S: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense (K >= S) or top-K (K < S) beam decode, end-state choice and
    backtrace on the device (fw [S] float32, BIG = not final).

    Returns (end_states [B] int64, has_final [B] bool, costs [B] float32,
    arcs [T, B] int32 with −1 on inactive or failed frames)."""
    B, T, _ = loglikes.shape
    dev = loglikes.device
    dense = K >= S
    bp_arc = torch.full((T, B, S if dense else K), -1, dtype=torch.int32, device=dev)
    bp_state = None if dense else torch.full((T, B, K), -1, dtype=torch.int32, device=dev)
    alpha = _decode_scan_impl(frm, pdf, w, ns, _start_alpha(B, S, start, dev), loglikes,
                              num_frames, acoustic_scale, beam, K, S,
                              (bp_state, bp_arc, None))
    total = alpha + fw[None, :]
    has_final = total.amin(dim=1) < BIG
    best_total = torch.where(has_final[:, None], total, alpha)
    end_states = best_total.argmin(dim=1)
    costs = best_total.gather(1, end_states[:, None])[:, 0]
    if not dense:
        arcs = _backtrace_scan(bp_state, bp_arc, frm, end_states.to(torch.int32),
                               num_frames)
        return end_states, has_final, costs, arcs
    arcs = torch.full((T, B), -1, dtype=torch.int32, device=dev)
    state = end_states
    t_end = min(T, int(num_frames.max().item())) if B else 0
    for t in range(t_end - 1, -1, -1):
        arc = bp_arc[t].gather(1, state[:, None])[:, 0]
        act = (t < num_frames) & (arc >= 0)
        arcs[t] = torch.where(act, arc, -1)
        state = torch.where(act, frm[arc.clamp(min=0).long()], state)
    return end_states, has_final, costs, arcs


def _decode_scan(frm, pdf, w, ns, start: int, loglikes: torch.Tensor,
                 num_frames: torch.Tensor, acoustic_scale: float, beam: float,
                 K: int, S: int):
    """The lattice mode's search: the dense scan from the start state with
    every frame's kept states, winning arcs and costs stored.

    Returns (tok_state [B, K], tok_cost [B, K]: the last frame's K best
    states; bp_state, bp_arc [T, B, K] int32 and bp_cost [T, B, K]
    float32)."""
    B, T, _ = loglikes.shape
    dev = loglikes.device
    bp_state = torch.full((T, B, K), -1, dtype=torch.int32, device=dev)
    bp_arc = torch.full((T, B, K), -1, dtype=torch.int32, device=dev)
    bp_cost = torch.full((T, B, K), BIG, dtype=torch.float32, device=dev)
    alpha = _decode_scan_impl(frm, pdf, w, ns, _start_alpha(B, S, start, dev), loglikes,
                              num_frames, acoustic_scale, beam, K, S,
                              (bp_state, bp_arc, bp_cost))
    tok_state, tok_cost = _top_tokens(alpha, K)
    return tok_state, tok_cost, bp_state, bp_arc, bp_cost


def _dense_graph_arrays(graph: CsrGraph, device: torch.device):
    """(frm, pdf, w, ns, fw) of a graph on `device`, uploaded once per
    device and kept on the graph: per-arc source state, pdf and next state
    as int64 index tensors, weights float32, final weights float32 with BIG
    for non-final states."""
    cache = graph.__dict__.setdefault("_dense_dev", {})
    key = str(device)
    if key not in cache:
        if graph.num_arcs and graph.pdf.min() < 0:
            raise KaldiError("graph has arcs without a pdf (epsilon input): "
                             "decode_batch takes folded graphs")
        frm = np.repeat(np.arange(graph.num_states, dtype=np.int64), graph.out_degree())
        fw = np.where(np.isfinite(graph.final_weight), graph.final_weight, BIG)
        cache[key] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
            frm, graph.pdf.astype(np.int64), graph.weight.astype(np.float32),
            graph.nextstate.astype(np.int64), fw.astype(np.float32)))
    return cache[key]


def decode_batch(
    graph: CsrGraph,
    loglikes: Union[np.ndarray, torch.Tensor],
    num_frames: Sequence[int],
    opts: Optional[ViterbiOptions] = None,
    want_lattice: bool = False,
    device: DeviceLike = None,
    timings: Optional[Dict[str, float]] = None,
) -> List[Optional[DecodeResult]]:
    """Beam-decode a batch [B, T, P] of loglikes against a shared graph, in
    the regime `decode_regime` picks; one DecodeResult per row, None where
    the beam died or the backtrace broke.

    want_lattice=True runs the dense scan at K = min(max_active, S) (never
    the beam-only K = S of dense mode unless max_active reaches S) and
    returns each utterance's per-frame kept states and costs
    (`frame_states`, `frame_costs`, [T, K]) for lat.lattice_from_decode;
    those [T, B, K] tensors cross to the host only in this mode.  On a
    graph too large for a [B, S] cost vector it takes the token-sparse
    lattice records (`token_lattice`) instead.

    `device=None` means the GPU, as in decode_batch_tokens.  timings: a
    dict that receives `search_seconds` (search and backtrace, ended by the
    copy of the [T, B] arcs to the host) and `host_tail_seconds` (words and
    alignments from the arcs)."""
    if graph.eps_ns is not None:
        raise NotImplementedError(
            "split-eps (chain) graphs decode through decode_batch_tokens; the "
            "dense and top-K regimes take folded graphs")
    opts = opts or ViterbiOptions()
    if device is None and isinstance(loglikes, torch.Tensor) and loglikes.is_cuda:
        dev = loglikes.device
    else:
        dev = resolve_device(device)
    loglikes = torch.as_tensor(loglikes, dtype=torch.float32).to(dev)
    B, T, P = loglikes.shape
    regime, K = decode_regime(B, T, graph.num_states, opts.max_active, want_lattice)
    clock = StageClock(dev, timings)
    if regime == "tokens":
        results = decode_batch_tokens(graph, loglikes, num_frames, opts,
                                      want_lattice=want_lattice, device=dev)
        clock.lap("search_seconds")
        return results
    num_frames = np.asarray(num_frames, np.int32)
    frm, pdf, w, ns, fw = _dense_graph_arrays(graph, dev)
    if graph.num_arcs and int(graph.pdf.max()) >= P:
        raise KaldiError(f"graph pdf ids reach {int(graph.pdf.max())}, loglikes have {P}")
    nf_dev = torch.from_numpy(num_frames).to(dev)
    frame_states = frame_costs = None
    if want_lattice:
        tok_state, tok_cost, bp_state, bp_arc, bp_cost = _decode_scan(
            frm, pdf, w, ns, graph.start, loglikes, nf_dev,
            float(opts.acoustic_scale), float(opts.beam), K, graph.num_states)
        tok_state_h = tok_state.cpu().numpy()
        tok_cost_h = tok_cost.cpu().numpy()
        fw_h = fw.cpu().numpy()
        end = np.zeros(B, np.int32)
        cost = np.zeros(B, np.float64)
        final = np.zeros(B, bool)
        for b in range(B):
            total = tok_cost_h[b] + fw_h[tok_state_h[b]]
            if total.min() >= BIG:
                total = tok_cost_h[b]
            else:
                final[b] = True
            slot = int(np.argmin(total))
            cost[b] = float(total[slot])
            end[b] = tok_state_h[b, slot]
        arcs = _backtrace_scan(bp_state, bp_arc, frm, torch.from_numpy(end).to(dev),
                               nf_dev).cpu().numpy()
        frame_states = bp_state.cpu().numpy()
        frame_costs = bp_cost.cpu().numpy()
    else:
        end_d, final_d, cost_d, arcs_d = _decode_and_backtrace(
            frm, pdf, w, ns, graph.start, loglikes, nf_dev, float(opts.acoustic_scale),
            float(opts.beam), fw, K, graph.num_states)
        arcs = arcs_d.cpu().numpy()
        end = end_d.cpu().numpy().astype(np.int32)
        final = final_d.cpu().numpy()
        cost = cost_d.cpu().numpy().astype(np.float64)
    clock.lap("search_seconds")
    results = results_from_arcs(graph, arcs, end, final, cost, num_frames,
                                frame_states=frame_states, frame_costs=frame_costs)
    clock.lap("host_tail_seconds")
    return results


# ---------------------------------------------------------------------------
# dense alignment over per-utterance graphs (align_batch)
# ---------------------------------------------------------------------------

def align_shape(graphs: Sequence[CsrGraph]) -> Tuple[int, int]:
    """(S, A): the padded states and arcs a batch of graphs aligns at, the
    largest counts rounded up to 64 and 512 as the JAX package pads them."""
    return (-(-max(g.num_states for g in graphs) // 64) * 64,
            -(-max(g.num_arcs for g in graphs) // 512) * 512)


def _pad_graphs(graphs: Sequence[CsrGraph]):
    """Per-utterance graphs → padded [B, A] arc arrays (source state, tid,
    pdf, weight, next state), [B] start states and [B, S] final weights (BIG
    = not final), at `align_shape`.  Padding arcs carry BIG weights and
    source, pdf and next state 0, so they never win a scatter-min."""
    B = len(graphs)
    S, A = align_shape(graphs)
    frm = np.zeros((B, A), np.int32)
    tid = np.zeros((B, A), np.int32)
    pdf = np.zeros((B, A), np.int32)
    w = np.full((B, A), BIG, np.float32)
    ns = np.zeros((B, A), np.int32)
    start = np.zeros(B, np.int64)
    final = np.full((B, S), BIG, np.float32)
    for b, g in enumerate(graphs):
        a = g.num_arcs
        frm[b, :a] = np.repeat(np.arange(g.num_states), np.diff(g.row_ptr))
        tid[b, :a] = g.tid
        pdf[b, :a] = g.pdf
        w[b, :a] = g.weight
        ns[b, :a] = g.nextstate
        start[b] = g.start
        final[b, : g.num_states] = np.where(np.isfinite(g.final_weight),
                                            g.final_weight, BIG)
    return frm, tid, pdf, w, ns, start, final, S


def _align_scan(frm: torch.Tensor, pdf: torch.Tensor, w: torch.Tensor,
                ns: torch.Tensor, start: torch.Tensor, loglikes: torch.Tensor,
                num_frames: torch.Tensor, acoustic_scale: float, S: int
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Dense Viterbi over every arc of every utterance's own graph: per frame

      cand [B, A] = alpha[frm] + w − acoustic_scale·ll_t[pdf]
      → scatter-min into the next states; winner = the largest arc id whose
        cand is within 1e-6 of its next state's new cost (scatter-max)

    with all three per-arc lookups through the gather kernel (K1): the
    frame's loglike row read in place from [B, T, P], then the [B, S] cost
    vector before and after the frame.  The reductions are order-free
    (min, max), so they are exact on every device.  Frames past an
    utterance's end keep its costs and store −1 winners; frames past every
    utterance's end are not run.

    Returns (alpha [B, S] after the last frame, winners [T, B, S] int32,
    frames run)."""
    B, A = frm.shape
    T = loglikes.shape[1]
    dev = loglikes.device
    alpha = torch.full((B, S), BIG, dtype=torch.float32, device=dev)
    alpha[torch.arange(B, device=dev), start] = 0.0
    ns64 = ns.long()
    arc_ids = torch.arange(A, dtype=torch.int32, device=dev)[None, :]
    best_arcs = torch.full((T, B, S), -1, dtype=torch.int32, device=dev)
    t_end = min(T, int(num_frames.max().item())) if B else 0
    for t in range(t_end):
        ac = batched_table_gather(loglikes[:, t], pdf).mul_(acoustic_scale)
        cand = batched_table_gather(alpha, frm).add_(w).sub_(ac)
        del ac
        cand.clamp_(max=BIG)
        new_alpha = torch.full((B, S), BIG, dtype=torch.float32, device=dev)
        new_alpha.scatter_reduce_(1, ns64, cand, "amin")
        hit = cand <= batched_table_gather(new_alpha, ns).add_(1e-6)
        hit &= cand < BIG
        arc_src = torch.where(hit, arc_ids, -1)
        best = torch.full((B, S), -1, dtype=torch.int32, device=dev)
        best.scatter_reduce_(1, ns64, arc_src, "amax")
        active = (t < num_frames)[:, None]
        alpha = torch.where(active, new_alpha, alpha)
        best_arcs[t] = torch.where(active, best, -1)
    return alpha, best_arcs, t_end


def _align_and_backtrace(frm, tid, pdf, w, ns, start, final, loglikes, num_frames,
                         acoustic_scale: float, S: int):
    """Forward scan, end-state choice and backtrace on the device, so only
    [B] scores and [T, B] transition-ids and flags reach the host (the
    [T, B, S] winners stay on the device).

    Returns (scores [B], tids [T, B] int32 with −1 on inactive frames, ok
    [T, B]: False only where an active frame had no winner, frames run)."""
    alpha, best_arcs, t_end = _align_scan(frm, pdf, w, ns, start, loglikes,
                                          num_frames, acoustic_scale, S)
    T, B = best_arcs.shape[:2]
    tot = alpha + final
    state = tot.argmin(dim=1)
    scores = tot.gather(1, state[:, None])[:, 0]
    tids = torch.full((T, B), -1, dtype=torch.int32, device=alpha.device)
    ok = torch.ones((T, B), dtype=torch.bool, device=alpha.device)
    for t in range(t_end - 1, -1, -1):
        arc = best_arcs[t].gather(1, state[:, None])[:, 0]
        in_range = t < num_frames
        good = in_range & (arc >= 0)
        a_cl = arc.clamp(min=0).long()[:, None]
        tids[t] = torch.where(good, tid.gather(1, a_cl)[:, 0], -1)
        state = torch.where(good, frm.gather(1, a_cl)[:, 0].long(), state)
        ok[t] = good | ~in_range
    return scores, tids, ok, t_end


def align_batch(
    graphs: Sequence[CsrGraph],
    loglikes: Union[np.ndarray, torch.Tensor],
    num_frames: Sequence[int],
    opts: Optional[ViterbiOptions] = None,
    device: DeviceLike = None,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[List[Optional[np.ndarray]], List[float]]:
    """Viterbi-align each utterance to its own graph (reference
    gmm-align-compiled; the JAX package's align_batch).

    loglikes: [B, T, P]; num_frames: valid frames per utterance.  Returns
    (alignments: tid arrays, None where the utterance could not reach a
    final state or its backtrace broke; per-utterance best cost, inf on
    failure).  `device=None` means the GPU, or the device of a CUDA
    loglike tensor; the CPU only by name.  timings: a dict that receives
    `align_seconds` (scan and backtrace, ended by the copy of the [T, B]
    tids to the host) and `align_frames`, the frames scanned (each runs
    the gather kernel three times)."""
    opts = opts or ViterbiOptions()
    if device is None and isinstance(loglikes, torch.Tensor) and loglikes.is_cuda:
        dev = loglikes.device
    else:
        dev = resolve_device(device)
    clock = StageClock(dev, timings)
    loglikes = torch.as_tensor(loglikes, dtype=torch.float32).to(dev)
    B, T, P = loglikes.shape
    if len(graphs) != B:
        raise KaldiError(f"{len(graphs)} graphs for a batch of {B}")
    if any(g.num_arcs and int(g.pdf.max()) >= P for g in graphs):
        raise KaldiError(f"a graph's pdf ids reach past the loglikes' {P}")
    frm, tid, pdf, w, ns, start, final, S = _pad_graphs(graphs)
    num_frames = np.asarray(num_frames, np.int32)
    dev_arrays = [torch.from_numpy(a).to(dev) for a in (frm, tid, pdf, w, ns, start, final)]
    scores, tids, ok, t_end = _align_and_backtrace(
        *dev_arrays, loglikes, torch.from_numpy(num_frames).to(dev),
        float(opts.acoustic_scale), S)
    h_scores = scores.cpu().numpy()
    h_tids = tids.cpu().numpy()
    h_ok = ok.cpu().numpy()
    clock.lap("align_seconds")
    clock.add("align_frames", t_end)
    alignments: List[Optional[np.ndarray]] = []
    costs: List[float] = []
    for b in range(B):
        nf = int(num_frames[b])
        if h_scores[b] >= BIG or not bool(h_ok[:nf, b].all()):
            log.warning("alignment failed for utterance %d", b)
            alignments.append(None)
            costs.append(np.inf)
            continue
        alignments.append(np.ascontiguousarray(h_tids[:nf, b]))
        costs.append(float(h_scores[b]))
    return alignments, costs
