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

Ported: folded graphs (eps arcs forwarded at build time), best path only.
Lattice records (`want_lattice=True`) and split-eps graphs raise
NotImplementedError until their slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph, build_tile_graph
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.ops.gather_kernel import batched_table_gather
from old_kaldi_git_tpu_torch.utils.log import KaldiError
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass
from old_kaldi_git_tpu_torch.utils.timing import StageClock

BIG = 1e10  # pseudo-infinity that survives float32 arithmetic
TOKENS_ABOVE_BYTES = 2_000_000_000  # [B, S] float32 cost vector above this
DENSE_UP_TO_BYTES = 4_000_000_000  # [T, B, S] int32 winning-arc store up to this


@options_dataclass
class ViterbiOptions:
    beam: float = 16.0
    max_active: int = 7000
    acoustic_scale: float = 0.1


@dataclasses.dataclass
class DecodeResult:
    words: List[int]
    alignment: np.ndarray  # tids, [T]
    cost: float


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


def _decode_scan_tokens(
    tile_ptr: torch.Tensor, tiles: torch.Tensor, start: int,
    loglikes: torch.Tensor, num_frames: torch.Tensor,
    acoustic_scale: float, beam: float, K: int, ET: int, S: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-sparse beam decode of folded graphs, best path only.

    Returns (tok_state [B, K] int32, tok_cost [B, K] float32,
    bp_state [T, B, K] int32, bp_arc [T, B, K] int32).  Arc ids are PADDED
    tile-slot ids (tile*MD + lane); callers map them back to graph arcs via
    TileGraph.pad2orig.  The backpointer stores are allocated once and
    written per frame; frames past every utterance's end are not run."""
    B, T, P = loglikes.shape
    NT, MD, _ = tiles.shape
    E = ET * MD
    dev = loglikes.device
    j = torch.arange(ET, dtype=torch.int64, device=dev)
    lane = torch.arange(MD, dtype=torch.int32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=torch.int64, device=dev)

    tok_state = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    tok_state[:, 0] = start
    tok_cost = torch.full((B, K), BIG, dtype=torch.float32, device=dev)
    tok_cost[:, 0] = 0.0
    bp_state = torch.full((T, B, K), -1, dtype=torch.int32, device=dev)
    bp_arc = torch.full((T, B, K), -1, dtype=torch.int32, device=dev)

    def expand_md(x):
        """[B, ET] per-tile value → [B, E] per-arc value (lane repeat)."""
        return x[:, :, None].expand(B, ET, MD).reshape(B, E)

    def deltas(vals):
        return torch.diff(vals, dim=1, prepend=zero_col)

    t_end = min(T, int(num_frames.max().item())) if B else 0
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
        # Sums are taken in int64, where nothing wraps.  Run starts >= ET
        # must DROP, not clamp onto the last slot: they go to a spare slot
        # ET that is cut off before the cumsum.
        cost_bits = tok_cost.view(torch.int32).long()
        stacked = torch.stack(
            [deltas(cum), deltas(rp - prev), deltas(cost_bits)], dim=1)
        # channels first, [B, 3, ET]: the cumsum then runs along the
        # contiguous dim (a scan along a strided dim is several times slower)
        scat = torch.zeros((B, 3, ET + 1), dtype=torch.int64, device=dev)
        scat.scatter_add_(
            2, prev.clamp(max=ET)[:, None, :].expand(B, 3, K), stacked)
        bases = torch.cumsum(scat[:, :, :ET], dim=2)  # [B, 3, ET]
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
        ll_arc = batched_table_gather(
            loglikes[:, t].contiguous(), pdf_arc.clamp(max=P - 1))
        # tile-padding arcs carry w=BIG; a positive acoustic term could drag
        # their cost just under BIG, so they are masked like budget-invalid
        # slots, not merely cost-gated
        valid = valid & (w_arc < BIG)
        cost = base_cost + w_arc - acoustic_scale * ll_arc
        dest = torch.where(valid, ns_arc, S)  # sentinel sorts last
        cost = torch.where(valid, cost.clamp(max=BIG), BIG)
        # dedup: stable sort on (dest, cost); ties keep expansion order
        key_s, order = torch.sort(_dest_cost_key(dest, cost), dim=1, stable=True)
        dest_s = (key_s >> 32).to(torch.int32)
        cost_s = cost.gather(1, order)
        arc_s = arc.gather(1, order)
        first = torch.ones((B, E), dtype=torch.bool, device=dev)
        first[:, 1:] = dest_s[:, 1:] != dest_s[:, :-1]
        cand = torch.where(first & (dest_s < S), cost_s, BIG)
        # top-K: stable sort by cost, first K
        new_cost, sel = torch.sort(cand, dim=1, stable=True)
        new_cost, sel = new_cost[:, :K], sel[:, :K]
        new_state = dest_s.gather(1, sel)
        new_arc = arc_s.gather(1, sel)
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
    return tok_state, tok_cost, bp_state, bp_arc


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


def decode_batch_tokens(
    graph: CsrGraph,
    loglikes: Union[np.ndarray, torch.Tensor],
    num_frames: Sequence[int],
    opts: Optional[ViterbiOptions] = None,
    want_lattice: bool = False,
    device: DeviceLike = None,
) -> List[Optional[DecodeResult]]:
    """Beam-decode a batch [B, T, P] of pseudo-loglikes against a shared
    graph; one DecodeResult per row, None where the beam died (a row with
    no frames yields an empty result).

    `device=None` means the GPU: a tensor that already lies on a CUDA device
    is decoded there, anything else is moved to the default one, and without
    a GPU this raises.  The CPU decodes only when asked by name."""
    if want_lattice:
        raise NotImplementedError(
            "lattice records of the token-sparse decoder are not ported "
            "yet: they come with the lattice and rescoring slice")
    if graph.eps_ns is not None:
        raise NotImplementedError(
            "split-eps (chain) graphs are not ported yet: they come with "
            "the chain decode slice")
    opts = opts or ViterbiOptions()
    if device is None and isinstance(loglikes, torch.Tensor) and loglikes.is_cuda:
        dev = loglikes.device
    else:
        dev = resolve_device(device)
    loglikes = torch.as_tensor(loglikes, dtype=torch.float32).to(dev)
    B, T, P = loglikes.shape
    tg = build_tile_graph(graph)
    if tg.num_tiles == 0:
        raise KaldiError("decoding graph has no arcs")
    K = max(4, min(opts.max_active, graph.num_states))
    ET = _token_budget(graph, K, tg.md)
    num_frames = np.asarray(num_frames, np.int32)
    fw = np.where(np.isfinite(graph.final_weight), graph.final_weight, BIG)
    nf_dev = torch.from_numpy(num_frames).to(dev)
    tile_ptr_dev, tiles_dev, frm_dev = tg.device_arrays(dev)
    tok_state, tok_cost, bp_state, bp_arc = _decode_scan_tokens(
        tile_ptr_dev, tiles_dev, graph.start, loglikes, nf_dev,
        float(opts.acoustic_scale), float(opts.beam), K, ET, graph.num_states)
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
    # the scan's arc ids are padded tile slots — map back to graph arcs
    arcs = np.where(arcs >= 0, tg.pad2orig[np.maximum(arcs, 0)], -1)
    return results_from_arcs(graph, arcs, end_states, use_final, costs, num_frames)


def results_from_arcs(
    graph: CsrGraph,
    arcs: np.ndarray,  # [T, B] winning arc ids (-1 = dead frame)
    end_states: np.ndarray,  # [B]
    use_final: np.ndarray,  # [B] bool
    costs: np.ndarray,  # [B]
    num_frames: np.ndarray,  # [B]
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
            words=words, alignment=tids.astype(np.int32), cost=float(costs[b])))
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


def _decode_and_backtrace(
    frm: torch.Tensor, pdf: torch.Tensor, w: torch.Tensor, ns: torch.Tensor,
    start: int, loglikes: torch.Tensor, num_frames: torch.Tensor,
    acoustic_scale: float, beam: float, fw: torch.Tensor, K: int, S: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense (K >= S) or top-K (K < S) beam decode, end-state choice and
    backtrace on the device.  Graph arrays are per-arc [A] tensors (frm, pdf
    int64; w float32; ns int64) and fw [S] float32 (BIG = not final).

    Returns (end_states [B] int64, has_final [B] bool, costs [B] float32,
    arcs [T, B] int32 with −1 on inactive or failed frames).  Frames past
    every utterance's end are not run; their backpointers stay −1, as the
    JAX scan's masked frames leave them."""
    B, T, _ = loglikes.shape
    A = frm.shape[0]
    dev = loglikes.device
    alpha = torch.full((B, S), BIG, dtype=torch.float32, device=dev)
    alpha[:, start] = 0.0
    arc_ids = torch.arange(A, dtype=torch.int32, device=dev)
    ns_idx = ns[None, :].expand(B, A)
    dense = K >= S
    bp_arc = torch.full((T, B, S if dense else K), -1, dtype=torch.int32, device=dev)
    if not dense:
        bp_state = torch.full((T, B, K), -1, dtype=torch.int32, device=dev)
        state_ids = torch.arange(S, dtype=torch.int64, device=dev)
    t_end = min(T, int(num_frames.max().item())) if B else 0
    for t in range(t_end):
        new_alpha, best_arc = _relax(alpha, loglikes[:, t], frm, pdf, w, ns,
                                     ns_idx, arc_ids, acoustic_scale, S)
        active = (t < num_frames)[:, None]
        if dense:
            best = new_alpha.amin(dim=1, keepdim=True)
            gated = torch.where(new_alpha <= best + beam, new_alpha, BIG)
            alpha = torch.where(active, gated, alpha)
            bp_arc[t] = torch.where(active & (gated < BIG), best_arc, -1)
            continue
        top_key = torch.topk(_cost_state_key(new_alpha, state_ids), K, dim=1,
                             largest=False, sorted=True).values
        top_idx = top_key.bitwise_and_(0xFFFFFFFF)
        top_cost = new_alpha.gather(1, top_idx)
        keep = top_cost <= top_cost[:, :1] + beam
        top_cost = torch.where(keep, top_cost, BIG)
        gated = new_alpha.fill_(BIG).scatter_(1, top_idx, top_cost)
        alpha = torch.where(active, gated, alpha)
        kept = active & keep
        bp_state[t] = torch.where(kept, top_idx.to(torch.int32), -1)
        bp_arc[t] = torch.where(kept, best_arc.gather(1, top_idx), -1)
        del top_key, top_idx, top_cost, keep, gated, best_arc
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
    for t in range(t_end - 1, -1, -1):
        arc = bp_arc[t].gather(1, state[:, None])[:, 0]
        act = (t < num_frames) & (arc >= 0)
        arcs[t] = torch.where(act, arc, -1)
        state = torch.where(act, frm[arc.clamp(min=0).long()], state)
    return end_states, has_final, costs, arcs


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

    `device=None` means the GPU, as in decode_batch_tokens.  timings: a
    dict that receives `search_seconds` (search and backtrace, ended by the
    copy of the [T, B] arcs to the host) and `host_tail_seconds` (words and
    alignments from the arcs)."""
    if want_lattice:
        raise NotImplementedError(
            "lattices of decode_batch (_decode_scan) are not ported yet: they "
            "come with the lattice and rescoring slice")
    if graph.eps_ns is not None:
        raise NotImplementedError(
            "split-eps (chain) graphs are not ported yet: they come with "
            "the chain decode slice")
    opts = opts or ViterbiOptions()
    if device is None and isinstance(loglikes, torch.Tensor) and loglikes.is_cuda:
        dev = loglikes.device
    else:
        dev = resolve_device(device)
    loglikes = torch.as_tensor(loglikes, dtype=torch.float32).to(dev)
    B, T, P = loglikes.shape
    regime, K = decode_regime(B, T, graph.num_states, opts.max_active)
    clock = StageClock(dev, timings)
    if regime == "tokens":
        results = decode_batch_tokens(graph, loglikes, num_frames, opts, device=dev)
        clock.lap("search_seconds")
        return results
    num_frames = np.asarray(num_frames, np.int32)
    frm, pdf, w, ns, fw = _dense_graph_arrays(graph, dev)
    if graph.num_arcs and int(graph.pdf.max()) >= P:
        raise KaldiError(f"graph pdf ids reach {int(graph.pdf.max())}, loglikes have {P}")
    end, final, cost, arcs = _decode_and_backtrace(
        frm, pdf, w, ns, graph.start, loglikes,
        torch.from_numpy(num_frames).to(dev), float(opts.acoustic_scale),
        float(opts.beam), fw, K, graph.num_states)
    arcs = arcs.cpu().numpy()
    clock.lap("search_seconds")
    results = results_from_arcs(
        graph, arcs, end.cpu().numpy().astype(np.int32), final.cpu().numpy(),
        cost.cpu().numpy().astype(np.float64), num_frames)
    clock.lap("host_tail_seconds")
    return results
