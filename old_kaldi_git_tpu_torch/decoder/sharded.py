"""Graph-sharded token-sparse beam decoding.

Counterpart of old_kaldi_git_tpu/decoder/sharded.py (`shard_graph`,
`_sharded_token_scan`, `_sharded_backtrace_prog`,
`decode_batch_tokens_sharded`): the same math on the port's token decoder
(decoder/viterbi.py), for graphs whose tile tables should not live whole on
one device.

  * States fall into N contiguous ranges balanced by tile count; shard d
    keeps its range's tile table (padding tiles carry w = BIG) and a local
    tile_ptr.  The token set [B, K] is replicated.
  * Each frame every shard expands the tokens whose state it owns into its
    own budget of ET tiles, looks up the arcs' loglikes through the gather
    kernel (ops/gather_kernel.py), dedups on (dest, cost) and keeps its K
    best.  Then the ROW-PARTITIONED merge: each batch row's N candidate
    lists go to the row's owner, which sorts them once by (dest, cost),
    keeps the first of each dest run and its K best, and the merged beams
    go back to every shard.  At N = 1 there is no merge.
  * The backtrace walks the replicated backpointers; the shard that owns
    an arc's tile computes the arc's source state, and a sum over the
    shards combines the answers (exactly one shard owns an arc).

The collectives sit behind a shard group:

  `InProcessShards(devices)`: N shards on a list of devices in this process
    (a device may repeat).  The shards that share a device are STACKED: one
    expansion over [B·n] rows and one gather-kernel call a frame for the
    n shards of a device, the index [B, n·E] read against the frame's
    [B, P] loglikes in place.  The all_to_all and all_gather become a
    concatenation in shard order and copies between devices.
  `ProcessGroupShards(group, device)`: one shard per rank of a
    torch.distributed group (NCCL on cards, gloo on the CPU):
    `all_to_all_single` of each row's candidates to its owner,
    `all_gather_into_tensor` of the merged beams, and an `all_reduce`
    for the backtrace.

Both give the same arcs as the JAX package's shard_map program: the merge
concatenates the shards' candidates in shard order and every sort is
stable, as lax.sort is.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph, build_tile_graph
from old_kaldi_git_tpu_torch.decoder.viterbi import (
    BIG,
    DecodeResult,
    ViterbiOptions,
    _dest_cost_key,
    results_from_arcs,
)
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.ops.gather_kernel import batched_table_gather
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("sharded")

_SPLIT_EPS = ("sharded decode needs a folded-eps graph: split-eps backoff "
              "hops are not wired into the sharded search (decoding over "
              "emitting arcs only would silently drop backoff transitions)")


@dataclasses.dataclass
class ShardedCsrGraph:
    """Host-side shard plan of a CsrGraph: N contiguous state ranges
    balanced by tile count, each with its local (0-based) tile_ptr and its
    slice of the [*, MD, 3] tile table.  Built once per (graph, N)."""

    graph: CsrGraph
    md: int
    lo: np.ndarray        # [N] first state of each shard
    tile_off: np.ndarray  # [N] global tile id of each shard's first tile
    tile_ptr: np.ndarray  # [N, SL+1] local tile_ptr (padded states: 0 tiles)
    tiles: np.ndarray     # [N, TL, MD, 3] int32 (w bits, pdf, nextstate)
    pad2orig: np.ndarray  # [Ntile*md] padded arc id -> graph arc id
    _dev: Dict[Tuple[str, Tuple[int, ...]], Tuple[torch.Tensor, ...]] = (
        dataclasses.field(default_factory=dict, repr=False, compare=False))

    @property
    def num_shards(self) -> int:
        return len(self.lo)

    @property
    def states_per_shard(self) -> int:
        return self.tile_ptr.shape[1] - 1

    @property
    def tiles_per_shard(self) -> int:
        return self.tiles.shape[1]

    def shard_tile_counts(self) -> np.ndarray:
        """[N] real tiles of each shard."""
        return self.tile_ptr[:, -1].astype(np.int64)

    def device_arrays(self, device: torch.device, shards: Sequence[int]):
        """(tile_ptr [n, SL+1], tiles [n·TL, MD, 3], lo [n], tile_off [n])
        of the listed shards on `device`, stacked, uploaded once and kept."""
        key = (str(device), tuple(shards))
        if key not in self._dev:
            idx = list(shards)
            self._dev[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (self.tile_ptr[idx],
                          self.tiles[idx].reshape(-1, self.md, 3),
                          self.lo[idx], self.tile_off[idx]))
        return self._dev[key]


def shard_graph(graph: CsrGraph, num_shards: int) -> ShardedCsrGraph:
    """Partition the states into `num_shards` contiguous ranges with about
    equal tile counts (tile storage and gather traffic are what must
    balance; state counts may be skewed)."""
    if graph.eps_ns is not None:
        raise KaldiError(_SPLIT_EPS)
    tg = build_tile_graph(graph)
    S = graph.num_states
    NT = tg.num_tiles
    tp = tg.tile_ptr.astype(np.int64)
    targets = (NT * np.arange(1, num_shards) / num_shards).astype(np.int64)
    cuts = np.searchsorted(tp, targets, side="left")
    bounds = np.concatenate([[0], np.clip(cuts, 0, S), [S]])
    bounds = np.maximum.accumulate(bounds).astype(np.int64)
    lo, hi = bounds[:-1], bounds[1:]
    SL = int((hi - lo).max())
    TL = int(max(1, (tp[hi] - tp[lo]).max()))
    tile_ptr = np.zeros((num_shards, SL + 1), np.int32)
    tiles = np.zeros((num_shards, TL, tg.md, 3), np.int32)
    # padding tiles carry w = BIG, so their arcs never become candidates
    tiles[..., 0] = np.array([BIG], np.float32).view(np.int32)[0]
    for d in range(num_shards):
        n = int(hi[d] - lo[d])
        local = tp[lo[d]:hi[d] + 1] - tp[lo[d]]
        tile_ptr[d, :n + 1] = local
        tile_ptr[d, n + 1:] = local[-1]  # padded states: zero tiles
        t0, t1 = int(tp[lo[d]]), int(tp[hi[d]])
        tiles[d, :t1 - t0] = tg.tiles[t0:t1]
    return ShardedCsrGraph(graph=graph, md=tg.md, lo=lo.astype(np.int32),
                           tile_off=tp[lo].astype(np.int32), tile_ptr=tile_ptr,
                           tiles=tiles, pad2orig=tg.pad2orig)


def shard_budget(sg: ShardedCsrGraph, K: int) -> int:
    """The per-shard tile budget ET: viterbi._token_budget's 1.25x rule
    against the LOCAL tile share, with 1.5x more slack for the active set's
    skew across shards when N > 1 (at N = 1 it equals the unsharded
    budget), capped at the shard's tile table, rounded up to 128."""
    N = sg.num_shards
    S = sg.graph.num_states
    TL = sg.tiles_per_shard
    NT = int(sg.tile_off[-1]) + TL  # about the total tile count
    mean_tiles = max(1.0, NT / max(1, S))
    skew = 1.5 if N > 1 else 1.0
    ET = int(min(TL, max(1.25 * K * mean_tiles * skew / N, 1.25 * K / N)))
    return max(128, (ET + 127) // 128 * 128)


def _select(dest: torch.Tensor, cost: torch.Tensor, arc: torch.Tensor, K: int,
            S: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dedup-min and top-K of each row's candidates: a stable sort by
    (dest, cost), the first entry of each dest run, a stable sort by cost,
    the first K.  Returns (cost, state, arc) [R, K]; state S where the cost
    is BIG.  Rows with fewer than K candidates are padded with BIG."""
    R, M = dest.shape
    if M < K:
        pad = K - M
        dest = torch.cat([dest, dest.new_full((R, pad), S)], dim=1)
        cost = torch.cat([cost, cost.new_full((R, pad), BIG)], dim=1)
        arc = torch.cat([arc, arc.new_full((R, pad), -1)], dim=1)
    key, order = torch.sort(_dest_cost_key(dest, cost), dim=1, stable=True)
    dest_s = (key >> 32).to(torch.int32)
    cost_s = cost.gather(1, order)
    arc_s = arc.gather(1, order)
    first = torch.ones_like(dest_s, dtype=torch.bool)
    first[:, 1:] = dest_s[:, 1:] != dest_s[:, :-1]
    cand = torch.where(first & (dest_s < S), cost_s, BIG)
    new_cost, sel = torch.sort(cand, dim=1, stable=True)
    new_cost, sel = new_cost[:, :K], sel[:, :K]
    new_state = torch.where(new_cost < BIG, dest_s.gather(1, sel), S)
    return new_cost, new_state, arc_s.gather(1, sel)


class InProcessShards:
    """N graph shards on a list of devices within this process (a device
    may repeat: N shards on one card, or on the CPU for tests).  Shards
    that share a device are stacked into one expansion and one gather-kernel
    call a frame."""

    def __init__(self, devices: Sequence[DeviceLike]):
        if not devices:
            raise ValueError("InProcessShards needs at least one device")
        self.devices = [resolve_device(d) for d in devices]
        self.size = len(self.devices)
        placement: Dict[str, Tuple[torch.device, List[int]]] = {}
        for d, dev in enumerate(self.devices):
            placement.setdefault(str(dev), (dev, []))[1].append(d)
        self.local = [(dev, tuple(ids)) for dev, ids in placement.values()]

    def merge(self, cands: List[Tuple[torch.Tensor, ...]], K: int, S: int
              ) -> List[Tuple[torch.Tensor, ...]]:
        """cands[g] = (cost, state, arc) [B, n_g, K] of local group g →
        the merged (cost, state, arc) [B, K] on each group's device."""
        if self.size == 1:
            return [tuple(x[:, 0] for x in cands[0])]
        home = self.local[0][0]
        blocks: List[Optional[Tuple[torch.Tensor, ...]]] = [None] * self.size
        for (_, ids), c in zip(self.local, cands):
            for i, d in enumerate(ids):
                blocks[d] = tuple(x[:, i].to(home) for x in c)
        cost, state, arc = (torch.cat([b[j] for b in blocks], dim=1)
                            for j in range(3))
        merged = _select(state, cost, arc, K, S)
        return [tuple(x.to(dev) for x in merged) for dev, _ in self.local]

    def reduce_sum(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The sum of the local groups' tensors, on each group's device."""
        if len(xs) == 1:
            return xs
        home = self.local[0][0]
        total = sum(x.to(home) for x in xs)
        return [total.to(dev) for dev, _ in self.local]


class ProcessGroupShards:
    """One graph shard per rank of a torch.distributed process group; this
    rank's shard lives on `device` (default: the current CUDA device, or the
    CPU for a gloo group)."""

    def __init__(self, group=None, device: DeviceLike = None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise KaldiError("ProcessGroupShards needs an initialised "
                             "torch.distributed process group")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if device is None and dist.get_backend(group) == "gloo":
            device = "cpu"
        if device is None:
            device = f"cuda:{torch.cuda.current_device()}"
        self.device = resolve_device(device)
        self.local = [(self.device, (self.rank,))]

    def merge(self, cands: List[Tuple[torch.Tensor, ...]], K: int, S: int
              ) -> List[Tuple[torch.Tensor, ...]]:
        import torch.distributed as dist

        cost, state, arc = (x[:, 0] for x in cands[0])
        N = self.size
        if N == 1:
            return [(cost, state, arc)]
        B = cost.shape[0]
        Bp = -(-B // N) * N
        pk = torch.stack([state, cost.view(torch.int32), arc], dim=-1)  # [B, K, 3]
        if Bp > B:
            fill = torch.tensor([S, int(np.array([BIG], np.float32).view(np.int32)[0]), -1],
                                dtype=torch.int32, device=pk.device)
            pk = torch.cat([pk, fill.expand(Bp - B, K, 3)], dim=0)
        recv = torch.empty_like(pk)
        # chunk d of the rows goes to rank d; block d of what comes back is
        # rank d's candidates for my rows
        dist.all_to_all_single(recv, pk.contiguous(), group=self.group)
        R = Bp // N
        recv = recv.view(N, R, K, 3).transpose(0, 1).reshape(R, N * K, 3)
        r_cost, r_state, r_arc = _select(
            recv[..., 0], recv[..., 1].contiguous().view(torch.float32),
            recv[..., 2], K, S)
        merged = torch.stack([r_state, r_cost.view(torch.int32), r_arc], dim=-1)
        allr = torch.empty((Bp, K, 3), dtype=torch.int32, device=pk.device)
        dist.all_gather_into_tensor(allr, merged.contiguous(), group=self.group)
        allr = allr[:B]
        return [(allr[..., 1].contiguous().view(torch.float32), allr[..., 0],
                 allr[..., 2].contiguous())]

    def reduce_sum(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        import torch.distributed as dist

        x = xs[0].clone()
        dist.all_reduce(x, group=self.group)
        return [x]


ShardGroup = Union[InProcessShards, ProcessGroupShards]


def _expand_local(tile_ptr: torch.Tensor, tiles: torch.Tensor, lo: torch.Tensor,
                  tile_off: torch.Tensor, tok_state: torch.Tensor,
                  tok_cost: torch.Tensor, ll_t: torch.Tensor,
                  acoustic_scale: float, K: int, ET: int, S: int,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One frame of the n stacked shards of a device: tile expansion of the
    tokens each shard owns, the arcs' loglikes by one gather-kernel call,
    dedup and local top-K.  Returns (cost, state, arc) [B, n, K]."""
    n, SL1 = tile_ptr.shape
    SL = SL1 - 1
    TL = tiles.shape[0] // n
    MD = tiles.shape[1]
    B = tok_state.shape[0]
    P = ll_t.shape[1]
    E = ET * MD
    R = B * n
    dev = tok_state.device
    j = torch.arange(ET, dtype=torch.int64, device=dev)
    lane = torch.arange(MD, dtype=torch.int32, device=dev)
    shard = torch.arange(n, dtype=torch.int64, device=dev)
    # rows b-major: row b·n + i is batch row b on local shard i
    st = tok_state[:, None, :].expand(B, n, K)
    s_loc = st - lo[None, :, None]
    live = ((st >= 0) & (tok_cost[:, None, :] < BIG)
            & (s_loc >= 0) & (s_loc < SL)).reshape(R, K)
    s_idx = (s_loc.clamp(0, SL - 1) + (shard * SL1)[None, :, None]).reshape(R, K).long()
    flat_ptr = tile_ptr.reshape(-1)
    rp = flat_ptr[s_idx].long()
    deg = torch.where(live, flat_ptr[s_idx + 1].long() - rp, 0)
    cum = torch.cumsum(deg, dim=1)
    prev = cum - deg
    zero_col = torch.zeros((R, 1), dtype=torch.int64, device=dev)
    cost_bits = tok_cost.view(torch.int32).long()[:, None, :].expand(B, n, K).reshape(R, K)
    # the per-token run quantities ride one stacked scatter-add of deltas at
    # the run starts and one cumsum, as in viterbi._decode_scan_tokens
    stacked = torch.stack([torch.diff(v, dim=1, prepend=zero_col)
                           for v in (cum, rp - prev, cost_bits)], dim=1)
    scat = torch.zeros((R, 3, ET + 1), dtype=torch.int64, device=dev)
    scat.scatter_add_(2, prev.clamp(max=ET)[:, None, :].expand(R, 3, K), stacked)
    bases = torch.cumsum(scat[:, :, :ET], dim=2)  # [R, 3, ET]
    valid = j[None, :] < bases[:, 0]
    tile_loc = (bases[:, 1] + j[None, :]).clamp(0, TL - 1)  # [R, ET]
    row_shard = shard.repeat(B)[:, None]  # [R, 1]
    rows = tiles[tile_loc + row_shard * TL]  # [R, ET, MD, 3]
    base_cost = bases[:, 2].to(torch.int32).view(torch.float32)
    w_arc = rows[..., 0].reshape(R, E).view(torch.float32)
    pdf_arc = rows[..., 1].reshape(R, E)
    ns_arc = rows[..., 2].reshape(R, E)
    garc = (((tile_loc + tile_off.long()[row_shard]).to(torch.int32) * MD)[:, :, None]
            + lane).reshape(R, E)
    base_cost = base_cost[:, :, None].expand(R, ET, MD).reshape(R, E)
    valid = valid[:, :, None].expand(R, ET, MD).reshape(R, E)
    # the n shards' indices side by side: one [B, n·E] gather against the
    # frame's [B, P] rows, read in place
    ll_arc = batched_table_gather(
        ll_t, pdf_arc.clamp(max=P - 1).reshape(B, n * E)).reshape(R, E)
    valid = valid & (w_arc < BIG)  # mask tile-padding arcs
    cost = base_cost + w_arc - acoustic_scale * ll_arc
    dest = torch.where(valid, ns_arc, S)
    cost = torch.where(valid, cost.clamp(max=BIG), BIG)
    garc = torch.where(valid, garc, -1)
    l_cost, l_state, l_arc = _select(dest, cost, garc, K, S)
    return tuple(x.reshape(B, n, K) for x in (l_cost, l_state, l_arc))


def _backtrace(group: ShardGroup, dev_arrays, bp: List[Tuple[torch.Tensor, ...]],
               end_states: np.ndarray, num_frames: np.ndarray, MD: int
               ) -> np.ndarray:
    """Owner-computed backtrace over the replicated [T, B, K] backpointers:
    the shard whose tile range holds an arc's tile finds its source state by
    a search of its local tile_ptr, and a sum over the shards combines the
    answers.  Returns the [T, B] winning padded arc ids (-1 = none)."""
    T, B, _ = bp[0][0].shape
    states, nfs, arcs_out = [], [], []
    for (dev, _), (bps, _) in zip(group.local, bp):
        states.append(torch.from_numpy(np.maximum(end_states, 0).astype(np.int64)).to(dev))
        nfs.append(torch.from_numpy(num_frames).to(dev))
        arcs_out.append(torch.full((T, B), -1, dtype=torch.int32, device=dev))
    t_end = min(T, int(num_frames.max())) if B else 0
    for t in range(t_end - 1, -1, -1):
        sums = []
        for g, ((tile_ptr, _, lo, tile_off), (bps, bpa)) in enumerate(zip(dev_arrays, bp)):
            state = states[g]
            match = bps[t] == state[:, None]
            slot = match.to(torch.int32).argmax(dim=1, keepdim=True)
            found = match.gather(1, slot)[:, 0]
            arc = bpa[t].gather(1, slot)[:, 0]
            active = (t < nfs[g]) & found & (arc >= 0)
            arcs_out[g][t] = torch.where(active, arc, -1)
            tl_loc = (arc.clamp(min=0).long() // MD)[None, :] - tile_off.long()[:, None]
            # ownership by each shard's REAL tile count, not the padded TL
            local = (active[None, :] & (tl_loc >= 0)
                     & (tl_loc < tile_ptr[:, -1:].long()))
            src = torch.searchsorted(tile_ptr, tl_loc.clamp(min=0).to(torch.int32),
                                     right=True).long() - 1
            sums.append(torch.stack([
                torch.where(local, lo.long()[:, None] + src, 0).sum(dim=0),
                local.long().sum(dim=0)]))
        totals = group.reduce_sum(sums)
        for g in range(len(states)):
            states[g] = torch.where(totals[g][1] > 0, totals[g][0], states[g])
    return arcs_out[0].cpu().numpy()


def decode_batch_tokens_sharded(
    graph: Union[CsrGraph, ShardedCsrGraph],
    loglikes: Union[np.ndarray, torch.Tensor],
    num_frames: Sequence[int],
    group: Optional[ShardGroup] = None,
    opts: Optional[ViterbiOptions] = None,
    want_lattice: bool = False,
    device: DeviceLike = None,
) -> List[Optional[DecodeResult]]:
    """Graph-sharded analog of viterbi.decode_batch_tokens: the same
    result contract, the tile tables split over the group's N shards.
    Pass a prebuilt ShardedCsrGraph to amortise the shard plan.

    group=None: in-process shards, one per visible CUDA device, or one
    shard on `device` when it is given ("cpu" is taken only by name);
    without a GPU and without device="cpu" this raises.  In a process group
    every rank passes the whole batch and gets the whole result."""
    opts = opts or ViterbiOptions()
    if group is None:
        if device is None:
            resolve_device(None)
            group = InProcessShards(
                [f"cuda:{i}" for i in range(torch.cuda.device_count())])
        else:
            group = InProcessShards([device])
    N = group.size
    if isinstance(graph, ShardedCsrGraph):
        sg = graph
        if sg.num_shards != N:
            raise ValueError(
                f"shard plan has {sg.num_shards} shards, the group has {N}")
        graph = sg.graph
    else:
        sg = shard_graph(graph, N)
    if graph.eps_ns is not None:
        raise KaldiError(_SPLIT_EPS)
    B, T, _ = loglikes.shape
    S = graph.num_states
    K = max(4, min(opts.max_active, S))
    ET = shard_budget(sg, K)
    num_frames = np.asarray(num_frames, np.int32)
    scale, beam = float(opts.acoustic_scale), float(opts.beam)

    dev_arrays, lls, toks, nfs, bp = [], [], [], [], []
    for dev, ids in group.local:
        dev_arrays.append(sg.device_arrays(dev, ids))
        lls.append(torch.as_tensor(loglikes, dtype=torch.float32).to(dev).contiguous())
        ts = torch.full((B, K), -1, dtype=torch.int32, device=dev)
        ts[:, 0] = graph.start
        tc = torch.full((B, K), BIG, dtype=torch.float32, device=dev)
        tc[:, 0] = 0.0
        toks.append((ts, tc))
        nfs.append(torch.from_numpy(num_frames).to(dev))
        bp.append((torch.full((T, B, K), -1, dtype=torch.int32, device=dev),
                   torch.full((T, B, K), -1, dtype=torch.int32, device=dev),
                   torch.full((T, B, K), BIG, dtype=torch.float32, device=dev)
                   if want_lattice else None))
    t_end = min(T, int(num_frames.max())) if B else 0
    for t in range(t_end):
        cands = [_expand_local(*arrs, ts, tc, ll[:, t], scale, K, ET, S)
                 for arrs, (ts, tc), ll in zip(dev_arrays, toks, lls)]
        merged = group.merge(cands, K, S)
        for g, (new_cost, new_state, new_arc) in enumerate(merged):
            ts, tc = toks[g]
            keep = ((new_cost <= new_cost[:, :1] + beam) & (new_cost < BIG)
                    & (new_state < S))
            new_cost = torch.where(keep, new_cost, BIG)
            new_state = torch.where(keep, new_state, -1)
            new_arc = torch.where(keep, new_arc, -1)
            active = (t < nfs[g])[:, None]
            toks[g] = (torch.where(active, new_state, ts),
                       torch.where(active, new_cost, tc))
            bp[g][0][t] = torch.where(active, new_state, -1)
            bp[g][1][t] = torch.where(active, new_arc, -1)
            if want_lattice:
                bp[g][2][t] = torch.where(active, new_cost, BIG)
    tok_state_h = toks[0][0].cpu().numpy()
    tok_cost_h = toks[0][1].cpu().numpy()
    fw = np.where(np.isfinite(graph.final_weight), graph.final_weight, BIG)
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
    arcs = _backtrace(group, dev_arrays, [(s, a) for s, a, _ in bp],
                      end_states, num_frames, sg.md)
    arcs = np.where(arcs >= 0, sg.pad2orig[np.maximum(arcs, 0)], -1)
    return results_from_arcs(
        graph, arcs, end_states, use_final, costs, num_frames,
        frame_states=bp[0][0].cpu().numpy() if want_lattice else None,
        frame_costs=bp[0][2].cpu().numpy() if want_lattice else None)
