"""CSR arc-tensor form of a decoding graph (own numpy copy of the parts of
old_kaldi_git_tpu/decoder/csr.py that the decoder reads).

The decoder consumes graphs as CSR arrays whose epsilon arcs were eliminated
up front by forwarding: every state's outgoing arc set is
{ eps-closure ∘ emitting arc }, with closure weights folded in and the
closure's output labels remembered on the host for word recovery.  This
module holds the container, the flat output-label store, the per-state tile
layout and the conversion from a native FST handle (`fst_to_csr_native`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.utils.log import get_logger

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
