"""Upstream OpenFst/Kaldi binary FST formats (counterpart of
old_kaldi_git_tpu/fst/kaldi_fst_io.py: files byte-equal to its writers').

Reference parity: src/fstext/kaldi-fst-io.{h,cc} (ReadFstKaldi /
WriteFstKaldi over OpenFst VectorFst<StdArc> — the on-disk HCLG.fst /
L.fst / G.fst layout) and src/lat/kaldi-lattice.cc (CompactLattice ark
cells: VectorFst over CompactLatticeWeightTpl<LatticeWeightTpl<float>,
int32>, arc type "compactlattice44").

Byte layout (OpenFst FstHeader + VectorFst body, little-endian):

  header:  int32 magic 2125659606 ("\\xd6\\xfd\\xb2~")
           string fsttype  (int32 len + bytes, "vector")
           string arctype  (int32 len + bytes, "standard"/"compactlattice44")
           int32 version (2)   int32 flags (0: no symbol tables)
           uint64 properties   int64 start
           int64 numstates     int64 numarcs
  state:   <final weight>  int64 narcs
  arc:     int32 ilabel  int32 olabel  <weight>  int32 nextstate

  StdArc weight            = float32 (tropical; +inf = Zero/nonfinal)
  CompactLattice weight    = float32 graph, float32 acoustic,
                             int64 n, n * int32 transition-ids
                             (LatticeWeightTpl::Write then
                              WriteType(vector<int32>) — lattice-weight.h)

Standalone graph files (HCLG.fst) are the bare header+body; ark cells
("kfst"/"kclat" holders) are framed `key <space> \\0B <body>` exactly like
upstream lattice archives (kaldi-holder + InitKaldiOutputStream).

Host code."""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

from old_kaldi_git_tpu_torch.fst.vector_fst import INF, NO_STATE, Arc, VectorFst
from old_kaldi_git_tpu_torch.lat.determinize import (
    CompactLattice,
    CompactLatticeArc,
)
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("kaldi-fst-io")

FST_MAGIC = 2125659606
_MIN_VERSION = 2


def _write_string(f: BinaryIO, s: str) -> None:
    b = s.encode()
    f.write(struct.pack("<i", len(b)))
    f.write(b)


def _read_string(f: BinaryIO) -> str:
    (n,) = struct.unpack("<i", f.read(4))
    if n < 0 or n > 10_000:
        raise KaldiError(f"bad string length {n} in FST header")
    return f.read(n).decode()


def _write_header(f: BinaryIO, arctype: str, start: int, numstates: int,
                  numarcs: int) -> None:
    f.write(struct.pack("<i", FST_MAGIC))
    _write_string(f, "vector")
    _write_string(f, arctype)
    f.write(struct.pack("<i", _MIN_VERSION))  # version
    f.write(struct.pack("<i", 0))             # flags: no symbol tables
    f.write(struct.pack("<Q", 3))             # properties: expanded|mutable
    f.write(struct.pack("<q", start if start != NO_STATE else -1))
    f.write(struct.pack("<q", numstates))
    f.write(struct.pack("<q", numarcs))


def _read_header(f: BinaryIO, want_arctype: str):
    raw = f.read(4)
    if len(raw) < 4 or struct.unpack("<i", raw)[0] != FST_MAGIC:
        raise KaldiError("not an OpenFst binary file (bad magic)")
    fsttype = _read_string(f)
    arctype = _read_string(f)
    if fsttype != "vector":
        raise KaldiError(f"unsupported fst type {fsttype!r} (want vector)")
    if arctype != want_arctype:
        raise KaldiError(
            f"unexpected arc type {arctype!r} (want {want_arctype!r})")
    version, flags = struct.unpack("<ii", f.read(8))
    if version < _MIN_VERSION:
        raise KaldiError(f"unsupported VectorFst file version {version}")
    (_props,) = struct.unpack("<Q", f.read(8))
    if flags & 0x1 or flags & 0x2:
        raise KaldiError(
            "embedded symbol tables are not supported (Kaldi graphs are "
            "written without them)")
    start, numstates, numarcs = struct.unpack("<qqq", f.read(24))
    return start, numstates, numarcs


# ---------------------------------------------------------------------------
# StdArc (tropical) — HCLG.fst / L.fst / G.fst
# ---------------------------------------------------------------------------

def write_fst_kaldi(f: BinaryIO, fst: VectorFst) -> None:
    """VectorFst<StdArc> binary, as WriteFstKaldi writes HCLG.fst."""
    numarcs = sum(len(a) for a in fst.arcs)
    _write_header(f, "standard", fst.start, fst.num_states, numarcs)
    for s in range(fst.num_states):
        w = fst.finals[s]
        f.write(struct.pack("<f", np.float32(np.inf) if w == INF else w))
        f.write(struct.pack("<q", len(fst.arcs[s])))
        if fst.arcs[s]:
            rows = np.empty((len(fst.arcs[s]), 4), "<u4")
            il = np.asarray([a.ilabel for a in fst.arcs[s]], "<i4")
            ol = np.asarray([a.olabel for a in fst.arcs[s]], "<i4")
            wt = np.asarray([a.weight for a in fst.arcs[s]], "<f4")
            ns = np.asarray([a.nextstate for a in fst.arcs[s]], "<i4")
            rows[:, 0] = il.view("<u4")
            rows[:, 1] = ol.view("<u4")
            rows[:, 2] = wt.view("<u4")
            rows[:, 3] = ns.view("<u4")
            f.write(rows.tobytes())


def read_fst_kaldi(f: BinaryIO) -> VectorFst:
    start, numstates, _numarcs = _read_header(f, "standard")
    fst = VectorFst()
    for _ in range(numstates):
        fst.add_state()
    if start >= 0:
        fst.set_start(int(start))
    for s in range(numstates):
        (w,) = struct.unpack("<f", f.read(4))
        if np.isfinite(w):
            fst.set_final(s, float(w))
        (narcs,) = struct.unpack("<q", f.read(8))
        if narcs:
            raw = np.frombuffer(f.read(16 * narcs), "<u4").reshape(narcs, 4)
            il = raw[:, 0].view("<i4")
            ol = raw[:, 1].view("<i4")
            wt = raw[:, 2].view("<f4")
            ns = raw[:, 3].view("<i4")
            for i in range(narcs):
                fst.add_arc(s, Arc(int(il[i]), int(ol[i]), float(wt[i]),
                                   int(ns[i])))
    return fst


def write_fst_kaldi_arrays(f: BinaryIO, start: int, row_ptr: np.ndarray,
                           il: np.ndarray, ol: np.ndarray, w: np.ndarray,
                           ns: np.ndarray, finals: np.ndarray) -> None:
    """VectorFst<StdArc> bytes straight from raw CSR-style arrays — same
    layout as write_fst_kaldi, but fully vectorized (one interleaved
    numpy buffer, no per-arc Python objects), so million-state HCLGs
    export in seconds.  finals: float32, +inf = non-final."""
    S = len(row_ptr) - 1
    A = int(row_ptr[-1])
    _write_header(f, "standard", int(start), S, A)
    deg = np.diff(row_ptr).astype(np.int64)
    # per-state record: f4 final, i8 narcs, then narcs * (i4 i4 f4 i4).
    # Interleave with byte-level assembly: build one buffer of
    # 12*S + 16*A bytes via offsets.
    state_off = 12 * np.arange(S, dtype=np.int64) + 16 * row_ptr[:-1].astype(
        np.int64)
    total = 12 * S + 16 * A
    buf = np.zeros(total, np.uint8)
    fin = np.where(np.isfinite(finals), finals, np.inf).astype("<f4")
    # state headers
    hdr = np.zeros((S, 12), np.uint8)
    hdr[:, 0:4] = fin.view(np.uint8).reshape(S, 4)
    hdr[:, 4:12] = deg.astype("<i8").view(np.uint8).reshape(S, 8)
    idx = (state_off[:, None] + np.arange(12)[None, :]).reshape(-1)
    buf[idx] = hdr.reshape(-1)
    # arcs
    rows = np.empty((A, 4), "<u4")
    rows[:, 0] = il.astype("<i4").view("<u4")
    rows[:, 1] = ol.astype("<i4").view("<u4")
    rows[:, 2] = w.astype("<f4").view("<u4")
    rows[:, 3] = ns.astype("<i4").view("<u4")
    arc_off = (np.repeat(state_off + 12, deg)
               + 16 * (np.arange(A) - np.repeat(row_ptr[:-1].astype(np.int64),
                                                deg)))
    aidx = (arc_off[:, None] + np.arange(16)[None, :]).reshape(-1)
    buf[aidx] = rows.view(np.uint8).reshape(-1)
    f.write(buf.tobytes())


def read_fst_kaldi_arrays(f: BinaryIO):
    """Inverse of write_fst_kaldi_arrays: (start, row_ptr, il, ol, w, ns,
    finals) without building Python arc objects."""
    start, numstates, numarcs = _read_header(f, "standard")
    raw = np.frombuffer(f.read(12 * numstates + 16 * numarcs), np.uint8)
    finals = np.zeros(numstates, np.float32)
    row_ptr = np.zeros(numstates + 1, np.int64)
    il = np.zeros(numarcs, np.int32)
    ol = np.zeros(numarcs, np.int32)
    w = np.zeros(numarcs, np.float32)
    ns = np.zeros(numarcs, np.int32)
    pos = 0
    a = 0
    for s in range(numstates):
        finals[s] = raw[pos:pos + 4].view("<f4")[0]
        narcs = int(raw[pos + 4:pos + 12].view("<i8")[0])
        pos += 12
        if narcs:
            rows = raw[pos:pos + 16 * narcs].view("<u4").reshape(narcs, 4)
            il[a:a + narcs] = rows[:, 0].view("<i4")
            ol[a:a + narcs] = rows[:, 1].view("<i4")
            w[a:a + narcs] = rows[:, 2].view("<f4")
            ns[a:a + narcs] = rows[:, 3].view("<i4")
            pos += 16 * narcs
            a += narcs
        row_ptr[s + 1] = a
    return int(start), row_ptr, il, ol, w, ns, finals


def write_fst_kaldi_file(path: str, fst: VectorFst) -> None:
    with open(path, "wb") as f:
        write_fst_kaldi(f, fst)


def read_fst_kaldi_file(path: str) -> VectorFst:
    with open(path, "rb") as f:
        return read_fst_kaldi(f)


# ---------------------------------------------------------------------------
# CompactLattice ("compactlattice44") — lattice ark cells
# ---------------------------------------------------------------------------

def _write_clat_weight(f: BinaryIO, graph: float, acoustic: float,
                       tids) -> None:
    g = graph if np.isfinite(graph) else np.inf
    a = acoustic if np.isfinite(acoustic) else np.inf
    f.write(struct.pack("<ff", g, a))
    tids = list(tids)
    f.write(struct.pack("<q", len(tids)))
    if tids:
        f.write(np.asarray(tids, "<i4").tobytes())


def _read_clat_weight(f: BinaryIO):
    graph, acoustic = struct.unpack("<ff", f.read(8))
    (n,) = struct.unpack("<q", f.read(8))
    if n < 0 or n > 100_000_000:
        raise KaldiError(f"bad tid-string length {n} in lattice weight")
    tids = np.frombuffer(f.read(4 * n), "<i4").tolist() if n else []
    return float(graph), float(acoustic), tids


def write_compact_lattice_kaldi(f: BinaryIO, clat: CompactLattice) -> None:
    """VectorFst<CompactLatticeArc> binary (kaldi-lattice.cc
    WriteCompactLattice, binary branch)."""
    numarcs = sum(len(a) for a in clat.arcs)
    _write_header(f, "compactlattice44", clat.start, clat.num_states,
                  numarcs)
    for s in range(clat.num_states):
        g, ac, tids = clat.finals[s]
        if g == INF or not np.isfinite(g):
            _write_clat_weight(f, np.inf, np.inf, [])
        else:
            _write_clat_weight(f, g, ac, tids)
        f.write(struct.pack("<q", len(clat.arcs[s])))
        for a in clat.arcs[s]:
            # acceptor: ilabel == olabel == word id
            f.write(struct.pack("<ii", a.word, a.word))
            _write_clat_weight(f, a.graph_cost, a.acoustic_cost, a.tids)
            f.write(struct.pack("<i", a.nextstate))


def read_compact_lattice_kaldi(f: BinaryIO) -> CompactLattice:
    start, numstates, _numarcs = _read_header(f, "compactlattice44")
    clat = CompactLattice()
    for _ in range(numstates):
        clat.add_state()
    clat.start = int(start) if start >= 0 else 0
    for s in range(numstates):
        g, ac, tids = _read_clat_weight(f)
        if np.isfinite(g):
            clat.finals[s] = (g, ac, tuple(tids))
        (narcs,) = struct.unpack("<q", f.read(8))
        for _ in range(narcs):
            il, ol = struct.unpack("<ii", f.read(8))
            if il != ol:
                raise KaldiError(
                    f"CompactLattice cell is not an acceptor ({il} != {ol})")
            g, ac, tids = _read_clat_weight(f)
            (ns,) = struct.unpack("<i", f.read(4))
            clat.arcs[s].append(
                CompactLatticeArc(il, g, ac, tuple(tids), ns))
    return clat


# ---------------------------------------------------------------------------
# ark holders with upstream framing (`key \0B <openfst binary>`)
# ---------------------------------------------------------------------------

def _register_holders() -> None:
    from old_kaldi_git_tpu_torch.utils.table import Holder, register_holder

    class KaldiFstHolder(Holder):
        """Upstream-framed StdArc FST ark cells (fstbin archives)."""

        def write(self, f, value: VectorFst, binary: bool) -> None:
            if not binary:
                raise KaldiError("kfst holder is binary-only")
            f.write(b"\x00B")
            write_fst_kaldi(f, value)

        def read(self, f) -> VectorFst:
            if f.read(2) != b"\x00B":
                raise KaldiError("kfst cell: expected binary marker \\0B")
            return read_fst_kaldi(f)

    class KaldiCompactLatticeHolder(Holder):
        """Upstream-framed CompactLattice ark cells (lat.*.gz contents)."""

        def write(self, f, value: CompactLattice, binary: bool) -> None:
            if not binary:
                raise KaldiError("kclat holder is binary-only")
            f.write(b"\x00B")
            write_compact_lattice_kaldi(f, value)

        def read(self, f) -> CompactLattice:
            if f.read(2) != b"\x00B":
                raise KaldiError("kclat cell: expected binary marker \\0B")
            return read_compact_lattice_kaldi(f)

    register_holder("kfst", KaldiFstHolder)
    register_holder("kclat", KaldiCompactLatticeHolder)


_register_holders()
