"""Mutable weighted FST over the tropical semiring.

Own copy of the containers of old_kaldi_git_tpu/fst/vector_fst.py (`Arc`,
`VectorFst`, `linear_fst`; reference OpenFst VectorFst<StdArc>).  Weights are
floats (tropical: plus=min, times=+, zero=inf, one=0); labels are ints with
0 = epsilon.  The graph algorithms run in the native library
(fst/native.py); these containers carry FSTs (L, G, H, the chain phone
LM) to it, and `connect` trims a G or a phone LM built here.

On disk an FST is the framework's OKTFST01 record (`write` / `read`, byte
for byte the JAX package's).  `write_arrays` / `read_arrays` move the same
bytes to and from the flat arrays of `NativeFst.to_raw_arrays`, so a
million-state HCLG crosses the disk without one Python object per arc.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import BinaryIO, Dict, Iterable, List, Optional, Tuple

import numpy as np

INF = math.inf
NO_STATE = -1
EPS = 0


@dataclasses.dataclass
class Arc:
    ilabel: int
    olabel: int
    weight: float
    nextstate: int

    def copy(self) -> "Arc":
        return Arc(self.ilabel, self.olabel, self.weight, self.nextstate)


class VectorFst:
    def __init__(self):
        self.arcs: List[List[Arc]] = []
        self.finals: List[float] = []  # INF = not final
        self.start: int = NO_STATE

    def add_state(self) -> int:
        self.arcs.append([])
        self.finals.append(INF)
        return len(self.arcs) - 1

    def add_arc(self, state: int, arc: Arc) -> None:
        self.arcs[state].append(arc)

    def set_start(self, s: int) -> None:
        self.start = s

    def set_final(self, s: int, weight: float = 0.0) -> None:
        self.finals[s] = weight

    def is_final(self, s: int) -> bool:
        return self.finals[s] != INF

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def states(self) -> Iterable[int]:
        return range(len(self.arcs))

    def arcsort(self, sort_type: str = "ilabel") -> None:
        key = (lambda a: (a.ilabel, a.olabel)) if sort_type == "ilabel" else (
            lambda a: (a.olabel, a.ilabel))
        for lst in self.arcs:
            lst.sort(key=key)

    def copy(self) -> "VectorFst":
        out = VectorFst()
        out.start = self.start
        out.finals = list(self.finals)
        out.arcs = [[a.copy() for a in lst] for lst in self.arcs]
        return out

    def connect(self) -> None:
        """Trim states not both accessible and coaccessible (OpenFst
        Connect), keeping the survivors' order; `last_connect_map` maps old
        state ids to new ones, for callers tracking per-state metadata."""
        if self.start == NO_STATE:
            self.arcs, self.finals = [], []
            return
        n = self.num_states
        acc = [False] * n
        acc[self.start] = True
        stack = [self.start]
        while stack:
            s = stack.pop()
            for a in self.arcs[s]:
                if not acc[a.nextstate]:
                    acc[a.nextstate] = True
                    stack.append(a.nextstate)
        rev: List[List[int]] = [[] for _ in range(n)]
        for s in range(n):
            for a in self.arcs[s]:
                rev[a.nextstate].append(s)
        coacc = [self.is_final(s) for s in range(n)]
        stack = [s for s in range(n) if coacc[s]]
        while stack:
            s = stack.pop()
            for src in rev[s]:
                if not coacc[src]:
                    coacc[src] = True
                    stack.append(src)
        keep = [s for s in range(n) if acc[s] and coacc[s]]
        remap: Dict[int, int] = {old: new for new, old in enumerate(keep)}
        self.arcs = [[Arc(a.ilabel, a.olabel, a.weight, remap[a.nextstate])
                      for a in self.arcs[old] if a.nextstate in remap] for old in keep]
        self.finals = [self.finals[old] for old in keep]
        self.start = remap.get(self.start, NO_STATE)
        self.last_connect_map = remap

    # -- text (OpenFst-compatible) and OKTFST01 binary I/O ---------------------
    def to_text(self) -> str:
        if self.start == NO_STATE:
            return ""
        lines = []
        for s in [self.start] + [s for s in self.states() if s != self.start]:
            for a in self.arcs[s]:
                w = f"\t{a.weight:g}" if a.weight != 0.0 else ""
                lines.append(f"{s}\t{a.nextstate}\t{a.ilabel}\t{a.olabel}{w}")
            if self.is_final(s):
                w = f"\t{self.finals[s]:g}" if self.finals[s] != 0.0 else ""
                lines.append(f"{s}{w}")
        return "\n".join(lines) + "\n"

    def to_arrays(self) -> Tuple:
        """(start, row_ptr, ilabels, olabels, weights, nextstates, finals):
        the layout of NativeFst.to_raw_arrays."""
        counts = np.fromiter((len(a) for a in self.arcs), np.int64, self.num_states)
        row_ptr = np.zeros(self.num_states + 1, np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        flat = [a for lst in self.arcs for a in lst]
        il = np.fromiter((a.ilabel for a in flat), np.int32, len(flat))
        ol = np.fromiter((a.olabel for a in flat), np.int32, len(flat))
        w = np.fromiter((a.weight for a in flat), np.float32, len(flat))
        ns = np.fromiter((a.nextstate for a in flat), np.int32, len(flat))
        finals = np.asarray(self.finals, np.float32)
        return self.start, row_ptr, il, ol, w, ns, finals

    @staticmethod
    def from_arrays(start: int, row_ptr, il, ol, w, ns, finals) -> "VectorFst":
        fst = VectorFst()
        fst.start = int(start)
        fst.finals = np.asarray(finals, np.float32).tolist()
        il, ol, w, ns = (np.asarray(a).tolist() for a in (il, ol, w, ns))
        arcs = [Arc(*t) for t in zip(il, ol, w, ns)]
        rp = np.asarray(row_ptr, np.int64).tolist()
        fst.arcs = [arcs[rp[s]: rp[s + 1]] for s in range(len(rp) - 1)]
        return fst

    def write(self, f: BinaryIO) -> None:
        """The OKTFST01 record (the JAX package's VectorFst.write)."""
        write_arrays(f, *self.to_arrays())

    @staticmethod
    def read(f: BinaryIO) -> "VectorFst":
        return VectorFst.from_arrays(*read_arrays(f))


OKTFST_MAGIC = b"OKTFST01"


def write_arrays(f: BinaryIO, start: int, row_ptr, il, ol, w, ns, finals) -> None:
    """OKTFST01: magic, <i start, <q states, <i arcs, then finals (<f4, inf
    = not final), arc counts per state (<i4), ilabels, olabels (<i4),
    weights (<f4) and next states (<i4)."""
    row_ptr = np.asarray(row_ptr, np.int64)
    n, a = len(row_ptr) - 1, int(row_ptr[-1])
    f.write(OKTFST_MAGIC)
    f.write(struct.pack("<iqi", int(start), n, a))
    f.write(np.asarray(finals, "<f4").tobytes())
    f.write(np.diff(row_ptr).astype("<i4").tobytes())
    if a:
        for arr, dt in ((il, "<i4"), (ol, "<i4"), (w, "<f4"), (ns, "<i4")):
            f.write(np.asarray(arr).astype(dt).tobytes())


def read_arrays(f: BinaryIO) -> Tuple:
    """The arrays of an OKTFST01 record, each filled by one np.frombuffer:
    (start, row_ptr int64, ilabels, olabels, weights, nextstates, finals)."""
    magic = f.read(8)
    if magic != OKTFST_MAGIC:
        raise ValueError(f"bad FST magic {magic!r}")
    start, n, a = struct.unpack("<iqi", f.read(16))
    finals = np.frombuffer(f.read(4 * n), "<f4").astype(np.float32)
    counts = np.frombuffer(f.read(4 * n), "<i4")
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    il, ol, w, ns = (np.frombuffer(f.read(4 * a), dt).astype(t) for dt, t in (
        ("<i4", np.int32), ("<i4", np.int32), ("<f4", np.float32), ("<i4", np.int32)))
    return start, row_ptr, il, ol, w, ns, finals


def linear_fst(labels: List[int], olabels: Optional[List[int]] = None) -> VectorFst:
    """Linear acceptor/transducer through `labels` (MakeLinearAcceptor)."""
    olabels = olabels if olabels is not None else labels
    fst = VectorFst()
    cur = fst.add_state()
    fst.set_start(cur)
    for il, ol in zip(labels, olabels):
        nxt = fst.add_state()
        fst.add_arc(cur, Arc(il, ol, 0.0, nxt))
        cur = nxt
    fst.set_final(cur, 0.0)
    return fst
