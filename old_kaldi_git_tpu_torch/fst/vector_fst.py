"""Mutable weighted FST over the tropical semiring.

Own copy of the containers of old_kaldi_git_tpu/fst/vector_fst.py (`Arc`,
`VectorFst`, `linear_fst`; reference OpenFst VectorFst<StdArc>).  Weights are
floats (tropical: plus=min, times=+, zero=inf, one=0); labels are ints with
0 = epsilon.  The graph algorithms run in the native library
(fst/native.py); these containers carry FSTs (L, G, H, the chain phone
LM) to it, and `connect` trims a G or a phone LM built here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional

INF = math.inf
NO_STATE = -1
EPS = 0


@dataclasses.dataclass
class Arc:
    ilabel: int
    olabel: int
    weight: float
    nextstate: int


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
