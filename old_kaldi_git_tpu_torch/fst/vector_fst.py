"""Mutable weighted FST over the tropical semiring.

Own copy of the containers of old_kaldi_git_tpu/fst/vector_fst.py (`Arc`,
`VectorFst`, `linear_fst`; reference OpenFst VectorFst<StdArc>).  Weights are
floats (tropical: plus=min, times=+, zero=inf, one=0); labels are ints with
0 = epsilon.  The graph algorithms run in the native library
(fst/native.py); these containers only carry small FSTs (L, G, H) to it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional

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
