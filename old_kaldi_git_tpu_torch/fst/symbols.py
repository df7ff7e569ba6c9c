"""Symbol tables (OpenFst SymbolTable equivalent; words.txt/phones.txt).

Own copy of old_kaldi_git_tpu/fst/symbols.py, the part the lang bundle uses.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class SymbolTable:
    def __init__(self):
        self._sym2id: Dict[str, int] = {}
        self._id2sym: Dict[int, str] = {}
        self._next = 0  # one past the largest id bound

    def __setstate__(self, state) -> None:
        # a table pickled without its counter
        self.__dict__.update(state)
        self._next = max(self._id2sym, default=-1) + 1

    @staticmethod
    def with_eps(eps: str = "<eps>") -> "SymbolTable":
        t = SymbolTable()
        t.add(eps, 0)
        return t

    def add(self, sym: str, idx: Optional[int] = None) -> int:
        if sym in self._sym2id:
            return self._sym2id[sym]
        if idx is None:
            idx = self._next
        if idx in self._id2sym:
            raise ValueError(f"id {idx} already bound to {self._id2sym[idx]!r}")
        self._sym2id[sym] = idx
        self._id2sym[idx] = sym
        self._next = max(self._next, idx + 1)
        return idx

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._sym2id[key]
        return self._id2sym[key]

    def __contains__(self, key) -> bool:
        return key in (self._sym2id if isinstance(key, str) else self._id2sym)

    def symbols(self) -> List[str]:
        return [self._id2sym[i] for i in sorted(self._id2sym)]

    def ids(self) -> List[int]:
        return sorted(self._id2sym)
