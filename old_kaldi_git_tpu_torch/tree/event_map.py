"""EventMap: polymorphic (key → value) decision maps.

Own copy of old_kaldi_git_tpu/tree/event_map.py.

Parity with reference src/tree/event-map.h: an *event* is a sorted list of
(key, value) pairs; keys are context positions 0..N-1 (value = phone id) and
key -1 = kPdfClass (value = pdf-class within the HMM).  EventMap.map(event)
answers the pdf-id.  Three node kinds: Constant (leaf), Table (switch on one
key), Split (binary split on a value set of one key).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Optional, Sequence, Tuple

KEY_PDF_CLASS = -1

Event = Tuple[Tuple[int, int], ...]  # sorted ((key, value), ...)


def make_event(pairs: Sequence[Tuple[int, int]]) -> Event:
    return tuple(sorted(pairs))


def event_lookup(event: Event, key: int) -> Optional[int]:
    for k, v in event:
        if k == key:
            return v
    return None


class EventMap:
    def map(self, event: Event) -> Optional[int]:
        raise NotImplementedError

    def multi_map(self, event_sets) -> set:
        """All answers reachable given per-key value sets (dict key→set).
        Used by GetPdfInfo-style enumeration."""
        raise NotImplementedError

    def max_result(self) -> int:
        raise NotImplementedError


class ConstantEventMap(EventMap):
    def __init__(self, answer: int):
        self.answer = answer

    def map(self, event: Event) -> int:
        return self.answer

    def multi_map(self, event_sets) -> set:
        return {self.answer}

    def max_result(self) -> int:
        return self.answer

    def __repr__(self):
        return f"CE({self.answer})"


class TableEventMap(EventMap):
    def __init__(self, key: int, table: Dict[int, EventMap]):
        self.key = key
        self.table = table

    def map(self, event: Event) -> Optional[int]:
        v = event_lookup(event, self.key)
        if v is None or v not in self.table:
            return None
        return self.table[v].map(event)

    def multi_map(self, event_sets) -> set:
        values = event_sets.get(self.key)
        out = set()
        for v, child in self.table.items():
            if values is None or v in values:
                out |= child.multi_map(event_sets)
        return out

    def max_result(self) -> int:
        return max((c.max_result() for c in self.table.values()), default=-1)

    def __repr__(self):
        return f"TE(key={self.key}, {len(self.table)} children)"


class SplitEventMap(EventMap):
    def __init__(self, key: int, yes_set, yes: EventMap, no: EventMap):
        self.key = key
        self.yes_set: FrozenSet[int] = frozenset(yes_set)
        self.yes = yes
        self.no = no

    def map(self, event: Event) -> Optional[int]:
        v = event_lookup(event, self.key)
        if v is None:
            return None
        return (self.yes if v in self.yes_set else self.no).map(event)

    def multi_map(self, event_sets) -> set:
        values = event_sets.get(self.key)
        out = set()
        if values is None:
            return self.yes.multi_map(event_sets) | self.no.multi_map(event_sets)
        if any(v in self.yes_set for v in values):
            out |= self.yes.multi_map(
                {**event_sets, self.key: {v for v in values if v in self.yes_set}}
            )
        if any(v not in self.yes_set for v in values):
            out |= self.no.multi_map(
                {**event_sets, self.key: {v for v in values if v not in self.yes_set}}
            )
        return out

    def max_result(self) -> int:
        return max(self.yes.max_result(), self.no.max_result())

    def __repr__(self):
        return f"SE(key={self.key}, |yes|={len(self.yes_set)})"
