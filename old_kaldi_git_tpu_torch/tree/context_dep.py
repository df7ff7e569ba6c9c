"""ContextDependency: the phone-context → pdf-id mapping.

Own copy of old_kaldi_git_tpu/tree/context_dep.py.  `write` / `read` use
the JAX package's token format (CE / TE / SE event maps), so that a tree
written by either package reads in the other; the committed `tree.pkl`
reads through convert.context_dependency_from_pickle.

Parity with reference src/tree/context-dep.h: wraps (N, P, EventMap root).
compute(phone_window, pdf_class) → pdf-id; get_pdf_info enumerates which
(phone, pdf_class) pairs can reach each pdf (needed by the TransitionModel).
"""

from __future__ import annotations

from typing import BinaryIO, Dict, List, Optional, Sequence, Set, Tuple

from old_kaldi_git_tpu_torch.tree.event_map import (
    KEY_PDF_CLASS,
    ConstantEventMap,
    EventMap,
    SplitEventMap,
    TableEventMap,
    make_event,
)
from old_kaldi_git_tpu_torch.utils import io_funcs as iof
from old_kaldi_git_tpu_torch.utils.log import KaldiError


class ContextDependency:
    def __init__(self, N: int, P: int, root: EventMap):
        self.N = N  # context width (1 = mono, 3 = triphone)
        self.P = P  # central position (0-based)
        self.root = root

    @property
    def num_pdfs(self) -> int:
        return self.root.max_result() + 1

    def compute(self, phone_window: Sequence[int], pdf_class: int) -> Optional[int]:
        """phone_window has length N; position P is the phone being modeled.
        Out-of-utterance context positions hold 0 (epsilon)."""
        if len(phone_window) != self.N:
            raise KaldiError(f"context window must have {self.N} phones")
        pairs = [(KEY_PDF_CLASS, pdf_class)] + [
            (i, p) for i, p in enumerate(phone_window)
        ]
        ans = self.root.map(make_event(pairs))
        if ans is None:
            raise KaldiError(
                f"tree has no answer for window {list(phone_window)} "
                f"pdf-class {pdf_class}"
            )
        return ans

    def get_pdf_info(
        self, phones: Sequence[int], num_pdf_classes: Dict[int, int]
    ) -> List[Set[Tuple[int, int]]]:
        """For each pdf-id, the set of (central phone, pdf_class) pairs that can
        reach it (reference ContextDependency::GetPdfInfo)."""
        info: List[Set[Tuple[int, int]]] = [set() for _ in range(self.num_pdfs)]
        phone_set = set(phones)
        ctx_values = phone_set | {0}
        for phone in phones:
            for pdf_class in range(num_pdf_classes[phone]):
                event_sets = {KEY_PDF_CLASS: {pdf_class}}
                for pos in range(self.N):
                    event_sets[pos] = {phone} if pos == self.P else ctx_values
                for pdf in self.root.multi_map(event_sets):
                    info[pdf].add((phone, pdf_class))
        return info

    def write(self, f: BinaryIO) -> None:
        """<ContextDependency> N P, the event map, </ContextDependency>."""
        iof.write_token(f, "<ContextDependency>")
        iof.write_int32(f, self.N)
        iof.write_int32(f, self.P)
        _write_event_map(f, self.root)
        iof.write_token(f, "</ContextDependency>")

    @staticmethod
    def read(f: BinaryIO) -> "ContextDependency":
        iof.expect_token(f, "<ContextDependency>")
        N = iof.read_int32(f)
        P = iof.read_int32(f)
        root = _read_event_map(f)
        iof.expect_token(f, "</ContextDependency>")
        return ContextDependency(N, P, root)


def _write_event_map(f: BinaryIO, em: EventMap) -> None:
    """CE answer | TE key n (value, map)*n in value order | SE key
    yes-set yes no."""
    if isinstance(em, ConstantEventMap):
        iof.write_token(f, "CE")
        iof.write_int32(f, em.answer)
    elif isinstance(em, TableEventMap):
        iof.write_token(f, "TE")
        iof.write_int32(f, em.key)
        iof.write_int32(f, len(em.table))
        for v in sorted(em.table):
            iof.write_int32(f, v)
            _write_event_map(f, em.table[v])
    elif isinstance(em, SplitEventMap):
        iof.write_token(f, "SE")
        iof.write_int32(f, em.key)
        iof.write_int_vector(f, sorted(em.yes_set))
        _write_event_map(f, em.yes)
        _write_event_map(f, em.no)
    else:
        raise KaldiError(f"unknown EventMap type {type(em)}")


def _read_event_map(f: BinaryIO) -> EventMap:
    tok = iof.read_token(f)
    if tok == "CE":
        return ConstantEventMap(iof.read_int32(f))
    if tok == "TE":
        key = iof.read_int32(f)
        table = {}
        for _ in range(iof.read_int32(f)):
            v = iof.read_int32(f)
            table[v] = _read_event_map(f)
        return TableEventMap(key, table)
    if tok == "SE":
        key = iof.read_int32(f)
        yes_set = [int(x) for x in iof.read_int_vector(f)]
        yes = _read_event_map(f)
        return SplitEventMap(key, yes_set, yes, _read_event_map(f))
    raise KaldiError(f"unknown EventMap token {tok!r}")


def monophone_context_dependency(
    phones: Sequence[int], num_pdf_classes: Dict[int, int]
) -> ContextDependency:
    """Trivial tree: each (phone, pdf_class) gets its own pdf
    (reference MonophoneContextDependency, gmm-init-mono)."""
    table: Dict[int, EventMap] = {}
    pdf = 0
    for phone in sorted(phones):
        sub: Dict[int, EventMap] = {}
        for pc in range(num_pdf_classes[phone]):
            sub[pc] = ConstantEventMap(pdf)
            pdf += 1
        table[phone] = TableEventMap(KEY_PDF_CLASS, sub)
    return ContextDependency(1, 0, TableEventMap(0, table))


def biphone_context_dependency(
    phones: Sequence[int], num_pdf_classes: Dict[int, int]
) -> ContextDependency:
    """Full (unclustered) left-biphone tree: every (left phone or eps,
    centre phone, pdf-class) gets its own pdf (reference gmm-init-biphone,
    the flat-start chain tree, built without alignment statistics)."""
    lefts = [0] + sorted(phones)  # 0 = utterance-initial (eps) context
    table: Dict[int, EventMap] = {}
    pdf = 0
    for phone in sorted(phones):
        by_left: Dict[int, EventMap] = {}
        for left in lefts:
            sub: Dict[int, EventMap] = {}
            for pc in range(num_pdf_classes[phone]):
                sub[pc] = ConstantEventMap(pdf)
                pdf += 1
            by_left[left] = TableEventMap(KEY_PDF_CLASS, sub)
        table[phone] = TableEventMap(0, by_left)  # key 0 = left position
    return ContextDependency(2, 1, TableEventMap(1, table))


def _map_key(node: EventMap) -> tuple:
    if isinstance(node, ConstantEventMap):
        return ("C", node.answer)
    if isinstance(node, TableEventMap):
        return ("T", node.key, tuple((v, _map_key(c)) for v, c in sorted(node.table.items())))
    if isinstance(node, SplitEventMap):
        return ("S", node.key, tuple(sorted(node.yes_set)), _map_key(node.yes),
                _map_key(node.no))
    raise TypeError(f"unknown event map {node!r}")


def tree_key(ctx_dep: ContextDependency) -> tuple:
    """A hashable form of a tree (its width, central position and every
    node): two trees map every event alike when their keys are equal."""
    return (ctx_dep.N, ctx_dep.P, _map_key(ctx_dep.root))
