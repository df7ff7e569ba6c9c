"""HMM topologies (own copy of the parts of old_kaldi_git_tpu/hmm/topology.py
that TransitionModel's reader and writer and the graph compiler use).

Parity with reference src/hmm/hmm-topology.h: per-phone state lists, each
state a pdf-class and (next-state, prob) transitions; the last state is
non-emitting; the default Kaldi topology (3-state Bakis for speech phones,
5-state left-to-right for silence).  Binary layout of HmmTopology::Write
(old-Kaldi vintage, one pdf-class per state).
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO, Dict, List, Sequence, Tuple

from old_kaldi_git_tpu_torch.utils import io_funcs as iof
from old_kaldi_git_tpu_torch.utils.log import KaldiError

NO_PDF = -1


@dataclasses.dataclass
class HmmState:
    pdf_class: int  # NO_PDF for non-emitting
    transitions: List[Tuple[int, float]]  # (next hmm-state, prob)


class HmmTopology:
    def __init__(self, entries: Dict[int, List[HmmState]]):
        self._entries = entries  # phone → states

    @staticmethod
    def standard(phones: Sequence[int], silence_phones: Sequence[int] = (),
                 num_states: int = 3, sil_num_states: int = 5) -> "HmmTopology":
        """Default Kaldi topology: `num_states`-state Bakis chain
        (self-loop 0.75 / forward 0.25) for speech phones; a
        `sil_num_states` left-to-right topology with skips for silence."""
        sil = set(silence_phones)
        bakis = _bakis_entry(num_states)
        sil_entry = _silence_entry(sil_num_states)
        return HmmTopology({p: sil_entry if p in sil else bakis for p in phones})

    @property
    def phones(self) -> List[int]:
        return sorted(self._entries)

    def topology_for_phone(self, phone: int) -> List[HmmState]:
        if phone not in self._entries:
            raise KaldiError(f"no topology entry for phone {phone}")
        return self._entries[phone]

    def num_pdf_classes(self, phone: int) -> int:
        return 1 + max(s.pdf_class for s in self.topology_for_phone(phone)
                       if s.pdf_class != NO_PDF)

    @staticmethod
    def read(f: BinaryIO) -> "HmmTopology":
        """<Topology> phones phone2idx num-entries, per entry: num-states,
        per state: pdf-class, num-transitions, (next-state, prob)…
        </Topology>."""
        iof.expect_token(f, "<Topology>")
        phones = iof.read_integer_vector(f)
        idx_vec = iof.read_integer_vector(f)
        num_entries = iof.read_int32(f)
        entries: List[List[HmmState]] = []
        for _ in range(num_entries):
            states = []
            for _ in range(iof.read_int32(f)):
                pdf_class = iof.read_int32(f)
                trans = []
                for _ in range(iof.read_int32(f)):
                    ns = iof.read_int32(f)
                    trans.append((ns, float(iof.read_float(f))))
                states.append(HmmState(pdf_class, trans))
            entries.append(states)
        iof.expect_token(f, "</Topology>")
        by_phone: Dict[int, List[HmmState]] = {}
        for p in phones:
            idx = idx_vec[p]
            if idx < 0 or idx >= num_entries:
                raise KaldiError(f"topology: bad entry index for phone {p}")
            by_phone[int(p)] = entries[idx]
        return HmmTopology(by_phone)

    def write(self, f: BinaryIO) -> None:
        """The layout `read` takes.  Phones with identical entries share one
        entry, numbered in phone order, as the reference stores them."""
        phones = self.phones
        entries: List[List[HmmState]] = []
        idx_vec = [-1] * (max(phones) + 1)
        for p in phones:
            entry = self._entries[p]
            for i, e in enumerate(entries):
                if e == entry:
                    idx_vec[p] = i
                    break
            else:
                entries.append(entry)
                idx_vec[p] = len(entries) - 1
        iof.write_token(f, "<Topology>")
        iof.write_integer_vector(f, phones)
        iof.write_integer_vector(f, idx_vec)
        iof.write_int32(f, len(entries))
        for entry in entries:
            iof.write_int32(f, len(entry))
            for st in entry:
                iof.write_int32(f, st.pdf_class)
                iof.write_int32(f, len(st.transitions))
                for ns, prob in st.transitions:
                    iof.write_int32(f, ns)
                    iof.write_float(f, prob)
        iof.write_token(f, "</Topology>")


def _bakis_entry(num_states: int) -> List[HmmState]:
    states = [HmmState(pdf_class=i, transitions=[(i, 0.75), (i + 1, 0.25)])
              for i in range(num_states)]
    states.append(HmmState(pdf_class=NO_PDF, transitions=[]))
    return states


def _silence_entry(num_states: int) -> List[HmmState]:
    """State 0 can self-loop or skip ahead to any of 1..n-2 (short silences
    pass quickly, like the stock 5-state topology); the others are a
    left-to-right chain."""
    if num_states < 3:
        return _bakis_entry(num_states)
    n = num_states
    targets0 = [0] + list(range(1, n - 1))
    p0 = 1.0 / len(targets0)
    states = [HmmState(0, [(t, p0) for t in targets0])]
    for i in range(1, n):
        states.append(HmmState(i, [(i, 0.75), (i + 1, 0.25)]))
    states.append(HmmState(NO_PDF, []))
    return states
