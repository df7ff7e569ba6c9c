"""HMM topologies, read side (own copy of the part of
old_kaldi_git_tpu/hmm/topology.py that TransitionModel.read uses).

Parity with reference src/hmm/hmm-topology.h: per-phone state lists, each
state a pdf-class and (next-state, prob) transitions; the last state is
non-emitting.  Binary layout of HmmTopology::Write (old-Kaldi vintage, one
pdf-class per state).
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO, Dict, List, Tuple

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

    @property
    def phones(self) -> List[int]:
        return sorted(self._entries)

    def topology_for_phone(self, phone: int) -> List[HmmState]:
        if phone not in self._entries:
            raise KaldiError(f"no topology entry for phone {phone}")
        return self._entries[phone]

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
