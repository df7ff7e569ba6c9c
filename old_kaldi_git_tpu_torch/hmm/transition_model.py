"""TransitionModel (own copy of the parts of
old_kaldi_git_tpu/hmm/transition_model.py that a decode and the graph
compiler need).

Parity with reference src/hmm/transition-model.h: transition-ids (tids,
1-based, 0 = epsilon) index (transition-state, transition-index) pairs; a
transition-state is a (phone, hmm-state, pdf) tuple.  The decoder needs the
tid → pdf map; the graph compiler the tuple → transition-state index, the
self-loop tids and the log transition probs.  A model is read from a `.mdl`
or built from a tree and a topology (`from_context_dependency`, reference
TransitionModel(ctx_dep, topo), with the topology's priors as its probs).
"""

from __future__ import annotations

import math
from typing import BinaryIO, Dict, List, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.hmm.topology import HmmTopology
from old_kaldi_git_tpu_torch.utils import io_funcs as iof
from old_kaldi_git_tpu_torch.utils.log import KaldiError


class TransitionModel:
    def __init__(self, topo: HmmTopology, tuples: List[Tuple[int, int, int]],
                 log_probs: np.ndarray):
        self.topo = topo
        self.tuples = tuples  # (phone, hmm_state, pdf) per transition-state
        self.num_pdfs = 1 + max((t[2] for t in tuples), default=-1)
        self._index: Dict[Tuple[int, int, int], int] = {t: i for i, t in enumerate(tuples)}
        # state2id[ts] = first tid of transition-state ts; one tid per
        # transition of its hmm-state
        counts = [len(topo.topology_for_phone(p)[h].transitions)
                  for p, h, _ in tuples]
        self.state2id = [1] + (1 + np.cumsum(counts, dtype=np.int64)).tolist()
        self.num_tids = self.state2id[-1] - 1
        # id2state[tid] = its transition-state (entry 0 unused)
        self.id2state = np.zeros(self.num_tids + 1, np.int32)
        self.id2state[1:] = np.repeat(np.arange(len(tuples), dtype=np.int32), counts)
        self.log_probs = log_probs  # [num_tids+1] float64
        if len(log_probs) != self.num_tids + 1:
            raise KaldiError(
                f"TransitionModel: {len(log_probs)} log-probs for "
                f"{self.num_tids} transition-ids")

    @staticmethod
    def from_context_dependency(ctx_dep, topo: HmmTopology) -> "TransitionModel":
        """One transition-state per (phone, hmm-state, pdf) that the tree
        can reach, sorted; log-probs from the topology's priors."""
        phones = topo.phones
        num_pdf_classes = {p: topo.num_pdf_classes(p) for p in phones}
        tuples = []
        for pdf, pairs in enumerate(ctx_dep.get_pdf_info(phones, num_pdf_classes)):
            for phone, pdf_class in sorted(pairs):
                for hmm_state, st in enumerate(topo.topology_for_phone(phone)):
                    if st.pdf_class == pdf_class:
                        tuples.append((phone, hmm_state, pdf))
        tuples.sort()
        probs = [prob for p, h, _ in tuples
                 for _ns, prob in topo.topology_for_phone(p)[h].transitions]
        log_probs = np.zeros(len(probs) + 1, np.float64)
        log_probs[1:] = [math.log(max(prob, 1e-20)) for prob in probs]
        return TransitionModel(topo, tuples, log_probs)

    def tuple_to_tstate(self, phone: int, hmm_state: int, pdf: int) -> int:
        key = (phone, hmm_state, pdf)
        if key not in self._index:
            raise KaldiError(f"no transition-state for {key}")
        return self._index[key]

    def pair_to_tid(self, tstate: int, tindex: int) -> int:
        return self.state2id[tstate] + tindex

    def self_loop_tid(self, tstate: int) -> int:
        """tid of the self-loop of this transition-state, or 0 if none."""
        phone, hmm_state, _ = self.tuples[tstate]
        trans = self.topo.topology_for_phone(phone)[hmm_state].transitions
        for ti, (ns, _p) in enumerate(trans):
            if ns == hmm_state:
                return self.state2id[tstate] + ti
        return 0

    def self_loop_prob(self, tstate: int) -> float:
        tid = self.self_loop_tid(tstate)
        return math.exp(self.log_probs[tid]) if tid else 0.0

    def _per_tid(self, column: int) -> np.ndarray:
        values = np.asarray([t[column] for t in self.tuples], np.int32)
        out = np.full(self.num_tids + 1, -1, np.int32)
        out[1:] = values[self.id2state[1:]]
        return out

    def tid_to_pdf_array(self) -> np.ndarray:
        """[num_tids+1] int32; entry 0 is -1 (epsilon)."""
        return self._per_tid(2)

    def tid_to_phone_array(self) -> np.ndarray:
        """[num_tids+1] int32; entry 0 is -1 (epsilon)."""
        return self._per_tid(0)

    @staticmethod
    def read(f: BinaryIO) -> "TransitionModel":
        """<TransitionModel> <Topology>… <Triples> n (phone hmm-state pdf)×n
        </Triples> <LogProbs> FV </LogProbs> </TransitionModel>; the
        <Tuples> form is taken when every self-loop pdf equals its pdf."""
        iof.expect_token(f, "<TransitionModel>")
        topo = HmmTopology.read(f)
        open_tok = iof.read_token(f)
        if open_tok not in ("<Triples>", "<Tuples>"):
            raise KaldiError(f"TransitionModel.read: got {open_tok!r}")
        four_ints = open_tok == "<Tuples>"
        tuples = []
        for _ in range(iof.read_int32(f)):
            phone, hmm_state, pdf = (iof.read_int32(f) for _ in range(3))
            if four_ints and iof.read_int32(f) != pdf:
                raise KaldiError(
                    "TransitionModel.read: separate self-loop pdfs "
                    "(post-2017 chain topologies) are not supported")
            tuples.append((phone, hmm_state, pdf))
        iof.expect_token(f, "</Tuples>" if four_ints else "</Triples>")
        iof.expect_token(f, "<LogProbs>")
        log_probs = iof.read_vector(f).astype(np.float64)
        iof.expect_token(f, "</LogProbs>")
        iof.expect_token(f, "</TransitionModel>")
        return TransitionModel(topo, tuples, log_probs)
