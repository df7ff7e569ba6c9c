"""TransitionModel (own copy of old_kaldi_git_tpu/hmm/transition_model.py:
what a decode, the graph compiler and GMM training need).

Parity with reference src/hmm/transition-model.h: transition-ids (tids,
1-based, 0 = epsilon) index (transition-state, transition-index) pairs; a
transition-state is a (phone, hmm-state, pdf) tuple.  The decoder needs the
tid → pdf map; the graph compiler the tuple → transition-state index, the
self-loop tids and the log transition probs; training the per-tid arrays
of hmm_utils (`tid_arrays`), the occupancy counts and the MLE update
(reference TransitionModel::MleUpdate, floor 0.01), and the writer.  A model
is read from a `.mdl` or built from a tree and a topology
(`from_context_dependency`, reference TransitionModel(ctx_dep, topo), with
the topology's priors as its probs and the tree's pdf count).
"""

from __future__ import annotations

import math
from typing import BinaryIO, Dict, List, Optional, Sequence, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.hmm.topology import HmmTopology
from old_kaldi_git_tpu_torch.utils import io_funcs as iof
from old_kaldi_git_tpu_torch.utils.log import KaldiError


class TransitionModel:
    def __init__(self, topo: HmmTopology, tuples: List[Tuple[int, int, int]],
                 log_probs: np.ndarray, num_pdfs: Optional[int] = None):
        """num_pdfs: the tree's pdf count; None takes 1 + the largest pdf of
        the tuples, as a `.mdl` reader derives it (the file stores none)."""
        self.topo = topo
        self.tuples = tuples  # (phone, hmm_state, pdf) per transition-state
        self.num_pdfs = (1 + max((t[2] for t in tuples), default=-1)
                         if num_pdfs is None else num_pdfs)
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
        self._tid_arrays: Optional[Dict[str, np.ndarray]] = None
        if len(log_probs) != self.num_tids + 1:
            raise KaldiError(
                f"TransitionModel: {len(log_probs)} log-probs for "
                f"{self.num_tids} transition-ids")

    @staticmethod
    def from_context_dependency(ctx_dep, topo: HmmTopology) -> "TransitionModel":
        """One transition-state per (phone, hmm-state, pdf) that the tree
        can reach, sorted; log-probs from the topology's priors; as many
        pdfs as the tree has."""
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
        return TransitionModel(topo, tuples, log_probs, num_pdfs=ctx_dep.num_pdfs)

    def tuple_to_tstate(self, phone: int, hmm_state: int, pdf: int) -> int:
        key = (phone, hmm_state, pdf)
        if key not in self._index:
            raise KaldiError(f"no transition-state for {key}")
        return self._index[key]

    def pair_to_tid(self, tstate: int, tindex: int) -> int:
        return self.state2id[tstate] + tindex

    def tid_to_pdf(self, tid: int) -> int:
        return self.tuples[self.id2state[tid]][2]

    def tid_to_phone(self, tid: int) -> int:
        return self.tuples[self.id2state[tid]][0]

    def is_self_loop(self, tid: int) -> bool:
        """Whether the transition returns to its own HMM state."""
        ts = int(self.id2state[tid])
        phone, hmm_state, _ = self.tuples[ts]
        trans = self.topo.topology_for_phone(phone)[hmm_state].transitions
        return trans[tid - self.state2id[ts]][0] == hmm_state

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

    def tid_arrays(self) -> Dict[str, np.ndarray]:
        """Per tid ([num_tids+1] int32, entry 0 -1): phone, hmm_state, pdf,
        pdf_class, tindex (its index among its state's transitions) and
        self_loop (1 for a self-loop), built once."""
        if self._tid_arrays is None:
            tindex = np.full(self.num_tids + 1, -1, np.int32)
            tindex[1:] = (np.arange(1, self.num_tids + 1)
                          - np.asarray(self.state2id)[self.id2state[1:]])
            pdf_class = np.full(self.num_tids + 1, -1, np.int32)
            self_loop = np.full(self.num_tids + 1, -1, np.int32)
            for tid in range(1, self.num_tids + 1):
                phone, hmm_state, _ = self.tuples[self.id2state[tid]]
                st = self.topo.topology_for_phone(phone)[hmm_state]
                pdf_class[tid] = st.pdf_class
                self_loop[tid] = st.transitions[tindex[tid]][0] == hmm_state
            self._tid_arrays = {"phone": self._per_tid(0), "hmm_state": self._per_tid(1),
                                "pdf": self._per_tid(2), "pdf_class": pdf_class,
                                "tindex": tindex, "self_loop": self_loop}
        return self._tid_arrays

    # -- MLE update (reference TransitionModel::MleUpdate) ---------------------
    def accumulate(self, alignment: Sequence[int], stats: np.ndarray) -> np.ndarray:
        """Adds each tid's frame count to `stats` (float64 [num_tids+1])."""
        ali = np.asarray(alignment, np.int64)
        if len(ali):
            stats += np.bincount(ali, minlength=len(stats)).astype(stats.dtype)
        return stats

    def mle_update(self, stats: np.ndarray, floor: float = 0.01) -> float:
        """Each transition-state's probs ∝ its tids' counts floored at
        `floor`; returns the total count."""
        stats = np.asarray(stats, dtype=np.float64)
        counts = np.maximum(stats[1:], floor)
        sums = np.add.reduceat(counts, np.asarray(self.state2id[:-1]) - 1)
        self.log_probs[1:] = np.log(counts / sums[self.id2state[1:]])
        return float(stats.sum())

    def write(self, f: BinaryIO) -> None:
        """<TransitionModel> <Topology>… <Triples> n (phone hmm-state pdf)×n
        </Triples> <LogProbs> FV </LogProbs> </TransitionModel>: the
        layout `read` takes, the log-probs as float32."""
        iof.write_token(f, "<TransitionModel>")
        self.topo.write(f)
        iof.write_token(f, "<Triples>")
        iof.write_int32(f, len(self.tuples))
        for phone, hmm_state, pdf in self.tuples:
            iof.write_int32(f, phone)
            iof.write_int32(f, hmm_state)
            iof.write_int32(f, pdf)
        iof.write_token(f, "</Triples>")
        iof.write_token(f, "<LogProbs>")
        iof.write_vector(f, self.log_probs.astype(np.float32))
        iof.write_token(f, "</LogProbs>")
        iof.write_token(f, "</TransitionModel>")

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
