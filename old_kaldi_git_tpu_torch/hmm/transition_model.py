"""TransitionModel, read side (own copy of the part of
old_kaldi_git_tpu/hmm/transition_model.py that a decode needs).

Parity with reference src/hmm/transition-model.h: transition-ids (tids,
1-based, 0 = epsilon) index (transition-state, transition-index) pairs; a
transition-state is a (phone, hmm-state, pdf) tuple.  The decoder needs the
tid → pdf map; the log transition probs are kept as read.
"""

from __future__ import annotations

from typing import BinaryIO, List, Tuple

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
        # state2id[ts] = first tid of transition-state ts; one tid per
        # transition of its hmm-state
        counts = [len(topo.topology_for_phone(p)[h].transitions)
                  for p, h, _ in tuples]
        self.state2id = [1] + (1 + np.cumsum(counts, dtype=np.int64)).tolist()
        self.num_tids = self.state2id[-1] - 1
        self.log_probs = log_probs  # [num_tids+1] float64
        if len(log_probs) != self.num_tids + 1:
            raise KaldiError(
                f"TransitionModel: {len(log_probs)} log-probs for "
                f"{self.num_tids} transition-ids")

    def tid_to_pdf_array(self) -> np.ndarray:
        """[num_tids+1] int32; entry 0 is -1 (epsilon)."""
        pdfs = np.asarray([t[2] for t in self.tuples], np.int32)
        out = np.full(self.num_tids + 1, -1, np.int32)
        out[1:] = np.repeat(pdfs, np.diff(self.state2id))
        return out

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
