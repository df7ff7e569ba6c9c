"""Chain HMM topology: one emitting state per phone, minimum duration 1.

Counterpart of old_kaldi_git_tpu/chain/topology.py (reference
steps/nnet3/chain/gen_topo.py output, with one pdf-class shared by the
self-loop and the forward transition, as the JAX package documents).
"""

from __future__ import annotations

from typing import Sequence

from old_kaldi_git_tpu_torch.hmm.topology import NO_PDF, HmmState, HmmTopology


def chain_topology(phones: Sequence[int]) -> HmmTopology:
    entry = [HmmState(pdf_class=0, transitions=[(0, 0.5), (1, 0.5)]),
             HmmState(pdf_class=NO_PDF, transitions=[])]
    return HmmTopology({p: entry for p in phones})
