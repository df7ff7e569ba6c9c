"""Table holder for FSTs ("fst"): training-graph archives (counterpart of
old_kaldi_git_tpu/fst/holder.py).

compile-train-graphs writes `ark:` tables of per-utterance graphs
(reference TableWriter<VectorFstHolder>); the alignment tools read them
back.  A cell is the self-delimiting OKTFST01 record, binary only.
"""

from __future__ import annotations

from old_kaldi_git_tpu_torch.fst.vector_fst import VectorFst
from old_kaldi_git_tpu_torch.utils.log import KaldiError
from old_kaldi_git_tpu_torch.utils.table import Holder, register_holder


class VectorFstHolder(Holder):
    def write(self, f, value: VectorFst, binary: bool) -> None:
        if not binary:
            raise KaldiError("fst holder: text table mode not supported")
        value.write(f)

    def read(self, f) -> VectorFst:
        return VectorFst.read(f)


register_holder("fst", VectorFstHolder)
