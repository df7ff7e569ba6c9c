"""HMM topology, transition model and H-transducer: what a GMM decode and
the training-graph compiler need; frame posteriors (hmm/posterior.py).

The JAX package's names (old_kaldi_git_tpu/hmm/__init__.py) where the port
has them (AddSelfLoops runs in the native graph library, fst/native.py);
importing hmm.posterior registers the "post" and "gpost" table holders.
"""

from old_kaldi_git_tpu_torch.hmm.topology import HmmTopology
from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
from old_kaldi_git_tpu_torch.hmm.hmm_utils import (
    make_h_transducer,
    split_to_phones,
    alignment_to_phones,
    alignment_to_pdfs,
    convert_alignment,
)
