"""Lattices on the host: rebuild from the decoder's records, determinization
(native, cpp/lattice.cc), LM rescoring, and what users read from a decode:
n-best lists, posteriors, confusion networks, MBR, CTM, archives.

The JAX package's names (old_kaldi_git_tpu/lat/__init__.py); importing the
package registers the "lat" and "clat" table holders.
"""

from old_kaldi_git_tpu_torch.lat.lattice import (
    Lattice,
    LatticeArc,
    lattice_from_decode,
    lattice_best_path,
    lattice_nbest,
    lattice_nbest_paths,
    lattice_prune,
    lattice_union,
    linear_lattice_from_path,
    lattice_arc_posteriors,
    lattice_to_word_fst,
    lattice_word_posteriors,
    confusion_network,
    rescore_nbest,
)
from old_kaldi_git_tpu_torch.lat.determinize import (
    CompactLattice,
    CompactLatticeArc,
    compact_lattice_to_lattice,
    determinize_lattice,
    determinize_lattice_pruned,
    minimize_compact_lattice,
    push_compact_lattice,
)
from old_kaldi_git_tpu_torch.lat.ctm import (
    CtmEntry,
    align_words_lexicon,
    ctm_from_alignment,
    lattice_to_ctm_conf,
)
from old_kaldi_git_tpu_torch.lat.rescore import lmrescore_compact_lattice
from old_kaldi_git_tpu_torch.lat.mbr import MbrResult, minimum_bayes_risk
from old_kaldi_git_tpu_torch.lat import holder as _holder  # registers lat/clat holders
