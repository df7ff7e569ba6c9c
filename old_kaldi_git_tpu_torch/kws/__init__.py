"""Keyword search over lattices (counterpart of old_kaldi_git_tpu/kws)."""

from old_kaldi_git_tpu_torch.kws.search import (  # noqa: F401
    KwsHit,
    build_kws_index,
    search_index,
    search_phrase,
)
from old_kaldi_git_tpu_torch.kws.atwv import compute_atwv  # noqa: F401
