"""Shared GMM training machinery: the alignment step.

Counterpart of the part of old_kaldi_git_tpu/recipes/gmm_common.py that
aligns a corpus (reference steps/train_{mono,deltas}.sh's
gmm-align-compiled): every utterance's features through the GMM kernel
(K3), then the dense alignment scan over its own training graph
(decoder/viterbi.py `align_batch`, K1 three times a frame).  Its
`pad_feats` is utils/batching.py's `pad_feature_batch` (the same padding,
keys sorted).  The EM update and the training loop are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph
from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, align_batch
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass
from old_kaldi_git_tpu_torch.utils.timing import StageClock


@options_dataclass
class GmmTrainOptions:
    """The alignment setting of the JAX package's GmmTrainOptions (its beam
    is not read by the alignment scan, which relaxes every arc; its
    iteration counts, Gaussian targets and realignment schedule belong to
    the training loop, which is not ported)."""

    acoustic_scale: float = 0.1


def align_all(
    am: AmDiagGmm,
    graphs: Sequence[CsrGraph],
    feats_padded: Union[np.ndarray, torch.Tensor],
    num_frames: Sequence[int],
    vopts: ViterbiOptions,
    max_batch: int = 0,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[List[Optional[np.ndarray]], List[float]]:
    """Viterbi-align every utterance on the model's device, in chunks of
    `max_batch` utterances (0: the whole corpus in one batch), each trimmed
    to its own longest utterance.  The GMM kernel has no [b, T, pdf·gauss]
    intermediate, so the whole 600-utterance set fits one batch of the
    card; the result does not depend on the chunking.

    timings: a dict that receives `loglikes_seconds`, `align_seconds` and
    `align_frames` (see align_batch), summed over the chunks."""
    dev = am.device
    B = len(graphs)
    num_frames = np.asarray(num_frames, np.int32)
    max_batch = B if max_batch <= 0 else max_batch
    clock = StageClock(dev, timings)
    alis: List[Optional[np.ndarray]] = []
    scores: List[float] = []
    for lo in range(0, B, max_batch):
        hi = min(B, lo + max_batch)
        t_max = int(num_frames[lo:hi].max())
        x = torch.as_tensor(feats_padded[lo:hi, :t_max]).to(dev)
        ll = am.loglikes_batch(x.contiguous())
        del x
        clock.lap("loglikes_seconds")
        a, s = align_batch(graphs[lo:hi], ll, num_frames[lo:hi], vopts, device=dev,
                           timings=timings)
        del ll
        clock.lap(None)
        alis.extend(a)
        scores.extend(s)
    return alis, scores
