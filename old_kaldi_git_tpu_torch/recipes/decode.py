"""Batched GMM decoding and scoring.

Counterpart of old_kaldi_git_tpu/recipes/decode.py (reference
gmm-decode-faster + steps/decode.sh + local/score.sh): the GMM evaluates
every pdf for the whole padded batch on the device (the GMM kernel,
ops/gmm_kernel.py), the batched beam decoder searches the shared graph, word
ids map back to words, and the hypotheses are scored against the reference
text.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph
from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
from old_kaldi_git_tpu_torch.utils.edit_distance import EditStats, compute_wer
from old_kaldi_git_tpu_torch.utils.log import get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass
from old_kaldi_git_tpu_torch.utils.timing import StageClock

log = get_logger("decode")


@options_dataclass
class DecodeOptions:
    beam: float = 16.0
    max_active: int = 7000
    acoustic_scale: float = 0.1


def decode_dataset(
    model: AmGmmModel,
    graph: CsrGraph,
    lang: Union[Sequence[str], object],
    feats: Dict[str, np.ndarray],
    opts: Optional[DecodeOptions] = None,
    timings: Optional[Dict[str, float]] = None,
    failed: Optional[List[str]] = None,
) -> Dict[str, List[str]]:
    """{utt: [T, D] features} → {utt: hypothesis words}, on the model's
    device.  The whole dict is padded into one batch, as the reference does.

    lang: the word table, word id → word.  The port has no Lang bundle: any
    object with a `.words` sequence is taken (the JAX package's Lang, the
    port's MinilibSystem), or the sequence itself (`minilib.word_table`).
    A failed utterance decodes to no words, with a warning; `failed`, a
    list, receives its key.
    timings: a dict that receives `loglikes_seconds` (the GMM over the
    batch), `search_seconds` and `host_tail_seconds`; each stage then ends
    with a device synchronise."""
    opts = opts or DecodeOptions()
    words = getattr(lang, "words", lang)
    dev = model.am.device
    keys, padded, nf = pad_feature_batch(feats)
    clock = StageClock(dev, timings)
    loglikes = model.am.loglikes_batch(torch.from_numpy(padded).to(dev))
    clock.lap("loglikes_seconds")
    vopts = ViterbiOptions(beam=opts.beam, max_active=opts.max_active,
                           acoustic_scale=opts.acoustic_scale)
    results = decode_batch(graph, loglikes, nf, vopts, device=dev, timings=timings)
    del loglikes
    clock.lap(None)
    hyps: Dict[str, List[str]] = {}
    for k, res in zip(keys, results):
        if res is None:
            log.warning("decode failed for %s", k)
            hyps[k] = []
            if failed is not None:
                failed.append(k)
        else:
            hyps[k] = [words[w] for w in res.words]
    clock.lap("host_tail_seconds")
    return hyps


def score_hyps(ref_text: Dict[str, Sequence[str]],
               hyps: Dict[str, Sequence[str]]) -> EditStats:
    stats = compute_wer({k: list(v) for k, v in ref_text.items()},
                        {k: list(v) for k, v in hyps.items()})
    log.info("scoring: %s", stats.report())
    return stats
