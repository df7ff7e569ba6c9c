"""Batched GMM decoding and scoring.

Counterpart of old_kaldi_git_tpu/recipes/decode.py (reference
gmm-decode-faster + steps/decode.sh + local/score.sh): the GMM evaluates
every pdf for the whole padded batch on the device (the GMM kernel,
ops/gmm_kernel.py), the batched beam decoder searches the shared graph, word
ids map back to words, and the hypotheses are scored against the reference
text.  `decode_dataset_with_lattices` keeps lattices (reference
gmm-latgen-faster): the token-sparse search emits its lattice records on the
device and the host builds each utterance's raw lattice from them;
`decode_biglm` replaces the small LM on the determinized lattices by a big
one, and `score_lattices_sweep` is score.sh's LM-weight sweep over lattice
best paths.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph
from old_kaldi_git_tpu_torch.decoder.viterbi import (
    ViterbiOptions,
    decode_batch,
    decode_batch_tokens,
)
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.lat.determinize import CompactLattice, determinize_lattice_pruned
from old_kaldi_git_tpu_torch.lat.lattice import (
    Lattice, lattice_best_path, lattice_from_token_records)
from old_kaldi_git_tpu_torch.lat.rescore import lmrescore_compact_lattice
from old_kaldi_git_tpu_torch.lm.arpa import ArpaLm
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


def decode_dataset_with_lattices(
    model: AmGmmModel,
    graph: CsrGraph,
    lang: Union[Sequence[str], object],
    feats: Dict[str, np.ndarray],
    opts: Optional[DecodeOptions] = None,
    lattice_beam: float = 10.0,
    determinize: bool = False,
    timings: Optional[Dict[str, float]] = None,
    decoder_words: Optional[Dict[str, List[int]]] = None,
) -> Dict[str, object]:
    """{utt: [T, D] features} → {utt: Lattice}, or {utt: CompactLattice}
    with determinize=True (the reference's --determinize-lattice, through
    the native library of cpp/lattice.cc), on the model's device: the GMM
    over the padded batch, `decode_batch_tokens` with lattice records
    within `lattice_beam`, then `lattice_from_token_records` on the host.
    An utterance whose search failed has no lattice, with a warning.
    `lang` is unused (the JAX package's signature).  timings:
    `loglikes_seconds`, decode_batch_tokens', `lattice_seconds` and, with
    determinize, `determinize_seconds`.  decoder_words: a dict that
    receives each decoded utterance's 1-best word ids from the search."""
    opts = opts or DecodeOptions()
    dev = model.am.device
    keys, padded, nf = pad_feature_batch(feats)
    clock = StageClock(dev, timings)
    loglikes = model.am.loglikes_batch(torch.from_numpy(padded).to(dev))
    clock.lap("loglikes_seconds")
    results = decode_batch_tokens(
        graph, loglikes, nf, ViterbiOptions(beam=opts.beam, max_active=opts.max_active,
                                            acoustic_scale=opts.acoustic_scale),
        want_lattice=True, lattice_beam=lattice_beam, device=dev, timings=timings)
    del loglikes
    clock.lap(None)
    lats: Dict[str, object] = {}
    for k, res in zip(keys, results):
        if res is None or res.token_lattice is None:
            log.warning("no lattice for %s", k)
            continue
        if decoder_words is not None:
            decoder_words[k] = list(res.words)
        lat = lattice_from_token_records(graph, res.token_lattice)
        if lat is not None:
            lats[k] = lat
    clock.lap("lattice_seconds")
    if determinize:
        lats = {k: determinize_lattice_pruned(lat, lattice_beam,
                                              acoustic_scale=opts.acoustic_scale)
                for k, lat in lats.items()}
        clock.lap("determinize_seconds")
    return lats


def decode_biglm(
    model: AmGmmModel,
    graph: CsrGraph,
    lang: Union[Sequence[str], object],
    feats: Dict[str, np.ndarray],
    old_lm: ArpaLm,
    new_lm: ArpaLm,
    opts: Optional[DecodeOptions] = None,
    lattice_beam: float = 10.0,
    lattices: Optional[Dict[str, CompactLattice]] = None,
) -> Dict[str, List[str]]:
    """Big-LM decoding (the reference's lattice-biglm-faster-decoder
    capability): decode on the small-LM graph keeping determinized
    lattices, then replace the LM on them exactly, old scores out and the
    big LM in (`lmrescore_compact_lattice`); the best path at lm_scale 1
    and the decode's acoustic scale.  No big HCLG is built.  old_lm /
    new_lm: ArpaLms over the word table's words.

    lattices: the determinized lattices of this decode (keyed like feats)
    when the caller has them: the decode is then skipped."""
    opts = opts or DecodeOptions()
    words = getattr(lang, "words", lang)
    if lattices is None:
        lattices = decode_dataset_with_lattices(model, graph, lang, feats, opts, lattice_beam,
                                                determinize=True)
    hyps: Dict[str, List[str]] = {}
    for k, clat in lattices.items():
        resc = lmrescore_compact_lattice(clat, words, new_lm, old_lm)
        best, _tids, _cost = resc.best_path(1.0, opts.acoustic_scale)
        hyps[k] = [words[w] for w in best]
    return hyps


def score_lattices_sweep(
    lattices: Dict[str, Lattice],
    lang: Union[Sequence[str], object],
    ref_text: Dict[str, Sequence[str]],
    acoustic_scale: float = 0.1,
    lm_scales: Sequence[float] = (0.5, 0.75, 1.0, 1.25, 1.5, 2.0),
    report: Optional[Dict[float, float]] = None,
) -> Tuple[float, EditStats]:
    """LM-weight sweep over lattice best paths (reference local/score.sh's
    LMWT loop, as lm_scale relative to the decode's scales): (the best
    lm_scale, its scoring; the first of equal WERs).  report: a dict that
    receives each scale's WER."""
    best = None
    words = getattr(lang, "words", lang)
    for lms in lm_scales:
        hyps = {}
        for k, lat in lattices.items():
            ids, _, _ = lattice_best_path(lat, lm_scale=lms, ac_scale=acoustic_scale)
            hyps[k] = [words[w] for w in ids]
        stats = compute_wer({k: list(v) for k, v in ref_text.items()},
                            {k: list(v) for k, v in hyps.items()})
        if report is not None:
            report[lms] = stats.wer
        if best is None or stats.wer < best[1].wer:
            best = (lms, stats)
    log.info("sweep best: lm_scale=%.2f %s", best[0], best[1].report())
    return best
