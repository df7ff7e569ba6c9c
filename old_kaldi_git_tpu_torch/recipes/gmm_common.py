"""Shared GMM training machinery: align → accumulate → update → mixup.

Counterpart of old_kaldi_git_tpu/recipes/gmm_common.py (reference
steps/train_{mono,deltas}.sh: gmm-align-compiled, gmm-acc-stats-ali,
gmm-sum-accs, gmm-est with mixing up).  `align_all` puts every utterance's
features through the GMM kernel (K3), then the dense alignment scan over
its own training graph (decoder/viterbi.py `align_batch`, K1 three times a
frame).  `gmm_training_loop` runs the EM iterations on the model's device:
the statistics of every aligned frame in one pass (gmm/mle.py, float64),
the M-step, the transition update, the mixture growth, and realignment on
the schedule.  The JAX package's `pad_feats` is utils/batching.py's
`pad_feature_batch` (the same padding, keys sorted).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph
from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, align_batch
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm
from old_kaldi_git_tpu_torch.gmm.mle import (
    AccumAmDiagGmm,
    MleDiagGmmOptions,
    mixup,
    mle_am_diag_gmm_update,
)
from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass
from old_kaldi_git_tpu_torch.utils.timing import StageClock

log = get_logger("gmm-train")


@options_dataclass
class GmmTrainOptions:
    """`beam` is kept for the reference's options: the alignment scan relaxes
    every arc of a training graph and reads no beam."""

    num_iters: int = 30
    max_iter_inc: int = 20
    totgauss: int = 1000
    beam: float = 32.0
    acoustic_scale: float = 0.1
    realign_iters: Sequence[int] = tuple(range(1, 10)) + (12, 14, 16, 18, 20, 23, 26, 29)


def pad_feats(feats: Dict[str, np.ndarray]
              ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """{utt: [T, D]} → (sorted keys, padded [B, Tmax, D] float32,
    num_frames [B])."""
    return pad_feature_batch(feats)


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


def gmm_training_loop(
    am: AmDiagGmm,
    tm: TransitionModel,
    graphs: Sequence[CsrGraph],
    keys: List[str],
    feats_padded: Union[np.ndarray, torch.Tensor],
    num_frames: np.ndarray,
    opts: GmmTrainOptions,
    initial_alignments: Optional[List[Optional[np.ndarray]]] = None,
    timings: Optional[Dict[str, float]] = None,
    history: Optional[List[dict]] = None,
) -> Tuple[AmDiagGmm, List[Optional[np.ndarray]]]:
    """The EM iterations on (am, tm), on the model's device; tm is updated in
    place.  Returns (final am, final alignments in `keys` order).

    Without initial alignments the first pass aligns with `am`.  Iteration
    `it` realigns first when it is in `opts.realign_iters` (it > 0); an
    utterance whose alignment fails keeps its previous one, and a pass in
    which all fail raises.  Then every aligned frame's statistics, the
    M-step and the transition update, and, for the first
    `opts.max_iter_inc` iterations, mixing up by `inc` Gaussians towards
    `opts.totgauss`.  A last pass aligns with the final model.

    feats_padded [B, T, D] in `keys` order (utils/batching.py
    `pad_feature_batch`), uploaded to the device once.  timings: a dict
    that receives `loglikes_seconds`, `align_seconds`, `align_frames`
    (align_all), `accumulate_seconds`, `update_seconds` and
    `align_passes`, each stage ended by a device synchronise.  history: a
    list that receives one dict per iteration: `iteration`,
    `like_per_frame` and `frames` of its statistics, `gaussians` before the
    update and `gaussians_after` its mixup."""
    dev = am.device
    vopts = ViterbiOptions(beam=opts.beam, acoustic_scale=opts.acoustic_scale)
    alignments: List[Optional[np.ndarray]] = (
        list(initial_alignments) if initial_alignments is not None else [None] * len(keys))
    x_pad = torch.as_tensor(feats_padded).to(dev)
    num_frames = np.asarray(num_frames, np.int32)
    clock = StageClock(dev, timings)

    def count(key: str) -> None:
        if timings is not None:
            timings[key] = timings.get(key, 0) + 1

    def do_align(final: bool = False) -> None:
        new_ali, _ = align_all(am, graphs, x_pad, num_frames, vopts, timings=timings)
        clock.lap(None)
        count("align_passes")
        ok = sum(1 for a in new_ali if a is not None)
        if ok == 0 and not final:
            raise KaldiError("all alignments failed")
        for i, a in enumerate(new_ali):
            if a is not None:
                alignments[i] = a
        log.info("aligned %d/%d utts", ok, len(keys))

    if initial_alignments is None:
        do_align()
    inc = max(0, opts.totgauss - am.num_gauss) // max(opts.max_iter_inc, 1)
    realign = set(opts.realign_iters)

    for it in range(opts.num_iters):
        if it > 0 and it in realign:
            do_align()
        accs = AccumAmDiagGmm(am)
        tstats = np.zeros(tm.num_tids + 1)
        aligned = [i for i in range(len(keys)) if alignments[i] is not None]
        if aligned:
            # every aligned frame of the corpus in one pass (reference
            # gmm-acc-stats-ali over all jobs, then gmm-sum-accs)
            all_ali = np.concatenate([np.asarray(alignments[i], np.int64) for i in aligned])
            rows = np.repeat(np.asarray(aligned), [len(alignments[i]) for i in aligned])
            cols = np.concatenate([np.arange(len(alignments[i])) for i in aligned])
            sel = (torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev))
            tot_like = accs.accumulate_corpus(am, x_pad[sel],
                                              tm.tid_to_pdf_array()[all_ali])
            tm.accumulate(all_ali, tstats)
            tot_frames = len(all_ali)
        else:
            tot_like, tot_frames = 0.0, 0
        clock.lap("accumulate_seconds")
        like_per_frame = tot_like / max(tot_frames, 1)
        log.info("iter %d: avg like/frame %.4f over %d frames (%d gauss)",
                 it, like_per_frame, tot_frames, am.num_gauss)
        gauss_before = am.num_gauss
        am = mle_am_diag_gmm_update(am, accs, MleDiagGmmOptions())
        tm.mle_update(tstats)
        if it < opts.max_iter_inc and am.num_gauss < opts.totgauss:
            am = mixup(am, min(opts.totgauss, am.num_gauss + inc),
                       occs=accs.pdf_occupancy(), seed=it)
        clock.lap("update_seconds")
        if history is not None:
            history.append({"iteration": it, "like_per_frame": like_per_frame,
                            "frames": tot_frames, "gaussians": gauss_before,
                            "gaussians_after": am.num_gauss})

    do_align(final=True)
    if timings is not None:
        log.info("gmm stage timing: loglikes %.2fs, align %.2fs, accumulate %.2fs, "
                 "update %.2fs", *(timings.get(k, 0.0) for k in (
                     "loglikes_seconds", "align_seconds", "accumulate_seconds",
                     "update_seconds")))
    return am, alignments
