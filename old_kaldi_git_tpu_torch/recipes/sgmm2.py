"""SGMM2 training (counterpart of old_kaldi_git_tpu/recipes/sgmm2.py;
reference steps/train_sgmm2.sh).

A diagonal UBM from the pooled frames (`ivector.extractor.train_ubm`), made
full-covariance, initialises the SGMM2 (one substate a pdf); EM then runs
with the alternating 'vwc' / 'MS' flags, splits substates toward
`total_substates` at `num_iters // 2`, and realigns at `realign_iters`
through `decoder/viterbi.align_batch` (the gather kernel, three launches a
scanned frame) on the training graphs.  Everything runs on `device`; each
iteration's statistics come from one pass over all aligned frames.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph, fst_to_csr
from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, align_batch
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.gmm.full_gmm import FullGmm
from old_kaldi_git_tpu_torch.gmm.sgmm2 import (AmSgmm2, MleAmSgmm2Accs, Sgmm2Model,
                                               Sgmm2UpdateOptions, alternating_flags,
                                               sgmm2_update, split_substates)
from old_kaldi_git_tpu_torch.ivector.extractor import train_ubm
from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
from old_kaldi_git_tpu_torch.utils.log import get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass

log = get_logger("sgmm2_recipe")


@options_dataclass
class Sgmm2TrainOptions:
    num_iters: int = 8
    num_ubm_gauss: int = 64
    total_substates: int = 0  # 0 = keep one per pdf
    realign_iters: Tuple[int, ...] = (2, 4, 6)
    beam: float = 200.0
    phn_space_dim: int = 0


def train_sgmm2(base, feats: Dict[str, np.ndarray], alignments: Dict[str, np.ndarray],
                graphs: Optional[Dict[str, object]] = None,
                opts: Optional[Sgmm2TrainOptions] = None, device: DeviceLike = None,
                history: Optional[List[dict]] = None,
                timings: Optional[Dict[str, float]] = None) -> Sgmm2Model:
    """base: the GMM system (AmGmmModel) whose transition model and pdfs the
    SGMM2 takes.  graphs: each utterance's training graph (a VectorFst, or
    a CsrGraph as `minilib.align_training_set` gives them) for the
    realignments; None keeps the first alignments throughout.  history:
    one dict an iteration (`iter`, `flags`, `avg_like`, `frames`,
    `substates`, `realigned`: utterances realigned after it); timings:
    `ubm_seconds`, `em_seconds`, `realign_seconds`."""
    opts = opts or Sgmm2TrainOptions()
    dev = resolve_device(device)
    times = {"ubm_seconds": 0.0, "em_seconds": 0.0, "realign_seconds": 0.0}
    t0 = time.perf_counter()
    keys = sorted(k for k in feats if k in alignments)
    X = np.concatenate([np.asarray(feats[k], np.float64) for k in keys])
    ubm = FullGmm.from_diag(train_ubm(X, num_gauss=opts.num_ubm_gauss, num_iters=6,
                                      device=dev))
    sgmm = AmSgmm2.init(ubm, base.am.num_pdfs, opts.phn_space_dim or None, device=dev)
    times["ubm_seconds"] = time.perf_counter() - t0
    tid2pdf = base.tm.tid_to_pdf_array()
    ali = {k: np.asarray(alignments[k]) for k in keys}
    csr = None
    if graphs is not None:
        csr = [g if isinstance(g, CsrGraph) else fst_to_csr(g, tid2pdf)
               for g in (graphs[k] for k in keys)]
        keys_p, padded, nf = pad_feature_batch(
            {k: np.asarray(feats[k], np.float32) for k in keys})
        x_pad = torch.from_numpy(padded).to(dev)
    x_all = {k: torch.from_numpy(np.asarray(feats[k], np.float64)).to(dev) for k in keys}
    split_at = opts.num_iters // 2
    for it in range(opts.num_iters):
        t0 = time.perf_counter()
        accs = MleAmSgmm2Accs(sgmm)
        lens = [min(len(x_all[k]), len(ali[k])) for k in keys]
        x = torch.cat([x_all[k][:n] for k, n in zip(keys, lens)])
        pdfs = np.concatenate([tid2pdf[ali[k][:n]] for k, n in zip(keys, lens)])
        accs.accumulate(sgmm, x, pdfs)
        flags = alternating_flags(it)
        avg = sgmm2_update(sgmm, accs, Sgmm2UpdateOptions(update_flags=flags))
        if it == split_at and opts.total_substates > sgmm.num_substates:
            split_substates(sgmm, accs, opts.total_substates)
        times["em_seconds"] += time.perf_counter() - t0
        realigned = 0
        if csr is not None and it in opts.realign_iters:
            t0 = time.perf_counter()
            loglikes = sgmm.loglikes_batch(x_pad, num_frames=nf).to(torch.float32)
            alis, _ = align_batch(csr, loglikes, nf, ViterbiOptions(beam=opts.beam),
                                  device=dev)
            del loglikes
            for i, k in enumerate(keys_p):
                if alis[i] is not None:
                    ali[k] = np.asarray(alis[i])
                    realigned += 1
            times["realign_seconds"] += time.perf_counter() - t0
            log.info("realigned at iter %d", it)
        if history is not None:
            history.append({"iter": it, "flags": flags, "avg_like": avg,
                            "frames": accs.total_frames, "substates": sgmm.num_substates,
                            "realigned": realigned})
    if timings is not None:
        timings.update(times)
    return Sgmm2Model(base.tm, sgmm)
