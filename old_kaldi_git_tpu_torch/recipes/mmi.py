"""MMI discriminative GMM training from lattices.

Counterpart of old_kaldi_git_tpu/recipes/mmi.py (reference
steps/train_mmi.sh): numerator statistics from the fixed alignments,
denominator statistics from the arc posteriors of decode lattices
(gmm-acc-stats2 over gmm-rescore-lattice'd lattices), an EBW update each
iteration (gmm/ebw.py).  Where the reference rescores its lattices with the
updated model, each iteration decodes anew, as the JAX package does: the
GMM kernel scores the updated model (EBW drops its packed rows), the
token-sparse search with lattice records (the gather kernel) makes the
lattices.  Both statistics come from `accumulate_corpus` on the model's
device, the denominator's with the posteriors as frame weights.  Standard
MMI (no boosting), as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.gmm.ebw import EbwOptions, ebw_update
from old_kaldi_git_tpu_torch.gmm.mle import AccumAmDiagGmm
from old_kaldi_git_tpu_torch.hmm.hmm_utils import alignment_to_pdfs
from old_kaldi_git_tpu_torch.lat.lattice import lattice_arc_posteriors
from old_kaldi_git_tpu_torch.recipes.decode import DecodeOptions, decode_dataset_with_lattices
from old_kaldi_git_tpu_torch.utils.log import get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass

log = get_logger("mmi")


@options_dataclass
class MmiTrainOptions:
    num_iters: int = 4
    acoustic_scale: float = 0.1
    beam: float = 16.0
    lattice_beam: float = 10.0
    ebw_e: float = 2.0
    tau: float = 0.0  # i-smoothing
    update_weights: bool = True


def accumulate_den_stats_from_lattices(model: AmGmmModel, lattices: Dict[str, object],
                                       feats: Dict[str, np.ndarray],
                                       acoustic_scale: float) -> AccumAmDiagGmm:
    """Soft pdf statistics from the lattices' emitting-arc posteriors above
    1e-5 at the decode's scales (the frame of an arc is that of its
    destination state), every utterance's frames in one
    accumulate_corpus."""
    tid_to_pdf = model.tm.tid_to_pdf_array()
    frames, pdfs, weights = [], [], []
    for k, lat in lattices.items():
        post = lattice_arc_posteriors(lat, lm_scale=1.0, ac_scale=acoustic_scale)
        for s in range(lat.num_states):
            for a, p in zip(lat.arcs[s], post[s]):
                if a.ilabel == 0 or p <= 1e-5:
                    continue
                t = lat.state_time[a.nextstate]
                if t < 0 or t >= feats[k].shape[0]:
                    continue
                frames.append(feats[k][t])
                pdfs.append(int(tid_to_pdf[a.ilabel]))
                weights.append(p)
    acc = AccumAmDiagGmm(model.am)
    if frames:
        acc.accumulate_corpus(model.am, np.stack(frames), np.asarray(pdfs),
                              np.asarray(weights))
    return acc


def accumulate_num_stats(model: AmGmmModel, feats: Dict[str, np.ndarray],
                         alignments: Dict[str, np.ndarray], keys: List[str]
                         ) -> AccumAmDiagGmm:
    """Hard-alignment statistics of `keys`, in one accumulate_corpus."""
    acc = AccumAmDiagGmm(model.am)
    acc.accumulate_corpus(
        model.am, np.concatenate([feats[k] for k in keys]),
        np.concatenate([np.asarray(alignment_to_pdfs(model.tm, alignments[k]))
                        for k in keys]))
    return acc


def train_mmi(model: AmGmmModel, graph: CsrGraph, lang, feats: Dict[str, np.ndarray],
              alignments: Dict[str, np.ndarray], opts: Optional[MmiTrainOptions] = None,
              history: Optional[List[dict]] = None) -> AmGmmModel:
    """EBW/MMI iterations on the model's device; updates the model in place
    and returns it.  `lang` is the word table (unused but by the decode's
    signature).  history: one dict an iteration (`iter`, `num_frames`,
    `den_frames`, `lattices` (their count), `scaled_num_like_per_frame`,
    `updated`, `skipped`, and the iteration's `lattice_dict` itself, whose
    statistics a caller can redo elsewhere)."""
    opts = opts or MmiTrainOptions()
    keys = [k for k, a in alignments.items() if a is not None and k in feats]
    for it in range(opts.num_iters):
        num_acc = accumulate_num_stats(model, feats, alignments, keys)
        lats = decode_dataset_with_lattices(
            model, graph, lang, {k: feats[k] for k in keys},
            DecodeOptions(beam=opts.beam, acoustic_scale=opts.acoustic_scale),
            lattice_beam=opts.lattice_beam)
        den_acc = accumulate_den_stats_from_lattices(model, lats, feats, opts.acoustic_scale)
        objf = num_acc.tot_like * opts.acoustic_scale / max(num_acc.tot_frames, 1.0)
        log.info("MMI iter %d: num frames %.0f, den frames %.0f, scaled num like/frame %.4f",
                 it, num_acc.tot_frames, den_acc.tot_frames, objf)
        updated, skipped = ebw_update(model.am, num_acc, den_acc, EbwOptions(
            e=opts.ebw_e, tau=opts.tau, update_weights=opts.update_weights))
        if history is not None:
            history.append({"iter": it, "num_frames": num_acc.tot_frames,
                            "den_frames": den_acc.tot_frames, "lattices": len(lats),
                            "scaled_num_like_per_frame": objf, "updated": updated,
                            "skipped": skipped, "lattice_dict": lats})
    return model
