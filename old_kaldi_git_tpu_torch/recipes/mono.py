"""Monophone GMM-HMM training.

Counterpart of old_kaldi_git_tpu/recipes/mono.py (reference
steps/train_mono.sh): flat start from the global feature stats
(gmm-init-mono), one training graph per utterance over the monophone tree,
then the shared loop of recipes/gmm_common.py (align → accumulate → MLE
update with mixing up, transition re-estimation), on the model's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.decoder.graph import GraphCompiler
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.fst.lang import Lang
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, AmGmmModel
from old_kaldi_git_tpu_torch.hmm.topology import HmmTopology
from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
from old_kaldi_git_tpu_torch.recipes.gmm_common import (
    GmmTrainOptions, align_all, gmm_training_loop)
from old_kaldi_git_tpu_torch.tree.context_dep import monophone_context_dependency
from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
from old_kaldi_git_tpu_torch.utils.log import get_logger
from old_kaldi_git_tpu_torch.utils.timing import StageClock

log = get_logger("mono")

# the public name the recipes use
MonoTrainOptions = GmmTrainOptions


def align_utts(am: AmDiagGmm, graphs, feats_padded, num_frames, opts):
    """(alignments, scores) of padded utterances on their training graphs
    (gmm_common.align_all; opts a ViterbiOptions)."""
    return align_all(am, graphs, feats_padded, num_frames, opts)


def train_mono(
    feats: Dict[str, np.ndarray],
    transcripts: Dict[str, List[str]],
    lang: Lang,
    opts: Optional[GmmTrainOptions] = None,
    device: DeviceLike = None,
    timings: Optional[Dict[str, float]] = None,
    history: Optional[List[dict]] = None,
) -> Tuple[AmGmmModel, Dict[str, np.ndarray]]:
    """Returns (final model, alignments by utterance).  The flat start's
    global mean and variance are float32 numpy over every frame, as the
    JAX package computes them.  timings: gmm_training_loop's, plus
    `graphs_seconds`; history: gmm_training_loop's."""
    dev = resolve_device(device)
    opts = opts or GmmTrainOptions(totgauss=100)
    clock = StageClock(dev, timings)
    keys, feats_padded, num_frames = pad_feature_batch(feats)
    phones = lang.real_phone_ids
    topo = HmmTopology.standard(phones, silence_phones=[lang.silence_id])
    ctx_dep = monophone_context_dependency(
        phones, {p: topo.num_pdf_classes(p) for p in phones})
    all_feats = np.concatenate([feats[k] for k in keys], axis=0)
    glob_mean = all_feats.mean(axis=0)
    glob_var = all_feats.var(axis=0) + 1e-3
    am = AmDiagGmm.init_mono(ctx_dep.num_pdfs, glob_mean, glob_var, perturb=0.01,
                             device=dev)
    tm = TransitionModel.from_context_dependency(ctx_dep, topo)
    log.info("train_mono: %d utts, %d pdfs, %d tids", len(keys), ctx_dep.num_pdfs,
             tm.num_tids)
    graphs = GraphCompiler(lang, ctx_dep, tm).compile_csr_graphs(
        [transcripts[k] for k in keys])
    clock.lap("graphs_seconds")
    am, alignments = gmm_training_loop(am, tm, graphs, keys, feats_padded, num_frames,
                                       opts, timings=timings, history=history)
    model = AmGmmModel(tm, am)
    return model, {k: a for k, a in zip(keys, alignments) if a is not None}
