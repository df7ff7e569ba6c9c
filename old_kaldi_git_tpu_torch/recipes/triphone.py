"""Triphone GMM training on delta features.

Counterpart of the deltas recipe of old_kaldi_git_tpu/recipes/triphone.py
(reference steps/train_deltas.sh): tree statistics from the previous
system's alignments (acc-tree-stats), the tree (build-tree), one Gaussian a
leaf from the leaf's statistics (gmm-init-model), the alignments converted
to the new tree (convert-ali), then the shared loop of
recipes/gmm_common.py on the model's device.  LDA+MLLT and SAT need the
feature transforms (`transform/`), which are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.decoder.graph import GraphCompiler
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.fst.lang import Lang
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, AmGmmModel
from old_kaldi_git_tpu_torch.gmm.mle import leaf_gmms
from old_kaldi_git_tpu_torch.hmm.hmm_utils import convert_alignment
from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
from old_kaldi_git_tpu_torch.recipes.gmm_common import GmmTrainOptions, gmm_training_loop
from old_kaldi_git_tpu_torch.tree.build_tree import accumulate_tree_stats, build_tree
from old_kaldi_git_tpu_torch.tree.context_dep import ContextDependency
from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
from old_kaldi_git_tpu_torch.utils.log import get_logger
from old_kaldi_git_tpu_torch.utils.timing import StageClock

log = get_logger("tri")


def _build_tree_and_model(
    feats: Dict[str, np.ndarray],
    alignments: Dict[str, np.ndarray],
    prev_model: AmGmmModel,
    lang: Lang,
    num_leaves: int,
    N: int = 3,
    P: int = 1,
    thresh: float = 20.0,
    device: DeviceLike = None,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[ContextDependency, TransitionModel, AmDiagGmm, Dict[str, np.ndarray]]:
    """acc-tree-stats → build-tree → leaf GMMs → convert-ali.  timings
    receives `tree_stats_seconds`, `tree_seconds` and `tree_init_seconds`
    (the leaf GMMs and the converted alignments).

    The global statistics that a leaf of 3 counts or fewer takes count the
    first leaf twice, as the JAX package's stage does."""
    dev = resolve_device(device)
    clock = StageClock(dev, timings)
    stats: Dict[tuple, object] = {}
    for k, ali in alignments.items():
        if ali is not None:
            accumulate_tree_stats(ali, feats[k], prev_model.tm, N=N, P=P, stats=stats)
    clock.lap("tree_stats_seconds")
    phones = lang.real_phone_ids
    topo = prev_model.tm.topo
    ctx_dep = build_tree(stats, phones, {p: topo.num_pdf_classes(p) for p in phones},
                         N=N, P=P, max_leaves=num_leaves, thresh=thresh)
    clock.lap("tree_seconds")
    tm = TransitionModel.from_context_dependency(ctx_dep, topo)
    leaf_stats: List[object] = [None] * ctx_dep.num_pdfs
    for event, st in stats.items():
        d = dict(event)
        pdf = ctx_dep.compute([d[i] for i in range(N)], d[-1])
        if leaf_stats[pdf] is None:
            leaf_stats[pdf] = st.copy()
        else:
            leaf_stats[pdf].add(st)
    glob = None
    for st in leaf_stats:
        if st is not None:
            glob = st.copy() if glob is None else glob
            glob.add(st)
    am = AmDiagGmm(leaf_gmms(leaf_stats, glob), dev)
    new_ali = {k: convert_alignment(ali, prev_model.tm, tm, ctx_dep)
               for k, ali in alignments.items() if ali is not None}
    clock.lap("tree_init_seconds")
    log.info("tree: %d leaves; converted %d alignments", ctx_dep.num_pdfs, len(new_ali))
    return ctx_dep, tm, am, new_ali


def train_deltas(
    feats: Dict[str, np.ndarray],
    transcripts: Dict[str, List[str]],
    lang: Lang,
    prev_model: AmGmmModel,
    prev_alignments: Dict[str, np.ndarray],
    num_leaves: int = 200,
    opts: Optional[GmmTrainOptions] = None,
    device: DeviceLike = None,
    timings: Optional[Dict[str, float]] = None,
    history: Optional[List[dict]] = None,
) -> Tuple[AmGmmModel, ContextDependency, Dict[str, np.ndarray]]:
    """A triphone system on the given features (reference train_deltas.sh),
    starting from the previous system's converted alignments.  Returns
    (model, tree, alignments by utterance).  timings: _build_tree_and_model's,
    `graphs_seconds` and gmm_training_loop's; history: gmm_training_loop's."""
    dev = resolve_device(device)
    opts = opts or GmmTrainOptions()
    ctx_dep, tm, am, conv_ali = _build_tree_and_model(
        feats, prev_alignments, prev_model, lang, num_leaves, device=dev,
        timings=timings)
    clock = StageClock(dev, timings)
    keys, feats_padded, num_frames = pad_feature_batch(feats)
    graphs = GraphCompiler(lang, ctx_dep, tm).compile_csr_graphs(
        [transcripts[k] for k in keys])
    clock.lap("graphs_seconds")
    am, alignments = gmm_training_loop(
        am, tm, graphs, keys, feats_padded, num_frames, opts,
        initial_alignments=[conv_ali.get(k) for k in keys], timings=timings,
        history=history)
    model = AmGmmModel(tm, am)
    return model, ctx_dep, {k: a for k, a in zip(keys, alignments) if a is not None}
