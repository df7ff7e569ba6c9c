"""Triphone GMM training: deltas, LDA+MLLT, SAT/fMLLR.

Counterpart of old_kaldi_git_tpu/recipes/triphone.py (reference
steps/train_deltas.sh, train_lda_mllt.sh, train_sat.sh; BASELINE config 2):

- `train_deltas`: tree statistics from the previous system's alignments
  (acc-tree-stats), the tree (build-tree), one Gaussian a leaf from the
  leaf's statistics (gmm-init-model), the alignments converted to the new
  tree (convert-ali), then the shared loop of recipes/gmm_common.py on the
  model's device.
- `train_lda_mllt`: the statics spliced ±3 on the device, LDA over the
  previous system's pdfs (transform/lda.py), the tree on the projected
  features, then segments of the GMM loop with MLLT updates between them,
  each composed into the transform and the model's means; the features are
  projected on the device, one product an update.
- `estimate_fmllr_per_speaker`: every speaker's statistics from one pass
  over the aligned frames, the transforms solved for all speakers at once
  (transform/fmllr.py).
- `train_sat`: fMLLR estimated between segments from the unadapted
  features, training on the adapted ones.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.decoder.graph import GraphCompiler
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.fst.lang import Lang
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, AmGmmModel
from old_kaldi_git_tpu_torch.gmm.mle import leaf_gmms
from old_kaldi_git_tpu_torch.hmm.hmm_utils import alignment_to_pdfs, convert_alignment
from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
from old_kaldi_git_tpu_torch.recipes.gmm_common import GmmTrainOptions, gmm_training_loop
from old_kaldi_git_tpu_torch.transform.fmllr import (
    FmllrAccs,
    accumulate_speakers,
    compute_fmllr_transforms,
)
from old_kaldi_git_tpu_torch.transform.lda import LdaEstimate
from old_kaldi_git_tpu_torch.transform.mllt import MlltAccs, transform_gmm_means, update_mllt
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


@dataclasses.dataclass
class LdaMlltResult:
    model: AmGmmModel
    ctx_dep: ContextDependency
    transform: np.ndarray  # [target_dim, spliced_dim] float64
    alignments: Dict[str, np.ndarray]


def splice_numpy(x: np.ndarray, left: int = 3, right: int = 3) -> np.ndarray:
    """[T, D] → [T, (left+1+right)·D]: each frame with its neighbours, the
    edge frames repeated."""
    T = x.shape[0]
    idx = np.clip(np.arange(T)[:, None] + np.arange(-left, right + 1)[None, :], 0, T - 1)
    return x[idx].reshape(T, -1)


def splice_padded(x: torch.Tensor, num_frames: torch.Tensor, left: int = 3,
                  right: int = 3) -> torch.Tensor:
    """splice_numpy for every utterance of a padded batch [B, T, D] at once,
    on its device: each utterance's edges repeat its own first and last
    frames.  Returns [B, T, (left+1+right)·D]; frames past an utterance's
    end hold copies of its last frame."""
    B, T, D = x.shape
    idx = torch.arange(T, device=x.device)[:, None] + torch.arange(
        -left, right + 1, device=x.device)[None, :]
    idx = torch.minimum(idx.clamp(min=0)[None], (num_frames - 1).clamp(min=0)[:, None, None])
    W = idx.shape[2]
    out = torch.gather(x, 1, idx.reshape(B, T * W, 1).expand(B, T * W, D))
    return out.reshape(B, T, W * D)


def _frame_mask(num_frames: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T, 1] float32: 1 on an utterance's frames, 0 on its padding."""
    return (torch.arange(T, device=num_frames.device)[None, :]
            < num_frames[:, None]).to(torch.float32)[:, :, None]


def _project(spliced: torch.Tensor, transform: np.ndarray, mask: torch.Tensor) -> torch.Tensor:
    """spliced [B, T, S] float32 by transform [d, S] in float64, cast to
    float32 (the JAX package's numpy promotes float32 times float64), with
    the padding 0 as pad_feature_batch leaves it."""
    t = torch.from_numpy(np.ascontiguousarray(transform)).to(spliced.device)
    return (spliced.double() @ t.T).float() * mask


def _aligned_frames(keys: Sequence[str], alignments: Sequence[Optional[np.ndarray]],
                    tm: TransitionModel, num_frames: np.ndarray, device: torch.device):
    """Every aligned frame of a padded batch: (rows, cols) index tensors
    (rows: each frame's utterance) and pdf ids [N] on `device`; an
    alignment longer than its utterance is cut to it."""
    tid2pdf = tm.tid_to_pdf_array()
    rows, cols, pdfs = [], [], []
    for i, ali in enumerate(alignments):
        if ali is None:
            continue
        p = tid2pdf[np.asarray(ali, np.int64)][: int(num_frames[i])]
        rows.append(np.full(len(p), i))
        cols.append(np.arange(len(p)))
        pdfs.append(p)

    def cat(a):
        return torch.from_numpy(np.concatenate(a).astype(np.int64)).to(device)

    return (cat(rows), cat(cols)), cat(pdfs)


def _tag_segment(history: Optional[List[dict]], start: int, seg: int) -> None:
    if history is not None:
        for h in history[start:]:
            h["segment"] = seg


def train_lda_mllt(
    static_feats: Dict[str, np.ndarray],
    transcripts: Dict[str, List[str]],
    lang: Lang,
    prev_model: AmGmmModel,
    prev_alignments: Dict[str, np.ndarray],
    num_leaves: int = 250,
    target_dim: int = 40,
    splice_context: int = 3,
    mllt_iters: Sequence[int] = (2, 4, 6, 12),
    opts: Optional[GmmTrainOptions] = None,
    device: DeviceLike = None,
    timings: Optional[Dict[str, float]] = None,
    history: Optional[List[dict]] = None,
) -> LdaMlltResult:
    """reference train_lda_mllt.sh on `device` (None: the GPU): LDA over the
    spliced statics (classes: the previous system's pdfs), then triphone
    training with MLLT updates composed into the transform and the means.

    The iterations run in segments between the sorted `mllt_iters`, up to
    opts.num_iters: each segment is a gmm_training_loop of its own length,
    realigning at its iterations 1.. and mixing up towards opts.totgauss
    from its own start; an MLLT update follows every segment but the last,
    also a segment of no iterations (mllt_iters past num_iters), as the
    JAX package does: the defaults (2, 4, 6, 12) with num_iters=8 run 12
    iterations and 4 updates.

    timings: `splice_seconds`, `lda_seconds`, _build_tree_and_model's,
    `graphs_seconds`, gmm_training_loop's summed, `segment<i>_seconds` and
    `mllt<i>_seconds`.  history: gmm_training_loop's dicts, each with its
    `segment`."""
    dev = resolve_device(device)
    opts = opts or GmmTrainOptions()
    clock = StageClock(dev, timings)
    keys, statics, nf = pad_feature_batch(static_feats)
    nf_t = torch.from_numpy(nf.astype(np.int64)).to(dev)
    spliced = splice_padded(torch.from_numpy(statics).to(dev), nf_t, splice_context,
                            splice_context)
    del statics
    mask = _frame_mask(nf_t, spliced.shape[1])
    sp_dim = spliced.shape[2]
    target_dim = min(target_dim, sp_dim)
    clock.lap("splice_seconds")

    lda = LdaEstimate(prev_model.am.num_pdfs, sp_dim, dev)
    prev = [prev_alignments.get(k) for k in keys]
    sel, pdfs = _aligned_frames(keys, prev, prev_model.tm, nf, dev)
    lda.accumulate(spliced[sel], pdfs)
    transform = lda.estimate(target_dim)
    x = _project(spliced, transform, mask)
    clock.lap("lda_seconds")

    host = {k: x[i, : nf[i]].cpu().numpy() for i, k in enumerate(keys)}
    ctx_dep, tm, am, conv_ali = _build_tree_and_model(
        host, prev_alignments, prev_model, lang, num_leaves, device=dev, timings=timings)
    del host
    clock = StageClock(dev, timings)
    graphs = GraphCompiler(lang, ctx_dep, tm).compile_csr_graphs(
        [transcripts[k] for k in keys])
    clock.lap("graphs_seconds")
    alignments = [conv_ali.get(k) for k in keys]

    boundaries = [0] + sorted(mllt_iters) + [opts.num_iters]
    for seg in range(len(boundaries) - 1):
        seg_iters = boundaries[seg + 1] - boundaries[seg]
        if seg_iters > 0:
            start = len(history) if history is not None else 0
            seg_opts = dataclasses.replace(opts, num_iters=seg_iters,
                                           realign_iters=tuple(range(1, seg_iters)))
            am, alignments = gmm_training_loop(
                am, tm, graphs, keys, x, nf, seg_opts, initial_alignments=alignments,
                timings=timings, history=history)
            _tag_segment(history, start, seg)
            clock.lap(f"segment{seg}_seconds")
        if seg < len(boundaries) - 2:
            accs = MlltAccs(target_dim, dev)
            sel, pdfs = _aligned_frames(keys, alignments, tm, nf, dev)
            accs.accumulate(am, x[sel], pdfs, groups=sel[0])
            m, _ = update_mllt(accs)
            transform = m @ transform
            transform_gmm_means(am, m)
            x = _project(spliced, transform, mask)
            clock.lap(f"mllt{seg}_seconds")

    model = AmGmmModel(tm, am)
    ali = {k: a for k, a in zip(keys, alignments) if a is not None}
    return LdaMlltResult(model, ctx_dep, transform, ali)


def estimate_fmllr_per_speaker(
    model: AmGmmModel,
    feats: Dict[str, np.ndarray],
    alignments: Dict[str, np.ndarray],
    utt2spk: Dict[str, str],
    min_count: float = 100.0,
    silence_weight: float = 1.0,
) -> Dict[str, np.ndarray]:
    """Per-speaker fMLLR transforms [D, D+1] (float64) from aligned data
    (reference gmm-est-fmllr over spk2utt), on the model's device: one pass
    over every utterance's aligned frames, then all speakers' row updates
    together.  A speaker under min_count frames gets no transform.
    `silence_weight` is the reference's option; as in the JAX package, no
    frame is weighted by it."""
    dev = model.am.device
    dim = next(iter(feats.values())).shape[1]
    speakers: Dict[str, int] = {}
    xs, pdfs, spk, utt = [], [], [], []
    for k, ali in alignments.items():
        if ali is None or k not in feats:
            continue
        s = speakers.setdefault(utt2spk.get(k, k), len(speakers))
        p = np.asarray(alignment_to_pdfs(model.tm, ali))
        t = min(len(p), feats[k].shape[0])
        xs.append(np.asarray(feats[k][:t]))
        pdfs.append(p[:t])
        spk.append(np.full(t, s))
        utt.append(np.full(t, len(utt)))
    if not speakers:
        return {}
    accs = [FmllrAccs(dim, dev) for _ in speakers]
    accumulate_speakers(accs, model.am, np.concatenate(xs), np.concatenate(pdfs),
                        np.concatenate(spk), groups=np.concatenate(utt))
    ws = compute_fmllr_transforms(accs, min_count=min_count)
    return {name: w for name, w in zip(speakers, ws) if w is not None}


def _adapt_padded(x: torch.Tensor, keys: Sequence[str], utt2spk: Dict[str, str],
                  transforms: Dict[str, np.ndarray], mask: torch.Tensor) -> torch.Tensor:
    """Each utterance of a padded batch through its speaker's transform
    (float64, cast to float32), unchanged when its speaker has none."""
    if not transforms:
        return x
    B, _, D = x.shape
    W = np.zeros((B, D, D + 1))
    W[:, :, :D] = np.eye(D)
    has = np.zeros(B, bool)
    for i, k in enumerate(keys):
        s = utt2spk.get(k, k)
        if s in transforms:
            W[i], has[i] = transforms[s], True
    w = torch.from_numpy(W).to(x.device)
    y = (torch.bmm(x.double(), w[:, :, :D].transpose(1, 2)) + w[:, None, :, D]).float() * mask
    return torch.where(torch.from_numpy(has).to(x.device)[:, None, None], y, x)


def train_sat(
    feats: Dict[str, np.ndarray],
    transcripts: Dict[str, List[str]],
    lang: Lang,
    prev_model: AmGmmModel,
    prev_alignments: Dict[str, np.ndarray],
    utt2spk: Dict[str, str],
    num_leaves: int = 300,
    fmllr_iters: Sequence[int] = (2, 4, 6, 12),
    opts: Optional[GmmTrainOptions] = None,
    device: DeviceLike = None,
    timings: Optional[Dict[str, float]] = None,
    history: Optional[List[dict]] = None,
) -> Tuple[AmGmmModel, ContextDependency, Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Speaker-adaptive training (reference train_sat.sh) on `device`: the
    segments of train_lda_mllt, with per-speaker fMLLR estimated between
    them from the unadapted features and the next segment trained on the
    adapted ones.  Returns (model, tree, transforms by speaker, alignments).
    timings: _build_tree_and_model's, `graphs_seconds`, gmm_training_loop's
    and `fmllr_seconds`; history: gmm_training_loop's, with `segment`."""
    dev = resolve_device(device)
    opts = opts or GmmTrainOptions()
    ctx_dep, tm, am, conv_ali = _build_tree_and_model(
        feats, prev_alignments, prev_model, lang, num_leaves, device=dev, timings=timings)
    clock = StageClock(dev, timings)
    keys, padded, nf = pad_feature_batch(feats)
    x0 = torch.from_numpy(padded).to(dev)
    mask = _frame_mask(torch.from_numpy(nf.astype(np.int64)).to(dev), x0.shape[1])
    graphs = GraphCompiler(lang, ctx_dep, tm).compile_csr_graphs(
        [transcripts[k] for k in keys])
    clock.lap("graphs_seconds")
    alignments = [conv_ali.get(k) for k in keys]
    transforms: Dict[str, np.ndarray] = {}
    boundaries = [0] + sorted(fmllr_iters) + [opts.num_iters]
    for seg in range(len(boundaries) - 1):
        seg_iters = boundaries[seg + 1] - boundaries[seg]
        if seg_iters > 0:
            start = len(history) if history is not None else 0
            seg_opts = dataclasses.replace(opts, num_iters=seg_iters,
                                           realign_iters=tuple(range(1, seg_iters)))
            am, alignments = gmm_training_loop(
                am, tm, graphs, keys, _adapt_padded(x0, keys, utt2spk, transforms, mask),
                nf, seg_opts, initial_alignments=alignments, timings=timings,
                history=history)
            _tag_segment(history, start, seg)
            clock.lap(None)
        if seg < len(boundaries) - 2:
            ali = {k: a for k, a in zip(keys, alignments) if a is not None}
            transforms = estimate_fmllr_per_speaker(AmGmmModel(tm, am), feats, ali, utt2spk)
            log.info("SAT: estimated fMLLR for %d speakers", len(transforms))
            clock.lap("fmllr_seconds")
    model = AmGmmModel(tm, am)
    ali = {k: a for k, a in zip(keys, alignments) if a is not None}
    return model, ctx_dep, transforms, ali
