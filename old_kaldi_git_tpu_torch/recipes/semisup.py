"""Semi-supervised chain (LF-MMI) training, the fork's specialty.

Counterpart of old_kaldi_git_tpu/recipes/semisup.py (reference
egs/*/s5/local/semisup/chain/run_tdnn_*semisupervised*.sh; Manohar et al.,
ICASSP 2018):

1. a seed chain model trained on the supervised subset;
2. the unlabelled audio decoded by the seed, keeping lattices
   (`decode_chain_lattices`);
3. each pruned lattice, its LM costs at --lattice-lm-scale, as that
   utterance's numerator (chain/semisup.py lattice_to_numerator);
4. LF-MMI continued on the supervised and unsupervised utterances together,
   the latter weighted by --unsup-egs-weight (`train_on_numerators`).

Supervised training graphs and lattice numerators share the padded arc
format of chain/e2e.py, so one step serves both.  On the seed model's
device.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.chain.e2e import NumeratorGraphBatch
from old_kaldi_git_tpu_torch.chain.loss import ChainLossOptions
from old_kaldi_git_tpu_torch.chain.semisup import lattice_to_numerator
from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph
from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch
from old_kaldi_git_tpu_torch.fst.lang import Lang
from old_kaldi_git_tpu_torch.lat.lattice import Lattice, lattice_from_decode, lattice_prune
from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
from old_kaldi_git_tpu_torch.models.tdnn import apply_orthonormal_constraints
from old_kaldi_git_tpu_torch.models.train import NnetTrainOptions, TrainState, make_optimizer
from old_kaldi_git_tpu_torch.recipes.chain import (
    ORTHONORMAL_INTERVAL, ChainModel, make_chain_e2e_step, numerator_graphs, pad_subsampled)
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass

log = get_logger("semisup")


@options_dataclass
class SemisupOptions:
    """Named after the reference recipe's flags."""

    num_epochs: int = 6
    minibatch_size: int = 8
    initial_lr: float = 3e-4
    final_lr: float = 5e-5
    # the decode of the unlabelled data
    beam: float = 16.0
    max_active: int = 7000
    lattice_beam: float = 8.0
    lattice_prune_beam: float = 4.0  # --lattice-prune-beam
    # supervision weights
    lattice_lm_scale: float = 0.5  # --lattice-lm-scale
    unsup_egs_weight: float = 1.0  # --unsup-egs-weight
    leaky_hmm_coefficient: float = 0.1
    l2_regularize: float = 5e-5
    seed: int = 0


def decode_chain_lattices(chain: ChainModel, graph: CsrGraph, feats: Dict[str, np.ndarray],
                          beam: float = 16.0, max_active: int = 7000,
                          lattice_beam: float = 8.0, acoustic_scale: float = 1.0
                          ) -> Dict[str, Lattice]:
    """One batch decode keeping raw (tid-level) lattices at the subsampled
    frame rate (nnet3-latgen-faster with a chain model), on the model's
    device: `decode_batch`'s lattice mode, then lattice_from_decode.  An
    utterance without per-frame tokens (a failed search, or a graph too
    large for the [B, S] regimes, which returns token records instead) has
    no lattice, with a warning, as in the JAX package."""
    keys = sorted(feats)
    fsf = chain.frame_subsampling_factor
    padded, nf = pad_subsampled(feats, keys, fsf)
    logits = chain.am.logits(padded, output_stride=fsf)
    results = decode_batch(graph, logits, nf, ViterbiOptions(
        beam=beam, max_active=max_active, acoustic_scale=acoustic_scale),
        want_lattice=True, device=chain.am.device)
    logits_h = logits.float().cpu().numpy()
    lats: Dict[str, Lattice] = {}
    for i, (k, res) in enumerate(zip(keys, results)):
        if res is None or res.frame_states is None:
            log.warning("no lattice for unsupervised utt %s", k)
            continue
        lat = lattice_from_decode(graph, logits_h[i, : nf[i]], res.frame_states,
                                  res.frame_costs, acoustic_scale, lattice_beam)
        if lat is not None:
            lats[k] = lat
    return lats


def lattice_numerators(seed_model: ChainModel, lats: Dict[str, Lattice],
                       opts: SemisupOptions) -> Tuple[List[str], List]:
    """(keys, numerators) of the lattices, each pruned at
    lattice_prune_beam (scales 1, 1) and taken through lattice_to_numerator;
    a lattice that gives no numerator is skipped with a warning."""
    keys, graphs = [], []
    for k in sorted(lats):
        pruned = lattice_prune(lats[k], opts.lattice_prune_beam, lm_scale=1.0, ac_scale=1.0)
        try:
            graphs.append(lattice_to_numerator(pruned, seed_model.tm, seed_model.den,
                                               lattice_lm_scale=opts.lattice_lm_scale))
            keys.append(k)
        except KaldiError as e:  # one bad lattice does not end the run
            log.warning("skipping unsupervised utterance %s: %s", k, e)
    return keys, graphs


def train_on_numerators(seed_model: ChainModel, feats: Dict[str, np.ndarray],
                        keys: List[str], graphs: List, weights: np.ndarray,
                        opts: SemisupOptions, history: Optional[List[dict]] = None,
                        report: Optional[dict] = None) -> ChainModel:
    """LF-MMI continued from a copy of the seed's network on the utterances
    `keys` with numerators `graphs` (normalised training graphs or lattice
    numerators) and sequence weights `weights`: Adam over shuffled full
    minibatches, the orthonormal constraint every 4 steps.  Tree,
    transition model and den graph stay the seed's.  history: one dict an
    epoch (`epoch`, `objf`, `steps`, `step_objf`); report: `steps` and the
    host-clock `step_seconds` of each."""
    dev = seed_model.am.device
    fsf = seed_model.frame_subsampling_factor
    gbatch = NumeratorGraphBatch.from_csr_graphs(graphs)
    feats_padded, nf_sub = pad_subsampled(feats, keys, fsf)
    model = copy.deepcopy(seed_model.am.model).train()
    loss_opts = ChainLossOptions(leaky_hmm_coefficient=opts.leaky_hmm_coefficient,
                                 l2_regularize=opts.l2_regularize, xent_regularize=0.0)
    B = opts.minibatch_size
    num_steps = opts.num_epochs * max(1, len(keys) // B)
    optimizer = make_optimizer(NnetTrainOptions(initial_lr=opts.initial_lr,
                                                final_lr=opts.final_lr), num_steps)
    state = TrainState(optimizer.init(dict(model.named_parameters())), 0)
    step_fn = make_chain_e2e_step(model, seed_model.den, optimizer, loss_opts, fsf)
    x_all = torch.from_numpy(feats_padded).to(dev)
    rng = np.random.default_rng(opts.seed)
    order = np.arange(len(keys))
    step_s = ({} if report is None else report).setdefault("step_seconds", [])
    for epoch in range(opts.num_epochs):
        rng.shuffle(order)
        batches = [order[i: i + B] for i in range(0, len(order) - B + 1, B)] or [order]
        objs = []
        for idx in batches:
            ts = time.perf_counter()
            state, _loss, metrics = step_fn(
                state, x_all.index_select(0, torch.from_numpy(idx).to(dev)), nf_sub[idx],
                gbatch.take(idx), seq_weights=weights[idx])
            step_s.append(time.perf_counter() - ts)
            objs.append(metrics["objf"])
            if state.step % ORTHONORMAL_INTERVAL == 0:
                apply_orthonormal_constraints(model)
        obj_v = torch.stack(objs).double().cpu().numpy()
        log.info("semisup epoch %d: objf %.4f (%d steps)", epoch, float(np.mean(obj_v)),
                 len(obj_v))
        if history is not None:
            history.append({"epoch": epoch, "objf": float(np.mean(obj_v)),
                            "steps": len(obj_v), "step_objf": obj_v.tolist()})
    if report is not None:
        report["steps"] = state.step
    am = seed_model.am
    out = AmNnet(am.config, model.eval(), None, device=dev, ivector_dim=am.ivector_dim)
    return ChainModel.from_parts(out, seed_model.ctx_dep, seed_model.tm, seed_model.den, fsf)


def train_chain_semisup(seed_model: ChainModel, lang: Lang, sup_feats: Dict[str, np.ndarray],
                        sup_transcripts: Dict[str, Sequence[str]],
                        unsup_feats: Dict[str, np.ndarray], decode_graph: CsrGraph,
                        opts: Optional[SemisupOptions] = None,
                        history: Optional[List[dict]] = None,
                        report: Optional[dict] = None) -> ChainModel:
    """LF-MMI continued from `seed_model` on supervised transcripts and
    lattice-supervised unlabelled audio (decoded on `decode_graph`).  The
    seed's tree, transition model and den graph are kept (the reference
    recipe may re-estimate the phone LM; keeping the seed's only makes
    num ≤ den easier to keep).  report: `lattices`, `unsup_utterances`,
    `num_states` and `num_arcs` of the padded numerator batch, and the
    host-clock `decode_seconds`, `numerator_seconds`, `train_seconds`."""
    opts = opts or SemisupOptions()
    report = {} if report is None else report
    t0 = time.perf_counter()
    lats = decode_chain_lattices(seed_model, decode_graph, unsup_feats, beam=opts.beam,
                                 max_active=opts.max_active, lattice_beam=opts.lattice_beam)
    report["decode_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    unsup_keys, unsup_graphs = lattice_numerators(seed_model, lats, opts)
    sup_keys = sorted(k for k in sup_transcripts if k in sup_feats)
    sup_graphs = numerator_graphs(lang, seed_model.ctx_dep, seed_model.tm, seed_model.den,
                                  [sup_transcripts[k] for k in sup_keys])
    keys = sup_keys + unsup_keys
    graphs = sup_graphs + unsup_graphs
    weights = np.concatenate([np.ones(len(sup_keys), np.float32),
                              np.full(len(unsup_keys), opts.unsup_egs_weight, np.float32)])
    feats_all = {**{k: sup_feats[k] for k in sup_keys},
                 **{k: unsup_feats[k] for k in unsup_keys}}
    report.update(lattices=len(lats), unsup_utterances=len(unsup_keys),
                  num_states=max(g.num_states for g in graphs),
                  num_arcs=max(g.num_arcs for g in graphs),
                  numerator_seconds=time.perf_counter() - t0)
    log.info("semisup: %d supervised + %d lattice-supervised utts, numerators ≤%d "
             "states/%d arcs", len(sup_keys), len(unsup_keys), report["num_states"],
             report["num_arcs"])
    t0 = time.perf_counter()
    out = train_on_numerators(seed_model, feats_all, keys, graphs, weights, opts, history,
                              report)
    report["train_seconds"] = time.perf_counter() - t0
    return out
