"""Chain (LF-MMI) acoustic models: loading, training, decode graph, decode.

Counterpart of old_kaldi_git_tpu/recipes/chain.py (reference
steps/nnet3/chain/train.py and local/chain/run_tdnn.sh): GMM alignments →
the chain topology and tree → phone LM → denominator graph → supervision →
LF-MMI training of a TDNN-F at frame-subsampling 3 → a chain decode graph
(self-loop-scale 1.0) → decode at acoustic scale 1.0 on the raw logits (no
log-softmax, no priors).

A `chain.mdl` pickle of the JAX package holds the network (`am`: config,
flax variables, priors, iVector dim), the tree and transition model, the
denominator graph, the frame-subsampling factor and per-layer learning-rate
factors; `ChainModel.load` converts all of it but the factors, which no
ported path reads, and reads the port's own format (`ChainModel.save`:
torch.save of the network's saved dict and the port's tree, transition
model and den graph).  A model the port trains carries its own tree,
transition model and den graph, so its decode graph is built from them
(`make_chain_decode_graph`), not read from the committed `chain_hclg.npz`.
`combine_chain_models` weighs several models on held-out chain egs (reference
nnet3-chain-combine).  `train_chain_e2e` is the flat-start variant
(reference steps/nnet3/chain/e2e/): no GMM system and no alignments, each
utterance's numerator its whole training graph (chain/e2e.py).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.chain.den_graph import DenominatorGraph, make_denominator_graph
from old_kaldi_git_tpu_torch.chain.e2e import (
    NumeratorGraphBatch, chain_e2e_loss, normalize_numerator_csr)
from old_kaldi_git_tpu_torch.chain.loss import ChainLossOptions, chain_loss
from old_kaldi_git_tpu_torch.chain.phone_lm import estimate_phone_lm
from old_kaldi_git_tpu_torch.chain.supervision import (
    alignment_to_supervision, chain_xent_labels, pad_supervisions)
from old_kaldi_git_tpu_torch.chain.topology import chain_topology
from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph
from old_kaldi_git_tpu_torch.decoder.graph import GraphCompiler, mkgraph_csr
from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.fst.lang import Lang
from old_kaldi_git_tpu_torch.fst.vector_fst import VectorFst
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.hmm.hmm_utils import alignment_to_phones
from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
from old_kaldi_git_tpu_torch.models.am_nnet import _ZIP_MAGIC, AmNnet
from old_kaldi_git_tpu_torch.models.natural_gradient import NgCollector
from old_kaldi_git_tpu_torch.models.tdnn import apply_orthonormal_constraints, make_tdnnf
from old_kaldi_git_tpu_torch.models.train import (
    NnetOptimizer, NnetTrainOptions, TrainState, apply_update, backstitch_step,
    check_divergence, combine_weights, combined_state, make_optimizer, ng_step, snapshot,
    stacked_state)
from old_kaldi_git_tpu_torch.recipes.nnet3 import append_ivector_feats
from old_kaldi_git_tpu_torch.tree.build_tree import accumulate_tree_stats, build_tree
from old_kaldi_git_tpu_torch.tree.context_dep import (
    ContextDependency, biphone_context_dependency, monophone_context_dependency)
from old_kaldi_git_tpu_torch.tree.event_map import KEY_PDF_CLASS, make_event
from old_kaldi_git_tpu_torch.utils.log import get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass

log = get_logger("chain")

ORTHONORMAL_INTERVAL = 4  # steps between tdnnf re-constraints (the JAX loop's)


@options_dataclass
class ChainTrainOptions:
    num_epochs: int = 10
    minibatch_size: int = 8
    frame_subsampling_factor: int = 3
    left_tolerance: int = 5
    right_tolerance: int = 5
    phone_lm_order: int = 2
    hidden_dim: int = 256
    bottleneck_dim: int = 64
    num_layers: int = 5
    initial_lr: float = 1e-3
    final_lr: float = 1e-4
    optimizer: str = "adam"  # adam | sgd | ng-sgd | ng-sgd-act
    leaky_hmm_coefficient: float = 0.1
    l2_regularize: float = 5e-5
    xent_regularize: float = 0.1
    backstitch_scale: float = 0.0
    backstitch_interval: int = 1
    max_lr_retries: int = 2
    seed: int = 0
    # 1 = per-phone pdfs; 2 = left-biphone tree from the alignment's stats
    # (build_tree.sh --context-width=2 --central-position=1)
    tree_context_width: int = 1
    tree_max_leaves: int = 500
    tree_thresh: float = 100.0
    # tdnnf layers past this index use time_stride = frame_subsampling_factor,
    # so the trunk past them runs at the subsampled rate; 0 = stride 1
    num_full_rate_layers: int = 3


@dataclasses.dataclass
class ChainModel:
    am: AmNnet
    tid_to_pdf: np.ndarray  # [num_tids + 1] int32, entry 0 = -1
    frame_subsampling_factor: int
    tid_to_phone: np.ndarray  # [num_tids + 1] int32, entry 0 = -1
    ctx_dep: Optional[ContextDependency] = None
    tm: Optional[TransitionModel] = None
    den: Optional[DenominatorGraph] = None

    @staticmethod
    def from_parts(am: AmNnet, ctx_dep: ContextDependency, tm: TransitionModel,
                   den: DenominatorGraph, fsf: int) -> "ChainModel":
        return ChainModel(am, tm.tid_to_pdf_array(), fsf, tm.tid_to_phone_array(),
                          ctx_dep, tm, den)

    def save(self, path: str) -> None:
        """The port's format: torch.save of the network's `AmNnet.saved()`
        dict, the port's tree, transition model and den graph, and the
        frame-subsampling factor."""
        torch.save({"format": CHAIN_SAVE_FORMAT, "am": self.am.saved(),
                    "ctx_dep": self.ctx_dep, "tm": self.tm, "den": self.den,
                    "fsf": self.frame_subsampling_factor}, path)

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "ChainModel":
        """A model the port saved, or a `ChainModel.save` pickle of the JAX
        package, read without it."""
        with open(path, "rb") as f:
            magic = f.read(len(_ZIP_MAGIC))
        if magic == _ZIP_MAGIC:
            d = torch.load(path, map_location="cpu", weights_only=False)
            if d.get("format") != CHAIN_SAVE_FORMAT:
                raise ValueError(f"{path}: not a {CHAIN_SAVE_FORMAT} file")
            return ChainModel.from_parts(AmNnet.from_saved(d["am"], device, path),
                                         d["ctx_dep"], d["tm"], d["den"], int(d["fsf"]))
        d = convert.load_pickle(path)
        am = d["am"]
        return ChainModel.from_parts(
            convert.am_nnet_from_jax(
                vars(am["config"]), am["variables"], am["log_priors"],
                device=device, ivector_dim=int(am.get("ivector_dim", 0))),
            convert.context_dependency_from_pickle(d["ctx_dep"]),
            convert.transition_model_from_pickle(d["tm"]),
            convert.den_graph_from_pickle(d["den"]), int(d["fsf"]))


CHAIN_SAVE_FORMAT = "old_kaldi_git_tpu_torch.ChainModel/1"
METRICS = ("objf", "num", "den", "l2", "xent")


def chain_objective(logits: torch.Tensor, den: DenominatorGraph,
                    loss_opts: ChainLossOptions, b_pdf, b_allowed, b_nf, b_sl, b_adv,
                    b_xent) -> Tuple[torch.Tensor, ...]:
    """LF-MMI (+ xent) loss of chain logits already cut to the supervision's
    frames, then its metrics in METRICS' order, detached (xent 0 without
    the regulariser)."""
    loss, metrics = chain_loss(logits, den, b_pdf, b_allowed, b_nf, b_sl, b_adv, loss_opts)
    xent = torch.zeros((), dtype=logits.dtype, device=logits.device)
    if loss_opts.xent_regularize > 0:
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, b_xent[..., None].long())[..., 0]
        mask = (torch.arange(logits.shape[1], device=logits.device)[None, :]
                < b_nf[:, None]).to(logits.dtype)
        xent = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        loss = loss + loss_opts.xent_regularize * xent
    metrics["xent"] = xent
    return (loss, *(metrics[k].detach() for k in METRICS))


def make_chain_step(model: torch.nn.Module, den: DenominatorGraph,
                    optimizer: NnetOptimizer, loss_opts: ChainLossOptions, fsf: int,
                    backstitch_scale: float = 0.0, backstitch_interval: int = 1,
                    ng_activation: bool = False):
    """LF-MMI (+ xent) step: (state, feats [B, T, D], pdf_seq, allowed,
    num_frames, seq_len, advance_lp, xent labels[, lr_scale]) → (state, loss,
    metrics), tensors on the model's device, the model updated in place.

    On the card the objective (the den and num recursions: about 15 small
    launches a frame each way) runs as CUDA graphs of its forward and
    backward, one pair for each input shape, captured at first use
    (torch.cuda.make_graphed_callables); the network and the update run as
    they are.  The graphs replay the same kernels on the same inputs, so the
    numbers are the eager ones.  ng_activation: the network runs
    instrumented (NgCollector's hooks, outside the captured graphs) and the
    update takes the activation Fisher statistics ("ng-sgd-act")."""
    dev = next(model.parameters()).device
    graphed: Dict[tuple, object] = {}
    collector = NgCollector(model) if ng_activation else None

    def objective(logits, *sup):
        fn = lambda x, *a: chain_objective(x, den, loss_opts, *a)  # noqa: E731
        if dev.type != "cuda":
            return fn(logits, *sup)
        key = tuple(tuple(t.shape) for t in (logits, *sup))
        if key not in graphed:
            sample = (logits.detach().clone().requires_grad_(), *sup)
            graphed[key] = torch.cuda.make_graphed_callables(fn, sample)
        # the graph's outputs are its static buffers, which the next replay
        # overwrites: copies leave the step
        return tuple(o.clone() for o in graphed[key](logits, *sup))

    def loss_fn(bf, sup, gen):
        logits = model(bf, output_stride=fsf, dropout_gen=gen)[:, : sup[1].shape[1]]
        loss, *values = objective(logits, *sup)
        return loss, dict(zip(METRICS, values))

    def step(state: TrainState, bf, b_pdf, b_allowed, b_nf, b_sl, b_adv, b_xent,
             lr_scale: float = 1.0):
        bf, *sup = [torch.as_tensor(a, device=dev)
                    for a in (bf, b_pdf, b_allowed, b_nf, b_sl, b_adv, b_xent)]
        gen = torch.Generator(device=dev).manual_seed(state.step)
        if collector is not None:
            return ng_step(model, lambda: loss_fn(bf, sup, gen), optimizer, state,
                           lr_scale, collector)
        return backstitch_step(model, lambda: loss_fn(bf, sup, gen), optimizer, state,
                               lr_scale, backstitch_scale, backstitch_interval)

    step.collector = collector  # its hooks stay on the model until removed
    return step


def build_chain_objects(gmm_model: AmGmmModel, alignments: Dict[str, np.ndarray],
                        lang: Lang, opts: ChainTrainOptions,
                        feats: Optional[Dict[str, np.ndarray]] = None
                        ) -> Tuple[ContextDependency, TransitionModel, DenominatorGraph]:
    """Chain topology and tree, phone LM, denominator graph.
    tree_context_width=2 with `feats` builds a left-biphone tree from the
    GMM alignment's statistics with every pdf-class pooled to the chain
    topology's one (reference steps/nnet3/chain/build_tree.sh)."""
    phones = lang.real_phone_ids
    topo = chain_topology(phones)
    if opts.tree_context_width == 2 and feats is not None:
        stats: dict = {}
        for k, ali in alignments.items():
            if ali is None or k not in feats:
                continue
            accumulate_tree_stats(ali, feats[k], gmm_model.tm, N=2, P=1, stats=stats)
        pooled: dict = {}
        for event, st in stats.items():
            d = dict(event)
            d[KEY_PDF_CLASS] = 0
            ev = make_event(sorted(d.items()))
            if ev in pooled:
                pooled[ev].add(st)
            else:
                pooled[ev] = st.copy()
        ctx_dep = build_tree(pooled, phones, {p: 1 for p in phones}, N=2, P=1,
                             max_leaves=opts.tree_max_leaves, thresh=opts.tree_thresh)
        log.info("chain biphone tree: %d pdfs", ctx_dep.num_pdfs)
    else:
        ctx_dep = monophone_context_dependency(phones, {p: 1 for p in phones})
    tm = TransitionModel.from_context_dependency(ctx_dep, topo)
    phone_seqs = [alignment_to_phones(gmm_model.tm, ali)
                  for ali in alignments.values() if ali is not None]
    den = make_denominator_graph(estimate_phone_lm(phone_seqs, opts.phone_lm_order), ctx_dep)
    return ctx_dep, tm, den


def train_chain(gmm_model: AmGmmModel, feats: Dict[str, np.ndarray],
                alignments: Dict[str, np.ndarray], lang: Lang,
                opts: Optional[ChainTrainOptions] = None,
                ivectors: Optional[Dict[str, np.ndarray]] = None,
                device: DeviceLike = None, history: Optional[List[dict]] = None,
                report: Optional[dict] = None) -> ChainModel:
    """LF-MMI training of a fresh TDNN-F (its weights drawn from a
    torch.Generator seeded with opts.seed) on `device` (None: the GPU).

    history: receives one dict an accepted epoch (`epoch`, `objf`, `xent`,
    `steps`, `step_objf`).  report: receives `tree_pdfs`, `den_states`, `den_arcs`,
    `supervision_failures` (the utterances skipped, with a warning, as the
    JAX package skips them), `steps`, and the host-clock seconds of
    `objects_seconds` (tree, LM, den graph), `supervision_seconds` and
    `train_seconds`."""
    opts = opts or ChainTrainOptions()
    dev = resolve_device(device)
    report = {} if report is None else report
    t0 = time.perf_counter()
    # the tree is built from the features without iVectors
    ctx_dep, tm, den = build_chain_objects(gmm_model, alignments, lang, opts, feats=feats)
    report.update(tree_pdfs=ctx_dep.num_pdfs, den_states=den.num_states,
                  den_arcs=int(len(den.pdf)), objects_seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    ivector_dim = 0
    if ivectors is not None:
        feats = append_ivector_feats(feats, ivectors)
        ivector_dim = int(np.asarray(next(iter(ivectors.values()))).shape[-1])
    keys = sorted(k for k, a in alignments.items() if a is not None and k in feats)
    sups, sup_keys, failed = [], [], []
    for k in keys:
        try:
            sups.append(alignment_to_supervision(
                alignments[k], gmm_model.tm, ctx_dep, opts.frame_subsampling_factor,
                opts.left_tolerance, opts.right_tolerance, den=den))
            sup_keys.append(k)
        except Exception as e:  # a pathological utterance is skipped, as in the reference
            log.warning("supervision failed for %s: %s", k, e)
            failed.append(k)
    report["supervision_failures"] = failed
    pdf_seq, allowed, sup_frames, seq_len, advance_lp = pad_supervisions(sups)
    fsf = opts.frame_subsampling_factor
    D = next(iter(feats.values())).shape[1]
    # features padded at the full rate; logits subsampled inside the step
    feats_padded, _ = pad_subsampled(feats, sup_keys, fsf)
    xent_labels = np.stack([chain_xent_labels(alignments[k], gmm_model.tm, ctx_dep, fsf,
                                              allowed.shape[1]) for k in sup_keys])
    data = [torch.from_numpy(a).to(dev) for a in (
        feats_padded, pdf_seq, allowed, sup_frames, seq_len, advance_lp, xent_labels)]
    report["supervision_seconds"] = time.perf_counter() - t0

    config = make_tdnnf(D, ctx_dep.num_pdfs, opts.hidden_dim, opts.bottleneck_dim,
                        opts.num_layers,
                        subsampled_stride=fsf if opts.num_full_rate_layers else 0,
                        num_full_rate_layers=opts.num_full_rate_layers)
    am = AmNnet.init(config, seed=opts.seed, device=dev)
    model = am.model.train()
    log.info("train_chain: %d utts, %d chain pdfs, den %d states/%d arcs", len(sup_keys),
             ctx_dep.num_pdfs, den.num_states, len(den.pdf))
    loss_opts = ChainLossOptions(leaky_hmm_coefficient=opts.leaky_hmm_coefficient,
                                 l2_regularize=opts.l2_regularize,
                                 xent_regularize=opts.xent_regularize)
    B = opts.minibatch_size
    num_steps = opts.num_epochs * max(1, len(sup_keys) // B)
    optimizer = make_optimizer(NnetTrainOptions(initial_lr=opts.initial_lr,
                                                final_lr=opts.final_lr,
                                                optimizer=opts.optimizer), num_steps)
    state = TrainState(optimizer.init(dict(model.named_parameters())), 0)
    step_fn = make_chain_step(model, den, optimizer, loss_opts, fsf,
                              opts.backstitch_scale, opts.backstitch_interval,
                              ng_activation=opts.optimizer == "ng-sgd-act")

    t0 = time.perf_counter()
    rng = np.random.default_rng(opts.seed)
    order = np.arange(len(sup_keys))
    epoch, retries, lr_scale, prev_loss = 0, 0, 1.0, None
    while epoch < opts.num_epochs:
        snap = snapshot(model, state)
        rng.shuffle(order)
        # full batches; a dataset smaller than one minibatch is one batch
        batches = [order[i: i + B] for i in range(0, len(order) - B + 1, B)] or [order]
        objs, xents = [], []
        for idx in batches:
            ix = torch.from_numpy(idx).to(dev)
            state, _loss, metrics = step_fn(state, *(a.index_select(0, ix) for a in data),
                                            lr_scale)
            objs.append(metrics["objf"])
            xents.append(metrics.get("xent", torch.zeros((), device=dev)))
            if state.step % ORTHONORMAL_INTERVAL == 0:
                apply_orthonormal_constraints(model)
        obj_v = torch.stack(objs).double().cpu().numpy()  # one copy an epoch
        xent_v = torch.stack(xents).double().cpu().numpy()
        mean_loss = -float(np.mean(obj_v))  # the objective is maximised
        e = epoch

        def accept():
            log.info("chain epoch %d: objf %.4f xent %.4f (%d steps)", e, -mean_loss,
                     float(np.mean(xent_v)), len(obj_v))
            if history is not None:
                history.append({"epoch": e, "objf": -mean_loss,
                                "xent": float(np.mean(xent_v)), "steps": len(obj_v),
                                "step_objf": obj_v.tolist()})

        state, prev_loss, epoch, retries, lr_scale = check_divergence(
            model, state, snap, mean_loss, prev_loss, epoch, retries, lr_scale,
            opts.max_lr_retries, accept)
    if step_fn.collector is not None:
        step_fn.collector.remove()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    report.update(steps=state.step, train_seconds=time.perf_counter() - t0)
    out = AmNnet(config, model.eval(), None, device=dev, ivector_dim=ivector_dim)
    return ChainModel.from_parts(out, ctx_dep, tm, den, fsf)


def make_chain_e2e_step(model: torch.nn.Module, den: DenominatorGraph,
                        optimizer: NnetOptimizer, loss_opts: ChainLossOptions, fsf: int):
    """Flat-start (generic numerator) LF-MMI step: (state, feats [B, T, D],
    num_frames [B], NumeratorGraphBatch of the B utterances[, seq_weights
    [B], lr_scale]) → (state, loss, metrics); the model is updated in place
    on its device, the final update scaled by lr_scale."""
    dev = next(model.parameters()).device

    def step(state: TrainState, bf, b_nf, graphs: NumeratorGraphBatch,
             seq_weights=None, lr_scale: float = 1.0):
        bf, b_nf = (torch.as_tensor(a, device=dev) for a in (bf, b_nf))
        wts = None if seq_weights is None else torch.as_tensor(seq_weights, device=dev)
        gen = torch.Generator(device=dev).manual_seed(state.step)

        def loss_fn():
            logits = model(bf, output_stride=fsf, dropout_gen=gen)
            return chain_e2e_loss(logits, den, graphs, b_nf, loss_opts, seq_weights=wts)

        opt, loss, metrics = apply_update(model, loss_fn, optimizer, state.opt_state, lr_scale)
        return TrainState(opt, state.step + 1), loss, metrics

    return step


def pad_subsampled(feats: Dict[str, np.ndarray], keys: List[str], fsf: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """[N, T, D] features padded to a multiple of `fsf` frames, and each
    utterance's frame count at the subsampled rate [N]."""
    T = -(-max(feats[k].shape[0] for k in keys) // fsf) * fsf
    padded = np.zeros((len(keys), T, feats[keys[0]].shape[1]), np.float32)
    nf = np.zeros(len(keys), np.int32)
    for i, k in enumerate(keys):
        padded[i, : feats[k].shape[0]] = feats[k]
        nf[i] = -(-feats[k].shape[0] // fsf)
    return padded, nf


def e2e_chain_objects(transcripts: Dict[str, List[str]], keys: List[str], lang: Lang,
                      opts: ChainTrainOptions
                      ) -> Tuple[ContextDependency, TransitionModel, DenominatorGraph]:
    """Flat-start tree (monophone, or with tree_context_width=2 the full
    left-biphone, reference gmm-init-biphone), transition model, and den
    graph from a phone LM of the transcripts' first pronunciations, each
    once as it is and once with silence before, between and after the
    words: the training graphs allow optional silence, and a den graph
    without a silence state lets long-silence numerator paths outweigh the
    denominator (the objective then diverges to +55 a frame)."""
    phones = lang.real_phone_ids
    topo = chain_topology(phones)
    make_tree = (biphone_context_dependency if opts.tree_context_width == 2
                 else monophone_context_dependency)
    ctx_dep = make_tree(phones, {p: 1 for p in phones})
    tm = TransitionModel.from_context_dependency(ctx_dep, topo)
    first_pron: dict = {}
    for word, _prob, pron in lang.lexicon.entries:
        first_pron.setdefault(word, [lang.phones[p] for p in pron])
    sil = lang.silence_id
    phone_seqs = []
    for k in keys:
        seq, seq_sil = [], [sil]
        for w in transcripts[k]:
            seq.extend(first_pron[w])
            seq_sil.extend(first_pron[w])
            seq_sil.append(sil)
        phone_seqs.append(seq)
        phone_seqs.append(seq_sil)
    den = make_denominator_graph(estimate_phone_lm(phone_seqs, opts.phone_lm_order), ctx_dep)
    return ctx_dep, tm, den


def numerator_graphs(lang: Lang, ctx_dep: ContextDependency, tm: TransitionModel,
                     den: DenominatorGraph, transcripts: Sequence[Sequence[str]]
                     ) -> List:
    """Each transcript's training graph, normalised by the den graph."""
    compiler = GraphCompiler(lang, ctx_dep, tm)
    return [normalize_numerator_csr(compiler.compile_csr_from_text(t), tm, den)
            for t in transcripts]


def train_chain_e2e(feats: Dict[str, np.ndarray], transcripts: Dict[str, List[str]],
                    lang: Lang, opts: Optional[ChainTrainOptions] = None,
                    device: DeviceLike = None, history: Optional[List[dict]] = None,
                    report: Optional[dict] = None) -> ChainModel:
    """Flat-start LF-MMI of a fresh TDNN-F (reference steps/nnet3/chain/e2e/
    and chain-generic-numerator) on `device` (None: the GPU): the tree, den
    graph and numerator graphs of e2e_chain_objects and numerator_graphs,
    then Adam over shuffled full minibatches with the orthonormal
    constraint every 4 steps and train_chain's halved-LR retry.  No xent
    term: there are no alignment targets.

    history: one dict an accepted epoch (`epoch`, `objf`, `steps`,
    `step_objf`).  report: `tree_pdfs`, `den_states`, `num_states` and
    `num_arcs` (the padded numerator batch's S and A), `steps`, and the
    host-clock `objects_seconds`, `numerator_seconds`, `train_seconds` and
    `step_seconds` (each step's, as the host issues it)."""
    opts = opts or ChainTrainOptions()
    dev = resolve_device(device)
    report = {} if report is None else report
    t0 = time.perf_counter()
    keys = sorted(k for k in transcripts if k in feats)
    ctx_dep, tm, den = e2e_chain_objects(transcripts, keys, lang, opts)
    report.update(tree_pdfs=ctx_dep.num_pdfs, den_states=den.num_states,
                  objects_seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    gbatch = NumeratorGraphBatch.from_csr_graphs(
        numerator_graphs(lang, ctx_dep, tm, den, [transcripts[k] for k in keys]))
    report.update(num_states=gbatch.num_states, num_arcs=int(gbatch.src.shape[1]),
                  numerator_seconds=time.perf_counter() - t0)
    log.info("train_chain_e2e: %d utts, %d pdfs, num graphs ≤%d states/%d arcs, "
             "den %d states", len(keys), ctx_dep.num_pdfs, gbatch.num_states,
             gbatch.src.shape[1], den.num_states)
    fsf = opts.frame_subsampling_factor
    feats_padded, nf_sub = pad_subsampled(feats, keys, fsf)
    D = feats_padded.shape[2]
    config = make_tdnnf(D, ctx_dep.num_pdfs, opts.hidden_dim, opts.bottleneck_dim,
                        opts.num_layers,
                        subsampled_stride=fsf if opts.num_full_rate_layers else 0,
                        num_full_rate_layers=opts.num_full_rate_layers)
    am = AmNnet.init(config, seed=opts.seed, device=dev)
    model = am.model.train()
    loss_opts = ChainLossOptions(leaky_hmm_coefficient=opts.leaky_hmm_coefficient,
                                 l2_regularize=opts.l2_regularize, xent_regularize=0.0)
    B = opts.minibatch_size
    num_steps = opts.num_epochs * max(1, len(keys) // B)
    optimizer = make_optimizer(NnetTrainOptions(initial_lr=opts.initial_lr,
                                                final_lr=opts.final_lr), num_steps)
    state = TrainState(optimizer.init(dict(model.named_parameters())), 0)
    step_fn = make_chain_e2e_step(model, den, optimizer, loss_opts, fsf)
    x_all = torch.from_numpy(feats_padded).to(dev)

    t0 = time.perf_counter()
    rng = np.random.default_rng(opts.seed)
    order = np.arange(len(keys))
    step_s = report.setdefault("step_seconds", [])
    epoch, retries, lr_scale, prev_loss = 0, 0, 1.0, None
    while epoch < opts.num_epochs:
        snap = snapshot(model, state)
        rng.shuffle(order)
        batches = [order[i: i + B] for i in range(0, len(order) - B + 1, B)] or [order]
        objs = []
        for idx in batches:
            ts = time.perf_counter()
            state, _loss, metrics = step_fn(
                state, x_all.index_select(0, torch.from_numpy(idx).to(dev)), nf_sub[idx],
                gbatch.take(idx), lr_scale=lr_scale)
            step_s.append(time.perf_counter() - ts)
            objs.append(metrics["objf"])
            if state.step % ORTHONORMAL_INTERVAL == 0:
                apply_orthonormal_constraints(model)
        obj_v = torch.stack(objs).double().cpu().numpy()  # one copy an epoch
        mean_loss = -float(np.mean(obj_v))
        e = epoch

        def accept():
            log.info("chain-e2e epoch %d: objf %.4f (%d steps)", e, -mean_loss, len(obj_v))
            if history is not None:
                history.append({"epoch": e, "objf": -mean_loss, "steps": len(obj_v),
                                "step_objf": obj_v.tolist()})

        state, prev_loss, epoch, retries, lr_scale = check_divergence(
            model, state, snap, mean_loss, prev_loss, epoch, retries, lr_scale,
            opts.max_lr_retries, accept)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    report.update(steps=state.step, train_seconds=time.perf_counter() - t0)
    out = AmNnet(config, model.eval(), None, device=dev)
    return ChainModel.from_parts(out, ctx_dep, tm, den, fsf)


def make_chain_decode_graph(chain: ChainModel, lang: Lang, g: VectorFst,
                            split_eps: bool = False,
                            timings: Optional[Dict[str, float]] = None) -> CsrGraph:
    """The chain model's decoding graph from its own tree and transition
    model: self-loop-scale 1.0 (reference mkgraph for chain models), folded,
    or split-eps for `decode_batch_tokens`.  timings: mkgraph_csr's."""
    return mkgraph_csr(lang, g, chain.ctx_dep, chain.tm, self_loop_scale=1.0,
                       split_eps=split_eps, timings=timings)


def decode_chain(chain: ChainModel, graph: CsrGraph, lang: Lang,
                 feats: Dict[str, np.ndarray], beam: float = 16.0,
                 max_active: int = 7000, acoustic_scale: float = 1.0,
                 ivectors: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, List[str]]:
    """One batch decode of `feats` on a folded graph with `decode_batch`, on
    the model's device: logits at frame-subsampling, acoustic scale 1.0."""
    if chain.am.ivector_dim and ivectors is None:
        raise ValueError(f"chain model expects {chain.am.ivector_dim}-dim i-vectors; "
                         "pass ivectors=")
    if ivectors is not None:
        feats = append_ivector_feats(feats, ivectors)
    keys = sorted(feats)
    fsf = chain.frame_subsampling_factor
    padded, nf = pad_subsampled(feats, keys, fsf)
    logits = chain.am.logits(padded, output_stride=fsf)
    results = decode_batch(graph, logits, nf, ViterbiOptions(
        beam=beam, max_active=max_active, acoustic_scale=acoustic_scale),
        device=chain.am.device)
    return {k: ([lang.words[w] for w in res.words] if res else [])
            for k, res in zip(keys, results)}


def combine_chain_models(cms: List[ChainModel], egs: List, num_steps: int = 40,
                         lr: float = 0.3, max_egs: int = 32,
                         loss_opts: Optional[ChainLossOptions] = None,
                         report: Optional[dict] = None) -> ChainModel:
    """Optimised chain-model combination (reference nnet3-chain-combine; the
    JAX package's one weight per model): the softmax weights that minimise
    the LF-MMI loss (no xent term by default) of the `max_egs` shortest
    chain egs, by `num_steps` of plain Adam, then the weighted sum of the
    models' parameters and batch-norm statistics; the first model's tree,
    transition model, den graph and priors.  On the first model's device.
    report: models.train.combine_weights'."""
    from old_kaldi_git_tpu_torch.models.egs import batch_chain_egs

    if len(cms) == 1:
        return cms[0]
    base = cms[0]
    dev = base.am.device
    opts = loss_opts or ChainLossOptions(xent_regularize=0.0)
    fsf = base.frame_subsampling_factor
    bf, pdf_seq, allowed, nf, sl, adv, _x = (
        torch.from_numpy(a).to(dev) for a in batch_chain_egs(
            sorted(egs, key=lambda e: e.feats.shape[0])[:max_egs]))
    model = copy.deepcopy(base.am.model).eval()
    stacked = stacked_state([cm.am.model for cm in cms])

    def objective(mdl, tensors):
        logits = torch.func.functional_call(mdl, tensors, (bf,), {"output_stride": fsf})
        loss, _ = chain_loss(logits[:, : allowed.shape[1]], base.den, pdf_seq, allowed,
                             nf, sl, adv, opts)
        return loss

    rep = {} if report is None else report
    w = combine_weights(model, stacked, objective, num_steps, lr, rep)
    log.info("combine_chain_models: %d models, loss %.4f → %.4f, weights %s", len(cms),
             rep["objf_uniform"], rep["objf_final"], np.round(rep["weights"], 3))
    with torch.no_grad():
        model.load_state_dict(combined_state(w, stacked))
    priors = base.am.log_priors
    am = AmNnet(base.am.config, model, None if priors is None else priors.cpu().numpy(),
                device=dev, ivector_dim=base.am.ivector_dim)
    return ChainModel.from_parts(am, base.ctx_dep, base.tm, base.den, fsf)
