"""End-to-end ("flat-start") chain training: generic FST numerators.

Counterpart of old_kaldi_git_tpu/chain/e2e.py (reference
src/chain/chain-generic-numerator.{h,cc} GenericNumeratorComputation and
steps/nnet3/chain/e2e/): LF-MMI without alignments, whose numerator is each
utterance's whole training graph, normalised by the den graph's weights.

The graphs are padded into [B, A] arc arrays and [B, S] initial and final
log-probs, as in the JAX package.  The forward over each utterance's own
graph runs on the batch's states flattened to [B·S]: each state's incoming
arcs are laid out in [B·S, K] slots (K the largest in-degree, unused slots
at weight NEG_INF), the sources' alphas and the arcs' emission scores are
gathered into the slots by SparseMaps (chain/loss.py: a gather whose
backward sums each source's gradients in a fixed order), and a logsumexp
over the last axis takes each state's new alpha.  Where the JAX package
takes a scatter-max and a scatter-add into the destinations, nothing here
adds with atomics, so the objective and its gradient repeat bit for bit on
the card.  The gradient is autograd's, as the JAX package takes jax.grad.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.chain.den_graph import DenominatorGraph
from old_kaldi_git_tpu_torch.chain.loss import (
    NEG_INF, PROB_FLOOR, ChainLossOptions, SparseMap, denominator_logprob)
from old_kaldi_git_tpu_torch.utils.log import KaldiError

# an unseen n-gram's LM advance, as in the den graph's numerator_weights
UNSEEN_NGRAM_LP = -20.0


@dataclasses.dataclass
class NumeratorGraphBatch:
    """Padded per-utterance numerator graphs (pdf level, eps-free)."""

    src: np.ndarray  # [B, A] int32
    dst: np.ndarray  # [B, A] int32
    pdf: np.ndarray  # [B, A] int32
    weight: np.ndarray  # [B, A] float32 (log prob = −graph cost)
    mask: np.ndarray  # [B, A] bool
    init_lp: np.ndarray  # [B, S] float32
    final_lp: np.ndarray  # [B, S] float32

    @property
    def num_states(self) -> int:
        return self.init_lp.shape[1]

    def take(self, idx: np.ndarray) -> "NumeratorGraphBatch":
        """The graphs of rows `idx`, padded as the whole batch."""
        return NumeratorGraphBatch(*(getattr(self, f.name)[idx]
                                     for f in dataclasses.fields(self)))

    @staticmethod
    def from_csr_graphs(graphs: Sequence) -> "NumeratorGraphBatch":
        """Batch per-utterance CsrGraph training graphs (raw, graph costs)
        or SimpleNumGraphs (normalised, log-probs)."""
        B = len(graphs)
        S = max(g.num_states for g in graphs)
        A = max(g.num_arcs for g in graphs)
        src = np.zeros((B, A), np.int32)
        dst = np.zeros((B, A), np.int32)
        pdf = np.zeros((B, A), np.int32)
        weight = np.full((B, A), NEG_INF, np.float32)
        mask = np.zeros((B, A), bool)
        init_lp = np.full((B, S), NEG_INF, np.float32)
        final_lp = np.full((B, S), NEG_INF, np.float32)
        for b, g in enumerate(graphs):
            na = g.num_arcs
            if hasattr(g, "row_ptr"):  # CsrGraph (raw training graph)
                deg = g.row_ptr[1:] - g.row_ptr[:-1]
                src[b, :na] = np.repeat(np.arange(g.num_states, dtype=np.int32), deg)
                dst[b, :na] = g.nextstate
                weight[b, :na] = -g.weight  # graph cost → log prob
                fin = np.asarray(g.final_weight)
                ok = np.isfinite(fin)
                final_lp[b, :g.num_states][ok] = -fin[ok]
            else:  # SimpleNumGraph (normalised product)
                src[b, :na] = g.src
                dst[b, :na] = g.dst
                weight[b, :na] = g.weight
                final_lp[b, :g.num_states] = g.final_lp
            pdf[b, :na] = g.pdf
            mask[b, :na] = True
            init_lp[b, g.start] = 0.0
        return NumeratorGraphBatch(src, dst, pdf, weight, mask, init_lp, final_lp)


@dataclasses.dataclass
class SimpleNumGraph:
    """A normalised numerator graph in flat arc arrays."""

    start: int
    src: np.ndarray
    dst: np.ndarray
    pdf: np.ndarray
    weight: np.ndarray  # log probs
    final_lp: np.ndarray  # [S]
    num_states: int

    @property
    def num_arcs(self) -> int:
        return len(self.src)


def den_step(tm, den: DenominatorGraph, tid: int, ds: int) -> Tuple[float, int]:
    """(weight, next den state) of an arc with transition-id `tid` taken
    from den state `ds` (−1 before the first frame), as the den graph
    weighs it: a self-loop stays at loop_lp; entering a phone costs loop_lp
    plus the LM advance (on the first frame the den initial prob alone); an
    n-gram the LM lacks is floored at −20 and stays on the current state
    (den state 0 on the first frame)."""
    loop_lp = float(den.loop_log_prob)
    if tm.is_self_loop(tid) and ds >= 0:
        return loop_lp, ds
    lm = den.lm_start if ds < 0 else int(den.lm_next[ds])
    ds2 = den.arc_lookup.get((lm, tm.tid_to_phone(tid)))
    if ds2 is None:
        return ((loop_lp + UNSEEN_NGRAM_LP) if ds >= 0 else UNSEEN_NGRAM_LP,
                ds if ds >= 0 else 0)
    if ds < 0:
        return float(den.initial_log_probs[ds2]), ds2
    return loop_lp + float(den.advance_lm_log_prob[ds2]), ds2


def simple_num_graph(start: int, arcs: List[Tuple[int, int, int, float]],
                     finals: Dict[int, float], num_states: int, what: str
                     ) -> SimpleNumGraph:
    if not arcs:
        raise KaldiError(f"empty {what}")
    final_lp = np.full(num_states, NEG_INF, np.float32)
    for s, w in finals.items():
        final_lp[s] = w
    src, dst, pdf, w = (np.asarray(x) for x in zip(*arcs))
    return SimpleNumGraph(start, src.astype(np.int32), dst.astype(np.int32),
                          pdf.astype(np.int32), w.astype(np.float32), final_lp, num_states)


def normalize_numerator_csr(csr, tm, den: DenominatorGraph) -> SimpleNumGraph:
    """Product of a per-utterance training graph with the den graph's
    normalisation weights (the reference's normalization.fst composition,
    chain-supervision.cc AddWeightToSupervisionFst): every numerator path
    gets exactly the weight it carries in the den graph, so num ≤ den and
    the objective is ≤ 0.  States are (graph state, den state) pairs
    numbered in the order a breadth-first walk first meets them, as in the
    JAX package.  Arcs are classified by their transition-id, not by the
    graph's topology: a minimised graph can have forward arcs with
    dst == src."""
    states: dict = {}

    def sid(ns: int, ds: int) -> int:
        key = (ns, ds)
        if key not in states:
            states[key] = len(states)
        return states[key]

    start_key = (int(csr.start), -1)
    start = sid(*start_key)
    arcs: List[Tuple[int, int, int, float]] = []
    finals: dict = {}
    seen = {start_key}
    q = deque([start_key])
    while q:
        ns, ds = q.popleft()
        me = sid(ns, ds)
        if np.isfinite(csr.final_weight[ns]) and ds >= 0:
            finals[me] = float(den.final_log_probs[ds])
        for a in range(int(csr.row_ptr[ns]), int(csr.row_ptr[ns + 1])):
            dst = int(csr.nextstate[a])
            w, nds = den_step(tm, den, int(csr.tid[a]), ds)
            arcs.append((me, sid(dst, nds), int(csr.pdf[a]), w))
            if (dst, nds) not in seen:
                seen.add((dst, nds))
                q.append((dst, nds))
    return simple_num_graph(start, arcs, finals, len(states), "numerator graph")


def _slot_maps(g: NumeratorGraphBatch, num_pdfs: int, device: torch.device):
    """The batch's arcs in [B·S, K] incoming slots: the SparseMaps that
    gather the sources' alphas ([B·S] → slots) and the arcs' emission
    scores ([B·P] → slots), and the slots' weights (NEG_INF where unused)."""
    B, S = g.init_lp.shape
    bb, aa = np.nonzero(g.mask)  # arcs in batch order, each utterance's in order
    src = bb * S + g.src[bb, aa]
    dst = bb * S + g.dst[bb, aa]
    order = np.argsort(dst, kind="stable")  # arcs grouped by destination
    dst_o = dst[order]
    counts = np.bincount(dst_o, minlength=B * S)
    K = max(int(counts.max(initial=0)), 1)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = dst_o * K + (np.arange(len(order)) - first[dst_o])
    w = np.full(B * S * K, NEG_INF, np.float32)
    w[slot] = g.weight[bb, aa][order]
    ones = np.ones(len(order), np.float32)
    alpha_map = SparseMap(src[order], slot, ones, B * S, B * S * K, device)
    pdf = (bb * num_pdfs + g.pdf[bb, aa])[order]
    score_map = SparseMap(pdf, slot, ones, B * num_pdfs, B * S * K, device)
    return alpha_map, score_map, torch.from_numpy(w).to(device), K


def generic_numerator_logprob(logits: torch.Tensor, g: NumeratorGraphBatch,
                              num_frames: torch.Tensor) -> torch.Tensor:
    """[B] numerator log-probs: the log-space forward over each utterance's
    own graph (GenericNumeratorComputation::Forward).  A state none of
    whose messages exceeds NEG_INF / 2 is NEG_INF, as in the JAX package."""
    B, T, P = logits.shape
    S = g.num_states
    dev = logits.device
    alpha_map, score_map, w, K = _slot_maps(g, P, dev)
    # every frame's emission scores in the slots, gathered at once: [T, B·S·K]
    scores = score_map(logits.transpose(0, 1).reshape(T, B * P))
    alpha = torch.from_numpy(g.init_lp).to(dev).reshape(B * S)
    nf = torch.as_tensor(num_frames, device=dev)
    active = (torch.arange(T, device=dev)[:, None] < nf[None, :]).repeat_interleave(S, 1)
    neg = torch.full((), NEG_INF, dtype=logits.dtype, device=dev)
    for t in range(T):
        msg = (alpha_map(alpha) + w + scores[t]).view(B * S, K)
        mx = msg.detach().amax(dim=1)
        mx_safe = torch.where(mx > NEG_INF / 2, mx, torch.zeros_like(mx))
        ssum = torch.exp(msg - mx_safe[:, None]).sum(dim=1)
        new_alpha = torch.where(ssum > 0, mx_safe + torch.log(torch.clamp(ssum, min=PROB_FLOOR)),
                                neg)
        alpha = torch.where(active[t], new_alpha, alpha)
    final = torch.from_numpy(g.final_lp).to(dev)
    return torch.logsumexp(alpha.view(B, S) + final, dim=1)


def chain_e2e_loss(logits: torch.Tensor, den: DenominatorGraph, g: NumeratorGraphBatch,
                   num_frames: torch.Tensor, opts: Optional[ChainLossOptions] = None,
                   seq_weights: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Flat-start LF-MMI loss: generic numerator − denominator, and its
    metrics.  The numerators come through normalize_numerator_csr (or the
    lattice numerators of chain/semisup.py), so num ≤ den and the objective
    is ≤ 0.  seq_weights [B] scales each sequence (the semi-supervised
    recipe's per-utterance weight); the normaliser is the weighted frame
    count, floored at one."""
    opts = opts or ChainLossOptions()
    nf = torch.as_tensor(num_frames, device=logits.device)
    if seq_weights is None:
        seq_weights = torch.ones(logits.shape[0], dtype=logits.dtype, device=logits.device)
    num = generic_numerator_logprob(logits, g, nf)
    den_lp = denominator_logprob(logits, nf, den, opts.leaky_hmm_coefficient)
    tot = torch.clamp((seq_weights * nf).sum(), min=1.0)
    objf = (seq_weights * (num - den_lp)).sum() / tot
    frame_mask = (torch.arange(logits.shape[1], device=logits.device)[None, :]
                  < nf[:, None])[..., None]
    l2 = (logits * logits * frame_mask * seq_weights[:, None, None]).sum() / tot
    loss = -objf + 0.5 * opts.l2_regularize * l2
    return loss, {"objf": objf, "num": (seq_weights * num).sum() / tot,
                  "den": (seq_weights * den_lp).sum() / tot, "l2": l2}
