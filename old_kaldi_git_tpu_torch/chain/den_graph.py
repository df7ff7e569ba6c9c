"""Denominator graph construction.

Counterpart of old_kaldi_git_tpu/chain/den_graph.py (reference
src/chain/chain-den-graph.cc DenominatorGraph): the phone LM composed with
the 1-state chain topology, one state per phone-LM arc (a "phone
instance") with a self-loop and arcs to the instances that can follow it;
the initial distribution from 100 power-method iterations.  Exported as
flat arc arrays (from_state, to_state, pdf, log_prob [A]) for the
recursions of chain/loss.py; host numpy, the JAX package's arrays exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.fst.vector_fst import INF, VectorFst
from old_kaldi_git_tpu_torch.tree.context_dep import ContextDependency
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("den-graph")


@dataclasses.dataclass
class DenominatorGraph:
    num_states: int
    from_state: np.ndarray  # [A] int32
    to_state: np.ndarray  # [A] int32
    pdf: np.ndarray  # [A] int32
    log_prob: np.ndarray  # [A] float32
    initial_log_probs: np.ndarray  # [S] float32 (power-method occupancy)
    final_log_probs: np.ndarray  # [S] float32 (0: every state may end a chunk)
    num_pdfs: int
    # numerator normalisation (the reference's normalization.fst): den state
    # per (LM state, phone), LM continuation per den state
    arc_lookup: Dict[Tuple[int, int], int] = dataclasses.field(default_factory=dict)
    lm_next: np.ndarray = None  # [S] int32: LM state after this instance
    lm_start: int = 0
    loop_log_prob: float = float(math.log(0.5))
    advance_lm_log_prob: np.ndarray = None  # [S]: LM part of entering state

    def __getstate__(self) -> dict:
        """The graph's fields, without the per-device arrays that
        chain/loss.py keeps on it: a saved model's tensors are loaded onto
        the CPU, so those arrays are made again on the device that next uses
        the graph."""
        state = dict(self.__dict__)
        state.pop("_device_arrays", None)
        return state

    def numerator_weights(self, phone_seq) -> np.ndarray:
        """[L] weights that give each token the weight its path carries in
        the denominator graph (so num ≤ den): [0] the initial prob of the
        first token's den state, [l > 0] the LM advance into token l; −20
        for an n-gram the LM lacks."""
        lm_state = self.lm_start
        advance = np.zeros(len(phone_seq), np.float32)
        for l, phone in enumerate(phone_seq):
            s = self.arc_lookup.get((lm_state, int(phone)))
            if s is None:
                advance[l] = -20.0
                continue
            advance[l] = self.initial_log_probs[s] if l == 0 else self.advance_lm_log_prob[s]
            lm_state = int(self.lm_next[s])
        return advance


def make_denominator_graph(phone_lm: VectorFst, ctx_dep: ContextDependency,
                           num_power_iters: int = 100) -> DenominatorGraph:
    """Phone LM ∘ chain topology → den graph arrays, for a monophone tree
    (N = 1) or a left-biphone one (N = 2, P = 1), whose left context is the
    last phone of the LM state's history (`state_hist`, order ≥ 2)."""
    if ctx_dep.N == 1:
        def window_of(lm_state: int, phone: int) -> List[int]:
            return [phone]
    elif ctx_dep.N == 2 and ctx_dep.P == 1:
        state_hist = getattr(phone_lm, "state_hist", None)
        if state_hist is None:
            raise KaldiError("biphone den graph needs a phone LM with state histories "
                             "(estimate_phone_lm provides them)")

        def window_of(lm_state: int, phone: int) -> List[int]:
            hist = state_hist.get(lm_state, ())
            return [hist[-1] if hist and hist[-1] > 0 else 0, phone]
    else:
        raise KaldiError("make_denominator_graph supports N=1 and left-biphone N=2/P=1")

    lm_arcs = [(s, a) for s in phone_lm.states() for a in phone_lm.arcs[s]]
    S = len(lm_arcs)
    if S == 0:
        raise KaldiError("empty phone LM")
    by_src: Dict[int, List[int]] = {}
    for i, (s, _a) in enumerate(lm_arcs):
        by_src.setdefault(s, []).append(i)

    frm, to, pdfs, lp = [], [], [], []
    loop_lp = math.log(0.5)
    for i, (s, a) in enumerate(lm_arcs):
        frm.append(i)
        to.append(i)
        pdfs.append(ctx_dep.compute(window_of(s, a.ilabel), 0))
        lp.append(loop_lp)
        for j in by_src.get(a.nextstate, ()):
            s2, a2 = lm_arcs[j]
            frm.append(i)
            to.append(j)
            pdfs.append(ctx_dep.compute(window_of(s2, a2.ilabel), 0))
            lp.append(loop_lp - a2.weight)

    init = np.full(S, -INF)
    for j in by_src.get(phone_lm.start, ()):
        init[j] = -lm_arcs[j][1].weight

    # power method for the steady-state occupancy: the leaky-HMM target
    # distribution and the normalisation start
    frm_np = np.asarray(frm, np.int64)
    to_np = np.asarray(to, np.int64)
    p_np = np.exp(np.asarray(lp))
    x = np.exp(np.where(np.isfinite(init), init, -1e30))
    x = x / max(x.sum(), 1e-30)
    for _ in range(num_power_iters):
        nx = np.zeros(S)
        np.add.at(nx, to_np, x[frm_np] * p_np)
        tot = nx.sum()
        if tot <= 0:
            break
        x = nx / tot
    x = np.maximum(x, 1e-20)
    initial_log_probs = np.log(x / x.sum()).astype(np.float32)
    log.info("den graph: %d states, %d arcs, %d pdfs", S, len(frm), ctx_dep.num_pdfs)

    arc_lookup: Dict[Tuple[int, int], int] = {}
    lm_next = np.zeros(S, np.int32)
    advance_lm = np.zeros(S, np.float32)
    for i, (s, a) in enumerate(lm_arcs):
        arc_lookup.setdefault((s, a.ilabel), i)
        lm_next[i] = a.nextstate
        advance_lm[i] = -a.weight
    return DenominatorGraph(
        num_states=S, from_state=np.asarray(frm, np.int32),
        to_state=np.asarray(to, np.int32), pdf=np.asarray(pdfs, np.int32),
        log_prob=np.asarray(lp, np.float32), initial_log_probs=initial_log_probs,
        final_log_probs=np.zeros(S, np.float32), num_pdfs=ctx_dep.num_pdfs,
        arc_lookup=arc_lookup, lm_next=lm_next, lm_start=phone_lm.start,
        advance_lm_log_prob=advance_lm)
