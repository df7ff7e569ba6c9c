"""H-transducer construction and alignment utilities.

Own copy of the parts of old_kaldi_git_tpu/hmm/hmm_utils.py that the graph
compiler and GMM training use: GetHTransducer (reference
src/hmm/hmm-utils.h; Ha, without self-loops, with disambig pass-through),
SplitToPhones, the alignment → phones / pdfs maps and ConvertAlignment
(same topology).  AddSelfLoops runs in the native library (fst/native.py
`NativeFst.add_self_loops`).  The alignment utilities work on an
utterance's whole tid array at once, through the transition model's
per-tid arrays.

Probability convention (documented; matches the reference's scaling scheme):
  * H arcs carry weight = transition_scale * -log(p / (1 - p_self)) — the
    forward probability renormalized without the self-loop;
  * AddSelfLoops adds self_loop_scale * -log(p_self) on the loop arc and
    self_loop_scale * -log(1 - p_self) on every non-self-loop transition of
    that transition-state, so at scales (1, 1) path weights equal the true
    -log transition probabilities.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.fst.vector_fst import EPS, INF, Arc, VectorFst
from old_kaldi_git_tpu_torch.hmm.topology import NO_PDF
from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
from old_kaldi_git_tpu_torch.tree.context_dep import ContextDependency


def phone_window_to_fst(
    window: Sequence[int],
    ctx_dep: ContextDependency,
    tm: TransitionModel,
    transition_scale: float = 1.0,
) -> VectorFst:
    """HMM piece for one context window: input labels = transition-ids of the
    non-self-loop transitions, output = eps, start = topo state 0, final =
    topo final state (reference GetHmmAsFst)."""
    phone = window[ctx_dep.P]
    entry = tm.topo.topology_for_phone(phone)
    fst = VectorFst()
    states = [fst.add_state() for _ in entry]
    fst.set_start(states[0])
    fst.set_final(states[-1], 0.0)
    for j, st in enumerate(entry):
        if st.pdf_class == NO_PDF:
            continue
        pdf = ctx_dep.compute(window, st.pdf_class)
        ts = tm.tuple_to_tstate(phone, j, pdf)
        p_self = tm.self_loop_prob(ts)
        for ti, (ns, _prob) in enumerate(st.transitions):
            if ns == j:
                continue  # self-loops added later
            tid = tm.pair_to_tid(ts, ti)
            p = math.exp(tm.log_probs[tid])
            q = p / max(1.0 - p_self, 1e-20)
            weight = -transition_scale * math.log(max(q, 1e-20))
            fst.add_arc(states[j], Arc(tid, EPS, weight, states[ns]))
    return fst


def make_h_transducer(
    ilabel_info: List[List[int]],
    ctx_dep: ContextDependency,
    tm: TransitionModel,
    transition_scale: float = 1.0,
) -> Tuple[VectorFst, List[int]]:
    """Build Ha (reference GetHTransducer): one loop state; for each CLG
    ilabel i, either an HMM piece (context window) or a pass-through arc
    (disambig, encoded in ilabel_info as a single negative id).

    Returns (Ha, disambig_tids): the input labels used for disambig symbols
    (they live above num_tids and must be removed before decoding).
    """
    fst = VectorFst()
    loop = fst.add_state()
    fst.set_start(loop)
    fst.set_final(loop, 0.0)
    next_disambig = tm.num_tids + 1
    disambig_tids: List[int] = []
    for i, info in enumerate(ilabel_info):
        if i == 0 or not info:
            continue  # epsilon
        if len(info) == 1 and info[0] <= 0:
            # disambiguation symbol (negative id), or the #-1 begin-of-
            # sequence symbol stored as [0] (context composition emits it
            # for epsilon arcs in LG, e.g. LM backoff — reference
            # GetHTransducer's `size()==1 && [0] <= 0` case): pass through
            # with a fresh input id
            fst.add_arc(loop, Arc(next_disambig, i, 0.0, loop))
            disambig_tids.append(next_disambig)
            next_disambig += 1
            continue
        piece = phone_window_to_fst(info, ctx_dep, tm, transition_scale)
        # splice piece between loop → ... → loop, olabel=i on the entry arcs
        offset = fst.num_states
        for s in piece.states():
            fst.add_state()
        for s in piece.states():
            for a in piece.arcs[s]:
                fst.add_arc(offset + s, Arc(a.ilabel, a.olabel, a.weight, offset + a.nextstate))
        fst.add_arc(loop, Arc(EPS, i, 0.0, offset + piece.start))
        for s in piece.states():
            if piece.finals[s] != INF:
                fst.add_arc(offset + s, Arc(EPS, EPS, piece.finals[s], loop))
    return fst, disambig_tids


# ---------------------------------------------------------------------------
# alignment utilities
# ---------------------------------------------------------------------------

def phone_starts(tm: TransitionModel, alignment: Sequence[int]) -> np.ndarray:
    """[T] bool: frame t begins a phone.  The graphs put a self-loop at the
    destination of its forward arc (reorder = true), so a phone begins at a
    tid that leaves hmm-state 0 and is not a self-loop; the first frame
    always begins one."""
    ali = np.asarray(alignment, np.int64)
    arr = tm.tid_arrays()
    starts = (arr["hmm_state"][ali] == 0) & (arr["self_loop"][ali] == 0)
    if len(ali):
        starts[0] = True
    return starts


def split_to_phones(tm: TransitionModel, alignment: Sequence[int]) -> List[List[int]]:
    """A tid sequence split into per-phone segments (reference
    SplitToPhones)."""
    ali = np.asarray(alignment, np.int64)
    bounds = np.flatnonzero(phone_starts(tm, ali))
    return [seg.tolist() for seg in np.split(ali, bounds[1:])] if len(ali) else []


def alignment_to_phones(tm: TransitionModel, alignment: Sequence[int]) -> List[int]:
    ali = np.asarray(alignment, np.int64)
    return tm.tid_arrays()["phone"][ali[phone_starts(tm, ali)]].tolist()


def alignment_to_pdfs(tm: TransitionModel, alignment: Sequence[int]) -> List[int]:
    return tm.tid_to_pdf_array()[np.asarray(alignment, np.int64)].tolist()


def convert_alignment(alignment: Sequence[int], tm_old: TransitionModel,
                      tm_new: TransitionModel, ctx_dep_new: ContextDependency) -> np.ndarray:
    """An alignment re-mapped to a new tree with the same topology
    (reference ConvertAlignment, same-topology path): each frame keeps its
    phone, hmm-state and transition index, and takes the pdf that the new
    tree gives its phone window (0 beyond the utterance) and pdf-class.
    Returns int32 tids."""
    ali = np.asarray(alignment, np.int64)
    if not len(ali):
        return np.zeros(0, np.int32)
    old = tm_old.tid_arrays()
    starts = phone_starts(tm_old, ali)
    seg = np.cumsum(starts) - 1
    N, P = ctx_dep_new.N, ctx_dep_new.P
    phones = old["phone"][ali[starts]].tolist()
    padded = [0] * P + phones + [0] * (N - 1 - P)
    hmm_state = old["hmm_state"][ali]
    # one tree lookup per (phone, hmm-state) visit
    keys, first, inverse = np.unique(np.stack([seg, hmm_state], axis=1), axis=0,
                                     return_index=True, return_inverse=True)
    base = np.empty(len(keys), np.int64)
    for i, (s, h) in enumerate(keys.tolist()):
        pdf = ctx_dep_new.compute(padded[s: s + N], int(old["pdf_class"][ali[first[i]]]))
        base[i] = tm_new.state2id[tm_new.tuple_to_tstate(phones[s], h, pdf)]
    return (base[inverse.reshape(-1)] + old["tindex"][ali]).astype(np.int32)
