"""Context-dependency composition (C) and the subsequential loop, host
Python (counterpart of old_kaldi_git_tpu/fst/context.py).

Parity with reference src/fstext/context-fst.h (ComposeContext,
AddSubsequentialLoop): expands an LG phone-level FST into CLG whose input
labels are context windows of N phones (ilabel-info entries), with output
delayed by N-P-1 phones and flushed at the utterance's end by the
subsequential symbol '$'.  Disambiguation symbols pass through as their own
entries ([-k] in ilabel_info, as in the reference).  The port's decoding
graphs compose in the native library (fst/native.py); this serves the
`fstcomposecontext` and `fstaddsubsequentialloop` tools, whose files must
be the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from old_kaldi_git_tpu_torch.fst.vector_fst import EPS, INF, Arc, VectorFst
from old_kaldi_git_tpu_torch.utils.log import KaldiError


def add_subsequential_loop(fst: VectorFst, subseq_symbol: int) -> VectorFst:
    """Append '$' symbols after complete strings (reference
    AddSubsequentialLoop): a new superfinal state with a '$' self-loop;
    every final state gets a ($:eps) arc into it carrying its final
    weight."""
    out = fst.copy()
    superfinal = out.add_state()
    out.add_arc(superfinal, Arc(subseq_symbol, EPS, 0.0, superfinal))
    out.set_final(superfinal, 0.0)
    for s in range(out.num_states - 1):
        if out.finals[s] != INF:
            out.add_arc(s, Arc(subseq_symbol, EPS, out.finals[s], superfinal))
            out.finals[s] = INF
    return out


def compose_context(lg: VectorFst, N: int, P: int, disambig_ids: Sequence[int],
                    subseq_symbol: int) -> Tuple[VectorFst, List[List[int]]]:
    """CLG = C ∘ LG', LG' = AddSubsequentialLoop(LG) when the output is
    delayed (N - P - 1 > 0).

    Input labels of `lg` are phone ids (and disambiguation ids); returns
    (CLG, ilabel_info), where ilabel_info[i] is the context window (N phone
    ids, 0 = outside the utterance) of CLG's ilabel i, [] for eps, and [-k]
    for the k-th disambiguation symbol in increasing id order."""
    disambig = set(disambig_ids)
    ilabel_info: List[List[int]] = [[]]
    window_index: Dict[Tuple[int, ...], int] = {}
    disambig_index: Dict[int, int] = {}
    disambig_ord = {pid: k for k, pid in enumerate(sorted(disambig))}

    def window_label(window: Tuple[int, ...]) -> int:
        if window not in window_index:
            ilabel_info.append(list(window))
            window_index[window] = len(ilabel_info) - 1
        return window_index[window]

    def disambig_label(phone_id: int) -> int:
        if phone_id not in disambig_index:
            ilabel_info.append([-disambig_ord[phone_id]])
            disambig_index[phone_id] = len(ilabel_info) - 1
        return disambig_index[phone_id]

    if N == 1:  # each phone is its own window
        out = lg.copy()
        for s in out.states():
            for a in out.arcs[s]:
                if a.ilabel == EPS:
                    continue
                a.ilabel = (disambig_label(a.ilabel) if a.ilabel in disambig
                            else window_label((a.ilabel,)))
        return out, ilabel_info

    delay = N - P - 1
    if delay < 0:
        raise KaldiError(f"bad context spec N={N} P={P}")
    src = add_subsequential_loop(lg, subseq_symbol) if delay > 0 else lg

    # a state is (the last N-1 phones, 0-padded at the start; lg's state),
    # numbered in the order a depth-first expansion first reaches it
    out = VectorFst()
    start_key = ((0,) * (N - 1), src.start)
    ids: Dict[Tuple[Tuple[int, ...], int], int] = {start_key: out.add_state()}
    out.set_start(0)
    stack = [start_key]
    while stack:
        key = stack.pop()
        hist, q = key
        s_out = ids[key]
        if src.finals[q] != INF:
            out.set_final(s_out, src.finals[q])
        for a in src.arcs[q]:
            if a.ilabel == EPS:
                new_hist, ilabel = hist, EPS
            elif a.ilabel in disambig:
                new_hist, ilabel = hist, disambig_label(a.ilabel)
            else:
                full = hist + (0 if a.ilabel == subseq_symbol else a.ilabel,)
                new_hist = full[1:]
                # a 0 centre (start padding, or flushing an empty centre)
                # emits no window
                ilabel = EPS if full[P] == 0 else window_label(full)
            nkey = (new_hist, a.nextstate)
            if nkey not in ids:
                ids[nkey] = out.add_state()
                stack.append(nkey)
            out.add_arc(s_out, Arc(ilabel, a.olabel, a.weight, ids[nkey]))
    out.connect()
    return out, ilabel_info
