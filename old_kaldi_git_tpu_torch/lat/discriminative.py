"""MPE / sMBR signed lattice posteriors for discriminative training.

Counterpart of old_kaldi_git_tpu/lat/discriminative.py (reference
src/lat/lattice-functions.cc LatticeForwardBackwardMpeVariants, criterion
'mpfe' = phone-frame accuracy, 'smbr' = state (pdf) accuracy): alpha and
beta are the usual log-domain scores; alpha_acc and beta_acc carry the
expected accumulated path accuracy through each state.  An arc's signed
posterior is γ(arc)·(alpha_acc[src] + acc(arc) + beta_acc[dst] − avg_acc):
arcs on better-than-average paths get positive weight, the others
negative.  Host code in float64, in the JAX package's order of operations.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.lat.lattice import (
    INF, Lattice, _forward_backward, _topo_order, lattice_state_times)
from old_kaldi_git_tpu_torch.utils.log import KaldiError

Posterior = List[List[Tuple[int, float]]]


def forward_backward_mpe_variants(
    lat: Lattice, tm, ref_alignment: Sequence[int], criterion: str = "mpfe",
    silence_phones: Sequence[int] = (), lm_scale: float = 1.0, ac_scale: float = 0.1,
) -> Tuple[Posterior, float]:
    """Signed tid-level posteriors per frame, and the expected accuracy
    (frames correct).  'mpfe': an emitting arc scores 1 at frame t when
    its phone is the reference alignment's; 'smbr': when its pdf is.  Arcs
    of silence phones, and frames whose reference is silence, score 0."""
    if criterion not in ("mpfe", "smbr"):
        raise KaldiError(f"bad criterion {criterion!r}")
    order = _topo_order(lat)
    times = lattice_state_times(lat)
    n = lat.num_states
    sil = frozenset(int(p) for p in silence_phones)
    ref_phone = np.asarray([tm.tid_to_phone(t) for t in ref_alignment])
    ref_pdf = np.asarray([tm.tid_to_pdf(t) for t in ref_alignment])

    def arc_acc(tid: int, t: int) -> float:
        if tid == 0 or t >= len(ref_alignment):
            return 0.0
        phone = tm.tid_to_phone(tid)
        if phone in sil or int(ref_phone[t]) in sil:
            return 0.0
        if criterion == "mpfe":
            return 1.0 if phone == int(ref_phone[t]) else 0.0
        return 1.0 if tm.tid_to_pdf(tid) == int(ref_pdf[t]) else 0.0

    alpha, beta = _forward_backward(lat, order, lm_scale, ac_scale)
    total = beta[lat.start]
    if not np.isfinite(total):
        raise KaldiError("lattice has no successful path")

    # the expected accuracy (probability domain, locally normalised)
    alpha_acc = np.zeros(n)
    for s in order:
        if alpha[s] == -INF:
            continue
        for a in lat.arcs[s]:
            w = -lat.combined(a, lm_scale, ac_scale)
            j = a.nextstate
            occ = np.exp(alpha[s] + w - alpha[j])  # P(arrive at j by this arc)
            alpha_acc[j] += occ * (alpha_acc[s] + arc_acc(a.ilabel, times[s]))
    beta_acc = np.zeros(n)
    for s in reversed(order):
        if beta[s] == -INF:
            continue
        acc = 0.0
        for a in lat.arcs[s]:
            w = -lat.combined(a, lm_scale, ac_scale)
            occ = np.exp(w + beta[a.nextstate] - beta[s])
            acc += occ * (beta_acc[a.nextstate] + arc_acc(a.ilabel, times[s]))
        beta_acc[s] = acc  # a final state adds no future accuracy

    avg_acc = 0.0  # the final states weighed by their arrival probability
    for s in range(n):
        if lat.is_final(s):
            g, ac = lat.finals[s]
            fw = -(lm_scale * g + ac_scale * ac)
            avg_acc += np.exp(alpha[s] + fw - total) * alpha_acc[s]

    num_frames = max(times[s] for s in range(n) if lat.is_final(s))
    post: Posterior = [[] for _ in range(num_frames)]
    for s in range(n):
        if alpha[s] == -INF or beta[s] == -INF:
            continue
        for a in lat.arcs[s]:
            if a.ilabel == 0:
                continue
            t = times[s]
            if t >= num_frames:
                continue
            w = -lat.combined(a, lm_scale, ac_scale)
            gamma = np.exp(alpha[s] + w + beta[a.nextstate] - total)
            signed = gamma * (alpha_acc[s] + arc_acc(a.ilabel, t)
                              + beta_acc[a.nextstate] - avg_acc)
            if signed != 0.0:
                post[t].append((a.ilabel, float(signed)))
    merged: Posterior = []  # several arcs of a frame can share a tid
    for frame in post:
        d: dict = {}
        for tid, w in frame:
            d[tid] = d.get(tid, 0.0) + w
        merged.append(sorted(d.items()))
    return merged, float(avg_acc)
