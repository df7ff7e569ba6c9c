"""Term-weighted value scoring for keyword search.

Counterpart of old_kaldi_git_tpu/kws/atwv.py (reference
kwsbin/compute-atwv.cc, the NIST STD / OpenKWS metric), host Python:

    ATWV = 1 - mean_over_keywords( P_miss(kw) + beta * P_fa(kw) )
    P_miss(kw) = 1 - N_correct(kw) / N_true(kw)
    P_fa(kw)   = N_spurious(kw) / (T_trials - N_true(kw))

with beta = 999.9 and T_trials the searched audio in seconds.  Keywords
without true occurrences stay out of the mean (the NIST convention).  A
hypothesis matches a reference occurrence of its keyword in the same
utterance when their midpoints are within `max_distance` seconds; the
hypotheses are matched greedily, best score first.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# (kw_id, utt, tbeg_sec, tend_sec)
RefEntry = Tuple[str, str, float, float]
# (kw_id, utt, tbeg_sec, tend_sec, score)
HypEntry = Tuple[str, str, float, float, float]

DEFAULT_BETA = 999.9


def compute_atwv(trials_sec: float, refs: Sequence[RefEntry], hyps: Sequence[HypEntry],
                 beta: float = DEFAULT_BETA, max_distance: float = 0.5
                 ) -> Tuple[float, Dict[str, float]]:
    """(ATWV, per-keyword TWV)."""
    ref_by_kw: Dict[str, List[RefEntry]] = {}
    for r in refs:
        ref_by_kw.setdefault(r[0], []).append(r)
    hyp_by_kw: Dict[str, List[HypEntry]] = {}
    for h in hyps:
        hyp_by_kw.setdefault(h[0], []).append(h)
    per_kw: Dict[str, float] = {}
    for kw, kw_refs in ref_by_kw.items():
        n_true = len(kw_refs)
        matched = [False] * n_true
        n_correct = n_spurious = 0
        for h in sorted(hyp_by_kw.get(kw, []), key=lambda x: -x[4]):
            h_mid = 0.5 * (h[2] + h[3])
            best, best_d = -1, max_distance
            for i, r in enumerate(kw_refs):
                if matched[i] or r[1] != h[1]:
                    continue
                d = abs(0.5 * (r[2] + r[3]) - h_mid)
                if d <= best_d:
                    best, best_d = i, d
            if best >= 0:
                matched[best] = True
                n_correct += 1
            else:
                n_spurious += 1
        p_miss = 1.0 - n_correct / n_true
        p_fa = n_spurious / max(trials_sec - n_true, 1e-8)
        per_kw[kw] = 1.0 - p_miss - beta * p_fa
    atwv = (sum(per_kw.values()) / len(per_kw)) if per_kw else 0.0
    return atwv, per_kw
