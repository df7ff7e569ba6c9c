"""Edit distance and WER computation (own copy of
old_kaldi_git_tpu/utils/edit_distance.py: pure Python, no tensors).

Parity with reference src/util/edit-distance-inl.h + src/bin/compute-wer.cc:
Levenshtein distance with insertion/deletion/substitution breakdown and
corpus-level WER aggregation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence


@dataclasses.dataclass
class EditStats:
    errors: int = 0
    ins: int = 0
    dele: int = 0
    sub: int = 0
    ref_len: int = 0
    num_sent: int = 0
    err_sent: int = 0

    @property
    def wer(self) -> float:
        return 100.0 * self.errors / max(self.ref_len, 1)

    def __iadd__(self, other: "EditStats") -> "EditStats":
        self.errors += other.errors
        self.ins += other.ins
        self.dele += other.dele
        self.sub += other.sub
        self.ref_len += other.ref_len
        self.num_sent += other.num_sent
        self.err_sent += other.err_sent
        return self

    def report(self) -> str:
        return (
            f"%WER {self.wer:.2f} [ {self.errors} / {self.ref_len}, "
            f"{self.ins} ins, {self.dele} del, {self.sub} sub ]"
        )


def edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> EditStats:
    """DP edit distance with op breakdown (ins = extra in hyp)."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, ins, del, sub) best alignment of ref[:i], hyp[:j]
    INF = 10**9
    prev = [(j, j, 0, 0) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, i, 0)] + [(INF, 0, 0, 0)] * m
        for j in range(1, m + 1):
            rc, hc = ref[i - 1], hyp[j - 1]
            # substitution / match
            c, a, d, s = prev[j - 1]
            best = (c + (rc != hc), a, d, s + (rc != hc))
            # deletion (ref word dropped)
            c, a, d, s = prev[j]
            if c + 1 < best[0]:
                best = (c + 1, a, d + 1, s)
            # insertion (extra hyp word)
            c, a, d, s = cur[j - 1]
            if c + 1 < best[0]:
                best = (c + 1, a + 1, d, s)
            cur[j] = best
        prev = cur
    cost, ins, dele, sub = prev[m]
    return EditStats(
        errors=cost, ins=ins, dele=dele, sub=sub, ref_len=n,
        num_sent=1, err_sent=int(cost > 0),
    )


def compute_wer(
    ref: Dict[str, List[str]], hyp: Dict[str, List[str]]
) -> EditStats:
    total = EditStats()
    for key, ref_words in ref.items():
        hyp_words = hyp.get(key, [])
        total += edit_distance(ref_words, hyp_words)
    return total
