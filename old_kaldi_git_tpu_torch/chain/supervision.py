"""Chain supervision: tolerance-windowed numerator constraints from alignments.

Counterpart of old_kaldi_git_tpu/chain/supervision.py (reference
src/chain/chain-supervision.cc, supervision from alignments): the phone
alignment subsampled, each phone boundary free to move by ±tolerance
frames, the numerator as a linear phone sequence and a [T', L] mask of the
tokens allowed at each subsampled frame.  Host numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.hmm.hmm_utils import (
    alignment_to_phones, split_to_phones)
from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
from old_kaldi_git_tpu_torch.tree.context_dep import ContextDependency
from old_kaldi_git_tpu_torch.utils.log import KaldiError


@dataclasses.dataclass
class ChainSupervision:
    """One utterance: the pdfs of its phone tokens and their windows."""

    pdf_seq: np.ndarray  # [L] int32: pdf of each phone token
    allowed: np.ndarray  # [T', L] bool: token l may emit at frame t
    num_frames: int  # T' (subsampled)
    advance_lp: np.ndarray = None  # [L]: den-graph weight of entering token l


def _windows(phones: Sequence[int], ctx_dep: ContextDependency):
    """Each token's phone window: left-biphone trees take the previous
    phone, 0 before the first (the den graph's convention)."""
    if ctx_dep.N == 1:
        return [[p] for p in phones]
    if ctx_dep.N == 2 and ctx_dep.P == 1:
        return [[phones[l - 1] if l > 0 else 0, p] for l, p in enumerate(phones)]
    raise KaldiError("supervision supports N=1 and left-biphone N=2/P=1")


def alignment_to_supervision(alignment: Sequence[int], tm: TransitionModel,
                             ctx_dep: ContextDependency,
                             frame_subsampling_factor: int = 3,
                             left_tolerance: int = 5, right_tolerance: int = 5,
                             den=None) -> ChainSupervision:
    """tid alignment (frame rate) → supervision at the subsampled rate;
    `den` gives the tokens their den-graph weights."""
    segments = split_to_phones(tm, alignment)
    if not segments:
        raise KaldiError("empty alignment")
    phones = alignment_to_phones(tm, alignment)
    durations = [len(seg) for seg in segments]
    fsf = frame_subsampling_factor
    T = sum(durations)
    Tsub = (T + fsf - 1) // fsf
    L = len(phones)
    starts = np.cumsum([0] + durations[:-1])
    ends = np.cumsum(durations)
    sub_start = np.maximum(starts - left_tolerance, 0) // fsf
    sub_end = (np.minimum(ends + right_tolerance, T) + fsf - 1) // fsf
    allowed = np.zeros((Tsub, L), bool)
    for l in range(L):
        allowed[sub_start[l]: max(sub_end[l], sub_start[l] + 1), l] = True
    if not allowed.any(axis=1).all():
        raise KaldiError("supervision window left frames uncovered")
    pdf_seq = np.asarray([ctx_dep.compute(w, 0) for w in _windows(phones, ctx_dep)],
                         np.int32)
    advance_lp = (den.numerator_weights(phones).astype(np.float32) if den is not None
                  else np.zeros(L, np.float32))
    return ChainSupervision(pdf_seq=pdf_seq, allowed=allowed, num_frames=Tsub,
                            advance_lp=advance_lp)


def pad_supervisions(sups: Sequence[ChainSupervision]
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Batch: (pdf_seq [B, L], allowed [B, T', L], num_frames [B],
    seq_len [B], advance_lp [B, L])."""
    B = len(sups)
    L = max(len(s.pdf_seq) for s in sups)
    T = max(s.num_frames for s in sups)
    pdf_seq = np.zeros((B, L), np.int32)
    allowed = np.zeros((B, T, L), bool)
    num_frames = np.zeros(B, np.int32)
    seq_len = np.zeros(B, np.int32)
    advance_lp = np.zeros((B, L), np.float32)
    for b, s in enumerate(sups):
        ls = len(s.pdf_seq)
        pdf_seq[b, :ls] = s.pdf_seq
        allowed[b, : s.num_frames, :ls] = s.allowed
        num_frames[b] = s.num_frames
        seq_len[b] = ls
        if s.advance_lp is not None:
            advance_lp[b, :ls] = s.advance_lp
    return pdf_seq, allowed, num_frames, seq_len, advance_lp


def chain_xent_labels(alignment: Sequence[int], tm: TransitionModel,
                      ctx_dep: ContextDependency, frame_subsampling_factor: int,
                      num_frames: int) -> np.ndarray:
    """[num_frames] hard chain-pdf labels at the subsampled rate for the
    cross-entropy regulariser (left-biphone context from the previous
    phone, 0 before the first)."""
    frames = []
    prev = 0
    for seg, ph in zip(split_to_phones(tm, alignment), alignment_to_phones(tm, alignment)):
        frames.extend([(prev, ph)] * len(seg))
        prev = ph
    out = np.zeros(num_frames, np.int32)
    for t, (left, ph) in enumerate(frames[::frame_subsampling_factor][:num_frames]):
        out[t] = ctx_dep.compute([ph] if ctx_dep.N == 1 else [left, ph], 0)
    return out
