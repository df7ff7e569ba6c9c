"""Training examples ("egs"), in memory.

Counterpart of the in-memory half of old_kaldi_git_tpu/models/egs.py
(reference src/nnet3/nnet-example.{h,cc}, src/chain/chain-supervision,
nnet3-get-egs / nnet3-chain-get-egs and the ExampleMerger): an eg's feats and
labels have equal length (the model pads context inside itself), and merging
stacks egs into [B, T, ...] arrays, which one train step consumes.
`combine_chain_models` batches its held-out egs through these.  Archives of
egs ride the table I/O (pipes, scripts, gzip) through two holders, "egs" and
"cegs", in the JAX package's bytes: Kaldi-style tokens over the io_funcs
primitives, binary only.
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO, Iterable, Iterator, List, Sequence, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.chain.supervision import (
    ChainSupervision, alignment_to_supervision, chain_xent_labels, pad_supervisions)
from old_kaldi_git_tpu_torch.utils import io_funcs as iof
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.table import Holder, register_holder

log = get_logger("egs")


@dataclasses.dataclass
class NnetEg:
    """Cross-entropy example: feats [T, D], pdf labels [T], weight mask [T].

    ivector: optional [R] per-chunk online i-vector (reference NnetIo
    "ivector" input with a single t=0 index, broadcast over the chunk via
    ReplaceIndex); batch_ce_egs appends it to every frame's features."""

    feats: np.ndarray
    labels: np.ndarray
    mask: np.ndarray = None
    ivector: np.ndarray = None

    def __post_init__(self):
        if self.mask is None:
            self.mask = np.ones(len(self.labels), np.float32)


@dataclasses.dataclass
class ChainEg:
    """LF-MMI example: full-rate feats + subsampled-rate supervision
    (+ hard xent labels for the cross-entropy regularizer head).

    ivector: optional [R] per-chunk online i-vector (see NnetEg)."""

    feats: np.ndarray  # [Tfull, D]
    sup: ChainSupervision
    xent: np.ndarray  # [T'] int32
    ivector: np.ndarray = None


# ---------------------------------------------------------------------------
# archive I/O: <Eg> and <ChainEg> records
# ---------------------------------------------------------------------------

def _write_ivec(f: BinaryIO, v: np.ndarray) -> None:
    """An int32 vector as a count and little-endian words (no size bytes)."""
    v = np.asarray(v, np.int32).reshape(-1)
    iof.write_int32(f, len(v))
    f.write(v.astype("<i4").tobytes())


def _read_ivec(f: BinaryIO) -> np.ndarray:
    n = iof.read_int32(f)
    raw = f.read(4 * n)
    if len(raw) != 4 * n:
        raise KaldiError("truncated int vector in eg")
    return np.frombuffer(raw, "<i4").astype(np.int32)


def _write_opt_ivector(f: BinaryIO, iv) -> None:
    """The optional <IVec> section, just before the close token."""
    if iv is not None:
        iof.write_token(f, "<IVec>")
        iof.write_vector(f, np.asarray(iv, np.float32))


def _read_opt_ivector(f: BinaryIO, close_token: str):
    tok = iof.read_token(f)
    if tok == "<IVec>":
        iv = iof.read_vector(f).astype(np.float32)
        iof.expect_token(f, close_token)
        return iv
    if tok != close_token:
        raise KaldiError(f"expected {close_token} or <IVec>, got {tok}")
    return None


class NnetEgHolder(Holder):
    """<Eg> feats (float matrix) labels (int vector) mask (float vector)
    [<IVec> vector] </Eg>."""

    name = "egs"

    def write(self, f: BinaryIO, eg: NnetEg, binary: bool) -> None:
        if not binary:
            raise KaldiError("egs are binary-only")
        iof.write_token(f, "<Eg>")
        iof.write_matrix(f, eg.feats)
        _write_ivec(f, eg.labels)
        iof.write_vector(f, eg.mask)
        _write_opt_ivector(f, eg.ivector)
        iof.write_token(f, "</Eg>")

    def read(self, f: BinaryIO) -> NnetEg:
        iof.expect_token(f, "<Eg>")
        feats = iof.read_matrix(f)
        labels = _read_ivec(f)
        mask = iof.read_vector(f)
        return NnetEg(feats, labels, mask, _read_opt_ivector(f, "</Eg>"))


class ChainEgHolder(Holder):
    """<ChainEg> feats pdf_seq allowed (a float32 0/1 matrix) num_frames
    advance_lp xent [<IVec> vector] </ChainEg>."""

    name = "cegs"

    def write(self, f: BinaryIO, eg: ChainEg, binary: bool) -> None:
        if not binary:
            raise KaldiError("cegs are binary-only")
        iof.write_token(f, "<ChainEg>")
        iof.write_matrix(f, eg.feats)
        _write_ivec(f, eg.sup.pdf_seq)
        iof.write_matrix(f, np.asarray(eg.sup.allowed).astype(np.float32))
        iof.write_int32(f, eg.sup.num_frames)
        iof.write_vector(f, eg.sup.advance_lp)
        _write_ivec(f, eg.xent)
        _write_opt_ivector(f, eg.ivector)
        iof.write_token(f, "</ChainEg>")

    def read(self, f: BinaryIO) -> ChainEg:
        iof.expect_token(f, "<ChainEg>")
        feats = iof.read_matrix(f)
        pdf_seq = _read_ivec(f)
        allowed = iof.read_matrix(f) > 0.5
        num_frames = iof.read_int32(f)
        advance_lp = iof.read_vector(f).astype(np.float32)
        xent = _read_ivec(f)
        ivector = _read_opt_ivector(f, "</ChainEg>")
        return ChainEg(feats, ChainSupervision(pdf_seq, allowed, num_frames, advance_lp),
                       xent, ivector)


register_holder("egs", NnetEgHolder)
register_holder("cegs", ChainEgHolder)


# ---------------------------------------------------------------------------
# extraction (nnet3-get-egs role)
# ---------------------------------------------------------------------------

def _chunk_ivector(ivectors, s: int, e: int):
    """Per-chunk i-vector: the online-ivector row at the chunk midpoint
    (reference nnet3-get-egs --online-ivectors takes the row at the chunk's
    central t over --online-ivector-period); a single [R] vector is used
    as-is (per-utterance i-vector)."""
    if ivectors is None:
        return None
    iv = np.asarray(ivectors, np.float32)
    if iv.ndim == 1:
        return iv
    mid = min((s + e) // 2, iv.shape[0] - 1)
    return iv[mid]


def get_ce_egs(
    feats: np.ndarray,
    pdf_labels: np.ndarray,
    frames_per_eg: int = 64,
    ivectors: np.ndarray = None,
) -> List[NnetEg]:
    """Cut one utterance into fixed-width CE egs (short tails re-windowed
    backward like the in-process trainer's _chunk_batches).

    ivectors: [T, R] online i-vectors (or [R] per-utterance) — each eg
    carries the row at its chunk midpoint."""
    t = min(len(pdf_labels), feats.shape[0])
    out: List[NnetEg] = []
    for s in range(0, t, frames_per_eg):
        e = min(s + frames_per_eg, t)
        if e - s < frames_per_eg // 2 and s > 0:
            s = max(0, e - frames_per_eg)
        out.append(NnetEg(np.asarray(feats[s:e], np.float32),
                          np.asarray(pdf_labels[s:e], np.int32),
                          ivector=_chunk_ivector(ivectors, s, e)))
    return out


def get_chain_egs(
    feats: np.ndarray,
    alignment: np.ndarray,
    gmm_tm,
    ctx_dep,
    den,
    frame_subsampling_factor: int = 3,
    left_tolerance: int = 5,
    right_tolerance: int = 5,
    ivectors: np.ndarray = None,
) -> List[ChainEg]:
    """One utterance → one chain eg (whole-utterance supervision; the
    batched loss pads/masks, so fixed 140/150-frame chunking is a data-
    pipeline choice, not a correctness requirement).

    ivectors: [T, R] online i-vectors (or [R] per-utterance); the eg
    carries the chunk-midpoint row like get_ce_egs and batch_chain_egs
    appends it to every frame (reference nnet3-chain-get-egs
    --online-ivectors)."""
    sup = alignment_to_supervision(
        alignment, gmm_tm, ctx_dep, frame_subsampling_factor,
        left_tolerance, right_tolerance, den=den,
    )
    fsf = frame_subsampling_factor
    xent = chain_xent_labels(alignment, gmm_tm, ctx_dep, fsf, sup.num_frames)
    Tfull = ((feats.shape[0] + fsf - 1) // fsf) * fsf
    padded = np.zeros((Tfull, feats.shape[1]), np.float32)
    padded[: feats.shape[0]] = feats
    return [ChainEg(padded, sup, xent,
                    ivector=_chunk_ivector(ivectors, 0, Tfull))]


# ---------------------------------------------------------------------------
# merging (ExampleMerger role): group same-shape egs into batches
# ---------------------------------------------------------------------------

def _batch_ivector_dim(egs: Sequence) -> int:
    """Common i-vector width of a minibatch (0 if the egs carry none).
    Mixed batches are an extraction bug — refuse rather than silently train
    a subset without its adaptation input."""
    dims = {0 if e.ivector is None else int(np.asarray(e.ivector).shape[-1])
            for e in egs}
    if len(dims) > 1:
        raise KaldiError(
            f"minibatch mixes i-vector dims {sorted(dims)}; merge egs from "
            "one extraction config only (reference ExampleMerger groups by "
            "matching structure)")
    return dims.pop()


def batch_ce_egs(
    egs: Sequence[NnetEg],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack CE egs (padding to the longest) → feats [B,T,D], labels [B,T],
    mask [B,T].

    When the egs carry i-vectors, each eg's [R] i-vector is appended to
    every frame of its feats (→ [B,T,D+R]) — the reference wires
    Append(input, ReplaceIndex(ivector, t, 0)) into the first layer's
    Descriptor (nnet-descriptor.h); with same-length egs that broadcast
    collapses into the feature matrix itself."""
    B = len(egs)
    T = max(e.feats.shape[0] for e in egs)
    D = egs[0].feats.shape[1]
    R = _batch_ivector_dim(egs)
    bf = np.zeros((B, T, D + R), np.float32)
    bl = np.zeros((B, T), np.int32)
    bm = np.zeros((B, T), np.float32)
    for j, e in enumerate(egs):
        n = e.feats.shape[0]
        bf[j, :n, :D] = e.feats
        if R:
            bf[j, :n, D:] = np.asarray(e.ivector, np.float32)[None, :]
        bl[j, : len(e.labels)] = e.labels
        bm[j, : len(e.mask)] = e.mask
    return bf, bl, bm


def batch_chain_egs(egs: Sequence[ChainEg]):
    """Stack chain egs → (feats [B,Tfull,D], pdf_seq, allowed, num_frames,
    seq_len, advance_lp, xent [B,T'])."""
    pdf_seq, allowed, num_frames, seq_len, advance_lp = pad_supervisions(
        [e.sup for e in egs]
    )
    B = len(egs)
    # each eg's feats are pre-padded to num_frames*fsf at extraction, so the
    # longest feats always cover the longest supervision at full rate
    Tfull = max(e.feats.shape[0] for e in egs)
    Tsub = allowed.shape[1]
    D = egs[0].feats.shape[1]
    R = _batch_ivector_dim(egs)
    bf = np.zeros((B, Tfull, D + R), np.float32)
    xent = np.zeros((B, Tsub), np.int32)
    for j, e in enumerate(egs):
        bf[j, : e.feats.shape[0], :D] = e.feats
        if R:
            bf[j, : e.feats.shape[0], D:] = np.asarray(
                e.ivector, np.float32)[None, :]
        xent[j, : len(e.xent)] = e.xent
    return bf, pdf_seq, allowed, num_frames, seq_len, advance_lp, xent


def iter_merged(
    egs: Iterable, minibatch_size: int, drop_last: bool = False
) -> Iterator[list]:
    """Group an eg stream into fixed-size minibatches (shape-padded by the
    batch_* helpers downstream)."""
    group: list = []
    for eg in egs:
        group.append(eg)
        if len(group) == minibatch_size:
            yield group
            group = []
    if group and not drop_last:
        yield group
