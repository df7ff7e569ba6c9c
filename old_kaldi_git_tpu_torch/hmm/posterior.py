"""Frame posteriors over transition-ids / pdfs.

Own copy of old_kaldi_git_tpu/hmm/posterior.py (reference
src/hmm/posterior.{h,cc}), with its archive bytes.  `Posterior` is
`vector<vector<pair<int32, BaseFloat>>>` (per frame, a sparse list of
(id, weight)); tools bin/ali-to-post, bin/weight-silence-post,
bin/post-to-pdf-post build on it.  Here the same shape is plain Python
lists, plus a table holder so posteriors flow through ark pipelines.
"""

from __future__ import annotations

import struct
from typing import Iterable, List, Sequence, Set, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.utils.io_funcs import (
    expect_token,
    init_kaldi_input_stream,
    init_kaldi_output_stream,
    read_int32,
    read_vector,
    write_int32,
    write_token,
    write_vector,
)
from old_kaldi_git_tpu_torch.utils.log import KaldiError
from old_kaldi_git_tpu_torch.utils.table import Holder, register_holder

Posterior = List[List[Tuple[int, float]]]


def ali_to_post(alignment: Sequence[int]) -> Posterior:
    """Hard alignment → one (tid, 1.0) entry per frame (bin/ali-to-post)."""
    return [[(int(t), 1.0)] for t in alignment]


def scale_post(post: Posterior, scale: float) -> Posterior:
    if scale == 1.0:
        return post
    return [[(i, w * scale) for i, w in frame] for frame in post]


def weight_silence_post(
    post: Posterior,
    tm,
    silence_phones: Iterable[int],
    silence_weight: float,
) -> Posterior:
    """Scale entries whose transition-id maps to a silence phone by
    `silence_weight`; zero-weighted entries are dropped (the reference
    bin/weight-silence-post default, used before LDA/MLLT/fMLLR stats so
    silence frames don't dominate the transforms)."""
    sil: Set[int] = set(int(p) for p in silence_phones)
    out: Posterior = []
    for frame in post:
        new = []
        for tid, w in frame:
            if tm.tid_to_phone(tid) in sil:
                w = w * silence_weight
            if w != 0.0:
                new.append((tid, w))
        out.append(new)
    return out


def post_to_pdf_post(post: Posterior, tm) -> Posterior:
    """Transition-id posteriors → pdf posteriors, summing duplicates
    (bin/post-to-pdf-post)."""
    out: Posterior = []
    for frame in post:
        acc = {}
        for tid, w in frame:
            pdf = tm.tid_to_pdf(tid)
            acc[pdf] = acc.get(pdf, 0.0) + w
        out.append(sorted(acc.items()))
    return out


def post_to_weights(post: Posterior) -> List[float]:
    """Per-frame total weight (bin/post-to-weights)."""
    return [sum(w for _, w in frame) for frame in post]


def posterior_entries_to_arrays(post: Posterior):
    """Flatten to (frame_index[N], id[N], weight[N]) numpy arrays for
    batched device-side weighting."""
    ts, ids, ws = [], [], []
    for t, frame in enumerate(post):
        for i, w in frame:
            ts.append(t)
            ids.append(i)
            ws.append(w)
    return (
        np.asarray(ts, np.int32),
        np.asarray(ids, np.int32),
        np.asarray(ws, np.float32),
    )


# ---------------------------------------------------------------------------
# table holder ("post"): text is the reference's
#   utt [ id w id w ] [ id w ] ...
# layout; binary is token-framed counts + packed pairs.
# ---------------------------------------------------------------------------


class PosteriorHolder(Holder):
    name = "post"

    def write(self, f, value: Posterior, binary: bool) -> None:
        if binary:
            init_kaldi_output_stream(f, True)
            write_token(f, "<Post>")
            write_int32(f, len(value))
            for frame in value:
                write_int32(f, len(frame))
                for i, w in frame:
                    f.write(struct.pack("<if", int(i), float(w)))
            write_token(f, "</Post>")
        else:
            parts = []
            for frame in value:
                parts.append("[ " + " ".join(
                    f"{i} {w:.6g}" for i, w in frame) + " ]")
            f.write((" ".join(parts) + "\n").encode())

    def read(self, f) -> Posterior:
        binary = init_kaldi_input_stream(f)
        if binary:
            expect_token(f, "<Post>")
            T = read_int32(f)
            post: Posterior = []
            for _ in range(T):
                n = read_int32(f)
                frame = []
                for _ in range(n):
                    i, w = struct.unpack("<if", f.read(8))
                    frame.append((i, w))
                post.append(frame)
            expect_token(f, "</Post>")
            return post
        toks = f.readline().decode().split()
        post = []
        frame: List[Tuple[int, float]] = []
        it = iter(toks)
        depth = 0
        for tok in it:
            if tok == "[":
                if depth:
                    raise KaldiError("nested '[' in posterior")
                depth, frame = 1, []
            elif tok == "]":
                depth = 0
                post.append(frame)
            else:
                w = next(it)
                frame.append((int(tok), float(w)))
        if depth:
            raise KaldiError("unterminated '[' in posterior")
        return post


register_holder("post", PosteriorHolder)


# ---------------------------------------------------------------------------
# Gaussian-level posteriors (reference src/hmm/posterior.h `GaussPost` =
# vector<vector<pair<int32, Vector<BaseFloat>>>>): per frame, (pdf-id,
# per-Gaussian posterior vector) — produced by gmm-post-to-gpost, consumed
# by gmm-est-fmllr-gpost / gmm-acc-stats-gpost style tools.
# ---------------------------------------------------------------------------

GaussPost = List[List[Tuple[int, np.ndarray]]]


def post_to_gpost(post: Posterior, tm, am, feats) -> GaussPost:
    """Transition-id posteriors → per-Gaussian posteriors
    (reference gmmbin/gmm-post-to-gpost.cc): for each (tid, w) entry the
    pdf's Gaussian responsibilities at that frame, scaled by w; entries of
    one pdf on one frame are merged.  `am` is the port's AmDiagGmm: the
    responsibilities are DiagGmm.posteriors in float64 on its device, one
    call a pdf over the frames that need it."""
    merged = []  # per frame: {pdf: summed weight}
    for frame in post:
        acc: dict = {}
        for tid, w in frame:
            pdf = tm.tid_to_pdf(tid)
            acc[pdf] = acc.get(pdf, 0.0) + w
        merged.append(acc)
    by_pdf: dict = {}  # pdf -> [frame]
    for t, acc in enumerate(merged):
        for pdf in acc:
            by_pdf.setdefault(pdf, []).append(t)
    x = torch.as_tensor(np.asarray(feats, np.float64), device=am.device)
    gammas: dict = {}  # (frame, pdf) -> responsibilities
    for pdf, frames in by_pdf.items():
        rows = am.pdfs[pdf].posteriors(x[torch.as_tensor(frames, device=am.device)])
        for t, row in zip(frames, rows.cpu().numpy()):
            gammas[(t, pdf)] = row
    return [[(pdf, (gammas[(t, pdf)] * w).astype(np.float32)) for pdf, w in sorted(acc.items())]
            for t, acc in enumerate(merged)]


class GaussPostHolder(Holder):
    """Binary-only holder for GaussPost tables ("gpost")."""

    name = "gpost"

    def write(self, f, value: GaussPost, binary: bool) -> None:
        init_kaldi_output_stream(f, True)
        write_token(f, "<GPost>")
        write_int32(f, len(value))
        for frame in value:
            write_int32(f, len(frame))
            for pdf, gamma in frame:
                write_int32(f, int(pdf))
                write_vector(f, np.asarray(gamma, np.float32))
        write_token(f, "</GPost>")

    def read(self, f) -> GaussPost:
        if not init_kaldi_input_stream(f):
            raise KaldiError("gpost tables are binary-only")
        expect_token(f, "<GPost>")
        T = read_int32(f)
        out: GaussPost = []
        for _ in range(T):
            n = read_int32(f)
            out.append([(read_int32(f), read_vector(f)) for _ in range(n)])
        expect_token(f, "</GPost>")
        return out


register_holder("gpost", GaussPostHolder)
