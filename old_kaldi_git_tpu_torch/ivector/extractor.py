"""iVector extraction, decode side.

Counterpart of old_kaldi_git_tpu/ivector/extractor.py (reference
src/ivector/ivector-extractor.{h,cc} and online2/online-ivector-feature.cc):
an IvectorExtractor is a diagonal UBM and a T matrix [C, D, R]; an
utterance's iVector is the mean of the Gaussian posterior over w,

    L = I + Σ_c γ_c T_cᵀ Σ_c⁻¹ T_c,    mean = L⁻¹ Σ_c T_cᵀ Σ_c⁻¹ f_c,

from its zeroth-order (γ) and centred first-order (f) UBM statistics.  Online
iVectors re-estimate w every `period` frames from the cumulative statistics.

The JAX package does this arithmetic in numpy float64 on the host; the port
does the same float64 arithmetic in torch on the extractor's device, and
casts to float32 once, at the end.  The UBM and extractor training (EM) and
full-covariance UBMs are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.gmm.diag_gmm import DiagGmm
from old_kaldi_git_tpu_torch.utils import io_funcs as iof
from old_kaldi_git_tpu_torch.utils.log import KaldiError

Frames = Union[np.ndarray, torch.Tensor]


class IvectorExtractor:
    """A diagonal UBM and its T matrix [C, D, R] (float64 on `device`)."""

    def __init__(self, ubm: DiagGmm, T: Frames, device: DeviceLike = None):
        self.ubm = ubm
        self.device = resolve_device(device)
        self.T = torch.as_tensor(T, dtype=torch.float64).to(self.device)
        if tuple(self.T.shape[:2]) != (ubm.num_mix, ubm.dim):
            raise KaldiError(f"IvectorExtractor: T {tuple(self.T.shape)} does not fit "
                             f"a UBM of {ubm.num_mix} x {ubm.dim}")
        self._precomp: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def ivector_dim(self) -> int:
        return self.T.shape[2]

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "IvectorExtractor":
        """A binary `final.ie`: <IvectorExtractor> kind (0 = diagonal UBM)
        <DiagGMM> R, the [C·D, R] float64 T </IvectorExtractor>."""
        with open(path, "rb") as f:
            if not iof.init_kaldi_input_stream(f):
                raise KaldiError(f"{path}: expected a binary Kaldi stream")
            iof.expect_token(f, "<IvectorExtractor>")
            kind = iof.read_int32(f)
            if kind != 0:
                raise KaldiError(
                    f"{path}: a full-covariance UBM (kind {kind}) is not ported; "
                    "the port reads diagonal UBMs (kind 0)")
            ubm = DiagGmm.read(f)
            r = iof.read_int32(f)
            flat = iof.read_matrix(f)
            iof.expect_token(f, "</IvectorExtractor>")
        T = np.asarray(flat, np.float64).reshape(ubm.num_mix, ubm.dim, r)
        return IvectorExtractor(ubm, T, device)

    def frames(self, feats: Frames) -> torch.Tensor:
        """[T, D] frames as a float64 tensor on the extractor's device."""
        if not isinstance(feats, torch.Tensor):
            feats = torch.from_numpy(np.asarray(feats, np.float64))
        return feats.to(self.device, torch.float64)


def _utt_stats(ubm: DiagGmm, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(γ [C], f [C, D]): zeroth- and centred first-order stats of float64
    frames x [T, D]."""
    post = ubm.posteriors(x)  # [T, C]
    gamma = post.sum(0)
    return gamma, post.T @ x - gamma[:, None] * ubm.tensors(x.device)["means"]


def _sigma_inv_T(ext: IvectorExtractor) -> torch.Tensor:
    """Σ_c⁻¹ T_c [C, D, R] of the diagonal UBM."""
    return ext.T / ext.ubm.tensors(ext.device)["vars"][:, :, None]


def _precomputed(ext: IvectorExtractor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ⁻¹T [C, D, R], W = TᵀΣ⁻¹T [C, R, R]), which depend only on (T, Σ):
    computed once and kept on the extractor."""
    if ext._precomp is None:
        sit = _sigma_inv_T(ext)
        ext._precomp = (sit, torch.einsum("cdr,cds->crs", ext.T, sit))
    return ext._precomp


def _posterior(ext: IvectorExtractor, gamma: torch.Tensor, f: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Gaussian posterior over w: (mean [R], precision L [R, R])."""
    r = ext.ivector_dim
    sit, W = _precomputed(ext)
    L = torch.eye(r, dtype=torch.float64, device=ext.device) + torch.einsum(
        "c,crs->rs", gamma, W)
    b = f.reshape(-1) @ sit.reshape(-1, r)
    return torch.linalg.solve(L, b), L


def _scale_and_cap(g: torch.Tensor, f: torch.Tensor, stats_scale: float,
                   max_count: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cumulative stats (γ [..., C], f [..., C, D]) in the reference order:
    the scale applies during accumulation, and max_count > 0 caps the SCALED
    count."""
    if stats_scale != 1.0:
        g = g * stats_scale
        f = f * stats_scale
    if max_count > 0:
        count = g.sum(-1, keepdim=True)
        scale = torch.where(count > max_count,
                            max_count / torch.clamp(count, min=1e-300),
                            torch.ones_like(count))
        g = g * scale
        f = f * scale[..., None]
    return g, f


def extract_ivector(ext: IvectorExtractor, feats: Frames) -> torch.Tensor:
    """One utterance's iVector [R], float32 on the extractor's device."""
    gamma, f = _utt_stats(ext.ubm, ext.frames(feats))
    return _posterior(ext, gamma, f)[0].to(torch.float32)


def online_ivector_updates(
    ext: IvectorExtractor,
    feats: Frames,
    period: int = 10,
    stats_scale: float = 1.0,
    max_count: float = 0.0,
) -> torch.Tensor:
    """[N, R] float64 iVectors at the N = ceil(T / period) update points of
    extract_online_ivectors, each from the cumulative statistics through
    the end of its period.

    One posterior pass over the utterance, per-period statistics by one
    einsum, cumulative sums over the periods, then ONE batched [N, R, R]
    solve for all update points."""
    x = ext.frames(feats)
    T = x.shape[0]
    R = ext.ivector_dim
    sit, W = _precomputed(ext)
    C, D, _ = ext.T.shape
    post = ext.ubm.posteriors(x)  # [T, C]
    N = -(-T // period)
    pad = N * period - T
    if pad:
        x = torch.cat([x, x.new_zeros((pad, D))])
        post = torch.cat([post, post.new_zeros((pad, C))])
    xr = x.reshape(N, period, D)
    pr = post.reshape(N, period, C)
    g_chunk = pr.sum(1)  # [N, C]
    f_chunk = (torch.einsum("npc,npd->ncd", pr, xr)
               - g_chunk[:, :, None] * ext.ubm.tensors(ext.device)["means"])
    g = torch.cumsum(g_chunk, 0)  # [N, C]: the stats up to each update point
    f = torch.cumsum(f_chunk, 0)  # [N, C, D]
    g, f = _scale_and_cap(g, f, stats_scale, max_count)
    L = torch.eye(R, dtype=torch.float64, device=ext.device) + torch.einsum(
        "nc,crs->nrs", g, W)
    b = f.reshape(N, C * D) @ sit.reshape(C * D, R)
    return torch.linalg.solve(L, b[..., None])[..., 0]


def extract_online_ivectors(
    ext: IvectorExtractor,
    feats: Frames,
    period: int = 10,
    stats_scale: float = 1.0,
    max_count: float = 0.0,
) -> torch.Tensor:
    """Online iVectors: [T, D] frames → [T, R] float32 on the extractor's
    device; frames [p, p+period) carry the iVector estimated from the
    cumulative statistics through the end of that period (reference
    OnlineIvectorFeature; `stats_scale` scales the statistics as they are
    accumulated, `max_count` > 0 caps their scaled count).  Float64 until
    this one cast (online_ivector_updates)."""
    T = len(feats)
    if T == 0:
        return torch.zeros((0, ext.ivector_dim), dtype=torch.float32, device=ext.device)
    w = online_ivector_updates(ext, feats, period, stats_scale, max_count)
    return w.to(torch.float32).repeat_interleave(period, dim=0)[:T]


def append_ivectors(feats: Dict[str, np.ndarray], ext: IvectorExtractor,
                    period: int = 10) -> Dict[str, np.ndarray]:
    """{utt: [T, D]} → {utt: [T, D + R]} with online iVectors appended (the
    nnet3/chain recipes' input convention)."""
    out = {}
    for k, x in feats.items():
        iv = extract_online_ivectors(ext, x, period).cpu().numpy()
        out[k] = np.concatenate([x, iv], axis=1).astype(np.float32)
    return out


class OnlineIvectorExtractor:
    """Streaming counterpart of extract_online_ivectors.

    accept() takes feature frames as they come and returns the iVectors of
    the frames whose period is complete (a hold-back of at most period−1
    frames: a frame's iVector uses the statistics through the end of its
    period); input_finished() flushes the trailing partial period.  For any
    chunking, the concatenated outputs equal extract_online_ivectors over
    the whole stream."""

    def __init__(self, ext: IvectorExtractor, period: int = 10,
                 stats_scale: float = 1.0, max_count: float = 0.0):
        self.ext = ext
        self.period = int(period)
        self.stats_scale = float(stats_scale)
        self.max_count = float(max_count)
        self._buf: Optional[np.ndarray] = None  # pending (< period) frames
        self._gamma: Optional[torch.Tensor] = None
        self._f: Optional[torch.Tensor] = None

    @property
    def ivector_dim(self) -> int:
        return self.ext.ivector_dim

    def _estimate(self) -> np.ndarray:
        g, f = _scale_and_cap(self._gamma, self._f, self.stats_scale, self.max_count)
        mean, _ = _posterior(self.ext, g, f)
        return mean.to(torch.float32).cpu().numpy()

    def _consume(self, chunk: np.ndarray) -> np.ndarray:
        g1, f1 = _utt_stats(self.ext.ubm, self.ext.frames(chunk))
        self._gamma = g1 if self._gamma is None else self._gamma + g1
        self._f = f1 if self._f is None else self._f + f1
        iv = self._estimate()
        return np.broadcast_to(iv, (chunk.shape[0], iv.shape[0])).copy()

    def accept(self, frames: np.ndarray) -> np.ndarray:
        """[n, D] new frames → [m, R] iVectors of the m ≤ n + pending frames
        whose period completed, in input order."""
        frames = np.asarray(frames)
        if self._buf is not None and self._buf.size:
            frames = np.concatenate([self._buf, frames])
        n_full = (frames.shape[0] // self.period) * self.period
        self._buf = frames[n_full:]
        out = [self._consume(frames[s: s + self.period])
               for s in range(0, n_full, self.period)]
        if not out:
            return np.zeros((0, self.ivector_dim), np.float32)
        return np.concatenate(out)

    def input_finished(self) -> np.ndarray:
        """Flush the trailing partial period, if any."""
        if self._buf is None or not self._buf.size:
            return np.zeros((0, self.ivector_dim), np.float32)
        tail, self._buf = self._buf, None
        return self._consume(tail)
