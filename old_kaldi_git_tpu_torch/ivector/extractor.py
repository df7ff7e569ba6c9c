"""iVector extraction, decode side.

Counterpart of old_kaldi_git_tpu/ivector/extractor.py (reference
src/ivector/ivector-extractor.{h,cc} and online2/online-ivector-feature.cc):
an IvectorExtractor is a diagonal UBM and a T matrix [C, D, R]; an
utterance's iVector is the mean of the Gaussian posterior over w,

    L = I + Σ_c γ_c T_cᵀ Σ_c⁻¹ T_c,    mean = L⁻¹ Σ_c T_cᵀ Σ_c⁻¹ f_c,

from its zeroth-order (γ) and centred first-order (f) UBM statistics.  Online
iVectors re-estimate w every `period` frames from the cumulative statistics.

The UBM is a DiagGmm or a full-covariance FullGmm (`final.ie` kind 0 or 1).
Training: `train_ubm` (EM for a diagonal UBM on pooled frames) and
`train_ivector_extractor` (EM for T: the E-step's posterior over w for every
utterance, the M-step one least-squares solve per Gaussian).

The JAX package does this arithmetic in numpy float64 on the host, one
utterance at a time; the port does the same float64 arithmetic in torch on
the extractor's device and casts to float32 once, at the end.  Its E-step is
batched: [U, C] zeroth- and [U, C, D] first-order statistics from padded
groups of utterances, [U, R, R] precisions, one batched solve and inverse,
and the sums over utterances as products in a fixed order (no atomics), so
a run on the card repeats itself bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.gmm.diag_gmm import DiagGmm
from old_kaldi_git_tpu_torch.gmm.full_gmm import FullGmm
from old_kaldi_git_tpu_torch.utils import io_funcs as iof
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("ivector")

Frames = Union[np.ndarray, torch.Tensor]
Ubm = Union[DiagGmm, FullGmm]


def train_ubm(feats: np.ndarray, num_gauss: int = 64, num_iters: int = 10, seed: int = 0,
              device: DeviceLike = None, history: Optional[List[dict]] = None) -> DiagGmm:
    """EM for a diagonal UBM on pooled frames [N, D], on `device`.  The start
    is the JAX package's, drawn on the host: global variance + 1e-3, means
    perturbed by 0.5·σ·N(0, 1) from numpy's generator seeded `seed`.  Each
    iteration: posteriors, counts + 1e-8, means and variances (floored at
    1e-3), weights.  history: receives one dict an iteration (`iter`,
    `avg_loglike`)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    xh = np.asarray(feats, np.float64)
    gmean, gvar = xh.mean(0), xh.var(0) + 1e-3
    means = gmean + 0.5 * np.sqrt(gvar) * rng.standard_normal((num_gauss, xh.shape[1]))
    gmm = DiagGmm(np.ones(num_gauss) / num_gauss, means, np.tile(gvar, (num_gauss, 1)))
    x = torch.from_numpy(xh).to(dev)
    for it in range(num_iters):
        gmm = ubm_em_step(gmm, x)
        like = float(gmm.loglikes(x).mean())
        log.info("UBM iter %d: avg loglike %.4f", it, like)
        if history is not None:
            history.append({"iter": it, "avg_loglike": like})
    return gmm


def ubm_em_step(gmm: DiagGmm, x: torch.Tensor) -> DiagGmm:
    """One EM iteration of train_ubm on float64 frames x [N, D] (on their
    device)."""
    post = gmm.posteriors(x)  # [N, C]
    counts = post.sum(0) + 1e-8
    new_means = post.T @ x / counts[:, None]
    new_vars = torch.clamp(post.T @ (x * x) / counts[:, None] - new_means ** 2, min=1e-3)
    weights = counts / counts.sum()
    return DiagGmm(weights.cpu().numpy(), new_means.cpu().numpy(), new_vars.cpu().numpy())


class IvectorExtractor:
    """A UBM (diagonal or full-covariance) and its T matrix [C, D, R] (float64
    on `device`)."""

    def __init__(self, ubm: Ubm, T: Frames, device: DeviceLike = None):
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

    def save(self, path: str) -> None:
        """`final.ie` as the JAX package writes it: <IvectorExtractor> kind
        (0 = diagonal UBM, 1 = full covariance), the UBM, R, T as a float64
        [C·D, R] matrix </IvectorExtractor>."""
        c, d, r = self.T.shape
        with open(path, "wb") as f:
            iof.init_kaldi_output_stream(f, True)
            iof.write_token(f, "<IvectorExtractor>")
            iof.write_int32(f, 1 if isinstance(self.ubm, FullGmm) else 0)
            self.ubm.write(f)
            iof.write_int32(f, r)
            iof.write_matrix(f, self.T.reshape(c * d, r).cpu().numpy(), dtype=np.float64)
            iof.write_token(f, "</IvectorExtractor>")

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "IvectorExtractor":
        """A binary `final.ie`: <IvectorExtractor> kind (0 = <DiagGMM>,
        1 = <FullGMM>), the UBM, R, the [C·D, R] float64 T
        </IvectorExtractor>."""
        with open(path, "rb") as f:
            if not iof.init_kaldi_input_stream(f):
                raise KaldiError(f"{path}: expected a binary Kaldi stream")
            iof.expect_token(f, "<IvectorExtractor>")
            kind = iof.read_int32(f)
            if kind not in (0, 1):
                raise KaldiError(f"{path}: unknown UBM kind {kind}")
            ubm = FullGmm.read(f) if kind == 1 else DiagGmm.read(f)
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


def _utt_stats(ubm: Ubm, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(γ [C], f [C, D]): zeroth- and centred first-order stats of float64
    frames x [T, D]."""
    post = ubm.posteriors(x)  # [T, C]
    gamma = post.sum(0)
    return gamma, post.T @ x - gamma[:, None] * ubm.tensors(x.device)["means"]


def _sigma_inv_T(ext: IvectorExtractor) -> torch.Tensor:
    """Σ_c⁻¹ T_c [C, D, R] of the diagonal or full-covariance UBM."""
    t = ext.ubm.tensors(ext.device)
    if isinstance(ext.ubm, FullGmm):
        return torch.einsum("cde,cer->cdr", t["inv_covars"], ext.T)
    return ext.T / t["vars"][:, :, None]


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


# ---------------------------------------------------------------------------
# extractor training (reference ivector-extractor-{init,acc-stats,est})
# ---------------------------------------------------------------------------

FRAMES_A_GROUP = 16384  # padded frames a group of the batched E-step


def init_ivector_extractor(ubm: Ubm, ivector_dim: int = 32, seed: int = 0,
                           device: DeviceLike = None) -> IvectorExtractor:
    """T = 0.1·N(0, 1) [C, D, R], drawn on the host from numpy's generator
    seeded `seed` (the JAX package's draw; reference ivector-extractor-init)."""
    rng = np.random.default_rng(seed)
    c, d = ubm.means.shape
    return IvectorExtractor(ubm, 0.1 * rng.standard_normal((c, d, ivector_dim)), device)


def batch_utt_stats(ext: IvectorExtractor, utt_feats: Sequence[Frames]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(γ [U, C], f [U, C, D]) of every utterance: groups of utterances
    padded to their longest, posteriors of the padding masked to 0, the
    sums over time as batched products."""
    xs = [ext.frames(x) for x in utt_feats]
    C, D = ext.ubm.num_mix, ext.ubm.dim
    means = ext.ubm.tensors(ext.device)["means"]
    gammas, fs = [], []
    i = 0
    while i < len(xs):
        j, tmax = i + 1, xs[i].shape[0]
        while j < len(xs) and (j - i + 1) * max(tmax, xs[j].shape[0]) <= FRAMES_A_GROUP:
            tmax = max(tmax, xs[j].shape[0])
            j += 1
        group, tmax = xs[i:j], max(tmax, 1)
        pad = torch.zeros((len(group), tmax, D), dtype=torch.float64, device=ext.device)
        mask = torch.zeros((len(group), tmax), dtype=torch.float64, device=ext.device)
        for g, x in enumerate(group):
            pad[g, : x.shape[0]] = x
            mask[g, : x.shape[0]] = 1.0
        post = ext.ubm.posteriors(pad.reshape(-1, D)).reshape(len(group), tmax, C)
        post = post * mask[:, :, None]
        gamma = post.sum(1)  # [G, C]
        gammas.append(gamma)
        fs.append(torch.bmm(post.transpose(1, 2), pad) - gamma[:, :, None] * means)
        i = j
    return torch.cat(gammas), torch.cat(fs)


def batch_posteriors(ext: IvectorExtractor, gamma: torch.Tensor, f: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The posterior over w of U utterances at once: (means [U, R],
    precisions L [U, R, R])."""
    U = gamma.shape[0]
    r = ext.ivector_dim
    sit, W = _precomputed(ext)
    L = torch.eye(r, dtype=torch.float64, device=ext.device) + (
        gamma @ W.reshape(W.shape[0], r * r)).reshape(U, r, r)
    b = f.reshape(U, -1) @ sit.reshape(-1, r)
    return torch.linalg.solve(L, b[..., None])[..., 0], L


def acc_ivector_extractor_stats(ext: IvectorExtractor, utt_feats: Sequence[Frames]
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """E-step (reference ivector-extractor-acc-stats), all utterances at
    once: A_c = Σ_u γ_uc E[w wᵀ] [C, R, R], B_c = Σ_u f_uc E[w]ᵀ [C, D, R],
    and Σ_u |E[w]|² (a 0-d tensor), float64 on the extractor's device."""
    gamma, f = batch_utt_stats(ext, utt_feats)
    mean, L = batch_posteriors(ext, gamma, f)
    U, C, D = f.shape
    r = ext.ivector_dim
    ww = torch.linalg.inv(L) + mean[:, :, None] * mean[:, None, :]  # [U, R, R]
    A = (gamma.T @ ww.reshape(U, r * r)).reshape(C, r, r)
    B = (f.reshape(U, C * D).T @ mean).reshape(C, D, r)
    return A, B, (mean * mean).sum()


def est_ivector_extractor(ext: IvectorExtractor, A: torch.Tensor, B: torch.Tensor
                          ) -> IvectorExtractor:
    """M-step (reference IvectorExtractorStats::Update): T_c = B_c A_c⁻¹ for
    every Gaussian in one batched solve; a Gaussian whose A_c is singular
    keeps its old T_c."""
    X, info = torch.linalg.solve_ex(A.transpose(1, 2), B.transpose(1, 2))
    T = torch.where((info == 0)[:, None, None], X.transpose(1, 2), ext.T)
    return IvectorExtractor(ext.ubm, T, ext.device)


def train_ivector_extractor(ubm: Ubm, utt_feats: Sequence[Frames], ivector_dim: int = 32,
                            num_iters: int = 5, seed: int = 0, device: DeviceLike = None,
                            history: Optional[List[dict]] = None) -> IvectorExtractor:
    """EM for T from init_ivector_extractor, on `device`; the UBM may be
    diagonal or full.  history: receives one dict an iteration (`iter`,
    `mean_w2`: the mean |E[w]|² over utterances in that E-step)."""
    ext = init_ivector_extractor(ubm, ivector_dim, seed, device)
    for it in range(num_iters):
        A, B, aux = acc_ivector_extractor_stats(ext, utt_feats)
        ext = est_ivector_extractor(ext, A, B)
        mw2 = float(aux) / max(len(utt_feats), 1)
        log.info("ivector iter %d: mean |w|² %.4f", it, mw2)
        if history is not None:
            history.append({"iter": it, "mean_w2": mw2})
    return ext


def extract_ivectors_per_spk(ext: IvectorExtractor, feats: Dict[str, Frames],
                             utt2spk: Optional[Dict[str, str]] = None
                             ) -> Dict[str, torch.Tensor]:
    """{speaker (or utterance): float32 [R] iVector} from each speaker's
    pooled statistics, on the extractor's device."""
    groups: Dict[str, list] = {}
    for utt, x in feats.items():
        groups.setdefault((utt2spk or {}).get(utt, utt), []).append(x)
    out = {}
    for spk, xs in groups.items():
        gamma, f = None, None
        for x in xs:
            g1, f1 = _utt_stats(ext.ubm, ext.frames(x))
            gamma = g1 if gamma is None else gamma + g1
            f = f1 if f is None else f + f1
        out[spk] = _posterior(ext, gamma, f)[0].to(torch.float32)
    return out


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
