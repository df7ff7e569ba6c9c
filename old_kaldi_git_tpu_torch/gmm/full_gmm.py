"""Full-covariance GMMs (the iVector UBM family) and their EM.

Counterpart of old_kaldi_git_tpu/gmm/full_gmm.py (reference
src/gmm/{full-gmm,mle-full-gmm}.{h,cc}, gmm-gselect): a FullGmm keeps float64
weights [M], means [M, D] and covariances [M, D, D] on the host, and scores
frames on the frames' device in float64 from the natural parameters the
reference caches (gconsts, Σ⁻¹μ, Σ⁻¹), uploaded once per device.

The E-step (`AccumFullGmm.accumulate`) adds its statistics as float64 tensors
on the model's device, in chunks of frames taken in order, each chunk one
product (no atomics), so a run on the card repeats itself bit for bit.  The
M-step (`mle_full_gmm_update`) is one batched eigendecomposition over all
components with the JAX package's removal and eigenvalue floor.  The JAX
package scores in float32 in two places (`component_loglikes_batch` and a
diagonal selector in `gselect`); the port scores in float64 throughout.
"""

from __future__ import annotations

from typing import BinaryIO, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.gmm.diag_gmm import M_LOG_2PI, DiagGmm
from old_kaldi_git_tpu_torch.utils import io_funcs as iof
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("fgmm")

Frames = Union[np.ndarray, torch.Tensor]
FRAME_CHUNK = 16384  # frames a step of the E-step: [chunk, M, D] float64 temporaries


def as_frames(x: Frames, device: torch.device) -> torch.Tensor:
    """[T, D] frames as a float64 tensor on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float64))
    return x.to(device, torch.float64)


class FullGmm:
    """One mixture of full-covariance Gaussians."""

    def __init__(self, weights: np.ndarray, means: np.ndarray, covars: np.ndarray):
        self.weights = np.asarray(weights, np.float64)  # [M]
        self.means = np.asarray(means, np.float64)  # [M, D]
        self.covars = np.asarray(covars, np.float64)  # [M, D, D]
        if (self.weights.ndim != 1 or self.means.ndim != 2 or self.covars.ndim != 3
                or self.covars.shape[1:] != (self.dim, self.dim)
                or self.means.shape[0] != self.weights.shape[0]):
            raise KaldiError("FullGmm: bad shapes")

    @property
    def num_mix(self) -> int:
        return self.weights.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    def tensors(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The natural parameters as float64 tensors on `device`, computed
        there once and kept: inv_covars [M, D, D], means_invcovars [M, D],
        gconsts [M] = log w − ½(D log 2π + log|Σ| + μᵀΣ⁻¹μ), and means."""
        cache = self.__dict__.setdefault("_dev", {})
        key = str(device)
        if key not in cache:
            w = torch.from_numpy(self.weights).to(device)
            mu = torch.from_numpy(self.means).to(device)
            cov = torch.from_numpy(self.covars).to(device)
            sign, logdet = torch.linalg.slogdet(cov)
            if bool((sign <= 0).any()):
                raise KaldiError("FullGmm: non-PD covariance")
            inv = torch.linalg.inv(cov)
            mi = torch.einsum("mde,me->md", inv, mu)
            quad = (mu * mi).sum(1)
            gc = torch.log(torch.clamp(w, min=1e-30)) - 0.5 * (
                self.dim * M_LOG_2PI + logdet + quad)
            cache[key] = {"inv_covars": inv, "means_invcovars": mi, "gconsts": gc,
                          "means": mu}
        return cache[key]

    @staticmethod
    def from_diag(diag: DiagGmm) -> "FullGmm":
        """fgmm-global-init-from-diag: diagonal covariances as full ones."""
        return FullGmm(diag.weights.copy(), diag.means.copy(),
                       np.stack([np.diag(v) for v in diag.vars]))

    def to_diag(self) -> DiagGmm:
        """fgmm-global-to-gmm: keep the covariances' diagonals."""
        return DiagGmm(self.weights.copy(), self.means.copy(),
                       np.stack([np.diag(c).copy() for c in self.covars]))

    # -- likelihoods, float64 on the frames' device --------------------------
    def component_loglikes(self, x: torch.Tensor) -> torch.Tensor:
        """[T, D] → [T, M]: gconst + xᵀ(Σ⁻¹μ) − ½ xᵀΣ⁻¹x.  The quadratic form
        is one [T, D] × [D, M·D] product."""
        t = self.tensors(x.device)
        x = x.to(torch.float64)
        M, D = self.num_mix, self.dim
        z = (x @ t["inv_covars"].permute(1, 0, 2).reshape(D, M * D)).reshape(-1, M, D)
        quad = (z * x[:, None, :]).sum(-1)
        return t["gconsts"][None, :] + x @ t["means_invcovars"].T - 0.5 * quad

    def loglikes(self, x: torch.Tensor) -> torch.Tensor:
        return torch.logsumexp(self.component_loglikes(x), dim=1)

    def posteriors(self, x: torch.Tensor) -> torch.Tensor:
        comp = self.component_loglikes(x)
        p = torch.exp(comp - comp.max(dim=1, keepdim=True).values)
        return p / p.sum(dim=1, keepdim=True)

    # -- serialization (Kaldi token framing, the JAX package's bytes) --------
    def write(self, f: BinaryIO) -> None:
        """<FullGMM> FV weights, FM means, M, M × FM covariance </FullGMM>."""
        iof.write_token(f, "<FullGMM>")
        iof.write_vector(f, self.weights.astype(np.float32))
        iof.write_matrix(f, self.means.astype(np.float32))
        iof.write_int32(f, self.num_mix)
        for c in self.covars:
            iof.write_matrix(f, c.astype(np.float32))
        iof.write_token(f, "</FullGMM>")

    @staticmethod
    def read(f: BinaryIO) -> "FullGmm":
        iof.expect_token(f, "<FullGMM>")
        w = iof.read_vector(f)
        means = iof.read_matrix(f)
        m = iof.read_int32(f)
        covars = np.stack([iof.read_matrix(f) for _ in range(m)])
        iof.expect_token(f, "</FullGMM>")
        return FullGmm(w, means, covars)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            iof.init_kaldi_output_stream(f, True)
            self.write(f)

    @staticmethod
    def load(path: str) -> "FullGmm":
        with open(path, "rb") as f:
            if not iof.init_kaldi_input_stream(f):
                raise KaldiError("FullGmm.load: expected binary stream")
            return FullGmm.read(f)


# ---------------------------------------------------------------------------
# Gaussian preselection (gmm-gselect)
# ---------------------------------------------------------------------------

def gselect(gmm, feats: torch.Tensor, num_gselect: int = 20) -> torch.Tensor:
    """[T, D] float64 frames → int64 [T, N] indices of the N best components
    by per-component loglike, best first (reference gmm-gselect), for a
    DiagGmm or a FullGmm, on the frames' device."""
    n = min(num_gselect, gmm.num_mix)
    return torch.topk(gmm.component_loglikes(feats), n, dim=1, sorted=True).indices


def loglikes_preselect(gmm, feats: torch.Tensor, gsel: torch.Tensor) -> torch.Tensor:
    """Total loglike [T] over only the preselected components
    (diag-gmm.cc LogLikelihoodsPreselect)."""
    return torch.logsumexp(torch.gather(gmm.component_loglikes(feats), 1, gsel), dim=1)


# ---------------------------------------------------------------------------
# MLE (mle-full-gmm.{h,cc})
# ---------------------------------------------------------------------------

class AccumFullGmm:
    """Sufficient statistics, float64 on `device`: occupancy [M], first order
    [M, D], full second order [M, D, D], and the total loglike and frames."""

    def __init__(self, num_mix: int, dim: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        z = lambda *s: torch.zeros(s, dtype=torch.float64, device=self.device)  # noqa: E731
        self.occ = z(num_mix)
        self.mean_acc = z(num_mix, dim)
        self.cov_acc = z(num_mix, dim, dim)
        self.tot_like = z()
        self.tot_frames = 0.0

    def accumulate(self, gmm: FullGmm, feats: Frames,
                   gsel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """E-step over [T, D] frames (fgmm-global-acc-stats); with `gsel`
        only the selected components take posterior mass
        (fgmm-global-acc-stats-gselect).  Returns the frames' total loglike
        as a 0-d tensor (no synchronise)."""
        x = as_frames(feats, self.device)
        D = x.shape[1]
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for lo in range(0, x.shape[0], FRAME_CHUNK):
            xc = x[lo: lo + FRAME_CHUNK]
            comp = gmm.component_loglikes(xc)
            if gsel is not None:
                sel = gsel[lo: lo + FRAME_CHUNK].to(self.device)
                masked = torch.full_like(comp, -torch.inf)
                comp = masked.scatter(1, sel, torch.gather(comp, 1, sel))
            like = torch.logsumexp(comp, dim=1, keepdim=True)
            post = torch.exp(comp - like)  # [t, M]
            self.occ += post.sum(0)
            self.mean_acc += post.T @ xc
            xx = (xc[:, :, None] * xc[:, None, :]).reshape(-1, D * D)
            self.cov_acc += (post.T @ xx).reshape(-1, D, D)
            total = total + like.sum()
        self.tot_like = self.tot_like + total
        self.tot_frames += x.shape[0]
        return total

    def add(self, other: "AccumFullGmm") -> None:
        self.occ += other.occ.to(self.device)
        self.mean_acc += other.mean_acc.to(self.device)
        self.cov_acc += other.cov_acc.to(self.device)
        self.tot_like = self.tot_like + other.tot_like.to(self.device)
        self.tot_frames += other.tot_frames

    def write(self, f: BinaryIO) -> None:
        """<FgmmAccs> M D, DV occupancy, DM first order, DM [M·D, D] second
        order, the totals as doubles </FgmmAccs> (the JAX package's bytes)."""
        iof.init_kaldi_output_stream(f, True)
        iof.write_token(f, "<FgmmAccs>")
        M, D = self.mean_acc.shape
        iof.write_int32(f, M)
        iof.write_int32(f, D)
        iof.write_vector(f, self.occ.cpu().numpy(), dtype=np.float64)
        iof.write_matrix(f, self.mean_acc.cpu().numpy(), dtype=np.float64)
        iof.write_matrix(f, self.cov_acc.reshape(M * D, D).cpu().numpy(), dtype=np.float64)
        iof.write_double(f, float(self.tot_like))
        iof.write_double(f, float(self.tot_frames))
        iof.write_token(f, "</FgmmAccs>")

    @staticmethod
    def read(f: BinaryIO, device: DeviceLike = None) -> "AccumFullGmm":
        if not iof.init_kaldi_input_stream(f):
            raise KaldiError("FgmmAccs must be binary")
        iof.expect_token(f, "<FgmmAccs>")
        M = iof.read_int32(f)
        D = iof.read_int32(f)
        accs = AccumFullGmm(M, D, device)
        t = lambda a: torch.from_numpy(np.asarray(a, np.float64)).to(accs.device)  # noqa: E731
        accs.occ = t(iof.read_vector(f))
        accs.mean_acc = t(iof.read_matrix(f))
        accs.cov_acc = t(iof.read_matrix(f)).reshape(M, D, D)
        accs.tot_like = torch.tensor(iof.read_float(f), dtype=torch.float64,
                                     device=accs.device)
        accs.tot_frames = iof.read_float(f)
        iof.expect_token(f, "</FgmmAccs>")
        return accs


def mle_full_gmm_update(gmm: FullGmm, accs: AccumFullGmm,
                        min_gaussian_occupancy: float = 10.0,
                        variance_floor: float = 1e-3,
                        remove_low_count: bool = False) -> FullGmm:
    """M-step (mle-full-gmm.cc MleFullGmmUpdate) for all components at once on
    the statistics' device: a component below `min_gaussian_occupancy` keeps
    its old parameters (or is removed with `remove_low_count`); a covariance
    whose least eigenvalue is below `variance_floor` is rebuilt from its
    eigenvalues floored there; weights are occupancies over the total, then
    renormalised over the kept components."""
    occ = accs.occ
    dev = occ.device
    mean = accs.mean_acc / occ[:, None]
    cov = accs.cov_acc / occ[:, None, None] - mean[:, :, None] * mean[:, None, :]
    cov = 0.5 * (cov + cov.transpose(1, 2))
    ok = occ >= min_gaussian_occupancy
    # starved components are never decomposed: identity in their place
    eye = torch.eye(cov.shape[1], dtype=cov.dtype, device=dev).expand_as(cov)
    cov = torch.where(ok[:, None, None], cov, eye)
    w, v = torch.linalg.eigh(cov)
    floor = ok & (w[:, 0] < variance_floor)
    rebuilt = (v * torch.clamp(w, min=variance_floor)[:, None, :]) @ v.transpose(1, 2)
    cov = torch.where(floor[:, None, None], rebuilt, cov)
    tot = torch.clamp(occ.sum(), min=1e-10)
    ok_h, floored = ok.cpu().numpy(), int(floor.sum())
    weights = np.where(ok_h, (occ / tot).cpu().numpy(), gmm.weights)
    means = np.where(ok_h[:, None], mean.cpu().numpy(), gmm.means)
    covars = np.where(ok_h[:, None, None], cov.cpu().numpy(), gmm.covars)
    if remove_low_count and not ok_h.all():
        weights, means, covars = weights[ok_h], means[ok_h], covars[ok_h]
        log.info("mle_full_gmm_update: removed %d low-count components",
                 int((~ok_h).sum()))
    weights = weights / weights.sum()
    if floored:
        log.info("mle_full_gmm_update: floored %d covariances", floored)
    if accs.tot_frames > 0:
        log.info("fgmm est: avg like/frame %.4f over %.0f frames",
                 float(accs.tot_like) / accs.tot_frames, accs.tot_frames)
    return FullGmm(weights, means, covars)


def train_full_ubm(diag_ubm: DiagGmm, utt_feats: Sequence[Frames], num_iters: int = 4,
                   num_gselect: int = 20, min_gaussian_occupancy: float = 10.0,
                   device: DeviceLike = None,
                   history: Optional[List[dict]] = None) -> FullGmm:
    """A full-covariance UBM from a trained diagonal one (reference
    train_ivector_extractor.sh: fgmm-global-init-from-diag, then
    fgmm-global-acc-stats-gselect / fgmm-global-est iterations), on
    `device`: the diagonal UBM preselects `num_gselect` components a frame
    once, and every E-step runs over all utterances' frames together.
    history: receives one dict an iteration (`iter`, `avg_loglike`)."""
    dev = resolve_device(device)
    x = torch.cat([as_frames(u, dev) for u in utt_feats])
    gsel = torch.cat([gselect(diag_ubm, x[lo: lo + FRAME_CHUNK], num_gselect)
                      for lo in range(0, x.shape[0], FRAME_CHUNK)])
    fgmm = FullGmm.from_diag(diag_ubm)
    for it in range(num_iters):
        accs = AccumFullGmm(fgmm.num_mix, fgmm.dim, dev)
        accs.accumulate(fgmm, x, gsel)
        avg = float(accs.tot_like) / max(accs.tot_frames, 1.0)
        log.info("full UBM iter %d: avg loglike %.4f", it, avg)
        if history is not None:
            history.append({"iter": it, "avg_loglike": avg})
        fgmm = mle_full_gmm_update(fgmm, accs, min_gaussian_occupancy=min_gaussian_occupancy)
    return fgmm
