"""PLDA back end for speaker verification.

Counterpart of old_kaldi_git_tpu/ivector/plda.py (reference
src/ivector/plda.{h,cc}): the two-covariance model

  x = μ + y + ε,  y ~ N(0, Φ_b) per class,  ε ~ N(0, Φ_w) per example,

estimated by EM over per-class statistics and stored diagonalised: a
transform A with A Φ_w Aᵀ = I and A Φ_b Aᵀ = diag(ψ).

The matrices are iVector-sized (tens to a few hundred): the estimate and its
eigenproblems run on the host in float64 numpy, as the JAX package runs them
(torch's `eigh` would give other eigenvector signs, and the transform would
part from the JAX package's).  The EM's per-class posteriors are one batched
inverse over the classes.  Scoring a set of trials is one batched product on
the device the caller names (`transform_ivectors`, `log_likelihood_ratios`);
the per-vector functions are the JAX package's, for single trials.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.utils import io_funcs as iof
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("plda")


@dataclasses.dataclass
class Plda:
    mean: np.ndarray  # [D]
    transform: np.ndarray  # [D, D] (A: simultaneously diagonalising)
    psi: np.ndarray  # [D] between-class variance in the transformed space

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    def transform_ivector(self, ivec: np.ndarray, normalize_length: bool = True) -> np.ndarray:
        """A(x − μ), scaled so that its squared norm is the model's expected
        Σ(1 + ψ) (reference Plda::TransformIvector)."""
        u = self.transform @ (np.asarray(ivec, np.float64) - self.mean)
        if normalize_length:
            exp_sq = float(np.sum(1.0 + self.psi))
            u = u * np.sqrt(exp_sq / max(float(u @ u), 1e-20))
        return u

    def log_likelihood_ratio(self, transformed_enroll: np.ndarray, n: int,
                             transformed_test: np.ndarray) -> float:
        """Reference Plda::LogLikelihoodRatio on the diagonalised model: the
        same-class predictive N(nψ/(nψ+1)·ū, 1 + ψ/(nψ+1)) against the
        different-class N(0, 1 + ψ), summed over dimensions."""
        psi = self.psi
        u_e = np.asarray(transformed_enroll, np.float64)
        u_t = np.asarray(transformed_test, np.float64)
        m_same = (n * psi / (n * psi + 1.0)) * u_e
        v_same = 1.0 + psi / (n * psi + 1.0)
        v_diff = 1.0 + psi
        ll_same = -0.5 * np.sum(np.log(2 * np.pi * v_same) + (u_t - m_same) ** 2 / v_same)
        ll_diff = -0.5 * np.sum(np.log(2 * np.pi * v_diff) + u_t ** 2 / v_diff)
        return float(ll_same - ll_diff)

    # -- many vectors at once, float64 on a device ----------------------------
    def transform_ivectors(self, ivecs, normalize_length: bool = True,
                           device: DeviceLike = None) -> torch.Tensor:
        """[N, D] iVectors → [N, D] transformed ones, float64 on `device`."""
        dev = resolve_device(device)
        x = torch.as_tensor(np.asarray(ivecs, np.float64)).to(dev)
        A = torch.from_numpy(self.transform).to(dev)
        u = (x - torch.from_numpy(self.mean).to(dev)) @ A.T
        if normalize_length:
            exp_sq = float(np.sum(1.0 + self.psi))
            u = u * torch.sqrt(exp_sq / torch.clamp((u * u).sum(1, keepdim=True), min=1e-20))
        return u

    def log_likelihood_ratios(self, enroll: torch.Tensor, n: torch.Tensor,
                              test: torch.Tensor) -> torch.Tensor:
        """[N] log-likelihood ratios of N trials: transformed enrolment
        vectors [N, D], their utterance counts [N] and transformed test
        vectors [N, D], on their device."""
        psi = torch.from_numpy(self.psi).to(enroll.device)[None, :]
        n = n.to(enroll.device, torch.float64)[:, None]
        m_same = (n * psi / (n * psi + 1.0)) * enroll
        v_same = 1.0 + psi / (n * psi + 1.0)
        v_diff = 1.0 + psi
        ll_same = -0.5 * (torch.log(2 * np.pi * v_same) + (test - m_same) ** 2 / v_same).sum(1)
        ll_diff = -0.5 * (torch.log(2 * np.pi * v_diff) + test ** 2 / v_diff).sum(1)
        return ll_same - ll_diff

    # -- serialization (plda.cc Write/Read framing, the JAX package's bytes) ---
    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            iof.init_kaldi_output_stream(f, True)
            iof.write_token(f, "<Plda>")
            iof.write_vector(f, self.mean, dtype=np.float64)
            iof.write_matrix(f, self.transform, dtype=np.float64)
            iof.write_vector(f, self.psi, dtype=np.float64)
            iof.write_token(f, "</Plda>")

    @staticmethod
    def load(path: str) -> "Plda":
        with open(path, "rb") as f:
            if not iof.init_kaldi_input_stream(f):
                raise KaldiError("Plda.load: expected binary stream")
            iof.expect_token(f, "<Plda>")
            mean = np.asarray(iof.read_vector(f), np.float64)
            transform = np.asarray(iof.read_matrix(f), np.float64)
            psi = np.asarray(iof.read_vector(f), np.float64)
            iof.expect_token(f, "</Plda>")
            return Plda(mean=mean, transform=transform, psi=psi)


def _simultaneous_diag(within: np.ndarray, between: np.ndarray):
    """A with A W Aᵀ = I and A B Aᵀ = diag(ψ), ψ descending (reference
    ComputeDerivedVars: whiten W, then rotate to diagonalise the whitened B)."""
    w_vals, w_vecs = np.linalg.eigh(within)
    w_vals = np.maximum(w_vals, 1e-10)
    whiten = (w_vecs * (1.0 / np.sqrt(w_vals))).T
    b_w = whiten @ between @ whiten.T
    b_vals, b_vecs = np.linalg.eigh(b_w)
    order = np.argsort(b_vals)[::-1]
    return b_vecs[:, order].T @ whiten, np.maximum(b_vals[order], 0.0)


@dataclasses.dataclass
class PldaStats:
    """Per-class sufficient statistics (reference PldaStats.AddSamples)."""

    dim: int
    class_sums: List[np.ndarray] = dataclasses.field(default_factory=list)
    class_counts: List[int] = dataclasses.field(default_factory=list)
    within_scatter: Optional[np.ndarray] = None
    num_examples: int = 0

    def add_samples(self, examples: np.ndarray) -> None:
        """examples: [n, D] iVectors of one class (speaker)."""
        x = np.asarray(examples, np.float64)
        if self.within_scatter is None:
            self.within_scatter = np.zeros((self.dim, self.dim))
        xc = x - x.mean(axis=0)
        self.within_scatter += xc.T @ xc
        self.class_sums.append(x.sum(axis=0))
        self.class_counts.append(x.shape[0])
        self.num_examples += x.shape[0]


def estimate_plda(stats: PldaStats, num_em_iters: int = 10) -> Plda:
    """Two-covariance EM (reference PldaEstimator::Estimate): each
    iteration the posterior of every class's y (one batched inverse over the
    classes), then Φ_b and Φ_w from their expected scatters."""
    if not stats.class_counts:
        raise KaldiError("estimate_plda: no classes")
    D = stats.dim
    counts = np.asarray(stats.class_counts, np.float64)  # [K]
    sums = np.stack(stats.class_sums)  # [K, D]
    N = float(stats.num_examples)
    K = len(stats.class_counts)
    mu = sums.sum(axis=0) / N
    means = sums / counts[:, None]
    phi_w = stats.within_scatter / max(N - K, 1.0) + 1e-6 * np.eye(D)
    mc = means - mu
    phi_b = (mc.T * counts) @ mc / K + 1e-6 * np.eye(D)
    for it in range(num_em_iters):
        inv_w = np.linalg.inv(phi_w)
        inv_b = np.linalg.inv(phi_b)
        cov = np.linalg.inv(inv_b[None] + counts[:, None, None] * inv_w[None])  # [K, D, D]
        rhs = (inv_b @ mu)[None, :] + (counts[:, None] * means) @ inv_w.T
        w_k = np.einsum("kde,ke->kd", cov, rhs)
        d = w_k - mu
        dm = means - w_k
        cov_sum = cov.sum(axis=0)
        phi_b = (cov_sum + d.T @ d) / K + 1e-8 * np.eye(D)
        phi_w = (stats.within_scatter + np.einsum("k,kde->de", counts, cov)
                 + (dm.T * counts) @ dm) / N + 1e-8 * np.eye(D)
        log.info("plda EM iter %d: tr(W)=%.4f tr(B)=%.4f", it, np.trace(phi_w),
                 np.trace(phi_b))
    a, psi = _simultaneous_diag(phi_w, phi_b)
    return Plda(mean=mu, transform=a, psi=psi)
