"""Basis fMLLR: speaker adaptation from very little data.

Counterpart of old_kaldi_git_tpu/transform/basis_fmllr.py (reference
src/transform/basis-fmllr-diag-gmm.{h,cc}, BasisFmllrEstimate): the
transform is W(d) = W0 + Σ_b d_b B_b with W0 = [I | 0], where the basis
matrices B_b are learned once from training speakers' fMLLR statistics (the
leading eigenvectors of the scatter of their gradients at W0, each row
whitened by the Cholesky factor of the count-averaged G_i, the JAX
package's stand-in for the reference's model-derived preconditioner), and a
test speaker estimates only n = min(num_bases, size_scale·β) coefficients.

The statistics are the port's `FmllrAccs` (float64 on the model's device,
transform/fmllr.py); what is learned from them here is small dense algebra
on at most [D(D+1)]² matrices and per-speaker line searches, which run on
the host in float64 numpy exactly as the JAX package runs them, so that on
the same statistics the basis and the transforms are the JAX package's to
the bit (an eigenvector's sign included).  The basis file is the JAX
package's, byte for byte.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.utils.io_funcs import (
    expect_token,
    init_kaldi_input_stream,
    init_kaldi_output_stream,
    read_int32,
    read_matrix,
    write_int32,
    write_matrix,
    write_token,
)
from old_kaldi_git_tpu_torch.utils.log import get_logger

log = get_logger("basis_fmllr")


class HostStats:
    """One speaker's fMLLR statistics on the host: K [D, D+1], G [D, D+1,
    D+1] float64 numpy and beta."""

    def __init__(self, K: np.ndarray, G: np.ndarray, beta: float):
        self.K, self.G, self.beta = K, G, float(beta)

    @staticmethod
    def of(accs) -> "HostStats":
        """From the port's FmllrAccs (tensors on any device) or anything with
        K, G and beta."""
        def host(a):
            return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)

        return HostStats(host(accs.K).astype(np.float64), host(accs.G).astype(np.float64),
                         accs.beta)


def identity_w(dim: int) -> np.ndarray:
    return np.concatenate([np.eye(dim), np.zeros((dim, 1))], axis=1)


def aux_gradient(w: np.ndarray, accs: HostStats) -> np.ndarray:
    """d/dW of β log|A| + tr(W Kᵀ) − ½ Σ_i w_i G_i w_iᵀ at W."""
    dim = w.shape[0]
    inv_t = np.linalg.inv(w[:, :dim]).T
    grad = np.concatenate([accs.beta * inv_t, np.zeros((dim, 1))], axis=1)
    grad += accs.K
    grad -= np.einsum("ij,ijk->ik", w, accs.G)
    return grad


def aux_objf(w: np.ndarray, accs: HostStats) -> float:
    """The fMLLR auxiliary function at W (−inf where |A| ≤ 0)."""
    dim = w.shape[0]
    sign, logdet = np.linalg.slogdet(w[:, :dim])
    if sign <= 0:
        return -np.inf
    quad = np.einsum("ij,ijk,ik->", w, accs.G, w)
    return accs.beta * logdet + float(np.sum(w * accs.K)) - 0.5 * quad


class BasisFmllr:
    """A learned fMLLR basis: `mats[num_bases, D, D+1]` float64."""

    def __init__(self, mats: np.ndarray):
        self.mats = np.asarray(mats, np.float64)

    @property
    def num_bases(self) -> int:
        return self.mats.shape[0]

    @property
    def dim(self) -> int:
        return self.mats.shape[1]

    def write(self, f) -> None:
        """<BasisFmllr> n, n float32 matrices, </BasisFmllr>."""
        init_kaldi_output_stream(f, True)
        write_token(f, "<BasisFmllr>")
        write_int32(f, self.num_bases)
        for b in range(self.num_bases):
            write_matrix(f, self.mats[b].astype(np.float32))
        write_token(f, "</BasisFmllr>")

    @staticmethod
    def read(f) -> "BasisFmllr":
        init_kaldi_input_stream(f)
        expect_token(f, "<BasisFmllr>")
        n = read_int32(f)
        mats = [read_matrix(f) for _ in range(n)]
        expect_token(f, "</BasisFmllr>")
        return BasisFmllr(np.stack(mats))

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            self.write(f)

    @staticmethod
    def load(path: str) -> "BasisFmllr":
        with open(path, "rb") as f:
            return BasisFmllr.read(f)


def estimate_fmllr_basis(spk_accs: Sequence, num_bases: Optional[int] = None) -> BasisFmllr:
    """The basis from training speakers' statistics (FmllrAccs or
    HostStats; reference BasisFmllrEstimate::EstimateFmllrBasis): each
    speaker's gradient at W0, rows whitened by the Cholesky factors of the
    count-averaged G_i, scaled by 1/√β; the leading eigenvectors of their
    scatter, mapped back through the whitening.  num_bases None: min(D(D+1),
    200)."""
    accs = [a for a in (HostStats.of(s) for s in spk_accs) if a.beta > 0]
    if not accs:
        raise ValueError("no non-empty speaker stats")
    dim = accs[0].K.shape[0]
    ncols = dim + 1
    total_beta = sum(a.beta for a in accs)
    g_avg = sum(a.G for a in accs) / total_beta
    chol: List[np.ndarray] = []
    chol_inv: List[np.ndarray] = []
    for i in range(dim):
        li = np.linalg.cholesky(g_avg[i] + 1e-6 * np.eye(ncols))
        chol.append(li)
        chol_inv.append(np.linalg.inv(li))
    w0 = identity_w(dim)
    scatter = np.zeros((dim * ncols, dim * ncols))
    for a in accs:
        grad = aux_gradient(w0, a)
        pre = np.stack([chol_inv[i] @ grad[i] for i in range(dim)])
        v = pre.reshape(-1) / np.sqrt(a.beta)
        scatter += np.outer(v, v)
    evals, evecs = np.linalg.eigh(scatter)
    order = np.argsort(evals)[::-1]
    n = num_bases if num_bases is not None else min(dim * ncols, 200)
    n = min(n, dim * ncols, len(accs) * dim * ncols)
    mats = np.empty((n, dim, ncols))
    lt_inv = [np.linalg.inv(chol[i].T) for i in range(dim)]
    for b in range(n):
        v = evecs[:, order[b]].reshape(dim, ncols)
        mats[b] = np.stack([lt_inv[i] @ v[i] for i in range(dim)])
    log.info("basis-fmllr: %d bases from %d speakers (%.0f frames); top-5 eigenvalues %s",
             n, len(accs), total_beta, np.array2string(evals[order[:5]], precision=3))
    return BasisFmllr(mats)


def compute_fmllr_basis_transform(accs, basis: BasisFmllr, size_scale: float = 0.2,
                                  num_iters: int = 10, min_count: float = 10.0
                                  ) -> Optional[Tuple[np.ndarray, int, float]]:
    """One speaker's transform in the basis (reference
    BasisFmllrEstimate::ComputeTransform): n = min(num_bases, size_scale·β)
    coefficients; each iteration projects the exact gradient onto the first
    n bases and takes a Newton line search along it.  Returns (W [D, D+1],
    n, objective gain per frame), or None under min_count frames."""
    accs = HostStats.of(accs)
    if accs.beta < min_count:
        log.info("basis-fmllr: count %.1f < min %.1f", accs.beta, min_count)
        return None
    dim = basis.dim
    n = int(min(basis.num_bases, max(1.0, size_scale * accs.beta)))
    mats = basis.mats[:n]
    w = identity_w(dim)
    start = aux_objf(w, accs)
    for _ in range(num_iters):
        grad = aux_gradient(w, accs)
        coeffs = np.einsum("bij,ij->b", mats, grad)
        delta = np.einsum("b,bij->ij", coeffs, mats)
        norm = np.linalg.norm(delta)
        if norm < 1e-12:
            break
        delta /= norm
        # f(α) = β log|A + α dA| + c1 α + c2 α²
        d_a = delta[:, :dim]
        c1 = float(np.sum(delta * accs.K)) - np.einsum("ij,ijk,ik->", w, accs.G, delta)
        c2 = -0.5 * np.einsum("ij,ijk,ik->", delta, accs.G, delta)
        a = w[:, :dim]
        alpha = 0.0
        for _newton in range(10):
            m = a + alpha * d_a
            try:
                m_inv = np.linalg.inv(m)
            except np.linalg.LinAlgError:
                alpha *= 0.5
                continue
            g1 = accs.beta * np.trace(m_inv @ d_a) + c1 + 2 * c2 * alpha
            h = -accs.beta * np.trace(m_inv @ d_a @ m_inv @ d_a) + 2 * c2
            if h >= -1e-12:
                break
            new_alpha = alpha - g1 / h
            for _ in range(20):  # keep |A| positive
                sign, _ld = np.linalg.slogdet(a + new_alpha * d_a)
                if sign > 0:
                    break
                new_alpha = (alpha + new_alpha) / 2.0
            if abs(new_alpha - alpha) < 1e-9:
                alpha = new_alpha
                break
            alpha = new_alpha
        new_w = w + alpha * delta
        if aux_objf(new_w, accs) <= aux_objf(w, accs):
            break
        w = new_w
    impr = (aux_objf(w, accs) - start) / accs.beta
    log.info("basis-fmllr: %d coeffs, objf impr %.4f/frame over %.0f frames", n, impr,
             accs.beta)
    return w, n, impr
