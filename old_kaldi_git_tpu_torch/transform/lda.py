"""Linear Discriminant Analysis estimation.

Counterpart of old_kaldi_git_tpu/transform/lda.py (reference
src/transform/lda-estimate.h, LdaEstimate): class = pdf-id; per-class
counts and sums and the global second moment are accumulated in float64 on
the frames' device (`index_put_(accumulate=True)`, whose sums run in a
fixed order on the card, and one xᵀx product); `estimate` copies them to
the host and solves the two symmetric eigenproblems (at most 91 × 91) in
float64 numpy exactly as the JAX package does, so that the transform
equals the JAX package's to rounding and no eigenvector's sign depends on
the solver.  The result is the [target_dim, dim] transform that whitens
the within-class covariance (Kaldi's convention).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("lda")

ArrayLike = Union[np.ndarray, torch.Tensor]


class LdaEstimate:
    """counts [C], first (per-class Σx) [C, D] and second (global Σxxᵀ)
    [D, D], float64 tensors on `device` (None: the GPU)."""

    def __init__(self, num_classes: int, dim: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        kw = dict(dtype=torch.float64, device=self.device)
        self.counts = torch.zeros(num_classes, **kw)
        self.first = torch.zeros((num_classes, dim), **kw)
        self.second = torch.zeros((dim, dim), **kw)

    def accumulate(self, feats: ArrayLike, classes: ArrayLike,
                   weights: Optional[ArrayLike] = None) -> None:
        """feats [N, D], classes [N] (any number of utterances at once)."""
        x = torch.as_tensor(feats).to(device=self.device, dtype=torch.float64)
        c = torch.as_tensor(classes).to(device=self.device, dtype=torch.int64)
        w = (torch.ones(x.shape[0], dtype=torch.float64, device=self.device)
             if weights is None
             else torch.as_tensor(weights).to(device=self.device, dtype=torch.float64))
        xw = x * w[:, None]
        self.counts.index_put_((c,), w, accumulate=True)
        self.first.index_put_((c,), xw, accumulate=True)
        self.second += xw.T @ x

    def estimate(self, target_dim: int, within_class_factor: float = 1.0) -> np.ndarray:
        """[target_dim, dim] float64 transform: rows are the discriminant
        directions, scaled so that the projected within-class covariance is
        the identity."""
        counts = self.counts.cpu().numpy()
        first = self.first.cpu().numpy()
        second = self.second.cpu().numpy()
        tot = counts.sum()
        if tot <= 0:
            raise KaldiError("LDA: no stats")
        dim = first.shape[1]
        mean = first.sum(axis=0) / tot
        total_cov = second / tot - np.outer(mean, mean)
        nz = counts > 0
        class_means = np.zeros_like(first)
        class_means[nz] = first[nz] / counts[nz, None]
        bc = ((counts[nz, None] * (class_means[nz] - mean)).T
              @ (class_means[nz] - mean)) / tot
        wc = total_cov - bc
        wc = 0.5 * (wc + wc.T) + 1e-6 * np.eye(dim) * max(np.trace(wc) / dim, 1e-10)
        evals, evecs = np.linalg.eigh(wc)
        evals = np.maximum(evals, 1e-10)
        w_inv_sqrt = evecs @ np.diag(evals ** -0.5) @ evecs.T
        m = w_inv_sqrt @ (0.5 * (bc + bc.T)) @ w_inv_sqrt
        bevals, bevecs = np.linalg.eigh(0.5 * (m + m.T))
        order = np.argsort(bevals)[::-1][:target_dim]
        log.info("LDA: kept %d dims, between-class eigs %s...", target_dim,
                 np.round(bevals[order[: min(5, target_dim)]], 2))
        return ((bevecs[:, order].T @ w_inv_sqrt) * within_class_factor).astype(np.float64)


def estimate_lda(feats_and_classes: Iterable[Tuple[ArrayLike, ArrayLike]], num_classes: int,
                 dim: int, target_dim: int, device: DeviceLike = None) -> np.ndarray:
    """The transform of (feats [T, D], classes [T]) pairs, accumulated on
    `device` (None: the GPU)."""
    acc = LdaEstimate(num_classes, dim, device)
    for feats, classes in feats_and_classes:
        acc.accumulate(feats, classes)
    return acc.estimate(target_dim)
