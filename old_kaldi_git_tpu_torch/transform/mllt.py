"""MLLT / global semi-tied covariance estimation.

Counterpart of old_kaldi_git_tpu/transform/mllt.py (reference
src/transform/mllt.h, MlltAccs): per-dimension weighted scatter matrices
G_i from Gaussian-level posteriors within each frame's aligned pdf, then the
row-by-row cofactor update of the square transform.

The JAX package loops over each utterance's pdfs and each pdf's Gaussians.
Here every aligned frame of the corpus goes in at once, on the model's
device, in float64: `aligned_gaussian_posteriors` scores each frame against
its own pdf's Gaussians (padded to the largest mixture) and zeroes the
Gaussians whose posterior mass within a group (an utterance's frames of one
pdf, the JAX package's unit) is under 1e-8, as the JAX package skips them;
then G = Σ over (frame, Gaussian) pairs of γ/σ²_i · d dᵀ is one product a
chunk of pairs, added in chunk order (no atomics: the card repeats itself
bit for bit).  `update_mllt` is the JAX package's 40 × 40 float64 cofactor
iteration on the host.  `transform_gmm_means` rewrites every mean in place
and clears the model's caches (`AmDiagGmm.invalidate`).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm
from old_kaldi_git_tpu_torch.utils.log import get_logger

log = get_logger("mllt")

ArrayLike = Union[np.ndarray, torch.Tensor]

MIN_GAUSSIAN_TOTAL = 1e-8  # the JAX package's skip of a Gaussian within a group
CHUNK_ELEMENTS = 1 << 24  # float64 elements of a chunk's largest intermediate


def padded_gaussians(am: AmDiagGmm) -> Tuple[torch.Tensor, ...]:
    """(gconsts [P, M] with −inf past a pdf's Gaussians, means_invvars,
    inv_vars and means [P, M, D], the mixture counts [P]) as float64 /
    int64 tensors on the model's device."""
    P, D = am.num_pdfs, am.dim
    nmix = np.asarray([p.num_mix for p in am.pdfs], np.int64)
    M = int(nmix.max())
    gc = np.full((P, M), -np.inf)
    miv, iv, mu = (np.zeros((P, M, D)) for _ in range(3))
    for i, pdf in enumerate(am.pdfs):
        m = pdf.num_mix
        gc[i, :m] = pdf.gconsts
        miv[i, :m] = pdf.means_invvars
        iv[i, :m] = pdf.inv_vars
        mu[i, :m] = pdf.means
    return tuple(torch.from_numpy(a).to(am.device) for a in (gc, miv, iv, mu, nmix))


def _as_dev(a: ArrayLike, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return a.to(device=dev, dtype=dtype)


def aligned_gaussian_posteriors(am: AmDiagGmm, feats: ArrayLike, pdf_ids: ArrayLike,
                                groups: Optional[ArrayLike] = None,
                                weights: Optional[ArrayLike] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frame n's posteriors over its pdf's Gaussians (reference
    DiagGmm::ComponentPosteriors), scaled by weights[n]; a Gaussian whose
    summed posterior over the frames of one group (groups [N], e.g. the
    utterance's index: the JAX package's per-utterance call) and one pdf is
    under 1e-8 gets 0.  Returns (x [N, D] float64, pdf [N] int64, post
    [N, M] float64), on the model's device."""
    dev = am.device
    x = _as_dev(feats, dev, torch.float64)
    pdf = _as_dev(pdf_ids, dev, torch.int64)
    N = x.shape[0]
    gc, miv, iv, _, nmix = padded_gaussians(am)
    M, D = gc.shape[1], x.shape[1]
    post = torch.zeros((N, M), dtype=torch.float64, device=dev)
    step = max(1, CHUNK_ELEMENTS // (M * D))
    for a in range(0, N, step):
        xs, ps = x[a:a + step], pdf[a:a + step]
        comp = (gc[ps] + torch.einsum("nd,nmd->nm", xs, miv[ps])
                - 0.5 * torch.einsum("nd,nmd->nm", xs * xs, iv[ps]))
        e = torch.exp(comp - comp.max(dim=1, keepdim=True).values)
        post[a:a + step] = e / e.sum(dim=1, keepdim=True)
    if weights is not None:
        post *= _as_dev(weights, dev, torch.float64)[:, None]
    g = (torch.zeros(N, dtype=torch.int64, device=dev) if groups is None
         else _as_dev(groups, dev, torch.int64))
    _, inv = torch.unique(g * am.num_pdfs + pdf, return_inverse=True)
    tot = torch.zeros((int(inv.max()) + 1 if N else 0, M), dtype=torch.float64, device=dev)
    tot.index_put_((inv,), post, accumulate=True)
    post *= (tot[inv] >= MIN_GAUSSIAN_TOTAL).to(post.dtype)
    return x, pdf, post


class MlltAccs:
    """G [D, D, D] (G[i] for output dimension i) and beta, float64 on
    `device`."""

    def __init__(self, dim: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.G = torch.zeros((dim, dim, dim), dtype=torch.float64, device=self.device)
        self.beta = 0.0

    def accumulate(self, am: AmDiagGmm, feats: ArrayLike, pdf_ids: ArrayLike,
                   weights: Optional[ArrayLike] = None,
                   groups: Optional[ArrayLike] = None) -> None:
        """Gaussian-level posteriors within each frame's aligned pdf
        (reference AccumulateFromPosteriors): feats [N, D] and pdf_ids [N]
        may hold a whole corpus, `groups` [N] then telling its utterances
        apart (None: one utterance)."""
        x, pdf, post = aligned_gaussian_posteriors(am, feats, pdf_ids, groups, weights)
        _, _, iv, mu, nmix = padded_gaussians(am)
        # the (frame, Gaussian) pairs within each frame's mixture
        t, m = torch.nonzero(torch.arange(post.shape[1], device=post.device)[None, :]
                             < nmix[pdf][:, None], as_tuple=True)
        D = x.shape[1]
        step = max(1, CHUNK_ELEMENTS // (D * D))
        G = self.G.to(x.device).reshape(D * D, D)
        for a in range(0, t.shape[0], step):
            ts, ms = t[a:a + step], m[a:a + step]
            ps = pdf[ts]
            d = x[ts] - mu[ps, ms]
            w = post[ts, ms][:, None] * iv[ps, ms]
            G += (w[:, :, None] * d[:, None, :]).reshape(-1, D * D).T @ d
        self.G = G.reshape(D, D, D).to(self.device)
        self.beta += float(post.sum())


def update_mllt(accs: MlltAccs, num_iters: int = 10) -> Tuple[np.ndarray, float]:
    """Row-wise cofactor update (reference MlltAccs::Update), float64 on
    the host.  Returns (M [D, D], objective improvement per frame)."""
    G = accs.G.cpu().numpy()
    dim = G.shape[0]
    m = np.eye(dim)
    g_inv = np.stack([np.linalg.inv(G[i] + 1e-6 * np.eye(dim)) for i in range(dim)])

    def objf(mat):
        _, logdet = np.linalg.slogdet(mat)
        return accs.beta * logdet - 0.5 * sum(mat[i] @ G[i] @ mat[i] for i in range(dim))

    start = objf(m)
    for _ in range(num_iters):
        for i in range(dim):
            cof = np.linalg.det(m) * np.linalg.inv(m).T[i]
            quad = cof @ g_inv[i] @ cof
            m[i] = np.sqrt(accs.beta / max(quad, 1e-20)) * (g_inv[i] @ cof)
    impr = (objf(m) - start) / max(accs.beta, 1.0)
    log.info("MLLT: objf improvement %.4f per frame over %d frames", impr, int(accs.beta))
    return m, impr


def transform_gmm_means(am: AmDiagGmm, m: np.ndarray) -> None:
    """μ ← M μ for every Gaussian, in place (reference
    gmm-transform-means), then the model's caches are cleared."""
    for pdf in am.pdfs:
        pdf.means = pdf.means @ m.T
    am.invalidate()
