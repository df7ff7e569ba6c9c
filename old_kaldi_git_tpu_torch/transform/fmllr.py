"""fMLLR (CMLLR) speaker-adaptive affine feature transforms.

Counterpart of old_kaldi_git_tpu/transform/fmllr.py (reference
src/transform/fmllr-diag-gmm.{h,cc}, FmllrDiagGmmAccs and
ComputeFmllrMatrixDiagGmmFull): K and per-row G_i statistics from
Gaussian posteriors, then the iterative row update with cofactors, solving
each row's quadratic for the log-det step.

The statistics come from every aligned frame at once on the model's device
(transform/mllt.py `aligned_gaussian_posteriors`: the same per-group skip
of Gaussians under 1e-8 as the JAX package), in float64, one product a
chunk of frames and speaker (`accumulate_speakers`).  The row update runs
for all speakers together (`compute_fmllr_transforms`): [S, D, D+1]
transforms, `torch.linalg.inv` / `det` on [S, D, D] in float64, with the
JAX package's 1e-5 ridge and root of the quadratic; a speaker under
`min_count` frames gets None.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm
from old_kaldi_git_tpu_torch.transform.mllt import (
    CHUNK_ELEMENTS,
    MIN_GAUSSIAN_TOTAL,
    aligned_gaussian_posteriors,
    padded_gaussians,
)
from old_kaldi_git_tpu_torch.utils.log import get_logger

log = get_logger("fmllr")

ArrayLike = Union[np.ndarray, torch.Tensor]


class FmllrAccs:
    """One speaker's statistics for a [D, D+1] transform: K [D, D+1],
    G [D, D+1, D+1] and beta, float64 on `device`."""

    def __init__(self, dim: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        kw = dict(dtype=torch.float64, device=self.device)
        self.K = torch.zeros((dim, dim + 1), **kw)
        self.G = torch.zeros((dim, dim + 1, dim + 1), **kw)
        self.beta = 0.0

    def _add_frames(self, xp: torch.Tensor, w: torch.Tensor, kv: torch.Tensor,
                    beta: float) -> None:
        """xp [n, D+1] extended frames, w [n, D] = Σ_m γ/σ², kv [n, D] =
        Σ_m γ μ/σ²: K += kvᵀ xp, G_i += Σ_n w[n, i] xp xpᵀ, in chunks."""
        D1 = xp.shape[1]
        D = D1 - 1
        step = max(1, CHUNK_ELEMENTS // (D * D1))
        G = self.G.reshape(D * D1, D1)
        for a in range(0, xp.shape[0], step):
            xs, ws = xp[a:a + step], w[a:a + step]
            self.K += kv[a:a + step].T @ xs
            G += (ws[:, :, None] * xs[:, None, :]).reshape(-1, D * D1).T @ xs
        self.beta += beta

    def accumulate(self, am: AmDiagGmm, feats: ArrayLike, pdf_ids: ArrayLike,
                   weights: Optional[ArrayLike] = None,
                   groups: Optional[ArrayLike] = None) -> None:
        """Frames [N, D] aligned to pdf_ids [N] (one utterance, or several
        told apart by `groups`), split among their pdf's Gaussians by the
        posteriors."""
        accumulate_speakers([self], am, feats, pdf_ids,
                            torch.zeros(len(pdf_ids), dtype=torch.int64), groups, weights)

    def accumulate_gpost(self, am: AmDiagGmm, feats: ArrayLike, gpost) -> None:
        """From Gaussian-level posteriors given by the caller (reference
        gmm-est-fmllr-gpost): gpost[t] is a list of (pdf, γ over the pdf's
        Gaussians); an entry whose γ sums under 1e-8 is skipped.  The same
        statistics as `accumulate` when the posteriors came from the same
        model and features."""
        x = torch.as_tensor(np.asarray(feats, np.float64)).to(self.device)
        _, _, iv, mu, _ = padded_gaussians(am)
        iv, mu = iv.to(self.device), mu.to(self.device)
        rows, pdfs, gams = [], [], []
        for t, frame in enumerate(gpost):
            for pdf, gamma in frame:
                g = np.asarray(gamma, np.float64)
                if g.sum() < MIN_GAUSSIAN_TOTAL:
                    continue
                pad = np.zeros(iv.shape[1])
                pad[: len(g)] = g
                rows.append(t)
                pdfs.append(pdf)
                gams.append(pad)
        if not rows:
            return
        r = torch.as_tensor(rows, device=self.device)
        p = torch.as_tensor(pdfs, device=self.device)
        gam = torch.as_tensor(np.stack(gams), device=self.device)
        w = torch.einsum("nm,nmd->nd", gam, iv[p])
        kv = torch.einsum("nm,nmd->nd", gam, iv[p] * mu[p])
        xp = torch.cat([x[r], torch.ones((len(rows), 1), dtype=x.dtype, device=x.device)], 1)
        self._add_frames(xp, w, kv, float(gam.sum()))

    def add(self, other: "FmllrAccs") -> None:
        self.K += other.K.to(self.device)
        self.G += other.G.to(self.device)
        self.beta += other.beta


def accumulate_speakers(accs: Sequence[FmllrAccs], am: AmDiagGmm, feats: ArrayLike,
                        pdf_ids: ArrayLike, speakers: ArrayLike,
                        groups: Optional[ArrayLike] = None,
                        weights: Optional[ArrayLike] = None) -> None:
    """Every speaker's statistics from one corpus of aligned frames: frame n
    (feats [N, D], pdf_ids [N]) goes to accs[speakers[n]]; `groups` [N]
    tells the utterances apart for the skip of Gaussians (None: the
    speaker's index)."""
    spk = torch.as_tensor(speakers).to(device=am.device, dtype=torch.int64)
    x, pdf, post = aligned_gaussian_posteriors(
        am, feats, pdf_ids, spk if groups is None else groups, weights)
    _, _, iv, mu, _ = padded_gaussians(am)
    D = x.shape[1]
    w = torch.zeros_like(x)
    kv = torch.zeros_like(x)
    step = max(1, CHUNK_ELEMENTS // (post.shape[1] * D))
    for a in range(0, x.shape[0], step):
        ps, gs = pdf[a:a + step], post[a:a + step]
        w[a:a + step] = torch.einsum("nm,nmd->nd", gs, iv[ps])
        kv[a:a + step] = torch.einsum("nm,nmd->nd", gs, iv[ps] * mu[ps])
    xp = torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)], 1)
    frame_beta = post.sum(dim=1)
    for s, acc in enumerate(accs):
        sel = torch.nonzero(spk == s, as_tuple=True)[0]
        if sel.numel():
            acc._add_frames(xp[sel].to(acc.device), w[sel].to(acc.device),
                            kv[sel].to(acc.device), float(frame_beta[sel].sum()))


def compute_fmllr_transforms(accs: Sequence[FmllrAccs], num_iters: int = 20,
                             min_count: float = 500.0) -> List[Optional[np.ndarray]]:
    """Every speaker's W [D, D+1] (float64 on the host), or None for a
    speaker with fewer than min_count frames (reference
    ComputeFmllrMatrixDiagGmmFull), solved for all speakers together on
    the statistics' device."""
    if not accs:
        return []
    dev = accs[0].device
    beta = torch.tensor([a.beta for a in accs], dtype=torch.float64, device=dev)
    ok = beta >= min_count
    for a in accs:
        if a.beta < min_count:
            log.info("fmllr: count %.1f < min %.1f, skipping", a.beta, min_count)
    if not bool(ok.any()):
        return [None] * len(accs)
    K = torch.stack([a.K.to(dev) for a in accs])
    G = torch.stack([a.G.to(dev) for a in accs])
    S, D, D1 = K.shape
    eye = torch.eye(D1, dtype=torch.float64, device=dev)
    # a refused speaker's rows are solved on stand-in statistics and dropped
    G = torch.where(ok[:, None, None, None], G, eye)
    K = torch.where(ok[:, None, None], K, torch.zeros_like(K))
    beta = torch.where(ok, beta, torch.ones_like(beta))
    g_inv = torch.linalg.inv(G + 1e-5 * eye)
    W = torch.zeros((S, D, D1), dtype=torch.float64, device=dev)
    W[:, :, :D] = torch.eye(D, dtype=torch.float64, device=dev)

    def objf(w):
        _, logdet = torch.linalg.slogdet(w[:, :, :D])
        return (beta * logdet + (w * K).sum(dim=(1, 2))
                - 0.5 * torch.einsum("sia,siab,sib->s", w, G, w))

    start = objf(W)
    zero = torch.zeros((S, 1), dtype=torch.float64, device=dev)
    for _ in range(num_iters):
        for i in range(D):
            a = W[:, :, :D]
            cof = torch.linalg.det(a)[:, None] * torch.linalg.inv(a)[:, :, i]
            c_ext = torch.cat([cof, zero], dim=1)
            gi = g_inv[:, i]
            gc = torch.einsum("sab,sb->sa", gi, c_ext)
            p = (c_ext * gc).sum(dim=1)
            q = (gc * K[:, i]).sum(dim=1)
            disc = q * q + 4.0 * p * beta
            alpha = (-q + torch.sqrt(disc.clamp(min=0.0))) / (2.0 * p.clamp(min=1e-20))
            W[:, i] = torch.einsum("sab,sb->sa", gi, alpha[:, None] * c_ext + K[:, i])
    impr = ((objf(W) - start) / beta).cpu().numpy()
    out: List[Optional[np.ndarray]] = []
    Wh = W.cpu().numpy()
    for s, good in enumerate(ok.cpu().numpy()):
        if good:
            log.info("fmllr: objf improvement %.4f per frame over %d frames", impr[s],
                     int(accs[s].beta))
            out.append(Wh[s])
        else:
            out.append(None)
    return out


def compute_fmllr_transform(accs: FmllrAccs, num_iters: int = 20,
                            min_count: float = 500.0) -> Optional[np.ndarray]:
    """One speaker's W [D, D+1], or None under min_count frames."""
    return compute_fmllr_transforms([accs], num_iters, min_count)[0]


def apply_affine_transform(feats: ArrayLike, w: ArrayLike) -> ArrayLike:
    """y = A x + b for feats [..., D] and W = [A b] ([D, D+1]), computed in
    float64 and cast to float32, as the JAX package's numpy promotes
    float32 features times a float64 transform.  A tensor stays on its
    device; an array gives an array."""
    if isinstance(feats, torch.Tensor):
        wt = torch.as_tensor(w, dtype=torch.float64).to(feats.device)
        return (feats.double() @ wt[:, :-1].T + wt[:, -1]).float()
    w = np.asarray(w, np.float64)
    return (np.asarray(feats) @ w[:, :-1].T + w[:, -1]).astype(np.float32)
