"""MLE estimation for diagonal GMMs.

Counterpart of old_kaldi_git_tpu/gmm/mle.py (reference
src/gmm/{mle-diag-gmm.h,mle-am-diag-gmm.h}, gmm-mixup, gmm-init-model):

- `AccumAmDiagGmm.accumulate_corpus`: hard-alignment statistics in float64
  on the model's device.  Each frame's posteriors run over its own pdf's
  Gaussians only; occupancies, Σx and Σx² go to padded [P, M] / [P, M, D]
  tensors, and the total log-likelihood beside them.  The JAX package does
  this in host numpy, one BLAS pass per occupied pdf; here frames are
  sorted by their pdf's mixture count and taken in chunks of at most
  CHUNK_PAIRS (frame, Gaussian) pairs, each padded to its own largest
  mixture, so a chunk is a few batched tensor operations.  Sums run in
  another order than the JAX package's (ulps).  They are added by
  `index_put_(accumulate=True)`, which on the card sorts the indices and
  adds in a fixed order, where `index_add_`'s atomics add in another order
  each run: a training run on the card repeats itself bit for bit.
- `mle_am_diag_gmm_update`: the M-step over every pdf at once, on the
  accumulators' device, with the JAX package's rules: Gaussians under
  `min_gaussian_occupancy` counts are removed (the largest is kept when
  none passes), variances floored, weights floored and renormalised; a pdf
  without occupancy is left as it was.  The result is a new AmDiagGmm on the
  same device, whose kernel rows are packed anew when it is first used.
- `mixup` and `init_am_from_tree_stats` are host numpy, as in the JAX
  package, and draw the same numbers from the same seeds.

The accumulator file I/O (`write_accs`, `read_accs`, `AccumDiagGmm`) serves
the command-line tools and is not ported.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, DiagGmm
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass

log = get_logger("gmm")

CHUNK_PAIRS = 1 << 18  # (frame, Gaussian) pairs an accumulation chunk holds

ArrayLike = Union[np.ndarray, torch.Tensor]


@options_dataclass
class MleDiagGmmOptions:
    min_gaussian_occupancy: float = 10.0
    min_gaussian_weight: float = 1e-5
    variance_floor: float = 1e-3
    remove_low_count_gaussians: bool = True


def _num_mix(am: AmDiagGmm) -> np.ndarray:
    return np.asarray([p.num_mix for p in am.pdfs], np.int64)


def _padded_params(am: AmDiagGmm):
    """gconsts [P, M] (−inf past a pdf's Gaussians), means·inv_vars and
    inv_vars [P, M, D], float64 on the model's device."""
    P, D, M = am.num_pdfs, am.dim, int(_num_mix(am).max())
    gc = np.full((P, M), -np.inf)
    miv = np.zeros((P, M, D))
    iv = np.zeros((P, M, D))
    for i, pdf in enumerate(am.pdfs):
        m = pdf.num_mix
        gc[i, :m] = pdf.gconsts
        miv[i, :m] = pdf.means_invvars
        iv[i, :m] = pdf.inv_vars
    return tuple(torch.from_numpy(a).to(am.device) for a in (gc, miv, iv))


class AccumAmDiagGmm:
    """Per-(pdf, Gaussian) occupancy, Σx and Σx², padded to the model's
    largest mixture: occ [P, M], mean_acc and var_acc [P, M, D], float64
    tensors on the model's device."""

    def __init__(self, am: AmDiagGmm):
        P, M, D = am.num_pdfs, int(_num_mix(am).max()), am.dim
        kw = dict(dtype=torch.float64, device=am.device)
        self.occ = torch.zeros((P, M), **kw)
        self.mean_acc = torch.zeros((P, M, D), **kw)
        self.var_acc = torch.zeros((P, M, D), **kw)
        self.tot_like = 0.0
        self.tot_frames = 0.0

    def accumulate_corpus(self, am: AmDiagGmm, feats: ArrayLike, pdf_ids: ArrayLike,
                          weights: Optional[ArrayLike] = None) -> float:
        """feats [N, D] (every aligned frame of the corpus), pdf_ids [N]: frame
        n belongs to pdf pdf_ids[n], split among its Gaussians by their
        posteriors (reference AccumulateFromDiagGmm); `weights` [N] scales
        a frame's share.  Returns the frames' total log-likelihood."""
        dev = am.device
        x_all = torch.as_tensor(feats).to(device=dev, dtype=torch.float64)
        pdf_all = torch.as_tensor(pdf_ids).to(device=dev, dtype=torch.int64)
        N = x_all.shape[0]
        w_all = (torch.ones(N, dtype=torch.float64, device=dev) if weights is None
                 else torch.as_tensor(weights).to(device=dev, dtype=torch.float64))
        gc, miv, iv = _padded_params(am)
        M = self.occ.shape[1]
        nmix = torch.from_numpy(_num_mix(am)).to(dev)
        # frames in order of their pdf's mixture count: each chunk is padded
        # to its own largest mixture
        frame_mix = nmix[pdf_all]
        order = torch.argsort(frame_mix, stable=True)
        mix_sorted = frame_mix[order].cpu().numpy()
        like = torch.zeros((), dtype=torch.float64, device=dev)
        a = 0
        while a < N:
            # at most CHUNK_PAIRS pairs, padded to the chunk's last (largest)
            # mixture: sized by the first frame's, then cut to the last's
            b = min(N, a + max(1, CHUNK_PAIRS // int(mix_sorted[a])))
            b = min(b, a + max(1, CHUNK_PAIRS // int(mix_sorted[b - 1])))
            mc = int(mix_sorted[b - 1])
            sel = order[a:b]
            x, p, w = x_all[sel], pdf_all[sel], w_all[sel]
            x2 = x * x
            comp = (gc[p, :mc] + torch.einsum("nd,nmd->nm", x, miv[p, :mc])
                    - 0.5 * torch.einsum("nd,nmd->nm", x2, iv[p, :mc]))
            cmax = comp.max(dim=1, keepdim=True).values
            e = torch.exp(comp - cmax)
            tot = e.sum(dim=1, keepdim=True)
            like += ((cmax[:, 0] + torch.log(tot[:, 0])) * w).sum()
            post = e / tot * w[:, None]  # [n, mc], 0 past the pdf's Gaussians
            idx = ((p[:, None] * M + torch.arange(mc, device=dev)[None, :]).reshape(-1),)
            self.occ.view(-1).index_put_(idx, post.reshape(-1), accumulate=True)
            D = x.shape[1]
            self.mean_acc.view(-1, D).index_put_(
                idx, (post[:, :, None] * x[:, None, :]).reshape(-1, D), accumulate=True)
            self.var_acc.view(-1, D).index_put_(
                idx, (post[:, :, None] * x2[:, None, :]).reshape(-1, D), accumulate=True)
            a = b
        like_f = float(like)
        self.tot_like += like_f
        self.tot_frames += float(w_all.sum())
        return like_f

    def pdf_occupancy(self) -> np.ndarray:
        """[P] float64 on the host: each pdf's occupancy (mixup's allocation
        key), summed over its Gaussians as the JAX package sums it."""
        return self.occ.cpu().numpy().sum(axis=1)


def mle_am_diag_gmm_update(am: AmDiagGmm, accs: AccumAmDiagGmm,
                           opts: Optional[MleDiagGmmOptions] = None) -> AmDiagGmm:
    """Every pdf's M-step (reference MleDiagGmmUpdate with flags "mvw"), in
    float64 on the accumulators' device; a new AmDiagGmm on the model's."""
    opts = opts or MleDiagGmmOptions()
    dev = accs.occ.device
    P, M = accs.occ.shape
    nmix = torch.from_numpy(_num_mix(am)).to(dev)
    valid = torch.arange(M, device=dev)[None, :] < nmix[:, None]
    occ = accs.occ
    tot = occ.sum(dim=1)
    if opts.remove_low_count_gaussians:
        keep = valid & (occ >= opts.min_gaussian_occupancy)
        occ_max = torch.where(valid, occ, -torch.inf).max(dim=1, keepdim=True).values
        keep = torch.where(keep.any(dim=1, keepdim=True), keep, valid & (occ == occ_max))
    else:
        keep = valid
    means = accs.mean_acc / occ[:, :, None]
    variances = torch.clamp_min(accs.var_acc / occ[:, :, None] - means ** 2,
                                opts.variance_floor)
    weights = torch.clamp_min(occ / tot[:, None], opts.min_gaussian_weight) * keep
    weights = weights / weights.sum(dim=1, keepdim=True)
    tot_h, keep_h = tot.cpu().numpy(), keep.cpu().numpy()
    w_h, m_h, v_h = (t.cpu().numpy() for t in (weights, means, variances))
    new_pdfs: List[DiagGmm] = []
    for i, pdf in enumerate(am.pdfs):
        if not tot_h[i] > 0:
            log.warning("no occupancy for a pdf; leaving it unchanged")
            new_pdfs.append(pdf)
            continue
        k = keep_h[i]
        new_pdfs.append(DiagGmm(w_h[i][k], m_h[i][k], v_h[i][k]))
    return AmDiagGmm(new_pdfs, am.device)


def mixup(am: AmDiagGmm, target_total: int, occs: Optional[np.ndarray] = None,
          perturb_factor: float = 0.01, seed: int = 0) -> AmDiagGmm:
    """Split Gaussians until the model has `target_total` of them (reference
    gmm-mixup / DiagGmm::Split): each new Gaussian goes to the pdf with the
    largest occupancy per Gaussian; within a pdf the heaviest Gaussian
    splits into two at mean ± perturb·σ·N(0, 1), drawn pdf by pdf from
    `default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    current = am.num_gauss
    if target_total <= current:
        return am
    occ_per_pdf = (occs if occs is not None
                   else np.asarray([p.num_mix for p in am.pdfs], float))
    alloc = np.asarray([p.num_mix for p in am.pdfs], int)
    while alloc.sum() < target_total:
        score = occ_per_pdf / alloc
        alloc[int(score.argmax())] += 1
    new_pdfs: List[DiagGmm] = []
    for pdf, n_target in zip(am.pdfs, alloc):
        if n_target == pdf.num_mix:
            new_pdfs.append(pdf)
            continue
        weights = list(pdf.weights)
        means = [m for m in pdf.means]
        variances = [v for v in pdf.vars]
        while len(weights) < n_target:
            i = int(np.argmax(weights))
            w = weights[i] / 2.0
            std = np.sqrt(variances[i])
            delta = perturb_factor * std * rng.normal(size=std.shape)
            weights[i] = w
            weights.append(w)
            means.append(means[i] + delta)
            means[i] = means[i] - delta
            variances.append(variances[i].copy())
        new_pdfs.append(DiagGmm(np.asarray(weights), np.asarray(means),
                                np.asarray(variances)))
    out = AmDiagGmm(new_pdfs, am.device)
    log.info("mixup: %d → %d gaussians", current, out.num_gauss)
    return out


def init_am_from_tree_stats(ctx_dep, stats, device=None) -> AmDiagGmm:
    """One single-Gaussian pdf per tree leaf from the leaf's pooled stats,
    the global stats for a leaf of 3 counts or fewer (reference
    gmm-init-model; stats = {event → GaussClusterable}, pooled in the
    dict's order)."""
    N = ctx_dep.N
    leaf_stats: List[object] = [None] * ctx_dep.num_pdfs
    for event, st in stats.items():
        d = dict(event)
        pdf = ctx_dep.compute([d[i] for i in range(N)], d[-1])
        if leaf_stats[pdf] is None:
            leaf_stats[pdf] = st.copy()
        else:
            leaf_stats[pdf].add(st)
    glob = None
    for st in leaf_stats:
        if st is not None:
            if glob is None:
                glob = st.copy()
            else:
                glob.add(st)
    if glob is None or glob.count <= 0:
        raise KaldiError("init_am_from_tree_stats: no stats")
    return AmDiagGmm(leaf_gmms(leaf_stats, glob), device)


def leaf_gmms(leaf_stats, glob) -> List[DiagGmm]:
    """A single Gaussian per leaf: its mean and variance (floored at 1e-3)
    where it has more than 3 counts, else the global ones."""
    gmean = glob.x / glob.count
    gvar = np.maximum(glob.x2 / glob.count - gmean ** 2, 1e-3)
    pdfs = []
    for st in leaf_stats:
        if st is not None and st.count > 3.0:
            mean = st.x / st.count
            var = np.maximum(st.x2 / st.count - mean ** 2, 1e-3)
        else:
            mean, var = gmean.copy(), gvar.copy()
        pdfs.append(DiagGmm(np.ones(1), mean[None, :], var[None, :]))
    return pdfs
