"""fMLLR for SGMM2 models.

Counterpart of old_kaldi_git_tpu/gmm/sgmm2_fmllr.py (reference
src/sgmm2/fmllr-sgmm2.{h,cc}, sgmm2bin/sgmm2-est-fmllr.cc).  The pool's
covariances are full, so the auxiliary

  Q(W) = β log|det A| + tr(Wᵀ L) − ½ Σ_i tr(Σ_i⁻¹ W G_i Wᵀ),   W = [A b],

is maximised by gradient ascent preconditioned by the occupancy-averaged
covariance (left) and feature scatter (right), an exact Newton line search
on the step, and a guarded apply that halves the step until Q does not
fall.  Statistics: β, L = Σ_i Σ_i⁻¹ C_i with C_i = Σ_t m̄_ti x⁺_tᵀ (m̄ the
posterior-weighted adapted means), G_i = Σ_t γ_ti x⁺ x⁺ᵀ.

The port collects a speaker's statistics in one pass over all its frames on
the model's device (`FmllrSgmm2Accs`), and estimates every speaker's
transform together (`estimate_sgmm2_fmllr_batch`): the [P, D, D+1]
transforms of P speakers take each ascent step at once, each speaker's
line search and halving decided by its own masks, in the JAX package's
order of tests.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from old_kaldi_git_tpu_torch.gmm.sgmm2 import F64, AmSgmm2, _t
from old_kaldi_git_tpu_torch.utils.log import get_logger

log = get_logger("sgmm2_fmllr")


class FmllrSgmm2Accs:
    """One speaker's statistics, float64 on the model's device: beta, L
    [D, D+1], G [I, D+1, D+1] and the occupancy-weighted covariance sum
    sigma_bar [D, D]."""

    def __init__(self, model: AmSgmm2):
        I, D, _ = model.M.shape
        dev = model.device
        self.device = dev
        self.beta = 0.0
        self.L = torch.zeros((D, D + 1), dtype=F64, device=dev)
        self.G = torch.zeros((I, D + 1, D + 1), dtype=F64, device=dev)
        self.sigma_bar = torch.zeros((D, D), dtype=F64, device=dev)
        self._sigma = torch.linalg.inv(model.sigma_inv)

    def accumulate(self, model: AmSgmm2, feats, pdf_ids, weights=None, spk_vec=None) -> None:
        """Posterior-weighted statistics of aligned frames in the current
        feature space, all frames in one pass."""
        dev = self.device
        x = _t(feats, dev)
        pdf = torch.as_tensor(np.asarray(pdf_ids, np.int64)).to(dev)
        w = torch.ones(x.shape[0], dtype=F64, device=dev) if weights is None else _t(weights, dev)
        off = model.spk_offsets(spk_vec)
        bias = model.spk_weight_bias(spk_vec)
        I, D, _ = model.M.shape
        xp = torch.cat([x, torch.ones((x.shape[0], 1), dtype=F64, device=dev)], 1)
        g_i = torch.zeros(I, dtype=F64, device=dev)
        for rows, idx, _, post, _, _ in model.own_pdf_posteriors(x, pdf, w, off, bias):
            xps = xp[rows]
            t = xps.shape[0]
            gi = post.sum(1)  # [t, I]
            vbar = torch.bmm(post.transpose(1, 2), model.V[idx])  # [t, I, S]
            mbar = torch.einsum("ids,tis->tid", model.M, vbar)
            if off is not None:
                mbar = mbar + gi[:, :, None] * off[None]
            C = (mbar.reshape(t, I * D).T @ xps).reshape(I, D, D + 1)
            self.L += model.sigma_inv.reshape(I * D, D).T @ C.reshape(I * D, D + 1)
            self.G += (gi.T @ (xps[:, :, None] * xps[:, None, :]).reshape(t, -1)
                       ).reshape(I, D + 1, D + 1)
            g_i += gi.sum(0)
        self.beta += float(g_i.sum())
        self.sigma_bar += torch.einsum("i,ide->de", g_i, self._sigma)

    def add(self, other: "FmllrSgmm2Accs") -> None:
        self.beta += other.beta
        self.L += other.L.to(self.device)
        self.G += other.G.to(self.device)
        self.sigma_bar += other.sigma_bar.to(self.device)


@dataclasses.dataclass
class FmllrSgmm2Options:
    num_iters: int = 10
    min_count: float = 100.0
    newton_steps: int = 5


def _aux(W, beta, L, G, sigma_inv) -> torch.Tensor:
    """Q of each speaker's W [P, D, D+1] ([P]; −inf where det A ≤ 0)."""
    sign, logdet = torch.linalg.slogdet(W[:, :, :-1])
    quad = torch.einsum("ide,pdf,pifg,peg->p", sigma_inv, W, G, W)
    q = beta * logdet + (W * L).sum((1, 2)) - 0.5 * quad
    return torch.where(sign > 0, q, torch.full_like(q, -torch.inf))


def estimate_sgmm2_fmllr_batch(model: AmSgmm2, accs: Sequence[FmllrSgmm2Accs],
                               opts: FmllrSgmm2Options = FmllrSgmm2Options()
                               ) -> List[Optional[torch.Tensor]]:
    """Every speaker's W [D, D+1] (None below `min_count`: the caller uses
    the identity), the speakers' ascent steps taken together."""
    I, D, _ = model.M.shape
    dev = model.device
    out: List[Optional[torch.Tensor]] = [None] * len(accs)
    live = [p for p, a in enumerate(accs) if a.beta >= opts.min_count]
    if not live:
        return out
    P = len(live)
    beta = torch.tensor([accs[p].beta for p in live], dtype=F64, device=dev)
    L = torch.stack([accs[p].L for p in live])
    G = torch.stack([accs[p].G for p in live])  # [P, I, D+1, D+1]
    sigma_inv = model.sigma_inv
    eye1 = torch.eye(D + 1, dtype=F64, device=dev)
    P_left = torch.stack([accs[p].sigma_bar for p in live]) / beta[:, None, None]
    G_bar = G.sum(1) / beta[:, None, None]
    tr = torch.diagonal(G_bar, dim1=1, dim2=2).sum(1)
    P_right = torch.linalg.inv(G_bar + (1e-6 * tr / (D + 1))[:, None, None] * eye1)
    W = torch.cat([torch.eye(D, dtype=F64, device=dev), torch.zeros((D, 1), dtype=F64,
                                                                      device=dev)], 1)
    W = W[None].repeat(P, 1, 1)
    f = _aux(W, beta, L, G, sigma_inv)
    going = torch.ones(P, dtype=torch.bool, device=dev)
    zero_col = torch.zeros((P, D, 1), dtype=F64, device=dev)
    for _ in range(opts.num_iters):
        A = W[:, :, :-1]
        grad = (beta[:, None, None] * torch.cat([torch.linalg.inv(A).transpose(1, 2), zero_col],
                                                2)
                + L - torch.einsum("ide,pef,pifg->pdg", sigma_inv, W, G))
        Dir = P_left @ grad @ P_right
        b1 = ((Dir * L).sum((1, 2))
              - torch.einsum("ide,pef,pifg,pdg->p", sigma_inv, W, G, Dir))
        b2 = torch.einsum("ide,pef,pifg,pdg->p", sigma_inv, Dir, G, Dir)
        D_A = Dir[:, :, :-1]
        t = torch.zeros(P, dtype=F64, device=dev)
        searching = going.clone()
        for _ in range(opts.newton_steps):
            Mt = A + t[:, None, None] * D_A
            sign, _ = torch.linalg.slogdet(Mt)
            bad = searching & (sign <= 0)
            good = searching & (sign > 0)
            Minv_DA = torch.linalg.solve(torch.where(good[:, None, None], Mt, A), D_A)
            f1 = beta * torch.diagonal(Minv_DA, dim1=1, dim2=2).sum(1) + b1 - t * b2
            f2 = -beta * (Minv_DA * Minv_DA.transpose(1, 2)).sum((1, 2)) - b2
            stop = good & (f2 >= -1e-12)
            newton = good & ~stop
            t = torch.where(bad, 0.5 * t, torch.where(newton, t - f1 / torch.where(
                newton, f2, torch.ones_like(f2)), t))
            searching = searching & ~stop
        step = t
        pending = going.clone()
        for _ in range(20):
            cand = W + step[:, None, None] * Dir
            fc = _aux(cand, beta, L, G, sigma_inv)
            take = pending & (fc >= f - 1e-9)
            W = torch.where(take[:, None, None], cand, W)
            f = torch.where(take, fc, f)
            pending = pending & ~take
            step = torch.where(pending, 0.5 * step, step)
            if not bool(pending.any()):
                break
        going = going & ~pending  # no improving step: that speaker has converged
        if not bool(going.any()):
            break
    for k, p in enumerate(live):
        out[p] = W[k]
    log.info("sgmm2 fMLLR: %d speakers, auxiliary/frame %s", P,
             (f / beta).cpu().numpy().round(4).tolist())
    return out


def estimate_sgmm2_fmllr(model: AmSgmm2, accs: FmllrSgmm2Accs,
                         opts: FmllrSgmm2Options = FmllrSgmm2Options()
                         ) -> Optional[torch.Tensor]:
    """One speaker's W [D, D+1] (None below `min_count`)."""
    return estimate_sgmm2_fmllr_batch(model, [accs], opts)[0]


def sgmm2_fmllr_objf_improvement(model: AmSgmm2, accs: FmllrSgmm2Accs, W) -> float:
    """Per-frame auxiliary improvement of W over the identity."""
    D = model.dim
    dev = model.device
    W0 = torch.cat([torch.eye(D, dtype=F64, device=dev), torch.zeros((D, 1), dtype=F64,
                                                                       device=dev)], 1)
    Ws = torch.stack([_t(W, dev), W0])
    beta = torch.tensor([accs.beta, accs.beta], dtype=F64, device=dev)
    q = _aux(Ws, beta, torch.stack([accs.L, accs.L]), torch.stack([accs.G, accs.G]),
             model.sigma_inv)
    return float(q[0] - q[1]) / max(accs.beta, 1.0)
