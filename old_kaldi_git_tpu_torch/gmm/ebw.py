"""Extended Baum-Welch (EBW) updates for discriminative GMM training.

Counterpart of old_kaldi_git_tpu/gmm/ebw.py (reference
src/gmm/ebw-diag-gmm.{h,cc} UpdateEbwDiagGmm, UpdateEbwWeightsDiagGmm,
IsmoothStatsDiagGmm: gmm-est-gaussians-ebw and gmm-est-weights-ebw).

Each Gaussian's mean and variance from the differenced num − den
statistics and a smoothing constant D:
    μ'  = (Δx + D μ) / (Δγ + D)
    σ²' = (Δx² + D (σ² + μ²)) / (Δγ + D) − μ'²
D starts at max(E·γ_den / 2, D_min) and doubles until every σ²' exceeds a
tenth of the variance floor (at most 20 times; a Gaussian that never gets
there is skipped).  The weights maximise
    Σ_m γ_num_m log w_m − Σ_m γ_den_m w_m / w_m^old
on the simplex: w_m = γ_num_m / (λ + γ_den_m / w_m^old), λ by bisection on
Σ w = 1.  I-smoothing adds τ pseudo-counts of the num statistics' own ML
estimate before the difference.

Host numpy in float64, Gaussian by Gaussian as in the JAX package, on the
accumulators' statistics copied from the device once; then the model's
packed kernel rows are dropped (`AmDiagGmm.invalidate`), so that the next
score on the card packs the updated parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm
from old_kaldi_git_tpu_torch.gmm.mle import AccumAmDiagGmm
from old_kaldi_git_tpu_torch.utils.log import get_logger

log = get_logger("ebw")


@dataclasses.dataclass
class EbwOptions:
    e: float = 2.0  # D = e · γ_den / 2 to start
    d_min: float = 1e-3
    tau: float = 0.0  # i-smoothing of the num statistics
    update_weights: bool = True
    variance_floor: float = 1e-3


@dataclasses.dataclass
class EbwStats:
    """occ [P, M], mean_acc and var_acc [P, M, D], float64 on the host."""

    occ: np.ndarray
    mean_acc: np.ndarray
    var_acc: np.ndarray

    @staticmethod
    def of(acc: AccumAmDiagGmm) -> "EbwStats":
        return EbwStats(*(np.asarray(t.detach().cpu().numpy(), np.float64)
                          for t in (acc.occ, acc.mean_acc, acc.var_acc)))


def ismooth_stats(acc: EbwStats, tau: float) -> EbwStats:
    """IsmoothStatsDiagGmm: add τ pseudo-counts of each Gaussian's own ML
    estimate to its statistics; Gaussians without occupancy stay as they
    are.  Takes an AccumAmDiagGmm or EbwStats."""
    if not isinstance(acc, EbwStats):
        acc = EbwStats.of(acc)
    if tau == 0.0:
        return acc
    occ = acc.occ
    safe = np.maximum(occ, 1e-10)
    mean_ml = acc.mean_acc / safe[..., None]
    var_ml = acc.var_acc / safe[..., None]
    mask = (occ > 1e-10)[..., None]
    return EbwStats(occ + tau * (occ > 1e-10),
                    acc.mean_acc + np.where(mask, tau * mean_ml, 0.0),
                    acc.var_acc + np.where(mask, tau * var_ml, 0.0))


def _ebw_weights(w_old: np.ndarray, num_occ: np.ndarray, den_occ: np.ndarray) -> np.ndarray:
    """Maximise Σ γn log w − Σ γd w / w_old on the simplex (one pdf).  λ
    may be negative when the den occupancy dominates: it is bracketed from
    just above its pole, −min(γd / w_old) over the Gaussians with γn > 0."""
    if num_occ.sum() <= 0:
        return w_old
    ratio = np.where(w_old > 0, den_occ / np.maximum(w_old, 1e-20), 0.0)
    active = num_occ > 0
    lam_min = -float(np.min(ratio[active])) if active.any() else 0.0

    def total(lam: float) -> float:
        return float(np.sum(num_occ[active] / np.maximum(lam + ratio[active], 1e-20)))

    # Σw → ∞ as λ → lam_min⁺ and falls monotonically in λ
    eps = max(1e-12, abs(lam_min) * 1e-12)
    lo = lam_min + eps
    hi = max(lam_min + 1.0, float(num_occ.sum()), 1.0)
    while total(hi) > 1.0:
        hi = lam_min + (hi - lam_min) * 2.0
        if hi - lam_min > 1e15:
            break
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if total(mid) > 1.0:
            lo = mid
        else:
            hi = mid
    w = np.where(active, num_occ / np.maximum(hi + ratio, 1e-20), 0.0)
    s = w.sum()
    if s <= 0:
        return w_old
    return w / s


def ebw_update(am: AmDiagGmm, num: AccumAmDiagGmm, den: AccumAmDiagGmm,
               opts: Optional[EbwOptions] = None) -> Tuple[int, int]:
    """In-place EBW update of the means, variances (and weights); returns
    (Gaussians updated, Gaussians skipped)."""
    opts = opts or EbwOptions()
    n = ismooth_stats(num, opts.tau)
    d_st = EbwStats.of(den)
    updated = skipped = 0
    for pdf, gmm in enumerate(am.pdfs):
        m = gmm.num_mix
        g_num = n.occ[pdf, :m]
        g_den = d_st.occ[pdf, :m]
        dx = n.mean_acc[pdf, :m] - d_st.mean_acc[pdf, :m]
        dx2 = n.var_acc[pdf, :m] - d_st.var_acc[pdf, :m]
        dg = g_num - g_den
        for j in range(m):
            if g_num[j] + g_den[j] < 1e-8:
                skipped += 1
                continue
            mu = gmm.means[j]
            var = gmm.vars[j]
            d = max(opts.e * g_den[j] / 2.0, opts.d_min)
            ok = False
            for _ in range(20):  # grow D until the variance is positive
                denom = dg[j] + d
                if denom > 1e-8:
                    mu_new = (dx[j] + d * mu) / denom
                    var_new = (dx2[j] + d * (var + mu * mu)) / denom - mu_new * mu_new
                    if np.all(var_new > opts.variance_floor * 0.1):
                        ok = True
                        break
                d *= 2.0
            if not ok:
                skipped += 1
                continue
            gmm.means[j] = mu_new
            gmm.vars[j] = np.maximum(var_new, opts.variance_floor)
            updated += 1
        if opts.update_weights:
            gmm.weights[:m] = _ebw_weights(gmm.weights[:m].copy(), g_num, g_den)
    am.invalidate()
    log.info("ebw_update: %d updated, %d skipped", updated, skipped)
    return updated, skipped
