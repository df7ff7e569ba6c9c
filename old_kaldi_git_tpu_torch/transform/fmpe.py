"""fMPE: discriminatively trained feature-space offsets.

Counterpart of old_kaldi_git_tpu/transform/fmpe.py (reference
src/transform/fmpe.{h,cc}; fmpe-init, gmm-get-stats-deriv,
gmm-fmpe-acc-stats, fmpe-sum-accs, fmpe-est, fmpe-apply-transform).

An offset GMM turns each frame into a sparse high-dimensional vector: for
each of its `num_gselect` most likely Gaussians g, post_scale·p_g·[1,
(x − μ_g)/σ_g]; a projection [G·(D+1), C·D] maps it to C intermediate
offsets, and a fixed layer of context averages (frames −4..+4 by default)
adds them into one offset: x' = x + offset(x).  Training pushes the signed
MPE / MMI gradient dF/dx' back through the context layer and the
projection, positive and negative parts apart, and steps each element by
lr·(pos − neg)/(pos + neg).

Both differentials of the JAX package are here: the direct one
(`model_deriv_direct`, the model held fixed) and the indirect one through
the model's ML re-estimation (`ModelDerivStats`, `model_deriv_indirect`,
the gmm-get-stats-deriv statistics).

Everything per frame runs in float64 on the device of the Fmpe object or
of the acoustic model: the offset GMM's posteriors and their gselect, the
expansion, the projection (a `torch.matmul`: the JAX package computes it
in numpy outside any Pallas kernel), the context layer, its adjoint and the
gradient statistics; the acoustic model's Gaussian posteriors of every
posterior entry of an utterance at once (transform/mllt.py
`gaussian_posteriors`), their statistics added by
`index_put_(accumulate=True)`, which adds in a fixed order on the card.
The files are the JAX package's layout.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, DiagGmm
from old_kaldi_git_tpu_torch.transform.mllt import gaussian_posteriors, padded_gaussians
from old_kaldi_git_tpu_torch.utils.io_funcs import (
    expect_token,
    init_kaldi_input_stream,
    init_kaldi_output_stream,
    read_float,
    read_int32,
    read_matrix,
    write_double,
    write_int32,
    write_matrix,
    write_token,
)
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("fmpe")

ArrayLike = Union[np.ndarray, torch.Tensor]

# the centre frame, ±1, and the averages of ±{2, 3, 4}
DEFAULT_CONTEXTS: Tuple[Tuple[Tuple[int, float], ...], ...] = (
    ((0, 1.0),),
    ((-1, 1.0),),
    ((1, 1.0),),
    ((-2, 1 / 3), (-3, 1 / 3), (-4, 1 / 3)),
    ((2, 1 / 3), (3, 1 / 3), (4, 1 / 3)),
)


def parse_contexts(spec: str):
    """'0/-1/1/-2,-3,-4/2,3,4' → context groups with weights 1/len."""
    groups = []
    for part in spec.split("/"):
        offs = [int(x) for x in part.split(",") if x.strip() != ""]
        if not offs:
            raise KaldiError(f"empty context group in {spec!r}")
        groups.append(tuple((o, 1.0 / len(offs)) for o in offs))
    return tuple(groups)


def _dev64(a: ArrayLike, dev: torch.device) -> torch.Tensor:
    a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return a.to(device=dev, dtype=torch.float64)


class Fmpe:
    """Offset GMM + projection `proj` [G·(D+1), C·D], float64 on `device`
    (None: the GPU)."""

    def __init__(self, gmm: DiagGmm, proj: ArrayLike, contexts=DEFAULT_CONTEXTS,
                 post_scale: float = 5.0, num_gselect: int = 25, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.gmm = gmm
        self.proj = _dev64(proj, self.device)
        self.contexts = tuple(tuple(c) for c in contexts)
        self.post_scale = float(post_scale)
        self.num_gselect = int(num_gselect)
        G, D = gmm.num_mix, gmm.dim
        if tuple(self.proj.shape) != (G * (D + 1), len(self.contexts) * D):
            raise KaldiError(f"proj shape {tuple(self.proj.shape)} != "
                             f"{(G * (D + 1), len(self.contexts) * D)}")

    @staticmethod
    def init(gmm: DiagGmm, contexts=DEFAULT_CONTEXTS, post_scale: float = 5.0,
             num_gselect: int = 25, device: DeviceLike = None) -> "Fmpe":
        """A zero projection (fmpe-init)."""
        G, D = gmm.num_mix, gmm.dim
        return Fmpe(gmm, np.zeros((G * (D + 1), len(contexts) * D)), contexts, post_scale,
                    num_gselect, device)

    @property
    def dim(self) -> int:
        return self.gmm.dim

    def expand(self, feats: ArrayLike) -> torch.Tensor:
        """[T, D] → [T, G·(D+1)]: for each of the num_gselect most likely
        Gaussians (ties at the last kept value kept too) the block
        post_scale·p_g·[1, (x − μ_g)/σ_g], zero elsewhere."""
        x = _dev64(feats, self.device)
        T, D = x.shape
        G = self.gmm.num_mix
        post = self.gmm.posteriors(x)
        if self.num_gselect < G:
            kth = torch.topk(post, self.num_gselect, dim=1).values[:, -1:]
            post = torch.where(post >= kth, post, torch.zeros_like(post))
            post = post / post.sum(dim=1, keepdim=True).clamp(min=1e-20)
        post = post * self.post_scale
        t = self.gmm.tensors(self.device)
        z = (x[:, None, :] - t["means"][None]) / torch.sqrt(t["vars"])[None]
        h = torch.cat([post[:, :, None], post[:, :, None] * z], dim=2)
        return h.reshape(T, G * (D + 1))

    def _apply_context(self, inter: torch.Tensor) -> torch.Tensor:
        """[T, C·D] intermediate offsets → [T, D] through the context layer."""
        T, D = inter.shape[0], self.dim
        out = torch.zeros((T, D), dtype=torch.float64, device=inter.device)
        for c, group in enumerate(self.contexts):
            block = inter[:, c * D:(c + 1) * D]
            for off, wt in group:
                lo, hi = max(0, -off), min(T, T - off)
                if hi > lo:
                    out[lo:hi] += wt * block[lo + off:hi + off]
        return out

    def _apply_context_reverse(self, grad_out: torch.Tensor) -> torch.Tensor:
        """The adjoint of the context layer: [T, D] → [T, C·D]."""
        T, D = grad_out.shape[0], self.dim
        g = torch.zeros((T, len(self.contexts) * D), dtype=torch.float64,
                        device=grad_out.device)
        for c, group in enumerate(self.contexts):
            for off, wt in group:
                lo, hi = max(0, -off), min(T, T - off)
                if hi > lo:
                    g[lo + off:hi + off, c * D:(c + 1) * D] += wt * grad_out[lo:hi]
        return g

    def offsets(self, feats: ArrayLike, h: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[T, D] float64 feature offsets."""
        if h is None:
            h = self.expand(feats)
        return self._apply_context(h @ self.proj)

    def transformed(self, feats: ArrayLike) -> torch.Tensor:
        """x' = x + offset(x), float64 on the object's device."""
        return _dev64(feats, self.device) + self.offsets(feats)

    def apply(self, feats: ArrayLike) -> torch.Tensor:
        """x' = x + offset(x), float32 on the object's device."""
        return self.transformed(feats).float()

    def acc_from_deriv(self, feats: ArrayLike, deriv: ArrayLike) -> "FmpeAccs":
        """The projection's gradient statistics for dF/dx' [T, D]."""
        grad = self.expand(feats).T @ self._apply_context_reverse(_dev64(deriv, self.device))
        return FmpeAccs(grad.clamp(min=0.0), (-grad).clamp(min=0.0))

    def update(self, accs: "FmpeAccs", learning_rate: float = 0.1) -> float:
        """proj += lr·(pos − neg)/(pos + neg) where pos + neg > 0; returns
        the mean |step| (reference FmpeStats::Update's scale-free rule)."""
        pos, neg = accs.pos.to(self.device), accs.neg.to(self.device)
        denom = pos + neg
        step = torch.where(denom > 0, learning_rate * (pos - neg) / denom.clamp(min=1e-20),
                           torch.zeros_like(denom))
        self.proj += step
        changed = float(step.abs().mean())
        log.info("fmpe update: mean |step| %.3e over %d params", changed, step.numel())
        return changed

    def write(self, f) -> None:
        init_kaldi_output_stream(f, True)
        write_token(f, "<Fmpe>")
        self.gmm.write(f)
        write_matrix(f, self.proj.cpu().numpy().astype(np.float32))
        write_double(f, self.post_scale)
        write_int32(f, self.num_gselect)
        write_int32(f, len(self.contexts))
        for group in self.contexts:
            write_int32(f, len(group))
            for off, wt in group:
                write_int32(f, off)
                write_double(f, wt)
        write_token(f, "</Fmpe>")

    @staticmethod
    def read(f, device: DeviceLike = None) -> "Fmpe":
        init_kaldi_input_stream(f)
        expect_token(f, "<Fmpe>")
        gmm = DiagGmm.read(f)
        proj = read_matrix(f)
        post_scale = read_float(f)
        num_gselect = read_int32(f)
        contexts = []
        for _ in range(read_int32(f)):
            ng = read_int32(f)
            contexts.append(tuple((read_int32(f), read_float(f)) for _ in range(ng)))
        expect_token(f, "</Fmpe>")
        return Fmpe(gmm, proj, tuple(contexts), post_scale, num_gselect, device)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            self.write(f)

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "Fmpe":
        with open(path, "rb") as f:
            return Fmpe.read(f, device)


class FmpeAccs:
    """The projection gradient's positive and negative parts, float64
    tensors of the projection's shape."""

    def __init__(self, pos: torch.Tensor, neg: torch.Tensor):
        self.pos, self.neg = pos, neg

    @staticmethod
    def zeros_like(fmpe: Fmpe) -> "FmpeAccs":
        return FmpeAccs(torch.zeros_like(fmpe.proj), torch.zeros_like(fmpe.proj))

    def add(self, other: "FmpeAccs") -> None:
        self.pos += other.pos.to(self.pos.device)
        self.neg += other.neg.to(self.neg.device)

    def save(self, path: str) -> None:
        """<FmpeAccs>, pos and neg as float64 matrices, </FmpeAccs>."""
        with open(path, "wb") as f:
            init_kaldi_output_stream(f, True)
            write_token(f, "<FmpeAccs>")
            write_matrix(f, self.pos.cpu().numpy(), np.float64)
            write_matrix(f, self.neg.cpu().numpy(), np.float64)
            write_token(f, "</FmpeAccs>")

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "FmpeAccs":
        dev = resolve_device(device)
        with open(path, "rb") as f:
            init_kaldi_input_stream(f)
            expect_token(f, "<FmpeAccs>")
            pos, neg = read_matrix(f), read_matrix(f)
            expect_token(f, "</FmpeAccs>")
        return FmpeAccs(_dev64(pos, dev), _dev64(neg, dev))


def _padded_vars(am: AmDiagGmm) -> torch.Tensor:
    """The variances [P, M, D] float64 on the model's device, 1 past a pdf's
    mixture (the means are transform/mllt.py `padded_gaussians`'); made once
    a model."""
    def make():
        P, D = am.num_pdfs, am.dim
        var = np.ones((P, max(p.num_mix for p in am.pdfs), D))
        for i, pdf in enumerate(am.pdfs):
            var[i, :pdf.num_mix] = pdf.vars
        return torch.from_numpy(var).to(am.device)

    return am.derived("padded_vars", make)


def _post_entries(signed_post, num_frames: int, tid2pdf: np.ndarray):
    """(frame, pdf, weight) of every posterior entry on frames < num_frames."""
    rows, pdfs, ws = [], [], []
    for t, frame in enumerate(signed_post):
        if t >= num_frames:
            break
        for tid, w in frame:
            rows.append(t)
            pdfs.append(int(tid2pdf[int(tid)]))
            ws.append(float(w))
    return (np.asarray(rows, np.int64), np.asarray(pdfs, np.int64),
            np.asarray(ws, np.float64))


class ModelDerivStats:
    """Per Gaussian, the signed discriminative statistics (Σwγ, Σwγx,
    Σwγx²) and the ML occupancy Σγ of the alignment, padded [P, M] / [P, M,
    D] float64 on the model's device (reference gmm-get-stats-deriv)."""

    def __init__(self, am: AmDiagGmm):
        P, D = am.num_pdfs, am.dim
        M = max(p.num_mix for p in am.pdfs)
        kw = dict(dtype=torch.float64, device=am.device)
        self.nmix = np.asarray([p.num_mix for p in am.pdfs], np.int64)
        self.occ_s = torch.zeros((P, M), **kw)
        self.s1_s = torch.zeros((P, M, D), **kw)
        self.s2_s = torch.zeros((P, M, D), **kw)
        self.ml_occ = torch.zeros((P, M), **kw)

    def accumulate(self, am: AmDiagGmm, tm, feats: ArrayLike, signed_post,
                   ali: ArrayLike) -> None:
        """One utterance: its signed tid posteriors, and its ML alignment
        (weight 1 a frame), frames past the features ignored."""
        x = _dev64(feats, am.device)
        T, D = x.shape
        M = self.occ_s.shape[1]
        tid2pdf = tm.tid_to_pdf_array()
        rows, pdfs, ws = _post_entries(signed_post, T, tid2pdf)
        cols = torch.arange(M, device=am.device)
        if len(rows):
            r = torch.from_numpy(rows).to(am.device)
            p = torch.from_numpy(pdfs).to(am.device)
            gamma = torch.from_numpy(ws).to(am.device)[:, None] * gaussian_posteriors(am, x[r], p)
            idx = ((p[:, None] * M + cols[None, :]).reshape(-1),)
            xr = x[r]
            self.occ_s.view(-1).index_put_(idx, gamma.reshape(-1), accumulate=True)
            self.s1_s.view(-1, D).index_put_(
                idx, (gamma[:, :, None] * xr[:, None, :]).reshape(-1, D), accumulate=True)
            self.s2_s.view(-1, D).index_put_(
                idx, (gamma[:, :, None] * (xr * xr)[:, None, :]).reshape(-1, D),
                accumulate=True)
        ali = np.asarray(ali, np.int64)[:T]
        if len(ali):
            p = torch.from_numpy(tid2pdf[ali].astype(np.int64)).to(am.device)
            post = gaussian_posteriors(am, x[:len(ali)], p)
            self.ml_occ.view(-1).index_put_(((p[:, None] * M + cols[None, :]).reshape(-1),),
                                            post.reshape(-1), accumulate=True)

    def add(self, other: "ModelDerivStats") -> None:
        for name in ("occ_s", "s1_s", "s2_s", "ml_occ"):
            getattr(self, name).add_(getattr(other, name).to(self.occ_s.device))

    def param_derivs(self, am: AmDiagGmm) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dF/dμ, dF/dσ²) [P, M, D] from the signed statistics:
        dF/dμ = (s1 − occ·μ)/σ², dF/dσ² = (s2 − 2μ s1 + occ μ²)/(2σ⁴) −
        occ/(2σ²)."""
        mu, var = padded_gaussians(am)[3], _padded_vars(am)
        occ = self.occ_s[:, :, None]
        dmu = (self.s1_s - occ * mu) / var
        dvar = ((self.s2_s - 2 * mu * self.s1_s + occ * mu ** 2) / (2 * var ** 2)
                - occ / (2 * var))
        return dmu, dvar

    def save(self, path: str) -> None:
        """<ModelDerivStats> P, then per pdf occ [1, M_p], s1, s2 [M_p, D] and
        the ML occupancy [1, M_p] as float64 matrices."""
        occ, s1, s2, ml = (t.cpu().numpy() for t in (self.occ_s, self.s1_s, self.s2_s,
                                                      self.ml_occ))
        with open(path, "wb") as f:
            init_kaldi_output_stream(f, True)
            write_token(f, "<ModelDerivStats>")
            write_int32(f, len(self.nmix))
            for j, m in enumerate(self.nmix):
                write_matrix(f, occ[j, None, :m], np.float64)
                write_matrix(f, s1[j, :m], np.float64)
                write_matrix(f, s2[j, :m], np.float64)
                write_matrix(f, ml[j, None, :m], np.float64)
            write_token(f, "</ModelDerivStats>")

    @staticmethod
    def load(path: str, am: AmDiagGmm) -> "ModelDerivStats":
        out = ModelDerivStats(am)
        occ, s1, s2, ml = (np.zeros(tuple(t.shape)) for t in (out.occ_s, out.s1_s, out.s2_s,
                                                                out.ml_occ))
        with open(path, "rb") as f:
            init_kaldi_input_stream(f)
            expect_token(f, "<ModelDerivStats>")
            if read_int32(f) != len(out.nmix):
                raise KaldiError("stats/model pdf count mismatch")
            for j, m in enumerate(out.nmix):
                occ[j, :m] = read_matrix(f)[0]
                s1[j, :m] = read_matrix(f)
                s2[j, :m] = read_matrix(f)
                ml[j, :m] = read_matrix(f)[0]
            expect_token(f, "</ModelDerivStats>")
        for name, a in (("occ_s", occ), ("s1_s", s1), ("s2_s", s2), ("ml_occ", ml)):
            setattr(out, name, torch.from_numpy(a).to(am.device))
        return out


def model_deriv_indirect(am: AmDiagGmm, tm, feats: ArrayLike, ali: ArrayLike,
                         stats: ModelDerivStats, min_count: float = 1e-3) -> torch.Tensor:
    """The indirect differential [T, D] float64: through the ML mean and
    variance maps of the alignment's frozen responsibilities,
    dF/dx_t = Σ_m γ_m(t)/Γ_m · [dF/dμ_m + 2(x_t − μ_m) dF/dσ²_m]; Gaussians
    of ML occupancy under min_count give nothing."""
    x = _dev64(feats, am.device)
    deriv = torch.zeros_like(x)
    ali = np.asarray(ali, np.int64)[:x.shape[0]]
    if not len(ali):
        return deriv
    dmu, dvar = stats.param_derivs(am)
    mu = padded_gaussians(am)[3]
    p = torch.from_numpy(tm.tid_to_pdf_array().astype(np.int64)[ali]).to(am.device)
    n = len(ali)
    gamma = gaussian_posteriors(am, x[:n], p)
    ml = stats.ml_occ[p]
    occ = ml.clamp(min=min_count)
    ok = (ml >= min_count).to(gamma.dtype)
    contrib = (dmu[p] + 2.0 * (x[:n, None, :] - mu[p]) * dvar[p]) / occ[:, :, None]
    deriv[:n] = ((gamma * ok)[:, :, None] * contrib).sum(dim=1)
    return deriv


def model_deriv_direct(am: AmDiagGmm, tm, feats: ArrayLike, signed_post) -> torch.Tensor:
    """The direct differential dF/dx [T, D] float64: for each (tid, w) of
    frame t, w·Σ_m γ_m(x_t)(μ_m − x_t)/σ²_m over the tid's pdf."""
    x = _dev64(feats, am.device)
    deriv = torch.zeros_like(x)
    rows, pdfs, ws = _post_entries(signed_post, x.shape[0], tm.tid_to_pdf_array().astype(np.int64))
    if not len(rows):
        return deriv
    r = torch.from_numpy(rows).to(am.device)
    p = torch.from_numpy(pdfs).to(am.device)
    mu, var = padded_gaussians(am)[3], _padded_vars(am)
    gamma = gaussian_posteriors(am, x[r], p)
    term = (gamma[:, :, None] * (mu[p] - x[r][:, None, :]) / var[p]).sum(dim=1)
    deriv.index_put_((r,), torch.from_numpy(ws).to(am.device)[:, None] * term,
                     accumulate=True)
    return deriv
