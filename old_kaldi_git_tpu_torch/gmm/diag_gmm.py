"""Diagonal-covariance GMMs.

Counterpart of old_kaldi_git_tpu/gmm/diag_gmm.py (reference
src/gmm/{diag-gmm.h,am-diag-gmm.h}): DiagGmm holds float64 weights, means and
variances, and gconsts computed from them as the reference does; AmDiagGmm
stacks every pdf's Gaussians into rows of [x, x², 1] coefficients so that all
frames × all pdfs is one call of the GMM kernel (ops/gmm_kernel.py).  The
arithmetic of `read` and of `gconsts` is float64, then the rows are cast to
float32 once, as the JAX package's `stacked()` does: the packed rows are the
JAX package's to the bit.  A single DiagGmm also scores frames itself
(`component_loglikes`, `loglikes`, `posteriors`) in float64 on the frames'
device: the iVector extractor's UBM needs its per-component posteriors at
that precision.  Training (gmm/mle.py) makes a new AmDiagGmm on the same
device after every update, whose rows are packed anew on first use; the
flat start is `AmDiagGmm.init_mono`, and the writers emit the JAX package's
bytes (float32 gconsts, weights, means·inv_vars, inv_vars).  Whoever changes
a pdf's parameters in place calls `AmDiagGmm.invalidate()`, which drops the
packed rows and the device tensors.
"""

from __future__ import annotations

import math
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
from old_kaldi_git_tpu_torch.ops.gmm_kernel import NEG, GmmWeights, gmm_loglikes, pack_gmm_weights
from old_kaldi_git_tpu_torch.utils import io_funcs as iof
from old_kaldi_git_tpu_torch.utils.log import KaldiError

M_LOG_2PI = math.log(2.0 * math.pi)


class DiagGmm:
    """One mixture of diagonal Gaussians (a single pdf)."""

    def __init__(self, weights: np.ndarray, means: np.ndarray, variances: np.ndarray):
        self.weights = np.asarray(weights, np.float64)  # [M]
        self.means = np.asarray(means, np.float64)  # [M, D]
        self.vars = np.asarray(variances, np.float64)  # [M, D]
        if not (self.weights.ndim == 1 and self.means.ndim == 2
                and self.means.shape == self.vars.shape
                and self.means.shape[0] == self.weights.shape[0]):
            raise KaldiError("DiagGmm: bad shapes")

    @property
    def num_mix(self) -> int:
        return self.weights.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    @property
    def inv_vars(self) -> np.ndarray:
        return 1.0 / self.vars

    @property
    def means_invvars(self) -> np.ndarray:
        return self.means / self.vars

    @property
    def gconsts(self) -> np.ndarray:
        """log(weight) − ½(D log 2π + Σ log var + Σ μ²/σ²)."""
        return (np.log(np.maximum(self.weights, 1e-30))
                - 0.5 * (self.dim * M_LOG_2PI + np.log(self.vars).sum(axis=1)
                         + (self.means ** 2 / self.vars).sum(axis=1)))

    def tensors(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """gconsts [M], means_invvars, inv_vars, means and vars [M, D] as
        float64 tensors on `device`, uploaded once per device and kept."""
        cache = self.__dict__.setdefault("_dev", {})
        key = str(device)
        if key not in cache:
            cache[key] = {name: torch.from_numpy(np.ascontiguousarray(getattr(self, name)))
                          .to(device)
                          for name in ("gconsts", "means_invvars", "inv_vars", "means",
                                       "vars")}
        return cache[key]

    def component_loglikes(self, x: torch.Tensor) -> torch.Tensor:
        """[T, D] frames (a tensor) → [T, M] per-component loglikes, float64
        on the frames' device."""
        t = self.tensors(x.device)
        x = x.to(torch.float64)
        return (t["gconsts"][None, :] + x @ t["means_invvars"].T
                - 0.5 * (x ** 2) @ t["inv_vars"].T)

    def loglikes(self, x: torch.Tensor) -> torch.Tensor:
        """[T, D] → [T] total loglikes (logsumexp over components)."""
        comp = self.component_loglikes(x)
        m = comp.max(dim=1, keepdim=True).values
        return (m + torch.log(torch.exp(comp - m).sum(dim=1, keepdim=True)))[:, 0]

    def posteriors(self, x: torch.Tensor) -> torch.Tensor:
        """[T, D] → [T, M] per-component posteriors, float64."""
        comp = self.component_loglikes(x)
        p = torch.exp(comp - comp.max(dim=1, keepdim=True).values)
        return p / p.sum(dim=1, keepdim=True)

    def write(self, f: BinaryIO) -> None:
        """<DiagGMM> <GCONSTS> FV <WEIGHTS> FV <MEANS_INVVARS> FM
        <INV_VARS> FM </DiagGMM>, each cast to float32."""
        iof.write_token(f, "<DiagGMM>")
        iof.write_token(f, "<GCONSTS>")
        iof.write_vector(f, self.gconsts.astype(np.float32))
        iof.write_token(f, "<WEIGHTS>")
        iof.write_vector(f, self.weights.astype(np.float32))
        iof.write_token(f, "<MEANS_INVVARS>")
        iof.write_matrix(f, self.means_invvars.astype(np.float32))
        iof.write_token(f, "<INV_VARS>")
        iof.write_matrix(f, self.inv_vars.astype(np.float32))
        iof.write_token(f, "</DiagGMM>")

    @staticmethod
    def read(f: BinaryIO) -> "DiagGmm":
        """<DiagGMM> [<GCONSTS> FV] <WEIGHTS> FV <MEANS_INVVARS> FM
        <INV_VARS> FM </DiagGMM>; the stored gconsts are recomputed."""
        iof.expect_token(f, "<DiagGMM>")
        tok = iof.read_token(f)
        if tok == "<GCONSTS>":
            iof.read_vector(f)
            tok = iof.read_token(f)
        if tok != "<WEIGHTS>":
            raise KaldiError(f"DiagGmm.read: expected <WEIGHTS>, got {tok!r}")
        w = iof.read_vector(f).astype(np.float64)
        iof.expect_token(f, "<MEANS_INVVARS>")
        means_invvars = iof.read_matrix(f).astype(np.float64)
        iof.expect_token(f, "<INV_VARS>")
        inv_vars = iof.read_matrix(f).astype(np.float64)
        iof.expect_token(f, "</DiagGMM>")
        variances = 1.0 / inv_vars
        return DiagGmm(w, means_invvars * variances, variances)


class AmDiagGmm:
    """All pdfs' GMMs, with their rows packed on one device for the kernel."""

    def __init__(self, pdfs: List[DiagGmm], device: DeviceLike = None):
        if not pdfs:
            raise KaldiError("AmDiagGmm: no pdfs")
        self.pdfs = pdfs
        self.device = resolve_device(device)
        self._weights: Optional[GmmWeights] = None

    @property
    def num_pdfs(self) -> int:
        return len(self.pdfs)

    @property
    def dim(self) -> int:
        return self.pdfs[0].dim

    @property
    def num_gauss(self) -> int:
        return sum(p.num_mix for p in self.pdfs)

    def invalidate(self) -> None:
        """Forget what derives from the pdfs' parameters, after they were
        changed in place (transform/mllt.py `transform_gmm_means`): the
        packed kernel rows and every DiagGmm's device tensors."""
        self._weights = None
        for pdf in self.pdfs:
            pdf.__dict__.pop("_dev", None)

    @staticmethod
    def init_mono(num_pdfs: int, glob_mean: np.ndarray, glob_var: np.ndarray,
                  perturb: float = 0.0, seed: int = 0,
                  device: DeviceLike = None) -> "AmDiagGmm":
        """The flat start (reference gmm-init-mono): one Gaussian a pdf at
        the global mean and variance, each mean moved by perturb·σ·N(0, 1)
        from `default_rng(seed)`, drawn pdf by pdf."""
        rng = np.random.default_rng(seed)
        pdfs = []
        for _ in range(num_pdfs):
            mean = glob_mean.copy()
            if perturb > 0:
                mean = mean + perturb * np.sqrt(glob_var) * rng.normal(size=mean.shape)
            pdfs.append(DiagGmm(np.ones(1), mean[None, :], glob_var[None, :].copy()))
        return AmDiagGmm(pdfs, device)

    def stacked(self) -> Tuple[np.ndarray, np.ndarray, int]:
        """(W [P·M, 2D+1] float32, mask [P, M] bool, M), the JAX package's
        layout: M is the largest mixture count rounded up to a power of two,
        a frame row is [x, x², 1], padded rows carry gconst −1e30."""
        P, D = self.num_pdfs, self.dim
        M = 1 << (max(p.num_mix for p in self.pdfs) - 1).bit_length()
        W = np.zeros((P, M, 2 * D + 1), np.float64)
        mask = np.zeros((P, M), bool)
        for i, pdf in enumerate(self.pdfs):
            m = pdf.num_mix
            W[i, :m, :D] = pdf.means_invvars
            W[i, :m, D: 2 * D] = -0.5 * pdf.inv_vars
            W[i, :m, 2 * D] = pdf.gconsts
            mask[i, :m] = True
        W[~mask, 2 * D] = NEG
        return W.reshape(P * M, 2 * D + 1).astype(np.float32), mask, M

    def weights(self) -> GmmWeights:
        """The packed rows on the model's device, built once."""
        if self._weights is None:
            W, mask, _ = self.stacked()
            self._weights = pack_gmm_weights(W, mask.sum(axis=1), self.device)
        return self._weights

    @torch.inference_mode()
    def loglikes_batch(self, feats: torch.Tensor) -> torch.Tensor:
        """[..., T, D] float32 tensor on the model's device → [..., T, P]
        loglikes there.  On CUDA through the GMM kernel, on the CPU through
        its plain version."""
        if not isinstance(feats, torch.Tensor):
            raise TypeError("loglikes_batch takes a tensor on the model's device")
        flat = feats.reshape(-1, feats.shape[-1]).contiguous()
        out = gmm_loglikes(flat, self.weights())
        return out.view(*feats.shape[:-1], self.num_pdfs)

    def write(self, f: BinaryIO) -> None:
        iof.write_token(f, "<DIMENSION>")
        iof.write_int32(f, self.dim)
        iof.write_token(f, "<NUMPDFS>")
        iof.write_int32(f, self.num_pdfs)
        for pdf in self.pdfs:
            pdf.write(f)

    @staticmethod
    def read(f: BinaryIO, device: DeviceLike = None) -> "AmDiagGmm":
        """<DIMENSION> d <NUMPDFS> n, then n DiagGMMs (no wrapper token)."""
        iof.expect_token(f, "<DIMENSION>")
        dim = iof.read_int32(f)
        iof.expect_token(f, "<NUMPDFS>")
        pdfs = []
        for _ in range(iof.read_int32(f)):
            g = DiagGmm.read(f)
            if g.dim != dim:
                raise KaldiError(f"AmDiagGmm.read: pdf dim {g.dim} != header dim {dim}")
            pdfs.append(g)
        return AmDiagGmm(pdfs, device)


class AmGmmModel:
    """(TransitionModel, AmDiagGmm): the `final.mdl` of a GMM system."""

    def __init__(self, tm: TransitionModel, am: AmDiagGmm):
        self.tm = tm
        self.am = am

    def write(self, f: BinaryIO) -> None:
        """`final.mdl`'s layout: the transition model, then the GMMs."""
        self.tm.write(f)
        self.am.write(f)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            iof.init_kaldi_output_stream(f, True)
            self.write(f)

    @staticmethod
    def read(f: BinaryIO, device: DeviceLike = None) -> "AmGmmModel":
        tm = TransitionModel.read(f)
        return AmGmmModel(tm, AmDiagGmm.read(f, device))

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "AmGmmModel":
        """A binary `.mdl` file.  device=None means the GPU (raises without
        one); the CPU only by name."""
        with open(path, "rb") as f:
            if not iof.init_kaldi_input_stream(f):
                raise KaldiError(f"{path}: expected a binary Kaldi stream")
            return AmGmmModel.read(f, device)
