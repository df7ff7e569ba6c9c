"""SGMM2: subspace Gaussian mixture acoustic models.

Counterpart of old_kaldi_git_tpu/gmm/sgmm2.py (reference
src/sgmm2/am-sgmm2.{h,cc}, estimate-am-sgmm2.{h,cc}): a shared pool of I
full-covariance Gaussians, per Gaussian a phonetic subspace M_i [D, S] and
a weight projection w_i [S]; per pdf j substate vectors v_jm [S] with
weights c_jm.  Then

  mean_jmi = M_i v_jm,   w_jmi = softmax_i(w_i · v_jm),
  p(x | j) = Σ_m c_jm Σ_i w_jmi N(x; mean_jmi, Σ_i),

with the optional speaker subspace (mean_jmi(s) = M_i v_jm + N_i v_s) and
the symmetric SGMM's speaker weight term (w_i · v_jm + u_i · v_s).

The JAX package computes in float64 numpy with Python loops over pdfs.  The
port computes the same float64 arithmetic in torch on the model's device,
all substates at once:

- the substates of every pdf are stacked, V [JM, S] and c [JM], with a
  padded [J, M_max] index of each pdf's substates (`substate_index`);
- scoring ([T, D] → [T, J]) is one product [T·I, S] × [S, JM] a chunk of
  frames, the per-(jm, i) constants (cached until `invalidate()`) added,
  a logsumexp over the Gaussians, then a logsumexp over each pdf's padded
  substates (−inf in the padding);
- the statistics of a call are one pass over all its frames, taken in the
  order of their pdf's substate count: each frame gathers its own pdf's
  substates ([t, m, I] posteriors, a chunk padded to its own largest
  count m), the per-substate sums of the valid entries are added by
  `index_put_(accumulate=True)` (a fixed order on the card: a run repeats
  itself bit for bit) and the per-Gaussian ones are products;
- the M-step solves every substate's v in one batched solve and M, Σ, N and
  u batched over the Gaussians, in the JAX package's order of the flags
  (v, M, S, N, u, w, c).

Model files are the JAX package's layout (float32 parameters).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import BinaryIO, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.gmm.full_gmm import FullGmm
from old_kaldi_git_tpu_torch.utils import io_funcs as iof
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("sgmm2")

Array = Union[np.ndarray, torch.Tensor]
SCORE_BYTES = 1 << 30  # float64 bytes of one scoring chunk's [t, I, JM] scores
POST_ELEMS = 1 << 24  # elements of one statistics chunk's [t, M_max, I] posteriors
F64 = torch.float64


def _t(x: Array, dev: torch.device) -> torch.Tensor:
    """A float64 tensor on `dev`; numpy input is copied (a model never
    shares memory with its caller's arrays)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, F64)
    return torch.tensor(np.asarray(x, np.float64), device=dev)


def _logsumexp(a: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """The JAX package's rule: a non-finite maximum counts as 0 (a row of
    −inf gives −inf)."""
    m = a.max(dim=dim, keepdim=True).values
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    out = m + torch.log(torch.exp(a - m).sum(dim=dim, keepdim=True))
    return out if keepdim else out.squeeze(dim)


class AmSgmm2:
    """The shared Gaussian pool and the stacked substates, float64 tensors
    on `device`: M [I, D, S], w [I, S], sigma_inv [I, D, D], V [JM, S],
    C [JM] (unnormalised substate weights), N [I, D, T] and u [I, T] or
    None; `counts` [J] (host) is each pdf's number of substates."""

    def __init__(self, M: Array, w: Array, sigma_inv: Array, v: Sequence[Array],
                 c: Sequence[Array], ubm: Optional[FullGmm] = None,
                 N: Optional[Array] = None, u: Optional[Array] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        dev = self.device
        self.M = _t(M, dev)
        self.w = _t(w, dev)
        self.sigma_inv = _t(sigma_inv, dev)
        self.ubm = ubm
        self.N = None if N is None else _t(N, dev)
        self.u = None if u is None else _t(u, dev)
        self.set_substates(v, c)

    # -- shapes -----------------------------------------------------------------
    @property
    def num_gauss(self) -> int:
        return self.M.shape[0]

    @property
    def dim(self) -> int:
        return self.M.shape[1]

    @property
    def phn_dim(self) -> int:
        return self.M.shape[2]

    @property
    def num_pdfs(self) -> int:
        return len(self.counts)

    @property
    def num_substates(self) -> int:
        return int(self.counts.sum())

    @property
    def spk_dim(self) -> int:
        return 0 if self.N is None else self.N.shape[2]

    @property
    def v(self) -> List[torch.Tensor]:
        """Each pdf's substate vectors [M_j, S] (views of V)."""
        return list(torch.split(self.V, self.counts.tolist()))

    @property
    def c(self) -> List[torch.Tensor]:
        return list(torch.split(self.C, self.counts.tolist()))

    def set_substates(self, v: Sequence[Array], c: Sequence[Array]) -> None:
        """Replaces every pdf's substates (v_j [M_j, S], c_j [M_j])."""
        if len(v) != len(c):
            raise KaldiError("AmSgmm2: v and c differ in pdfs")
        self.counts = np.asarray([len(x) for x in v], np.int64)
        if (self.counts < 1).any() or any(len(a) != len(b) for a, b in zip(v, c)):
            raise KaldiError("AmSgmm2: every pdf needs substates, as many c as v")
        if any(isinstance(x, torch.Tensor) for x in list(v) + list(c)):
            self.V = torch.cat([_t(x, self.device).reshape(-1, self.phn_dim) for x in v])
            self.C = torch.cat([_t(x, self.device).reshape(-1) for x in c])
        else:  # host arrays: one upload each
            self.V = _t(np.concatenate([np.reshape(x, (-1, self.phn_dim)) for x in v]),
                        self.device)
            self.C = _t(np.concatenate([np.reshape(x, -1) for x in c]), self.device)
        self.invalidate()

    def invalidate(self) -> None:
        """Forget what derives from the parameters (after they changed)."""
        self._cache: Dict[str, object] = {}

    def _cached(self, name: str, make):
        if name not in self._cache:
            self._cache[name] = make()
        return self._cache[name]

    def to(self, device: DeviceLike) -> "AmSgmm2":
        """A copy on `device`."""
        return AmSgmm2(self.M, self.w, self.sigma_inv, self.v, self.c, self.ubm,
                       self.N, self.u, device)

    # -- init -------------------------------------------------------------------
    @staticmethod
    def init(ubm: FullGmm, num_pdfs: int, phn_dim: Optional[int] = None,
             device: DeviceLike = None) -> "AmSgmm2":
        """sgmm2-init: M_i = [μ_i | I_D] (so v = e1 gives the UBM's means),
        w = 0, Σ_i⁻¹ from the UBM (host float64, the JAX package's
        inverses), one substate a pdf."""
        I, D = ubm.num_mix, ubm.dim
        S = phn_dim or D + 1
        if S < 1 or S > D + 1:
            raise KaldiError(f"phn_dim must be in [1, D+1], got {S}")
        M = np.zeros((I, D, S))
        M[:, :, 0] = ubm.means
        M[:, :, 1:] = np.broadcast_to(np.eye(D)[:, :S - 1], (I, D, S - 1))
        sigma_inv = np.stack([np.linalg.inv(ubm.covars[i] + 1e-6 * np.eye(D))
                              for i in range(I)])
        v0 = np.zeros((1, S))
        v0[0, 0] = 1.0
        return AmSgmm2(M, np.zeros((I, S)), sigma_inv, [v0] * num_pdfs,
                       [np.ones(1)] * num_pdfs, ubm, device=device)

    def init_speaker_subspace(self, spk_dim: int, symmetric: bool = False) -> None:
        """sgmm2-init --spk-space-dim: N_i = the first `spk_dim` identity
        columns; with `symmetric`, u = 0."""
        I, D, _ = self.M.shape
        if spk_dim < 1 or spk_dim > D:
            raise KaldiError(f"spk_dim must be in [1, D], got {spk_dim}")
        eye = torch.eye(D, dtype=F64, device=self.device)[:, :spk_dim]
        self.N = eye[None].expand(I, D, spk_dim).clone()
        if symmetric:
            self.u = torch.zeros((I, spk_dim), dtype=F64, device=self.device)
        self.invalidate()

    # -- speaker terms ----------------------------------------------------------
    def _spk_vec(self, spk_vec) -> torch.Tensor:
        vs = _t(spk_vec, self.device).reshape(-1)
        if vs.shape != (self.spk_dim,):
            raise KaldiError(f"speaker vector dim {tuple(vs.shape)} vs spk_dim {self.spk_dim}")
        return vs

    def spk_offsets(self, spk_vec) -> Optional[torch.Tensor]:
        """o_i = N_i v_s [I, D] (None: no speaker subspace or vector)."""
        if self.N is None or spk_vec is None:
            return None
        return torch.einsum("idt,t->id", self.N, self._spk_vec(spk_vec))

    def spk_weight_bias(self, spk_vec) -> Optional[torch.Tensor]:
        """The symmetric SGMM's log-weight bias b_i = u_i · v_s [I]."""
        if self.u is None or spk_vec is None:
            return None
        return self.u @ self._spk_vec(spk_vec)

    # -- per-model constants (cached) -------------------------------------------
    def shared(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(H = MᵀΣ⁻¹M [I, S, S], log-normalisers [I], MᵀΣ⁻¹ [I, S, D])."""
        def make():
            I, D, S = self.M.shape
            MtSi = torch.einsum("ids,ide->ise", self.M, self.sigma_inv)
            H = torch.einsum("isd,idt->ist", MtSi, self.M)
            sign, logdet = torch.linalg.slogdet(self.sigma_inv)
            if not bool((sign > 0).all()):
                raise KaldiError("Sigma_inv not positive definite")
            return H, -0.5 * (D * np.log(2 * np.pi) - logdet), MtSi
        return self._cached("shared", make)

    def substate_index(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(index [J, M_max] of each pdf's substates in V (0 in the padding),
        valid [J, M_max], owner pdf [JM]) on the device."""
        def make():
            J, Mx = self.num_pdfs, int(self.counts.max())
            start = np.concatenate([[0], np.cumsum(self.counts)[:-1]])
            m = np.arange(Mx)[None, :]
            valid = m < self.counts[:, None]
            idx = np.where(valid, start[:, None] + m, 0)
            owner = np.repeat(np.arange(J), self.counts)
            return (torch.from_numpy(idx).to(self.device),
                    torch.from_numpy(valid).to(self.device),
                    torch.from_numpy(owner).to(self.device))
        return self._cached("index", make)

    def _stacked(self) -> Dict[str, torch.Tensor]:
        """logc [JM] (normalised in each pdf, floored at 1e-20), bilin [JM, I]
        = −½ vᵀH_i v, aw [JM, I] raw weight logits, logw [JM, I]."""
        def make():
            H, _, _ = self.shared()
            idx, valid, owner = self.substate_index()
            I, S = self.num_gauss, self.phn_dim
            csum = torch.where(valid, self.C[idx], torch.zeros((), dtype=F64,
                                                                 device=self.device)).sum(1)
            logc = torch.log(torch.clamp(self.C / torch.clamp(csum[owner], min=1e-20),
                                         min=1e-20))
            VH = (self.V @ H.permute(1, 0, 2).reshape(S, I * S)).reshape(-1, I, S)
            bilin = -0.5 * (VH * self.V[:, None, :]).sum(-1)
            aw = self.V @ self.w.T
            return {"logc": logc, "bilin": bilin, "aw": aw,
                    "logw": aw - _logsumexp(aw, 1, keepdim=True)}
        return self._cached("stacked", make)

    def _state_consts(self, spk_bias: Optional[torch.Tensor]) -> torch.Tensor:
        """bilin + logw (re-normalised with the speaker bias) + logc [JM, I]."""
        st = self._stacked()
        if spk_bias is None:
            return self._cached("consts", lambda: st["bilin"] + st["logw"]
                                + st["logc"][:, None])
        a = st["aw"] + spk_bias[None, :]
        return st["bilin"] + (a - _logsumexp(a, 1, keepdim=True)) + st["logc"][:, None]

    # -- evaluation ---------------------------------------------------------------
    def frame_terms(self, x: torch.Tensor, spk_offsets: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """a [T, I] = C_i − ½ xᵀΣ_i⁻¹x and z [T, I, S] = M_iᵀΣ_i⁻¹x of float64
        frames; with speaker offsets o [I, D], those of x − o_i."""
        _, Cn, MtSi = self.shared()
        I, D, S = self.M.shape
        xs = (x @ self.sigma_inv.permute(1, 0, 2).reshape(D, I * D)).reshape(-1, I, D)
        a = Cn[None, :] - 0.5 * (xs * x[:, None, :]).sum(-1)
        z = (x @ MtSi.permute(2, 0, 1).reshape(D, I * S)).reshape(-1, I, S)
        if spk_offsets is not None:
            sig_o = torch.einsum("ide,ie->id", self.sigma_inv, spk_offsets)
            a = a + x @ sig_o.T - 0.5 * (spk_offsets * sig_o).sum(1)[None]
            z = z - torch.einsum("isd,id->is", MtSi, spk_offsets)[None]
        return a, z

    def loglikes(self, feats: Array, spk_vec=None) -> torch.Tensor:
        """[T, D] → [T, J] float64 on the model's device (DecodableAmSgmm2):
        a chunk of frames' [t, I, JM] scores from one product, a logsumexp
        over the Gaussians, then over each pdf's substates."""
        x = _t(feats, self.device)
        off = self.spk_offsets(spk_vec)
        K = self._state_consts(self.spk_weight_bias(spk_vec)).T.contiguous()  # [I, JM]
        idx, valid, _ = self.substate_index()
        I, S, JM = self.num_gauss, self.phn_dim, self.V.shape[0]
        Vt = self.V.T.contiguous()
        chunk = max(1, SCORE_BYTES // (8 * I * JM))
        out = torch.empty((x.shape[0], self.num_pdfs), dtype=F64, device=self.device)
        for lo in range(0, x.shape[0], chunk):
            a, z = self.frame_terms(x[lo: lo + chunk], off)
            t = a.shape[0]
            s = (z.reshape(t * I, S) @ Vt).reshape(t, I, JM)
            s += a[:, :, None]
            s += K[None]
            comp = _logsumexp(s, 1)  # [t, JM]
            del s
            per = torch.where(valid[None], comp[:, idx], -torch.inf)  # [t, J, M_max]
            out[lo: lo + t] = _logsumexp(per, 2)
        return out

    def loglikes_batch(self, feats: Array, num_frames: Optional[Sequence[int]] = None,
                       spk_vecs: Optional[Sequence] = None) -> torch.Tensor:
        """[B, T, D] → [B, T, J] float64 on the model's device (the
        decodable contract of the aligner and the decoders).  With
        `num_frames` only each utterance's valid frames are scored (the
        padding stays 0); `spk_vecs`: a speaker vector (or None) per
        utterance."""
        x = _t(feats, self.device)
        B, T, _ = x.shape
        nf = [T] * B if num_frames is None else [int(n) for n in num_frames]
        out = torch.zeros((B, T, self.num_pdfs), dtype=F64, device=self.device)
        if spk_vecs is None:
            frames = torch.cat([x[b, : nf[b]] for b in range(B)])
            ll = self.loglikes(frames)
            lo = 0
            for b in range(B):
                out[b, : nf[b]] = ll[lo: lo + nf[b]]
                lo += nf[b]
            return out
        for b in range(B):
            out[b, : nf[b]] = self.loglikes(x[b, : nf[b]], spk_vec=spk_vecs[b])
        return out

    def own_pdf_posteriors(self, x: torch.Tensor, pdf_ids: torch.Tensor,
                           weights: torch.Tensor, off=None, bias=None):
        """Each frame's posteriors over its own pdf's substates and the
        Gaussians.  The frames go in the order of their pdf's substate
        count (a stable sort), in chunks padded to the chunk's own largest
        count: yields (rows [t] the chunk's frame positions, idx [t, m],
        valid [t, m], post [t, m, I] weighted, loglike [t], z [t, I, S]);
        the padding's posteriors are 0."""
        idx_all, valid_all, _ = self.substate_index()
        K = self._state_consts(bias)
        I = self.num_gauss
        count = torch.from_numpy(self.counts).to(self.device)[pdf_ids]
        order = torch.argsort(count, stable=True)
        counts = count[order].cpu().numpy()
        lo, T = 0, len(counts)
        while lo < T:
            # at most POST_ELEMS posteriors: sized by the first frame's count,
            # then cut to the last (largest) one's
            hi = min(T, lo + max(1, POST_ELEMS // (I * int(counts[lo]))))
            hi = min(hi, lo + max(1, POST_ELEMS // (I * int(counts[hi - 1]))))
            m = int(counts[hi - 1])
            rows = order[lo:hi]
            a, z = self.frame_terms(x[rows], off)
            p = pdf_ids[rows]
            idx, valid = idx_all[p, :m], valid_all[p, :m]  # [t, m]
            Kg = torch.where(valid[:, :, None], K[idx], -torch.inf)  # [t, m, I]
            s = torch.bmm(self.V[idx], z.transpose(1, 2)) + a[:, None, :] + Kg
            t = s.shape[0]
            lse = _logsumexp(s.reshape(t, -1), 1)
            post = torch.exp(s - lse[:, None, None]) * weights[rows, None, None]
            yield rows, idx, valid, post, lse, z
            lo = hi

    # -- serialization ------------------------------------------------------------
    def write(self, f: BinaryIO) -> None:
        """The JAX package's layout: <AmSgmm2> I D S J, M_i, w, Σ_i⁻¹, each
        pdf's v_j and c_j, the speaker dim and N_i, the u flag and u, the UBM
        flag and UBM </AmSgmm2>, parameters as float32."""
        h = lambda a: a.detach().cpu().numpy().astype(np.float32)  # noqa: E731
        iof.write_token(f, "<AmSgmm2>")
        for n in (self.num_gauss, self.dim, self.phn_dim, self.num_pdfs):
            iof.write_int32(f, n)
        M, sigma_inv = h(self.M), h(self.sigma_inv)
        for i in range(self.num_gauss):
            iof.write_matrix(f, M[i])
        iof.write_matrix(f, h(self.w))
        for i in range(self.num_gauss):
            iof.write_matrix(f, sigma_inv[i])
        V, C = h(self.V), h(self.C)
        lo = 0
        for n in self.counts.tolist():
            iof.write_matrix(f, V[lo: lo + n])
            iof.write_vector(f, C[lo: lo + n])
            lo += n
        iof.write_int32(f, self.spk_dim)
        if self.N is not None:
            N = h(self.N)
            for i in range(self.num_gauss):
                iof.write_matrix(f, N[i])
        iof.write_int32(f, 1 if self.u is not None else 0)
        if self.u is not None:
            iof.write_matrix(f, h(self.u))
        iof.write_int32(f, 1 if self.ubm is not None else 0)
        if self.ubm is not None:
            self.ubm.write(f)
        iof.write_token(f, "</AmSgmm2>")

    @staticmethod
    def read(f: BinaryIO, device: DeviceLike = None) -> "AmSgmm2":
        iof.expect_token(f, "<AmSgmm2>")
        I, D, S, J = (iof.read_int32(f) for _ in range(4))
        M = np.stack([iof.read_matrix(f) for _ in range(I)])
        w = iof.read_matrix(f)
        sigma_inv = np.stack([iof.read_matrix(f) for _ in range(I)])
        v, c = [], []
        for _ in range(J):
            v.append(np.asarray(iof.read_matrix(f), np.float64))
            c.append(np.asarray(iof.read_vector(f), np.float64))
        spk_dim = iof.read_int32(f)
        N = np.stack([iof.read_matrix(f) for _ in range(I)]) if spk_dim > 0 else None
        u = np.asarray(iof.read_matrix(f), np.float64) if iof.read_int32(f) else None
        ubm = FullGmm.read(f) if iof.read_int32(f) else None
        iof.expect_token(f, "</AmSgmm2>")
        out = AmSgmm2(M, w, sigma_inv, v, c, ubm, N=N, u=u, device=device)
        if out.dim != D or out.phn_dim != S:
            raise KaldiError("inconsistent AmSgmm2 header")
        return out


# ---------------------------------------------------------------------------
# EM
# ---------------------------------------------------------------------------


class MleAmSgmm2Accs:
    """Sufficient statistics (MleAmSgmm2Accs), float64 on the model's device:
    gamma [JM, I] and y [JM, S] per substate, Y [I, D, S], Q [I, S, S] and
    the raw scatter S [I, D, D] per Gaussian; with a speaker subspace Y_N
    [I, D, T] and Q_N [I, T, T]; on a symmetric model a_u [I, T] and Q_u
    [I, T, T]."""

    def __init__(self, model: AmSgmm2):
        I, D, S = model.M.shape
        JM = model.V.shape[0]
        self.device = model.device
        self.counts = model.counts.copy()
        z = lambda *s: torch.zeros(s, dtype=F64, device=self.device)  # noqa: E731
        self.gamma, self.y = z(JM, I), z(JM, S)
        self.Y, self.Q, self.S = z(I, D, S), z(I, S, S), z(I, D, D)
        T = model.spk_dim
        self.Y_N = z(I, D, T) if T else None
        self.Q_N = z(I, T, T) if T else None
        has_u = model.u is not None and T > 0
        self.a_u = z(I, T) if has_u else None
        self.Q_u = z(I, T, T) if has_u else None
        self.total_frames = 0.0
        self.total_like = 0.0

    def accumulate(self, model: AmSgmm2, feats: Array, pdf_ids: Array, weights=None,
                   spk_vec=None) -> None:
        """One pass over aligned frames (an utterance, a speaker or a whole
        table: the statistics are sums).  With `spk_vec` the phonetic
        statistics are those of the speaker-shifted features x − N_i v_s
        and the speaker-subspace ones are collected (for one speaker)."""
        dev = self.device
        x = _t(feats, dev)
        pdf = torch.as_tensor(np.asarray(pdf_ids, np.int64)).to(dev)
        w = (torch.ones(x.shape[0], dtype=F64, device=dev) if weights is None
             else _t(weights, dev))
        off = model.spk_offsets(spk_vec)
        bias = model.spk_weight_bias(spk_vec)
        I, D, S = model.M.shape
        JM = model.V.shape[0]
        gamma = torch.zeros((JM, I), dtype=F64, device=dev)
        y = torch.zeros((JM, S), dtype=F64, device=dev)
        xw = torch.zeros((I, D), dtype=F64, device=dev)
        like = torch.zeros((), dtype=F64, device=dev)
        for rows, idx, valid, post, lse, z in model.own_pdf_posteriors(x, pdf, w, off, bias):
            xc = x[rows]
            t = xc.shape[0]
            own = (idx[valid],)  # the padding left out: no run of its index to add up
            gamma.index_put_(own, post[valid], accumulate=True)
            y.index_put_(own, torch.bmm(post, z)[valid], accumulate=True)
            pv = torch.bmm(post.transpose(1, 2), model.V[idx])  # [t, I, S]
            self.Y += (xc.T @ pv.reshape(t, I * S)).reshape(D, I, S).permute(1, 0, 2)
            gi = post.sum(1)  # [t, I]
            self.S += (gi.T @ (xc[:, :, None] * xc[:, None, :]).reshape(t, D * D)
                       ).reshape(I, D, D)
            xw += gi.T @ xc
            like += (lse * w[rows]).sum()
        self.gamma += gamma
        self.y += y
        VV = (model.V[:, :, None] * model.V[:, None, :]).reshape(JM, S * S)
        self.Q += (gamma.T @ VV).reshape(I, S, S)
        if off is not None:
            vs = model._spk_vec(spk_vec)
            gv = gamma.T @ model.V  # [I, S]
            gsum = gamma.sum(0)
            self.Y -= off[:, :, None] * gv[:, None, :]
            self.S -= off[:, :, None] * xw[:, None, :] + xw[:, :, None] * off[:, None, :]
            self.S += gsum[:, None, None] * (off[:, :, None] * off[:, None, :])
            r = xw - torch.einsum("ids,is->id", model.M, gv)
            self.Y_N += r[:, :, None] * vs[None, None, :]
            self.Q_N += gsum[:, None, None] * torch.outer(vs, vs)[None]
            if self.a_u is not None:
                aw = model._stacked()["aw"] + bias[None, :]
                wjmi = torch.exp(aw - _logsumexp(aw, 1, keepdim=True))
                what = (gamma.sum(1)[:, None] * wjmi).sum(0)
                self.a_u += torch.outer(gsum - what, vs)
                self.Q_u += torch.maximum(gsum, what)[:, None, None] * torch.outer(vs, vs)[None]
        self.total_like += float(like)
        self.total_frames += float(w.sum())

    def add(self, other: "MleAmSgmm2Accs") -> None:
        for name in ("gamma", "y", "Y", "Q", "S", "Y_N", "Q_N", "a_u", "Q_u"):
            mine, theirs = getattr(self, name), getattr(other, name)
            if mine is not None and theirs is not None:
                mine += theirs.to(self.device)
        self.total_frames += other.total_frames
        self.total_like += other.total_like

    # -- serialization (the JAX package's bytes) ----------------------------------
    def save(self, path: str) -> None:
        h = lambda a: a.detach().cpu().numpy()  # noqa: E731
        gamma, y = h(self.gamma), h(self.y)
        with open(path, "wb") as f:
            iof.init_kaldi_output_stream(f, True)
            iof.write_token(f, "<Sgmm2Accs>")
            iof.write_int32(f, len(self.counts))
            lo = 0
            for n in self.counts.tolist():
                iof.write_matrix(f, gamma[lo: lo + n], np.float64)
                iof.write_matrix(f, y[lo: lo + n], np.float64)
                lo += n
            for name, arr in (("Y", self.Y), ("Q", self.Q), ("S", self.S)):
                iof.write_token(f, f"<{name}>")
                for m in h(arr):
                    iof.write_matrix(f, m, np.float64)
            iof.write_int32(f, 0 if self.Y_N is None else self.Y_N.shape[2])
            if self.Y_N is not None:
                for name, arr in (("YN", self.Y_N), ("QN", self.Q_N)):
                    iof.write_token(f, f"<{name}>")
                    for m in h(arr):
                        iof.write_matrix(f, m, np.float64)
            iof.write_int32(f, 0 if self.a_u is None else 1)
            if self.a_u is not None:
                iof.write_token(f, "<AU>")
                iof.write_matrix(f, h(self.a_u), np.float64)
                iof.write_token(f, "<QU>")
                for m in h(self.Q_u):
                    iof.write_matrix(f, m, np.float64)
            iof.write_vector(f, np.asarray([self.total_frames, self.total_like]), np.float64)
            iof.write_token(f, "</Sgmm2Accs>")

    @staticmethod
    def load(path: str, model: AmSgmm2) -> "MleAmSgmm2Accs":
        out = MleAmSgmm2Accs(model)
        dev = out.device
        with open(path, "rb") as f:
            iof.init_kaldi_input_stream(f)
            iof.expect_token(f, "<Sgmm2Accs>")
            if iof.read_int32(f) != model.num_pdfs:
                raise KaldiError("acc/model pdf mismatch")
            gammas, ys = [], []
            for j, n in enumerate(model.counts.tolist()):
                g = np.asarray(iof.read_matrix(f), np.float64)
                if g.shape[0] != n:
                    raise KaldiError(
                        f"acc pdf {j}: {g.shape[0]} substates in file, model has {n} — "
                        "accs must come from the same substate topology")
                gammas.append(g)
                ys.append(np.asarray(iof.read_matrix(f), np.float64))
            out.gamma = _t(np.concatenate(gammas), dev)
            out.y = _t(np.concatenate(ys), dev)

            def read_stack(name, n):
                iof.expect_token(f, f"<{name}>")
                return _t(np.stack([iof.read_matrix(f) for _ in range(n)]), dev)

            I = model.num_gauss
            out.Y, out.Q, out.S = (read_stack(n, I) for n in ("Y", "Q", "S"))
            t_spk = iof.read_int32(f)
            if t_spk:
                if out.Y_N is None or out.Y_N.shape[2] != t_spk:
                    raise KaldiError("acc/model speaker-subspace mismatch")
                out.Y_N, out.Q_N = read_stack("YN", I), read_stack("QN", I)
            if iof.read_int32(f):
                if out.a_u is None:
                    raise KaldiError("acc has symmetric-SGMM stats but model has no u "
                                     "(not symmetric)")
                iof.expect_token(f, "<AU>")
                out.a_u = _t(iof.read_matrix(f), dev)
                out.Q_u = read_stack("QU", I)
            tots = iof.read_vector(f)
            out.total_frames, out.total_like = float(tots[0]), float(tots[1])
            iof.expect_token(f, "</Sgmm2Accs>")
        return out


@dataclasses.dataclass
class Sgmm2UpdateOptions:
    """--update-flags of sgmm2-est.  'v' and 'M' must not be updated from
    the same statistics (the combined step overshoots): alternate them
    across iterations (`alternating_flags`)."""

    update_flags: str = "vwc"
    min_gaussian_occupancy: float = 10.0
    min_substate_occupancy: float = 2.0
    cov_floor: float = 1e-3
    w_newton_steps: int = 3


def alternating_flags(iteration: int) -> str:
    """The per-iteration update schedule: even iterations 'vwc', odd 'MS'."""
    return "vwc" if iteration % 2 == 0 else "MS"


def sgmm2_update(model: AmSgmm2, accs: MleAmSgmm2Accs,
                 opts: Sgmm2UpdateOptions = Sgmm2UpdateOptions()) -> float:
    """M-step (MleAmSgmm2Updater::Update) on the model's device; returns the
    average like/frame of the statistics under the model they came from."""
    I, D, S = model.M.shape
    dev = model.device
    flags = opts.update_flags
    if "v" in flags and "M" in flags:
        log.warning("updating 'v' and 'M' from the same stats overshoots "
                    "(see Sgmm2UpdateOptions); use alternating_flags()")
    H, _, _ = model.shared()
    eye = lambda n: torch.eye(n, dtype=F64, device=dev)  # noqa: E731
    occ_i = accs.gamma.sum(0)  # [I]

    if "v" in flags:
        JM = model.V.shape[0]
        A = (accs.gamma @ H.reshape(I, S * S)).reshape(JM, S, S) + 1e-6 * eye(S)
        new = torch.linalg.solve(A, accs.y[:, :, None])[:, :, 0]
        ok = accs.gamma.sum(1) >= opts.min_substate_occupancy
        model.V = torch.where(ok[:, None], new, model.V)

    if "M" in flags:
        ok = occ_i >= opts.min_gaussian_occupancy
        new = accs.Y @ torch.linalg.inv(accs.Q + 1e-6 * eye(S))
        model.M = torch.where(ok[:, None, None], new, model.M)

    if "S" in flags:
        ok = occ_i >= opts.min_gaussian_occupancy
        Mi = model.M
        Mt = Mi.transpose(1, 2)
        Yt = accs.Y.transpose(1, 2)
        cov = (accs.S - Mi @ Yt - accs.Y @ Mt + Mi @ accs.Q @ Mt) / torch.where(
            ok, occ_i, torch.ones_like(occ_i))[:, None, None]
        cov = 0.5 * (cov + cov.transpose(1, 2)) + opts.cov_floor * eye(D)
        cov = torch.where(ok[:, None, None], cov, eye(D).expand(I, D, D))
        model.sigma_inv = torch.where(ok[:, None, None], torch.linalg.inv(cov),
                                      model.sigma_inv)

    if "N" in flags and model.N is not None:
        if accs.Y_N is None:
            raise KaldiError("flag 'N' needs speaker-subspace stats (accumulate with spk_vec)")
        T = model.spk_dim
        ok = torch.diagonal(accs.Q_N, dim1=1, dim2=2).sum(1) >= 1e-8
        new = accs.Y_N @ torch.linalg.inv(accs.Q_N + 1e-6 * eye(T))
        model.N = torch.where(ok[:, None, None], new, model.N)

    if "u" in flags and model.u is not None:
        if accs.a_u is None:
            raise KaldiError("flag 'u' needs symmetric-SGMM stats (accumulate with spk_vec "
                             "on a symmetric model)")
        T = model.spk_dim
        occ = torch.diagonal(accs.Q_u, dim1=1, dim2=2).sum(1)
        ok = occ >= 1e-8
        reg = (1e-6 + 1e-2 * occ / T)[:, None, None] * eye(T)
        step = torch.linalg.solve(accs.Q_u + reg, accs.a_u[:, :, None])[:, :, 0]
        model.u = torch.where(ok[:, None], model.u + step, model.u)

    if "w" in flags:
        _update_weight_projections(model, accs, opts.w_newton_steps)

    if "c" in flags:
        idx, valid, owner = model.substate_index()
        g = accs.gamma.sum(1)  # [JM]
        tot = torch.where(valid, g[idx], torch.zeros((), dtype=F64, device=dev)).sum(1)
        tj = tot[owner]
        model.C = torch.where(tj > 0, torch.clamp(g / torch.where(tj > 0, tj, 1.0), min=1e-8),
                              model.C)

    model.invalidate()
    avg = accs.total_like / accs.total_frames if accs.total_frames else float("nan")
    log.info("sgmm2-est: avg like/frame %.4f over %.0f frames (%d substates)", avg,
             accs.total_frames, model.num_substates)
    return avg


def _update_weight_projections(model: AmSgmm2, accs: MleAmSgmm2Accs, steps: int) -> None:
    """Gradient steps with halving on F(w) = Σ_jmi γ_jmi log softmax_i(w_i·v_jm);
    a step is taken when F does not fall by more than 1e-9."""
    V, G = model.V, accs.gamma
    tot = G.sum(1, keepdim=True)

    def logw_of(w):
        a = V @ w.T
        return a - _logsumexp(a, 1, keepdim=True)

    def aux(w) -> float:
        return float((G * logw_of(w)).sum())

    w = model.w.clone()
    f0 = aux(w)
    denom = max(float(tot.sum()), 1.0)
    for _ in range(steps):
        grad = (G - tot * torch.exp(logw_of(w))).T @ V  # [I, S]
        step = 1.0
        while step > 1e-4:
            cand = w + step * grad / denom
            if aux(cand) >= f0 - 1e-9:
                w = cand
                f0 = aux(w)
                break
            step *= 0.5
    model.w = w


def _spk_terms(model: AmSgmm2, x, pdf, w, vs):
    """One pass of estimate_spk_vector: (lhs [T, T], rhs [T], total
    occupancy, γ_i [I], ŵ_i [I]) under the current speaker vector vs."""
    I, D, S = model.M.shape
    off = model.spk_offsets(vs)
    bias = model.spk_weight_bias(vs)
    dev = model.device
    gsum = torch.zeros(I, dtype=F64, device=dev)
    xw = torch.zeros((I, D), dtype=F64, device=dev)
    gv = torch.zeros((I, S), dtype=F64, device=dev)
    occ_jm = torch.zeros(model.V.shape[0], dtype=F64, device=dev)
    for rows, idx, valid, post, _, _ in model.own_pdf_posteriors(x, pdf, w, off, bias):
        gi = post.sum(1)
        gsum += gi.sum(0)
        xw += gi.T @ x[rows]
        gv += torch.bmm(post.transpose(1, 2), model.V[idx]).sum(0)
        if model.u is not None:
            occ_jm.index_put_((idx[valid],), post.sum(2)[valid], accumulate=True)
    what = None
    if model.u is not None:
        aw = model._stacked()["aw"] + bias[None, :]
        what = (occ_jm[:, None] * torch.exp(aw - _logsumexp(aw, 1, keepdim=True))).sum(0)
    return gsum, xw, gv, what


def estimate_spk_vector(model: AmSgmm2, feats: Array, pdf_ids: Array, weights=None,
                        num_iters: int = 2, min_count: float = 10.0) -> torch.Tensor:
    """A speaker's vector v_s [T] (sgmm2-est-spkvecs) on the model's device:
    the closed-form solve of (Σ_i γ_i N_iᵀΣ_i⁻¹N_i) v_s = Σ_i N_iᵀΣ_i⁻¹ r_i
    over the speaker's aligned frames, iterated since the posteriors depend
    on v_s; zeros when the occupancy is below `min_count`.  On a symmetric
    model the weight term is linearised at the current v_s."""
    if model.N is None:
        raise KaldiError("model has no speaker subspace")
    dev = model.device
    x = _t(feats, dev)
    pdf = torch.as_tensor(np.asarray(pdf_ids, np.int64)).to(dev)
    w = torch.ones(x.shape[0], dtype=F64, device=dev) if weights is None else _t(weights, dev)
    T = model.spk_dim
    NtSi = torch.einsum("idt,ide->ite", model.N, model.sigma_inv)
    H_spk = torch.einsum("ite,ieu->itu", NtSi, model.N)
    vs = torch.zeros(T, dtype=F64, device=dev)
    for _ in range(max(1, num_iters)):
        gsum, xw, gv, what = _spk_terms(model, x, pdf, w, vs)
        if float(gsum.sum()) < min_count:
            return torch.zeros(T, dtype=F64, device=dev)
        r = xw - torch.einsum("ids,is->id", model.M, gv)
        lhs = torch.einsum("i,itu->tu", gsum, H_spk)
        rhs = torch.einsum("ite,ie->t", NtSi, r)
        if model.u is not None:
            g_w = model.u.T @ (gsum - what)
            H_w = torch.einsum("i,it,iu->tu", torch.maximum(gsum, what), model.u, model.u)
            lhs = lhs + H_w
            rhs = rhs + g_w + H_w @ vs
        vs = torch.linalg.solve(lhs + 1e-6 * torch.eye(T, dtype=F64, device=dev), rhs)
    return vs


def split_substates(model: AmSgmm2, accs: MleAmSgmm2Accs, target: int,
                    perturb: float = 0.01, seed: int = 0) -> None:
    """Grows the model toward `target` substates by splitting the substate
    of highest occupancy, the first (lowest pdf, then substate) among equals
    (MleAmSgmm2Updater::SplitSubstates): v ∓ perturb·N(0, 1) drawn from
    `default_rng(seed)` split by split, c halved, the copy appended to its
    pdf.  The choice runs on the host over a heap."""
    rng = np.random.default_rng(seed)
    occ_all = accs.gamma.sum(1).cpu().numpy()
    V, C = model.V.cpu().numpy(), model.C.cpu().numpy()
    bounds = np.concatenate([[0], np.cumsum(model.counts)])
    v = [V[bounds[j]: bounds[j + 1]].copy() for j in range(model.num_pdfs)]
    c = [C[bounds[j]: bounds[j + 1]].copy() for j in range(model.num_pdfs)]
    occ = [list(occ_all[bounds[j]: bounds[j + 1]]) for j in range(model.num_pdfs)]
    heap = [(-o, j, m) for j in range(len(occ)) for m, o in enumerate(occ[j])]
    heapq.heapify(heap)
    total = model.num_substates
    while total < target and heap:
        neg, j, m = heapq.heappop(heap)
        if -neg != occ[j][m]:
            continue  # an entry made stale by an earlier split
        if occ[j][m] <= 0:
            break
        d = perturb * rng.standard_normal(model.phn_dim)
        v0 = v[j][m].copy()
        v[j] = np.vstack([v[j], v0 + d])
        v[j][m] = v0 - d
        half = c[j][m] / 2
        c[j][m] = half
        c[j] = np.append(c[j], half)
        occ[j][m] /= 2
        occ[j].append(occ[j][m])
        heapq.heappush(heap, (-occ[j][m], j, m))
        heapq.heappush(heap, (-occ[j][-1], j, len(occ[j]) - 1))
        total += 1
    model.set_substates(v, c)
    log.info("split to %d substates", model.num_substates)


# ---------------------------------------------------------------------------
# (TransitionModel, AmSgmm2): the sgmm2 final.mdl
# ---------------------------------------------------------------------------


class Sgmm2Model:
    def __init__(self, tm, sgmm: AmSgmm2):
        self.tm = tm
        self.sgmm = sgmm

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            iof.init_kaldi_output_stream(f, True)
            self.tm.write(f)
            self.sgmm.write(f)

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "Sgmm2Model":
        from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel

        with open(path, "rb") as f:
            iof.init_kaldi_input_stream(f)
            tm = TransitionModel.read(f)
            sgmm = AmSgmm2.read(f, device)
        return Sgmm2Model(tm, sgmm)
