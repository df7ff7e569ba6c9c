"""Regression-tree MLLR / fMLLR: adaptation per cluster of Gaussians.

Counterpart of old_kaldi_git_tpu/transform/regtree.py (reference
src/transform/regression-tree.{h,cc}, regtree-fmllr-diag-gmm.{h,cc},
regtree-mllr-diag-gmm.{h,cc}; gmm-make-regtree, gmm-est-regtree-fmllr,
gmm-est-regtree-mllr, gmm-decode-faster-regtree-{fmllr,mllr}).

Every Gaussian of the model belongs to one of B baseclasses (weighted
k-means on its variance-normalised mean), merged agglomeratively into a
binary tree (`RegressionTree.build`: host numpy, the JAX package's
arithmetic and draws, so that the tree file is the JAX package's byte for
byte).  Statistics are gathered per baseclass; a baseclass is adapted by the
transform of its first ancestor (itself included) whose subtree holds
min_count frames.

- The accumulators take every frame of a speaker at once on the model's
  device, in float64: posteriors over each frame's pdf's Gaussians with the
  JAX package's per-utterance skip of Gaussians under 1e-8
  (transform/mllt.py `aligned_gaussian_posteriors`, the utterances told
  apart by `groups`); fMLLR statistics go to one FmllrAccs a baseclass, MLLR
  statistics (K_c, G_c from each Gaussian's occupancy and Σγx) to [B, ...]
  tensors.
- fMLLR estimation solves every regression node of every speaker together
  (transform/fmllr.py `compute_fmllr_transforms`); MLLR's closed-form row
  solves (D systems of D+1) run on the host in float64 numpy, as in the JAX
  package.
- `apply_mllr_to_model` gives an adapted AmDiagGmm on the model's device,
  which scores through the GMM kernel like any other model;
  `regtree_fmllr_loglikes` scores each Gaussian on its class's transformed
  features plus log|A|, in float64 on the model's device (no kernel: the
  JAX package computes it in numpy).
- The "regx" table holder carries a speaker's RegtreeTransform.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, DiagGmm
from old_kaldi_git_tpu_torch.transform.fmllr import FmllrAccs, compute_fmllr_transforms
from old_kaldi_git_tpu_torch.transform.mllt import (
    CHUNK_ELEMENTS,
    aligned_gaussian_posteriors,
    padded_gaussians,
)
from old_kaldi_git_tpu_torch.utils.io_funcs import (
    expect_token,
    init_kaldi_input_stream,
    init_kaldi_output_stream,
    read_int32,
    read_int_vector,
    read_matrix,
    read_token,
    write_int32,
    write_int_vector,
    write_matrix,
    write_token,
)
from old_kaldi_git_tpu_torch.utils.log import get_logger
from old_kaldi_git_tpu_torch.utils.table import Holder, register_holder

log = get_logger("regtree")

ArrayLike = Union[np.ndarray, torch.Tensor]


class RegressionTree:
    """A binary tree over Gaussian baseclasses: nodes 0..B-1 are the
    baseclasses, merged nodes follow in merge order, the root is the last
    (its own parent).  `gauss2bclass[pdf][mix]` is each Gaussian's
    baseclass."""

    def __init__(self, parents: np.ndarray, gauss2bclass: List[np.ndarray],
                 num_baseclasses: int):
        self.parents = np.asarray(parents, np.int32)
        self.gauss2bclass = [np.asarray(g, np.int32) for g in gauss2bclass]
        self.num_baseclasses = int(num_baseclasses)

    @property
    def num_nodes(self) -> int:
        return len(self.parents)

    @property
    def root(self) -> int:
        return self.num_nodes - 1

    @staticmethod
    def build(am: AmDiagGmm, num_baseclasses: int = 32, seed: int = 0,
              kmeans_iters: int = 20) -> "RegressionTree":
        """Weighted k-means (k-means++ start from `default_rng(seed)`) of the
        Gaussians' variance-normalised means into `num_baseclasses`, empty
        clusters dropped, then Ward-style agglomerative merging into a binary
        tree (gmm-make-regtree)."""
        mu = np.concatenate([g.means for g in am.pdfs])
        w = np.maximum(np.concatenate([g.weights for g in am.pdfs]), 1e-8)
        G = len(mu)
        B = int(min(num_baseclasses, G))
        z = mu * (1.0 / (mu.std(axis=0) + 1e-8))
        rng = np.random.default_rng(seed)
        centers = [z[rng.integers(G)]]
        for _ in range(B - 1):
            d2 = np.min([np.sum((z - c) ** 2, axis=1) for c in centers], axis=0)
            prob = d2 * w
            tot = prob.sum()
            if tot <= 0:
                centers.append(z[rng.integers(G)])
                continue
            centers.append(z[rng.choice(G, p=prob / tot)])
        cent = np.stack(centers)
        assign = np.zeros(G, np.int64)
        for _ in range(kmeans_iters):
            new = ((z[:, None, :] - cent[None, :, :]) ** 2).sum(axis=2).argmin(axis=1)
            if (new == assign).all():
                assign = new
                break
            assign = new
            for b in range(B):
                sel = assign == b
                if sel.any():
                    cent[b] = np.average(z[sel], axis=0, weights=w[sel])
        used = np.unique(assign)
        remap = {int(b): i for i, b in enumerate(used)}
        assign = np.asarray([remap[int(b)] for b in assign])
        B = len(used)
        cent = cent[used]
        occ = np.asarray([w[assign == b].sum() for b in range(B)])
        parents = np.full(2 * B - 1, -1, np.int32)
        live: Dict[int, Tuple[np.ndarray, float]] = {b: (cent[b], occ[b]) for b in range(B)}
        nxt = B
        while len(live) > 1:
            keys = sorted(live)
            best = None
            for i, a in enumerate(keys):
                ca, wa = live[a]
                for b in keys[i + 1:]:
                    cb, wb = live[b]
                    cost = (wa * wb) / (wa + wb) * np.sum((ca - cb) ** 2)
                    if best is None or cost < best[0]:
                        best = (cost, a, b)
            _, a, b = best
            ca, wa = live.pop(a)
            cb, wb = live.pop(b)
            parents[a] = parents[b] = nxt
            live[nxt] = ((wa * ca + wb * cb) / (wa + wb), wa + wb)
            nxt += 1
        root = nxt - 1 if B > 1 else 0
        parents = parents[:root + 1]
        parents[root] = root
        g2b, off = [], 0
        for gmm in am.pdfs:
            g2b.append(assign[off:off + gmm.num_mix].astype(np.int32))
            off += gmm.num_mix
        log.info("regtree: %d baseclasses over %d Gaussians, %d nodes", B, G, len(parents))
        return RegressionTree(parents, g2b, B)

    def write(self, f) -> None:
        init_kaldi_output_stream(f, True)
        write_token(f, "<RegressionTree>")
        write_int32(f, self.num_baseclasses)
        write_int_vector(f, self.parents)
        write_int32(f, len(self.gauss2bclass))
        for g in self.gauss2bclass:
            write_int_vector(f, g)
        write_token(f, "</RegressionTree>")

    @staticmethod
    def read(f) -> "RegressionTree":
        init_kaldi_input_stream(f)
        expect_token(f, "<RegressionTree>")
        nb = read_int32(f)
        parents = read_int_vector(f)
        g2b = [read_int_vector(f) for _ in range(read_int32(f))]
        expect_token(f, "</RegressionTree>")
        return RegressionTree(parents, g2b, nb)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            self.write(f)

    @staticmethod
    def load(path: str) -> "RegressionTree":
        with open(path, "rb") as f:
            return RegressionTree.read(f)

    def padded_classes(self, am: AmDiagGmm) -> torch.Tensor:
        """[P, M] int64 on the model's device: each Gaussian's baseclass, −1
        past a pdf's mixture (M = the largest mixture)."""
        M = max(len(g) for g in self.gauss2bclass)
        out = np.full((len(self.gauss2bclass), M), -1, np.int64)
        for p, g in enumerate(self.gauss2bclass):
            out[p, :len(g)] = g
        return torch.from_numpy(out).to(am.device)


class RegtreeTransform:
    """A speaker's transforms `xforms[N, D, D+1]` and the baseclass →
    transform map; kind "fmllr" (on the features, with log|A| per transform)
    or "mllr" (on the means)."""

    def __init__(self, kind: str, xforms: np.ndarray, bclass2xform: np.ndarray,
                 logdets: Optional[np.ndarray] = None):
        if kind not in ("fmllr", "mllr"):
            raise ValueError(f"bad regtree transform kind {kind!r}")
        self.kind = kind
        self.xforms = np.asarray(xforms, np.float64)
        self.bclass2xform = np.asarray(bclass2xform, np.int32)
        if logdets is None and kind == "fmllr":
            logdets = np.asarray([np.linalg.slogdet(w[:, :-1])[1] for w in self.xforms])
        self.logdets = np.asarray(logdets, np.float64) if logdets is not None else None

    @property
    def num_xforms(self) -> int:
        return len(self.xforms)

    def write(self, f) -> None:
        init_kaldi_output_stream(f, True)
        write_token(f, "<RegtreeXform>")
        write_token(f, "<Fmllr>" if self.kind == "fmllr" else "<Mllr>")
        write_int32(f, self.num_xforms)
        write_int_vector(f, self.bclass2xform)
        for w in self.xforms:
            write_matrix(f, w.astype(np.float32))
        write_token(f, "</RegtreeXform>")

    @staticmethod
    def read(f) -> "RegtreeTransform":
        init_kaldi_input_stream(f)
        expect_token(f, "<RegtreeXform>")
        kind = "fmllr" if read_token(f) == "<Fmllr>" else "mllr"
        n = read_int32(f)
        b2x = read_int_vector(f)
        xforms = np.stack([read_matrix(f) for _ in range(n)])
        expect_token(f, "</RegtreeXform>")
        return RegtreeTransform(kind, xforms, b2x)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            self.write(f)

    @staticmethod
    def load(path: str) -> "RegtreeTransform":
        with open(path, "rb") as f:
            return RegtreeTransform.read(f)


# ---------------------------------------------------------------------------
# accumulators
# ---------------------------------------------------------------------------


class RegtreeFmllrAccs:
    """fMLLR statistics per baseclass (RegtreeFmllrDiagGmmAccs): one
    FmllrAccs each, float64 on `device` (None: the GPU)."""

    def __init__(self, dim: int, num_baseclasses: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.accs = [FmllrAccs(dim, self.device) for _ in range(num_baseclasses)]
        self.dim = dim

    def accumulate(self, am: AmDiagGmm, tree: RegressionTree, feats: ArrayLike,
                   pdf_ids: ArrayLike, weights: Optional[ArrayLike] = None,
                   groups: Optional[ArrayLike] = None) -> None:
        """Frames [N, D] aligned to pdf_ids [N] (several utterances told
        apart by `groups`), split among their pdf's Gaussians; each
        Gaussian's share goes to its baseclass."""
        x, pdf, post = aligned_gaussian_posteriors(am, feats, pdf_ids, groups, weights)
        _, _, iv, mu, _ = padded_gaussians(am)
        bc = tree.padded_classes(am)
        xp = torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)], 1)
        D, M = x.shape[1], post.shape[1]
        step = max(1, CHUNK_ELEMENTS // (M * D))
        for a in range(0, x.shape[0], step):
            ps, gs = pdf[a:a + step], post[a:a + step]
            ivp = iv[ps]
            kvp = ivp * mu[ps]
            cls = bc[ps]
            for b in torch.unique(cls[gs > 0]).tolist():
                gb = gs * (cls == b)
                rows = torch.nonzero(gb.sum(dim=1) > 0, as_tuple=True)[0]
                gb = gb[rows]
                self.accs[b]._add_frames(
                    xp[a:a + step][rows].to(self.device),
                    torch.einsum("nm,nmd->nd", gb, ivp[rows]).to(self.device),
                    torch.einsum("nm,nmd->nd", gb, kvp[rows]).to(self.device),
                    float(gb.sum()))


class RegtreeMllrAccs:
    """MLLR (mean transform) statistics per baseclass
    (RegtreeMllrDiagGmmAccs), float64 on `device`: for a Gaussian with
    occupancy γ, Σγx and extended mean μ⁺ = [μ, 1],
    K_c[i] += (1/σ²_i)(Σγx)_i μ⁺ and G_c[i] += γ (1/σ²_i) μ⁺μ⁺ᵀ."""

    def __init__(self, dim: int, num_baseclasses: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        kw = dict(dtype=torch.float64, device=self.device)
        self.K = torch.zeros((num_baseclasses, dim, dim + 1), **kw)
        self.G = torch.zeros((num_baseclasses, dim, dim + 1, dim + 1), **kw)
        self.beta = torch.zeros(num_baseclasses, **kw)
        self.dim = dim

    def accumulate(self, am: AmDiagGmm, tree: RegressionTree, feats: ArrayLike,
                   pdf_ids: ArrayLike, weights: Optional[ArrayLike] = None,
                   groups: Optional[ArrayLike] = None) -> None:
        x, pdf, post = aligned_gaussian_posteriors(am, feats, pdf_ids, groups, weights)
        _, _, iv, mu, _ = padded_gaussians(am)
        bc = tree.padded_classes(am).reshape(-1)
        P, M, D = iv.shape
        dev = x.device
        idx = ((pdf[:, None] * M + torch.arange(M, device=dev)[None, :]).reshape(-1),)
        occ = torch.zeros(P * M, dtype=torch.float64, device=dev)
        sx = torch.zeros((P * M, D), dtype=torch.float64, device=dev)
        occ.index_put_(idx, post.reshape(-1), accumulate=True)
        sx.index_put_(idx, (post[:, :, None] * x[:, None, :]).reshape(-1, D), accumulate=True)
        seen = torch.nonzero(occ > 0, as_tuple=True)[0]
        g_iv, g_mu, g_bc = iv.reshape(-1, D)[seen], mu.reshape(-1, D)[seen], bc[seen]
        g_occ, g_sx = occ[seen], sx[seen]
        mup = torch.cat([g_mu, torch.ones((len(seen), 1), dtype=torch.float64, device=dev)], 1)
        for b in torch.unique(g_bc).tolist():
            s = g_bc == b
            self.K[b] += torch.einsum("gi,ga->ia", g_iv[s] * g_sx[s], mup[s]).to(self.device)
            self.G[b] += torch.einsum("gi,ga,gb->iab", g_occ[s, None] * g_iv[s], mup[s],
                                      mup[s]).to(self.device)
            self.beta[b] += g_occ[s].sum().to(self.device)


# ---------------------------------------------------------------------------
# estimation: one transform per sufficiently occupied regression node
# ---------------------------------------------------------------------------


def _regression_nodes(tree: RegressionTree, beta_leaf: np.ndarray,
                      min_count: float) -> Tuple[np.ndarray, np.ndarray]:
    """For each baseclass, its first ancestor (itself included) whose
    subtree holds min_count; and every node's occupancy."""
    n = tree.num_nodes
    beta = np.zeros(n)
    beta[:tree.num_baseclasses] = beta_leaf
    for i in range(n - 1):  # children come before their parents
        beta[tree.parents[i]] += beta[i]
    node_of = np.empty(tree.num_baseclasses, np.int64)
    for b in range(tree.num_baseclasses):
        node = b
        while beta[node] < min_count and node != tree.root:
            node = tree.parents[node]
        node_of[b] = node
    return node_of, beta


def _leaves_under(tree: RegressionTree, node: int) -> List[int]:
    under = []
    for b in range(tree.num_baseclasses):
        k = b
        while True:
            if k == node:
                under.append(b)
                break
            if k == tree.root:
                break
            k = tree.parents[k]
    return under


def _node_order(tree: RegressionTree, node_of: np.ndarray) -> Tuple[List[int], np.ndarray]:
    """The regression nodes in order of first use by the baseclasses, and
    each baseclass's transform index."""
    cache: Dict[int, int] = {}
    b2x = np.empty(tree.num_baseclasses, np.int32)
    for b in range(tree.num_baseclasses):
        b2x[b] = cache.setdefault(int(node_of[b]), len(cache))
    return list(cache), b2x


def estimate_regtree_fmllr(accs: RegtreeFmllrAccs, tree: RegressionTree,
                           min_count: float = 1000.0, num_iters: int = 20) -> RegtreeTransform:
    """One fMLLR transform per regression node (RegtreeFmllrDiagGmmAccs::
    Update; the identity where even the root lacks max(min_count, 1)
    frames), every node solved together on the statistics' device."""
    return estimate_regtree_fmllr_speakers([accs], tree, min_count, num_iters)[0]


def estimate_regtree_fmllr_speakers(speakers: List[RegtreeFmllrAccs], tree: RegressionTree,
                                    min_count: float = 1000.0,
                                    num_iters: int = 20) -> List[RegtreeTransform]:
    """`estimate_regtree_fmllr` of each speaker's statistics, the regression
    nodes of every speaker solved in one batch (`compute_fmllr_transforms`:
    its row updates are launched once for all, not once a speaker)."""
    plans, solve = [], []
    for accs in speakers:
        node_of, beta = _regression_nodes(tree, np.asarray([a.beta for a in accs.accs]),
                                          min_count)
        nodes, b2x = _node_order(tree, node_of)
        merged = []
        for node in nodes:
            m = FmllrAccs(accs.dim, accs.device)
            for leaf in _leaves_under(tree, node):
                m.add(accs.accs[leaf])
            merged.append(m)
        solve += [m for m in merged if m.beta >= max(min_count, 1.0)]
        plans.append((merged, b2x, beta[tree.root]))
    solved = iter(compute_fmllr_transforms(solve, num_iters=num_iters, min_count=0.0))
    out = []
    for merged, b2x, occupancy in plans:
        dim = merged[0].K.shape[0]
        identity = np.concatenate([np.eye(dim), np.zeros((dim, 1))], axis=1)
        xforms = [next(solved) if m.beta >= max(min_count, 1.0) else identity.copy()
                  for m in merged]
        log.info("regtree-fmllr: %d transforms for %d baseclasses (occupancy %.0f)",
                 len(xforms), tree.num_baseclasses, occupancy)
        out.append(RegtreeTransform("fmllr", np.stack(xforms), b2x))
    return out


def estimate_regtree_mllr(accs: RegtreeMllrAccs, tree: RegressionTree,
                          min_count: float = 1000.0) -> RegtreeTransform:
    """One MLLR mean transform per regression node, row by row w_i = (G_i +
    1e-6 I)⁻¹ k_i on the host in float64 (RegtreeMllrDiagGmmAccs::Update);
    the identity where even the root lacks max(min_count, 1) frames."""
    dim = accs.dim
    K_h, G_h, beta_h = (t.cpu().numpy() for t in (accs.K, accs.G, accs.beta))
    node_of, beta = _regression_nodes(tree, beta_h, min_count)
    nodes, b2x = _node_order(tree, node_of)
    identity = np.concatenate([np.eye(dim), np.zeros((dim, 1))], axis=1)
    xforms: List[np.ndarray] = []
    tot_impr = tot_beta = 0.0
    for node in nodes:
        leaves = _leaves_under(tree, node)
        K, Gm, nb = K_h[leaves].sum(axis=0), G_h[leaves].sum(axis=0), beta_h[leaves].sum()
        if nb < max(min_count, 1.0):
            xforms.append(identity.copy())
            continue
        w = np.stack([np.linalg.solve(Gm[i] + 1e-6 * np.eye(dim + 1), K[i])
                      for i in range(dim)])
        q_new = sum(w[i] @ K[i] - 0.5 * w[i] @ Gm[i] @ w[i] for i in range(dim))
        q_old = sum(identity[i] @ K[i] - 0.5 * identity[i] @ Gm[i] @ identity[i]
                    for i in range(dim))
        tot_impr += q_new - q_old
        tot_beta += nb
        xforms.append(w)
    if tot_beta > 0:
        log.info("regtree-mllr: %d transforms, objf impr %.4f/frame over %.0f frames",
                 len(xforms), tot_impr / tot_beta, tot_beta)
    return RegtreeTransform("mllr", np.stack(xforms), b2x)


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------


def apply_mllr_to_model(am: AmDiagGmm, tree: RegressionTree,
                        xf: RegtreeTransform) -> AmDiagGmm:
    """The adapted model, μ' = A_c μ + b_c for each Gaussian
    (RegtreeMllrDiagGmm::GetTransformedMeans), on the model's device; it
    scores through the GMM kernel."""
    if xf.kind != "mllr":
        raise ValueError("apply_mllr_to_model needs an mllr transform")
    pdfs = []
    for p, gmm in enumerate(am.pdfs):
        means = gmm.means.copy()
        for m in range(gmm.num_mix):
            w = xf.xforms[xf.bclass2xform[tree.gauss2bclass[p][m]]]
            means[m] = w[:, :-1] @ gmm.means[m] + w[:, -1]
        pdfs.append(DiagGmm(gmm.weights.copy(), means, gmm.vars.copy()))
    return AmDiagGmm(pdfs, am.device)


def regtree_fmllr_loglikes(am: AmDiagGmm, tree: RegressionTree, xf: RegtreeTransform,
                           feats: ArrayLike) -> torch.Tensor:
    """[T, D] → [T, P] float64 loglikes on the model's device, each Gaussian
    scored on its class's transformed features y = A x + b plus log|A|
    (DecodableAmDiagGmmRegtreeFmllr)."""
    if xf.kind != "fmllr":
        raise ValueError("regtree_fmllr_loglikes needs an fmllr transform")
    dev = am.device
    x = (feats if isinstance(feats, torch.Tensor) else torch.from_numpy(np.asarray(feats)))
    x = x.to(device=dev, dtype=torch.float64)
    gc, miv, iv, _, _ = padded_gaussians(am)
    P, M, D = iv.shape
    xg = torch.from_numpy(xf.bclass2xform.astype(np.int64)).to(dev)[
        tree.padded_classes(am).clamp(min=0)].reshape(-1)
    real = torch.isfinite(gc.reshape(-1))
    W = torch.from_numpy(xf.xforms).to(dev)
    logdets = torch.from_numpy(xf.logdets).to(dev)
    T = x.shape[0]
    out = torch.empty((T, P), dtype=torch.float64, device=dev)
    step = max(1, CHUNK_ELEMENTS // (P * M))
    cols = [torch.nonzero(real & (xg == n), as_tuple=True)[0] for n in range(len(W))]
    for a in range(0, T, step):
        xs = x[a:a + step]
        comp = torch.full((xs.shape[0], P * M), -torch.inf, dtype=torch.float64, device=dev)
        for n, c in enumerate(cols):
            if not len(c):
                continue
            y = xs @ W[n, :, :-1].T + W[n, :, -1]
            comp[:, c] = (gc.reshape(-1)[c] + logdets[n] + y @ miv.reshape(-1, D)[c].T
                          - 0.5 * (y * y) @ iv.reshape(-1, D)[c].T)
        comp = comp.view(-1, P, M)
        cmax = comp.max(dim=2, keepdim=True).values
        out[a:a + step] = cmax[:, :, 0] + torch.log(torch.exp(comp - cmax).sum(dim=2))
    return out


class RegtreeXformHolder(Holder):
    """Table holder ("regx") of a speaker's RegtreeTransform."""

    name = "regx"

    def write(self, f, value: RegtreeTransform, binary: bool) -> None:
        value.write(f)

    def read(self, f) -> RegtreeTransform:
        return RegtreeTransform.read(f)


register_holder("regx", RegtreeXformHolder)
