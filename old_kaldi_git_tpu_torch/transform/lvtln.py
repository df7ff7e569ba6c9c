"""Linear VTLN: vocal-tract-length normalisation as a set of linear feature
transforms, one per warp factor.

Counterpart of old_kaldi_git_tpu/transform/lvtln.py (reference
src/transform/lvtln.{h,cc}, gmm-init-lvtln, gmm-train-lvtln-special,
gmm-est-lvtln-trans).  A class is fitted by least squares to map warped
features onto unwarped ones (`train_lvtln_class`: the frames' products
XᵀX and YᵀX summed in float64 on the frames' device, the D × D solve on the
host); a speaker gets the class, and each row's offset, that maximise the
fMLLR auxiliary function of their statistics (`select_lvtln_transform`, on
the port's FmllrAccs copied to the host: C candidates of D rows, float64
numpy as in the JAX package).  The file is the JAX package's, byte for
byte.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.transform.basis_fmllr import HostStats, aux_objf, identity_w
from old_kaldi_git_tpu_torch.utils.io_funcs import (
    expect_token,
    init_kaldi_input_stream,
    init_kaldi_output_stream,
    read_int32,
    read_matrix,
    read_vector,
    write_int32,
    write_matrix,
    write_token,
    write_vector,
)
from old_kaldi_git_tpu_torch.utils.log import get_logger

log = get_logger("lvtln")

ArrayLike = Union[np.ndarray, torch.Tensor]


class LinearVtln:
    """`mats[C, D, D]` float64 linear transforms, one per warp factor."""

    def __init__(self, mats: np.ndarray, warps: Sequence[float]):
        self.mats = np.asarray(mats, np.float64)
        self.warps = [float(w) for w in warps]
        if self.mats.shape[0] != len(self.warps):
            raise ValueError("one transform per warp required")

    @staticmethod
    def init(dim: int, warps: Sequence[float]) -> "LinearVtln":
        """Identity transforms (gmm-init-lvtln)."""
        return LinearVtln(np.broadcast_to(np.eye(dim), (len(warps), dim, dim)).copy(), warps)

    @property
    def num_classes(self) -> int:
        return len(self.warps)

    @property
    def dim(self) -> int:
        return self.mats.shape[1]

    def set_transform(self, c: int, a: np.ndarray) -> None:
        self.mats[c] = a

    def write(self, f) -> None:
        """<LinearVtln> C, the warps as a float32 vector, C float32
        matrices, </LinearVtln>."""
        init_kaldi_output_stream(f, True)
        write_token(f, "<LinearVtln>")
        write_int32(f, self.num_classes)
        write_vector(f, np.asarray(self.warps, np.float32))
        for c in range(self.num_classes):
            write_matrix(f, self.mats[c].astype(np.float32))
        write_token(f, "</LinearVtln>")

    @staticmethod
    def read(f) -> "LinearVtln":
        init_kaldi_input_stream(f)
        expect_token(f, "<LinearVtln>")
        n = read_int32(f)
        warps = read_vector(f)
        mats = np.stack([read_matrix(f) for _ in range(n)])
        expect_token(f, "</LinearVtln>")
        return LinearVtln(mats, warps.tolist())

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            self.write(f)

    @staticmethod
    def load(path: str) -> "LinearVtln":
        with open(path, "rb") as f:
            return LinearVtln.read(f)


def train_lvtln_class(pairs: Sequence[Tuple[ArrayLike, ArrayLike]],
                      device: DeviceLike = None) -> np.ndarray:
    """The least-squares map A minimising Σ ||y_t − A x_t||² over (x = warped,
    y = unwarped) utterance pairs, each cut to its shorter length
    (gmm-train-lvtln-special): XᵀX and YᵀX in float64 on `device` (None:
    the GPU), then A = YᵀX (XᵀX + 1e-6 I)⁻¹ on the host."""
    dev = resolve_device(device)
    dim = pairs[0][0].shape[1]
    xtx = torch.zeros((dim, dim), dtype=torch.float64, device=dev)
    ytx = torch.zeros((dim, dim), dtype=torch.float64, device=dev)

    def dev64(a: ArrayLike) -> torch.Tensor:
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return a.to(device=dev, dtype=torch.float64)

    for x, y in pairs:
        t = min(len(x), len(y))
        x, y = dev64(x)[:t], dev64(y)[:t]
        xtx += x.T @ x
        ytx += y.T @ x
    return ytx.cpu().numpy() @ np.linalg.inv(xtx.cpu().numpy() + 1e-6 * np.eye(dim))


def select_lvtln_transform(accs, lvtln: LinearVtln, estimate_offset: bool = True,
                           min_count: float = 10.0
                           ) -> Optional[Tuple[np.ndarray, float, int, float]]:
    """The class (with each row's offset, when estimate_offset, in closed
    form for its fixed A) of largest fMLLR auxiliary on the speaker's
    statistics (gmm-est-lvtln-trans).  Returns (W [D, D+1], warp, class,
    objective gain per frame over the identity), or None under min_count
    frames."""
    accs = HostStats.of(accs)
    if accs.beta < min_count:
        return None
    dim = lvtln.dim
    start = aux_objf(identity_w(dim), accs)
    best: Optional[Tuple[float, np.ndarray, int]] = None
    for c in range(lvtln.num_classes):
        w = np.concatenate([lvtln.mats[c], np.zeros((dim, 1))], axis=1)
        if estimate_offset:
            # b_i maximises K_i b_i − ½ (w_i + b_i e_D)ᵀ G_i (w_i + b_i e_D)
            for i in range(dim):
                g = accs.G[i]
                denom = g[dim, dim]
                if denom <= 0:
                    continue
                w[i, dim] = (accs.K[i, dim] - float(w[i, :dim] @ g[:dim, dim])) / denom
        obj = aux_objf(w, accs)
        if best is None or obj > best[0]:
            best = (obj, w, c)
    obj, w, c = best
    impr = (obj - start) / accs.beta
    log.info("lvtln: class %d (warp %.2f), objf impr %.4f/frame over %.0f frames", c,
             lvtln.warps[c], impr, accs.beta)
    return w, lvtln.warps[c], c, impr
