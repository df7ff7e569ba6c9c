"""Batched diagonal-GMM log-likelihoods: per-pdf logsumexp over its Gaussians.

`out[n, p] = logsumexp_{g in p} ([x_n, x_n², 1] · W_g)` for feats [N, D]
float32, where a Gaussian's row W_g = (means·inv_vars, −½·inv_vars, gconst
with the log weight) — reference DiagGmm::LogLikelihoods over every pdf of an
AmDiagGmm.

Replaces the TPU kernel old_kaldi_git_tpu/ops/gmm_kernel.py
(`gmm_loglikes_pallas` → `_gmm_kernel`, packing `pack_gmm_weights`).  That
kernel pads every pdf to a power-of-two mixture count and reduces groups with
indicator matmuls, a temperature stabiliser and a bf16×3 split, all because
of the MXU.  On Hopper it is csrc/gmm.cu, on a RAGGED layout: per-pdf offsets
into a [G, E4] table of the real Gaussians' rows (E4 = 2D+1 rounded up to a
multiple of 4, zero columns), an exact online logsumexp in fp32 registers,
full fp32 products (no TF32, no split).  Bound: operations, 2·N·G·(2D+1) fp32
against the card's fp32 rate; the [N, P] float32 output is the bytes.

The plain version is the JAX package's jnp path (gmm/diag_gmm.py
`_loglikes_stacked`): [x, x², 1] @ W.T against the PADDED [P·M, 2D+1] rows
(M = a power of two ≥ the largest mixture count, padded rows gconst −1e30),
reshaped [P, M], max and logsumexp.  Its [N, P·M] intermediate is 512 KB a
frame for a 2,000-pdf, M = 64 model, so it runs over chunks of frames of
about 2 GB each; the result does not depend on the chunking.  Contract kept
from the TPU kernel's test (tests/test_ops.py): kernel and plain version agree
within 2e-3 + 2e-3·|ref| (fp32 sums in another order over terms up to ~1e4).

On a CUDA tensor the wrapper launches the kernel or raises.  The plain
version is taken only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

NEG = -1e30  # gconst of a padded row: vanishes in the logsumexp
FRAMES_PER_BLOCK = 32  # csrc/gmm.cu
PDFS_PER_BLOCK = 128
PLAIN_CHUNK_BYTES = 2 << 30  # the plain version's [n, P·M] intermediate
MAX_SMEM_BYTES = 232448  # what one block may use on sm_90


@dataclasses.dataclass(frozen=True)
class GmmWeights:
    """An AmDiagGmm's rows in the two layouts, float32 on one device."""

    stacked: torch.Tensor  # [P·M, 2D+1], padded rows gconst NEG (plain version)
    rows: torch.Tensor  # [G, E4] the real Gaussians only, pdf by pdf (kernel)
    offsets: torch.Tensor  # [P+1] int32, pdf p owns rows[offsets[p]:offsets[p+1]]
    num_pdfs: int
    max_mix: int  # M
    dim: int  # D

    @property
    def num_gauss(self) -> int:
        return self.rows.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rows.device


def pack_gmm_weights(stacked: np.ndarray, num_mix: np.ndarray,
                     device: torch.device) -> GmmWeights:
    """Both layouts from the padded float32 rows [P·M, 2D+1] (the JAX
    package's `AmDiagGmm.stacked()` layout) and each pdf's mixture count."""
    num_mix = np.asarray(num_mix, np.int64)
    p = len(num_mix)
    if p == 0 or num_mix.min() < 1:
        raise ValueError("every pdf needs at least one Gaussian")
    m = stacked.shape[0] // p
    if stacked.shape[0] != p * m or num_mix.max() > m:
        raise ValueError(f"stacked rows {stacked.shape} do not hold "
                         f"{p} pdfs of up to {num_mix.max()} Gaussians")
    e = stacked.shape[1]
    d = (e - 1) // 2
    real = (np.arange(m)[None, :] < num_mix[:, None]).reshape(-1)
    e4 = -(-e // 4) * 4
    rows = np.zeros((int(num_mix.sum()), e4), np.float32)
    rows[:, :e] = stacked[real]
    offsets = np.zeros(p + 1, np.int32)
    np.cumsum(num_mix, out=offsets[1:])
    stacked = np.ascontiguousarray(stacked, np.float32)
    return GmmWeights(*(torch.from_numpy(a).to(device) for a in (stacked, rows, offsets)),
                      num_pdfs=p, max_mix=m, dim=d)


def gmm_loglikes_plain(feats: torch.Tensor, weights: GmmWeights) -> torch.Tensor:
    """The same function in plain PyTorch (any device), chunked over frames."""
    n = feats.shape[0]
    p, m = weights.num_pdfs, weights.max_mix
    out = torch.empty((n, p), dtype=torch.float32, device=feats.device)
    chunk = max(1, PLAIN_CHUNK_BYTES // (4 * p * m))
    w_t = weights.stacked.T
    for lo in range(0, n, chunk):
        x = feats[lo: lo + chunk]
        ext = torch.cat([x, x * x, torch.ones_like(x[:, :1])], dim=1)
        comp = (ext @ w_t).view(-1, p, m)
        cmax = comp.amax(dim=2, keepdim=True)
        out[lo: lo + chunk] = cmax[:, :, 0] + torch.log(torch.exp(comp - cmax).sum(dim=2))
        del ext, comp, cmax
    return out


def _check(feats: torch.Tensor, weights: GmmWeights) -> None:
    if feats.dim() != 2 or feats.shape[1] != weights.dim:
        raise ValueError(f"expected feats [N, {weights.dim}], got {tuple(feats.shape)}")
    if feats.dtype != torch.float32:
        raise TypeError(f"expected float32 feats, got {feats.dtype}")
    if feats.device != weights.device:
        raise ValueError(f"feats on {feats.device} but weights on {weights.device}")


def gmm_loglikes(feats: torch.Tensor, weights: GmmWeights) -> torch.Tensor:
    """[N, D] float32 feats → [N, P] float32 loglikes.

    CUDA tensors go through csrc/gmm.cu on the current stream, without a
    synchronise; `gmm_loglikes.launches` counts those launches."""
    _check(feats, weights)
    if feats.device.type == "cpu":
        return gmm_loglikes_plain(feats, weights)
    if feats.device.type != "cuda":
        raise RuntimeError(f"unsupported device {feats.device}")
    if not (feats.is_contiguous() and weights.rows.is_contiguous()
            and weights.offsets.is_contiguous()):
        raise ValueError("gmm_loglikes needs contiguous tensors")
    n, p = feats.shape[0], weights.num_pdfs
    if -(-p // PDFS_PER_BLOCK) > 65535:
        raise ValueError(f"{p} pdfs exceed the kernel's grid limit")
    if FRAMES_PER_BLOCK * weights.rows.shape[1] * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"feature dim {weights.dim}: a tile of frames does not "
                         "fit a block's shared memory")
    from old_kaldi_git_tpu_torch.ops import _build

    fn = _build.bind(
        "gmm", "okt_gmm_loglikes",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = torch.empty((n, p), dtype=torch.float32, device=feats.device)
    if n == 0:
        return out
    with torch.cuda.device(feats.device):
        err = fn(feats.data_ptr(), weights.rows.data_ptr(),
                 weights.offsets.data_ptr(), out.data_ptr(), n, weights.dim,
                 weights.rows.shape[1], p, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "gmm_loglikes")
    gmm_loglikes.launches += 1
    return out


gmm_loglikes.launches = 0
