"""Batched diagonal-GMM log-likelihoods: per-pdf logsumexp over its Gaussians.

`out[n, p] = logsumexp_{g in p} ([x_n, x_n², 1] · W_g)` for feats [N, D]
float32, where a Gaussian's row W_g = (means·inv_vars, −½·inv_vars, gconst
with the log weight) — reference DiagGmm::LogLikelihoods over every pdf of an
AmDiagGmm.

Replaces the TPU kernel old_kaldi_git_tpu/ops/gmm_kernel.py
(`gmm_loglikes_pallas` → `_gmm_kernel`, packing `pack_gmm_weights`).  That
kernel pads every pdf to a power-of-two mixture count and reduces groups with
indicator matmuls, a temperature stabiliser and a bf16×3 split, all because
of the MXU.  On Hopper it is csrc/gmm.cu: a tensor-core product in 3×TF32
over PDF-PACKED COLUMN TILES, with the per-pdf logsumexp fused behind it.

The layout, built here on the host (`pack_gmm_weights`):

- The real Gaussians are packed pdf by pdf, in order, into tiles of
  COLS_PER_TILE columns.  A pdf that does not fit the rest of a tile starts
  the next one; only a pdf larger than a tile is split, and it runs on from
  where it starts into the following tiles.  Padding columns are zero and
  belong to no pdf (`col_pdf` −1).
- The depth 2D+1 is padded with zero columns to a multiple of 8, the TF32
  depth of one MMA (80 for D = 39).
- Each tile's columns are split into `hi = tf32_round(W)` and
  `lo = tf32_round(W − hi)`, so that lo·hi + hi·lo + hi·hi, three TF32
  products summed in fp32, carry the product to about 2⁻²² of its terms.  One
  TF32 product is not enough: features reach ±127, scores −6,700 nats, and
  its rounding moves a loglike by nats.  hi and lo are stored in the order
  the kernel's shared memory wants them (`tiles`), so a tile is one copy.
- Per tile, one segment per pdf it holds (`segments`: pdf, first and end
  column, whether the pdf began in an earlier tile and whether it runs on
  into the next), tile by tile (`seg_offsets`).  The segments that need a
  logsumexp (all but a pdf of one Gaussian that lies in one tile) are
  listed again as the tile's work (`work`: first column | end column << 8
  | flags << 16), in two halves with about as many columns each, one for
  each of the two threads that share a frame in the kernel
  (`work_offsets`).

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
COLS_PER_TILE = 64  # C, Gaussian columns of one tile (csrc/gmm.cu kCols)
FRAMES_PER_BLOCK = 128  # csrc/gmm.cu kRows
K_STEP = 8  # TF32 depth of one MMA: the padded depth is a multiple of it
CARRY_IN, CARRY_OUT = 1, 2  # segment flags
PLAIN_CHUNK_BYTES = 2 << 30  # the plain version's [n, P·M] intermediate
MAX_SMEM_BYTES = 232448  # what one block may use on sm_90


@dataclasses.dataclass(frozen=True)
class GmmWeights:
    """An AmDiagGmm's rows in the two layouts, on one device."""

    stacked: torch.Tensor  # [P·M, 2D+1] f32, padded rows gconst NEG (plain version)
    tiles: torch.Tensor  # [T, 2, C/8, K/4, 8, 4] f32: hi, lo (kernel)
    segments: torch.Tensor  # [S, 4] int32: pdf, first column, end column, flags
    seg_offsets: torch.Tensor  # [T+1] int32: tile t owns segments[so[t]:so[t+1]]
    work: torch.Tensor  # [W] int32: first column | end column << 8 | flags << 16
    work_offsets: torch.Tensor  # [2T+1] int32: tile t's halves at wo[2t], wo[2t+1]
    col_pdf: torch.Tensor  # [T·C] int32: each column's pdf, −1 for padding
    num_pdfs: int
    num_gauss: int  # G, the real columns
    max_mix: int  # M
    dim: int  # D

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    @property
    def depth(self) -> int:
        """K, the padded depth of a frame row [x, x², 1, 0…]."""
        return self.tiles.shape[3] * 4

    @property
    def num_tiles(self) -> int:
        return self.tiles.shape[0]

    def columns(self):
        """(hi, lo), each [T·C, K]: the tiles' columns in their logical order."""
        t, _, c8, k4, _, _ = self.tiles.shape
        cols = self.tiles.permute(0, 1, 2, 4, 3, 5).reshape(t, 2, c8 * 8, k4 * 4)
        return cols[:, 0].reshape(-1, k4 * 4), cols[:, 1].reshape(-1, k4 * 4)

    def tile_pdfs(self) -> np.ndarray:
        """[T, 2] int: each tile's first pdf and pdf count."""
        so = self.seg_offsets.cpu().numpy()
        return np.stack([self.segments[:, 0].cpu().numpy()[so[:-1]], np.diff(so)], 1)


def tf32_round(a: np.ndarray) -> np.ndarray:
    """float32 → the nearest TF32 value (10 mantissa bits), ties away from
    zero, as `cvt.rna.tf32.f32` rounds; still float32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    mag = ((bits & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) & np.uint32(0x7FFFE000)
    return (mag | (bits & np.uint32(0x80000000))).view(np.float32)


def pack_columns(num_mix: np.ndarray):
    """Each column's pdf (−1 for padding), the segments of each tile, and
    the work of each tile in two halves: ([T·C] int32, [S, 4] int32,
    [T+1] int32, [W] int32, [2T+1] int32)."""
    cols = COLS_PER_TILE
    col_pdf = []
    for p, m in enumerate(num_mix.tolist()):
        used = len(col_pdf) % cols
        if used and m <= cols and used + m > cols:
            col_pdf.extend([-1] * (cols - used))
        col_pdf.extend([p] * m)
    col_pdf.extend([-1] * (-len(col_pdf) % cols))
    col_pdf = np.asarray(col_pdf, np.int32)
    real = np.flatnonzero(col_pdf >= 0)
    first = np.full(len(num_mix), len(col_pdf))  # each pdf's first and last tile
    last = np.zeros(len(num_mix), np.int64)
    np.minimum.at(first, col_pdf[real], real // cols)
    np.maximum.at(last, col_pdf[real], real // cols)
    segments, seg_offsets, work, work_offsets = [], [0], [], [0]
    for t, tile in enumerate(col_pdf.reshape(-1, cols)):
        starts = np.flatnonzero((tile >= 0) & (np.r_[-2, tile[:-1]] != tile))
        todo = []
        for c0 in starts.tolist():
            p = int(tile[c0])
            c1 = c0 + int(np.count_nonzero(tile[c0:] == p))
            flags = CARRY_IN * (first[p] < t) + CARRY_OUT * (last[p] > t)
            segments.append((p, c0, c1, flags))
            if flags or c1 - c0 > 1:
                todo.append((c0, c1))
                work.append(c0 | c1 << 8 | flags << 16)
        # split where the larger half has the fewest columns (and entries)
        cost = np.cumsum([0] + [4 + c1 - c0 for c0, c1 in todo])
        split = int(np.argmin(np.maximum(cost, cost[-1] - cost)))
        work_offsets += [work_offsets[-1] + split, len(work)]
        seg_offsets.append(len(segments))
    return (col_pdf, np.asarray(segments, np.int32).reshape(-1, 4),
            np.asarray(seg_offsets, np.int32), np.asarray(work, np.int32),
            np.asarray(work_offsets, np.int32))


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
    stacked = np.ascontiguousarray(stacked, np.float32)
    e = stacked.shape[1]
    d = (e - 1) // 2
    k = -(-e // K_STEP) * K_STEP
    col_pdf, segments, seg_offsets, work, work_offsets = pack_columns(num_mix)
    real = (np.arange(m)[None, :] < num_mix[:, None]).reshape(-1)
    w = np.zeros((len(col_pdf), k), np.float32)
    w[col_pdf >= 0, :e] = stacked[real]
    hi = tf32_round(w)
    lo = tf32_round(w - hi)
    c = COLS_PER_TILE
    # [T, 2, C, K] → core matrices of 8 columns × 4 depths (128 bytes), the
    # canonical K-major layout without swizzle that wgmma reads
    tiles = np.stack([hi, lo]).reshape(2, -1, c // 8, 8, k // 4, 4)
    tiles = np.ascontiguousarray(tiles.transpose(1, 0, 2, 4, 3, 5))
    return GmmWeights(*(torch.from_numpy(a).to(device)
                        for a in (stacked, tiles, segments, seg_offsets, work,
                                  work_offsets, col_pdf)),
                      num_pdfs=p, num_gauss=int(num_mix.sum()), max_mix=m, dim=d)


def smem_bytes(depth: int) -> int:
    """Shared memory of one block of csrc/gmm.cu at padded depth K: the
    frames' hi/lo, two stages of a tile's hi/lo, the score tile, two carries
    of (max, sum) a frame and four barriers."""
    return 4 * (2 * FRAMES_PER_BLOCK * depth + 2 * 2 * COLS_PER_TILE * depth
                + FRAMES_PER_BLOCK * COLS_PER_TILE + 4 * FRAMES_PER_BLOCK) + 32


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
    if not (feats.is_contiguous() and weights.tiles.is_contiguous()
            and weights.segments.is_contiguous()):
        raise ValueError("gmm_loglikes needs contiguous tensors")
    smem = smem_bytes(weights.depth)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"feature dim {weights.dim}: the staged tiles need {smem} "
                         f"bytes of shared memory, a block has {MAX_SMEM_BYTES}")
    from old_kaldi_git_tpu_torch.ops import _build

    fn = _build.bind(
        "gmm", "okt_gmm_loglikes",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    n, p = feats.shape[0], weights.num_pdfs
    out = torch.empty((n, p), dtype=torch.float32, device=feats.device)
    if n == 0:
        return out
    with torch.cuda.device(feats.device):
        err = fn(feats.data_ptr(), weights.tiles.data_ptr(), weights.segments.data_ptr(),
                 weights.seg_offsets.data_ptr(), weights.work.data_ptr(),
                 weights.work_offsets.data_ptr(), out.data_ptr(), n, weights.dim,
                 weights.depth, weights.num_tiles, p, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "gmm_loglikes")
    gmm_loglikes.launches += 1
    return out


gmm_loglikes.launches = 0
