"""Fused MFCC: windowed frames → spectrum → power → mel → log → liftered DCT.

Replaces the TPU kernel old_kaldi_git_tpu/ops/mfcc_kernel.py
(`fused_mfcc_from_frames` → `_mfcc_kernel`): four chained products and
elementwise stages in one kernel per frame tile, nothing between the stages
in device memory.  On Hopper it is csrc/mfcc.cu, which computes the same
function by one of two routes, chosen by the window W (`mfcc_route`):

- "fft", for W in FFT_PLANS (128, 256, 512, 1024): a real-input FFT in
  float64.  The frame is read as W/2 complex points z[n] = x[2n] + i·x[2n+1],
  a W/2-point complex FFT runs in the passes of FFT_PLANS[W] (Stockham
  order, a radix-16, -8 or -4 DFT in registers in each pass), and the split
  X[k] = ½(Z[k] + Z*[W/2−k]) − ½i·e^{−2πik/W}(Z[k] − Z*[W/2−k]) gives the
  kept bins k < W/2 (the Nyquist bin is dropped, as MelBanks drops it).
  Power, the mel energies (each filter summed over its span of nonzero bins,
  `mel_spans`), the floored log and the DCT are float64; the output is
  float32.  Twiddles come from `twiddles`, a float64 host table.
  About 7.2k operations a frame at W = 256 (the dense DFT product would be
  131k), so at the card's float64 rate the arithmetic fits under the time it
  takes to read the frames: the route is bound by its bytes, 4·(N·W + N·C).
- "dft", for any other even W (e.g. 400, `round_to_power_of_two=False`):
  the direct DFT in float64, X[k] = Σ_n x[n]·e^{−2πink/W} with the twiddles
  of the same table, then the same float64 tail.  Not on the decoders'
  paths: their windows are powers of two.

Why float64: the contract (below) leaves a new kernel about 3e-4 beside the
plain version's own error, and on real frames a 3×TF32 product or an fp32
FFT misses it in the high cepstra (tests/test_torch_mfcc_fft.py).

Contract kept from the TPU kernel: within 1e-3 absolute of the plain
version `fused_mfcc_reference` (float32 sums in another order at log-mel
magnitudes ~20).  On a CUDA tensor the wrapper launches the kernel or
raises.  The plain version is taken only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.feat.compute import MfccOptions, dct_matrix, lifter_coeffs
from old_kaldi_git_tpu_torch.feat.mel import mel_banks_matrix

EPS = 1e-30
MAX_SMEM_BYTES = 232448  # what one block may use on sm_90

# the "fft" route (csrc/mfcc.cu, template over W): radices of its passes,
# a radix-16 pass first
FFT_PLANS: Dict[int, Tuple[int, ...]] = {
    128: (16, 4), 256: (16, 8), 512: (16, 16), 1024: (16, 8, 4)}

MfccWeights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def make_mfcc_weights(opts: Optional[MfccOptions] = None,
                      device: DeviceLike = None,
                      dtype: torch.dtype = torch.float32) -> MfccWeights:
    """(c_re [W, W/2], c_im [W, W/2], mel [W/2, num_bins],
    dct [num_bins, num_ceps]) on `device` (None = the GPU; the CPU only by
    name); the Nyquist bin is dropped (as MelBanks does) and the DCT already
    includes liftering.  The cos/sin tables are computed in float64 and
    rounded to `dtype`; the mel and DCT tables are their float32 values in
    either dtype (float64 gives the plain version in float64 the exact DFT)."""
    opts = opts or MfccOptions()
    device = resolve_device(device)
    w = opts.frame_opts.padded_window_size
    f = w // 2
    n = np.arange(w)
    k = np.arange(f)
    ang = -2.0 * math.pi * np.outer(n, k) / w
    c_re = np.cos(ang)  # [W, F]
    c_im = np.sin(ang)
    mel, _ = mel_banks_matrix(opts.mel_opts, opts.frame_opts.samp_freq, w)  # [F, nb]
    nb = mel.shape[1]
    dct = dct_matrix(opts.num_ceps, nb)  # [C, nb]
    if opts.cepstral_lifter != 0.0:
        dct = dct * lifter_coeffs(opts.num_ceps, opts.cepstral_lifter)[:, None]
    tables = (c_re, c_im, mel.astype(np.float32), np.ascontiguousarray(dct.T, np.float32))
    return tuple(torch.as_tensor(t).to(dtype).contiguous().to(device) for t in tables)


def fused_mfcc_reference(frames: torch.Tensor, weights: MfccWeights) -> torch.Tensor:
    """The same math in plain PyTorch (any device, any float dtype):
    [N, W] → [N, num_ceps]."""
    c_re, c_im, mel, dct = weights
    re = frames @ c_re
    im = frames @ c_im
    power = re * re + im * im
    log_mel = torch.log(torch.clamp(power @ mel, min=EPS))
    return log_mel @ dct


def mfcc_route(w: int) -> str:
    """The kernel route a window of `w` samples takes: "fft" for the
    powers of two in FFT_PLANS, "dft" for every other window."""
    return "fft" if w in FFT_PLANS else "dft"


def twiddles(w: int) -> np.ndarray:
    """[w, 2] float64: (cos, −sin)(2πq/w) = e^{−2πiq/w} for q < w.  For w
    divisible by 8 only the first octant is computed and the rest follows by
    symmetry, so that the quarter points are exact and mirrored entries are
    equal numbers."""
    if w % 8:
        a = 2.0 * math.pi * np.arange(w) / w
        return np.stack([np.cos(a), -np.sin(a)], axis=1)
    e, quarter = w // 8, w // 4
    a = 2.0 * math.pi * np.arange(e + 1) / w
    c8, s8 = np.cos(a), np.sin(a)
    c8[e] = s8[e] = math.sqrt(0.5)  # cos(π/4) = sin(π/4), correctly rounded
    c = np.empty(w)
    s = np.empty(w)
    q = np.arange(quarter + 1)
    low = q <= e
    c[: quarter + 1] = np.where(low, c8[np.minimum(q, e)], s8[np.minimum(quarter - q, e)])
    s[: quarter + 1] = np.where(low, s8[np.minimum(q, e)], c8[np.minimum(quarter - q, e)])
    c[quarter], s[quarter] = 0.0, 1.0
    for k in range(1, 4):  # rotate the first quadrant by k quarters
        lo, hi = k * quarter, min((k + 1) * quarter, w - 1)
        src = np.arange(lo, hi + 1) - quarter
        c[lo: hi + 1] = -s[src]
        s[lo: hi + 1] = c[src]
    return np.stack([c, -s], axis=1)


def mel_spans(mel: np.ndarray) -> np.ndarray:
    """[num_bins, 2] int32 (first bin, bin count) of each filter's span: from
    its first to its last nonzero bin (count 0 for a filter without one).
    csrc/mfcc.cu builds the same table from the dense [W/2, num_bins] table
    in each block and sums a filter over its span only."""
    nz = np.asarray(mel) != 0
    spans = np.zeros((nz.shape[1], 2), np.int32)
    for m in range(nz.shape[1]):
        (rows,) = np.nonzero(nz[:, m])
        if rows.size:
            spans[m] = rows[0], rows[-1] - rows[0] + 1
    return spans


def check_mel_spans(mel: torch.Tensor) -> None:
    """Refuse a [W/2, num_bins] filterbank whose spans (`mel_spans`) hold
    more than W + num_bins bins in all: csrc/mfcc.cu keeps the spans'
    weights in a table of that size (each bin lies in at most two of
    mel_banks_matrix's triangular filters).  The table is read to the host
    once for each version of `mel`."""
    if getattr(mel, "_spans_checked", None) == mel._version:
        return
    total = int(mel_spans(mel.detach().cpu().numpy())[:, 1].sum())
    if total > 2 * mel.shape[0] + mel.shape[1]:
        raise ValueError(
            f"the mel filters' spans hold {total} bins, more than the kernel's span "
            f"table of 2·(W/2) + num_bins = {2 * mel.shape[0] + mel.shape[1]}")
    mel._spans_checked = mel._version


_twiddle_tables: Dict[Tuple[int, str], torch.Tensor] = {}


def _twiddles_on(w: int, device: torch.device) -> torch.Tensor:
    key = (w, str(device))
    if key not in _twiddle_tables:
        _twiddle_tables[key] = torch.from_numpy(twiddles(w)).to(device)
    return _twiddle_tables[key]


def _check(frames: torch.Tensor, weights: MfccWeights) -> None:
    c_re, c_im, mel, dct = weights
    if frames.dim() != 2:
        raise ValueError(f"expected frames [N, W], got {tuple(frames.shape)}")
    w = frames.shape[1]
    f = c_re.shape[1]
    if (c_re.shape != (w, f) or c_im.shape != (w, f) or mel.dim() != 2
            or mel.shape[0] != f or dct.dim() != 2 or dct.shape[0] != mel.shape[1]):
        raise ValueError(
            "table shapes do not chain: frames "
            f"{tuple(frames.shape)}, c_re {tuple(c_re.shape)}, c_im "
            f"{tuple(c_im.shape)}, mel {tuple(mel.shape)}, dct {tuple(dct.shape)}")
    for t in (frames, *weights):
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32 tensors, got {t.dtype}")
        if t.device != frames.device:
            raise ValueError(f"tables on {t.device} but frames on {frames.device}")


def fused_mfcc_from_frames(frames: torch.Tensor, weights: MfccWeights) -> torch.Tensor:
    """[N, W] windowed frames → [N, num_ceps] cepstra (no energy column; the
    caller overwrites c0 with the raw log energy when use_energy).

    CUDA tensors go through csrc/mfcc.cu on the current stream, without a
    synchronise, by the route `mfcc_route(W)`; `fused_mfcc_from_frames.launches`
    counts those launches and `.launches_by_route` counts them by route.
    There the DFT tables c_re and c_im are not read: the kernel takes the
    DFT that W implies (`twiddles`), the one make_mfcc_weights, their only
    producer, tabulates.  The mel table must pass `check_mel_spans`."""
    _check(frames, weights)
    if frames.device.type == "cpu":
        return fused_mfcc_reference(frames, weights)
    if frames.device.type != "cuda":
        raise RuntimeError(f"unsupported device {frames.device}")
    _, _, mel, dct = weights
    n, w = frames.shape
    nb, c = mel.shape[1], dct.shape[1]
    if not all(t.is_contiguous() for t in (frames, *weights)):
        raise ValueError("fused_mfcc_from_frames needs contiguous tensors")
    route = mfcc_route(w)
    if route == "fft" and frames.data_ptr() % 16 != 0:
        raise ValueError("the kernel copies frame rows 16 bytes at a time: "
                         "the frames must be 16-byte aligned")
    from old_kaldi_git_tpu_torch.ops import _build

    smem = _build.bind("mfcc", "okt_fused_mfcc_smem", [ctypes.c_int] * 4,
                       restype=ctypes.c_longlong)(route == "fft", w, nb, c)
    if smem < 0:
        raise ValueError(f"the {route!r} route does not take a window of {w} with "
                         f"{nb} mel bins and {c} cepstra")
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"window {w} with {nb} mel bins: a block of the {route!r} route needs "
            f"{smem} bytes of shared memory, a block has {MAX_SMEM_BYTES}")
    check_mel_spans(mel)
    out = torch.empty((n, c), dtype=torch.float32, device=frames.device)
    if n == 0:
        return out
    fn = _build.bind("mfcc", f"okt_fused_mfcc_{route}",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(frames.device):
        err = fn(frames.data_ptr(), _twiddles_on(w, frames.device).data_ptr(),
                 mel.data_ptr(), dct.data_ptr(), out.data_ptr(), n, w, nb, c,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "fused_mfcc_from_frames")
    fused_mfcc_from_frames.launches += 1
    fused_mfcc_from_frames.launches_by_route[route] += 1
    return out


fused_mfcc_from_frames.launches = 0
fused_mfcc_from_frames.launches_by_route = {"fft": 0, "dft": 0}
