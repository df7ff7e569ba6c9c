"""Fused MFCC: windowed frames → DFT → power → mel → log → liftered DCT.

Replaces the TPU kernel old_kaldi_git_tpu/ops/mfcc_kernel.py
(`fused_mfcc_from_frames` → `_mfcc_kernel`): four chained products and
elementwise stages in one kernel per frame tile, nothing between the stages
in device memory.  On Hopper it is csrc/mfcc.cu.  The DFT, mel and DCT
products are computed inside that kernel in full float32 (no TF32, no bf16
split: power bins reach 1e9 and the log would lose digits), against tables
of their true widths — [W, W/2] cos/sin, [W/2, 23] mel, [23, 13] liftered DCT
— not the TPU's 128-lane padding.  Bound: operations,
2·N·W·F·2 + 2·N·F·NB + 2·N·NB·C fp32 against the card's fp32 rate; the bytes
4·(N·W + N·C) take several times less.  Contract kept from the TPU kernel: within
1e-3 absolute of the plain version (fp32 sums taken in another order, at
log-mel magnitudes ~20).

On a CUDA tensor the wrapper launches the kernel or raises.  The plain
version is taken only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.feat.compute import MfccOptions, dct_matrix, lifter_coeffs
from old_kaldi_git_tpu_torch.feat.mel import mel_banks_matrix

EPS = 1e-30
TILE_N = 32  # frames per block in csrc/mfcc.cu
MAX_SMEM_BYTES = 232448  # what one block may use on sm_90

MfccWeights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def make_mfcc_weights(opts: Optional[MfccOptions] = None,
                      device: DeviceLike = None) -> MfccWeights:
    """(c_re [W, W/2], c_im [W, W/2], mel [W/2, num_bins],
    dct [num_bins, num_ceps]) float32 on `device` (None = the GPU; the CPU
    only by name); the Nyquist bin is dropped (as MelBanks does) and the DCT
    already includes liftering."""
    opts = opts or MfccOptions()
    device = resolve_device(device)
    w = opts.frame_opts.padded_window_size
    f = w // 2
    n = np.arange(w)
    k = np.arange(f)
    ang = -2.0 * math.pi * np.outer(n, k) / w
    c_re = np.cos(ang).astype(np.float32)  # [W, F]
    c_im = np.sin(ang).astype(np.float32)
    mel, _ = mel_banks_matrix(opts.mel_opts, opts.frame_opts.samp_freq, w)  # [F, nb]
    nb = mel.shape[1]
    dct = dct_matrix(opts.num_ceps, nb)  # [C, nb]
    if opts.cepstral_lifter != 0.0:
        dct = dct * lifter_coeffs(opts.num_ceps, opts.cepstral_lifter)[:, None]
    tables = (c_re, c_im, mel.astype(np.float32), np.ascontiguousarray(dct.T, np.float32))
    return tuple(torch.as_tensor(t).contiguous().to(device) for t in tables)


def fused_mfcc_reference(frames: torch.Tensor, weights: MfccWeights) -> torch.Tensor:
    """The same math in plain PyTorch (any device): [N, W] → [N, num_ceps]."""
    c_re, c_im, mel, dct = weights
    re = frames @ c_re
    im = frames @ c_im
    power = re * re + im * im
    log_mel = torch.log(torch.clamp(power @ mel, min=EPS))
    return log_mel @ dct


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
    synchronise; `fused_mfcc_from_frames.launches` counts those launches."""
    _check(frames, weights)
    if frames.device.type == "cpu":
        return fused_mfcc_reference(frames, weights)
    if frames.device.type != "cuda":
        raise RuntimeError(f"unsupported device {frames.device}")
    c_re, c_im, mel, dct = weights
    n, w = frames.shape
    f, nb, c = c_re.shape[1], mel.shape[1], dct.shape[1]
    if not all(t.is_contiguous() for t in (frames, *weights)):
        raise ValueError("fused_mfcc_from_frames needs contiguous tensors")
    if w % 4 != 0 or frames.data_ptr() % 16 != 0:
        raise ValueError("the kernel reads frames 16 bytes at a time: the "
                         f"window ({w}) must be a multiple of 4 and aligned")
    smem = TILE_N * (w + f + nb) * 4
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"window {w}: a {TILE_N}-frame tile needs {smem} bytes of shared "
            f"memory, a block has {MAX_SMEM_BYTES}")
    from old_kaldi_git_tpu_torch.ops import _build

    fn = _build.bind(
        "mfcc", "okt_fused_mfcc",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    out = torch.empty((n, c), dtype=torch.float32, device=frames.device)
    if n == 0:
        return out
    with torch.cuda.device(frames.device):
        err = fn(frames.data_ptr(), c_re.data_ptr(), c_im.data_ptr(),
                 mel.data_ptr(), dct.data_ptr(), out.data_ptr(),
                 n, w, f, nb, c, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "fused_mfcc_from_frames")
    fused_mfcc_from_frames.launches += 1
    return out


fused_mfcc_from_frames.launches = 0
