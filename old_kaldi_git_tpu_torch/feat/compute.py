"""Offline feature computers: MFCC.

Counterpart of old_kaldi_git_tpu/feat/compute.py (reference
src/feat/feature-mfcc.h and feature-common.h OfflineFeatureTpl).  Array-first:
the computer maps [B, num_samples] → [B, T, D].

The spectrum path (DFT → power → mel → log → liftered DCT) runs through the
fused kernel of old_kaldi_git_tpu_torch.ops.mfcc_kernel; the column c0 is then
overwritten with the raw log energy.  Fbank, spectrogram and PLP are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from old_kaldi_git_tpu_torch.feat.mel import MelBanksOptions
from old_kaldi_git_tpu_torch.feat.window import (
    FrameExtractionOptions,
    extract_frames,
    num_frames,
)
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass


def dct_matrix(num_rows: int, num_cols: int) -> np.ndarray:
    """Orthonormal DCT-II (reference src/matrix/matrix-functions.cc
    ComputeDctMatrix): row 0 = sqrt(1/N), row k = sqrt(2/N) cos(pi k (2n+1)/2N)."""
    n = np.arange(num_cols)
    k = np.arange(num_rows)[:, None]
    mat = np.sqrt(2.0 / num_cols) * np.cos(math.pi * k * (2 * n + 1) / (2 * num_cols))
    mat[0] = np.sqrt(1.0 / num_cols)
    return mat.astype(np.float32)


def lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    """Reference ComputeLifterCoeffs: 1 + 0.5*Q*sin(pi*i/Q)."""
    i = np.arange(num_ceps)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


def _frame_opts():
    return FrameExtractionOptions()


def _mel_opts():
    return MelBanksOptions(num_bins=23)


@options_dataclass
class MfccOptions:
    frame_opts: FrameExtractionOptions = dataclasses.field(default_factory=_frame_opts)
    mel_opts: MelBanksOptions = dataclasses.field(default_factory=_mel_opts)
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0


class Mfcc:
    """Reference src/feat/feature-mfcc.h MfccComputer.  The kernel's tables
    are built once per device at first use."""

    def __init__(self, opts: Optional[MfccOptions] = None):
        self.opts = opts or MfccOptions()
        self.frame_opts: FrameExtractionOptions = self.opts.frame_opts
        self._weights = {}

    def num_frames(self, num_samples: int) -> int:
        return num_frames(num_samples, self.frame_opts)

    def weights(self, device: torch.device):
        from old_kaldi_git_tpu_torch.ops.mfcc_kernel import make_mfcc_weights

        key = str(device)
        if key not in self._weights:
            self._weights[key] = make_mfcc_weights(self.opts, device=device)
        return self._weights[key]

    def __call__(self, wave: torch.Tensor, *,
                 dither_generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """[..., num_samples] → [..., T, num_ceps].  T from the padded length;
        use num_frames(actual_samples) to mask."""
        frames, log_energy = extract_frames(
            wave, self.frame_opts, dither_generator=dither_generator)
        return self._compute(frames, log_energy)

    def _compute(self, frames: torch.Tensor, log_energy: torch.Tensor
                 ) -> torch.Tensor:
        from old_kaldi_git_tpu_torch.ops.mfcc_kernel import fused_mfcc_from_frames

        o = self.opts
        lead = frames.shape[:-1]
        flat = frames.reshape(-1, frames.shape[-1]).contiguous()
        ceps = fused_mfcc_from_frames(
            flat, self.weights(frames.device)).reshape(*lead, o.num_ceps)
        if o.use_energy:
            if o.energy_floor > 0.0:
                log_energy = torch.clamp(log_energy, min=math.log(o.energy_floor))
            ceps[..., 0] = log_energy  # in place: ceps is this call's own buffer
        return ceps
