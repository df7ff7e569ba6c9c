"""Sample-rate conversion (counterpart of the uniform-grid part of
old_kaldi_git_tpu/feat/resample.py; reference src/feat/resample.h
LinearResample): band-limited interpolation with a Hanning-windowed sinc of
num_zeros zero crossings and a cutoff of 0.99 × the lower Nyquist rate, as
one gather and a weighted sum on the wave's device."""

from __future__ import annotations

import math

import numpy as np
import torch


def _windowed_sinc(t: np.ndarray, cutoff: float, num_zeros: int) -> np.ndarray:
    """The low-pass filter at time offsets t (seconds)."""
    support = num_zeros / (2.0 * cutoff)
    window = np.where(np.abs(t) < support, 0.5 + 0.5 * np.cos(math.pi * t / support), 0.0)
    return window * 2.0 * cutoff * np.sinc(2.0 * cutoff * t)


def resample_weights(num_samples_in: int, samp_freq_in: float, samp_freq_out: float,
                     num_zeros: int = 6):
    """(indices [T_out, taps] int64, weights [T_out, taps] float32, T_out)."""
    cutoff = 0.99 * 0.5 * min(samp_freq_in, samp_freq_out)
    num_out = int(num_samples_in / samp_freq_in * samp_freq_out)
    support = num_zeros / (2.0 * cutoff)
    taps = int(2 * support * samp_freq_in) + 2
    t_out = np.arange(num_out) / samp_freq_out
    first = np.ceil((t_out - support) * samp_freq_in).astype(np.int64)
    idx = first[:, None] + np.arange(taps)[None, :]
    w = _windowed_sinc(t_out[:, None] - idx / samp_freq_in, cutoff, num_zeros) / samp_freq_in
    w = np.where((idx >= 0) & (idx < num_samples_in), w, 0.0)
    return np.clip(idx, 0, num_samples_in - 1), w.astype(np.float32), num_out


def linear_resample(wave: torch.Tensor, samp_freq_in: float, samp_freq_out: float,
                    num_zeros: int = 6) -> torch.Tensor:
    """[..., S_in] → [..., S_out] on the wave's device."""
    if samp_freq_in == samp_freq_out:
        return wave
    idx, w, _ = resample_weights(wave.shape[-1], samp_freq_in, samp_freq_out, num_zeros)
    idx = torch.from_numpy(idx).to(wave.device)
    return (wave[..., idx] * torch.from_numpy(w).to(wave.device)).sum(dim=-1)
