"""Mel filterbank construction with VTLN (own numpy copy of
old_kaldi_git_tpu/feat/mel.py: built once on the host, used as a table).

Parity with reference src/feat/mel-computations.h (MelBanks): triangular
filters on the mel scale over FFT bins, optional vocal-tract-length warping.
Materialized as a dense [num_fft_bins, num_bins] matrix: the fused MFCC
kernel reduces the power row against it (the reference does sparse per-bin
dot products on CPU).
"""

from __future__ import annotations

import numpy as np

from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass
from old_kaldi_git_tpu_torch.utils.log import KaldiError


@options_dataclass
class MelBanksOptions:
    num_bins: int = 25
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0: nyquist + high_freq
    vtln_low: float = 100.0
    vtln_high: float = -500.0


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(np.asarray(mel, dtype=np.float64) / 1127.0) - 1.0)


def vtln_warp_freq(
    vtln_low: float, vtln_high: float, low_freq: float, high_freq: float,
    warp_factor: float, freq: np.ndarray,
) -> np.ndarray:
    """Reference MelBanks::VtlnWarpFreq: piecewise-linear warp with slope
    1/warp_factor in the middle and linear tails pinned at low/high_freq."""
    if warp_factor == 1.0:
        return freq
    scale = 1.0 / warp_factor
    fl = scale * vtln_low
    fh = scale * vtln_high
    # tails chosen so the map is continuous and hits (low,low), (high,high)
    scale_left = (fl - low_freq) / (vtln_low - low_freq)
    scale_right = (high_freq - fh) / (high_freq - vtln_high)
    out = np.empty_like(freq)
    left = freq < vtln_low
    right = freq > vtln_high
    mid = ~(left | right)
    out[left] = low_freq + scale_left * (freq[left] - low_freq)
    out[mid] = scale * freq[mid]
    out[right] = high_freq + scale_right * (freq[right] - high_freq)
    return out


def mel_banks_matrix(
    opts: MelBanksOptions,
    samp_freq: float,
    padded_window_size: int,
    vtln_warp: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (weights [num_fft_bins, num_bins] float32, center_freqs [num_bins]).

    num_fft_bins = padded_window_size // 2 (nyquist bin excluded, as in the
    reference).
    """
    num_fft_bins = padded_window_size // 2
    nyquist = 0.5 * samp_freq
    high_freq = opts.high_freq if opts.high_freq > 0 else nyquist + opts.high_freq
    low_freq = opts.low_freq
    if not (0 <= low_freq < high_freq <= nyquist):
        raise KaldiError(
            f"bad mel frequency range [{low_freq}, {high_freq}] vs nyquist {nyquist}"
        )
    vtln_high = opts.vtln_high if opts.vtln_high > 0 else nyquist + opts.vtln_high

    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (opts.num_bins + 1)
    # mel boundary points per bin: left, center, right
    bin_idx = np.arange(opts.num_bins, dtype=np.float64)
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = mel_low + (bin_idx + 1) * mel_delta
    right_mel = mel_low + (bin_idx + 2) * mel_delta
    if vtln_warp != 1.0:
        def warp_mel(mels):
            freqs = inverse_mel_scale(mels)
            return mel_scale(
                vtln_warp_freq(opts.vtln_low, vtln_high, low_freq, high_freq,
                               vtln_warp, freqs)
            )
        left_mel, center_mel, right_mel = map(warp_mel, (left_mel, center_mel, right_mel))

    fft_freqs = np.arange(num_fft_bins, dtype=np.float64) * samp_freq / padded_window_size
    fft_mels = mel_scale(fft_freqs)  # [F]
    up = (fft_mels[:, None] - left_mel[None, :]) / (center_mel - left_mel)[None, :]
    down = (right_mel[None, :] - fft_mels[:, None]) / (right_mel - center_mel)[None, :]
    weights = np.maximum(0.0, np.minimum(up, down))
    return weights.astype(np.float32), inverse_mel_scale(center_mel).astype(np.float32)
