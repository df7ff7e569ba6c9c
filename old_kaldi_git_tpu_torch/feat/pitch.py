"""Kaldi-style pitch tracker and POV features (counterpart of
old_kaldi_git_tpu/feat/pitch.py; reference src/feat/pitch-functions.{h,cc},
compute-kaldi-pitch-feats and process-kaldi-pitch-feats).

The JAX package's reshaping of the reference's per-frame online loop, on
tensors:
  * downsample to resample_freq (4 kHz) with the windowed-sinc resampler;
  * the NCCF over a dense integer lag grid as one gather and reduction
    ([B, L, T, W] lag-shifted windows against the [B, T, W] frames);
  * the Viterbi over lags (cost = -nccf + penalty · (log lag ratio)^2), a
    `lax.scan` there, is a loop over frames carrying the [B, L] cost front,
    with the [L, L] inter-lag penalty precomputed, and the backtrace a loop
    back over the stored [T, B, L] backpointers.

compute_kaldi_pitch gives [B, T, 2] = (NCCF pov, pitch Hz); process_pitch
turns it into the 3-dim feature (POV feature, mean-subtracted log pitch,
delta pitch).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from old_kaldi_git_tpu_torch.feat.resample import linear_resample
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass


@options_dataclass
class PitchOptions:
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    resample_freq: float = 4000.0
    penalty_factor: float = 0.1
    lowpass_cutoff: float = 1000.0
    nccf_ballast: float = 7000.0
    soft_min_f0: float = 10.0


@options_dataclass
class ProcessPitchOptions:
    pitch_scale: float = 2.0
    pov_scale: float = 2.0
    delta_pitch_scale: float = 10.0
    normalization_window: int = 151  # frames, centred sliding CMN of log-pitch


def _lag_grid(opts: PitchOptions) -> np.ndarray:
    """Dense integer lags covering [1/max_f0, 1/min_f0] at resample_freq."""
    min_lag = int(math.floor(opts.resample_freq / opts.max_f0))
    max_lag = int(math.ceil(opts.resample_freq / opts.min_f0))
    return np.arange(min_lag, max_lag + 1, dtype=np.int64)


def _nccf(wave: torch.Tensor, lags: torch.Tensor, window_size: int,
          window_shift: int, num_frames: int) -> torch.Tensor:
    """[B, T, L] normalised cross-correlation of each frame's window with
    the window `lag` samples later, each with its mean removed (reference
    ComputeCorrelation), without ballast."""
    S = wave.shape[1]
    starts = torch.arange(num_frames, device=wave.device) * window_shift
    idx0 = (starts[:, None] + torch.arange(window_size, device=wave.device)[None, :]
            ).clamp(max=S - 1)  # [T, W]
    x0 = wave[:, idx0]
    x0 = x0 - x0.mean(dim=-1, keepdim=True)  # [B, T, W]
    e0 = (x0 * x0).sum(dim=-1)  # [B, T]
    xl = wave[:, (idx0[None] + lags[:, None, None]).clamp(max=S - 1)]  # [B, L, T, W]
    xl = xl - xl.mean(dim=-1, keepdim=True)
    el = (xl * xl).sum(dim=-1)
    dot = (x0[:, None] * xl).sum(dim=-1)
    nccf = dot / (torch.sqrt(e0[:, None] * el) + 1e-10)  # [B, L, T]
    return nccf.transpose(1, 2).clamp(-1.0, 1.0)


def _lag_viterbi(nccf: torch.Tensor, penalty: torch.Tensor) -> torch.Tensor:
    """[B, T] indices of the min-cost lag track:
    cost[t, l] = -nccf[t, l] + min_l' (cost[t-1, l'] + penalty[l', l]).

    As the JAX package unwinds it: frame t (t < T-1) gets the track's lag at
    t+1 and the last frame its own, so frame 0's lag is dropped and the last
    one repeated (a fault kept for parity; ROADMAP queue 3)."""
    B, T, L = nccf.shape
    front = -nccf[:, 0, :]
    bps = []
    for t in range(1, T):
        tot = front[:, :, None] + penalty[None, :, :]
        front, best_prev = tot.min(dim=1)
        front = front - nccf[:, t, :]
        bps.append(best_prev)
    last = front.argmin(dim=-1)  # [B]
    lag, track = last, []
    for bp in reversed(bps):
        track.append(lag)
        lag = bp.gather(1, lag[:, None])[:, 0]
    return torch.stack(track[::-1] + [last], dim=1)


def compute_kaldi_pitch(wave: torch.Tensor, opts: PitchOptions = None) -> torch.Tensor:
    """[B, num_samples] at opts.samp_freq → [B, T, 2] (nccf_pov, pitch_hz),
    on the wave's device."""
    opts = opts or PitchOptions()
    wave = torch.as_tensor(wave, dtype=torch.float32)
    if wave.ndim == 1:
        wave = wave[None]
    down = linear_resample(wave, opts.samp_freq, opts.resample_freq)
    # the resampler low-passes at min(freq_in, freq_out)/2; a lower cutoff
    # (the reference's 1 kHz) goes down to 2·cutoff and back up
    if opts.lowpass_cutoff < 0.5 * opts.resample_freq:
        down = linear_resample(down, opts.resample_freq, 2.0 * opts.lowpass_cutoff)
        down = linear_resample(down, 2.0 * opts.lowpass_cutoff, opts.resample_freq)
    window_size = int(opts.resample_freq * 0.001 * opts.frame_length_ms)
    window_shift = int(opts.resample_freq * 0.001 * opts.frame_shift_ms)
    lags_np = _lag_grid(opts)
    lags = torch.from_numpy(lags_np).to(wave.device)
    S = down.shape[-1]
    T = max(1, 1 + (S - window_size - int(lags_np[-1])) // window_shift)
    # the ballast, scaled by the mean signal energy, enters as the frame-
    # average energy ratio, so that one NCCF serves pov and pitch
    window_e = (down * down).mean(dim=-1, keepdim=True) * window_size  # [B, 1]
    ballast = opts.nccf_ballast * 1e-4 * window_e * window_e
    nccf_pov = _nccf(down, lags, window_size, window_shift, T)
    scale = torch.sqrt(window_e[:, :, None] / (window_e[:, :, None] + ballast[:, :, None]
                                               + 1e-10))
    lag_f = lags.to(torch.float32)
    soft = 1.0 - (opts.soft_min_f0 / opts.min_f0) * (lag_f / float(lags_np[-1]))
    nccf_pitch = nccf_pov * scale * soft[None, None, :]
    log_lags = np.log(lags_np.astype(np.float64))
    penalty = (opts.penalty_factor * np.square(log_lags[:, None] - log_lags[None, :])
               * (opts.max_f0 / 10.0)).astype(np.float32)
    best = _lag_viterbi(nccf_pitch, torch.from_numpy(penalty).to(wave.device))  # [B, T]
    pitch_hz = opts.resample_freq / lags[best].to(torch.float32)
    pov = nccf_pov.gather(2, best[:, :, None])[:, :, 0]
    return torch.stack([pov, pitch_hz], dim=-1)


def _pov_feature(nccf: torch.Tensor) -> torch.Tensor:
    """Reference NccfToPovFeature: 2 · ((1.0001 - nccf)^0.15 - 1)."""
    return 2.0 * (torch.pow(1.0001 - nccf, 0.15) - 1.0)


def pov_probability(nccf: torch.Tensor) -> torch.Tensor:
    """Reference NccfToPov: the probability of voicing from the fitted
    polynomial l = -5.2 + 5.4e^{7.5(c-1)} + 4.8c - 2e^{-10c} + 4.2e^{20(c-1)},
    pov = 1/(1 + e^-l)."""
    c = nccf.clamp(-1.0, 1.0)
    l = (-5.2 + 5.4 * torch.exp(7.5 * (c - 1.0)) + 4.8 * c - 2.0 * torch.exp(-10.0 * c)
         + 4.2 * torch.exp(20.0 * (c - 1.0)))
    return 1.0 / (1.0 + torch.exp(-l))


def _box_sum(x: torch.Tensor, width: int) -> torch.Tensor:
    """[B, N] → [B, N - width + 1]: sums over each window of `width`."""
    kernel = torch.ones((1, 1, width), dtype=x.dtype, device=x.device)
    return torch.nn.functional.conv1d(x[:, None], kernel)[:, 0]


def process_pitch(pitch: torch.Tensor, opts: ProcessPitchOptions = None) -> torch.Tensor:
    """[B, T, 2] (nccf, pitch_hz) → [B, T, 3] (pov feature,
    normalised log pitch, delta pitch): process-kaldi-pitch-feats' output."""
    opts = opts or ProcessPitchOptions()
    pitch = torch.as_tensor(pitch, dtype=torch.float32)
    nccf = pitch[..., 0]
    log_pitch = torch.log(pitch[..., 1].clamp(min=1e-3))
    pov = pov_probability(nccf)
    # POV-weighted sliding-window mean of the log pitch
    half = opts.normalization_window // 2
    pad = torch.nn.functional.pad
    num = _box_sum(pad(log_pitch * pov, (half, half)), opts.normalization_window)
    den = _box_sum(pad(pov, (half, half)), opts.normalization_window) + 1e-8
    delta = torch.diff(log_pitch, dim=1, prepend=log_pitch[:, :1])
    return torch.stack([opts.pov_scale * _pov_feature(nccf),
                        opts.pitch_scale * (log_pitch - num / den),
                        opts.delta_pitch_scale * delta], dim=-1)
