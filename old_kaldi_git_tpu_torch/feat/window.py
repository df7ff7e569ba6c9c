"""Frame extraction: framing, dither, DC removal, preemphasis, windowing.

Counterpart of old_kaldi_git_tpu/feat/window.py (reference
src/feat/feature-window.h: FrameExtractionOptions, NumFrames, ExtractWindow,
ProcessWindow), batched over [B, num_samples] torch tensors.  Framing is one
index gather with indices computed on the host from the padded length;
everything downstream is elementwise on [B, T, N].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass

_F32_TINY = float(np.finfo(np.float32).tiny)


@options_dataclass
class FrameExtractionOptions:
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"  # povey|hamming|hanning|rectangular|blackman
    round_to_power_of_two: bool = True
    blackman_coeff: float = 0.42
    snip_edges: bool = True

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def padded_window_size(self) -> int:
        if self.round_to_power_of_two:
            return 1 << (self.window_size - 1).bit_length()
        return self.window_size


def num_frames(num_samples: int, opts: FrameExtractionOptions) -> int:
    """Reference feature-window.cc NumFrames."""
    shift, length = opts.window_shift, opts.window_size
    if opts.snip_edges:
        if num_samples < length:
            return 0
        return 1 + (num_samples - length) // shift
    return (num_samples + shift // 2) // shift


def feature_window(opts: FrameExtractionOptions) -> np.ndarray:
    """The analysis window (reference FeatureWindowFunction)."""
    n = opts.window_size
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if opts.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif opts.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif opts.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif opts.window_type == "rectangular":
        w = np.ones(n)
    elif opts.window_type == "blackman":
        c = opts.blackman_coeff
        w = c - 0.5 * np.cos(a * i) + (0.5 - c) * np.cos(2 * a * i)
    else:
        raise ValueError(f"unknown window type {opts.window_type!r}")
    return w.astype(np.float32)


def frame_start_indices(max_samples: int, opts: FrameExtractionOptions) -> np.ndarray:
    """First-sample index of each frame for a max_samples-long signal."""
    t = np.arange(num_frames(max_samples, opts))
    if opts.snip_edges:
        return t * opts.window_shift
    # centered frames: midpoint of frame t is at (t + 0.5) * shift
    return t * opts.window_shift + opts.window_shift // 2 - opts.window_size // 2


def extract_frames(
    wave: torch.Tensor,
    opts: FrameExtractionOptions,
    *,
    dither_generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., num_samples] → (windowed frames [..., T, padded_N], raw log energy [..., T]).

    Implements reference ExtractWindow/ProcessWindow: gather → dither →
    remove-DC → (log energy here) → preemphasis → window → zero-pad to
    padded_window_size.  Non-snip-edges reflects at the edges.  Dither is
    applied only when a generator (on the wave's device) is given.
    """
    n = opts.window_size
    max_samples = wave.shape[-1]
    starts = frame_start_indices(max_samples, opts)
    idx = starts[:, None] + np.arange(n)[None, :]  # [T, N]
    if not opts.snip_edges:
        # reflect out-of-range indices (reference does symmetric reflection)
        idx = np.abs(idx)
        over = idx >= max_samples
        idx = np.where(over, 2 * max_samples - 1 - idx, idx)
    idx = np.clip(idx, 0, max_samples - 1)
    idx_t = torch.as_tensor(idx, dtype=torch.long, device=wave.device)
    frames = wave[..., idx_t]  # [..., T, N]

    if opts.dither != 0.0 and dither_generator is not None:
        frames = frames + opts.dither * torch.randn(
            frames.shape, dtype=frames.dtype, device=frames.device,
            generator=dither_generator)
    if opts.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)

    # raw log energy before preemphasis/window (reference ProcessWindow)
    energy = (frames * frames).sum(dim=-1)
    log_energy = torch.log(torch.clamp(energy, min=_F32_TINY))

    if opts.preemph_coeff != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - opts.preemph_coeff * prev

    frames = frames * torch.as_tensor(feature_window(opts), device=wave.device)

    pad = opts.padded_window_size - n
    if pad > 0:
        frames = torch.nn.functional.pad(frames, (0, pad))
    return frames, log_energy
