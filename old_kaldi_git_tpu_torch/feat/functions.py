"""Feature post-processing: deltas, splicing, sliding-window CMN.

Counterpart of old_kaldi_git_tpu/feat/functions.py (reference
src/feat/feature-functions.h ComputeDeltas, SpliceFrames, SlidingWindowCmn),
batched over leading axes; edge frames are replicated via clipped indices
exactly like the reference.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass


@options_dataclass
class DeltaFeaturesOptions:
    order: int = 2
    window: int = 2


def delta_filters(opts: DeltaFeaturesOptions) -> List[np.ndarray]:
    """Per-order 1-D filters (reference DeltaFeatures ctor): order 0 = [1],
    each next order is the previous convolved with the regression kernel
    j/sum(j^2), j in [-w, w]."""
    scales = [np.array([1.0])]
    w = opts.window
    j = np.arange(-w, w + 1, dtype=np.float64)
    kernel = j / np.sum(j**2)
    for _ in range(opts.order):
        scales.append(np.convolve(scales[-1], kernel, mode="full"))
    return [s.astype(np.float32) for s in scales]


def compute_deltas(feats: torch.Tensor,
                   opts: Optional[DeltaFeaturesOptions] = None) -> torch.Tensor:
    """[..., T, D] → [..., T, D*(order+1)] with clipped-edge regression."""
    opts = opts or DeltaFeaturesOptions()
    t_axis = feats.shape[-2]
    base = torch.arange(t_axis, device=feats.device)
    outs = []
    for filt in delta_filters(opts):
        radius = (len(filt) - 1) // 2
        acc = None
        for k, coeff in enumerate(filt):
            idx = (base + (k - radius)).clamp(0, t_axis - 1)
            term = feats.index_select(-2, idx) * float(coeff)
            acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.cat(outs, dim=-1)


def splice_frames(feats: torch.Tensor, left_context: int = 4,
                  right_context: int = 4) -> torch.Tensor:
    """[..., T, D] → [..., T, D*(l+1+r)], edges replicated (reference
    SpliceFrames)."""
    t_axis = feats.shape[-2]
    base = torch.arange(t_axis, device=feats.device)
    return torch.cat([feats.index_select(-2, (base + o).clamp(0, t_axis - 1))
                      for o in range(-left_context, right_context + 1)], dim=-1)


@options_dataclass
class SlidingWindowCmnOptions:
    cmn_window: int = 600
    min_window: int = 100
    normalize_variance: bool = False
    center: bool = False


def sliding_window_cmn(feats: torch.Tensor,
                       opts: Optional[SlidingWindowCmnOptions] = None) -> torch.Tensor:
    """Per-frame mean (and optionally variance) normalisation over a sliding
    window (reference SlidingWindowCmn), by cumulative sums: [..., T, D] →
    [..., T, D].  center=True centres the window on the frame; otherwise
    the window ends at the frame (min_window at the start)."""
    opts = opts or SlidingWindowCmnOptions()
    t_axis = feats.shape[-2]
    t = np.arange(t_axis)
    if opts.center:
        start = t - opts.cmn_window // 2
        end = start + opts.cmn_window
        shift = np.where(start < 0, -start, 0)
        start, end = start + shift, end + shift
        shift = np.where(end > t_axis, end - t_axis, 0)
        start, end = np.maximum(start - shift, 0), np.minimum(end, t_axis)
    else:
        end = t + 1
        start = np.maximum(end - opts.cmn_window, 0)
        end = np.maximum(end, np.minimum(opts.min_window, t_axis))
    dev = feats.device
    counts = torch.from_numpy((end - start).astype(np.float32)).to(dev)[:, None]
    start = torch.from_numpy(start).to(dev)
    end = torch.from_numpy(end).to(dev)
    zeros = torch.zeros_like(feats[..., :1, :])
    csum = torch.cat([zeros, torch.cumsum(feats, dim=-2)], dim=-2)
    mean = (csum.index_select(-2, end) - csum.index_select(-2, start)) / counts
    out = feats - mean
    if opts.normalize_variance:
        csum2 = torch.cat([zeros, torch.cumsum(feats * feats, dim=-2)], dim=-2)
        win2 = csum2.index_select(-2, end) - csum2.index_select(-2, start)
        var = torch.clamp(win2 / counts - mean * mean, min=1e-10)
        out = out / torch.sqrt(var)
    return out
