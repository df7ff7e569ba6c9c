"""Feature post-processing: deltas.

Counterpart of old_kaldi_git_tpu/feat/functions.py (reference
src/feat/feature-functions.h ComputeDeltas), batched over leading axes;
edge frames are replicated via clipped indices exactly like the reference.
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
