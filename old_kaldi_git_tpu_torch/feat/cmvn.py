"""Per-speaker / per-utterance CMVN statistics (counterpart of
old_kaldi_git_tpu/feat/cmvn.py; reference src/transform/cmvn.h AccCmvnStats /
ApplyCmvn and the compute-cmvn-stats / apply-cmvn tools).

Stats are a [2, dim+1] float64 matrix, row 0 = (sum_x, count), row 1 =
(sum_x^2, 0): Kaldi's on-disk layout, so cmvn.ark files interoperate.  The
sums run on the features' device in float64; the stats come back as numpy.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

ArrayLike = Union[np.ndarray, torch.Tensor]


def acc_cmvn_stats(feats: ArrayLike, weights: ArrayLike = None) -> np.ndarray:
    """[T, D] (numpy or a tensor on any device) → [2, D+1] float64 stats."""
    x = torch.as_tensor(feats).to(torch.float64)
    if weights is None:
        count = float(x.shape[0])
        s1, s2 = x.sum(dim=0), (x * x).sum(dim=0)
    else:
        w = torch.as_tensor(weights).to(device=x.device, dtype=torch.float64)
        count = float(w.sum())
        s1, s2 = (x * w[:, None]).sum(dim=0), (x * x * w[:, None]).sum(dim=0)
    dim = x.shape[1]
    stats = np.zeros((2, dim + 1), np.float64)
    stats[0, :dim] = s1.cpu().numpy()
    stats[0, dim] = count
    stats[1, :dim] = s2.cpu().numpy()
    return stats


def sum_cmvn_stats(stats_list: Sequence[np.ndarray]) -> np.ndarray:
    return np.sum(np.stack([np.asarray(s, np.float64) for s in stats_list]), axis=0)


def cmvn_shift_scale(stats: np.ndarray, norm_vars: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """stats → (shift [D], scale [D]) float32, so that normalised =
    x * scale + shift."""
    stats = np.asarray(stats, np.float64)
    dim = stats.shape[1] - 1
    count = max(stats[0, dim], 1e-10)
    mean = stats[0, :dim] / count
    if norm_vars:
        var = np.maximum(stats[1, :dim] / count - mean ** 2, 1e-10)
        scale = 1.0 / np.sqrt(var)
    else:
        scale = np.ones(dim)
    shift = -mean * scale
    return shift.astype(np.float32), scale.astype(np.float32)


def apply_cmvn(feats: torch.Tensor, stats: np.ndarray, norm_vars: bool = False
               ) -> torch.Tensor:
    """[..., T, D] float32 tensor → the normalised features, on its device."""
    shift, scale = cmvn_shift_scale(stats, norm_vars)
    return (feats * torch.from_numpy(scale).to(feats.device)
            + torch.from_numpy(shift).to(feats.device))
