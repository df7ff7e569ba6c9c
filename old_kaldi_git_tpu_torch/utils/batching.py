"""Batching helpers (counterpart of old_kaldi_git_tpu/utils/batching.py)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def pad_feature_batch(
    feats: Dict[str, np.ndarray], keys: Optional[Sequence[str]] = None
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """{utt: [T, D]} → (keys, padded [B, Tmax, D] float32, num_frames [B]).

    Utterances are sorted by key unless an explicit order is given."""
    keys = list(keys) if keys is not None else sorted(feats)
    T = max(feats[k].shape[0] for k in keys)
    D = feats[keys[0]].shape[1]
    padded = np.zeros((len(keys), T, D), np.float32)
    nf = np.zeros(len(keys), np.int32)
    for i, k in enumerate(keys):
        padded[i, : feats[k].shape[0]] = feats[k]
        nf[i] = feats[k].shape[0]
    return keys, padded, nf
