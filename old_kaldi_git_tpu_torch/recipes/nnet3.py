"""Feature wiring of nnet3 models that take online iVectors.

Counterpart of `append_ivector_feats` in old_kaldi_git_tpu/recipes/nnet3.py
(the reference's Append(input, ReplaceIndex(ivector, t, 0)) Descriptor,
collapsed into the feature matrix).  The training recipe stays with the JAX
package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def append_ivector_feats(feats: Dict[str, np.ndarray],
                         ivectors: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """{utt: [T, D]} + {utt: [T, R] online (or [R] per-utterance) iVectors}
    → {utt: [T, D+R]} float32.  Online iVectors computed on another frame
    count are clamp-padded to the feature length: frame t takes row
    min(t, T_ivec − 1)."""
    out = {}
    for k, x in feats.items():
        iv = np.asarray(ivectors[k], np.float32)
        if iv.ndim == 1:
            iv = np.broadcast_to(iv, (x.shape[0], iv.shape[0]))
        elif iv.shape[0] != x.shape[0]:
            iv = iv[np.minimum(np.arange(x.shape[0]), iv.shape[0] - 1)]
        out[k] = np.concatenate([x, iv], axis=1)
    return out
