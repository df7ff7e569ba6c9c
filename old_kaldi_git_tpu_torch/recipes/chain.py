"""Chain (LF-MMI) acoustic models, decode side.

Counterpart of the loader of old_kaldi_git_tpu/recipes/chain.py
(`ChainModel`, `ChainModel.load`): a `chain.mdl` pickle holds the network
(`am`: config, flax variables, priors, iVector dim), the tree and transition
model, the denominator graph, the frame-subsampling factor and per-layer
learning-rate factors.  Decoding needs the network, the tid → pdf map of the
transition model (chain graphs are saved without their pdf column) and the
subsampling factor; streaming also its tid → phone map.  The tree, the
denominator graph and the learning-rate factors are training state and are
read but not converted.  Chain models decode their raw logits at acoustic
scale 1.0: no log-softmax, no priors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.device import DeviceLike
from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet


@dataclasses.dataclass
class ChainModel:
    am: AmNnet
    tid_to_pdf: np.ndarray  # [num_tids + 1] int32, entry 0 = -1
    frame_subsampling_factor: int
    tid_to_phone: np.ndarray  # [num_tids + 1] int32, entry 0 = -1

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "ChainModel":
        """A `ChainModel.save` pickle of the JAX package, read without it."""
        d = convert.load_pickle(path)
        am = d["am"]
        return ChainModel(
            convert.am_nnet_from_jax(
                vars(am["config"]), am["variables"], am["log_priors"],
                device=device, ivector_dim=int(am.get("ivector_dim", 0))),
            convert.tid_to_pdf_from_transition_model(d["tm"]),
            int(d["fsf"]),
            convert.tid_to_phone_from_transition_model(d["tm"]))
