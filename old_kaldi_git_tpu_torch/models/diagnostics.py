"""Objective diagnostics on held-out data.

Counterpart of old_kaldi_git_tpu/models/diagnostics.py (reference
src/nnet3/nnet-diagnostics.{h,cc}, nnet3-compute-prob and
nnet3-chain-compute-prob): the objective and frame accuracy of a model on a
set of utterances, in eval mode, without updating it, on the model's device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.chain.loss import ChainLossOptions, chain_loss
from old_kaldi_git_tpu_torch.chain.supervision import alignment_to_supervision, pad_supervisions
from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
from old_kaldi_git_tpu_torch.utils.log import get_logger

log = get_logger("nnet-diag")


@torch.inference_mode()
def compute_prob(am: AmNnet, feats: Dict[str, np.ndarray],
                 pdf_labels: Dict[str, np.ndarray]) -> Tuple[float, float]:
    """(mean CE in nats a frame, frame accuracy) over the utterances that
    have labels, as one padded batch (nnet3-compute-prob)."""
    keys = [k for k in sorted(feats) if k in pdf_labels]
    if not keys:
        return float("nan"), float("nan")
    keys, x, _nf = pad_feature_batch(feats, keys=keys)
    T = x.shape[1]
    y = np.zeros((len(keys), T), np.int64)
    m = np.zeros((len(keys), T), np.float32)
    for i, k in enumerate(keys):
        t = min(feats[k].shape[0], len(pdf_labels[k]))
        y[i, :t] = pdf_labels[k][:t]
        m[i, :t] = 1.0
    yt, mt = torch.from_numpy(y).to(am.device), torch.from_numpy(m).to(am.device)
    logits = am.logits(x)
    logp = torch.log_softmax(logits, dim=-1)
    tok = torch.gather(logp, 2, yt[:, :, None])[:, :, 0]
    denom = torch.clamp(mt.sum(), min=1.0)
    ce = float(-(tok * mt).sum() / denom)
    acc = float(((logits.argmax(-1) == yt).to(mt.dtype) * mt).sum() / denom)
    log.info("compute_prob: CE %.4f acc %.3f over %d frames", ce, acc, int(denom))
    return ce, acc


@torch.inference_mode()
def compute_chain_prob(chain_model, feats: Dict[str, np.ndarray],
                       alignments: Dict[str, np.ndarray], gmm_model,
                       opts: Optional[ChainLossOptions] = None) -> float:
    """The chain objective (num − den a frame) of the utterances whose
    supervision can be made (nnet3-chain-compute-prob); an utterance whose
    supervision fails is skipped with a warning, as the trainer skips it."""
    fsf = chain_model.frame_subsampling_factor
    sups, used = [], []
    for k in sorted(feats):
        if alignments.get(k) is None:
            continue
        try:
            sups.append(alignment_to_supervision(
                alignments[k], gmm_model.tm, chain_model.ctx_dep,
                frame_subsampling_factor=fsf, den=chain_model.den))
            used.append(k)
        except Exception as e:  # a pathological utterance is skipped, as in training
            log.warning("compute_chain_prob: skipping %s (%s)", k, e)
    if not used:
        return float("nan")
    dev = chain_model.am.device
    pdf_seq, allowed, nf, seq_len, adv = (torch.from_numpy(a).to(dev)
                                          for a in pad_supervisions(sups))
    T = max(feats[k].shape[0] for k in used)
    x = np.zeros((len(used), T, feats[used[0]].shape[1]), np.float32)
    for i, k in enumerate(used):
        x[i, : feats[k].shape[0]] = feats[k]
    logits = chain_model.am.logits(x, output_stride=fsf)[:, : allowed.shape[1]]
    loss, _ = chain_loss(logits, chain_model.den, pdf_seq, allowed, nf, seq_len, adv,
                         opts or ChainLossOptions())
    objf = -float(loss)
    log.info("compute_chain_prob: objf %.4f over %d utts", objf, len(used))
    return objf
