"""nnet3-style TDNN training recipe and the feature wiring of iVector models.

Counterpart of old_kaldi_git_tpu/recipes/nnet3.py (reference
steps/nnet3/train_dnn.py): alignments from a GMM system, CE training of a
TDNN on their pdf labels, priors, decode with the GMM system's HCLG; and
`append_ivector_feats` (the reference's Append(input, ReplaceIndex(ivector,
t, 0)) Descriptor, collapsed into the feature matrix).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph
from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.fst.lang import Lang
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.hmm.hmm_utils import alignment_to_pdfs
from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
from old_kaldi_git_tpu_torch.models.tdnn import TdnnConfig, make_tdnn, make_tdnnf
from old_kaldi_git_tpu_torch.models.train import NnetTrainOptions, train_ce
from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
from old_kaldi_git_tpu_torch.utils.log import get_logger

log = get_logger("nnet3")


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


def train_tdnn(gmm_model: AmGmmModel, feats: Dict[str, np.ndarray],
               alignments: Dict[str, np.ndarray], hidden_dim: int = 256,
               num_layers: int = 4, factored: bool = False,
               opts: Optional[NnetTrainOptions] = None,
               config: Optional[TdnnConfig] = None,
               ivectors: Optional[Dict[str, np.ndarray]] = None,
               device: DeviceLike = None, history: Optional[List[dict]] = None,
               timings: Optional[Dict[str, float]] = None) -> AmNnet:
    """CE-train a fresh TDNN (its weights drawn from a torch.Generator
    seeded 0) on GMM alignments, on `device` (None: the GPU); pdf ids come
    from the GMM's tree.  `config` overrides hidden_dim / num_layers /
    factored with any architecture (make_tdnn_lstm, make_tdnn_attention,
    make_cnn_tdnnf, an xconfig's TdnnConfig); `ivectors` are appended to
    every frame and the model records their width.  history, timings:
    train_ce's."""
    dev = resolve_device(device)
    ivector_dim = 0
    if ivectors is not None:
        feats = append_ivector_feats(feats, ivectors)
        ivector_dim = int(np.asarray(next(iter(ivectors.values()))).shape[-1])
    input_dim = next(iter(feats.values())).shape[1]
    labels = {k: np.asarray(alignment_to_pdfs(gmm_model.tm, ali), np.int32)
              for k, ali in alignments.items() if ali is not None}
    feats = {k: feats[k] for k in labels}
    num_pdfs = gmm_model.am.num_pdfs
    if config is None:
        config = (make_tdnnf(input_dim, num_pdfs, hidden_dim, max(32, hidden_dim // 8),
                             num_layers) if factored
                  else make_tdnn(input_dim, num_pdfs, hidden_dim, num_layers))
    if config.input_dim != input_dim:
        raise ValueError(f"config input_dim {config.input_dim} != feature dim {input_dim} "
                         "(acoustic + i-vector)")
    am = AmNnet.init(config, device=dev)
    am.ivector_dim = ivector_dim
    log.info("train_tdnn: %d pdfs, context -%d/+%d, %d utts, ivector_dim %d", num_pdfs,
             config.left_context, config.right_context, len(labels), ivector_dim)
    return train_ce(am, feats, labels, opts, history, timings)


def decode_tdnn(am: AmNnet, graph: CsrGraph, lang: Lang, feats: Dict[str, np.ndarray],
                beam: float = 16.0, max_active: int = 7000, acoustic_scale: float = 1.0,
                ivectors: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, List[str]]:
    """One batch decode of `feats` on a folded graph with `decode_batch`, on
    the model's device (reference nnet3-latgen-faster, the best path);
    acoustic scale 1.0 is the nnet3 convention.  A model trained with
    iVectors must be given them."""
    if am.ivector_dim and ivectors is None:
        raise ValueError(f"model expects {am.ivector_dim}-dim i-vectors appended; pass "
                         "ivectors=")
    if ivectors is not None:
        feats = append_ivector_feats(feats, ivectors)
    keys, padded, nf = pad_feature_batch(feats)
    results = decode_batch(graph, am.loglikes_batch(padded), nf, ViterbiOptions(
        beam=beam, max_active=max_active, acoustic_scale=acoustic_scale), device=am.device)
    return {k: ([lang.words[w] for w in res.words] if res else [])
            for k, res in zip(keys, results)}
