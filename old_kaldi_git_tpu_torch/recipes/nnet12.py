"""nnet1 and nnet2 on the yes/no corpus: the JAX package's end-to-end flows
for the two legacy model families (its tests/test_nnet12.py), on the port.

A monophone GMM system (24 training and 6 test utterances, 8 iterations
towards 60 Gaussians) gives the frame labels; `train_nnet1_yesno` trains a
sigmoid MLP by nnet-train-frmshuff with newbob, `train_nnet2_yesno` a p-norm
DNN by parallel SGD with model averaging on a whitening fixed affine; each
decodes the test utterances on a unigram HCLG of the GMM's transition model
at acoustic scale 0.1 (`decode_wer`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from old_kaldi_git_tpu_torch.decoder.graph import mkgraph_csr
from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.fst.lang import Lang, make_unigram_grammar_fst
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.hmm.hmm_utils import alignment_to_pdfs
from old_kaldi_git_tpu_torch.models.nnet1 import (
    AmNnet1, Nnet1Config, Nnet1TrainOptions, train_nnet1_frmshuff)
from old_kaldi_git_tpu_torch.models.nnet2 import (
    AmNnet2, Nnet2Config, Nnet2TrainOptions, make_fixed_affine, train_nnet2_parallel)
from old_kaldi_git_tpu_torch.recipes.decode import score_hyps
from old_kaldi_git_tpu_torch.recipes.gmm_common import GmmTrainOptions
from old_kaldi_git_tpu_torch.recipes.mono import train_mono
from old_kaldi_git_tpu_torch.recipes.triphone import splice_numpy
from old_kaldi_git_tpu_torch.recipes.yesno import compute_feats, make_corpus, make_lang
from old_kaldi_git_tpu_torch.tree.context_dep import monophone_context_dependency
from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
from old_kaldi_git_tpu_torch.utils.edit_distance import EditStats


@dataclasses.dataclass
class YesnoNnetSystem:
    gmm: AmGmmModel
    lang: Lang
    train_feats: Dict[str, np.ndarray]
    labels: Dict[str, np.ndarray]  # per-frame pdf ids of the GMM's alignments
    train_text: Dict[str, List[str]]
    test_feats: Dict[str, np.ndarray]
    test_text: Dict[str, List[str]]


def yesno_system(device: DeviceLike = None) -> YesnoNnetSystem:
    """The corpus, features and monophone GMM labels on `device`."""
    dev = resolve_device(device)
    train_waves, train_text, test_waves, test_text = make_corpus(24, 6)
    train_feats = compute_feats(train_waves, dev)
    test_feats = compute_feats(test_waves, dev)
    lang = make_lang()
    gmm, ali = train_mono(train_feats, train_text, lang,
                          GmmTrainOptions(num_iters=8, totgauss=60,
                                          realign_iters=(1, 2, 3, 4, 6)), device=dev)
    labels = {k: np.asarray(alignment_to_pdfs(gmm.tm, a), np.int32)
              for k, a in ali.items() if a is not None}
    return YesnoNnetSystem(gmm, lang, train_feats, labels, train_text, test_feats, test_text)


def decode_wer(system: YesnoNnetSystem, am) -> EditStats:
    """`am`'s loglikes of the padded test set, searched on a unigram HCLG of
    the training transcripts (decode_batch, beam 20, acoustic scale 0.1)."""
    s = system
    g = make_unigram_grammar_fst(list(s.train_text.values()), s.lang.words)
    phones = s.lang.real_phone_ids
    topo = s.gmm.tm.topo
    cd = monophone_context_dependency(phones, {p: topo.num_pdf_classes(p) for p in phones})
    csr = mkgraph_csr(s.lang, g, cd, s.gmm.tm)
    keys, padded, nf = pad_feature_batch(s.test_feats)
    results = decode_batch(csr, am.loglikes_batch(padded), nf,
                           ViterbiOptions(beam=20.0, acoustic_scale=0.1), device=am.device)
    hyps = {k: ([s.lang.words[w] for w in r.words] if r else [])
            for k, r in zip(keys, results)}
    return score_hyps(s.test_text, hyps)


def train_nnet1_yesno(system: YesnoNnetSystem, seed: int = 0,
                      history: Optional[List[dict]] = None) -> AmNnet1:
    """2 × 128 sigmoid units at ±4 frames, 20 newbob epochs of minibatch
    128 at learning rate 0.06 with momentum 0.5 (halving below 0.4 %)."""
    dim = next(iter(system.train_feats.values())).shape[1]
    cfg = Nnet1Config(input_dim=dim, output_dim=system.gmm.am.num_pdfs, hidden_dim=128,
                      num_hidden_layers=2, left_context=4, right_context=4)
    am = AmNnet1.init(cfg, torch.Generator().manual_seed(seed), device=system.gmm.am.device)
    return train_nnet1_frmshuff(
        am, system.train_feats, system.labels,
        Nnet1TrainOptions(max_epochs=20, minibatch_size=128, learn_rate=6e-2, momentum=0.5,
                          start_halving_impr=0.004), history=history)


def train_nnet2_yesno(system: YesnoNnetSystem, seed: int = 0,
                      history: Optional[List[dict]] = None) -> AmNnet2:
    """2 × p-norm 256 → 32 at ±3 frames on the whitening fixed affine of
    the spliced training frames, 40 iterations of parallel SGD (jobs 2 → 4,
    minibatches of 4 utterances, learning rate 0.01 → 0.001, Adam)."""
    dim = next(iter(system.train_feats.values())).shape[1]
    cfg = Nnet2Config(input_dim=dim, output_dim=system.gmm.am.num_pdfs, left_context=3,
                      right_context=3, pnorm_input_dim=256, pnorm_output_dim=32,
                      num_hidden_layers=2)
    spliced = np.concatenate([splice_numpy(system.train_feats[k], 3, 3)
                              for k in sorted(system.train_feats)], 0)
    cfg = dataclasses.replace(cfg, fixed_affine=make_fixed_affine(spliced))
    am = AmNnet2.init(cfg, torch.Generator().manual_seed(seed), device=system.gmm.am.device)
    return train_nnet2_parallel(
        am, system.train_feats, system.labels,
        Nnet2TrainOptions(num_epochs=40, minibatch_size=4, num_jobs_initial=2,
                          num_jobs_final=4, initial_lr=1e-2, final_lr=1e-3),
        history=history)
