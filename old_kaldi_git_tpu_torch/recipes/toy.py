"""The fused toy pipeline: a medium-vocabulary synthetic system decoded
straight from waveforms.

Counterpart of bench.py's `build_toy_system` and `run_toy` (the JAX
package's throughput headline on a ~1,000-state graph): a random 200-word
lexicon over 30 phones, a unigram grammar from 500 random sentences,
`mkgraph_csr` with a monophone tree, and a randomly initialised TDNN-F
(39 → 512 / 64, six layers) with uniform priors.  `decode_toy` runs
waveforms through the MFCC kernel (K2), deltas, the TDNN-F and the dense
beam search at K = S (`decode_batch`, beam-only pruning), all on one device.
The JAX package compiles these stages into one program; here they are
eager calls.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph
from old_kaldi_git_tpu_torch.decoder.graph import mkgraph_csr
from old_kaldi_git_tpu_torch.decoder.viterbi import DecodeResult, ViterbiOptions, decode_batch
from old_kaldi_git_tpu_torch.device import DeviceLike
from old_kaldi_git_tpu_torch.feat import Mfcc, MfccOptions, compute_deltas
from old_kaldi_git_tpu_torch.fst.lang import Lang, Lexicon, make_unigram_grammar_fst
from old_kaldi_git_tpu_torch.hmm.topology import HmmTopology
from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
from old_kaldi_git_tpu_torch.models.tdnn import make_tdnnf
from old_kaldi_git_tpu_torch.tree.context_dep import (
    ContextDependency, monophone_context_dependency)
from old_kaldi_git_tpu_torch.utils.timing import StageClock

BEAM = 14.0
NUM_WORDS, SEED = 200, 0  # bench.py's toy: its lexicon, grammar and graph
FRAMES_PER_PHONE, SEP = 6, 6.0  # synthetic loglikes, as tests/test_online.py's


@dataclasses.dataclass
class ToySystem:
    lang: Lang
    tm: TransitionModel
    ctx_dep: ContextDependency
    csr: CsrGraph
    am: AmNnet


def toy_lexicon(rng: np.random.Generator) -> Dict[str, str]:
    phone_names = [f"p{i}" for i in range(30)]
    return {f"w{w:03d}": " ".join(rng.choice(phone_names, size=rng.integers(2, 6)))
            for w in range(NUM_WORDS)}


def build_toy_system(device: DeviceLike = None) -> ToySystem:
    """The toy system, drawn from SEED as bench.py draws it (the same
    lexicon, grammar and graph); the TDNN-F's weights come from
    AmNnet.init(config, seed=0)."""
    rng = np.random.default_rng(SEED)
    lang = Lang(Lexicon.from_dict(toy_lexicon(rng)))
    phones = lang.real_phone_ids
    topo = HmmTopology.standard(phones, silence_phones=[lang.silence_id])
    cd = monophone_context_dependency(phones, {p: topo.num_pdf_classes(p) for p in phones})
    tm = TransitionModel.from_context_dependency(cd, topo)
    sentences = [[f"w{rng.integers(0, NUM_WORDS):03d}" for _ in range(rng.integers(1, 8))]
                 for _ in range(500)]
    csr = mkgraph_csr(lang, make_unigram_grammar_fst(sentences, lang.words), cd, tm)
    config = make_tdnnf(39, cd.num_pdfs, hidden_dim=512, bottleneck_dim=64, num_layers=6)
    # the JAX package's priors from uniform alignment counts (+0.5, floored)
    p = np.full(cd.num_pdfs, 1.5) / (1.5 * cd.num_pdfs)
    log_priors = np.log(np.maximum(p, 0.01 / cd.num_pdfs)).astype(np.float32)
    return ToySystem(lang, tm, cd, csr, AmNnet.init(config, seed=0, device=device,
                                                    log_priors=log_priors))


def synthetic_loglikes(system: ToySystem, sentences: Sequence[Sequence[str]],
                       seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Loglikes [B, T, P] in which each sentence's pronunciation wins frame
    by frame (its pdf at 0, the others at −SEP, FRAMES_PER_PHONE frames a
    phone, as tests/test_online.py's _loglikes_for makes them), with
    N(0, 0.5²) noise from `seed`, padded with −SEP rows; and the frame
    counts [B]."""
    rng = np.random.default_rng(seed)
    pron = {w: p for w, _, p in system.lang.lexicon.entries}
    topo = system.tm.topo
    P = system.ctx_dep.num_pdfs
    rows = []
    for words in sentences:
        pdfs = []
        for name in (ph for w in words for ph in pron[w]):
            phone = system.lang.phones[name]
            emitting = [st.pdf_class for st in topo.topology_for_phone(phone)
                        if st.pdf_class >= 0]
            per = max(1, FRAMES_PER_PHONE // len(emitting))
            for pc in emitting:
                pdfs += [system.ctx_dep.compute([phone], pc)] * per
        ll = np.full((len(pdfs), P), -SEP, np.float32)
        ll[np.arange(len(pdfs)), pdfs] = 0.0
        rows.append(ll + (0.5 * rng.normal(size=ll.shape)).astype(np.float32))
    nf = np.asarray([len(r) for r in rows], np.int32)
    out = np.full((len(rows), int(nf.max()), P), -SEP, np.float32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out, nf


def decode_toy(system: ToySystem, waves: torch.Tensor,
               timings: Optional[Dict[str, float]] = None
               ) -> List[Optional[DecodeResult]]:
    """[B, N] waveforms at 16 kHz → one DecodeResult per row (None where the
    beam died), on the system's device: MFCC (K2), deltas, the TDNN-F's
    pseudo-loglikes at acoustic scale 1.0, then decode_batch at
    max_active = S, beam 14.  timings: a dict that receives
    `front_end_seconds`, `acoustic_model_seconds`, `search_seconds` and
    `host_tail_seconds`."""
    dev = system.am.device
    clock = StageClock(dev, timings)
    opts = MfccOptions()
    opts.frame_opts.dither = 0.0
    feats = compute_deltas(Mfcc(opts)(torch.as_tensor(waves, dtype=torch.float32).to(dev)))
    clock.lap("front_end_seconds")
    loglikes = system.am.loglikes_batch(feats)
    del feats
    clock.lap("acoustic_model_seconds")
    B, T, _ = loglikes.shape
    S = system.csr.num_states
    return decode_batch(system.csr, loglikes, np.full(B, T, np.int32),
                        ViterbiOptions(beam=BEAM, max_active=S, acoustic_scale=1.0),
                        device=dev, timings=timings)
