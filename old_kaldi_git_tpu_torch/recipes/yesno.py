"""Synthetic yesno corpus and the end-to-end monophone pipeline (BASELINE
config 1).

Counterpart of old_kaldi_git_tpu/recipes/yesno.py (reference
egs/yesno/s5): two words with distinct formant structure plus silence,
8 kHz waves synthesised from a seed with numpy by an own copy of the JAX
package's synthesis (bit-equal waves and text), then MFCC through the MFCC
kernel → flat-start monophone GMM training (recipes/mono.py: K3 and the
alignment scan with K1) → unigram G → mkgraph → batched decode → WER.
`run_yesno` writes the trained `final.mdl` to `workdir`; BASELINE config 2
on this corpus is recipes/run_all.py.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.decoder.graph import mkgraph_csr
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.feat.compute import compute_utterance_feats
from old_kaldi_git_tpu_torch.fst.lang import Lang, Lexicon, make_unigram_grammar_fst
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.recipes.decode import DecodeOptions, decode_dataset, score_hyps
from old_kaldi_git_tpu_torch.recipes.mono import MonoTrainOptions, train_mono
from old_kaldi_git_tpu_torch.tree.context_dep import monophone_context_dependency
from old_kaldi_git_tpu_torch.utils.edit_distance import EditStats
from old_kaldi_git_tpu_torch.utils.log import get_logger
from old_kaldi_git_tpu_torch.utils.timing import StageClock

log = get_logger("yesno")

SAMP_FREQ = 8000.0

# formant recipes per phone (frequencies in Hz, amplitudes)
PHONE_SPECS: Dict[str, List[Tuple[float, float]]] = {
    "Y": [(250, 0.9), (2100, 0.5), (2900, 0.3)],
    "EH": [(550, 1.0), (1750, 0.6)],
    "S": [(3400, 0.7), (2800, 0.5)],
    "N": [(300, 1.0), (1200, 0.3)],
    "OW": [(450, 1.0), (900, 0.7)],
}
PHONE_DUR = {"Y": 0.10, "EH": 0.14, "S": 0.12, "N": 0.11, "OW": 0.16}
WORD_PRONS = {"yes": ["Y", "EH", "S"], "no": ["N", "OW"]}


def synth_utterance(words: List[str], rng: np.random.Generator,
                    noise: float = 40.0) -> np.ndarray:
    """Concatenate formant-tone phones with silence gaps → waveform."""
    pieces = [_silence(0.12, rng, noise)]
    for w in words:
        for ph in WORD_PRONS[w]:
            pieces.append(_phone(ph, rng, noise))
        pieces.append(_silence(0.10 + 0.05 * rng.random(), rng, noise))
    return np.concatenate(pieces)


def _phone(ph: str, rng: np.random.Generator, noise: float) -> np.ndarray:
    dur = PHONE_DUR[ph] * (0.85 + 0.3 * rng.random())
    n = int(dur * SAMP_FREQ)
    t = np.arange(n) / SAMP_FREQ
    sig = np.zeros(n)
    for freq, amp in PHONE_SPECS[ph]:
        f = freq * (1.0 + 0.02 * rng.standard_normal())
        sig += amp * np.sin(2 * math.pi * f * t + rng.random() * 2 * math.pi)
    # onset/offset ramps against clicks
    ramp = min(80, n // 4)
    env = np.ones(n)
    env[:ramp] = np.linspace(0, 1, ramp)
    env[-ramp:] = np.linspace(1, 0, ramp)
    sig = 2500.0 * sig * env + noise * rng.standard_normal(n)
    return sig.astype(np.float32)


def _silence(dur: float, rng: np.random.Generator, noise: float) -> np.ndarray:
    n = int(dur * SAMP_FREQ)
    return (noise * rng.standard_normal(n)).astype(np.float32)


def make_corpus(num_train: int = 31, num_test: int = 10, seed: int = 17
                ) -> Tuple[Dict[str, np.ndarray], Dict[str, List[str]],
                           Dict[str, np.ndarray], Dict[str, List[str]]]:
    """(train_waves, train_text, test_waves, test_text)."""
    rng = np.random.default_rng(seed)

    def gen(n, prefix):
        waves, text = {}, {}
        for i in range(n):
            num_words = 1 + int(rng.integers(0, 4))
            words = [("yes" if rng.random() < 0.5 else "no") for _ in range(num_words)]
            utt = f"{prefix}_{i:03d}"
            waves[utt] = synth_utterance(words, rng)
            text[utt] = words
        return waves, text

    train_waves, train_text = gen(num_train, "train")
    test_waves, test_text = gen(num_test, "test")
    return train_waves, train_text, test_waves, test_text


def compute_feats(waves: Dict[str, np.ndarray],
                  device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """MFCC (undithered) + per-utterance CMN + deltas: [T, 39] float32, every
    utterance in one batch through the MFCC kernel."""
    return compute_utterance_feats(waves, SAMP_FREQ, resolve_device(device),
                                   chunk=max(1, len(waves)))


def compute_static_feats(waves: Dict[str, np.ndarray],
                         device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Static 13-dim MFCC + per-utterance CMN, no deltas: the input of the
    LDA+MLLT pipeline (recipes/triphone.train_lda_mllt)."""
    return compute_utterance_feats(waves, SAMP_FREQ, resolve_device(device),
                                   deltas=False, chunk=max(1, len(waves)))


def make_lang() -> Lang:
    lexicon = Lexicon.from_dict({w: " ".join(p) for w, p in WORD_PRONS.items()})
    return Lang(lexicon, silence_phone="SIL", sil_prob=0.5)


def decode_yesno(model: AmGmmModel, lang: Lang, train_text: Dict[str, List[str]],
                 test_feats: Dict[str, np.ndarray], test_text: Dict[str, List[str]],
                 timings: Optional[Dict[str, float]] = None) -> EditStats:
    """The decode half of config 1: a unigram G from the training
    transcripts, HCLG over the monophone tree of the model's topology, the
    batched decode at beam 20, WER."""
    clock = StageClock(model.am.device, timings)
    g = make_unigram_grammar_fst(list(train_text.values()), lang.words)
    phones = lang.real_phone_ids
    topo = model.tm.topo
    ctx_dep = monophone_context_dependency(
        phones, {p: topo.num_pdf_classes(p) for p in phones})
    csr = mkgraph_csr(lang, g, ctx_dep, model.tm)
    clock.lap("decode_graph_seconds")
    hyps = decode_dataset(model, csr, lang, test_feats, DecodeOptions(beam=20.0))
    clock.lap("decode_seconds")
    return score_hyps(test_text, hyps)


def run_yesno(
    workdir: Optional[str] = None,
    num_train: int = 31,
    num_test: int = 10,
    train_opts: Optional[MonoTrainOptions] = None,
    device: DeviceLike = None,
    timings: Optional[Dict[str, float]] = None,
    history: Optional[List[dict]] = None,
) -> EditStats:
    """The whole config-1 pipeline on `device` (None: the GPU); returns the
    test set's WER stats.  timings: `features_seconds`, train_mono's,
    `decode_graph_seconds` and `decode_seconds`; history: train_mono's."""
    dev = resolve_device(device)
    clock = StageClock(dev, timings)
    train_waves, train_text, test_waves, test_text = make_corpus(num_train, num_test)
    train_feats = compute_feats(train_waves, dev)
    test_feats = compute_feats(test_waves, dev)
    clock.lap("features_seconds")
    lang = make_lang()
    opts = train_opts or MonoTrainOptions(num_iters=20, totgauss=120)
    model, _ali = train_mono(train_feats, train_text, lang, opts, device=dev,
                             timings=timings, history=history)
    if workdir:
        os.makedirs(workdir, exist_ok=True)
        model.save(os.path.join(workdir, "final.mdl"))
    stats = decode_yesno(model, lang, train_text, test_feats, test_text, timings)
    log.info("yesno E2E: %s", stats.report())
    return stats
