"""Mini-librispeech-class synthetic system at realistic decode-graph scale:
the serving path of the port.

Counterpart of old_kaldi_git_tpu/recipes/minilib.py: it loads a built
system (20k-word lexicon, pruned trigram, triphone tree, a 1M-state HCLG as
CSR arrays, a TDNN-F CE model; the committed one the JAX package built) and
decodes the held-out set with measured WER, and it builds the system,
stage by stage (`build_system`, below).

  waveform → compute_feats (13 MFCC through the fused kernel, per-utterance
  CMN, deltas → 39) → AmNnet.loglikes_batch → decode_batch_tokens → words
  → compute_wer.

Two more paths decode the same held-out set: the chain model `chain.mdl`
on its split-eps graph `chain_hclg.npz` (logits at frame-subsampling 3,
`decode_and_score_chain`), and lattice rescoring (`rescore_and_score`):
the flagship decode keeps bounded lattice records on the device, the host
rebuilds and determinizes each lattice and rescores it from the pruned
trigram to a full 4-gram estimated from the synthesised LM text.  The
iVector systems (`final_ivec.am`, `chain_ivec.mdl`) take the same features
with online iVectors from the diagonal-UBM extractor `final.ie` appended
(`use_ivectors=True`).

And GMM training on the 600-utterance training set (`training_set`):
forced alignment with `tri.mdl` or `mono.mdl`, or as the equal alignment
(`align_training_set`: a training graph per utterance from the lang bundle,
`make_lang`, and the model's tree, GMM loglikes, the alignment scan); the
JAX package's build_system stages 3 and 4, `train_mono_system` (flat-start
monophones) and `train_tri_system` (the triphone tree and its training,
from the committed `mono.mdl` and `mono_ali.pkl`).

And neural training from the committed `tri.mdl` and `tri_ali.pkl`: stage 5,
`train_am_system` (CE training of the TDNN-F `final.am`, which decodes on
`hclg.npz`: its pdfs are tri.mdl's), and stages 7 and 8,
`train_chain_system` (the biphone chain tree, den graph and LF-MMI training
of the chain TDNN-F, then that model's own split-eps chain HCLG from the
pruned trigram), which returns a ChainSystem for `decode_and_score_chain`.

And iVector training, stages 9-11: `train_ivector_system` (a diagonal UBM on
every fourth pooled training frame, then the extractor: `final.ie`),
`train_am_ivec_system` (the CE TDNN-F on features with online iVectors from
it: `final_ivec.am`) and `train_chain_ivec_system` (`chain_ivec.mdl`, whose
tree is built from the features without iVectors, so it is stage 7's tree
and decodes on stage 8's graph; `load_chain_system` and `on_graph_of`
compare the two trees and refuse a graph of another tree).

`build_system` runs the JAX package's 11 stages through these functions,
gated by `utils/pipeline.py` (a stage is skipped below `--stage` and when
its artifacts exist): `python -m old_kaldi_git_tpu_torch.recipes.minilib
--workdir D [--stage N]`.  The port writes its own formats where the JAX
package pickles its classes (`lang.pkl`, `tree.pkl`, `final.am`,
`chain.mdl`, `final_ivec.am`, `chain_ivec.mdl`); the other artifacts are
the JAX package's formats.

The evaluation and training audio is synthesised from the option seeds with numpy, by an
own copy of the JAX package's synthesis (bit-equal waves and text), so
nothing is downloaded.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import math
import os
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph, FlatOlabels
from old_kaldi_git_tpu_torch.decoder.graph import GraphCompiler, mkgraph_csr
from old_kaldi_git_tpu_torch.decoder.viterbi import (
    ViterbiOptions, align_batch, decode_batch_tokens)
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.feat.compute import FEAT_CHUNK, compute_utterance_feats
from old_kaldi_git_tpu_torch.fst.lang import Lang, Lexicon
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
from old_kaldi_git_tpu_torch.ivector.extractor import (
    IvectorExtractor, extract_online_ivectors, train_ivector_extractor, train_ubm)
from old_kaldi_git_tpu_torch.lat.determinize import determinize_lattice_pruned
from old_kaldi_git_tpu_torch.lat.lattice import (
    lattice_best_path, lattice_from_token_records, lattice_oracle)
from old_kaldi_git_tpu_torch.lat.rescore import lmrescore_compact_lattice
from old_kaldi_git_tpu_torch.lm.arpa import ArpaLm, arpa_to_fst, parse_arpa
from old_kaldi_git_tpu_torch.lm.ngram import (
    estimate_ngram_lm, perplexity, prune_ngram_lm, write_arpa)
from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
from old_kaldi_git_tpu_torch.models.tdnn import TdnnConfig, make_tdnnf
from old_kaldi_git_tpu_torch.models.train import NnetTrainOptions
from old_kaldi_git_tpu_torch.recipes.chain import (
    ChainModel, ChainTrainOptions, make_chain_decode_graph, train_chain)
from old_kaldi_git_tpu_torch.recipes.gmm_common import GmmTrainOptions, align_all
from old_kaldi_git_tpu_torch.recipes.mono import MonoTrainOptions, train_mono
from old_kaldi_git_tpu_torch.recipes.triphone import train_deltas
from old_kaldi_git_tpu_torch.recipes.nnet3 import append_ivector_feats, train_tdnn
from old_kaldi_git_tpu_torch.tree.context_dep import (
    ContextDependency, monophone_context_dependency, tree_key)
from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
from old_kaldi_git_tpu_torch.utils.edit_distance import compute_wer
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass
from old_kaldi_git_tpu_torch.utils.pipeline import Pipeline
from old_kaldi_git_tpu_torch.utils.timing import StageClock

log = get_logger("minilib")

SAMP_FREQ = 8000.0


@options_dataclass
class MinilibOptions:
    """The fields that shape the lexicon, the text, the held-out and training
    sets, the LM (its text, order and pruning), the GMM stages, the neural
    ones and the iVector extractor (the JAX package's options)."""

    num_phones: int = 40
    num_words: int = 20_000
    lm_sentences: int = 250_000
    num_train: int = 600
    num_test: int = 256
    seed: int = 42
    lm_order: int = 3
    prune_threshold: float = 4e-8
    tree_leaves: int = 2000
    tri_iters: int = 8
    mono_iters: int = 25
    mono_totgauss: int = 500
    tri_totgauss: int = 4000
    # TDNN-F acoustic models (stage 5's CE model, stage 7's chain model)
    hidden_dim: int = 512
    bottleneck_dim: int = 64
    num_layers: int = 6
    num_epochs: int = 4
    # online iVectors: a 64-Gaussian diagonal UBM, 32-dim iVectors every 10
    # frames
    ivector_ubm_gauss: int = 64
    ivector_dim: int = 32
    ivector_period: int = 10
    chain_epochs: int = 20


# ---------------------------------------------------------------------------
# phone inventory & audio synthesis (formant tones over a generated
# 40-phone grid)
# ---------------------------------------------------------------------------

def phone_inventory(num_phones: int) -> Dict[str, List[Tuple[float, float]]]:
    """Deterministic formant grid: f1 x f2 combinations below the 4 kHz
    Nyquist, each phone acoustically distinct in the mel filterbank."""
    f1s = [300.0, 450.0, 600.0, 750.0, 900.0]
    f2s = [1050.0, 1350.0, 1650.0, 1950.0, 2250.0, 2550.0, 2850.0, 3150.0]
    specs: Dict[str, List[Tuple[float, float]]] = {}
    for i in range(num_phones):
        f1 = f1s[i % len(f1s)]
        f2 = f2s[(i // len(f1s)) % len(f2s)]
        specs[f"p{i:02d}"] = [(f1, 1.0), (f2, 0.7)]
    return specs


def phone_durations(num_phones: int) -> Dict[str, float]:
    return {f"p{i:02d}": 0.05 + 0.005 * (i % 6) for i in range(num_phones)}


def _tone(spec, dur, rng, noise):
    n = int(dur * SAMP_FREQ)
    t = np.arange(n) / SAMP_FREQ
    sig = np.zeros(n)
    for freq, amp in spec:
        f = freq * (1.0 + 0.015 * rng.standard_normal())
        sig += amp * np.sin(2 * math.pi * f * t + rng.random() * 2 * math.pi)
    ramp = min(60, max(1, n // 4))
    env = np.ones(n)
    env[:ramp] = np.linspace(0, 1, ramp)
    env[-ramp:] = np.linspace(1, 0, ramp)
    return (2500.0 * sig * env + noise * rng.standard_normal(n)).astype(np.float32)


def _silence(dur, rng, noise):
    n = int(dur * SAMP_FREQ)
    return (noise * rng.standard_normal(n)).astype(np.float32)


def synth_utterance(
    words: Sequence[str],
    lexicon: Dict[str, str],
    specs: Dict[str, List[Tuple[float, float]]],
    durs: Dict[str, float],
    rng: np.random.Generator,
    noise: float = 40.0,
    sil_between: float = 0.3,
) -> np.ndarray:
    pieces = [_silence(0.1, rng, noise)]
    for w in words:
        for ph in lexicon[w].split():
            d = durs[ph] * (0.85 + 0.3 * rng.random())
            pieces.append(_tone(specs[ph], d, rng, noise))
        if rng.random() < sil_between:
            pieces.append(_silence(0.05 + 0.1 * rng.random(), rng, noise))
    pieces.append(_silence(0.1, rng, noise))
    return np.concatenate(pieces)


# ---------------------------------------------------------------------------
# lexicon & text
# ---------------------------------------------------------------------------

def make_lexicon(opts: MinilibOptions) -> Dict[str, str]:
    rng = np.random.default_rng(opts.seed)
    names = list(phone_inventory(opts.num_phones))
    lex: Dict[str, str] = {}
    seen = set()
    w = 0
    while w < opts.num_words:
        pron = tuple(rng.choice(names, size=int(rng.integers(3, 8))))
        if pron in seen:
            continue
        seen.add(pron)
        lex[f"w{w:05d}"] = " ".join(pron)
        w += 1
    return lex


def make_text(
    opts: MinilibOptions, num_sentences: int, seed: int,
    min_len: int = 5, max_len: int = 18,
) -> List[np.ndarray]:
    """Sentences as word-id arrays from a sparse Zipfian Markov grammar.
    The successor structure depends only on opts.seed, so LM text and
    held-out train/test sentences come from the SAME language."""
    grammar_rng = np.random.default_rng(opts.seed + 1)
    V = opts.num_words
    zipf = 1.0 / (np.arange(1, V + 1) ** 0.9)
    zipf /= zipf.sum()
    NSUCC = 30
    succ = grammar_rng.choice(V, size=(V, NSUCC), p=zipf)
    rng = np.random.default_rng(seed)
    starts = rng.choice(V, size=num_sentences, p=zipf)
    lens = rng.integers(min_len, max_len, size=num_sentences)
    pick = rng.integers(0, NSUCC, size=(num_sentences, max_len))
    out = []
    for i in range(num_sentences):
        cur = int(starts[i])
        s = [cur]
        for j in range(int(lens[i]) - 1):
            cur = int(succ[cur, pick[i, j]])
            s.append(cur)
        out.append(np.asarray(s, np.int32))
    return out


def _to_words(sent_ids: np.ndarray) -> List[str]:
    return [f"w{int(i):05d}" for i in sent_ids]



def word_table(lexicon: Dict[str, str]) -> List[str]:
    """Word-id → word, as the lang bundle numbers them: `<eps>` (0), the
    lexicon's words sorted, then the LM-backoff disambiguation symbol `#0`."""
    return ["<eps>"] + sorted(lexicon) + ["#0"]


SILENCE_PHONE = "SIL"


def silence_phone_id(lexicon: Dict[str, str]) -> int:
    """The silence phone's id as the lang bundle numbers phones: `<eps>` (0),
    then the lexicon's phones and SIL, sorted (the JAX package rebuilds its
    lang.pkl cache from the lexicon in just this order)."""
    phones = {p for pron in lexicon.values() for p in pron.split()}
    return 1 + sorted(phones | {SILENCE_PHONE}).index(SILENCE_PHONE)


# ---------------------------------------------------------------------------
# features (shared front-end: 13 MFCC + per-utt CMVN + deltas = 39)
# ---------------------------------------------------------------------------

def compute_feats(waves: Dict[str, np.ndarray],
                  device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """{utt: wave} → {utt: [T, 39] float32}: 13 MFCC at 8 kHz through the MFCC
    kernel, per-utterance CMN, deltas (feat/compute.py
    `compute_utterance_feats`, in chunks of FEAT_CHUNK utterances)."""
    return compute_utterance_feats(waves, SAMP_FREQ, resolve_device(device),
                                   chunk=FEAT_CHUNK)


def compute_ivectors(ext: IvectorExtractor, feats: Dict[str, np.ndarray],
                     period: int = 10) -> Dict[str, np.ndarray]:
    """Per-utterance online iVectors {utt: [T, R] float32} (reference
    ivector-extract-online2), computed on the extractor's device."""
    return {k: extract_online_ivectors(ext, v, period=period).cpu().numpy()
            for k, v in feats.items()}


def synth_set(
    opts: MinilibOptions, sents: List[np.ndarray], prefix: str, seed: int,
    noise: float = 40.0,
) -> Tuple[Dict[str, np.ndarray], Dict[str, List[str]]]:
    lex = make_lexicon(opts)
    specs = phone_inventory(opts.num_phones)
    durs = phone_durations(opts.num_phones)
    rng = np.random.default_rng(seed)
    waves, text = {}, {}
    for i, s in enumerate(sents):
        words = _to_words(s)
        utt = f"{prefix}_{i:04d}"
        waves[utt] = synth_utterance(words, lex, specs, durs, rng,
                                     noise=noise)
        text[utt] = words
    return waves, text


def training_set(opts: MinilibOptions) -> Tuple[Dict[str, np.ndarray],
                                               Dict[str, List[str]]]:
    """The training set the GMM stages of the JAX package's build_system use
    (and align): opts.num_train sentences of 4-10 words, synthesised as
    `train_0000`…"""
    sents = make_text(opts, opts.num_train, opts.seed + 4, min_len=4, max_len=11)
    return synth_set(opts, sents, "train", opts.seed + 5)


def make_lang(opts: Optional[MinilibOptions] = None) -> Lang:
    """The lang bundle of the system (20k-word lexicon, SIL, silence
    probability 0.5), built from the lexicon as the JAX package rebuilds its
    uncommitted lang.pkl cache."""
    opts = opts or MinilibOptions()
    return Lang(Lexicon.from_dict(make_lexicon(opts)), silence_phone=SILENCE_PHONE,
                sil_prob=0.5)


# The NOISY evaluation regime: the clean corpus decodes at 0.03-0.07% WER,
# where quality differences cannot be resolved; re-synthesizing the held-out
# set at this noise amplitude puts the CE first pass in the few-percent range.
NOISE_EVAL = 400.0


def make_test_set(
    opts: MinilibOptions, noise: Optional[float] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, List[str]]]:
    """The held-out evaluation set: clean (synthesis default noise=40) or
    re-synthesized at a raised noise amplitude — same sentences, same rng
    stream, so clean and noisy rows are paired."""
    test_sents = make_text(opts, opts.num_test, opts.seed + 6)
    return synth_set(opts, test_sents, "test", opts.seed + 7,
                     noise=40.0 if noise is None else noise)


# ---------------------------------------------------------------------------
# the committed system
# ---------------------------------------------------------------------------

def load_csr(path: str, tid_to_pdf: Optional[np.ndarray] = None) -> CsrGraph:
    """A graph saved by the JAX package's save_csr.  Graphs saved without
    their per-arc pdf array need `tid_to_pdf` to rebuild it."""
    z = np.load(path)
    if "pdf" in z:
        pdf = z["pdf"]
    else:
        if tid_to_pdf is None:
            raise KaldiError(
                f"{path} was saved without the pdf array; pass tid_to_pdf "
                "(convert.tid_to_pdf_from_transition_model)")
        pdf = np.asarray(tid_to_pdf, np.int32)[z["tid"]]
    csr = CsrGraph(
        start=int(z["start"]),
        row_ptr=z["row_ptr"], tid=z["tid"], pdf=pdf,
        weight=z["weight"], nextstate=z["nextstate"],
        final_weight=z["final_weight"],
        arc_olabels=FlatOlabels(z["olab_off"], z["olab_val"]),
        final_olabels=FlatOlabels(z["folab_off"], z["folab_val"]),
        eps_ns=z["eps_ns"] if "eps_ns" in z else None,
        eps_w=z["eps_w"] if "eps_w" in z else None,
        eps_olab=z["eps_olab"] if "eps_olab" in z else None,
        eps_depth=int(z["eps_depth"]) if "eps_depth" in z else 0,
    )
    csr._olabel_mask = csr.arc_olabels.offsets[1:] > csr.arc_olabels.offsets[:-1]
    return csr


@dataclasses.dataclass
class MinilibSystem:
    words: List[str]  # word id → word
    csr: CsrGraph
    am: AmNnet
    test_waves: Dict[str, np.ndarray]
    test_text: Dict[str, List[str]]
    workdir: str = ""
    # the CE+iVec model and its extractor, loaded at first use
    ivector_models: Optional[Tuple[AmNnet, IvectorExtractor]] = None


def load_ivector_extractor(workdir: str, am: AmNnet) -> IvectorExtractor:
    """`final.ie` on `am`'s device, checked against the iVector dims that
    `am` takes."""
    ext = IvectorExtractor.load(os.path.join(workdir, "final.ie"), device=am.device)
    if ext.ivector_dim != am.ivector_dim:
        raise KaldiError(f"final.ie gives {ext.ivector_dim}-dim iVectors, the "
                         f"model takes {am.ivector_dim}")
    return ext


def ivector_models(system: MinilibSystem) -> Tuple[AmNnet, IvectorExtractor]:
    """(final_ivec.am, final.ie) on the system's device, loaded once."""
    if system.ivector_models is None:
        am = AmNnet.load(os.path.join(system.workdir, "final_ivec.am"),
                         device=system.am.device)
        system.ivector_models = (am, load_ivector_extractor(system.workdir, am))
    return system.ivector_models


def load_system(workdir: str, opts: Optional[MinilibOptions] = None,
                device: DeviceLike = None) -> MinilibSystem:
    """Load the built system (tree.pkl, hclg.npz, final.am) and synthesise
    the held-out test set.  Only loads: a missing artifact raises."""
    opts = opts or MinilibOptions()
    dev = resolve_device(device)
    for name in ("tree.pkl", "hclg.npz", "final.am"):
        if not os.path.exists(os.path.join(workdir, name)):
            raise KaldiError(
                f"{workdir}: {name} is missing; build_system makes it")
    _ctx_dep, tm = convert.load_pickle(os.path.join(workdir, "tree.pkl"))
    tid_to_pdf = convert.tid_to_pdf_from_transition_model(tm)
    csr = load_csr(os.path.join(workdir, "hclg.npz"), tid_to_pdf)
    am = AmNnet.load(os.path.join(workdir, "final.am"), device=dev)
    test_waves, test_text = make_test_set(opts)
    return MinilibSystem(word_table(make_lexicon(opts)), csr, am,
                         test_waves, test_text, workdir)


def decode_test_set(
    system: MinilibSystem,
    waves: Dict[str, np.ndarray],
    beam: float = 14.0,
    max_active: int = 2048,
    acoustic_scale: float = 1.0,
    batch: int = 64,
    timings: Optional[Dict[str, float]] = None,
    use_ivectors: bool = False,
) -> Dict[str, List[str]]:
    """Token-sparse decode of `waves` on the system's device → {utt: words}.

    Utterances are decoded in duration-sorted chunks of `batch`: the
    [T, B, K] backpointer store is the memory hog at the 1M-state scale, and
    duration sorting keeps the padding waste small.  T is bucketed to
    multiples of 128 and the last chunk's batch dim is padded with
    zero-frame rows, so every chunk has one of a few shapes.

    timings: a dict that receives the host-clock seconds of each stage
    (`front_end_seconds`, `acoustic_model_seconds`, `search_seconds`, the
    last with backtrace and host tail) and `search_frames`; each stage then
    ends with a device synchronise.

    use_ivectors: decode with the CE+iVec model `final_ivec.am`, the
    features with online iVectors from `final.ie` appended
    (`ivector_seconds`)."""
    dev = system.am.device
    clock = StageClock(dev, timings)
    feats = compute_feats(waves, device=dev)
    clock.lap("front_end_seconds")
    am = system.am
    if use_ivectors:
        am, ext = ivector_models(system)
        clock.lap(None)  # loading belongs to no stage
        feats = append_ivector_feats(feats, compute_ivectors(ext, feats))
        clock.lap("ivector_seconds")
    return decode_features(dataclasses.replace(system, am=am), feats, beam, max_active,
                           acoustic_scale, batch, timings)


def decode_features(
    system: MinilibSystem,
    feats: Dict[str, np.ndarray],
    beam: float = 14.0,
    max_active: int = 2048,
    acoustic_scale: float = 1.0,
    batch: int = 64,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, List[str]]:
    """The search half of decode_test_set, on features made elsewhere (e.g.
    the filterbank a CNN-TDNN-F reads): system.am's loglikes of
    duration-sorted chunks of `batch` utterances, T bucketed to multiples
    of 128, then decode_batch_tokens on system.csr → {utt: words}.
    timings: `acoustic_model_seconds`, `search_seconds`, `search_frames`."""
    dev = system.am.device
    clock = StageClock(dev, timings)
    am = system.am
    vopts = ViterbiOptions(beam=beam, max_active=max_active,
                           acoustic_scale=acoustic_scale)
    by_dur = sorted(feats, key=lambda k: feats[k].shape[0])
    hyps: Dict[str, List[str]] = {}
    for lo in range(0, len(by_dur), batch):
        chunk = by_dur[lo: lo + batch]
        keys, padded, nf = pad_feature_batch({k: feats[k] for k in chunk})
        T = padded.shape[1]
        Tb = -(-T // 128) * 128
        if Tb > T:
            padded = np.pad(padded, ((0, 0), (0, Tb - T), (0, 0)))
        if len(keys) < batch:
            padded = np.pad(padded, ((0, batch - len(keys)), (0, 0), (0, 0)))
            nf = np.concatenate([nf, np.zeros(batch - len(keys), nf.dtype)])
        clock.lap(None)  # host staging belongs to no stage
        loglikes = am.loglikes_batch(padded)
        clock.lap("acoustic_model_seconds")
        results = decode_batch_tokens(system.csr, loglikes, nf, vopts, device=dev)
        clock.lap("search_seconds")
        clock.add("search_frames", int(nf.max()))
        for k, res in zip(keys, results):
            hyps[k] = [system.words[w] for w in res.words] if res else []
    return hyps


def _score_stats(stats, test_text: Dict[str, List[str]],
                 hyps: Dict[str, List[str]], noise: Optional[float]) -> Dict:
    return {"wer": stats.wer, "errors": stats.errors, "ref_words": stats.ref_len,
            "utterances_with_errors": sorted(
                k for k in test_text if list(test_text[k]) != hyps[k]),
            "noise": noise}


def decode_and_score(
    system: MinilibSystem,
    beam: float = 14.0,
    max_active: int = 2048,
    acoustic_scale: float = 1.0,
    batch: int = 64,
    noise: Optional[float] = None,
    opts: Optional[MinilibOptions] = None,
    timings: Optional[Dict[str, float]] = None,
    use_ivectors: bool = False,
) -> Tuple[float, float]:
    """Decode the system's held-out set; returns (WER %, audio seconds).

    noise: decode the set re-synthesized at this noise amplitude instead of
    the clean waves (NOISE_EVAL is the standard noisy regime).
    timings, use_ivectors: see decode_test_set.  The run's WER, error count
    and the utterances with errors land in `decode_and_score.last_stats`."""
    test_waves, test_text = system.test_waves, system.test_text
    if noise is not None:
        test_waves, test_text = make_test_set(
            opts or MinilibOptions(), noise=noise)
    hyps = decode_test_set(system, test_waves, beam, max_active,
                           acoustic_scale, batch, timings, use_ivectors)
    stats = compute_wer({k: list(v) for k, v in test_text.items()}, hyps)
    audio_s = sum(w.shape[0] for w in test_waves.values()) / SAMP_FREQ
    decode_and_score.last_stats = _score_stats(stats, test_text, hyps, noise)
    log.info("minilib decode: %s over %.0f audio-s", stats.report(), audio_s)
    return stats.wer, audio_s


# ---------------------------------------------------------------------------
# the chain system: chain.mdl on its split-eps graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChainSystem:
    words: List[str]  # word id → word
    csr: CsrGraph  # split-eps: emitting arcs + one backoff arc a state
    model: ChainModel
    # final.ie, for a model that takes online iVectors
    ivector_extractor: Optional[IvectorExtractor] = None


def load_chain_system(workdir: str, model_name: Optional[str] = None,
                      opts: Optional[MinilibOptions] = None,
                      device: DeviceLike = None,
                      use_ivectors: bool = False) -> ChainSystem:
    """Load a chain model and chain_hclg.npz (saved without its pdf column:
    the model's own tid → pdf map rebuilds it).  The model defaults to
    chain.mdl, or chain_ivec.mdl with `use_ivectors`; a model that takes
    online iVectors comes with the extractor final.ie."""
    opts = opts or MinilibOptions()
    model_name = model_name or ("chain_ivec.mdl" if use_ivectors else "chain.mdl")
    for name in (model_name, "chain_hclg.npz"):
        if not os.path.exists(os.path.join(workdir, name)):
            raise KaldiError(f"{workdir}: {name} is missing")
    model = ChainModel.load(os.path.join(workdir, model_name), device=device)
    if model_name != "chain.mdl" and os.path.exists(os.path.join(workdir, "chain.mdl")):
        # chain_hclg.npz is stage 8's graph of chain.mdl's tree
        check_same_tree(model.ctx_dep, ChainModel.load(
            os.path.join(workdir, "chain.mdl"), device="cpu").ctx_dep,
            f"{workdir}/{model_name}", f"{workdir}/chain_hclg.npz (chain.mdl's)")
    csr = load_csr(os.path.join(workdir, "chain_hclg.npz"), model.tid_to_pdf)
    ext = (load_ivector_extractor(workdir, model.am) if model.am.ivector_dim
           else None)
    return ChainSystem(word_table(make_lexicon(opts)), csr, model, ext)


def decode_chain_test_set(
    system: ChainSystem,
    waves: Dict[str, np.ndarray],
    beam: float = 14.0,
    max_active: int = 2048,
    batch: int = 64,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, List[str]]:
    """Token-sparse decode of `waves` with the chain model → {utt: words}:
    raw logits at frame-subsampling `fsf` (3), acoustic scale 1.0.  Chunks
    as decode_test_set, with T bucketed to multiples of 128·fsf input frames
    so that every chunk decodes a multiple of 128 subsampled frames, and
    nf_sub = ceil(nf / fsf).  timings: as decode_test_set (`search_frames`
    counts subsampled frames).  A model that takes online iVectors gets
    them appended to the features (`ivector_seconds`)."""
    am = system.model.am
    dev = am.device
    fsf = system.model.frame_subsampling_factor
    clock = StageClock(dev, timings)
    feats = compute_feats(waves, device=dev)
    clock.lap("front_end_seconds")
    if am.ivector_dim:
        feats = append_ivector_feats(
            feats, compute_ivectors(system.ivector_extractor, feats))
        clock.lap("ivector_seconds")
    vopts = ViterbiOptions(beam=beam, max_active=max_active, acoustic_scale=1.0)
    by_dur = sorted(feats, key=lambda k: feats[k].shape[0])
    hyps: Dict[str, List[str]] = {}
    for lo in range(0, len(by_dur), batch):
        chunk = by_dur[lo: lo + batch]
        keys, padded, nf = pad_feature_batch({k: feats[k] for k in chunk})
        T = padded.shape[1]
        Tb = -(-T // (128 * fsf)) * (128 * fsf)
        padded = np.pad(padded, ((0, batch - len(keys)), (0, Tb - T), (0, 0)))
        nf = np.concatenate([nf, np.zeros(batch - len(keys), nf.dtype)])
        nf_sub = (nf + fsf - 1) // fsf
        clock.lap(None)  # host staging belongs to no stage
        logits = am.logits(padded, output_stride=fsf)
        clock.lap("acoustic_model_seconds")
        results = decode_batch_tokens(system.csr, logits, nf_sub, vopts, device=dev)
        clock.lap("search_seconds")
        clock.add("search_frames", int(nf_sub.max()))
        for k, res in zip(keys, results):
            hyps[k] = [system.words[w] for w in res.words] if res else []
    return hyps


def decode_and_score_chain(
    system: ChainSystem,
    opts: Optional[MinilibOptions] = None,
    beam: float = 14.0,
    max_active: int = 2048,
    batch: int = 64,
    noise: Optional[float] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[float, float]:
    """Decode the held-out set with the chain model (frame-subsampling 3,
    acoustic scale 1.0, self-loop-scale-1.0 split-eps graph); returns
    (WER %, audio seconds).  noise: as decode_and_score.  timings: see
    decode_chain_test_set.  The run's WER, error count and the utterances
    with errors land in `decode_and_score_chain.last_stats`."""
    opts = opts or MinilibOptions()
    test_waves, test_text = make_test_set(opts, noise=noise)
    hyps = decode_chain_test_set(system, test_waves, beam, max_active, batch, timings)
    stats = compute_wer({k: list(v) for k, v in test_text.items()}, hyps)
    audio_s = sum(w.shape[0] for w in test_waves.values()) / SAMP_FREQ
    decode_and_score_chain.last_stats = _score_stats(stats, test_text, hyps, noise)
    log.info("minilib chain decode: %s over %.0f audio-s", stats.report(), audio_s)
    return stats.wer, audio_s


# ---------------------------------------------------------------------------
# lattice rescoring: pruned trigram → full higher-order LM
# ---------------------------------------------------------------------------

def rescore_lm(opts: Optional[MinilibOptions] = None, full_lm_order: int = 0) -> ArpaLm:
    """The full `full_lm_order`-gram (0: opts.lm_order) that rescore_and_score
    rescores with, estimated from the synthesised LM text (host work)."""
    opts = opts or MinilibOptions()
    order = full_lm_order or opts.lm_order
    sents = [_to_words(s) for s in make_text(opts, opts.lm_sentences, opts.seed + 2)]
    return estimate_ngram_lm(sents, order=order, cutoffs=(0, 0, 1) + (1,) * max(0, order - 3))


def rescore_and_score(
    system: MinilibSystem,
    opts: Optional[MinilibOptions] = None,
    beam: float = 14.0,
    max_active: int = 1024,
    lattice_beam: float = 8.0,
    lattice_budget: int = 0,  # 0 = auto (2·max_active records a frame)
    batch: int = 16,
    num_utts: int = 0,
    noise: Optional[float] = None,
    full_lm_order: int = 0,
    compute_oracle: bool = False,
    timings: Optional[Dict[str, float]] = None,
    lms: Optional[Dict[str, ArpaLm]] = None,
    full_lm: Optional[ArpaLm] = None,
) -> Tuple[float, float]:
    """Decode with the pruned-trigram HCLG keeping lattices (bounded device
    records), determinize each lattice exactly within `lattice_beam`, then
    rescore pruned trigram → full `full_lm_order`-gram (0: opts.lm_order)
    estimated from the synthesised LM text (reference
    lattice-lmrescore-const-arpa over the fglarge 4-gram).  Returns
    (WER before, WER after) over the first `num_utts` (0 = all) held-out
    utterances by name; the run's numbers, with the lattice oracle WER when
    `compute_oracle` and each utterance's live lattice records, land in
    `rescore_and_score.last_stats`.

    timings: a dict that receives the host-clock seconds of each stage
    (`lm_estimate_seconds`, `arpa_parse_seconds`, `front_end_seconds`,
    `acoustic_model_seconds`, `search_seconds`, `record_transfer_seconds`,
    `lattice_build_seconds` (rebuild and best path), `oracle_seconds`,
    `determinize_seconds`, `rescore_seconds`) and the decoder's record
    counts (`lattice_records_live`, `lattice_record_slots`,
    `lattice_overflow_fallbacks`).
    lms: a dict that receives the two LMs, "full" (the estimate) and
    "pruned" (arpa.txt.gz's), for a caller that rescores with them again.
    full_lm: `rescore_lm(opts, full_lm_order)` made elsewhere (e.g. in a
    spawned process while the caller decodes), in place of the estimate."""
    opts = opts or MinilibOptions()
    dev = system.am.device
    clock = StageClock(dev, timings)
    if full_lm is None:
        full_lm = rescore_lm(opts, full_lm_order)
    clock.lap("lm_estimate_seconds")
    with gzip.open(os.path.join(system.workdir, "arpa.txt.gz"), "rt") as f:
        pruned_lm = parse_arpa(f.read())
    clock.lap("arpa_parse_seconds")
    if lms is not None:
        lms.update(full=full_lm, pruned=pruned_lm)

    test_waves, test_text = system.test_waves, system.test_text
    if noise is not None:
        test_waves, test_text = make_test_set(opts, noise=noise)
    keys_all = sorted(test_waves)
    if num_utts:
        keys_all = keys_all[:num_utts]
    feats = compute_feats({k: test_waves[k] for k in keys_all}, device=dev)
    clock.lap("front_end_seconds")
    word_id = {w: i for i, w in enumerate(system.words)}
    vopts = ViterbiOptions(beam=beam, max_active=max_active, acoustic_scale=1.0)
    base_hyps: Dict[str, List[str]] = {}
    resc_hyps: Dict[str, List[str]] = {}
    refs: Dict[str, List[str]] = {}
    oracle_errs = oracle_ref = 0
    live: Dict[str, int] = {}
    by_dur = sorted(feats, key=lambda k: feats[k].shape[0])
    for lo in range(0, len(by_dur), batch):
        chunk = by_dur[lo: lo + batch]
        keys, padded, nf = pad_feature_batch({k: feats[k] for k in chunk})
        T = padded.shape[1]
        padded = np.pad(padded, ((0, 0), (0, -(-T // 128) * 128 - T), (0, 0)))
        clock.lap(None)
        ll = system.am.loglikes_batch(padded)
        clock.lap("acoustic_model_seconds")
        results = decode_batch_tokens(
            system.csr, ll, nf, vopts, want_lattice=True, lattice_beam=lattice_beam,
            lattice_budget=lattice_budget, device=dev, timings=timings)
        clock.lap(None)  # the decoder times its own stages
        for k, res in zip(keys, results):
            refs[k] = list(test_text[k])
            if res is not None and res.token_lattice is not None:
                live[k] = int((res.token_lattice.arc >= 0).sum())
            lat = (None if res is None or res.token_lattice is None
                   else lattice_from_token_records(system.csr, res.token_lattice))
            if lat is None:
                base_hyps[k] = resc_hyps[k] = []
                oracle_errs += len(refs[k])
                oracle_ref += len(refs[k])
                clock.lap("lattice_build_seconds")
                continue
            words, _t, _c = lattice_best_path(lat, 1.0, 1.0)
            base_hyps[k] = [system.words[w] for w in words]
            clock.lap("lattice_build_seconds")
            if compute_oracle:
                ref_ids = [word_id[w] for w in refs[k]]
                errs, _p = lattice_oracle(lat, ref_ids)
                oracle_errs += errs
                oracle_ref += len(ref_ids)
                clock.lap("oracle_seconds")
            clat = determinize_lattice_pruned(lat, lattice_beam, acoustic_scale=1.0)
            clock.lap("determinize_seconds")
            resc = lmrescore_compact_lattice(clat, system.words, full_lm, pruned_lm)
            w2, _tids, _cost = resc.best_path(lm_scale=1.0, ac_scale=1.0)
            resc_hyps[k] = [system.words[w] for w in w2]
            clock.lap("rescore_seconds")
    before = compute_wer(refs, base_hyps)
    after = compute_wer(refs, resc_hyps)
    oracle_wer = (100.0 * oracle_errs / max(oracle_ref, 1)
                  if compute_oracle else None)
    rescore_and_score.last_stats = {
        "before": before.wer, "after": after.wer,
        "oracle_wer": oracle_wer, "num_utts": len(keys_all),
        "full_lm_order": full_lm.order, "noise": noise, "live_records": live,
    }
    log.info("minilib rescore (%d utts, noise %s): pruned trigram %s → full "
             "%d-gram %s%s", len(keys_all), noise, before.report(), full_lm.order,
             after.report(),
             f" (lattice oracle WER {oracle_wer:.2f})" if compute_oracle else "")
    return before.wer, after.wer


# ---------------------------------------------------------------------------
# forced alignment of the training set
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AlignmentResult:
    alignments: Dict[str, np.ndarray]  # utt → transition-ids, one a frame
    failed: List[str]  # utterances that found no path (no entry above)
    scores: Dict[str, float]  # utt → best path cost
    seconds: Dict[str, float]  # by stage: lang, graphs, features, loglikes, align
    frames_scanned: int  # frames the alignment scan ran (K1 three times each)
    graphs: Dict[str, CsrGraph]  # utt → its training graph


def align_training_set(workdir: str, feats: Dict[str, np.ndarray],
                       text: Dict[str, List[str]], model: str = "tri",
                       equal: bool = False, lang: Optional[Lang] = None,
                       device: DeviceLike = None) -> AlignmentResult:
    """Forced alignment of in-memory features against their transcripts
    (reference compile-train-graphs, then gmm-align-compiled, or
    align-equal-compiled with `equal`; the JAX package's train tools'
    `_batch_align`).

    model "tri": `tri.mdl` on the tree of `tree.pkl`; "mono": `mono.mdl` on
    the monophone tree of its topology over the lang's real phones, as the
    mono recipe builds it.  The alignment runs at GmmTrainOptions' acoustic
    scale (0.1); `equal` aligns on zero loglikes at acoustic scale 1.0, as
    mono training starts.  `lang` is built from the lexicon when not given
    (its seconds are then the "lang" stage).  Each stage ends with a device
    synchronise."""
    dev = resolve_device(device)
    seconds: Dict[str, float] = {}
    clock = StageClock(dev, seconds)
    if lang is None:
        lang = make_lang()
    clock.lap("lang_seconds")
    gmm = AmGmmModel.load(os.path.join(workdir, f"{model}.mdl"), device=dev)
    if model == "tri":
        ctx_dep = convert.context_dependency_from_pickle(
            convert.load_pickle(os.path.join(workdir, "tree.pkl"))[0])
    elif model == "mono":
        topo = gmm.tm.topo
        phones = lang.real_phone_ids
        ctx_dep = monophone_context_dependency(
            phones, {p: topo.num_pdf_classes(p) for p in phones})
    else:
        raise KaldiError(f"unknown GMM model {model!r}: 'tri' or 'mono'")
    keys = sorted(feats)
    compiler = GraphCompiler(lang, ctx_dep, gmm.tm)
    graphs = compiler.compile_csr_graphs([text[k] for k in keys])
    clock.lap("graphs_seconds")
    _, padded, nf = pad_feature_batch(feats, keys)
    x = torch.from_numpy(padded).to(dev)
    clock.lap("features_seconds")
    if equal:
        # zero loglikes at scale 1.0: each utterance's cheapest path of its
        # length through its graph
        ll = torch.zeros((len(keys), x.shape[1], gmm.am.num_pdfs), device=dev)
        clock.lap("loglikes_seconds")
        alis, costs = align_batch(graphs, ll, nf, ViterbiOptions(acoustic_scale=1.0),
                                  device=dev, timings=seconds)
    else:
        alis, costs = align_all(
            gmm.am, graphs, x, nf,
            ViterbiOptions(acoustic_scale=GmmTrainOptions().acoustic_scale),
            timings=seconds)
    frames = int(seconds.pop("align_frames"))
    return AlignmentResult(
        alignments={k: a for k, a in zip(keys, alis) if a is not None},
        failed=[k for k, a in zip(keys, alis) if a is None],
        scores={k: c for k, c in zip(keys, costs)},
        seconds=seconds, frames_scanned=frames, graphs=dict(zip(keys, graphs)))


# ---------------------------------------------------------------------------
# GMM training: the JAX package's build_system stages 3 (mono) and 4 (tri)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainResult:
    model: AmGmmModel
    alignments: Dict[str, np.ndarray]  # utt → transition-ids, one a frame
    timings: Dict[str, float]  # by stage (gmm_training_loop's keys and the set-up's)
    history: List[dict]  # one dict an iteration (gmm_training_loop)
    tree: Optional[ContextDependency] = None  # the triphone tree (train_tri_system)


def train_mono_system(workdir_out: Optional[str], feats: Dict[str, np.ndarray],
                      text: Dict[str, List[str]], lang: Lang,
                      opts: Optional[MinilibOptions] = None,
                      device: DeviceLike = None) -> TrainResult:
    """Stage 3 of the JAX package's build_system: flat-start monophone
    training on `feats` (the training set's, `training_set` and
    `compute_feats`) for opts.mono_iters iterations towards
    opts.mono_totgauss Gaussians, on `device`.  With `workdir_out`, writes
    `mono.mdl` there."""
    opts = opts or MinilibOptions()
    timings: Dict[str, float] = {}
    history: List[dict] = []
    model, ali = train_mono(feats, text, lang,
                            MonoTrainOptions(num_iters=opts.mono_iters,
                                             totgauss=opts.mono_totgauss),
                            device=device, timings=timings, history=history)
    if workdir_out:
        os.makedirs(workdir_out, exist_ok=True)
        model.save(os.path.join(workdir_out, "mono.mdl"))
    return TrainResult(model, ali, timings, history)


def train_tri_system(workdir_out: Optional[str], feats: Dict[str, np.ndarray],
                     text: Dict[str, List[str]], lang: Lang,
                     opts: Optional[MinilibOptions] = None,
                     device: DeviceLike = None,
                     mono_workdir: str = "exp/minilib") -> TrainResult:
    """Stage 4 of the JAX package's build_system: the triphone tree of
    opts.tree_leaves leaves (thresh 20) from `mono.mdl` and `mono_ali.pkl`
    in `mono_workdir` (the committed system's by default, as the JAX stage
    reads its own stage 3), then opts.tri_iters iterations realigning at
    1, 3, 5, … towards opts.tri_totgauss Gaussians, on `device`.  With
    `workdir_out`, writes `tri.mdl` there."""
    opts = opts or MinilibOptions()
    dev = resolve_device(device)
    timings: Dict[str, float] = {}
    history: List[dict] = []
    clock = StageClock(dev, timings)
    mono = AmGmmModel.load(os.path.join(mono_workdir, "mono.mdl"), device=dev)
    mono_ali = convert.load_pickle(os.path.join(mono_workdir, "mono_ali.pkl"))
    clock.lap("load_seconds")
    model, tree, ali = train_deltas(
        feats, text, lang, mono, mono_ali, num_leaves=opts.tree_leaves,
        opts=GmmTrainOptions(num_iters=opts.tri_iters, totgauss=opts.tri_totgauss,
                             realign_iters=tuple(range(1, opts.tri_iters, 2))),
        device=dev, timings=timings, history=history)
    if workdir_out:
        os.makedirs(workdir_out, exist_ok=True)
        model.save(os.path.join(workdir_out, "tri.mdl"))
    return TrainResult(model, ali, timings, history, tree)


# ---------------------------------------------------------------------------
# neural training: the JAX package's build_system stages 5, 7 and 8
# ---------------------------------------------------------------------------

def _tri_system(gmm_workdir: str) -> Tuple[AmGmmModel, Dict[str, np.ndarray]]:
    """tri.mdl (its transition model and pdf count) and tri_ali.pkl."""
    return (AmGmmModel.load(os.path.join(gmm_workdir, "tri.mdl"), device="cpu"),
            convert.load_pickle(os.path.join(gmm_workdir, "tri_ali.pkl")))


def train_am_system(workdir_out: Optional[str], feats: Dict[str, np.ndarray],
                    opts: Optional[MinilibOptions] = None, device: DeviceLike = None,
                    gmm_workdir: str = "exp/minilib", history: Optional[List[dict]] = None,
                    timings: Optional[Dict[str, float]] = None,
                    config: Optional[TdnnConfig] = None) -> AmNnet:
    """Stage 5 of the JAX package's build_system: CE training of the TDNN-F
    make_tdnnf(39, tri.mdl's pdfs, opts.hidden_dim, opts.bottleneck_dim,
    opts.num_layers) for opts.num_epochs epochs (NnetTrainOptions' other
    defaults) on `feats` (the training set's) labelled by tri_ali.pkl
    through tri.mdl's transition model, on `device`; priors from its
    posteriors.  `config` trains another architecture in its place (e.g.
    make_tdnn_lstm(39, 2000), or make_cnn_tdnnf(40, 2000) on filterbank
    features); its input_dim must be the features'.  With `workdir_out`,
    writes `final.am` there in the port's format.  history, timings:
    train_ce's."""
    opts = opts or MinilibOptions()
    tri, ali = _tri_system(gmm_workdir)
    if config is None:
        config = make_tdnnf(39, tri.am.num_pdfs, opts.hidden_dim, opts.bottleneck_dim,
                            opts.num_layers)
    am = train_tdnn(tri, feats, ali, opts=NnetTrainOptions(num_epochs=opts.num_epochs),
                    config=config, device=device, history=history, timings=timings)
    if workdir_out:
        os.makedirs(workdir_out, exist_ok=True)
        am.save(os.path.join(workdir_out, "final.am"))
    return am


def chain_train_options(opts: MinilibOptions) -> ChainTrainOptions:
    """Stage 7's options: opts.chain_epochs epochs of minibatch 8, the TDNN-F
    widths of opts, an order-3 phone LM, a left-biphone tree of up to
    opts.tree_leaves leaves."""
    return ChainTrainOptions(
        num_epochs=opts.chain_epochs or opts.num_epochs, minibatch_size=8,
        hidden_dim=opts.hidden_dim, bottleneck_dim=opts.bottleneck_dim,
        num_layers=opts.num_layers, phone_lm_order=3, tree_context_width=2,
        tree_max_leaves=opts.tree_leaves)


def train_chain_system(feats: Dict[str, np.ndarray], lang: Lang,
                       opts: Optional[MinilibOptions] = None, device: DeviceLike = None,
                       gmm_workdir: str = "exp/minilib",
                       history: Optional[List[dict]] = None,
                       report: Optional[dict] = None) -> ChainSystem:
    """Stages 7 and 8 of the JAX package's build_system, in memory: train_chain
    on `feats` (the training set's) with tri.mdl and tri_ali.pkl at
    `chain_train_options(opts)` on `device`, then the trained model's own
    chain graph (G from the pruned trigram `arpa.txt.gz`, mkgraph at
    self-loop-scale 1.0, split-eps).  history, report: train_chain's; report
    also receives `g_seconds`, `g_states`, `g_arcs`, mkgraph_csr's stage
    seconds, `hclg_states`, `hclg_arcs` and `hclg_backoff_arcs`."""
    opts = opts or MinilibOptions()
    report = {} if report is None else report
    model = train_chain_model(feats, lang, opts, device, gmm_workdir, history, report)
    csr, graph_report = chain_graph(model.ctx_dep, model.tm, lang, opts, gmm_workdir)
    report.update(graph_report)
    return ChainSystem(word_table(make_lexicon(opts)), csr, model)


def train_chain_model(feats: Dict[str, np.ndarray], lang: Lang,
                      opts: Optional[MinilibOptions] = None, device: DeviceLike = None,
                      gmm_workdir: str = "exp/minilib",
                      history: Optional[List[dict]] = None,
                      report: Optional[dict] = None) -> ChainModel:
    """Stage 7: train_chain on `feats` with tri.mdl and tri_ali.pkl at
    `chain_train_options(opts)` on `device` (history, report: train_chain's)."""
    tri, ali = _tri_system(gmm_workdir)
    return train_chain(tri, feats, ali, lang, chain_train_options(opts or MinilibOptions()),
                       device=device, history=history, report=report)


def chain_graph(ctx_dep: ContextDependency, tm: TransitionModel, lang: Optional[Lang] = None,
                opts: Optional[MinilibOptions] = None, gmm_workdir: str = "exp/minilib"
                ) -> Tuple[CsrGraph, dict]:
    """Stage 8: the split-eps decoding graph of a chain model's tree and
    transition model (G from the pruned trigram `arpa.txt.gz`, mkgraph at
    self-loop-scale 1.0: recipes/chain.make_chain_decode_graph's), host
    work; lang None: make_lang(opts).  Its arguments pickle, so a spawned
    process can build it while the caller goes on.  Returns (graph, report
    of `g_seconds`, `g_states`, `g_arcs`, mkgraph_csr's stage seconds,
    `hclg_states`, `hclg_arcs`, `hclg_backoff_arcs`)."""
    lang = lang or make_lang(opts)
    report: dict = {}
    t0 = time.perf_counter()
    with gzip.open(os.path.join(gmm_workdir, "arpa.txt.gz"), "rt") as f:
        g = arpa_to_fst(parse_arpa(f.read()), lang.words)
    report.update(g_seconds=time.perf_counter() - t0, g_states=g.num_states,
                  g_arcs=g.num_arcs)
    csr = mkgraph_csr(lang, g, ctx_dep, tm, self_loop_scale=1.0, split_eps=True,
                      timings=report)
    report.update(hclg_states=csr.num_states, hclg_arcs=csr.num_arcs,
                  hclg_backoff_arcs=int((csr.eps_ns >= 0).sum()) if csr.eps_ns is not None
                  else 0)
    return csr, report


def check_same_tree(model_tree: ContextDependency, graph_tree: ContextDependency,
                    model_name: str, graph_name: str) -> None:
    """Raise unless a model's tree is the tree its decoding graph was built
    from: a graph of another tree reads other pdfs under the same tids."""
    if tree_key(model_tree) != tree_key(graph_tree):
        raise KaldiError(
            f"{model_name} has a tree of {model_tree.num_pdfs} pdfs that differs from the "
            f"tree of {graph_name} ({graph_tree.num_pdfs} pdfs): it cannot decode on that "
            "graph")


def on_graph_of(system: ChainSystem, model: ChainModel,
                ext: Optional[IvectorExtractor] = None) -> ChainSystem:
    """`model` decoding on `system`'s graph (stage 11's chain+iVec model on
    stage 8's): raises unless their trees are equal."""
    check_same_tree(model.ctx_dep, system.model.ctx_dep, "the chain model",
                    "the chain system's graph")
    return ChainSystem(system.words, system.csr, model, ext)


# ---------------------------------------------------------------------------
# iVector training: the JAX package's build_system stages 9, 10 and 11
# ---------------------------------------------------------------------------

def train_ivector_system(workdir_out: Optional[str], feats: Dict[str, np.ndarray],
                         opts: Optional[MinilibOptions] = None, device: DeviceLike = None,
                         history: Optional[Dict[str, List[dict]]] = None
                         ) -> IvectorExtractor:
    """Stage 9 of the JAX package's build_system: a diagonal UBM of
    opts.ivector_ubm_gauss Gaussians (6 iterations) on every fourth frame of
    the training features pooled in key order, then the extractor of
    opts.ivector_dim-dim iVectors (4 iterations) over every utterance, on
    `device`.  With `workdir_out`, writes `final.ie` there.  history:
    receives `ubm` and `extractor`, train_ubm's and
    train_ivector_extractor's per-iteration dicts."""
    opts = opts or MinilibOptions()
    utts = [feats[k] for k in sorted(feats)]
    hist = {"ubm": [], "extractor": []} if history is None else history
    hist.setdefault("ubm", [])
    hist.setdefault("extractor", [])
    ubm = train_ubm(np.concatenate(utts)[::4], num_gauss=opts.ivector_ubm_gauss,
                    num_iters=6, device=device, history=hist["ubm"])
    ext = train_ivector_extractor(ubm, utts, ivector_dim=opts.ivector_dim, num_iters=4,
                                  device=device, history=hist["extractor"])
    if workdir_out:
        os.makedirs(workdir_out, exist_ok=True)
        ext.save(os.path.join(workdir_out, "final.ie"))
    return ext


def train_am_ivec_system(workdir_out: Optional[str], feats: Dict[str, np.ndarray],
                         ext: IvectorExtractor, opts: Optional[MinilibOptions] = None,
                         device: DeviceLike = None, gmm_workdir: str = "exp/minilib",
                         history: Optional[List[dict]] = None,
                         timings: Optional[Dict[str, float]] = None) -> AmNnet:
    """Stage 10: online iVectors every opts.ivector_period frames from `ext`,
    then stage 5's CE training of make_tdnnf(39 + opts.ivector_dim, ...) on
    the features with them appended.  With `workdir_out`, writes
    `final_ivec.am` there."""
    opts = opts or MinilibOptions()
    tri, ali = _tri_system(gmm_workdir)
    ivecs = compute_ivectors(ext, feats, opts.ivector_period)
    config = make_tdnnf(39 + ext.ivector_dim, tri.am.num_pdfs, opts.hidden_dim,
                        opts.bottleneck_dim, opts.num_layers)
    am = train_tdnn(tri, feats, ali, opts=NnetTrainOptions(num_epochs=opts.num_epochs),
                    config=config, ivectors=ivecs, device=device, history=history,
                    timings=timings)
    if workdir_out:
        os.makedirs(workdir_out, exist_ok=True)
        am.save(os.path.join(workdir_out, "final_ivec.am"))
    return am


def train_chain_ivec_system(feats: Dict[str, np.ndarray], lang: Lang, ext: IvectorExtractor,
                            opts: Optional[MinilibOptions] = None, device: DeviceLike = None,
                            gmm_workdir: str = "exp/minilib",
                            history: Optional[List[dict]] = None,
                            report: Optional[dict] = None) -> ChainModel:
    """Stage 11: train_chain at stage 7's options on the features with online
    iVectors from `ext` appended; its tree comes from the features without
    them, so it is stage 7's tree on the same features."""
    opts = opts or MinilibOptions()
    tri, ali = _tri_system(gmm_workdir)
    return train_chain(tri, feats, ali, lang, chain_train_options(opts),
                       ivectors=compute_ivectors(ext, feats, opts.ivector_period),
                       device=device, history=history, report=report)


# ---------------------------------------------------------------------------
# the stage-gated system build
# ---------------------------------------------------------------------------

def save_csr(path: str, csr: CsrGraph, omit_pdf: bool = False) -> None:
    """A graph as the JAX package's save_csr writes it (np.savez_compressed);
    omit_pdf drops the per-arc pdf array, which load_csr rebuilds from the
    model's tid → pdf map."""
    def flat(ol) -> FlatOlabels:
        if isinstance(ol, FlatOlabels):
            return ol
        off = np.zeros(len(ol) + 1, np.int32)
        vals: List[int] = []
        for i, t in enumerate(ol):
            vals.extend(t)
            off[i + 1] = len(vals)
        return FlatOlabels(off, np.asarray(vals, np.int32))

    ol, fol = flat(csr.arc_olabels), flat(csr.final_olabels)
    extra = {}
    if csr.eps_ns is not None:
        extra = dict(eps_ns=csr.eps_ns, eps_w=csr.eps_w, eps_olab=csr.eps_olab,
                     eps_depth=np.int32(csr.eps_depth))
    if not omit_pdf:
        extra["pdf"] = csr.pdf
    np.savez_compressed(path, start=np.int32(csr.start), row_ptr=csr.row_ptr, tid=csr.tid,
                        weight=csr.weight, nextstate=csr.nextstate,
                        final_weight=csr.final_weight, olab_off=ol.offsets,
                        olab_val=ol.values, folab_off=fol.offsets, folab_val=fol.values,
                        **extra)


def _dump_pkl_gz(path: str, obj) -> None:
    with gzip.open(path, "wb", compresslevel=6) as f:
        pickle.dump(obj, f, protocol=4)


def _load_lang(workdir: str, opts: MinilibOptions) -> Lang:
    """Stage 1's `lang.pkl` when the port wrote it; else the lang bundle
    rebuilt from the lexicon (the committed system does not keep it)."""
    path = os.path.join(workdir, "lang.pkl")
    if os.path.exists(path):
        lang = convert.load_pickle(path)
        if isinstance(lang, Lang):
            return lang
    return make_lang(opts)


def _load_tree(workdir: str) -> Tuple[ContextDependency, "object"]:
    """`tree.pkl`: (tree, transition model), pickled by the JAX package or
    by the port's stage 4."""
    ctx_dep, tm = convert.load_pickle(os.path.join(workdir, "tree.pkl"))
    return (convert.context_dependency_from_pickle(ctx_dep),
            convert.transition_model_from_pickle(tm))


def _grammar(workdir: str, lang: Lang):
    with gzip.open(os.path.join(workdir, "arpa.txt.gz"), "rt") as f:
        g = arpa_to_fst(parse_arpa(f.read()), lang.words)
    g.arcsort("ilabel")
    return g


def _build_hclg(workdir: str, opts: MinilibOptions) -> CsrGraph:
    """Stage 6's folded HCLG from the pruned trigram and tree.pkl's tree.
    (The JAX package also writes the upstream-format HCLG.fst here; the
    port does not: no stage and no ported path reads it.)"""
    lang = _load_lang(workdir, opts)
    ctx_dep, tm = _load_tree(workdir)
    return mkgraph_csr(lang, _grammar(workdir, lang), ctx_dep, tm)


def build_system(workdir: str, opts: Optional[MinilibOptions] = None, stage: int = 0,
                 device: DeviceLike = None) -> None:
    """Build every artifact of the system under `workdir`, on `device`
    (None: the GPU), stage by stage as the JAX package's build_system:
    1 lang, 2 LM, 3 mono, 4 tri, 5 CE am, 6 HCLG, 7 chain, 8 chain HCLG,
    9 final.ie, 10 final_ivec.am, 11 chain_ivec.mdl.  Stages below `stage`,
    and stages whose artifacts exist, are skipped.  The stages read the
    earlier stages' artifacts from `workdir` (stage 4 reads stage 3's),
    and the training set's features are computed once a run."""
    opts = opts or MinilibOptions()
    dev = resolve_device(device)
    pipe = Pipeline(workdir, stage=stage, log_to_files=False)
    cache: dict = {}

    def train_data():
        if "feats" not in cache:
            waves, text = training_set(opts)
            cache["feats"], cache["text"] = compute_feats(waves, device=dev), text
        return cache["feats"], cache["text"]

    @pipe.stage(1, "lang", produces="lang.pkl")
    def _lang(ctx):
        with open(ctx.path("lang.pkl"), "wb") as f:
            pickle.dump(make_lang(opts), f, protocol=4)

    @pipe.stage(2, "lm", produces="arpa.txt.gz")
    def _lm(ctx):
        sents = [_to_words(s) for s in make_text(opts, opts.lm_sentences, opts.seed + 2)]
        lm = estimate_ngram_lm(sents, order=opts.lm_order, cutoffs=(0, 0, 1))
        lm = prune_ngram_lm(lm, threshold=opts.prune_threshold)
        heldout = [_to_words(s) for s in make_text(opts, 200, opts.seed + 3)]
        log.info("lm: held-out perplexity %.1f", perplexity(lm, heldout))
        tmp = ctx.path("arpa.txt")
        write_arpa(lm, tmp)
        with open(tmp, "rb") as f, gzip.open(ctx.path("arpa.txt.gz"), "wb") as g:
            g.write(f.read())
        os.remove(tmp)

    @pipe.stage(3, "mono", produces=("mono.mdl", "mono_ali.pkl"))
    def _mono(ctx):
        feats, text = train_data()
        res = train_mono_system(workdir, feats, text, _load_lang(workdir, opts), opts, dev)
        _dump_pkl_gz(ctx.path("mono_ali.pkl"), res.alignments)

    @pipe.stage(4, "tri", produces=("tri.mdl", "tri_ali.pkl", "tree.pkl"))
    def _tri(ctx):
        feats, text = train_data()
        res = train_tri_system(workdir, feats, text, _load_lang(workdir, opts), opts, dev,
                               mono_workdir=workdir)
        _dump_pkl_gz(ctx.path("tri_ali.pkl"), res.alignments)
        with open(ctx.path("tree.pkl"), "wb") as f:
            pickle.dump((res.tree, res.model.tm), f, protocol=4)

    @pipe.stage(5, "am", produces="final.am")
    def _am(ctx):
        train_am_system(workdir, train_data()[0], opts, dev, gmm_workdir=workdir)

    @pipe.stage(6, "hclg", produces="hclg.npz")
    def _hclg(ctx):
        save_csr(ctx.path("hclg.npz"), _build_hclg(workdir, opts), omit_pdf=True)

    @pipe.stage(7, "chain", produces="chain.mdl")
    def _chain(ctx):
        tri, ali = _tri_system(workdir)
        train_chain(tri, train_data()[0], ali, _load_lang(workdir, opts),
                    chain_train_options(opts), device=dev).save(ctx.path("chain.mdl"))

    @pipe.stage(8, "chain_hclg", produces="chain_hclg.npz")
    def _chain_hclg(ctx):
        lang = _load_lang(workdir, opts)
        cm = ChainModel.load(ctx.path("chain.mdl"), device="cpu")
        save_csr(ctx.path("chain_hclg.npz"),
                 make_chain_decode_graph(cm, lang, _grammar(workdir, lang), split_eps=True),
                 omit_pdf=True)

    @pipe.stage(9, "ivector", produces="final.ie")
    def _ivector(ctx):
        train_ivector_system(workdir, train_data()[0], opts, dev)

    @pipe.stage(10, "am_ivec", produces="final_ivec.am")
    def _am_ivec(ctx):
        ext = IvectorExtractor.load(ctx.path("final.ie"), device=dev)
        train_am_ivec_system(workdir, train_data()[0], ext, opts, dev, gmm_workdir=workdir)

    @pipe.stage(11, "chain_ivec", produces="chain_ivec.mdl")
    def _chain_ivec(ctx):
        ext = IvectorExtractor.load(ctx.path("final.ie"), device=dev)
        train_chain_ivec_system(train_data()[0], _load_lang(workdir, opts), ext, opts, dev,
                                gmm_workdir=workdir).save(ctx.path("chain_ivec.mdl"))

    pipe.run()


def export_upstream_artifacts(workdir: str, opts: Optional[MinilibOptions] = None,
                              num_utts: int = 8, device: DeviceLike = None
                              ) -> Dict[str, dict]:
    """Write the system's artifacts in the UPSTREAM byte formats and read
    each one back (the JAX package's export_upstream_artifacts):

      final.mdl — the triphone GMM system, Kaldi binary (tri.mdl's bytes;
                  final.mdl is the reference name);
      HCLG.fst  — the decode graph's OpenFst VectorFst<StdArc> bytes, read
                  back as arrays when the graph build wrote it;
      lat.1.gz  — the first num_utts held-out utterances decoded with
                  lattice records on `device` (default the card),
                  determinized, as gzipped CompactLattice ark cells
                  (`key \0B <clat bytes>`).

    Returns {file: {"bytes", "read_seconds", and what was read back}}."""
    import shutil

    from old_kaldi_git_tpu_torch.fst.kaldi_fst_io import (
        read_compact_lattice_kaldi, read_fst_kaldi_arrays, write_compact_lattice_kaldi)

    opts = opts or MinilibOptions()
    report: Dict[str, dict] = {}
    # 1. final.mdl (Kaldi binary GMM system)
    mdl = os.path.join(workdir, "final.mdl")
    if not os.path.exists(mdl):
        shutil.copyfile(os.path.join(workdir, "tri.mdl"), mdl)
    t0 = time.perf_counter()
    m = AmGmmModel.load(mdl, device=device)
    if m.am.num_pdfs <= 0:
        raise KaldiError(f"{mdl}: no pdfs read back")
    report["final.mdl"] = {"bytes": os.path.getsize(mdl), "num_pdfs": m.am.num_pdfs,
                           "read_seconds": time.perf_counter() - t0}
    log.info("final.mdl: %d pdfs (Kaldi binary, read back)", m.am.num_pdfs)
    # 2. HCLG.fst (OpenFst bytes), when the graph build wrote it
    fst_path = os.path.join(workdir, "HCLG.fst")
    if os.path.exists(fst_path):
        t0 = time.perf_counter()
        with open(fst_path, "rb") as f:
            _start, rp, il, _ol, _w, _ns, _fin = read_fst_kaldi_arrays(f)
        report["HCLG.fst"] = {"bytes": os.path.getsize(fst_path), "states": len(rp) - 1,
                              "arcs": len(il), "read_seconds": time.perf_counter() - t0}
        log.info("HCLG.fst: %d states / %d arcs (OpenFst bytes, read back)",
                 len(rp) - 1, len(il))
    # 3. lat.1.gz: decode with lattice records, determinize, write the cells
    system = load_system(workdir, opts, device=device)
    keys = sorted(system.test_waves)[:num_utts]
    feats = compute_feats({k: system.test_waves[k] for k in keys}, device=system.am.device)
    keys, padded, nf = pad_feature_batch(feats)
    ll = system.am.loglikes_batch(padded)
    results = decode_batch_tokens(
        system.csr, ll, nf, ViterbiOptions(beam=14.0, max_active=2048, acoustic_scale=1.0),
        want_lattice=True, lattice_beam=8.0, lattice_budget=128, device=system.am.device)
    lat_path = os.path.join(workdir, "lat.1.gz")
    n_written = 0
    with gzip.open(lat_path, "wb") as f:
        for k, res in zip(keys, results):
            if res is None or res.token_lattice is None:
                continue
            lat = lattice_from_token_records(system.csr, res.token_lattice)
            if lat is None:
                continue
            clat = determinize_lattice_pruned(lat, 8.0, acoustic_scale=1.0)
            f.write(k.encode() + b" \0B")
            write_compact_lattice_kaldi(f, clat)
            n_written += 1
    # read the archive back (upstream cell framing: key, space, \0B, body)
    t0 = time.perf_counter()
    n_read = 0
    with gzip.open(lat_path, "rb") as f:
        while True:
            key = b""
            c = f.read(1)
            if not c:
                break
            while c != b" ":
                key += c
                c = f.read(1)
            if f.read(2) != b"\0B":
                raise KaldiError(f"{lat_path}: cell {key!r} is not binary")
            if read_compact_lattice_kaldi(f).num_states <= 0:
                raise KaldiError(f"{lat_path}: cell {key!r} is empty")
            n_read += 1
    if n_read != n_written:
        raise KaldiError(f"{lat_path}: {n_read} cells read back of {n_written}")
    report["lat.1.gz"] = {"bytes": os.path.getsize(lat_path), "cells": n_read,
                          "read_seconds": time.perf_counter() - t0}
    log.info("lat.1.gz: %d CompactLattice cells (upstream ark bytes, read back)", n_read)
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Build the minilib system stage by stage on the GPU (stages 1-11; "
                    "a stage whose artifacts exist is skipped)")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--stage", type=int, default=0, help="skip the stages below this one")
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)
    build_system(args.workdir, MinilibOptions(), stage=args.stage, device=args.device)


if __name__ == "__main__":
    main()
