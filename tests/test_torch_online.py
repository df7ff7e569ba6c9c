"""Streaming in the port vs its batch path and vs the JAX package, on the CPU.

OnlineFeaturePipeline: chunked output equals whole-stream output within
1e-4 (the JAX package's own rule, tests/test_online.py) and the JAX
pipeline within 1e-3 + 1e-5·max|feature| (the front-end rule of the port);
with an online iVector extractor, the appended iVectors equal
extract_online_ivectors over the pipeline's own base frames exactly.
StreamingAmNnet: tests/test_torch_online_am.py; StreamingTokenDecoder:
tests/test_torch_online_decoder.py (both use the helpers here).  The new
entry points default to the GPU and raise without one.  Slow: the online2 path (pipeline with online iVectors
into the CE+iVec model on hclg.npz) on 16 held-out utterances, words equal
to the JAX package's."""

import tests.torch_threads  # noqa: F401
import os

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu.feat.compute as jcompute
import old_kaldi_git_tpu.ivector.extractor as jiv
import old_kaldi_git_tpu.models.am_nnet as jam
import old_kaldi_git_tpu.online.streaming as jstream
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
import old_kaldi_git_tpu_torch.ivector.extractor as tiv
import old_kaldi_git_tpu_torch.online.streaming as tstream
from old_kaldi_git_tpu_torch.feat import MfccOptions
from old_kaldi_git_tpu_torch.models.streaming_am import StreamingAmNnet
from tests.test_online import _backoff_split_system, _loglikes_for, _toy_decode_system
from tests.test_torch_chain import port_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")


def _mfcc_opts(opts_cls):
    opts = opts_cls()
    opts.frame_opts.dither = 0.0
    opts.frame_opts.samp_freq = 8000.0
    return opts


def _pipeline_outputs(pipe, wave, sizes):
    outs, pos = [], 0
    for sz in sizes:
        outs.append(pipe.accept_waveform(wave[pos: pos + sz]))
        pos += sz
    outs.append(pipe.accept_waveform(wave[pos:]))
    outs.append(pipe.input_finished())
    return np.concatenate([o for o in outs if o.size])


# ---------------------------------------------------------------------------
# OnlineFeaturePipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("add_deltas,global_stats", [(True, False), (False, False),
                                                     (True, True)])
def test_pipeline_chunked_equals_whole_and_the_jax_pipeline(add_deltas, global_stats):
    rng = np.random.default_rng(0)
    wave = (rng.normal(size=9000) * 800).astype(np.float32)
    stats = None
    if global_stats:  # [2, D+1]: sums over 50 frames, then the count
        stats = np.zeros((2, 14))
        stats[0, :13] = rng.normal(size=13) * 50
        stats[0, 13] = 50.0
    kw = dict(add_deltas=add_deltas, global_cmvn_stats=stats)
    whole = _pipeline_outputs(
        tstream.OnlineFeaturePipeline(_mfcc_opts(MfccOptions), device="cpu", **kw),
        wave, [])
    chunked = _pipeline_outputs(
        tstream.OnlineFeaturePipeline(_mfcc_opts(MfccOptions), device="cpu", **kw),
        wave, [100, 757, 1200, 3000, 1943])
    want = _pipeline_outputs(
        jstream.OnlineFeaturePipeline(_mfcc_opts(jcompute.MfccOptions), **kw), wave, [])
    assert whole.shape == chunked.shape == want.shape
    assert whole.shape[1] == (39 if add_deltas else 13)
    np.testing.assert_allclose(chunked, whole, rtol=1e-4, atol=1e-4)
    assert np.abs(whole - want).max() <= 1e-3 + 1e-5 * np.abs(want).max()


@pytest.fixture(scope="module")
def extractors():
    path = os.path.join(WORKDIR, "final.ie")
    return jiv.IvectorExtractor.load(path), tiv.IvectorExtractor.load(path, device="cpu")


def test_pipeline_appends_online_ivectors(extractors):
    """final.ie's 39-dim UBM on the pipeline's own deltas: in 3001-sample
    chunks the base frames equal the whole stream's within 1e-4, the
    iVectors equal extract_online_ivectors over those base frames exactly,
    and the JAX extractor on the same frames within 1e-6 relative."""
    je, te = extractors
    rng = np.random.default_rng(3)
    wave = (rng.normal(size=16000) * 1000).astype(np.float32)
    base = _pipeline_outputs(
        tstream.OnlineFeaturePipeline(_mfcc_opts(MfccOptions), device="cpu"), wave, [])
    pipe = tstream.OnlineFeaturePipeline(
        _mfcc_opts(MfccOptions), device="cpu",
        ivector_extractor=tiv.OnlineIvectorExtractor(te, period=10))
    assert pipe.output_dim == 39 + 32
    got = _pipeline_outputs(pipe, wave, [3001] * 5)
    assert got.shape == (base.shape[0], 71)
    np.testing.assert_allclose(got[:, :39], base, rtol=1e-4, atol=1e-4)
    want = tiv.extract_online_ivectors(te, got[:, :39], period=10).numpy()
    np.testing.assert_array_equal(got[:, 39:], want)
    jwant = jiv.extract_online_ivectors(je, got[:, :39], period=10)
    assert np.abs(got[:, 39:] - jwant).max() <= 1e-6 * np.abs(jwant).max()


# ---------------------------------------------------------------------------
# StreamingAmNnet
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# StreamingTokenDecoder
# ---------------------------------------------------------------------------

def _toy_graphs():
    """{name: (JAX CsrGraph, loglikes [T_in, P], options, fsf, quantum,
    silence phones, tid_to_phone)}."""
    lang, _topo, cd, tm, csr = _toy_decode_system()
    _folded, split, _ = _backoff_split_system()
    folded_ll = _loglikes_for(tm, cd, lang, ["Y", "EH", "S"])
    rng = np.random.default_rng(3)
    no_phones = np.zeros(split.tid.max() + 1, np.int32)
    return {
        "folded": (csr, folded_ll,
                   dict(beam=30.0, max_active=64, acoustic_scale=1.0), 1, 32,
                   [lang.silence_id], tm.tid_to_phone_array()),
        "split": (split, rng.normal(size=(25, 12)).astype(np.float32),
                  dict(beam=1e9, max_active=64, acoustic_scale=0.7), 1, 32, [], no_phones),
        "split_fsf3": (split, np.random.default_rng(4).normal(size=(75, 12)).astype(
            np.float32), dict(beam=1e9, max_active=64, acoustic_scale=0.7), 3, 30, [],
            no_phones),
    }


def _chunkings(T, fsf):
    if fsf == 1:  # tests/test_online.py:192
        return [[5] * ((T + 4) // 5), [1] * T, [T], [7, 3, T]]
    return [[30, 30, 15], [T], [10] * 8, [1] * T]


def _feed(dec, ll, chunks):
    T, lo = len(ll), 0
    for n in chunks:
        dec.advance(ll[lo: lo + n], final=lo + n >= T)
        lo += n
        if lo >= T:
            break
    return dec._backtrace()


# ---------------------------------------------------------------------------
# online2 on the committed system (slow)
# ---------------------------------------------------------------------------

def online2_words(pipeline_cls, ext_cls, decoder_cls, graph, am_fn, lctx, rctx,
                  sil, tid_to_phone, vopts, waves, mfcc_opts, chunk=4000, **kw):
    """{utt: word ids}: each wave through the feature pipeline with online
    iVectors in `chunk`-sample pieces, every piece's frames into the
    streaming decoder as they come."""
    out = {}
    dec = decoder_cls(graph, am_fn, sil, tid_to_phone, vopts, am_left_context=lctx,
                      am_right_context=rctx, **kw)
    for k in sorted(waves):
        pipe = pipeline_cls(mfcc_opts, ivector_extractor=ext_cls(), **kw)
        dec.reset()
        w = waves[k]
        for lo in range(0, len(w), chunk):
            dec.advance(pipe.accept_waveform(w[lo: lo + chunk]))
        dec.advance(pipe.input_finished(), final=True)
        out[k] = dec.best_words()
    return out


@pytest.mark.slow
def test_online2_words_equal_the_jax_package():
    import pickle

    import old_kaldi_git_tpu.recipes.minilib as jminilib
    import old_kaldi_git_tpu_torch.recipes.minilib as tminilib
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet

    system = tminilib.load_system(WORKDIR, device="cpu")
    by_dur = sorted(system.test_waves, key=lambda k: len(system.test_waves[k]))
    keys = by_dur[::16][:16]
    waves = {k: system.test_waves[k] for k in keys}
    _cd, jtm = pickle.load(open(os.path.join(WORKDIR, "tree.pkl"), "rb"))
    jlang = jminilib._load_lang(WORKDIR)
    sil = [tminilib.silence_phone_id(tminilib.make_lexicon(tminilib.MinilibOptions()))]
    assert sil == [jlang.silence_id]
    t2p = jtm.tid_to_phone_array()
    path_ie = os.path.join(WORKDIR, "final.ie")
    am = AmNnet.load(os.path.join(WORKDIR, "final_ivec.am"), device="cpu")
    te = tiv.IvectorExtractor.load(path_ie, device="cpu")
    got = online2_words(
        tstream.OnlineFeaturePipeline, lambda: tiv.OnlineIvectorExtractor(te),
        tstream.StreamingTokenDecoder, system.csr, am.loglikes_batch,
        am.config.left_context, am.config.right_context, sil, t2p,
        tvit.ViterbiOptions(beam=14.0, max_active=2048, acoustic_scale=1.0),
        waves, _mfcc_opts(MfccOptions), device="cpu")
    jam_ = jam.AmNnet.load(os.path.join(WORKDIR, "final_ivec.am"))
    je = jiv.IvectorExtractor.load(path_ie)
    jgraph = jminilib.load_csr(os.path.join(WORKDIR, "hclg.npz"), jtm.tid_to_pdf_array())
    want = online2_words(
        jstream.OnlineFeaturePipeline, lambda: jiv.OnlineIvectorExtractor(je),
        jstream.StreamingTokenDecoder, jgraph, jam_.loglikes_batch,
        jam_.config.left_context, jam_.config.right_context, sil, t2p,
        jvit.ViterbiOptions(beam=14.0, max_active=2048, acoustic_scale=1.0),
        waves, _mfcc_opts(jcompute.MfccOptions))
    print("online2 words", {k: [system.words[w] for w in v] for k, v in got.items()})
    assert got == want


@pytest.mark.parametrize("entry", ["extractor", "pipeline", "decoder", "chain_ivec"])
def test_entry_points_default_to_the_gpu_and_raise_without_one(entry):
    if torch.cuda.is_available():
        return
    import old_kaldi_git_tpu_torch.recipes.minilib as tminilib

    graph = _toy_graphs()["split"][0]
    calls = {
        "extractor": lambda: tiv.IvectorExtractor.load(os.path.join(WORKDIR, "final.ie")),
        "pipeline": lambda: tstream.OnlineFeaturePipeline(),
        "decoder": lambda: tstream.StreamingTokenDecoder(
            port_graph(graph), lambda x: x, [], np.zeros(99, np.int32)),
        "chain_ivec": lambda: tminilib.load_chain_system(WORKDIR, use_ivectors=True),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
