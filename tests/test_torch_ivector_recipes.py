"""The iVector recipes in the port vs the JAX package, on the CPU (split from
tests/test_torch_ivector.py, whose fixtures these tests use):
append_ivector_feats (with its clamp-pad) exactly, per-utterance iVectors
within 1e-6, the transition model's maps and the silence phone, and the
CE+iVec and chain+iVec recipes' words on the 2 shortest held-out
utterances.  Slow: all 256 held-out utterances, clean and noisy, for both
iVector systems, word for word."""

import tests.torch_threads  # noqa: F401
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest

import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu.ivector.extractor as jiv
import old_kaldi_git_tpu.models.am_nnet as jam
import old_kaldi_git_tpu.recipes.minilib as jminilib
import old_kaldi_git_tpu.recipes.nnet3 as jnnet3
from old_kaldi_git_tpu.recipes.chain import ChainModel as JaxChainModel
from old_kaldi_git_tpu.utils.batching import pad_feature_batch
import old_kaldi_git_tpu_torch.ivector.extractor as tiv
import old_kaldi_git_tpu_torch.recipes.minilib as tminilib
import old_kaldi_git_tpu_torch.recipes.nnet3 as tnnet3
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.utils.edit_distance import compute_wer
from tests.test_torch_ivector import WORKDIR, FINAL_IE, rel, final_ie, held_out_feats


@pytest.mark.parametrize("iv_frames", [12, 9, 15, 0])  # 0: one [R] vector
def test_append_ivector_feats_equal(iv_frames):
    rng = np.random.default_rng(iv_frames)
    feats = {"a": rng.normal(size=(12, 4)).astype(np.float32),
             "b": rng.normal(size=(5, 4)).astype(np.float32)}
    shape = (lambda t: (3,)) if iv_frames == 0 else (lambda t: (t - 12 + iv_frames, 3))
    ivecs = {k: rng.normal(size=shape(len(v))).astype(np.float32)
             for k, v in feats.items()}
    want = jnnet3.append_ivector_feats(feats, ivecs)
    got = tnnet3.append_ivector_feats(feats, ivecs)
    for k in feats:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k])
        assert got[k].shape == (len(feats[k]), 7)
    if iv_frames == 9:  # the clamp-pad repeats the last iVector row
        assert np.array_equal(got["a"][9:, 4:], np.repeat(ivecs["a"][-1:], 3, axis=0))


@pytest.mark.parametrize("which", ["compute_ivectors", "append_ivectors"])
def test_per_utterance_ivectors_equal(final_ie, held_out_feats, which):
    """minilib.compute_ivectors ({utt: [T, 32]}) and extractor.append_ivectors
    ({utt: [T, 39 + 32]}) on held-out features."""
    je, te = final_ie
    if which == "compute_ivectors":
        want = jminilib.compute_ivectors(je, held_out_feats)
        got = tminilib.compute_ivectors(te, held_out_feats)
    else:
        want = jiv.append_ivectors(held_out_feats, je)
        got = tiv.append_ivectors(held_out_feats, te)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        assert rel(got[k], want[k]) <= 1e-6


def test_transition_model_maps_and_the_silence_phone():
    with open(os.path.join(WORKDIR, "tree.pkl"), "rb") as f:
        _ctx, tm = pickle.load(f)
    _ctx_stub, tm_stub = convert.load_pickle(os.path.join(WORKDIR, "tree.pkl"))
    got = convert.tid_to_phone_from_transition_model(tm_stub)
    want = tm.tid_to_phone_array()
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    lexicon = tminilib.make_lexicon(tminilib.MinilibOptions())
    assert tminilib.silence_phone_id(lexicon) == jminilib._load_lang(WORKDIR).silence_id == 1


def _jax_ivec_hyps(which, waves, batch, words, max_active=2048):
    """The JAX package's decode_and_score (use_ivectors) or
    decode_and_score_chain (use_ivectors) loop, down to words."""
    feats = jminilib.compute_feats(waves)
    ext = jiv.IvectorExtractor.load(FINAL_IE)
    feats = jnnet3.append_ivector_feats(feats, jminilib.compute_ivectors(ext, feats, 10))
    _cd, tm = pickle.load(open(os.path.join(WORKDIR, "tree.pkl"), "rb"))
    if which == "ce":
        am = jam.AmNnet.load(os.path.join(WORKDIR, "final_ivec.am"))
        graph = jminilib.load_csr(os.path.join(WORKDIR, "hclg.npz"), tm.tid_to_pdf_array())
        fsf = 1
        scores = am.loglikes_batch
    else:
        cm = JaxChainModel.load(os.path.join(WORKDIR, "chain_ivec.mdl"))
        graph = jminilib.load_csr(os.path.join(WORKDIR, "chain_hclg.npz"),
                                  cm.tm.tid_to_pdf_array())
        fsf = cm.frame_subsampling_factor
        scores = lambda x: cm.am.logits(jnp.asarray(x), output_stride=fsf)  # noqa: E731
    vopts = jvit.ViterbiOptions(beam=14.0, max_active=max_active, acoustic_scale=1.0)
    by_dur = sorted(feats, key=lambda k: feats[k].shape[0])
    hyps = {}
    for lo in range(0, len(by_dur), batch):
        chunk = by_dur[lo: lo + batch]
        keys, padded, nf = pad_feature_batch({k: feats[k] for k in chunk})
        T = padded.shape[1]
        padded = np.pad(padded, ((0, batch - len(keys)),
                                 (0, -(-T // (128 * fsf)) * (128 * fsf) - T), (0, 0)))
        nf = np.concatenate([nf, np.zeros(batch - len(keys), nf.dtype)])
        results = jvit.decode_batch_tokens(graph, scores(padded), (nf + fsf - 1) // fsf,
                                           vopts)
        for k, res in zip(keys, results):
            hyps[k] = [words[w] for w in res.words] if res else []
    return hyps


def _port_ivec_hyps(which, waves, batch, timings=None, max_active=2048):
    if which == "ce":
        system = tminilib.load_system(WORKDIR, device="cpu")
        return system.words, tminilib.decode_test_set(
            system, waves, max_active=max_active, batch=batch, timings=timings,
            use_ivectors=True)
    system = tminilib.load_chain_system(WORKDIR, device="cpu", use_ivectors=True)
    assert system.ivector_extractor.ivector_dim == system.model.am.ivector_dim == 32
    return system.words, tminilib.decode_chain_test_set(
        system, waves, max_active=max_active, batch=batch, timings=timings)


@pytest.mark.parametrize("which", ["ce", "chain"])
def test_ivector_recipe_words_equal_on_the_shortest_utterances(which):
    """The recipes' wiring at K=512 on the 2 shortest utterances (K=2048 on
    all 256: the slow test below)."""
    waves, text = tminilib.make_test_set(tminilib.MinilibOptions())
    short = {k: waves[k] for k in sorted(waves, key=lambda k: len(waves[k]))[:2]}
    timings = {}
    words, got = _port_ivec_hyps(which, short, 2, timings, max_active=512)
    assert got == _jax_ivec_hyps(which, short, 2, words, max_active=512)
    assert all(got[k] == text[k] for k in short)
    assert sorted(timings) == ["acoustic_model_seconds", "front_end_seconds",
                               "ivector_seconds", "search_frames", "search_seconds"]


@pytest.mark.slow
@pytest.mark.parametrize("which", ["ce", "chain"])
@pytest.mark.parametrize("noise", [None, 400.0])
def test_ivector_recipe_words_equal_on_the_held_out_set(which, noise):
    """All 256 held-out utterances at K=2048, B=64, as bench.py runs both
    iVector systems: the same words for every utterance."""
    waves, text = tminilib.make_test_set(tminilib.MinilibOptions(), noise=noise)
    words, got = _port_ivec_hyps(which, waves, 64)
    want = _jax_ivec_hyps(which, waves, 64, words)
    assert [k for k in want if got[k] != want[k]] == []
    stats = compute_wer({k: list(v) for k, v in text.items()}, got)
    print(f"{which}+iVec noise={noise}: both packages {stats.report()}; utterances "
          f"with errors: {sorted(k for k in text if list(text[k]) != got[k])}")
