"""Online iVectors in the port vs the JAX package, on the CPU.

final.ie through the port's reader (a diagonal UBM of 64 Gaussians at dim
39, T [64, 39, 32]); the UBM's float64 scores and posteriors within 1e-12
relative; the extractor's float64 statistics, precision and posterior means
within 1e-9 relative, the online update points too; online iVectors (float32
after one cast) within 1e-6 relative, on final.ie with held-out utterances
and on a small extractor trained by the JAX package; OnlineIvectorExtractor
equal to extract_online_ivectors for any chunking, exactly;
append_ivector_feats (with its clamp-pad) exactly; the CE+iVec and
chain+iVec recipes' words on the 2 shortest held-out utterances.  Slow: all
256 held-out utterances, clean and noisy, for both iVector systems, word
for word."""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from old_kaldi_git_tpu_torch.gmm.diag_gmm import DiagGmm
from old_kaldi_git_tpu_torch.utils.edit_distance import compute_wer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")
FINAL_IE = os.path.join(WORKDIR, "final.ie")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def final_ie():
    return jiv.IvectorExtractor.load(FINAL_IE), tiv.IvectorExtractor.load(FINAL_IE,
                                                                         device="cpu")


@pytest.fixture(scope="module")
def small():
    """A 4-Gaussian, 3-dim extractor at feature dim 5, trained by the JAX
    package (as tests/test_ivector_online.py trains it) and carried over."""
    rng = np.random.default_rng(0)
    utts = [(rng.normal(size=(60, 5)) + 2.0 * (i % 2)).astype(np.float32)
            for i in range(6)]
    ubm = jiv.train_ubm(np.concatenate(utts), num_gauss=4, num_iters=3)
    je = jiv.train_ivector_extractor(ubm, utts, ivector_dim=3, num_iters=3)
    return je, tiv.IvectorExtractor(DiagGmm(ubm.weights, ubm.means, ubm.vars), je.T,
                                    device="cpu")


@pytest.fixture(scope="module")
def held_out_feats():
    waves, _ = tminilib.make_test_set(tminilib.MinilibOptions())
    keys = sorted(waves)[:3]
    return tminilib.compute_feats({k: waves[k] for k in keys}, device="cpu")


@pytest.mark.parametrize("name,ivector_dim,input_dim", [
    ("final.am", 0, 39), ("final_ivec.am", 32, 71)])
def test_load_am_nnet_keeps_the_ivector_dim(name, ivector_dim, input_dim):
    am = convert.load_am_nnet(os.path.join(WORKDIR, name), device="cpu")
    assert am.ivector_dim == ivector_dim == jam.AmNnet.load(
        os.path.join(WORKDIR, name)).ivector_dim
    assert am.config.input_dim == input_dim


def test_final_ie_loads(final_ie):
    je, te = final_ie
    assert tuple(te.T.shape) == je.T.shape == (64, 39, 32) and te.ivector_dim == 32
    assert te.T.dtype == torch.float64 and np.array_equal(te.T.numpy(), je.T)
    for f in ("weights", "means", "vars"):
        assert np.array_equal(getattr(te.ubm, f), getattr(je.ubm, f))


def test_full_covariance_extractor_is_refused(tmp_path):
    raw = bytearray(open(FINAL_IE, "rb").read())
    at = raw.index(b"<IvectorExtractor> ") + len(b"<IvectorExtractor> ")
    assert raw[at] == 4 and raw[at + 1: at + 5] == b"\0\0\0\0"  # int32 kind 0
    raw[at + 1] = 1
    path = tmp_path / "full.ie"
    path.write_bytes(bytes(raw))
    with pytest.raises(tiv.KaldiError, match="full-covariance"):
        tiv.IvectorExtractor.load(str(path), device="cpu")


@pytest.mark.parametrize("method", ["component_loglikes", "loglikes", "posteriors"])
def test_diag_gmm_scores_equal(final_ie, method):
    je, te = final_ie
    x = np.random.default_rng(1).normal(size=(50, 39)) * 3
    want = getattr(je.ubm, method)(x)
    got = getattr(te.ubm, method)(torch.from_numpy(x))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    assert rel(got.numpy(), want) <= 1e-12
    if method == "posteriors":
        assert np.allclose(got.sum(1).numpy(), 1.0, rtol=0, atol=1e-12)


def test_float64_pieces_equal(final_ie, held_out_feats):
    je, te = final_ie
    x = held_out_feats[sorted(held_out_feats)[0]]
    jg, jf = jiv._utt_stats(je.ubm, x)
    tg, tf = tiv._utt_stats(te.ubm, te.frames(x))
    assert rel(tg.numpy(), jg) <= 1e-9 and rel(tf.numpy(), jf) <= 1e-9
    for got, want in zip(tiv._precomputed(te), jiv._precomputed(je)):
        assert rel(got.numpy(), want) <= 1e-9
    jm, jL = jiv._posterior(je, jg, jf)
    tm, tL = tiv._posterior(te, tg, tf)
    assert rel(tL.numpy(), jL) <= 1e-9 and rel(tm.numpy(), jm) <= 1e-9
    assert rel(tiv.extract_ivector(te, x).numpy(), jiv.extract_ivector(je, x)) <= 1e-6


SCALE_COUNT = [(1.0, 0.0), (0.5, 0.0), (1.0, 20.0)]


def _jax_updates64(je, x, period, stats_scale, max_count):
    """The JAX package's float64 posterior means at every update point, from
    its own statistics over each prefix, scaled as its OnlineIvectorExtractor
    scales them."""
    out = []
    for end in range(period, len(x) + period, period):
        g, f = jiv._utt_stats(je.ubm, x[:end])
        g, f = g * stats_scale, f * stats_scale
        if max_count > 0 and g.sum() > max_count:
            s = max_count / g.sum()
            g, f = g * s, f * s
        out.append(jiv._posterior(je, g, f)[0])
    return np.stack(out)


@pytest.mark.parametrize("scale_count", SCALE_COUNT)
@pytest.mark.parametrize("which", ["small", "final_ie"])
def test_online_ivectors_equal(request, held_out_feats, which, scale_count):
    je, te = request.getfixturevalue(which)
    stats_scale, max_count = scale_count
    if which == "small":
        xs = [np.random.default_rng(2).normal(size=(63, 5)).astype(np.float32)]
    else:
        xs = [held_out_feats[k] for k in sorted(held_out_feats)]
    for x in xs:
        got64 = tiv.online_ivector_updates(te, x, 10, stats_scale, max_count)
        assert got64.dtype == torch.float64
        assert rel(got64.numpy(), _jax_updates64(je, x, 10, stats_scale, max_count)) <= 1e-9
        want = jiv.extract_online_ivectors(je, x, 10, stats_scale, max_count)
        got = tiv.extract_online_ivectors(te, x, 10, stats_scale, max_count)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert rel(got.numpy(), want) <= 1e-6
        assert np.array_equal(got.numpy(), np.repeat(
            got64.numpy().astype(np.float32), 10, axis=0)[:len(x)])
    assert tuple(tiv.extract_online_ivectors(te, xs[0][:0]).shape) == (0, te.ivector_dim)


@pytest.mark.parametrize("chunks", [[63], [1] * 63, [10, 10, 10, 10, 10, 13],
                                    [7, 16, 3, 25, 12]])
@pytest.mark.parametrize("scale_count", SCALE_COUNT)
def test_online_extractor_chunking_invariance(small, chunks, scale_count):
    """For any chunking the streaming extractor's outputs concatenate to
    extract_online_ivectors over the whole utterance, exactly."""
    _je, te = small
    stats_scale, max_count = scale_count
    x = np.random.default_rng(1).normal(size=(63, 5)).astype(np.float32)
    batch = tiv.extract_online_ivectors(te, x, 10, stats_scale, max_count).numpy()
    st = tiv.OnlineIvectorExtractor(te, period=10, stats_scale=stats_scale,
                                    max_count=max_count)
    outs, lo = [], 0
    for n in chunks:
        outs.append(st.accept(x[lo: lo + n]))
        lo += n
    outs.append(st.input_finished())
    np.testing.assert_array_equal(np.concatenate(outs), batch)
    assert st.input_finished().shape == (0, 3)


def test_online_extractor_float64_input(small):
    _je, te = small
    x = np.random.default_rng(2).normal(size=(40, 5))
    st = tiv.OnlineIvectorExtractor(te, period=10)
    got = np.concatenate([st.accept(x[:17]), st.accept(x[17:]), st.input_finished()])
    np.testing.assert_array_equal(got, tiv.extract_online_ivectors(te, x, 10).numpy())


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


# ---------------------------------------------------------------------------
# the iVector recipes
# ---------------------------------------------------------------------------

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
