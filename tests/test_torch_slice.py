"""The first slice of the port as a whole, against the JAX package on the CPU:
waves → features → loglikes → words.  A tiny system (a small random graph, a
narrow random TDNN-F, 3 synthesised utterances) in tier-1; 4 utterances of the
committed exp/minilib system at max_active=256 marked slow.  Words must be
equal; path costs within 1e-2 (sums over hundreds of frames of loglikes that
agree to ~1e-4)."""

import tests.torch_threads  # noqa: F401
import dataclasses
import functools
import os
import pickle

import numpy as np
import pytest

import old_kaldi_git_tpu.decoder.csr as jcsr
import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu.models.am_nnet as jam
import old_kaldi_git_tpu.models.tdnn as jtdnn
import old_kaldi_git_tpu.recipes.minilib as jminilib
import old_kaldi_git_tpu.utils.batching as jbatching
import old_kaldi_git_tpu_torch.decoder.csr as tcsr
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
import old_kaldi_git_tpu_torch.recipes.minilib as tminilib
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.utils.edit_distance import compute_wer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")
P = 40


def _graph_fields(seed, S=300, deg=4):
    rng = np.random.default_rng(seed)
    A = S * deg
    return dict(
        start=0, row_ptr=(np.arange(S + 1) * deg).astype(np.int32),
        tid=rng.integers(1, 100, A).astype(np.int32),
        pdf=rng.integers(0, P, A).astype(np.int32),
        weight=rng.exponential(1.0, A).astype(np.float32),
        nextstate=rng.integers(0, S, A).astype(np.int32),
        final_weight=np.where(rng.random(S) < 0.5, rng.exponential(1.0, S),
                              np.inf).astype(np.float32),
        arc_olabels=[((int(rng.integers(1, 50)),) if rng.random() < 0.5 else ())
                     for _ in range(A)],
        final_olabels=[() for _ in range(S)])


def _random_jax_am(seed):
    config = jtdnn.make_tdnnf(39, P, hidden_dim=48, bottleneck_dim=12, num_layers=3)
    am = jam.AmNnet.init(config, seed=seed)
    rng = np.random.default_rng(seed)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict)
                else (0.5 + rng.random(v.shape)).astype(np.float32) if k == "var"
                else (rng.normal(size=v.shape) * 0.03).astype(np.float32)
                for k, v in tree.items()}

    am.variables = fill(am.variables)
    am.log_priors = np.log(rng.dirichlet(np.ones(P) * 5)).astype(np.float32)
    return am


def _decode_loop(am, graph, feats, vopts, batch, decode_batch_tokens):
    """The recipe's decode loop (recipes/minilib.py decode_and_score) down to
    DecodeResults, so that path costs can be compared; one body for both
    packages' acoustic model and decoder."""
    by_dur = sorted(feats, key=lambda k: feats[k].shape[0])
    out = {}
    for lo in range(0, len(by_dur), batch):
        chunk = by_dur[lo: lo + batch]
        keys, padded, nf = jbatching.pad_feature_batch({k: feats[k] for k in chunk})
        T = padded.shape[1]
        padded = np.pad(padded, ((0, batch - len(keys)), (0, -(-T // 128) * 128 - T), (0, 0)))
        nf = np.concatenate([nf, np.zeros(batch - len(keys), nf.dtype)])
        results = decode_batch_tokens(graph, am.loglikes_batch(padded), nf, vopts)
        for k, res in zip(keys, results):
            out[k] = res
    return out


def test_tiny_system_end_to_end():
    jopts = jminilib.MinilibOptions(num_words=300, num_test=3)
    topts = tminilib.MinilibOptions(num_words=300, num_test=3)
    # short sentences (2-3 words, about 1.5 s of audio) keep this in seconds
    jwaves, jtext = jminilib.synth_set(
        jopts, jminilib.make_text(jopts, 3, 77, min_len=2, max_len=4), "tiny", 78)
    twaves, ttext = tminilib.synth_set(
        topts, tminilib.make_text(topts, 3, 77, min_len=2, max_len=4), "tiny", 78)
    assert jtext == ttext
    assert all(np.array_equal(jwaves[k], twaves[k]) for k in jwaves)
    fields = _graph_fields(1)
    jax_am = _random_jax_am(2)
    o = dict(beam=10.0, max_active=64, acoustic_scale=1.0)

    jres = _decode_loop(jax_am, jcsr.CsrGraph(**fields),
                        jminilib.compute_feats(jwaves), jvit.ViterbiOptions(**o),
                        2, jvit.decode_batch_tokens)

    am = convert.am_nnet_from_jax(dataclasses.asdict(jax_am.config),
                                  jax_am.variables, jax_am.log_priors, device="cpu")
    words = [f"word{i}" for i in range(50)]
    system = tminilib.MinilibSystem(words, tcsr.CsrGraph(**fields), am,
                                    twaves, ttext)
    hyps = tminilib.decode_test_set(system, twaves, batch=2, **o)
    assert sorted(hyps) == sorted(jres)
    for k, res in jres.items():
        assert res is not None and len(res.words) > 0
        assert hyps[k] == [words[w] for w in res.words]

    # the same through the port's pieces, to see the path costs
    tres = _decode_loop(am, system.csr, tminilib.compute_feats(twaves, device="cpu"),
                        tvit.ViterbiOptions(**o), 2,
                        functools.partial(tvit.decode_batch_tokens, device="cpu"))
    for k, res in jres.items():
        got = tres[k]
        assert got.words == res.words
        assert np.array_equal(got.alignment, res.alignment)
        assert got.cost == pytest.approx(res.cost, abs=1e-2)

    # and the scoring entry point: random models decode garbage, the same garbage
    wer, audio_s = tminilib.decode_and_score(system, batch=2, **o)
    want = compute_wer({k: list(v) for k, v in jtext.items()},
                       {k: [words[w] for w in r.words] for k, r in jres.items()})
    assert wer == pytest.approx(want.wer)
    assert audio_s == pytest.approx(sum(len(w) for w in jwaves.values()) / 8000.0)


def test_tid_to_pdf_from_the_stub_tree_equals_the_transition_models():
    with open(os.path.join(WORKDIR, "tree.pkl"), "rb") as f:
        _ctx, tm = pickle.load(f)
    _ctx_stub, tm_stub = convert.load_pickle(os.path.join(WORKDIR, "tree.pkl"))
    assert not hasattr(tm_stub, "tid_to_pdf_array")  # a stub: state, no code
    got = convert.tid_to_pdf_from_transition_model(tm_stub)
    want = tm.tid_to_pdf_array()
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert got[0] == -1 and got.max() == 1999


def test_load_system_only_loads(tmp_path):
    with pytest.raises(tminilib.KaldiError, match="tree.pkl"):
        tminilib.load_system(str(tmp_path), device="cpu")


def test_load_csr_rebuilds_the_pdf_column():
    tid_to_pdf = convert.tid_to_pdf_from_transition_model(
        convert.load_pickle(os.path.join(WORKDIR, "tree.pkl"))[1])
    path = os.path.join(WORKDIR, "hclg.npz")
    with pytest.raises(tminilib.KaldiError, match="tid_to_pdf"):
        tminilib.load_csr(path)
    csr = tminilib.load_csr(path, tid_to_pdf)
    assert (csr.num_states, csr.num_arcs) == (1058721, 3068177)
    assert csr.pdf.dtype == np.int32 and csr.pdf.min() >= 0 and csr.pdf.max() == 1999
    assert np.array_equal(csr.pdf[:1000], tid_to_pdf[csr.tid[:1000]])
    assert csr.eps_ns is None  # folded graph


@pytest.mark.slow
@pytest.mark.parametrize("num_utts,max_active,batch,noise", [
    (4, 256, 4, None),
    (4, 256, 4, 400.0),
    (256, 1024, 8, None),    # the whole held-out set at the flagship width,
    (256, 1024, 8, 400.0),   # about 10 minutes each on 8 CPU cores
])
def test_committed_system_words_equal(num_utts, max_active, batch, noise):
    """Held-out utterances of exp/minilib, clean and at the noisy operating
    point, through both packages on the CPU: the same words for every
    utterance, hence the same errors."""
    opts = tminilib.MinilibOptions(num_test=num_utts)
    jopts = jminilib.MinilibOptions(num_test=num_utts)
    system = tminilib.load_system(WORKDIR, opts, device="cpu")
    jsys = jminilib.load_system(WORKDIR, jopts, build_missing=False)
    if noise is not None:
        system.test_waves, system.test_text = tminilib.make_test_set(opts, noise)
        jsys.test_waves, jsys.test_text = jminilib.make_test_set(jopts, noise)
        assert all(np.array_equal(jsys.test_waves[k], system.test_waves[k])
                   for k in jsys.test_waves)
    o = dict(beam=14.0, max_active=max_active, acoustic_scale=1.0)
    hyps = tminilib.decode_test_set(system, system.test_waves, batch=batch, **o)
    jres = _decode_loop(jsys.am, jsys.csr, jminilib.compute_feats(jsys.test_waves),
                        jvit.ViterbiOptions(**o), batch, jvit.decode_batch_tokens)
    jhyps = {k: [jsys.lang.words[w] for w in res.words] for k, res in jres.items()}
    assert sorted(hyps) == sorted(jhyps)
    differing = [k for k in jhyps if hyps[k] != jhyps[k]]
    assert differing == []
    text = {k: list(v) for k, v in system.test_text.items()}
    stats = compute_wer(text, hyps)
    print(f"noise={noise} utts={num_utts} K={max_active}: both packages "
          f"{stats.report()}; utterances with errors: "
          f"{sorted(k for k in text if text[k] != hyps[k])}")
    assert stats.wer <= (1.0 if noise is None else 25.0)


def test_stage_timings_are_filled_only_on_request():
    topts = tminilib.MinilibOptions(num_words=300, num_test=2)
    waves, text = tminilib.synth_set(
        topts, tminilib.make_text(topts, 2, 5, min_len=2, max_len=3), "t", 6)
    jax_am = _random_jax_am(3)
    am = convert.am_nnet_from_jax(dataclasses.asdict(jax_am.config),
                                  jax_am.variables, jax_am.log_priors, device="cpu")
    system = tminilib.MinilibSystem([f"word{i}" for i in range(50)],
                                    tcsr.CsrGraph(**_graph_fields(1)), am, waves, text)
    o = dict(beam=10.0, max_active=64, acoustic_scale=1.0, batch=1)
    timings = {}
    hyps = tminilib.decode_test_set(system, waves, timings=timings, **o)
    assert hyps == tminilib.decode_test_set(system, waves, **o)
    assert sorted(timings) == ["acoustic_model_seconds", "front_end_seconds",
                               "search_frames", "search_seconds"]
    assert all(v > 0 for v in timings.values())
    feats = tminilib.compute_feats(waves, device="cpu")
    assert timings["search_frames"] == sum(f.shape[0] for f in feats.values())
