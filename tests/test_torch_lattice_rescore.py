"""LM rescoring in the port vs the JAX package on the CPU (split from
tests/test_torch_lattice.py, whose helpers these tests use): rescored
lattices' best path and cost within 1e-4 on toy graphs; the rescoring
recipe on the committed system, 2 utterances with a small LM text in
tier 1, the benchmark's 64 noisy utterances with the full 4-gram (and the
live records on the same loglikes) marked slow."""

import tests.torch_threads  # noqa: F401
import numpy as np
import pytest

import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu.lat.determinize as jdet
import old_kaldi_git_tpu.lat.rescore as jresc
import old_kaldi_git_tpu.lm.ngram as jngram
import old_kaldi_git_tpu.recipes.minilib as jminilib
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
import old_kaldi_git_tpu_torch.lat.determinize as tdet
import old_kaldi_git_tpu_torch.lat.rescore as tresc
import old_kaldi_git_tpu_torch.lm.ngram as tngram
import old_kaldi_git_tpu_torch.recipes.minilib as tminilib
from tests.test_torch_lattice import WORKDIR, _lattices


@pytest.mark.parametrize("graph", ["folded", "split"])
def test_lmrescore_best_path_equal(graph):
    words = ["<eps>"] + [f"w{i:05d}" for i in range(1, 40)]
    sents = [[words[1 + (i * 7 + j * 3) % 39] for j in range(3 + i % 5)]
             for i in range(300)]
    old = (jngram.estimate_ngram_lm(sents[:150], order=2),
           tngram.estimate_ngram_lm(sents[:150], order=2))
    new = (jngram.estimate_ngram_lm(sents, order=4, cutoffs=(0, 0, 1, 1)),
           tngram.estimate_ngram_lm(sents, order=4, cutoffs=(0, 0, 1, 1)))
    for _jr, _tr, jl, tl in _lattices(graph, max_active=16):
        # both packages' default route: the native library of cpp/lattice.cc
        jc = jdet.determinize_lattice_pruned(jl, 8.0)
        tc = tdet.determinize_lattice_pruned(tl, 8.0)
        for use_old in (True, False):
            want = jresc.lmrescore_compact_lattice(jc, words, new[0],
                                                   old[0] if use_old else None)
            got = tresc.lmrescore_compact_lattice(tc, words, new[1],
                                                  old[1] if use_old else None)
            assert got.num_states == want.num_states and got.num_arcs == want.num_arcs
            gw, gt, gc = got.best_path(1.0, 1.0)
            ww, wt, wc = want.best_path(1.0, 1.0)
            assert (gw, gt) == (ww, wt)
            assert gc == pytest.approx(wc, abs=1e-4)


@pytest.fixture(scope="module")
def flagship():
    return (jminilib.load_system(WORKDIR, build_missing=False),
            tminilib.load_system(WORKDIR, device="cpu"))


def _rescore_both(flagship, **kw):
    jsys, tsys = flagship
    jopts = jminilib.MinilibOptions(lm_sentences=kw.pop("lm_sentences", 250_000))
    topts = tminilib.MinilibOptions(lm_sentences=jopts.lm_sentences)
    want = jminilib.rescore_and_score(jsys, jopts, **kw)
    jstats = dict(jminilib.rescore_and_score.last_stats)
    timings = {}
    got = tminilib.rescore_and_score(tsys, topts, timings=timings, **kw)
    tstats = dict(tminilib.rescore_and_score.last_stats)
    # the port also counts each utterance's live lattice records (the JAX
    # package counts none); they add up to the decoder's total
    live = tstats.pop("live_records")
    assert sum(live.values()) == timings["lattice_records_live"]
    return want, jstats, got, tstats, timings, live


def test_rescore_recipe_equals_on_two_utterances(flagship):
    want, jstats, got, tstats, timings, live = _rescore_both(
        flagship, lm_sentences=3000, noise=400.0, full_lm_order=4,
        compute_oracle=True, num_utts=2, batch=2)
    assert len(live) == 2 and min(live.values()) > 0
    assert got == pytest.approx(want) and tstats == pytest.approx(jstats)
    assert {"lm_estimate_seconds", "search_seconds", "record_transfer_seconds",
            "lattice_build_seconds", "determinize_seconds", "rescore_seconds",
            "oracle_seconds", "lattice_records_live",
            "lattice_record_slots"} <= set(timings)
    assert 0 < timings["lattice_records_live"] < timings["lattice_record_slots"]


@pytest.mark.slow
def test_rescore_recipe_equals_at_the_benchmark_setting(flagship):
    """bench.py's call: 64 noisy utterances, the full 4-gram, the oracle."""
    want, jstats, got, tstats, timings, live = _rescore_both(
        flagship, noise=400.0, full_lm_order=4, compute_oracle=True, num_utts=64)
    assert got == pytest.approx(want) and tstats == pytest.approx(jstats)
    print(f"rescore, both packages: {tstats}; port stages {timings}")
    # chip_smoke.py holds the card's per-utterance counts against these
    print("live records by utterance:", [live[k] for k in sorted(live)])


@pytest.mark.slow
def test_rescore_records_equal_on_the_same_loglikes(flagship):
    """The benchmark's 64 noisy utterances with the JAX package's loglikes
    fed to both decoders: every utterance's words and live lattice records
    equal.  (Each package on its own loglikes may count a few records more
    or fewer on an utterance: the lattice-beam gate is a float comparison,
    and the two front ends and TDNNs round differently.)"""
    from old_kaldi_git_tpu.utils.batching import pad_feature_batch

    jsys, tsys = flagship
    waves, _ = jminilib.make_test_set(jminilib.MinilibOptions(), noise=400.0)
    keys = sorted(waves)[:64]
    feats = jminilib.compute_feats({k: waves[k] for k in keys})
    by_dur = sorted(feats, key=lambda k: feats[k].shape[0])
    o = dict(beam=14.0, max_active=1024, acoustic_scale=1.0)
    live = {}
    for lo in range(0, len(by_dur), 16):
        ks, padded, nf = pad_feature_batch({k: feats[k] for k in by_dur[lo: lo + 16]})
        T = padded.shape[1]
        padded = np.pad(padded, ((0, 0), (0, -(-T // 128) * 128 - T), (0, 0)))
        ll = np.asarray(jsys.am.loglikes_batch(padded))
        jres = jvit.decode_batch_tokens(jsys.csr, ll, nf, jvit.ViterbiOptions(**o),
                                        want_lattice=True, lattice_beam=8.0)
        tres = tvit.decode_batch_tokens(tsys.csr, ll, nf, tvit.ViterbiOptions(**o),
                                        want_lattice=True, lattice_beam=8.0, device="cpu")
        for k, jr, tr in zip(ks, jres, tres):
            assert tr.words == jr.words, k
            live[k] = int((tr.token_lattice.arc >= 0).sum())
            assert live[k] == int((np.asarray(jr.token_lattice.arc) >= 0).sum()), k
    print("live records on the JAX package's loglikes:", [live[k] for k in keys])
