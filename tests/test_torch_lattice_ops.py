"""The rest of lat/lattice.py and lat/determinize.py, and
compose_lattice_pruned, in the port against the JAX package on the CPU.

Lattices: the yes/no toy's (tests/torch_lattice_toy.py: the port's decode
at a weak separation, copied arc for arc into the JAX package's Lattice).
n-best lists, word sequences, topology and sausage bins are exact; floats
within 1e-9 (both packages run the same float64 loops in the same order).
lattice_to_word_fst runs the port's native DeterminizeStar (cpp/wfst.cc,
float32 weights) against the JAX package's Python one (float64): the two
are the same function but not always the same states (float32 residuals
merge subsets that float64 ones keep apart), so each word sequence's cost
is held, within float32's 1e-6 relative, and lattice_interp, which takes
its costs from it, by its n-best lists and best path."""

import tests.torch_threads  # noqa: F401
import numpy as np
import pytest

import old_kaldi_git_tpu.lat.determinize as jdet
import old_kaldi_git_tpu.lat.lattice as jlat
import old_kaldi_git_tpu.lat.rescore as jresc
import old_kaldi_git_tpu.lm.ngram as jngram
import old_kaldi_git_tpu_torch.lat.determinize as tdet
import old_kaldi_git_tpu_torch.lat.lattice as tlat
import old_kaldi_git_tpu_torch.lat.rescore as tresc
import old_kaldi_git_tpu_torch.lm.ngram as tngram
from tests.torch_lattice_toy import (
    clat_to_jax, clat_tuple, lat_tuple, to_jax, yesno_lattices)

TOL = 1e-9
F32_REL = 1e-6  # the native library's float32 weights
SCALES = [(1.0, 1.0), (1.0, 0.1), (0.7, 0.3)]


@pytest.fixture(scope="module")
def toy():
    return yesno_lattices()


def arcs_tuple(arcs):
    return [(a.ilabel, a.olabel, a.graph_cost, a.acoustic_cost, a.nextstate) for a in arcs]


def test_the_toy_lattices_hold_competing_words(toy):
    assert len(toy.port) == 4
    for lat in toy.port:
        assert len(tlat.lattice_nbest(lat, 5, 1.0, 0.1)) >= 3
    assert lat_tuple(toy.port[2]) == lat_tuple(toy.jax[2])


@pytest.mark.parametrize("scales", SCALES[1:])
def test_nbest_paths_linear_lattices_and_union(toy, scales):
    for tl, jl in zip(toy.port, toy.jax):
        got = tlat.lattice_nbest_paths(tl, 6, *scales)
        want = jlat.lattice_nbest_paths(jl, 6, *scales)
        assert [(arcs_tuple(a), f) for a, f in got] == [(arcs_tuple(a), f) for a, f in want]
        tlins = [tlat.linear_lattice_from_path(a, f) for a, f in got]
        jlins = [jlat.linear_lattice_from_path(a, f) for a, f in want]
        assert [lat_tuple(x) for x in tlins] == [lat_tuple(x) for x in jlins]
        tu, ju = tlat.lattice_union(tlins), jlat.lattice_union(jlins)
        assert lat_tuple(tu) == lat_tuple(ju)
        assert tlat.lattice_best_path(tu, *scales)[0] == tlat.lattice_best_path(tl, *scales)[0]


@pytest.mark.parametrize("scales", SCALES)
def test_lattice_nbest_word_posteriors_and_confusion_network(toy, scales):
    for tl, jl in zip(toy.port, toy.jax):
        got, want = tlat.lattice_nbest(tl, 8, *scales), jlat.lattice_nbest(jl, 8, *scales)
        assert [w for w, _ in got] == [w for w, _ in want]
        np.testing.assert_allclose([c for _, c in got], [c for _, c in want], rtol=0, atol=TOL)
        tw, jw = tlat.lattice_word_posteriors(tl, *scales), jlat.lattice_word_posteriors(jl, *scales)
        assert sorted(tw) == sorted(jw)
        np.testing.assert_allclose([tw[k] for k in sorted(tw)], [jw[k] for k in sorted(jw)],
                                   rtol=0, atol=TOL)
        tc, jc = tlat.confusion_network(tl, *scales), jlat.confusion_network(jl, *scales)
        assert [[w for w, _ in b] for b in tc] == [[w for w, _ in b] for b in jc]
        np.testing.assert_allclose([p for b in tc for _, p in b], [p for b in jc for _, p in b],
                                   rtol=0, atol=TOL)


def test_rescore_nbest(toy):
    sents = [["yes"], ["no"], ["yes", "no"], ["no", "no", "yes"], ["yes", "yes"]] * 4
    jlm = jngram.estimate_ngram_lm(sents, order=2)
    tlm = tngram.estimate_ngram_lm(sents, order=2)
    words = toy.jlang.words
    for tl, jl in zip(toy.port, toy.jax):
        nb = tlat.lattice_nbest(tl, 6, 1.0, 0.1)
        got = tlat.rescore_nbest(nb, lambda w: 0.5 * len(w),
                                 lambda w: -tlm.score_sequence([words[i] for i in w]), 2.0)
        want = jlat.rescore_nbest(jlat.lattice_nbest(jl, 6, 1.0, 0.1), lambda w: 0.5 * len(w),
                                  lambda w: -jlm.score_sequence([words[i] for i in w]), 2.0)
        assert [w for w, _ in got] == [w for w, _ in want]
        np.testing.assert_allclose([c for _, c in got], [c for _, c in want], rtol=0, atol=TOL)
    # a new LM that prefers the second hypothesis flips the ranking
    out = tlat.rescore_nbest([([1], 10.0), ([2], 10.5)], lambda w: 0.0,
                             lambda w: 0.0 if w == [2] else 5.0)
    assert out[0][0] == [2]


def test_lattice_depth_and_frame_posteriors(toy):
    for (tl, jl), scales in zip(zip(toy.port, toy.jax), SCALES + SCALES[:1]):
        assert tlat.lattice_depth(tl) == jlat.lattice_depth(jl) >= 1.0
        got = tlat.lattice_to_post(tl, toy.ttm, *scales)
        want = jlat.lattice_to_post(jl, toy.jtm, *scales)
        assert [[p for p, _ in f] for f in got] == [[p for p, _ in f] for f in want]
        np.testing.assert_allclose([w for f in got for _, w in f],
                                   [w for f in want for _, w in f], rtol=0, atol=TOL)
        full = tlat.lattice_to_post(tl, toy.ttm, *scales, min_post=0.0)
        np.testing.assert_allclose([sum(w for _, w in f) for f in full], 1.0, atol=1e-9)


def word_fst_paths(fst):
    """{word sequence: cost} of an acyclic FST's paths (the best, if several)."""
    out = {}

    def walk(s, words, cost):
        if fst.finals[s] != np.inf:
            key = tuple(words)
            out[key] = min(out.get(key, np.inf), cost + fst.finals[s])
        for a in fst.arcs[s]:
            walk(a.nextstate, words + [a.olabel] if a.olabel else words, cost + a.weight)

    walk(fst.start, [], 0.0)
    return out


def test_lattice_to_word_fst_through_the_native_library(toy):
    for (tl, jl), scales in zip(zip(toy.port, toy.jax), SCALES + SCALES[1:2]):
        got, want = tlat.lattice_to_word_fst(tl, *scales), jlat.lattice_to_word_fst(jl, *scales)
        gp, wp = word_fst_paths(got), word_fst_paths(want)
        assert sorted(gp) == sorted(wp) and len(gp) >= 3
        np.testing.assert_allclose([gp[k] for k in sorted(gp)], [wp[k] for k in sorted(wp)],
                                   rtol=F32_REL)
        # one path a word sequence: deterministic on words
        assert sum(1 for lst in got.arcs for a in lst if a.olabel) == got.num_arcs
        assert all(len({a.olabel for a in lst}) == len(lst) for lst in got.arcs)
        # the best sequence is the lattice's best path
        best = tlat.lattice_best_path(tl, *scales)
        assert min(gp, key=gp.get) == tuple(best[0])
        assert gp[tuple(best[0])] == pytest.approx(best[2], rel=F32_REL)


@pytest.mark.parametrize("alpha", [0.5, 0.8])
def test_lattice_interp(toy, alpha):
    for tl, jl in zip(toy.port, toy.jax):
        t2 = tlat.lattice_prune(tl, 6.0, 1.0, 0.1)
        j2 = jlat.lattice_prune(jl, 6.0, 1.0, 0.1)
        got = tlat.lattice_interp(tl, t2, alpha)
        want = jlat.lattice_interp(jl, j2, alpha)
        assert got is not None and want is not None
        for scales in SCALES[:2]:
            gn, wn = tlat.lattice_nbest(got, 10, *scales), jlat.lattice_nbest(want, 10, *scales)
            assert [w for w, _ in gn] == [w for w, _ in wn]
            np.testing.assert_allclose([c for _, c in gn], [c for _, c in wn], rtol=F32_REL)
            gb, wb = tlat.lattice_best_path(got, *scales), jlat.lattice_best_path(want, *scales)
            assert gb[:2] == wb[:2] and gb[2] == pytest.approx(wb[2], rel=F32_REL)
    # word sequences that never meet give None in both
    far = tlat.Lattice()
    s0, s1 = far.add_state(0), far.add_state(1)
    far.arcs[s0].append(tlat.LatticeArc(1, 99, 0.0, 0.0, s1))
    far.finals[s1] = (0.0, 0.0)
    assert tlat.lattice_interp(toy.port[0], far) is None
    assert jlat.lattice_interp(toy.jax[0], to_jax(far)) is None


def test_compact_lattice_conversion_push_and_minimize(toy):
    for tl in toy.port:
        tc = tdet.determinize_lattice_pruned(tl, 8.0, acoustic_scale=0.1)
        jc = clat_to_jax(tc)
        assert lat_tuple(tdet.compact_lattice_to_lattice(tc)) == lat_tuple(
            jdet.compact_lattice_to_lattice(jc))
        tp, jp = tdet.push_compact_lattice(tc), jdet.push_compact_lattice(jc)
        assert [[(a.word, a.tids, a.nextstate) for a in x] for x in tp.arcs] == [
            [(a.word, a.tids, a.nextstate) for a in x] for x in jp.arcs]
        np.testing.assert_allclose([(a.graph_cost, a.acoustic_cost) for x in tp.arcs for a in x],
                                   [(a.graph_cost, a.acoustic_cost) for x in jp.arcs for a in x],
                                   rtol=0, atol=TOL)
        tm, jm = tdet.minimize_compact_lattice(tc), jdet.minimize_compact_lattice(jc)
        assert tm.num_states == jm.num_states <= tc.num_states
        assert clat_tuple(tm) == clat_tuple(jm)
        # pushing and minimising keep every word sequence's best path
        assert tm.best_path(1.0, 0.1)[:2] == tc.best_path(1.0, 0.1)[:2]
        assert tm.best_path(1.0, 0.1)[2] == pytest.approx(tc.best_path(1.0, 0.1)[2], abs=1e-6)


@pytest.mark.parametrize("beam", [2.0, 6.0])
def test_compose_lattice_pruned(toy, beam):
    sents = [["yes"], ["no"], ["yes", "no"], ["no", "no", "yes"], ["yes", "yes"]] * 4
    old = (jngram.estimate_ngram_lm(sents[:6], order=1), tngram.estimate_ngram_lm(sents[:6], order=1))
    new = (jngram.estimate_ngram_lm(sents, order=3), tngram.estimate_ngram_lm(sents, order=3))
    words = [toy.jlang.words[i] for i in range(len(toy.jlang.words.symbols()))]
    for tl in toy.port:
        tc = tdet.determinize_lattice_pruned(tl, 8.0, acoustic_scale=0.1)
        for use_old in (True, False):
            got = tresc.compose_lattice_pruned(tc, words, new[1], old[1] if use_old else None,
                                               lattice_beam=beam)
            want = jresc.compose_lattice_pruned(clat_to_jax(tc), words, new[0],
                                                old[0] if use_old else None, lattice_beam=beam)
            assert clat_tuple(got) == clat_tuple(want)
            exact = tresc.lmrescore_compact_lattice(tc, words, new[1],
                                                    old[1] if use_old else None)
            assert got.best_path(1.0, 1.0)[0] == exact.best_path(1.0, 1.0)[0]
