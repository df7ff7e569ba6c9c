"""MBR decoding (lat/mbr.py) and CTM output (lat/ctm.py) in the port
against the JAX package on the CPU.

Lattices: the yes/no toy's (tests/torch_lattice_toy.py), determinized by
the port and copied into the JAX package's CompactLattice, and random
lattices (tests/test_determinize.py).  Words, sausage bins and CTM
entries exact; posteriors, confidences, expected times and expected WER
within 1e-9.  MBR ≤ MAP in expected WER by brute force, and well-formed
sausages, on small lattices.  The shared final-word fault (ROADMAP queue
3) pinned on bench.py's toy graph: both packages give the same sausage,
MBR and CTM, each without the word the end state carries."""

import tests.torch_threads  # noqa: F401
import numpy as np
import pytest

import old_kaldi_git_tpu.lat.ctm as jctm
import old_kaldi_git_tpu.lat.lattice as jlat
import old_kaldi_git_tpu.lat.mbr as jmbr
import old_kaldi_git_tpu_torch.lat.ctm as tctm
import old_kaldi_git_tpu_torch.lat.determinize as tdet
import old_kaldi_git_tpu_torch.lat.lattice as tlat
import old_kaldi_git_tpu_torch.lat.mbr as tmbr
from tests.test_determinize import random_lattice
from tests.test_mbr import brute_expected_wer
from tests.test_torch_determinize_native import port_lattice
from tests.torch_lattice_toy import clat_to_jax, final_word_lattices, yesno_lattices

TOL = 1e-9


@pytest.fixture(scope="module")
def toy():
    return yesno_lattices()


def assert_mbr_equal(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    assert got.words == want.words
    assert [[w for w, _ in b] for b in got.sausage] == [[w for w, _ in b] for b in want.sausage]
    np.testing.assert_allclose([p for b in got.sausage for _, p in b],
                               [p for b in want.sausage for _, p in b], rtol=0, atol=TOL)
    np.testing.assert_allclose(got.confidences, want.confidences, rtol=0, atol=TOL)
    np.testing.assert_allclose(np.reshape(got.times, -1), np.reshape(want.times, -1),
                               rtol=0, atol=TOL)
    assert got.expected_wer == pytest.approx(want.expected_wer, abs=TOL)


def assert_wellformed(res):
    assert len(res.confidences) == len(res.words) == len(res.sausage) == len(res.times)
    assert all(0.0 <= c <= 1.0 for c in res.confidences)
    for b in res.sausage:
        assert sum(p for _, p in b) == pytest.approx(1.0, abs=1e-4)
    assert all(e >= b for b, e in res.times)


@pytest.mark.parametrize("scales", [(1.0, 0.1), (1.0, 0.3)])
def test_mbr_equals_the_jax_package_on_decode_lattices(toy, scales):
    for tl in toy.port:
        tc = tdet.determinize_lattice_pruned(tl, 10.0, acoustic_scale=scales[1])
        got = tmbr.minimum_bayes_risk(tc, *scales, frame_shift=0.01)
        assert_mbr_equal(got, jmbr.minimum_bayes_risk(clat_to_jax(tc), *scales,
                                                      frame_shift=0.01))
        assert_wellformed(got)
        assert got.expected_wer >= 0.0


def test_mbr_equals_the_jax_package_on_random_lattices():
    rng = np.random.default_rng(0)
    checked = 0
    for _ in range(30):
        jl = random_lattice(rng, num_states=9, num_arcs=22, num_words=3)
        tc = tdet.determinize_lattice_pruned(port_lattice(jl), np.inf)
        got = tmbr.minimum_bayes_risk(tc, 1.0, 1.0)
        assert_mbr_equal(got, jmbr.minimum_bayes_risk(clat_to_jax(tc), 1.0, 1.0))
        checked += got is not None
    assert checked >= 20


def test_mbr_no_worse_than_map_by_brute_force():
    rng = np.random.default_rng(1)
    total = improved = 0
    for _ in range(40):
        jl = random_lattice(rng, num_states=9, num_arcs=22, num_words=3)
        tc = tdet.determinize_lattice_pruned(port_lattice(jl), np.inf)
        res = tmbr.minimum_bayes_risk(tc, 1.0, 1.0)
        if res is None:
            continue
        assert_wellformed(res)
        e_map = brute_expected_wer(tc, tc.best_path(1.0, 1.0)[0], 1.0, 1.0)
        e_mbr = brute_expected_wer(tc, res.words, 1.0, 1.0)
        assert e_mbr <= e_map + 1e-6
        improved += e_mbr < e_map - 1e-9
        total += 1
    assert total >= 25 and improved >= 1


def test_mbr_on_a_linear_lattice_with_durations():
    clat = tdet.CompactLattice()
    s = clat.add_state()
    clat.start = s
    for i, d in enumerate([3, 5, 2]):
        ns = clat.add_state()
        clat.arcs[s].append(tdet.CompactLatticeArc(i + 1, 0.2, 0.2, tuple(range(1, d + 1)), ns))
        s = ns
    clat.finals[s] = (0.0, 0.0, ())
    res = tmbr.minimum_bayes_risk(clat, 1.0, 1.0)
    assert res.words == [1, 2, 3] and res.expected_wer == pytest.approx(0.0, abs=1e-12)
    assert res.confidences == pytest.approx([1.0] * 3)
    assert res.times == pytest.approx([(0.0, 3.0), (3.0, 8.0), (8.0, 10.0)])
    assert tmbr.minimum_bayes_risk(tdet.CompactLattice()) is None


@pytest.mark.parametrize("scales", [(1.0, 0.1), (1.0, 1.0)])
def test_lattice_to_ctm_conf_equals_the_jax_package(toy, scales):
    for i, (tl, jl) in enumerate(zip(toy.port, toy.jax)):
        got = tctm.lattice_to_ctm_conf(tl, toy.ttm, toy.tlang, f"utt{i}", *scales)
        want = jctm.lattice_to_ctm_conf(jl, toy.jtm, toy.jlang, f"utt{i}", *scales)
        assert [e.line() for e in got] == [e.line() for e in want]
        assert [(e.utt, e.channel, e.word) for e in got] == [
            (e.utt, e.channel, e.word) for e in want]
        np.testing.assert_allclose([(e.start, e.duration, e.confidence) for e in got],
                                   [(e.start, e.duration, e.confidence) for e in want],
                                   rtol=0, atol=TOL)
        words = tlat.lattice_best_path(tl, *scales)[0]
        assert [e.word for e in got] == [toy.tlang.words[w] for w in words]
        assert all(0.0 <= e.confidence <= 1.0 for e in got)
        assert [e.start for e in got] == sorted(e.start for e in got)


def test_word_alignment_by_lexicon_and_by_word_boundaries(toy, tmp_path):
    boundary = {toy.tlang.phones[p]: k for p, k in (
        ("Y", "begin"), ("EH", "internal"), ("S", "end"), ("N", "begin"), ("OW", "end"),
        ("SIL", "nonword"))}
    path = tmp_path / "word_boundary.int"
    path.write_text("".join(f"{p} {k}\n" for p, k in boundary.items()))
    assert tctm.read_word_boundary(str(path)) == jctm.read_word_boundary(str(path)) == boundary
    for tl, jl in zip(toy.port, toy.jax):
        words, tids, _ = tlat.lattice_best_path(tl, 1.0, 1.0)
        by_lex = tctm.align_words_lexicon(toy.ttm, toy.tlang, words, tids)
        assert by_lex == jctm.align_words_lexicon(toy.jtm, toy.jlang, words, tids)
        assert tctm.align_words_boundary(toy.ttm, boundary, words, tids) == \
            jctm.align_words_boundary(toy.jtm, boundary, words, tids) == by_lex
        got = tctm.ctm_from_alignment(toy.ttm, toy.tlang, words, tids, "u", 2, 0.03,
                                      confidences=[0.5] * len(words))
        want = jctm.ctm_from_alignment(toy.jtm, toy.jlang, words, tids, "u", 2, 0.03,
                                       confidences=[0.5] * len(words))
        assert [e.line() for e in got] == [e.line() for e in want]
    with pytest.raises(tctm.KaldiError):
        tctm.align_words_lexicon(toy.ttm, toy.tlang, [toy.tlang.words["no"]],
                                 tlat.lattice_best_path(toy.port[0], 1.0, 1.0)[1])


def test_the_final_word_fault_is_the_jax_packages():
    """ROADMAP queue 3: a lattice whose end state carries a word (the
    graph's final_olabels) loses it in both packages alike."""
    toyf = final_word_lattices()
    tailed = [i for i, t in enumerate(toyf.tails) if t]
    assert tailed
    for i in tailed:
        tl, jl = toyf.port[i], toyf.jax[i]
        best = tlat.lattice_best_path(tl, 1.0, 1.0)[0]
        assert best + toyf.tails[i] == toyf.words[i]  # the lattice lacks the tail
        tcn, jcn = tlat.confusion_network(tl, 1.0, 0.1), jlat.confusion_network(jl, 1.0, 0.1)
        assert [[w for w, _ in b] for b in tcn] == [[w for w, _ in b] for b in jcn]
        np.testing.assert_allclose([p for b in tcn for _, p in b],
                                   [p for b in jcn for _, p in b], rtol=0, atol=TOL)
        tc = tdet.determinize_lattice_pruned(tl, 8.0, acoustic_scale=0.1)
        res = tmbr.minimum_bayes_risk(tc, 1.0, 0.1)
        assert_mbr_equal(res, jmbr.minimum_bayes_risk(clat_to_jax(tc), 1.0, 0.1))
        got = tctm.lattice_to_ctm_conf(tl, toyf.ttm, toyf.tlang, "u", 1.0, 0.1)
        want = jctm.lattice_to_ctm_conf(jl, toyf.jtm, toyf.jlang, "u", 1.0, 0.1)
        assert [e.line() for e in got] == [e.line() for e in want]
        assert len(got) == len(best) == len(toyf.words[i]) - len(toyf.tails[i])
