"""Lattices on the host in the port vs the JAX package on the CPU (split from
tests/test_torch_lattice.py, whose helpers these tests use): the decoder's
records never land on padding frames and equal the JAX package's; the
rebuilt lattice and its best path (the decoder's 1-best), the oracle, the
pruned determinization (held against the JAX package's Python algorithm:
states, arcs and weights within 1e-5), ARPA parsing and n-gram
estimation."""

import tests.torch_threads  # noqa: F401
import gzip
import os

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.decoder.csr as jcsr
import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu.lat.determinize as jdet
import old_kaldi_git_tpu.lat.lattice as jlat
import old_kaldi_git_tpu.lat.native as jnative
import old_kaldi_git_tpu.lm.arpa as jarpa
import old_kaldi_git_tpu.lm.ngram as jngram
import old_kaldi_git_tpu_torch.decoder.csr as tcsr
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
import old_kaldi_git_tpu_torch.lat.determinize as tdet
import old_kaldi_git_tpu_torch.lat.lattice as tlat
import old_kaldi_git_tpu_torch.lm.arpa as tarpa
import old_kaldi_git_tpu_torch.lm.ngram as tngram
from tests.test_torch_chain import port_graph
from tests.test_torch_lattice import GRAPHS, WORKDIR, _lattices, _sentences, lattices_equal


@pytest.mark.parametrize("graph", ["folded", "split"])
def test_records_equal_and_never_on_padding_frames(graph):
    """The raw [T, B, L] records of one scan equal the JAX scan's on the
    frames the port runs, and no record lands on a frame past an
    utterance's end, on either side: the compaction counts only real
    frames' records, so padding cannot push an utterance into the
    overflow fallback."""
    jg = GRAPHS[graph]()
    tg = port_graph(jg) if graph == "split" else GRAPHS["folded"]()
    tg = port_graph(tg) if graph == "split" else tcsr.CsrGraph(
        **{f: getattr(tg, f) for f in ("start", "row_ptr", "tid", "pdf", "weight",
                                       "nextstate", "final_weight", "arc_olabels",
                                       "final_olabels")})
    rng = np.random.default_rng(4)
    B, T, P, K, L = 3, 20, 12, 16, 128
    ll = rng.normal(size=(B, T, P)).astype(np.float32)
    nf = np.asarray([13, 0, 6], np.int32)
    jt = jcsr.build_tile_graph(jg)
    ET = jvit._token_budget(jg, K, jt.md)
    eps_hops, D, init = None, 0, None
    if graph == "split":
        eps_hops, D = jvit._eps_hop_table(jg)
        seeds = tvit.start_closure(tg, D)
        ts0 = np.full((B, K), -1, np.int32)
        tc0 = np.full((B, K), tvit.BIG, np.float32)
        for i, (s, c) in enumerate(seeds):
            ts0[:, i], tc0[:, i] = s, c
        init = (ts0, tc0)
    tp, tiles, _ = jt.device_arrays()
    jout = jvit._decode_scan_tokens(tp, tiles, jg.start, ll, nf, 0.8, 1e9, K, ET,
                                    jg.num_states, L, 6.0,
                                    None if init is None else tuple(map(np.asarray, init)),
                                    eps_hops, D)
    jrec = [np.asarray(x) for x in jout[5:]]
    ttp, ttiles, _ = tcsr.build_tile_graph(tg).device_arrays(torch.device("cpu"))
    thops = None if graph == "folded" else tvit._eps_hop_table(tg, torch.device("cpu"))[0]
    *_, trec = tvit._decode_scan_tokens(
        ttp, ttiles, tg.start, torch.from_numpy(ll), torch.from_numpy(nf), 0.8, 1e9, K,
        ET, tg.num_states, L, 6.0,
        None if init is None else tuple(map(torch.from_numpy, init)), thops, D)
    trec = [x.numpy() for x in trec]
    t_end = int(nf.max())
    assert trec[2].shape == (t_end, B, L) and jrec[2].shape == (T, B, L)
    for b in range(B):
        assert (jrec[2][nf[b]:, b] == -1).all() and (trec[2][nf[b]:, b] == -1).all()
    assert (trec[2] >= 0).sum() > 0
    for j, t in zip(jrec, trec):
        np.testing.assert_array_equal(t, j[:t_end])
    _, jcounts = jvit._compact_lat_records(*jout[5:], R=T * 64)
    packed, tcounts = tvit._compact_lat_records(tuple(map(torch.from_numpy, trec)), T * 64)
    assert np.array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert tcounts.tolist() == [int((trec[2][:n, b] >= 0).sum()) for b, n in enumerate(nf)]
    rows = packed.numpy()
    for b in range(B):
        live = rows[b, : tcounts[b]]
        assert (live[:, 0] < nf[b]).all() and (rows[b, tcounts[b]:] == -1).all()


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_lattice_rebuild_and_best_path_equal_the_decoder(graph):
    """The port's counterpart of tests/test_lattice.py's split-eps lattice
    test: the rebuilt lattice equals the JAX package's, and its best path is
    the decoder's 1-best (words, transition ids, cost)."""
    for jr, tr, jl, tl in _lattices(graph):
        assert tl is not None
        lattices_equal(jl, tl)
        # at the decoder's acoustic scale
        words, tids, cost = tlat.lattice_best_path(tl, 1.0, 0.7)
        assert words == tr.words and tids == list(tr.alignment)
        assert cost == pytest.approx(tr.cost, abs=1e-3)
        assert (words, tids) == tuple(jlat.lattice_best_path(jl, 1.0, 0.7)[:2])
        ref = list(tr.words[:2]) + [3, 1]
        assert tlat.lattice_oracle(tl, ref) == jlat.lattice_oracle(jl, ref)
        assert tlat.lattice_oracle(tl, tr.words)[0] == 0


def compact_lattices_equal(a, b, atol=1e-5):
    assert a.num_states == b.num_states and a.start == b.start
    for s in range(a.num_states):
        (ga, aa, sa), (gb, ab, sb) = a.finals[s], b.finals[s]
        assert sa == sb and ga == pytest.approx(gb, abs=atol)
        assert aa == pytest.approx(ab, abs=atol)
        assert len(a.arcs[s]) == len(b.arcs[s])
        for x, y in zip(a.arcs[s], b.arcs[s]):
            assert (x.word, tuple(x.tids), x.nextstate) == (y.word, tuple(y.tids),
                                                             y.nextstate)
            assert x.graph_cost == pytest.approx(y.graph_cost, abs=atol)
            assert x.acoustic_cost == pytest.approx(y.acoustic_cost, abs=atol)


def compact_lattice_tuple(clat):
    """Everything a CompactLattice holds, for an exact comparison."""
    return (clat.num_states, clat.start, list(clat.finals),
            [[(a.word, tuple(a.tids), a.graph_cost, a.acoustic_cost, a.nextstate)
              for a in lst] for lst in clat.arcs])


def hand_lattice(mod):
    """Two paths for word 5 (different costs and tid strings), an
    eps-word detour, a tie on the total cost broken by the graph cost, and
    a dead branch."""
    lat = mod.Lattice()
    for t in range(7):
        lat.add_state(t)
    A = mod.LatticeArc
    lat.arcs[0] += [A(1, 5, 1.0, 2.0, 1), A(2, 5, 0.5, 2.0, 2), A(3, 0, 0.2, 0.1, 3)]
    lat.arcs[1] += [A(4, 0, 0.0, 1.0, 4)]
    lat.arcs[2] += [A(5, 0, 0.0, 1.5, 4)]
    lat.arcs[3] += [A(6, 5, 1.0, 1.8, 4), A(7, 9, 2.0, 1.0, 5)]
    lat.arcs[4] += [A(8, 6, 0.3, 0.3, 6)]
    lat.arcs[5] += [A(9, 6, 0.1, 0.2, 6)]
    lat.finals[6] = (0.5, 0.0)
    return lat


@pytest.mark.parametrize("beam", [0.5, 3.0, 8.0])
def test_determinize_equals_the_python_algorithm(beam, monkeypatch):
    """The port's Python algorithm (determinize_lattice, float64) against
    the JAX package's within 1e-5; determinize_lattice_pruned, which runs
    cpp/lattice.cc in both packages by default (float32 weights at its
    boundary), and the port's Python route of it, equal to the JAX
    package's default exactly."""
    cases = [(hand_lattice(jlat), hand_lattice(tlat), b, {})
             for b in (beam, np.inf)]  # np.inf: the unpruned subset construction
    for graph in ("folded", "split"):
        cases += [(jl, tl, beam, {}) for _jr, _tr, jl, tl in _lattices(graph, max_active=16)]
    cases.append((hand_lattice(jlat), hand_lattice(tlat), beam,
                  dict(acoustic_scale=0.5, lm_scale=2.0)))
    for jl, tl, b, kw in cases:
        want = jdet.determinize_lattice_pruned(jl, b, **kw)
        for algorithm in ("native", "python"):
            assert compact_lattice_tuple(tdet.determinize_lattice_pruned(
                tl, b, algorithm=algorithm, **kw)) == compact_lattice_tuple(want)
    monkeypatch.setattr(jnative, "available", lambda: False)
    for jl, tl, b, kw in cases:
        if not kw:
            compact_lattices_equal(jdet.determinize_lattice_pruned(jl, b),
                                   tdet.determinize_lattice(tl, b))


def test_parse_arpa_equals():
    with gzip.open(os.path.join(WORKDIR, "arpa.txt.gz"), "rt") as f:
        text = f.read()
    # a slice: the header and the first lines of every section
    keep, n = [], 0
    for ln in text.splitlines():
        if ln.startswith("\\") or ln.startswith("ngram") or not ln.strip():
            keep.append(ln)
            n = 0
        elif n < 400:
            keep.append(ln)
            n += 1
    sliced = "\n".join(keep)
    want, got = jarpa.parse_arpa(sliced), tarpa.parse_arpa(sliced)
    assert got.order == want.order == 3
    assert got.ngrams == want.ngrams and len(got.ngrams) == 1200
    for hist in [(), (jarpa.BOS,), ("w00001", "w00002"), ("w00003",)]:
        for w in ("w00001", "w00010", jarpa.EOS, "nope"):
            assert got.logprob(w, hist) == want.logprob(w, hist)


@pytest.mark.parametrize("order,cutoffs", [(3, None), (4, (0, 0, 1, 1)), (2, (0, 1))])
def test_estimate_ngram_lm_equals(order, cutoffs):
    sents = _sentences(400, 5)
    want = jngram.estimate_ngram_lm(sents, order=order, cutoffs=cutoffs)
    got = tngram.estimate_ngram_lm(sents, order=order, cutoffs=cutoffs)
    assert got.order == want.order and got.ngrams == want.ngrams
    assert got.score_sequence(sents[0]) == want.score_sequence(sents[0])
