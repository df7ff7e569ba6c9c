"""Lattices in the port vs the JAX package on the CPU.

The decoder's lattice records on toy graphs, folded and split-eps: the
TokenLattice arrays equal (slots, arcs, post-hop states and final states
exactly; acoustic costs within 1e-5, final costs within 1e-4: float32 path
sums that the two backends contract differently), with padding frames,
zero-frame rows and the overflow fallback; records never land on padding
frames.  The host copies: the rebuilt lattice and its best path (which is
the decoder's 1-best), the oracle, the pruned determinization (held
against the JAX package's Python algorithm: states, arcs and weights within
1e-5), ARPA parsing, n-gram estimation and LM rescoring (best path and cost
within 1e-4).  The rescoring recipe on the committed system: 2 utterances
with a small LM text in tier-1, the benchmark's 64 noisy utterances with
the full 4-gram marked slow."""

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
import old_kaldi_git_tpu.lat.rescore as jresc
import old_kaldi_git_tpu.lm.arpa as jarpa
import old_kaldi_git_tpu.lm.ngram as jngram
import old_kaldi_git_tpu.recipes.minilib as jminilib
import old_kaldi_git_tpu_torch.decoder.csr as tcsr
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
import old_kaldi_git_tpu_torch.lat.determinize as tdet
import old_kaldi_git_tpu_torch.lat.lattice as tlat
import old_kaldi_git_tpu_torch.lat.rescore as tresc
import old_kaldi_git_tpu_torch.lm.arpa as tarpa
import old_kaldi_git_tpu_torch.lm.ngram as tngram
import old_kaldi_git_tpu_torch.recipes.minilib as tminilib
from tests.test_torch_chain import backoff_fst, port_graph, split_and_folded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")


def random_graph(seed, S=300, deg=4, P=12):
    """A folded random graph with words on a fifth of the arcs."""
    rng = np.random.default_rng(seed)
    A = S * deg
    kw = dict(
        start=0, row_ptr=(np.arange(S + 1) * deg).astype(np.int32),
        tid=rng.integers(1, 100, A).astype(np.int32),
        pdf=rng.integers(0, P, A).astype(np.int32),
        weight=rng.exponential(1.0, A).astype(np.float32),
        nextstate=((np.repeat(np.arange(S), deg) + rng.integers(1, 50, A)) % S
                   ).astype(np.int32),
        final_weight=np.where(rng.random(S) < 0.3, rng.exponential(1.0, S),
                              np.inf).astype(np.float32),
        arc_olabels=[((int(rng.integers(1, 30)),) if rng.random() < 0.2 else ())
                     for _ in range(A)],
        final_olabels=[() for _ in range(S)])
    return jcsr.CsrGraph(**kw)


GRAPHS = {
    "folded": lambda: random_graph(0),
    "split": lambda: split_and_folded(backoff_fst(7))[1],
    "split_deep": lambda: split_and_folded(backoff_fst(9, chain_len=5))[1],
    "folded_of_split": lambda: split_and_folded(backoff_fst(7))[0],
}


def decode_both(jg, ll, nf, timings=None, **o):
    lat = {k: o.pop(k) for k in ("lattice_beam", "lattice_budget") if k in o}
    jres = jvit.decode_batch_tokens(jg, ll, nf, jvit.ViterbiOptions(**o),
                                    want_lattice=True, **lat)
    tg = port_graph(jg) if jg.eps_ns is not None else tcsr.CsrGraph(
        **{f: getattr(jg, f) for f in ("start", "row_ptr", "tid", "pdf", "weight",
                                       "nextstate", "final_weight", "arc_olabels",
                                       "final_olabels")})
    tres = tvit.decode_batch_tokens(tg, ll, nf, tvit.ViterbiOptions(**o),
                                    want_lattice=True, device="cpu", timings=timings,
                                    **lat)
    return tg, jres, tres


def assert_token_lattices_equal(jl, tl):
    assert (jl is None) == (tl is None)
    if jl is None:
        return
    for f in ("src_slot", "dst_slot", "arc", "dst_state", "final_states"):
        a, b = getattr(jl, f), getattr(tl, f)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    assert jl.ac.shape == tl.ac.shape
    np.testing.assert_allclose(tl.ac, jl.ac, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tl.final_costs, jl.final_costs, rtol=0, atol=1e-4)


def assert_results_equal(jres, tres):
    assert len(jres) == len(tres)
    for jr, tr in zip(jres, tres):
        assert (jr is None) == (tr is None)
        if jr is None:
            continue
        assert tr.words == jr.words and np.array_equal(tr.alignment, jr.alignment)
        assert tr.cost == pytest.approx(jr.cost, abs=1e-3)
        assert_token_lattices_equal(jr.token_lattice, tr.token_lattice)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("max_active,beam,lattice_beam,scale", [
    (4, 1e9, 1e9, 0.7),
    (16, 5.0, 3.0, 1.0),
    (64, 1e9, 8.0, 0.5),
])
def test_token_lattice_arrays_equal(graph, max_active, beam, lattice_beam, scale):
    """Rows of different lengths (padding frames), a zero-frame row."""
    jg = GRAPHS[graph]()
    rng = np.random.default_rng(11)
    ll = rng.normal(size=(4, 25, 12)).astype(np.float32) * 2.0
    nf = np.asarray([25, 17, 0, 9], np.int32)
    _, jres, tres = decode_both(jg, ll, nf, beam=beam, max_active=max_active,
                                acoustic_scale=scale, lattice_beam=lattice_beam)
    assert sum(r is not None and r.token_lattice is not None for r in jres) >= 2
    assert_results_equal(jres, tres)


def test_overflow_fallback_arrays_equal():
    """More live records than the packed buffer holds (R = 64 a frame):
    both sides fetch those utterances' full columns instead."""
    jg = random_graph(1, S=500, deg=8)
    rng = np.random.default_rng(3)
    ll = rng.normal(size=(2, 12, 12)).astype(np.float32)
    nf = np.asarray([12, 7], np.int32)
    timings = {}
    _, jres, tres = decode_both(jg, ll, nf, timings, beam=1e9, max_active=256,
                                acoustic_scale=1.0, lattice_beam=1e9, lattice_budget=256)
    assert timings["lattice_overflow_fallbacks"] == 2
    assert all(r.token_lattice.arc.shape == (n, 256) for r, n in zip(tres, nf))
    assert_results_equal(jres, tres)


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


def lattices_equal(a, b, atol=1e-5):
    assert a.num_states == b.num_states and a.start == b.start
    assert a.state_time == b.state_time
    assert a.finals == pytest.approx(b.finals, abs=atol)
    for s in range(a.num_states):
        assert len(a.arcs[s]) == len(b.arcs[s])
        for x, y in zip(a.arcs[s], b.arcs[s]):
            assert (x.ilabel, x.olabel, x.nextstate) == (y.ilabel, y.olabel, y.nextstate)
            assert x.graph_cost == pytest.approx(y.graph_cost, abs=atol)
            assert x.acoustic_cost == pytest.approx(y.acoustic_cost, abs=atol)


def _lattices(graph, seed=11, max_active=64, lattice_beam=8.0):
    jg = GRAPHS[graph]()
    rng = np.random.default_rng(seed)
    ll = rng.normal(size=(3, 25, 12)).astype(np.float32) * 2.0
    nf = np.asarray([25, 17, 9], np.int32)
    tg, jres, tres = decode_both(jg, ll, nf, beam=1e9, max_active=max_active,
                                 acoustic_scale=0.7, lattice_beam=lattice_beam)
    out = []
    for jr, tr in zip(jres, tres):
        jl = jlat.lattice_from_token_records(jg, jr.token_lattice)
        tl = tlat.lattice_from_token_records(tg, tr.token_lattice)
        out.append((jr, tr, jl, tl))
    return out


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
    monkeypatch.setattr(jnative, "available", lambda: False)
    for b in (beam, np.inf):  # the unpruned subset construction, on the hand lattice
        got = tdet.determinize_lattice_pruned(hand_lattice(tlat), b)
        want = jdet.determinize_lattice_pruned(hand_lattice(jlat), b)
        compact_lattices_equal(want, got)
    for graph in ("folded", "split"):
        for _jr, _tr, jl, tl in _lattices(graph, max_active=16):
            compact_lattices_equal(jdet.determinize_lattice_pruned(jl, beam),
                                   tdet.determinize_lattice_pruned(tl, beam))
    scaled = tdet.determinize_lattice_pruned(hand_lattice(tlat), beam,
                                             acoustic_scale=0.5, lm_scale=2.0)
    compact_lattices_equal(
        jdet.determinize_lattice_pruned(hand_lattice(jlat), beam, acoustic_scale=0.5,
                                        lm_scale=2.0), scaled)


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


def _sentences(n, seed):
    opts = tminilib.MinilibOptions(num_words=300)
    return [tminilib._to_words(s) for s in tminilib.make_text(opts, n, seed)]


@pytest.mark.parametrize("order,cutoffs", [(3, None), (4, (0, 0, 1, 1)), (2, (0, 1))])
def test_estimate_ngram_lm_equals(order, cutoffs):
    sents = _sentences(400, 5)
    want = jngram.estimate_ngram_lm(sents, order=order, cutoffs=cutoffs)
    got = tngram.estimate_ngram_lm(sents, order=order, cutoffs=cutoffs)
    assert got.order == want.order and got.ngrams == want.ngrams
    assert got.score_sequence(sents[0]) == want.score_sequence(sents[0])


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
        jc = jdet.determinize_lattice(jl, 8.0)
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
