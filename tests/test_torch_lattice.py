"""Lattices in the port vs the JAX package on the CPU.

The decoder's lattice records on toy graphs, folded and split-eps: the
TokenLattice arrays equal (slots, arcs, post-hop states and final states
exactly; acoustic costs within 1e-5, final costs within 1e-4: float32 path
sums that the two backends contract differently), with padding frames,
zero-frame rows and the overflow fallback.  The records on padding frames
and the host copies (rebuild, best path, oracle, determinization, ARPA,
n-gram estimation): tests/test_torch_lattice_rebuild.py; LM rescoring and
the rescoring recipe: tests/test_torch_lattice_rescore.py; both use the
helpers here."""

import tests.torch_threads  # noqa: F401
import os

import numpy as np
import pytest

import old_kaldi_git_tpu.decoder.csr as jcsr
import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu.lat.lattice as jlat
import old_kaldi_git_tpu_torch.decoder.csr as tcsr
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
import old_kaldi_git_tpu_torch.lat.lattice as tlat
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


def _sentences(n, seed):
    opts = tminilib.MinilibOptions(num_words=300)
    return [tminilib._to_words(s) for s in tminilib.make_text(opts, n, seed)]
