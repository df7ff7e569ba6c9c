"""Chain decode in the port vs the JAX package on the CPU.

Split-eps toy graphs (emitting arcs plus one backoff eps arc a state, built
by the JAX package's `fst_to_split_csr_arrays` and handed to both decoders
as the same arrays): the hop table exactly; words exactly and path costs
within 1e-3 (float32 sums of the same terms, contracted differently by the
two backends) for several K (K < D+1 included), beams and acoustic scales,
with zero-frame rows and beams that die; and the split decode against the
folded decode of the same graph.  The committed chain system:
tests/test_torch_chain_models.py, which uses these helpers, as
tests/test_torch_lattice*.py and tests/test_torch_online*.py do."""

import tests.torch_threads  # noqa: F401
import os

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.decoder.csr as jcsr
import old_kaldi_git_tpu.decoder.viterbi as jvit
from old_kaldi_git_tpu.fst.vector_fst import INF, Arc, VectorFst
import old_kaldi_git_tpu_torch.decoder.csr as tcsr
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")
_FIELDS = ("start", "row_ptr", "tid", "pdf", "weight", "nextstate", "final_weight",
           "arc_olabels", "final_olabels", "eps_ns", "eps_w", "eps_olab", "eps_depth")


def port_graph(g):
    """The port's CsrGraph over the same arrays as a JAX CsrGraph."""
    return tcsr.CsrGraph(**{f: getattr(g, f) for f in _FIELDS})


def backoff_fst(seed, S=40, P=12, chain_len=3, emit=3, dead_after=None):
    """A backoff-shaped FST: `emit` random emitting arcs a state, an eps arc
    s → s+1 except at the end of each run of `chain_len` states (eps chains
    of depth chain_len-1, some with words), finals on every fifth state.
    With `dead_after`, emitting arcs only move forward and the states from
    `dead_after` on emit nothing, so long utterances die."""
    rng = np.random.default_rng(seed)
    fst = VectorFst()
    for _ in range(S):
        fst.add_state()
    fst.start = 0
    for s in range(S):
        if dead_after is None or s < dead_after:
            for _ in range(emit):
                nxt = (int(rng.integers(0, S)) if dead_after is None
                       else min(S - 1, s + 1 + int(rng.integers(0, 2))))
                fst.add_arc(s, Arc(int(rng.integers(1, P + 1)), int(rng.integers(0, 5)),
                                   float(rng.exponential(0.5)), nxt))
        if s % chain_len != chain_len - 1 and s + 1 < S:
            fst.add_arc(s, Arc(0, int(rng.integers(0, 3)),
                               float(rng.exponential(0.3)), s + 1))
    for s in range(0, S, 5):
        fst.set_final(s, float(rng.exponential(0.2)))
    return fst


def split_and_folded(fst, P=12):
    """(folded JAX CsrGraph, split JAX CsrGraph) of one FST, as
    tests/test_online.py _backoff_split_system builds them."""
    tid_to_pdf = np.arange(P + 1, dtype=np.int32)
    tid_to_pdf[1:] = np.arange(P)
    folded = jcsr.fst_to_csr(fst, tid_to_pdf)
    counts = np.asarray([len(a) for a in fst.arcs], np.int64)
    row_ptr = np.zeros(fst.num_states + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    arcs = [a for lst in fst.arcs for a in lst]
    il = np.asarray([a.ilabel for a in arcs], np.int32)
    ol = np.asarray([a.olabel for a in arcs], np.int32)
    w = np.asarray([a.weight for a in arcs], np.float32)
    ns = np.asarray([a.nextstate for a in arcs], np.int32)
    finals = np.asarray([f if f != INF else np.inf for f in fst.finals], np.float32)
    split = jcsr.fst_to_split_csr_arrays(fst.start, row_ptr.astype(np.int32), il, ol,
                                         w, ns, finals, tid_to_pdf)
    return folded, split


def compare(jres, tres, cost_atol=1e-3):
    assert len(jres) == len(tres)
    for jr, tr in zip(jres, tres):
        assert (jr is None) == (tr is None)
        if jr is None:
            continue
        assert tr.words == jr.words
        assert np.array_equal(tr.alignment, jr.alignment)
        assert tr.cost == pytest.approx(jr.cost, abs=cost_atol)


@pytest.mark.parametrize("chain_len", [3, 7])
def test_eps_hop_table_equal(chain_len):
    _, split = split_and_folded(backoff_fst(7, chain_len=chain_len))
    tg = port_graph(split)
    want = np.asarray(jvit._eps_hop_table(split)[0])
    got, D = tvit._eps_hop_table_host(tg)
    assert D == split.eps_depth == chain_len - 1
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    dev, D2 = tvit._eps_hop_table(tg, torch.device("cpu"))
    assert D2 == D and np.array_equal(dev.numpy(), want)


@pytest.mark.parametrize("max_active,beam,scale,chain_len", [
    (4, 1e9, 0.7, 7),    # K = 4 < D + 1 = 7: only the first K start seeds are kept
    (4, 3.0, 1.0, 3),
    (8, 4.0, 0.3, 7),
    (64, 1e9, 0.7, 3),
    (64, 6.0, 1.5, 7),
])
def test_split_decode_words_equal(max_active, beam, scale, chain_len):
    _, split = split_and_folded(backoff_fst(7, chain_len=chain_len))
    rng = np.random.default_rng(11)
    ll = rng.normal(size=(4, 25, 12)).astype(np.float32) * 2.0
    nf = np.asarray([25, 0, 17, 9], np.int32)  # row 1: batch padding
    o = dict(beam=beam, max_active=max_active, acoustic_scale=scale)
    jres = jvit.decode_batch_tokens(split, ll, nf, jvit.ViterbiOptions(**o))
    tres = tvit.decode_batch_tokens(port_graph(split), ll, nf, tvit.ViterbiOptions(**o),
                                    device="cpu")
    assert jres[0] is not None
    compare(jres, tres)
    assert tres[1].words == [] and len(tres[1].alignment) == 0


def test_split_decode_dead_beams_equal():
    """States past 6 emit nothing: utterances longer than the graph's paths
    die on a frame (None), short ones decode, on both sides."""
    _, split = split_and_folded(backoff_fst(3, S=12, chain_len=3, dead_after=6))
    rng = np.random.default_rng(5)
    ll = rng.normal(size=(4, 30, 12)).astype(np.float32)
    nf = np.asarray([30, 2, 1, 0], np.int32)
    o = dict(beam=1e9, max_active=8, acoustic_scale=1.0)
    jres = jvit.decode_batch_tokens(split, ll, nf, jvit.ViterbiOptions(**o))
    tres = tvit.decode_batch_tokens(port_graph(split), ll, nf, tvit.ViterbiOptions(**o),
                                    device="cpu")
    assert jres[0] is None and any(r is not None for r in jres[1:])
    compare(jres, tres)


@pytest.mark.parametrize("seed", [7, 8])
def test_split_decode_equals_folded_decode(seed):
    """The split graph and the folded graph of one FST describe the same
    paths: an exact search (no beam, K above the states) finds the same
    words, alignment and cost on both."""
    folded, split = split_and_folded(backoff_fst(seed))
    rng = np.random.default_rng(seed)
    ll = rng.normal(size=(3, 25, 12)).astype(np.float32)
    nf = np.asarray([25, 17, 9], np.int32)
    o = tvit.ViterbiOptions(beam=1e9, max_active=64, acoustic_scale=0.7)
    rs = tvit.decode_batch_tokens(port_graph(split), ll, nf, o, device="cpu")
    rf = tvit.decode_batch_tokens(port_graph(folded), ll, nf, o, device="cpu")
    assert all(r is not None for r in rs)
    compare(rf, rs)


def test_start_closure_seeds():
    _, split = split_and_folded(backoff_fst(7, chain_len=7))
    tg = port_graph(split)
    seeds = tvit.start_closure(tg, 6)
    assert [s for s, _ in seeds] == list(range(7))
    # float64 sums of the float32 hop weights, as the JAX package sums them
    c = 0.0
    for k in range(1, 7):
        c += float(tg.eps_w[k - 1])
        assert seeds[k][1] == c
    assert len(tvit.start_closure(tg, 2)) == 3
