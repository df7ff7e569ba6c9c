"""The graph-sharded token decode of the port against the JAX package's, on
the CPU.

The shard plan (`shard_graph`) array for array at N = 1, 2, 4 and 8; then
`decode_batch_tokens_sharded` with in-process CPU shards at N = 1 and 4
against the JAX function on the conftest's virtual CPU mesh of N devices,
on the JAX test's random graph (tests/test_sharded_decoder.py `_random_csr`,
the exact regime and a beam that prunes) and its toy yes/no HCLG: words,
alignments (the winning arcs' tids) and the per-frame token sets exactly,
costs within 1e-3.  The refusals (a split-eps graph, a plan for another N)
raise as the JAX package's do.  The process-group shards are held to these
in tests/test_torch_parallel.py."""

import tests.torch_threads  # noqa: F401
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import old_kaldi_git_tpu.decoder.sharded as jsh
import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu_torch.decoder.sharded as tsh
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
from old_kaldi_git_tpu.decoder.csr import CsrGraph, fst_to_csr
from old_kaldi_git_tpu.decoder.graph import mkgraph
from old_kaldi_git_tpu.fst.lang import make_unigram_grammar_fst
from old_kaldi_git_tpu.utils.log import KaldiError as JaxKaldiError
from old_kaldi_git_tpu_torch.utils.log import KaldiError
from tests.test_decoder import _simulate_loglikes, _toy_system
from tests.test_sharded_decoder import _random_csr
from tests.test_torch_chain import port_graph


def toy_hclg():
    """(JAX CsrGraph, loglikes [3, T, P], num_frames) of the JAX test's
    yes/no HCLG and three simulated utterances."""
    lang, _topo, cd, tm = _toy_system()
    gfst = make_unigram_grammar_fst([["yes"], ["no"], ["yes", "no"]], lang.words)
    csr = fst_to_csr(mkgraph(lang, gfst, cd, tm), tm.tid_to_pdf_array())
    phones = {"yes": ["Y", "EH", "S"], "no": ["N", "OW"]}
    cases = [["yes"], ["no", "yes"], ["no", "no", "no"]]
    lls = [_simulate_loglikes(tm, cd, lang, [lang.phones[p] for w in c for p in phones[w]],
                              frames_per_phone=6, sep=2.0) for c in cases]
    T = max(x.shape[0] for x in lls)
    loglikes = np.full((len(cases), T, cd.num_pdfs), -20.0, np.float32)
    nf = np.zeros(len(cases), np.int32)
    for i, x in enumerate(lls):
        loglikes[i, :x.shape[0]] = x
        nf[i] = x.shape[0]
    return csr, loglikes, nf


def both(g, ll, nf, N, beam, max_active, scale, want_lattice=True):
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("graph",))
    jres = jsh.decode_batch_tokens_sharded(
        g, ll, nf, mesh=mesh, want_lattice=want_lattice,
        opts=jvit.ViterbiOptions(beam=beam, max_active=max_active, acoustic_scale=scale))
    tres = tsh.decode_batch_tokens_sharded(
        port_graph(g), ll, nf, group=tsh.InProcessShards(["cpu"] * N),
        want_lattice=want_lattice,
        opts=tvit.ViterbiOptions(beam=beam, max_active=max_active, acoustic_scale=scale))
    return jres, tres


def same(jres, tres):
    assert len(jres) == len(tres)
    for jr, tr in zip(jres, tres):
        assert (jr is None) == (tr is None)
        if jr is None:
            continue
        assert tr.words == jr.words
        assert np.array_equal(tr.alignment, jr.alignment)
        assert tr.cost == pytest.approx(jr.cost, abs=1e-3)
        if jr.frame_states is not None:
            assert np.array_equal(tr.frame_states, jr.frame_states)


@pytest.mark.parametrize("N", [1, 2, 4, 8])
def test_shard_plan_equals_the_jax_packages(N):
    g = _random_csr(np.random.default_rng(1))
    a, b = jsh.shard_graph(g, N), tsh.shard_graph(port_graph(g), N)
    assert b.num_shards == N
    for f in ("lo", "tile_off", "tile_ptr", "tiles", "pad2orig"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert b.md == a.md


@pytest.mark.parametrize("N", [1, 4])
def test_exact_regime_equals_the_jax_package(N):
    """K >= S and no beam: exact Viterbi on both sides."""
    rng = np.random.default_rng(2)
    g = _random_csr(rng)
    ll = rng.normal(size=(3, 40, 20)).astype(np.float32)
    nf = np.array([40, 31, 17], np.int32)
    same(*both(g, ll, nf, N, 1e9, 512, 0.1))


@pytest.mark.parametrize("N", [1, 4])
def test_pruning_beam_equals_the_jax_package(N):
    """K = 64 of 500 states and beam 8: the local top-K and the merge prune."""
    rng = np.random.default_rng(5)
    g = _random_csr(rng)
    ll = rng.normal(size=(4, 30, 20)).astype(np.float32)
    nf = np.array([30, 30, 12, 0], np.int32)
    same(*both(g, ll, nf, N, 8.0, 64, 0.5))


@pytest.mark.parametrize("N", [1, 4])
def test_toy_hclg_equals_the_jax_package(N):
    csr, ll, nf = toy_hclg()
    jres, tres = both(csr, ll, nf, N, 30.0, 200, 1.0)
    same(jres, tres)
    assert all(r is not None and r.words for r in tres)


def test_four_shards_give_the_single_device_words():
    """The sharded search at N = 4 and the port's unsharded token decode."""
    csr, ll, nf = toy_hclg()
    pg = port_graph(csr)
    opts = tvit.ViterbiOptions(beam=30.0, max_active=200, acoustic_scale=1.0)
    single = tvit.decode_batch_tokens(pg, ll, nf, opts, device="cpu")
    shd = tsh.decode_batch_tokens_sharded(pg, ll, nf, group=tsh.InProcessShards(["cpu"] * 4),
                                          opts=opts)
    for a, b in zip(single, shd):
        assert b.words == a.words
        assert np.array_equal(b.alignment, a.alignment)
        assert b.cost == pytest.approx(a.cost, abs=1e-3)


def test_budget_at_one_shard_is_the_unsharded_budget():
    """ET at N = 1 is viterbi._token_budget's; at N > 1 each shard's share
    with the skew slack (the JAX rule), never below 128."""
    csr, _ll, _nf = toy_hclg()
    pg = port_graph(csr)
    for K in (4, 64, 200):
        assert tsh.shard_budget(tsh.shard_graph(pg, 1), K) == tvit._token_budget(pg, K)
    big = port_graph(_random_csr(np.random.default_rng(1), S=20000))
    for N in (1, 2, 4):
        sg = tsh.shard_graph(big, N)
        mean = max(1.0, (int(sg.tile_off[-1]) + sg.tiles_per_shard) / 20000)
        want = int(min(sg.tiles_per_shard,
                       1.25 * 1024 * mean * (1.5 if N > 1 else 1.0) / N))
        assert tsh.shard_budget(sg, 1024) == max(128, -(-want // 128) * 128)


def test_split_eps_graph_is_refused():
    rng = np.random.default_rng(4)
    g = _random_csr(rng, S=64)
    split = CsrGraph(
        start=g.start, row_ptr=g.row_ptr, tid=g.tid, pdf=g.pdf, weight=g.weight,
        nextstate=g.nextstate, final_weight=g.final_weight, arc_olabels=g.arc_olabels,
        final_olabels=g.final_olabels, eps_ns=np.zeros(64, np.int32),
        eps_w=np.zeros(64, np.float32), eps_olab=np.zeros(64, np.int32), eps_depth=1)
    ll = rng.normal(size=(1, 5, 20)).astype(np.float32)
    with pytest.raises(JaxKaldiError):
        jsh.shard_graph(split, 2)
    with pytest.raises(KaldiError):
        tsh.shard_graph(port_graph(split), 2)
    with pytest.raises(KaldiError):
        tsh.decode_batch_tokens_sharded(port_graph(split), ll, [5], device="cpu")


def test_plan_for_another_shard_count_is_refused():
    rng = np.random.default_rng(3)
    g = _random_csr(rng, S=64)
    ll = rng.normal(size=(1, 5, 20)).astype(np.float32)
    with pytest.raises(ValueError):
        jsh.decode_batch_tokens_sharded(jsh.shard_graph(g, 4), ll, [5],
                                        mesh=Mesh(np.asarray(jax.devices()[:2]), ("graph",)))
    with pytest.raises(ValueError):
        tsh.decode_batch_tokens_sharded(tsh.shard_graph(port_graph(g), 4), ll, [5],
                                        group=tsh.InProcessShards(["cpu"] * 2))
