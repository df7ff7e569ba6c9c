"""Port decode_batch (dense and top-K `_decode_and_backtrace`) vs the JAX
package's on the CPU, on toy graphs: words and alignments equal, costs within
1e-3 (float32 sums of the same terms; the backends may contract differently).

Where a case runs at acoustic_scale ≠ 1 the JAX side gets the loglikes
pre-scaled by np.float32(scale) and decodes at 1.0: its own product at 0.1
is computed in two places with different rounding (XLA fusions), and its
winner test `cand <= new_alpha[ns] + 1e-6` then misses winners.  The port
computes the product once, so the pre-scaled reference is the steady one."""

import tests.torch_threads  # noqa: F401
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import old_kaldi_git_tpu.decoder.csr as jcsr
import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu_torch.decoder.csr as tcsr
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
from test_torch_decoder import _compare, _ragged_graph, _random_graph


def _jax_search(kw, ll, nf, K, acoustic_scale, beam):
    """JAX `_decode_and_backtrace` at K, on pre-scaled loglikes."""
    g = jcsr.CsrGraph(**kw)
    nf = np.asarray(nf, np.int32)
    ll = ll * np.float32(acoustic_scale)
    frm = np.repeat(np.arange(g.num_states, dtype=np.int32), g.out_degree())
    fw = np.where(np.isfinite(g.final_weight), g.final_weight, jvit.BIG)
    end, final, cost, arcs = jvit._decode_and_backtrace(
        jnp.asarray(frm), jnp.asarray(g.pdf), jnp.asarray(g.weight),
        jnp.asarray(g.nextstate), g.start, jnp.asarray(ll), jnp.asarray(nf),
        1.0, beam, jnp.asarray(fw.astype(np.float32)), K, g.num_states)
    return jvit.results_from_arcs(g, np.asarray(arcs), np.asarray(end),
                                  np.asarray(final), np.asarray(cost, np.float64), nf)


def _port_search(kw, ll, nf, K, acoustic_scale, beam):
    g = tcsr.CsrGraph(**kw)
    nf = np.asarray(nf, np.int32)
    frm, pdf, w, ns, fw = tvit._dense_graph_arrays(g, torch.device("cpu"))
    end, final, cost, arcs = tvit._decode_and_backtrace(
        frm, pdf, w, ns, g.start, torch.from_numpy(ll), torch.from_numpy(nf),
        acoustic_scale, beam, fw, K, g.num_states)
    assert arcs.dtype == torch.int32 and tuple(arcs.shape) == (ll.shape[1], ll.shape[0])
    return tvit.results_from_arcs(g, arcs.numpy(), end.numpy().astype(np.int32),
                                  final.numpy(), cost.numpy().astype(np.float64), nf)


def _dead_graph():
    """One arc then nothing: a longer utterance kills the beam."""
    return dict(
        start=0, row_ptr=np.array([0, 1, 1], np.int32),
        tid=np.array([1], np.int32), pdf=np.array([0], np.int32),
        weight=np.array([0.5], np.float32), nextstate=np.array([1], np.int32),
        final_weight=np.array([np.inf, 0.0], np.float32),
        arc_olabels=[(7,)], final_olabels=[(), ()])


def _tie_graph():
    """State 0 fans out to states 1..12 at equal cost; each keeps a self-loop
    and a final weight that falls with the state id.  At K = 4 the K-th
    place cuts through a 12-way exact tie: the kept states must be 1..4
    (lowest ids first, as lax.top_k puts equal values), whose best end is 4."""
    fan, S = 12, 13
    arcs = [(0, i, 0.5, (i,)) for i in range(1, fan + 1)]
    arcs += [(i, i, 0.25, ()) for i in range(1, fan + 1)]
    arcs.sort(key=lambda a: a[0])
    row_ptr = np.zeros(S + 1, np.int32)
    np.cumsum(np.bincount([a[0] for a in arcs], minlength=S), out=row_ptr[1:])
    return dict(
        start=0, row_ptr=row_ptr,
        tid=np.arange(1, len(arcs) + 1, dtype=np.int32),
        pdf=np.zeros(len(arcs), np.int32),
        weight=np.array([a[2] for a in arcs], np.float32),
        nextstate=np.array([a[1] for a in arcs], np.int32),
        final_weight=np.array([np.inf] + [0.0625 * (fan - i) for i in range(1, S)],
                              np.float32),
        arc_olabels=[a[3] for a in arcs], final_olabels=[() for _ in range(S)])


def _case(name):
    """(graph fields, loglikes, num_frames, acoustic_scale, beam)."""
    if name == "ragged_lengths_and_empty_rows":
        rng = np.random.default_rng(12)
        kw = _random_graph(4, S=300, words=True, final_all=False)
        ll = (rng.normal(size=(5, 30, 20)) * 30).astype(np.float32)
        return kw, ll, [30, 22, 0, 7, 1], 0.1, 6.0
    if name == "dead_states_and_partial_fanout":
        rng = np.random.default_rng(11)
        ll = (rng.normal(size=(4, 24, 9)) * 2).astype(np.float32)
        return _ragged_graph(3), ll, [24, 0, 13, 24], 1.0, 12.0
    if name == "beam_dead_row":
        return _dead_graph(), np.zeros((2, 4, 2), np.float32), [4, 1], 0.1, 10.0
    raise KeyError(name)


CASES = ["ragged_lengths_and_empty_rows", "dead_states_and_partial_fanout",
         "beam_dead_row"]


@pytest.mark.parametrize("mode", ["dense", "topk"])
@pytest.mark.parametrize("name", CASES)
def test_search_matches_the_jax_package(name, mode):
    kw, ll, nf, scale, beam = _case(name)
    S = len(kw["row_ptr"]) - 1
    K = S if mode == "dense" else max(1, S // 8)
    jres = _jax_search(kw, ll, nf, K, scale, beam)
    tres = _port_search(kw, ll, nf, K, scale, beam)
    _compare(jres, tres)
    if name == "beam_dead_row":
        assert tres[0] is None and tres[1].words == [7]
    else:
        assert sum(r is not None and len(r.words) > 0 for r in tres) >= 2


@pytest.mark.parametrize("level", [0.0, 2.0])  # 2.0: every path cost is negative
def test_top_k_tie_across_the_kth_place(level):
    kw = _tie_graph()
    ll = np.full((2, 3, 1), level, np.float32)
    nf = [3, 2]
    jres = _jax_search(kw, ll, nf, 4, 1.0, 100.0)
    tres = _port_search(kw, ll, nf, 4, 1.0, 100.0)
    _compare(jres, tres, cost_atol=0.0)
    # kept states 1..4: the best end among them is state 4 (word 4)
    assert [r.words for r in tres] == [[4], [4]]
    # with every state kept the best end is 12
    full = _port_search(kw, ll, nf, 13, 1.0, 100.0)
    assert [r.words for r in full] == [[12], [12]]


@pytest.mark.parametrize("scale", [1.0, 0.1])
def test_decode_batch_matches_the_jax_package(scale):
    """Through both packages' decode_batch (the dense regime at this size)."""
    kw = _random_graph(7, S=200, words=True, final_all=False)
    rng = np.random.default_rng(8)
    ll = (rng.normal(size=(3, 25, 20)) * 10).astype(np.float32)
    nf = np.array([25, 18, 0], np.int32)
    o = dict(beam=8.0, max_active=50)
    jres = jvit.decode_batch(jcsr.CsrGraph(**kw), ll * np.float32(scale), nf,
                             jvit.ViterbiOptions(acoustic_scale=1.0, **o))
    timings = {}
    tres = tvit.decode_batch(tcsr.CsrGraph(**kw), ll, nf,
                             tvit.ViterbiOptions(acoustic_scale=scale, **o),
                             device="cpu", timings=timings)
    _compare(jres, tres)
    assert tres[0] is not None and tres[2].words == []
    assert sorted(timings) == ["host_tail_seconds", "search_seconds"]


def test_regime_thresholds_are_the_jax_packages():
    src = inspect.getsource(jvit.decode_batch)
    assert "B * graph.num_states * 4 > 2_000_000_000" in src
    assert "T * B * graph.num_states * 4 <= 4_000_000_000" in src
    assert tvit.TOKENS_ABOVE_BYTES == 2_000_000_000
    assert tvit.DENSE_UP_TO_BYTES == 4_000_000_000
    S = 1_058_721  # the committed HCLG
    assert tvit.decode_regime(256, 654, S, 7000) == ("topk", 7000)
    assert tvit.decode_regime(472, 654, S, 7000) == ("topk", 7000)
    assert tvit.decode_regime(473, 654, S, 7000)[0] == "tokens"
    assert tvit.decode_regime(4, 100, 2_500_000, 7000) == ("dense", 2_500_000)
    assert tvit.decode_regime(4, 101, 2_500_000, 7000) == ("topk", 7000)
    assert tvit.decode_regime(1, 1000, 1_000_000, 7000) == ("dense", 1_000_000)
    assert tvit.decode_regime(1, 1001, 1_000_000, 7000) == ("topk", 7000)
    assert tvit.decode_regime(1, 1001, 1_000_000, 7000, want_lattice=True) == ("topk", 7000)
    assert tvit.decode_regime(8, 10, 300, 16, want_lattice=True) == ("topk", 16)
    assert tvit.decode_regime(8, 10, 300, 512, want_lattice=True) == ("dense", 300)
    assert tvit.decode_regime(8, 10, 300, 16) == ("dense", 300)
    # exactly at the token-sparse threshold: B·S·4 = 2e9 stays dense/top-K
    assert tvit.decode_regime(500, 1, 1_000_000, 7000)[0] == "dense"
    assert tvit.decode_regime(500, 2, 1_000_000, 7000)[0] == "dense"
    assert tvit.decode_regime(500, 3, 1_000_000, 7000)[0] == "topk"
    assert tvit.decode_regime(501, 1, 1_000_000, 7000)[0] == "tokens"


def test_token_regime_goes_to_the_token_sparse_search(monkeypatch):
    seen = {}

    def fake_tokens(graph, loglikes, num_frames, opts, want_lattice=False, device=None):
        seen["shape"] = tuple(loglikes.shape)
        seen["want_lattice"] = want_lattice
        return []

    monkeypatch.setattr(tvit, "decode_regime", lambda *a, **k: ("tokens", 4))
    monkeypatch.setattr(tvit, "decode_batch_tokens", fake_tokens)
    g = tcsr.CsrGraph(**_ragged_graph(0))
    assert tvit.decode_batch(g, np.zeros((2, 3, 9), np.float32), [3, 3],
                             device="cpu") == []
    assert seen == {"shape": (2, 3, 9), "want_lattice": False}


def test_cost_state_key_orders_like_the_pair():
    rng = np.random.default_rng(16)
    cost = np.concatenate([rng.normal(size=200) * 50,
                           [0.0, -0.5, 0.5, 1e10, -1e10, 1e-42, -1e-42, 1e10, 0.5]]
                          ).astype(np.float32)
    state = rng.permutation(len(cost)).astype(np.int64)
    key = tvit._cost_state_key(torch.from_numpy(cost), torch.from_numpy(state)).numpy()
    assert len(np.unique(key)) == len(key)
    got = np.argsort(key)
    want = np.lexsort((state, cost))
    assert np.array_equal(cost[got], cost[want]) and np.array_equal(state[got], state[want])


def test_unported_modes_and_devices_raise(monkeypatch):
    kw = _ragged_graph(0)
    ll = np.zeros((1, 2, 9), np.float32)
    g = tcsr.CsrGraph(**kw)
    # the lattice mode is ported: K = min(max_active, S), per-frame tokens
    (res,) = tvit.decode_batch(g, ll, [2], tvit.ViterbiOptions(max_active=7),
                               want_lattice=True, device="cpu")
    assert res.frame_states.shape == res.frame_costs.shape == (2, 7)
    assert (res.frame_states[:, 0] >= 0).all() and (res.frame_costs < 1e10).any()
    split = tcsr.CsrGraph(**kw, eps_ns=np.full(60, -1, np.int32))
    with pytest.raises(NotImplementedError, match="chain"):
        tvit.decode_batch(split, ll, [2], device="cpu")
    with pytest.raises(tvit.KaldiError, match="pdf"):
        tvit.decode_batch(g, ll[:, :, :5], [2], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvit.decode_batch(g, torch.from_numpy(ll), [2])
