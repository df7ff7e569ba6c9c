"""Port decoder vs the JAX decoder on the CPU: tile layout arrays equal,
words/alignments equal and costs within 1e-3 (float32 sums of the same terms;
the two backends may contract multiply-adds differently) on toy and random
graphs, including zero-frame rows, a beam that dies, a truncating budget,
and the two hazards of the packed layout: int32-bitcast tiles and sort ties."""

import tests.torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.decoder.csr as jcsr
import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu_torch.decoder.csr as tcsr
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit

_FIELDS = ("start", "row_ptr", "tid", "pdf", "weight", "nextstate",
           "final_weight", "arc_olabels", "final_olabels")


def _both(**kw):
    """The same graph as the JAX package's CsrGraph and as the port's."""
    return jcsr.CsrGraph(**kw), tcsr.CsrGraph(**kw)


def _random_graph(seed, S=500, deg=4, P=20, words=False, final_all=True):
    rng = np.random.default_rng(seed)
    A = S * deg
    nxt = ((np.repeat(np.arange(S), deg) + rng.integers(1, 50, A)) % S)
    olab = [((int(rng.integers(1, 30)),) if words and rng.random() < 0.2 else ())
            for _ in range(A)]
    fw = (np.zeros(S, np.float32) if final_all else
          np.where(rng.random(S) < 0.3, rng.exponential(1.0, S),
                   np.inf).astype(np.float32))
    return dict(
        start=0, row_ptr=(np.arange(S + 1) * deg).astype(np.int32),
        tid=rng.integers(1, 100, A).astype(np.int32),
        pdf=rng.integers(0, P, A).astype(np.int32),
        weight=rng.exponential(1.0, A).astype(np.float32),
        nextstate=nxt.astype(np.int32), final_weight=fw,
        arc_olabels=olab, final_olabels=[() for _ in range(S)])


def _ragged_graph(seed, S=60, P=9):
    """Out-degrees 0..9 (dead states, partial tiles), words on some arcs."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 10, S)
    deg[0] = 5
    row_ptr = np.zeros(S + 1, np.int32)
    row_ptr[1:] = np.cumsum(deg)
    A = int(row_ptr[-1])
    return dict(
        start=0, row_ptr=row_ptr,
        tid=rng.integers(1, 50, A).astype(np.int32),
        pdf=rng.integers(0, P, A).astype(np.int32),
        weight=rng.exponential(1.0, A).astype(np.float32),
        nextstate=rng.integers(0, S, A).astype(np.int32),
        final_weight=np.where(rng.random(S) < 0.5, 0.25, np.inf).astype(np.float32),
        arc_olabels=[((int(rng.integers(1, 9)),) if rng.random() < 0.3 else ())
                     for _ in range(A)],
        final_olabels=[() for _ in range(S)])


def _compare(jres, tres, cost_atol=1e-3):
    assert len(jres) == len(tres)
    for jr, tr in zip(jres, tres):
        assert (jr is None) == (tr is None)
        if jr is None:
            continue
        assert tr.words == jr.words
        assert np.array_equal(tr.alignment, jr.alignment)
        assert tr.cost == pytest.approx(jr.cost, abs=cost_atol)


def _decode_both(kw, ll, nf, **o):
    jg, tg = _both(**kw)
    jres = jvit.decode_batch_tokens(jg, ll, nf, jvit.ViterbiOptions(**o))
    tres = tvit.decode_batch_tokens(tg, ll, nf, tvit.ViterbiOptions(**o),
                                    device="cpu")
    return jres, tres


@pytest.mark.parametrize("seed,md", [(0, 4), (1, 4), (2, 2)])
def test_build_tile_graph_arrays_equal(seed, md):
    jg, tg = _both(**_ragged_graph(seed))
    jt = jcsr.build_tile_graph(jg, md)
    tt = tcsr.build_tile_graph(tg, md)
    assert jt.md == tt.md and jt.num_tiles == tt.num_tiles
    for name in ("tile_ptr", "tiles", "pad2orig", "frm_pad"):
        a, b = getattr(jt, name), getattr(tt, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_token_budget_equal():
    for seed in (0, 1):
        jg, tg = _both(**_ragged_graph(seed, S=4000))
        for K in (4, 64, 1024):
            assert tvit._token_budget(tg, K) == jvit._token_budget(jg, K)


def test_random_graph_exact_viterbi_matches():
    """K >= S and an unbounded beam: both decoders are exact Viterbi."""
    kw = _random_graph(0)
    rng = np.random.default_rng(10)
    ll = rng.normal(size=(3, 40, 20)).astype(np.float32)
    jres, tres = _decode_both(kw, ll, np.full(3, 40, np.int32),
                              beam=1e9, max_active=512, acoustic_scale=0.1)
    assert all(r is not None for r in jres)
    _compare(jres, tres)


def test_words_ragged_lengths_zero_frame_rows_and_padding_frames():
    """Rows of different lengths, rows with nf=0 (batch padding) and frames
    past num_frames must not disturb the other rows."""
    kw = _ragged_graph(3)
    rng = np.random.default_rng(11)
    ll = rng.normal(size=(5, 24, 9)).astype(np.float32) * 2.0
    nf = np.array([24, 0, 13, 1, 0], np.int32)
    jres, tres = _decode_both(kw, ll, nf, beam=12.0, max_active=32,
                              acoustic_scale=1.0)
    _compare(jres, tres)
    assert tres[1] is not None and tres[1].words == [] and len(tres[1].alignment) == 0


def test_narrow_beam_and_small_max_active_match():
    kw = _random_graph(4, S=300, words=True, final_all=False)
    rng = np.random.default_rng(12)
    ll = rng.normal(size=(4, 30, 20)).astype(np.float32) * 3.0
    nf = np.array([30, 22, 30, 7], np.int32)
    jres, tres = _decode_both(kw, ll, nf, beam=4.0, max_active=16,
                              acoustic_scale=1.0)
    _compare(jres, tres)


def test_dead_beam_returns_none_and_one_frame_decodes():
    """A graph path shorter than the utterance: every candidate is BIG on a
    frame; the result must be None, not a sentinel state id on the host."""
    kw = dict(
        start=0, row_ptr=np.array([0, 1, 1], np.int32),
        tid=np.array([1], np.int32), pdf=np.array([0], np.int32),
        weight=np.array([0.5], np.float32), nextstate=np.array([1], np.int32),
        final_weight=np.array([np.inf, 0.0], np.float32),
        arc_olabels=[(7,)], final_olabels=[(), ()])
    ll = np.zeros((1, 4, 2), np.float32)
    jres, tres = _decode_both(kw, ll, [4], beam=10.0, max_active=4)
    assert jres == [None] and tres == [None]
    jres, tres = _decode_both(kw, ll[:, :1], [1], beam=10.0, max_active=4)
    _compare(jres, tres)
    assert tres[0].words == [7]


def test_truncating_budget_matches(monkeypatch):
    """A tile budget far below the active tiles drops the worst tokens'
    arcs: run starts beyond the budget must be dropped, not clamped."""
    kw = _random_graph(5, S=400, deg=8, words=True)
    rng = np.random.default_rng(13)
    ll = rng.normal(size=(3, 25, 20)).astype(np.float32)
    nf = np.array([25, 25, 18], np.int32)
    monkeypatch.setattr(jvit, "_token_budget", lambda g, K, md=4: 128)
    monkeypatch.setattr(tvit, "_token_budget", lambda g, K, md=4: 128)
    jres, tres = _decode_both(kw, ll, nf, beam=1e9, max_active=256,
                              acoustic_scale=0.5)
    _compare(jres, tres)
    # and the budget really did truncate: the full budget finds a better path
    monkeypatch.undo()
    _, full = _decode_both(kw, ll, nf, beam=1e9, max_active=256,
                           acoustic_scale=0.5)
    assert any(f.cost < t.cost - 1e-3 for f, t in zip(full, tres))


def test_int32_bitcast_tiles_keep_small_integers():
    """Hazard: the packed tiles carry float32 weights as int32 bit patterns
    beside small integers (pdf, nextstate).  Read as float32 those integers
    are denormals, which float copies may flush to zero.  Weights that ARE
    denormal or tiny, and pdf/nextstate ids of 1..3, must come through the
    device gather unchanged."""
    S, deg, P = 6, 4, 4
    A = S * deg
    tiny = np.float32(1e-42)  # denormal float32
    weight = np.full(A, tiny, np.float32)
    weight[::3] = np.float32(2.0)
    kw = dict(
        start=0, row_ptr=(np.arange(S + 1) * deg).astype(np.int32),
        tid=(np.arange(A) % 7 + 1).astype(np.int32),
        pdf=(np.arange(A) % P).astype(np.int32),
        weight=weight,
        nextstate=((np.arange(A) * 5 + 1) % S).astype(np.int32),
        final_weight=np.zeros(S, np.float32),
        arc_olabels=[() for _ in range(A)], final_olabels=[() for _ in range(S)])
    _, tg = _both(**kw)
    tt = tcsr.build_tile_graph(tg)
    _tile_ptr, tiles, _frm = tt.device_arrays(torch.device("cpu"))
    assert tiles.dtype == torch.int32
    rows = tiles[torch.arange(tt.num_tiles)]
    w = rows[..., 0].reshape(-1).view(torch.float32).numpy()
    assert np.array_equal(w.view(np.int32), weight.view(np.int32))
    assert np.array_equal(rows[..., 1].reshape(-1).numpy(), kw["pdf"])
    assert np.array_equal(rows[..., 2].reshape(-1).numpy(), kw["nextstate"])
    rng = np.random.default_rng(14)
    ll = rng.normal(size=(2, 12, P)).astype(np.float32)
    jres, tres = _decode_both(kw, ll, [12, 9], beam=1e9, max_active=8,
                              acoustic_scale=1.0)
    _compare(jres, tres, cost_atol=1e-5)


def test_sort_ties_resolve_like_the_reference():
    """Hazard: equal (dest, cost) candidates.  All weights and loglikes are
    equal, so every frame is full of exact ties and the winner is decided by
    sort stability alone; costs are sums of exact binary fractions, so both
    decoders must agree to the last bit, on alignments too.  Negative costs
    (positive loglikes) exercise the sign handling of the sort key."""
    S, deg, P = 40, 4, 3
    A = S * deg
    rng = np.random.default_rng(15)
    kw = dict(
        start=0, row_ptr=(np.arange(S + 1) * deg).astype(np.int32),
        tid=np.arange(1, A + 1).astype(np.int32),
        pdf=(np.arange(A) % P).astype(np.int32),
        weight=np.full(A, 0.5, np.float32),
        nextstate=rng.integers(0, S, A).astype(np.int32),
        final_weight=np.zeros(S, np.float32),
        arc_olabels=[() for _ in range(A)], final_olabels=[() for _ in range(S)])
    for level in (0.0, 2.0):  # 2.0: every path cost is negative
        ll = np.full((2, 10, P), level, np.float32)
        jres, tres = _decode_both(kw, ll, [10, 6], beam=3.0, max_active=8,
                                  acoustic_scale=1.0)
        _compare(jres, tres, cost_atol=0.0)


def test_dest_cost_key_orders_like_the_pair():
    rng = np.random.default_rng(16)
    cost = np.concatenate([
        rng.normal(size=200) * 50, [0.0, -0.5, 0.5, 1e10, -1e10, 1e-42, -1e-42]
    ]).astype(np.float32)
    dest = rng.integers(0, 5, len(cost)).astype(np.int32)
    key = tvit._dest_cost_key(torch.from_numpy(dest), torch.from_numpy(cost)).numpy()
    want = np.lexsort((cost, dest))
    got = np.argsort(key, kind="stable")
    assert np.array_equal(dest[got], dest[want])
    assert np.array_equal(cost[got], cost[want])


def test_lattice_calls_now_decode():
    """The call that raised before lattices were ported now decodes, as the
    JAX package does, and attaches a TokenLattice to every row."""
    kw = _ragged_graph(0)
    jg, tg = _both(**kw)
    ll = np.random.default_rng(17).normal(size=(2, 6, 9)).astype(np.float32)
    jres = jvit.decode_batch_tokens(jg, ll, [6, 2], want_lattice=True)
    tres = tvit.decode_batch_tokens(tg, ll, [6, 2], want_lattice=True, device="cpu")
    _compare(jres, tres)
    assert all(r.token_lattice is not None for r in tres)
    for jr, tr in zip(jres, tres):
        assert np.array_equal(tr.token_lattice.arc, jr.token_lattice.arc)


def test_split_calls_now_decode():
    """A split-eps graph without a single backoff arc (the call that raised
    before split graphs were ported) decodes as its folded twin and as the
    JAX package."""
    kw = _ragged_graph(0)
    eps = dict(eps_ns=np.full(60, -1, np.int32), eps_w=np.full(60, 1e10, np.float32),
               eps_olab=np.zeros(60, np.int32), eps_depth=0)
    jsplit, tsplit = _both(**kw, **eps)
    ll = np.random.default_rng(18).normal(size=(3, 8, 9)).astype(np.float32)
    nf = [8, 3, 0]
    o = dict(beam=1e9, max_active=16, acoustic_scale=1.0)
    jres = jvit.decode_batch_tokens(jsplit, ll, nf, jvit.ViterbiOptions(**o))
    tres = tvit.decode_batch_tokens(tsplit, ll, nf, tvit.ViterbiOptions(**o), device="cpu")
    _compare(jres, tres)
    _, folded = _decode_both(kw, ll, nf, **o)
    _compare(folded, tres)
    assert tres[0] is not None


def test_decode_runs_on_the_cpu_only_when_asked(monkeypatch):
    """device=None means the GPU, also for a tensor that lies on the CPU:
    without one the entry point raises and does not decode on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg = _both(**_ragged_graph(0))
    ll = np.zeros((1, 2, 9), np.float32)
    for unasked in (ll, torch.from_numpy(ll)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tvit.decode_batch_tokens(tg, unasked, [2])
    res = tvit.decode_batch_tokens(tg, torch.from_numpy(ll), [2], device="cpu")
    assert len(res) == 1
