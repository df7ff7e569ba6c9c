"""The helpers of the port's second CLI batch against their JAX counterparts,
on the CPU: `utils/threads.py` (`map_ordered` keeps the input's order
whatever the threads' timing; `prefetch`, `TaskSequencer`),
`fst/context.py` (`compose_context` and its ilabel_info, and
`add_subsequential_loop`, on the shared system's L_disambig, arc for arc),
`fst/rand.py` (`rand_fst`: the same FST from the same seed),
`fst/algorithms.py` (`fst_equivalent`, `add_disambig_self_loops`,
`replace_fst`), `decoder/csr.py` `fst_to_csr` (array for array the JAX
export and the native one of `read_hclg_csr`, weights equal in float32),
`lm/arpa.py` `write_const_arpa` and `gmm/mle.py` `write_accs` / `read_accs`
(byte for byte the JAX writers' files, each package reading the other's).
Every comparison is exact."""

import tests.torch_threads  # noqa: F401
import io
import random
import threading
import time

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.fst.algorithms as jalg
import old_kaldi_git_tpu.fst.context as jctx
import old_kaldi_git_tpu.fst.rand as jrand
import old_kaldi_git_tpu.fst.vector_fst as jvf
import old_kaldi_git_tpu.utils.threads as jthreads
import old_kaldi_git_tpu_torch.fst.algorithms as talg
import old_kaldi_git_tpu_torch.fst.context as tctx
import old_kaldi_git_tpu_torch.fst.rand as trand
import old_kaldi_git_tpu_torch.fst.vector_fst as tvf
import old_kaldi_git_tpu_torch.utils.threads as tthreads
from tests.torch_cli_system import system

CSR_FIELDS = ("row_ptr", "tid", "pdf", "weight", "nextstate", "final_weight")


def _to_jax(fst):
    j = jvf.VectorFst()
    j.start, j.finals = fst.start, list(fst.finals)
    j.arcs = [[jvf.Arc(a.ilabel, a.olabel, a.weight, a.nextstate) for a in lst]
              for lst in fst.arcs]
    return j


def _arcs(fst):
    return (fst.start, list(fst.finals),
            [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in lst] for lst in fst.arcs])


def _read(path):
    with open(path, "rb") as f:
        return tvf.VectorFst.read(f)


@pytest.fixture(scope="module")
def s():
    return system()


@pytest.mark.parametrize("num_threads", [1, 6])
def test_map_ordered_keeps_the_input_order_whatever_the_timing(num_threads):
    """Tasks that sleep a random time end out of order on 6 threads; the
    results come back in the input's order, as the JAX package's do, and
    the pending tasks stay within max_in_flight."""
    rng = random.Random(7)
    delays = [rng.uniform(0.0, 0.004) for _ in range(60)]
    running, peak, lock = [0], [0], threading.Lock()

    def work(i):
        with lock:
            running[0] += 1
            peak[0] = max(peak[0], running[0])
        time.sleep(delays[i])
        with lock:
            running[0] -= 1
        return i * i

    got = list(tthreads.map_ordered(work, range(60), num_threads, max_in_flight=8))
    assert got == list(jthreads.map_ordered(lambda i: i * i, range(60), num_threads))
    assert got == [i * i for i in range(60)] and peak[0] <= max(1, min(num_threads, 8))
    assert list(tthreads.prefetch(iter(range(50)), depth=3)) == list(range(50))
    with tthreads.TaskSequencer(num_threads) as seq:
        for i in range(20):
            seq.submit(work, i)
        assert list(seq.results()) == [i * i for i in range(20)]
        seq.submit(lambda: 1 / 0)
        seq.submit(work, 3)
        assert seq.wait() == (1, 1)


def test_prefetch_stops_its_producer_when_the_consumer_stops():
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    it = tthreads.prefetch(gen(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert len(produced) < 10


@pytest.mark.parametrize("N,P", [(1, 0), (2, 1), (3, 1)])
def test_compose_context_equals_the_jax_package(s, N, P):
    """C ∘ L_disambig of the shared system's lang (phones and #k
    disambiguation symbols on the input): the same CLG arc for arc and the
    same ilabel_info; the subsequential symbol one past the largest
    ilabel, as fstcomposecontext picks it."""
    p = s["p"]
    L = _read(p("lang", "L_disambig.fst"))
    with open(p("lang", "phones.txt")) as f:
        disambig = [int(i) for sym, i in (ln.split() for ln in f) if sym.startswith("#")]
    assert disambig
    subseq = 1 + max(a.ilabel for lst in L.arcs for a in lst)
    tclg, tinfo = tctx.compose_context(L, N, P, disambig, subseq)
    jclg, jinfo = jctx.compose_context(_to_jax(L), N, P, disambig, subseq)
    assert tinfo == jinfo and len(tinfo) > 10
    assert _arcs(tclg) == _arcs(jclg) and tclg.num_states >= L.num_states
    if N == 3:
        assert _arcs(tctx.add_subsequential_loop(L, subseq)) == _arcs(
            jctx.add_subsequential_loop(_to_jax(L), subseq))


def test_rand_fst_draws_the_jax_packages_fsts():
    for seed in range(6):
        for kw in ({}, {"acyclic": True}, {"functional_ish": True, "eps_prob": 0.4},
                   {"num_states": 9, "num_arcs": 20, "num_ilabels": 5}):
            t = trand.rand_fst(random.Random(seed), **kw)
            j = jrand.rand_fst(random.Random(seed), **kw)
            assert _arcs(t) == _arcs(j), (seed, kw)


def test_equivalence_self_loops_and_grammar_expansion_equal_the_jax_package():
    rng_t, rng_j = random.Random(3), random.Random(3)
    for trial in range(8):
        a = trand.rand_fst(rng_t, num_states=5, num_arcs=9)
        b = trand.rand_fst(rng_t, num_states=5, num_arcs=9)
        ja, jb = jrand.rand_fst(rng_j, num_states=5, num_arcs=9), jrand.rand_fst(
            rng_j, num_states=5, num_arcs=9)
        for x, y, jx, jy in ((a, a, ja, ja), (a, b, ja, jb)):
            for use_log in (False, True):
                assert talg.fst_equivalent(x, y, 5, 1e-4, use_log) == jalg.fst_equivalent(
                    jx, jy, 5, 1e-4, use_log), trial
        assert talg.fst_equivalent(a, a.copy(), 5)
        if not a.num_states:  # connect() emptied it
            continue
        pairs = [(30, 40), (31, 0)]
        talg.add_disambig_self_loops(a, pairs)
        jalg.add_disambig_self_loops(ja, pairs)
        assert _arcs(a) == _arcs(ja)
    top = tvf.linear_fst([1, 100, 3, 101])
    subs = {100: tvf.linear_fst([2, 101]), 101: tvf.linear_fst([5])}
    out = talg.replace_fst(top, subs)
    jout = jalg.replace_fst(_to_jax(top), {k: _to_jax(v) for k, v in subs.items()})
    assert _arcs(out) == _arcs(jout)
    assert [o for o in talg.shortest_path(out)[2] if o] == [1, 2, 5, 3, 5]
    with pytest.raises(Exception, match="recursive"):
        talg.replace_fst(top, {100: tvf.linear_fst([100])})


def test_fst_to_csr_equals_the_jax_export_and_the_native_one(s):
    import old_kaldi_git_tpu.decoder.csr as jcsr
    from old_kaldi_git_tpu_torch.decoder.csr import fst_to_csr
    from old_kaldi_git_tpu_torch.decoder.graph import read_hclg_csr
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel

    t2p = AmGmmModel.load(s["tri"], device="cpu").tm.tid_to_pdf_array()
    fst = _read(s["hclg"])
    t = fst_to_csr(fst, t2p)
    j = jcsr.fst_to_csr(_to_jax(fst), t2p)
    n = read_hclg_csr(s["hclg"], t2p)
    assert t.start == j.start == n.start and t.num_states > 1000
    for f in CSR_FIELDS:
        a = getattr(t, f)
        assert a.dtype == np.asarray(getattr(j, f)).dtype, f
        assert np.array_equal(a, getattr(j, f)) and np.array_equal(a, getattr(n, f)), f
    for i in range(t.num_arcs):
        assert t.arc_olabels[i] == tuple(j.arc_olabels[i]) == n.arc_olabels[i]
    for i in range(t.num_states):
        assert t.final_olabels[i] == tuple(j.final_olabels[i]) == n.final_olabels[i]


def test_const_arpa_files_are_byte_equal_and_read_both_ways(s, tmp_path):
    import old_kaldi_git_tpu.lm.arpa as jarpa
    import old_kaldi_git_tpu_torch.lm.arpa as tarpa
    from old_kaldi_git_tpu_torch.lm.ngram import estimate_ngram_lm, write_arpa

    sents = [ws for ws in s["text"].values()]
    write_arpa(estimate_ngram_lm(sents, order=3), f"{tmp_path}/g3.arpa")
    for name in ("g3.arpa", None):
        path = f"{tmp_path}/{name}" if name else s["p"]("G.arpa")
        with open(path) as f:
            text = f.read()
        tarpa.write_const_arpa(tarpa.parse_arpa(text), f"{tmp_path}/t.carpa")
        jarpa.write_const_arpa(jarpa.parse_arpa(text), f"{tmp_path}/j.carpa")
        with open(f"{tmp_path}/t.carpa", "rb") as a, open(f"{tmp_path}/j.carpa", "rb") as b:
            assert a.read() == b.read()
        by_jax = jarpa.load_lm(f"{tmp_path}/t.carpa")
        by_port = tarpa.load_lm(f"{tmp_path}/j.carpa")
        assert by_jax.order == by_port.order and by_jax.ngrams == by_port.ngrams
        assert by_port.ngrams == tarpa.parse_arpa(text).ngrams


def test_accumulator_files_are_byte_equal_and_read_both_ways(s):
    """Both packages' accumulators of mono.mdl over two utterances' frames,
    the port's carried into the JAX object (its float order differs): the
    files are equal byte for byte and each package reads the other's."""
    import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
    import old_kaldi_git_tpu.gmm.mle as jmle
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.gmm.mle import AccumAmDiagGmm, read_accs, write_accs

    model = AmGmmModel.load(s["mono"], device="cpu")
    x = np.concatenate([s["feats"][k] for k in sorted(s["feats"])[:2]])
    pdfs = np.random.default_rng(0).integers(0, model.am.num_pdfs, len(x))
    w = np.random.default_rng(1).uniform(0.1, 1.0, len(x))
    accs = AccumAmDiagGmm(model.am)
    accs.accumulate_corpus(model.am, torch.from_numpy(x), torch.from_numpy(pdfs),
                           weights=torch.from_numpy(w))
    trans = np.random.default_rng(2).uniform(0, 5, model.tm.num_tids + 1)
    jaccs = jmle.AccumAmDiagGmm(jgmm.AmGmmModel.load(s["mono"]).am)
    for f in ("occ", "mean_acc", "var_acc"):
        setattr(jaccs, f, getattr(accs, f).numpy().copy())
    jaccs.tot_like, jaccs.tot_frames = accs.tot_like, accs.tot_frames
    tb, jb = io.BytesIO(), io.BytesIO()
    write_accs(tb, accs, trans)
    jmle.write_accs(jb, jaccs, trans)
    assert tb.getvalue() == jb.getvalue() and len(tb.getvalue()) > 100000
    back, tstats = read_accs(io.BufferedReader(io.BytesIO(jb.getvalue())), device="cpu")
    jback, jstats = jmle.read_accs(io.BufferedReader(io.BytesIO(tb.getvalue())))
    assert np.array_equal(tstats, trans) and np.array_equal(jstats, trans)
    for f in ("occ", "mean_acc", "var_acc"):
        assert getattr(back, f).dtype == torch.float64
        assert np.array_equal(getattr(back, f).numpy(), getattr(accs, f).numpy())
        assert np.array_equal(getattr(jback, f), getattr(accs, f).numpy())
    assert (back.tot_like, back.tot_frames) == (accs.tot_like, accs.tot_frames)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            read_accs(io.BufferedReader(io.BytesIO(tb.getvalue())))
