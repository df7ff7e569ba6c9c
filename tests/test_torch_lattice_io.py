"""Lattice and posterior archives, and hmm/posterior.py, in the port
against the JAX package on the CPU.

Lattice and compact-lattice tables ("lat", "clat") and posterior tables
("post", "gpost"), written by each package in text and in binary: the same
bytes, and each reads the other's back equal (the text forms hold 6
significant digits, so a text round trip is held to those).  `ark,scp:`
through the script and random access.  get_holder resolves the four names
without an import.  The posterior functions equal the JAX package's;
post_to_gpost on the model's device (the CPU here) within 1e-6 of the
float32 it returns.  Lattices: the yes/no toy's (tests/torch_lattice_toy.py)."""

import tests.torch_threads  # noqa: F401
import numpy as np
import pytest

import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
import old_kaldi_git_tpu.hmm.posterior as jpost
import old_kaldi_git_tpu.lat.holder  # noqa: F401  registers the JAX package's holders
import old_kaldi_git_tpu.utils.table as jtable
import old_kaldi_git_tpu_torch.hmm.posterior as tpost
import old_kaldi_git_tpu_torch.lat.determinize as tdet
import old_kaldi_git_tpu_torch.lat.holder as tholder
import old_kaldi_git_tpu_torch.lat.lattice as tlat
import old_kaldi_git_tpu_torch.utils.table as ttable
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, DiagGmm
from tests.torch_lattice_toy import clat_to_jax, clat_tuple, to_jax, yesno_lattices


@pytest.fixture(scope="module")
def toy():
    toy = yesno_lattices()
    toy.clats = [tdet.determinize_lattice_pruned(x, 10.0, acoustic_scale=0.1) for x in toy.port]
    return toy


def _write(mod, spec, holder, values):
    with mod.TableWriter(spec, holder) as w:
        for k, v in values.items():
            w[k] = v


def _text_rounded(value):
    """What a text archive keeps of a lattice's weights: 6 significant
    digits (the holders' %.6g)."""
    r = lambda x: float(f"{x:.6g}")  # noqa: E731
    if isinstance(value, tdet.CompactLattice):
        out = tdet.CompactLattice()
        for _ in range(value.num_states):
            out.add_state()
        out.start = value.start
        out.finals = [(r(g), r(a), s) if g != np.inf else (g, a, s) for g, a, s in value.finals]
        out.arcs = [[tdet.CompactLatticeArc(x.word, r(x.graph_cost), r(x.acoustic_cost),
                                            tuple(x.tids), x.nextstate) for x in lst]
                    for lst in value.arcs]
        return clat_tuple(out)
    return (value.start, [(r(g), r(a)) if g != np.inf else (g, a) for g, a in value.finals],
            [[(x.ilabel, x.olabel, r(x.graph_cost), r(x.acoustic_cost), x.nextstate)
              for x in lst] for lst in value.arcs])


def _read_tuple(value, holder):
    """A lattice read back from a table (which keeps no state times)."""
    if holder == "clat":
        return clat_tuple(value)
    return (value.start, list(value.finals),
            [[(x.ilabel, x.olabel, x.graph_cost, x.acoustic_cost, x.nextstate) for x in lst]
             for lst in value.arcs])


@pytest.mark.parametrize("holder,text", [("lat", False), ("lat", True), ("clat", False),
                                         ("clat", True)])
def test_lattice_archives_cross_read_with_the_same_bytes(toy, holder, text, tmp_path):
    tvals = {f"utt{i}": v for i, v in enumerate(toy.port if holder == "lat" else toy.clats)}
    jvals = {k: (to_jax(v) if holder == "lat" else clat_to_jax(v)) for k, v in tvals.items()}
    opt = ",t" if text else ""
    _write(ttable, f"ark{opt}:{tmp_path}/t.ark", holder, tvals)
    _write(jtable, f"ark{opt}:{tmp_path}/j.ark", holder, jvals)
    tb, jb = (open(tmp_path / f, "rb").read() for f in ("t.ark", "j.ark"))
    assert tb == jb and len(tb) > 1000
    t_back = ttable.read_table(f"ark:{tmp_path}/j.ark", holder)
    j_back = jtable.read_table(f"ark:{tmp_path}/t.ark", holder)
    assert list(t_back) == list(j_back) == list(tvals)
    for k, v in tvals.items():
        assert _read_tuple(t_back[k], holder) == _read_tuple(j_back[k], holder)
        assert isinstance(t_back[k], tdet.CompactLattice if holder == "clat" else tlat.Lattice)
        assert _text_rounded(t_back[k]) == _text_rounded(v)


def test_compact_lattice_table_through_its_script(toy, tmp_path):
    vals = {f"utt{i}": v for i, v in enumerate(toy.clats)}
    _write(ttable, f"ark,scp:{tmp_path}/c.ark,{tmp_path}/c.scp", "clat", vals)
    by_scp = ttable.read_table(f"scp:{tmp_path}/c.scp", "clat")
    ra = ttable.RandomAccessTableReader(f"scp:{tmp_path}/c.scp", "clat")
    j_scp = jtable.read_table(f"scp:{tmp_path}/c.scp", "clat")
    for k, v in vals.items():
        assert clat_tuple(by_scp[k]) == clat_tuple(ra[k]) == clat_tuple(j_scp[k])
        # binary keeps the weights' %.6g text inside its frame
        assert _text_rounded(by_scp[k]) == _text_rounded(v)
        assert by_scp[k].best_path(1.0, 0.1)[:2] == v.best_path(1.0, 0.1)[:2]


def test_get_holder_resolves_the_registered_names():
    for name, cls in (("lat", tholder.LatticeHolder), ("clat", tholder.CompactLatticeHolder),
                      ("post", tpost.PosteriorHolder), ("gpost", tpost.GaussPostHolder)):
        assert type(ttable.get_holder(name)) is cls and cls.name == name
    ttable.register_holder("post-again", tpost.PosteriorHolder)
    assert isinstance(ttable.get_holder("post-again"), tpost.PosteriorHolder)
    with pytest.raises(ttable.KaldiError):
        ttable.get_holder("no-such-holder")


def _posteriors(seed=0):
    rng = np.random.default_rng(seed)
    return {f"u{i}": [[(int(t), float(np.float32(w))) for t, w in zip(
        rng.integers(1, 40, n), rng.random(n))] for n in rng.integers(0, 4, 12 + i)]
        for i in range(3)}


@pytest.mark.parametrize("text", [False, True])
def test_posterior_archives_cross_read_with_the_same_bytes(text, tmp_path):
    vals = _posteriors()
    opt = ",t" if text else ""
    _write(ttable, f"ark{opt}:{tmp_path}/t.ark", "post", vals)
    _write(jtable, f"ark{opt}:{tmp_path}/j.ark", "post", vals)
    assert open(tmp_path / "t.ark", "rb").read() == open(tmp_path / "j.ark", "rb").read()
    t_back = ttable.read_table(f"ark:{tmp_path}/j.ark", "post")
    assert t_back == jtable.read_table(f"ark:{tmp_path}/t.ark", "post")
    if not text:
        assert t_back == vals
    else:
        assert all(np.allclose([w for f in t_back[k] for _, w in f],
                               [w for f in v for _, w in f], rtol=1e-5) for k, v in vals.items())


def test_posterior_functions(toy):
    ttm, jtm = toy.ttm, toy.jtm
    ali = [int(t) for t in tlat.lattice_best_path(toy.port[2], 1.0, 1.0)[1]]  # SIL first
    got, want = tpost.ali_to_post(ali), jpost.ali_to_post(ali)
    assert got == want
    post = tlat.lattice_to_post(toy.port[3], ttm, 1.0, 0.1)
    for a, b in ((tpost.scale_post(got, 0.5), jpost.scale_post(want, 0.5)),
                 (tpost.weight_silence_post(got, ttm, [toy.tlang.silence_id], 0.0),
                  jpost.weight_silence_post(want, jtm, [toy.jlang.silence_id], 0.0)),
                 (tpost.weight_silence_post(got, ttm, [toy.tlang.silence_id], 0.25),
                  jpost.weight_silence_post(want, jtm, [toy.jlang.silence_id], 0.25)),
                 (tpost.post_to_pdf_post(got, ttm), jpost.post_to_pdf_post(want, jtm))):
        assert a == b
    assert tpost.post_to_weights(post) == jpost.post_to_weights(post)
    for x, y in zip(tpost.posterior_entries_to_arrays(post),
                    jpost.posterior_entries_to_arrays(post)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert any(len(f) == 0 for f in tpost.weight_silence_post(got, ttm, [toy.tlang.silence_id],
                                                              0.0))


def test_gauss_posteriors_and_their_table(toy, tmp_path):
    rng = np.random.default_rng(4)
    P, D = toy.ttm.num_pdfs, 6
    mix = [int(m) for m in rng.integers(1, 5, P)]
    params = [(rng.random(m) + 0.1, rng.normal(size=(m, D)), 0.5 + rng.random((m, D)))
              for m in mix]
    params = [(w / w.sum(), mu, v) for w, mu, v in params]
    tam = AmDiagGmm([DiagGmm(*p) for p in params], device="cpu")
    jam = jgmm.AmDiagGmm([jgmm.DiagGmm(*p) for p in params])
    ali = [int(t) for t in tlat.lattice_best_path(toy.port[2], 1.0, 1.0)[1]]
    post = tpost.scale_post(tpost.ali_to_post(ali), 0.7)
    post = [f + [(f[0][0], 0.3)] if i % 3 == 0 else f for i, f in enumerate(post)]  # merged
    feats = rng.normal(size=(len(post), D)).astype(np.float32)
    got = tpost.post_to_gpost(post, toy.ttm, tam, feats)
    want = jpost.post_to_gpost(post, toy.jtm, jam, feats)
    assert [[p for p, _ in f] for f in got] == [[p for p, _ in f] for f in want]
    for f, g in zip(got, want):
        for (_, a), (_, b) in zip(f, g):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    _write(ttable, f"ark:{tmp_path}/t.ark", "gpost", {"u": got})
    _write(jtable, f"ark:{tmp_path}/j.ark", "gpost", {"u": got})
    assert open(tmp_path / "t.ark", "rb").read() == open(tmp_path / "j.ark", "rb").read()
    back = ttable.read_table(f"ark:{tmp_path}/j.ark", "gpost")["u"]
    assert [[p for p, _ in f] for f in back] == [[p for p, _ in f] for f in got]
    assert all(np.array_equal(a, b) for f, g in zip(back, got) for (_, a), (_, b) in zip(f, g))
