"""The port's graph plane against the JAX package's, on the CPU.

The lang bundle (L and L_disambig arc for arc, symbol tables, disambiguation
ids) for the yes/no toy lexicon and the 20k-word minilib lexicon; the
topology and the transition model built from a tree; the committed tree
read from `tree.pkl` (ContextDependency.compute on every context window the
training graphs use); the training graphs of the 8 shortest training
utterances for `tri.mdl` and `mono.mdl`, and `mkgraph_csr` on the yes/no
toy, as CSR arrays, exactly; the native library's build (from the
checkout's source into build/, never the committed cpp/libokt_wfst.so)."""

import tests.torch_threads  # noqa: F401
import os
import pickle

import numpy as np
import pytest

import old_kaldi_git_tpu.decoder.graph as jgraph
import old_kaldi_git_tpu.fst.lang as jlang
import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
import old_kaldi_git_tpu.hmm.topology as jtopo
import old_kaldi_git_tpu.hmm.transition_model as jtm
import old_kaldi_git_tpu.tree.context_dep as jcd
import old_kaldi_git_tpu_torch.decoder.graph as tgraph
import old_kaldi_git_tpu_torch.fst.lang as tlang
import old_kaldi_git_tpu_torch.fst.native as tnative
import old_kaldi_git_tpu_torch.hmm.topology as ttopo
import old_kaldi_git_tpu_torch.hmm.transition_model as ttm
import old_kaldi_git_tpu_torch.tree.context_dep as tcd
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.fst.native import NativeFst
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.recipes import minilib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")
TOY_LEXICON = {"yes": "Y EH S", "no": "N OW"}
CSR_FIELDS = ("row_ptr", "tid", "pdf", "weight", "nextstate", "final_weight")


@pytest.fixture(scope="module")
def langs():
    """(JAX Lang, port Lang) of the 20k-word minilib lexicon."""
    lex = minilib.make_lexicon(minilib.MinilibOptions())
    return (jlang.Lang(jlang.Lexicon.from_dict(lex), silence_phone="SIL", sil_prob=0.5),
            minilib.make_lang())


@pytest.fixture(scope="module")
def shortest_transcripts():
    """The transcripts of the 8 shortest training utterances."""
    waves, text = minilib.training_set(minilib.MinilibOptions())
    keys = sorted(waves, key=lambda k: (len(waves[k]), k))[:8]
    return [text[k] for k in keys]


def _arcs(fst):
    return ([[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in lst] for lst in fst.arcs],
            fst.finals, fst.start)


def _assert_csr_equal(j, t):
    assert j.start == t.start
    for f in CSR_FIELDS:
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("arc_olabels", "final_olabels"):
        a, b = getattr(j, f), getattr(t, f)
        assert np.array_equal(a.offsets, b.offsets) and np.array_equal(a.values, b.values), f


def _assert_lang_equal(j, t):
    for name in ("L", "L_disambig"):
        assert _arcs(getattr(j, name)) == _arcs(getattr(t, name)), name
    assert j.phones.symbols() == t.phones.symbols()
    assert j.words.symbols() == t.words.symbols()
    assert j.disambig_phone_ids == t.disambig_phone_ids
    assert j.real_phone_ids == t.real_phone_ids
    assert (j.silence_id, j.word_disambig_id, j.num_disambig) == (
        t.silence_id, t.word_disambig_id, t.num_disambig)


def test_toy_lang_equals_the_jax_package():
    j = jlang.Lang(jlang.Lexicon.from_dict(TOY_LEXICON), silence_phone="SIL", sil_prob=0.5)
    t = tlang.Lang(tlang.Lexicon.from_dict(TOY_LEXICON), silence_phone="SIL", sil_prob=0.5)
    _assert_lang_equal(j, t)
    g = [["yes"], ["no", "yes"], ["no"]]
    assert _arcs(jlang.make_unigram_grammar_fst(g, j.words)) == _arcs(
        tlang.make_unigram_grammar_fst(g, t.words))
    # homophones and prefixes get their disambiguation symbols in order
    lex = {"a": "X Y", "b": "X Y", "c": "X", "d": ["X Y Z", "Z"]}
    j = jlang.Lang(jlang.Lexicon.from_dict(lex))
    t = tlang.Lang(tlang.Lexicon.from_dict(lex))
    assert jlang.add_lex_disambig(j.lexicon) == tlang.add_lex_disambig(t.lexicon)
    assert t.num_disambig == 3
    _assert_lang_equal(j, t)


def test_minilib_lang_equals_the_jax_package(langs):
    j, t = langs
    _assert_lang_equal(j, t)
    assert t.L_disambig.num_arcs > 140_000
    assert t.silence_id == minilib.silence_phone_id(
        minilib.make_lexicon(minilib.MinilibOptions()))


def _toy(pkg_lang, pkg_topo, pkg_cd):
    lang = pkg_lang.Lang(pkg_lang.Lexicon.from_dict(TOY_LEXICON), silence_phone="SIL",
                         sil_prob=0.5)
    phones = lang.real_phone_ids
    topo = pkg_topo.HmmTopology.standard(phones, silence_phones=[lang.silence_id])
    cd = pkg_cd.monophone_context_dependency(
        phones, {p: topo.num_pdf_classes(p) for p in phones})
    return lang, topo, cd


def test_topology_and_transition_model_from_a_tree_equal_the_jax_package():
    jl, jt, jc = _toy(jlang, jtopo, jcd)
    tl, tt, tc = _toy(tlang, ttopo, tcd)
    for p in jt.phones:
        assert [(s.pdf_class, s.transitions) for s in jt.topology_for_phone(p)] == [
            (s.pdf_class, s.transitions) for s in tt.topology_for_phone(p)]
        assert jt.num_pdf_classes(p) == tt.num_pdf_classes(p)
    jm = jtm.TransitionModel(jc, jt)
    tm = ttm.TransitionModel.from_context_dependency(tc, tt)
    assert jm.tuples == tm.tuples and list(jm.state2id) == tm.state2id
    assert np.array_equal(jm.log_probs, tm.log_probs)
    assert np.array_equal(jm._id2state, tm.id2state)
    assert np.array_equal(jm.tid_to_pdf_array(), tm.tid_to_pdf_array())
    assert np.array_equal(jm.tid_to_phone_array(), tm.tid_to_phone_array())
    for ts in range(len(tm.tuples)):
        assert jm.self_loop_tid(ts) == tm.self_loop_tid(ts)
        assert jm.self_loop_prob(ts) == tm.self_loop_prob(ts)
        assert jm.tuple_to_tstate(*jm.tuples[ts]) == tm.tuple_to_tstate(*tm.tuples[ts]) == ts


def test_mono_tree_over_the_lang_gives_mono_mdls_transition_model(langs):
    """The monophone tree the alignment entry point builds for mono.mdl
    numbers its pdfs as mono.mdl does."""
    _, lang = langs
    gmm = AmGmmModel.load(os.path.join(WORKDIR, "mono.mdl"), device="cpu")
    topo = gmm.tm.topo
    cd = tcd.monophone_context_dependency(
        lang.real_phone_ids, {p: topo.num_pdf_classes(p) for p in lang.real_phone_ids})
    tm = ttm.TransitionModel.from_context_dependency(cd, topo)
    assert tm.tuples == gmm.tm.tuples and tm.state2id == gmm.tm.state2id
    assert cd.num_pdfs == gmm.am.num_pdfs


def test_mkgraph_csr_on_the_yes_no_toy_equals_the_jax_package():
    jl, jt, jc = _toy(jlang, jtopo, jcd)
    tl, tt, tc = _toy(tlang, ttopo, tcd)
    jm, tm = jtm.TransitionModel(jc, jt), ttm.TransitionModel.from_context_dependency(tc, tt)
    sents = [["yes"], ["no"], ["yes", "no"]]
    j = jgraph.mkgraph_csr(jl, jlang.make_unigram_grammar_fst(sents, jl.words), jc, jm)
    t = tgraph.mkgraph_csr(tl, tlang.make_unigram_grammar_fst(sents, tl.words), tc, tm)
    assert t.num_states > 10 and any(len(o) for o in t.arc_olabels)
    _assert_csr_equal(j, t)


def _systems(model, langs):
    """(JAX GraphCompiler, port GraphCompiler) for tri.mdl or mono.mdl."""
    jl, tl = langs
    jm = jgmm.AmGmmModel.load(os.path.join(WORKDIR, f"{model}.mdl"))
    tm = AmGmmModel.load(os.path.join(WORKDIR, f"{model}.mdl"), device="cpu")
    if model == "tri":
        with open(os.path.join(WORKDIR, "tree.pkl"), "rb") as f:
            jc = pickle.load(f)[0]
        tc = convert.context_dependency_from_pickle(
            convert.load_pickle(os.path.join(WORKDIR, "tree.pkl"))[0])
    else:
        phones = jl.real_phone_ids
        jc = jcd.monophone_context_dependency(
            phones, {p: jm.tm.topo.num_pdf_classes(p) for p in phones})
        tc = tcd.monophone_context_dependency(
            phones, {p: tm.tm.topo.num_pdf_classes(p) for p in phones})
    return jgraph.GraphCompiler(jl, jc, jm.tm), tgraph.GraphCompiler(tl, tc, tm.tm)


@pytest.mark.parametrize("model", ["tri", "mono"])
def test_training_graphs_equal_the_jax_package(model, langs, shortest_transcripts):
    jgc, tgc = _systems(model, langs)
    tgraphs = tgc.compile_csr_graphs(shortest_transcripts)
    for words, t in zip(shortest_transcripts, tgraphs):
        _assert_csr_equal(jgc.compile_csr_from_text(words), t)
    assert max(g.num_states for g in tgraphs) > 50
    # the same compiler again: the cached L handle gives the same graph
    _assert_csr_equal(tgraphs[0], tgc.compile_csr_from_text(shortest_transcripts[0]))


def test_committed_tree_computes_as_the_jax_package_on_the_graph_windows(
        langs, shortest_transcripts):
    """Every triphone window (and pdf class) that context composition gives
    the 8 training graphs, through the pickled tree read both ways."""
    _, tl = langs
    _, tgc = _systems("tri", langs)
    with open(os.path.join(WORKDIR, "tree.pkl"), "rb") as f:
        jc = pickle.load(f)[0]
    tc = tgc.ctx_dep
    windows = set()
    for words in shortest_transcripts:
        ids = np.asarray(tgc._word_ids(words), np.int32)
        n = len(ids) + 1
        g = NativeFst.from_arrays(0, np.minimum(np.arange(n + 1), n - 1), ids, ids,
                                  np.zeros(n - 1, np.float32), np.arange(1, n),
                                  np.r_[np.full(n - 1, np.inf), 0.0])
        lg = NativeFst.from_vector_fst(tl.L_disambig).compose(g)
        lg = lg.determinize_star(use_log=True).minimize_encoded()
        _, info = lg.compose_context(3, 1, tl.disambig_phone_ids, max(tl.phones.ids()) + 1)
        windows.update(tuple(w) for w in info if len(w) == 3)
    assert len(windows) > 50
    n = 0
    for w in sorted(windows):
        for pc in range(tgc.tm.topo.num_pdf_classes(w[1])):
            assert tc.compute(list(w), pc) == jc.compute(list(w), pc)
            n += 1
    assert n > 150
    assert tc.num_pdfs == jc.num_pdfs == 2000


def test_native_library_builds_from_the_checkout_into_build(tmp_path, monkeypatch):
    path = tnative.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "build")
    assert os.path.basename(path).startswith("libokt_wfst-")
    tnative._load()
    assert os.path.exists(path)
    assert os.path.realpath(os.path.join(REPO, "cpp", "libokt_wfst.so")) != os.path.realpath(path)
    # another source, another name; a source that does not compile raises
    bad = tmp_path / "wfst.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    assert tnative.library_path() != path
    with pytest.raises(tnative.KaldiError, match="failed"):
        tnative.build()
    assert not (tmp_path / "build").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "build").iterdir())
