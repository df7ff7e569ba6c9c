"""decode_biglm, score_lattices_sweep and decode_dataset_with_lattices'
determinized lattices in the port against the JAX package on the CPU.

yesno: a monophone model the port trains (tests/test_torch_mmi.py's
yesno_system), read by both packages from one .mdl, on the JAX package's
graph of its transition model (the port's copy of the same arrays),
decoded at acoustic scale 1.0 (ROADMAP queue 3's parity rule).
decode_biglm gives the JAX package's words with a bigram over a flat
unigram and with the identity (old = new), which reproduces the lattice
best paths; score_lattices_sweep gives its best scale, WER and words; the
determinized lattices (native in both packages) keep the JAX package's
topology and tid strings, weights within 1e-4 (the GMMs' float32 loglikes
differ by float order).  `-m slow`: 12 utterances of exp/minilib with
tri.mdl on hclg.npz, the JAX package fed the loglikes pre-scaled by
float32(0.1) at scale 1.0."""

import tests.torch_threads  # noqa: F401
import math
import os

import numpy as np
import pytest

import old_kaldi_git_tpu.decoder.csr as jcsr
import old_kaldi_git_tpu.decoder.graph as jgraph
import old_kaldi_git_tpu.fst.lang as jlang
import old_kaldi_git_tpu.lat.mbr as jmbr
import old_kaldi_git_tpu.lm.arpa as jarpa
import old_kaldi_git_tpu.recipes.decode as jdecode
import old_kaldi_git_tpu.tree.context_dep as jcd
import old_kaldi_git_tpu_torch.lat.determinize as tdet
import old_kaldi_git_tpu_torch.lat.lattice as tlat
import old_kaldi_git_tpu_torch.lat.mbr as tmbr
import old_kaldi_git_tpu_torch.lm.arpa as tarpa
from old_kaldi_git_tpu_torch.recipes import decode as tdecode
from old_kaldi_git_tpu_torch.recipes import yesno
from tests.test_torch_chain import port_graph
from tests.test_torch_mmi import both_models, yesno_system
from tests.torch_lattice_toy import clat_to_jax, clat_tuple, to_jax

OPTS = dict(beam=20.0, acoustic_scale=1.0)
FLAT = """
\\data\\
ngram 1=4
\\1-grams:
-0.5 yes
-0.5 no
-0.5 </s>
-99 <s>
\\end\\
"""


def bigram_arpa(texts):
    counts, tot = {}, {}
    for words in texts:
        seq = ["<s>"] + list(words) + ["</s>"]
        for a, b in zip(seq, seq[1:]):
            counts[(a, b)] = counts.get((a, b), 0) + 1
            tot[a] = tot.get(a, 0) + 1
    lines = ["\\data\\", "ngram 1=4", f"ngram 2={len(counts)}", "\\1-grams:",
             "-0.5 yes -0.3", "-0.5 no -0.3", "-0.5 </s>", "-99 <s> -0.3", "\\2-grams:"]
    lines += [f"{math.log10(c / tot[a]):.4f} {a} {b}" for (a, b), c in sorted(counts.items())]
    return "\n".join(lines + ["\\end\\"])


@pytest.fixture(scope="module")
def yes():
    s = yesno_system(12, 6, 6, 40)
    tmodel, jmodel = both_models(s["model"])
    lang = jlang.Lang(jlang.Lexicon.from_dict({w: " ".join(p) for w, p in
                                                yesno.WORD_PRONS.items()}),
                      silence_phone="SIL", sil_prob=0.5)
    phones = lang.real_phone_ids
    topo = jmodel.tm.topo
    cd = jcd.monophone_context_dependency(phones, {p: topo.num_pdf_classes(p) for p in phones})
    g = jlang.make_unigram_grammar_fst(list(s["st"].values()) + [["yes"], ["no"]], lang.words)
    jg = jcsr.fst_to_csr(jgraph.mkgraph(lang, g, cd, jmodel.tm), jmodel.tm.tid_to_pdf_array())
    s.update(tmodel=tmodel, jmodel=jmodel, jlang=lang, jg=jg, tg=port_graph(jg),
             bigram=bigram_arpa(s["st"].values()))
    return s


def test_decode_biglm_equals_the_jax_package(yes):
    old = (jarpa.parse_arpa(FLAT), tarpa.parse_arpa(FLAT))
    new = (jarpa.parse_arpa(yes["bigram"]), tarpa.parse_arpa(yes["bigram"]))
    words = [yes["jlang"].words[i] for i in range(len(yes["jlang"].words.symbols()))]
    timings, decoded = {}, {}
    clats = tdecode.decode_dataset_with_lattices(
        yes["tmodel"], yes["tg"], words, yes["sf"], tdecode.DecodeOptions(**OPTS),
        determinize=True, timings=timings, decoder_words=decoded)
    assert {"lattice_seconds", "determinize_seconds"} <= set(timings) and len(clats) == 6
    for k, clat in clats.items():
        assert clat.best_path(1.0, 1.0)[0] == decoded[k]  # the lattice holds the 1-best
    for o, n in ((old, new), (old, old)):
        want = jdecode.decode_biglm(yes["jmodel"], yes["jg"], yes["jlang"], yes["sf"], o[0],
                                    n[0], jdecode.DecodeOptions(**OPTS))
        got = tdecode.decode_biglm(yes["tmodel"], yes["tg"], words, yes["sf"], o[1], n[1],
                                   tdecode.DecodeOptions(**OPTS))
        assert got == want and len(got) == 6
        # the decode's lattices handed in give the same words
        assert tdecode.decode_biglm(yes["tmodel"], yes["tg"], words, yes["sf"], o[1], n[1],
                                    tdecode.DecodeOptions(**OPTS), lattices=clats) == got
    assert got == {k: [words[w] for w in decoded[k]] for k in clats}  # identity: the 1-best
    base = tdecode.score_hyps(yes["st"], got)
    resc = tdecode.score_hyps(yes["st"], tdecode.decode_biglm(
        yes["tmodel"], yes["tg"], words, yes["sf"], old[1], new[1],
        tdecode.DecodeOptions(**OPTS), lattices=clats))
    assert resc.wer <= base.wer + 1e-9


def test_score_lattices_sweep_equals_the_jax_package(yes):
    words = [yes["jlang"].words[i] for i in range(len(yes["jlang"].words.symbols()))]
    tl = tdecode.decode_dataset_with_lattices(yes["tmodel"], yes["tg"], words, yes["sf"],
                                              tdecode.DecodeOptions(**OPTS))
    jl = jdecode.decode_dataset_with_lattices(yes["jmodel"], yes["jg"], yes["jlang"],
                                              yes["sf"], jdecode.DecodeOptions(**OPTS))
    assert sorted(tl) == sorted(jl)
    scales = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0)
    report = {}
    got = tdecode.score_lattices_sweep(tl, words, yes["st"], 1.0, scales, report=report)
    want = jdecode.score_lattices_sweep(jl, yes["jlang"], yes["st"], 1.0, scales)
    assert got[0] == want[0] and got[1].wer == want[1].wer and got[1].errors == want[1].errors
    assert sorted(report) == list(scales) and report[got[0]] == min(report.values())
    for s in scales:
        w1 = jdecode.score_lattices_sweep(jl, yes["jlang"], yes["st"], 1.0, (s,))[1].wer
        assert report[s] == w1


def test_determinized_decode_lattices_against_the_jax_packages(yes):
    words = [yes["jlang"].words[i] for i in range(len(yes["jlang"].words.symbols()))]
    got = tdecode.decode_dataset_with_lattices(yes["tmodel"], yes["tg"], words, yes["sf"],
                                               tdecode.DecodeOptions(**OPTS), determinize=True)
    want = jdecode.decode_dataset_with_lattices(yes["jmodel"], yes["jg"], yes["jlang"],
                                                yes["sf"], jdecode.DecodeOptions(**OPTS),
                                                determinize=True)
    for k in want:
        g, w = got[k], want[k]
        assert g.num_states == w.num_states and g.start == w.start
        assert [[(a.word, tuple(a.tids), a.nextstate) for a in x] for x in g.arcs] == [
            [(a.word, tuple(a.tids), a.nextstate) for a in x] for x in w.arcs]
        np.testing.assert_allclose([(a.graph_cost, a.acoustic_cost) for x in g.arcs for a in x],
                                   [(a.graph_cost, a.acoustic_cost) for x in w.arcs for a in x],
                                   rtol=1e-5, atol=1e-4)
        res = tmbr.minimum_bayes_risk(g, 1.0, 1.0)
        assert res.words == jmbr.minimum_bayes_risk(w, 1.0, 1.0).words


# ---------------------------------------------------------------------------
# slow: exp/minilib
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")


@pytest.mark.slow
def test_minilib_lattice_outputs_on_twelve_noisy_utterances():
    """tri.mdl on hclg.npz, the first 12 held-out utterances at noise 400 (the
    chip's lattice_outputs phase at a smaller size): native = Python
    determinization on all 12, each lattice's best path = the decoder's
    words, the sweep, MBR, the CTM and the big-LM rescoring equal to the
    JAX package's on its lattices of the same loglikes.  Two of the 12
    searches end off the graph's final states, inside a word: the lexicon
    walk of lattice_to_ctm_conf refuses their best paths in both packages."""
    import gzip

    import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
    import old_kaldi_git_tpu.lat.ctm as jctm
    import old_kaldi_git_tpu.recipes.minilib as jminilib
    import old_kaldi_git_tpu_torch.lat.ctm as tctm
    from old_kaldi_git_tpu_torch import convert
    from old_kaldi_git_tpu_torch.recipes import minilib

    system = minilib.load_system(WORKDIR, device="cpu")
    waves, text = minilib.make_test_set(minilib.MinilibOptions(), noise=minilib.NOISE_EVAL)
    keys = sorted(waves)[:12]
    feats = minilib.compute_feats({k: waves[k] for k in keys}, device="cpu")
    ref = {k: text[k] for k in keys}
    tmodel = convert.load_am_gmm_model(os.path.join(WORKDIR, "tri.mdl"), device="cpu")
    decoded, timings = {}, {}
    raw = tdecode.decode_dataset_with_lattices(tmodel, system.csr, system.words, feats,
                                               decoder_words=decoded, timings=timings)
    assert sorted(raw) == keys
    for k, lat in raw.items():
        assert tlat.lattice_best_path(lat, 1.0, 0.1)[0] == decoded[k]
        native = tdet.determinize_lattice_pruned(lat, 10.0, acoustic_scale=0.1)
        python = tdet.determinize_lattice_pruned(lat, 10.0, acoustic_scale=0.1,
                                                 algorithm="python")
        assert clat_tuple(native) == clat_tuple(python)
        res = tmbr.minimum_bayes_risk(native, 1.0, 0.1)
        assert res.words == jmbr.minimum_bayes_risk(clat_to_jax(native), 1.0, 0.1).words
    # the JAX package on the same graph and model, loglikes pre-scaled
    jmodel = jgmm.AmGmmModel.load(os.path.join(WORKDIR, "tri.mdl"))
    scaled = jmodel.am.loglikes_batch
    jmodel.am.loglikes_batch = lambda x: np.asarray(scaled(x)) * np.float32(0.1)
    jsys = jminilib.load_system(WORKDIR, build_missing=False)
    jraw = jdecode.decode_dataset_with_lattices(jmodel, jsys.csr, jsys.lang, feats,
                                                jdecode.DecodeOptions(acoustic_scale=1.0))
    lang, refused = minilib.make_lang(), []
    for k in keys:
        try:
            got = [e.line() for e in tctm.lattice_to_ctm_conf(raw[k], tmodel.tm, lang, k)]
        except tctm.KaldiError:
            refused.append(k)
            with pytest.raises(jctm.KaldiError):
                jctm.lattice_to_ctm_conf(to_jax(raw[k]), jmodel.tm, jsys.lang, k)
            continue
        assert got == [e.line() for e in jctm.lattice_to_ctm_conf(to_jax(raw[k]), jmodel.tm,
                                                                 jsys.lang, k)]
    assert refused == ["test_0008", "test_0010"]
    got = tdecode.score_lattices_sweep(raw, system.words, ref, 0.1)
    jl = {k: _rescaled(v) for k, v in jraw.items()}
    want = jdecode.score_lattices_sweep(jl, jsys.lang, ref, 0.1)
    assert got[0] == want[0] and got[1].errors == want[1].errors
    with gzip.open(os.path.join(WORKDIR, "arpa.txt.gz"), "rt") as f:
        pruned = tarpa.parse_arpa(f.read())
    clats = {k: tdet.determinize_lattice_pruned(v, 10.0, acoustic_scale=0.1)
             for k, v in raw.items()}
    same = tdecode.decode_biglm(tmodel, system.csr, system.words, feats, pruned, pruned,
                                lattices=clats)
    assert same == {k: [system.words[w] for w in decoded[k]] for k in keys}


def _rescaled(lat):
    """A JAX lattice of pre-scaled loglikes with the acoustic costs ÷ 0.1,
    as the port's lattice of the unscaled ones holds them."""
    for lst in lat.arcs:
        for a in lst:
            a.acoustic_cost /= np.float32(0.1)
    return lat
