"""GMM training recipes in the port against the JAX package's, on the CPU.

The yes/no corpus: the port's synthesis gives the JAX package's waves and
text bit for bit, and its front end (`compute_feats`, through the MFCC
kernel's plain version) the JAX package's features within 1e-3 +
1e-5·max|feature| (the front end's rule, tests/test_torch_feat.py).  Then
config 1 at the JAX test's reduced size (tests/test_decoder.py `test_yesno_e2e`: 20 / 8 utterances, 10
iterations, 60 Gaussians) through both packages in lockstep on the same
(JAX) features: the JAX package's alignment runs on loglikes pre-scaled by
np.float32(0.1) at acoustic scale 1.0 (its winner test's 1e-6 is below a
float32 ulp at these path costs, ROADMAP queue 3; the port at 0.1 equals
the port on pre-scaled loglikes bit for bit), and the two must give the
same tids at every alignment pass, the same Gaussian count at every
iteration, final means and variances within 1e-6 relative, and WER 0.00.

Slow: config 1 at its defaults, and minilib stages 3 and 4 (600 training
utterances; the tree of 2,000 leaves), through the port on the CPU; each
prints the per-iteration like/frame and Gaussian counts (and the tree's
leaf digests) that chip_smoke.py commits as the CPU's record."""

import tests.torch_threads  # noqa: F401
import importlib
import json
import os
import time

import numpy as np
import pytest

import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu.recipes.gmm_common as jgc
import old_kaldi_git_tpu.recipes.mono as jmono
import old_kaldi_git_tpu.recipes.yesno as jyes
import old_kaldi_git_tpu_torch.recipes.gmm_common as tgc
from old_kaldi_git_tpu.decoder.csr import fst_to_csr
from old_kaldi_git_tpu.decoder.graph import mkgraph
from old_kaldi_git_tpu.fst.lang import make_unigram_grammar_fst
from old_kaldi_git_tpu.recipes.decode import DecodeOptions, decode_dataset, score_hyps
from old_kaldi_git_tpu.tree.context_dep import monophone_context_dependency
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.recipes import minilib, yesno
from old_kaldi_git_tpu_torch.recipes.mono import MonoTrainOptions, train_mono
from old_kaldi_git_tpu_torch.tree import build_tree as tbt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")
SCALE = np.float32(0.1)
SMALL = dict(num_iters=10, totgauss=60, realign_iters=(1, 2, 3, 4, 5, 6, 8))


@pytest.fixture(scope="module")
def small_corpus():
    return jyes.make_corpus(20, 8), yesno.make_corpus(20, 8)


def test_the_yesno_corpus_is_the_jax_packages(small_corpus):
    for j, t in zip(*small_corpus):
        assert list(j) == list(t)
        for k in j:
            if isinstance(j[k], np.ndarray):
                assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k])
            else:
                assert t[k] == j[k]


@pytest.mark.parametrize("which", ["compute_feats", "compute_static_feats"])
def test_yesno_features_within_the_pr1_rule(small_corpus, which):
    waves = {**small_corpus[0][0], **small_corpus[0][2]}
    want = getattr(jyes, which)(waves)
    got = getattr(yesno, which)(waves, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        tol = 1e-3 + 1e-5 * float(np.abs(want[k]).max())
        assert float(np.abs(got[k] - want[k]).max()) <= tol, k


def test_yesno_trains_in_lockstep_with_the_jax_package(small_corpus, monkeypatch):
    (jtrain, jtext, jtest, jtest_text), _ = small_corpus
    feats = jyes.compute_feats(jtrain)
    test_feats = jyes.compute_feats(jtest)
    jpasses, tpasses, jgauss = [], [], []

    def jax_align_batch(graphs, ll, nf, vopts):
        return jvit.align_batch(graphs, np.asarray(ll) * SCALE, nf,
                                jvit.ViterbiOptions(beam=vopts.beam, acoustic_scale=1.0))

    def recorder(fn, passes):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            passes.append(out[0])
            return out
        return wrapped

    def jax_update(am, accs, opts):
        jgauss.append(am.num_gauss)
        return update(am, accs, opts)

    update = jgc.mle_am_diag_gmm_update
    monkeypatch.setattr(jgc, "align_batch", jax_align_batch)
    monkeypatch.setattr(jgc, "align_all", recorder(jgc.align_all, jpasses))
    monkeypatch.setattr(jgc, "mle_am_diag_gmm_update", jax_update)
    monkeypatch.setattr(tgc, "align_all", recorder(tgc.align_all, tpasses))
    jlang = jyes.make_lang()
    jmodel, _ = jmono.train_mono(feats, jtext, jlang, jmono.MonoTrainOptions(**SMALL))
    history = []
    tlang = yesno.make_lang()
    tmodel, _ = train_mono(feats, jtext, tlang, MonoTrainOptions(**SMALL), device="cpu",
                           history=history)

    assert len(tpasses) == len(jpasses) == 9  # first, 7 realignments, last
    for jp, tp in zip(jpasses, tpasses):
        assert [a is None for a in jp] == [a is None for a in tp]
        assert all(a is None or np.array_equal(a, b) for a, b in zip(jp, tp))
    assert [h["gaussians"] for h in history] == jgauss
    assert tmodel.am.num_gauss == jmodel.am.num_gauss
    for tp, jp in zip(tmodel.am.pdfs, jmodel.am.pdfs):
        np.testing.assert_allclose(tp.weights, jp.weights, rtol=1e-6)
        np.testing.assert_allclose(tp.means, jp.means, rtol=1e-6)
        np.testing.assert_allclose(tp.vars, jp.vars, rtol=1e-6)
    np.testing.assert_allclose(tmodel.tm.log_probs, jmodel.tm.log_probs, rtol=1e-9)

    # decode with each package's model and graph (the JAX package's search
    # at its own acoustic scale, as its recipe runs it)
    phones = jlang.real_phone_ids
    ctx_dep = monophone_context_dependency(
        phones, {p: jmodel.tm.topo.num_pdf_classes(p) for p in phones})
    g = make_unigram_grammar_fst(list(jtext.values()), jlang.words)
    csr = fst_to_csr(mkgraph(jlang, g, ctx_dep, jmodel.tm), jmodel.tm.tid_to_pdf_array())
    jstats = score_hyps(jtest_text, decode_dataset(jmodel, csr, jlang, test_feats,
                                                   DecodeOptions(beam=20.0)))
    tstats = yesno.decode_yesno(tmodel, tlang, jtext, test_feats, jtest_text)
    assert jstats.ref_len == tstats.ref_len > 0
    assert jstats.wer == 0.0 and tstats.wer == 0.0, (jstats.report(), tstats.report())


def _agreement(res, committed, labels):
    """Share of frames with the same label (tid → label of each model) as
    the committed alignment of the same stage."""
    cmodel = convert.load_am_gmm_model(os.path.join(WORKDIR, f"{committed}.mdl"), device="cpu")
    calis = convert.load_pickle(os.path.join(WORKDIR, f"{committed}_ali.pkl"))
    out = {}
    for label in labels:
        mine = getattr(res.model.tm, f"tid_to_{label}_array")()
        theirs = getattr(cmodel.tm, f"tid_to_{label}_array")()
        same = sum(int((mine[a] == theirs[np.asarray(calis[k])]).sum())
                   for k, a in res.alignments.items())
        out[label] = same / sum(len(a) for a in res.alignments.values())
    return out


def _print_history(name, history, extra=None):
    print(f"\n{name.upper()}_CPU_RECORD = " + json.dumps({
        "gaussians": [h["gaussians"] for h in history],
        "gaussians_final": history[-1]["gaussians_after"],
        "like_per_frame": [h["like_per_frame"] for h in history], **(extra or {})}))


@pytest.mark.slow
def test_yesno_config_1_at_its_defaults_on_the_cpu():
    history, timings = [], {}
    t0 = time.perf_counter()
    stats = yesno.run_yesno(device="cpu", history=history, timings=timings)
    wall = time.perf_counter() - t0
    assert stats.ref_len > 0 and stats.wer == 0.0, stats.report()
    assert len(history) == 20 and history[-1]["gaussians_after"] <= 120
    _print_history("yesno", history)
    print(f"wall {wall:.1f} s; " + json.dumps(timings))


@pytest.fixture(scope="module")
def training_set():
    opts = minilib.MinilibOptions()
    waves, text = minilib.training_set(opts)
    return opts, minilib.compute_feats(waves, device="cpu"), text, minilib.make_lang(opts)


@pytest.fixture(scope="module")
def stage_3(training_set, tmp_path_factory):
    opts, feats, text, lang = training_set
    out = tmp_path_factory.mktemp("mono")
    t0 = time.perf_counter()
    res = minilib.train_mono_system(str(out), feats, text, lang, opts, device="cpu")
    return res, time.perf_counter() - t0, out


@pytest.mark.slow
def test_minilib_stage_3_on_the_cpu(training_set, stage_3):
    opts = training_set[0]
    res, wall, out = stage_3
    assert len(res.alignments) == opts.num_train
    assert len(res.history) == opts.mono_iters and res.timings["align_passes"] == 17
    assert (out / "mono.mdl").exists()
    _print_history("mono", res.history, {
        "largest_mixture": max(p.num_mix for p in res.model.am.pdfs)})
    print("agreement with mono_ali.pkl", _agreement(res, "mono", ("pdf", "phone")))
    print(f"wall {wall:.1f} s; " + json.dumps(res.timings))


@pytest.mark.slow
def test_minilib_stage_3_parts_on_float_order(training_set, stage_3):
    """The same stage on the JAX package's features of the same waves (up to
    a few 1e-3 from the port's): flat-start EM parts from the run on the
    port's features by float order alone.  Prints how far: chip_smoke.py's
    allowance for the card's run (TRAIN_LIKE_TOL) is three times that."""
    opts, feats, text, lang = training_set
    waves, _ = minilib.training_set(opts)
    jfeats = importlib.import_module("old_kaldi_git_tpu.recipes.minilib").compute_feats(waves)
    feat_gap = max(float(np.abs(jfeats[k] - feats[k]).max()) for k in feats)
    res = minilib.train_mono_system(None, jfeats, text, lang, opts, device="cpu")
    gaps = [abs(a["like_per_frame"] - b["like_per_frame"])
            for a, b in zip(res.history, stage_3[0].history)]
    assert len(res.alignments) == opts.num_train and max(gaps) < 1.0
    print(f"\nfeatures up to {feat_gap:.3g} apart; like/frame gap by iteration "
          f"{[round(g, 4) for g in gaps]}; largest {max(gaps)}; Gaussians "
          f"{res.model.am.num_gauss} against {stage_3[0].model.am.num_gauss}")


@pytest.mark.slow
def test_minilib_stage_4_on_the_cpu(training_set, tmp_path):
    opts, feats, text, lang = training_set
    t0 = time.perf_counter()
    res = minilib.train_tri_system(str(tmp_path), feats, text, lang, opts, device="cpu",
                                   mono_workdir=WORKDIR)
    wall = time.perf_counter() - t0
    assert res.tree.num_pdfs == opts.tree_leaves
    assert len(res.alignments) == opts.num_train
    assert len(res.history) == opts.tri_iters and res.timings["align_passes"] == 5
    # the leaves by the events they hold, the events in the tree stats' order
    # (which the alignments alone fix)
    mono = convert.load_am_gmm_model(os.path.join(WORKDIR, "mono.mdl"), device="cpu")
    stats = {}
    for k, a in convert.load_pickle(os.path.join(WORKDIR, "mono_ali.pkl")).items():
        tbt.accumulate_tree_stats(a, feats[k], mono.tm, stats=stats)
    leaves = tbt.leaf_digests(res.tree, stats)
    _print_history("tri", res.history, {
        "largest_mixture": max(p.num_mix for p in res.model.am.pdfs),
        "leaf_digests": "".join(leaves)})
    print("agreement with tri_ali.pkl", _agreement(res, "tri", ("phone",)))
    print(f"wall {wall:.1f} s; " + json.dumps(res.timings))
