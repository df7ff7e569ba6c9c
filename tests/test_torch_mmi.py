"""MMI training of GMMs (EBW) in the port against the JAX package on the CPU.

A yesno monophone system trained by the port (read by both packages from
the port's .mdl), its decode lattices from the port's
decode_dataset_with_lattices (copied arc for arc into the JAX package's
Lattice), and seeded random statistics:

- _ebw_weights in the negative-λ regime (the counterpart of
  tests/test_hmm_gmm.py::test_ebw_weights_negative_lambda_regime) and on
  random pdfs: within 1e-12 of the JAX package's, and the auxiliary
  function at least as high as at the old weights and any simplex point
  of a sweep;
- ismooth_stats and ebw_update on the same model and statistics, with and
  without weight updates and i-smoothing: means, variances and weights
  within 1e-10 (float64), the updated/skipped counts equal;
- the repacking: ebw_update drops the model's packed kernel rows, so the
  next score (K3's plain version here, the kernel on the card) is the
  updated model's, equal to a fresh AmDiagGmm of the same pdfs;
- accumulate_den_stats_from_lattices on the same lattices: within 1e-9
  relative (sums in another order);
- train_mmi on the port at a reduced size: the lattices' den frames equal
  the training frames, most Gaussians updated, test WER 0.
`-m slow`: the JAX test's sizes (24/8, mono 80 Gaussians, 2 MMI iterations
at acoustic scale 0.2, τ 20): test WER 0.00."""

import copy
import os
import tempfile

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401
import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
import old_kaldi_git_tpu.gmm.ebw as jebw
import old_kaldi_git_tpu.gmm.mle as jmle
import old_kaldi_git_tpu.recipes.mmi as jmmi
from old_kaldi_git_tpu_torch.decoder.graph import mkgraph_csr
from old_kaldi_git_tpu_torch.fst.lang import make_unigram_grammar_fst
from old_kaldi_git_tpu_torch.gmm import ebw as tebw
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, AmGmmModel, DiagGmm
from old_kaldi_git_tpu_torch.gmm.mle import AccumAmDiagGmm
from old_kaldi_git_tpu_torch.recipes import mmi as tmmi, yesno
from old_kaldi_git_tpu_torch.recipes.decode import (
    DecodeOptions, decode_dataset, decode_dataset_with_lattices, score_hyps)
from old_kaldi_git_tpu_torch.recipes.mono import MonoTrainOptions, train_mono
from old_kaldi_git_tpu_torch.tree.context_dep import monophone_context_dependency
from tests.test_torch_lattice_post import to_jax


def yesno_system(n_train, n_test, iters, gauss):
    tw, tt, sw, st = yesno.make_corpus(n_train, n_test)
    tf, sf = yesno.compute_feats(tw, "cpu"), yesno.compute_feats(sw, "cpu")
    lang = yesno.make_lang()
    model, ali = train_mono(tf, tt, lang, MonoTrainOptions(num_iters=iters, totgauss=gauss),
                            device="cpu")
    phones = lang.real_phone_ids
    topo = model.tm.topo
    cd = monophone_context_dependency(phones, {p: topo.num_pdf_classes(p) for p in phones})
    csr = mkgraph_csr(lang, make_unigram_grammar_fst(list(tt.values()), lang.words), cd,
                      model.tm)
    return dict(model=model, ali=ali, lang=lang, csr=csr, tf=tf, sf=sf, st=st)


def both_models(model):
    """The model as both packages read it from one .mdl file (its float32
    parameters)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.mdl")
        model.save(path)
        return AmGmmModel.load(path, device="cpu"), jgmm.AmGmmModel.load(path)


@pytest.fixture(scope="module")
def yes():
    s = yesno_system(12, 4, 6, 40)
    s["lats"] = decode_dataset_with_lattices(s["model"], s["csr"], s["lang"], s["tf"],
                                             DecodeOptions(beam=20.0, acoustic_scale=0.2),
                                             lattice_beam=10.0)
    return s


def random_stats(am, seed):
    """(num, den) statistics of both packages: the same seeded numbers."""
    rng = np.random.default_rng(seed)
    P, M, D = am.num_pdfs, max(p.num_mix for p in am.pdfs), am.dim
    out = []
    for scale in (10.0, 6.0):
        occ = scale * rng.random((P, M))
        occ[rng.random((P, M)) < 0.1] = 0.0
        mean = occ[..., None] * rng.normal(size=(P, M, D))
        var = occ[..., None] * (1.0 + rng.random((P, M, D))) + mean ** 2 / np.maximum(
            occ[..., None], 1e-10)
        t = AccumAmDiagGmm(am)
        t.occ, t.mean_acc, t.var_acc = (torch.from_numpy(a.copy()) for a in (occ, mean, var))
        j = jmle.AccumAmDiagGmm.__new__(jmle.AccumAmDiagGmm)
        j.occ, j.mean_acc, j.var_acc = occ.copy(), mean.copy(), var.copy()
        j.tot_like = j.tot_frames = 0.0
        out.append((t, j))
    return out


def test_ebw_weights_negative_lambda_regime():
    w_old = np.array([0.5, 0.5])
    num = np.array([0.3, 0.1])
    den = np.array([5.0, 1.0])
    w = tebw._ebw_weights(w_old, num, den)
    np.testing.assert_allclose(w, jebw._ebw_weights(w_old, num, den), rtol=0, atol=1e-12)
    assert abs(w.sum() - 1.0) < 1e-6 and (w >= 0).all()

    def auxf(wv):
        return float(np.sum(num * np.log(np.maximum(wv, 1e-20))) - np.sum(den * wv / w_old))

    assert auxf(w) >= auxf(w_old) - 1e-9
    grid = np.linspace(0.001, 0.999, 999)
    assert auxf(w) >= max(auxf(np.array([g, 1 - g])) for g in grid) - 1e-6
    rng = np.random.default_rng(3)
    for _ in range(20):
        m = int(rng.integers(1, 6))
        w_old = rng.dirichlet(np.ones(m))
        num, den = 5 * rng.random(m), 8 * rng.random(m)
        np.testing.assert_allclose(tebw._ebw_weights(w_old, num, den),
                                   jebw._ebw_weights(w_old, num, den), rtol=0, atol=1e-12)


@pytest.mark.parametrize("tau", [0.0, 20.0])
def test_ismooth_stats(yes, tau):
    (t, j), _ = random_stats(yes["model"].am, seed=1)
    ts, js = tebw.ismooth_stats(t, tau), jebw.ismooth_stats(j, tau)
    for f in ("occ", "mean_acc", "var_acc"):
        np.testing.assert_allclose(getattr(ts, f), getattr(js, f), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("opts", [dict(), dict(tau=20.0, e=1.0), dict(update_weights=False)])
def test_ebw_update_equals_the_jax_package(yes, opts):
    model, jm = both_models(yes["model"])
    (tn, jn), (td, jd) = random_stats(model.am, seed=2)
    t_counts = tebw.ebw_update(model.am, tn, td, tebw.EbwOptions(**opts))
    j_counts = jebw.ebw_update(jm.am, jn, jd, jebw.EbwOptions(**opts))
    assert t_counts == j_counts and t_counts[0] > 0
    for tp, jp in zip(model.am.pdfs, jm.am.pdfs):
        for f in ("means", "vars", "weights"):
            np.testing.assert_allclose(getattr(tp, f), getattr(jp, f), rtol=1e-10,
                                       atol=1e-10, err_msg=f)


def test_ebw_update_repacks_the_kernel_rows(yes):
    model = copy.deepcopy(yes["model"])
    x = torch.from_numpy(np.concatenate([yes["tf"][k] for k in sorted(yes["tf"])[:3]]))
    before = model.am.loglikes_batch(x)
    assert model.am._weights is not None
    (tn, _), (td, _) = random_stats(model.am, seed=4)
    tebw.ebw_update(model.am, tn, td)
    assert model.am._weights is None
    after = model.am.loglikes_batch(x)
    fresh = AmDiagGmm([DiagGmm(p.weights, p.means, p.vars) for p in model.am.pdfs],
                      device="cpu").loglikes_batch(x)
    assert torch.equal(after, fresh)
    assert (after - before).abs().max() > 1e-3


def test_den_stats_from_the_same_lattices(yes):
    model, jm = both_models(yes["model"])
    lats = yes["lats"]
    assert sorted(lats) == sorted(yes["tf"])
    t = tmmi.accumulate_den_stats_from_lattices(model, lats, yes["tf"], 0.2)
    j = jmmi.accumulate_den_stats_from_lattices(jm, {k: to_jax(v) for k, v in lats.items()},
                                                yes["tf"], 0.2)
    assert t.tot_frames == pytest.approx(j.tot_frames, rel=1e-12)
    assert t.tot_like == pytest.approx(j.tot_like, rel=1e-9)
    for f in ("occ", "mean_acc", "var_acc"):
        want = getattr(j, f)
        np.testing.assert_allclose(getattr(t, f).numpy(), want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())
    # every frame's posteriors sum to one: den frames = training frames
    assert t.tot_frames == pytest.approx(sum(len(v) for v in yes["tf"].values()), rel=1e-6)


def test_train_mmi_on_the_port_reduced(yes):
    model = copy.deepcopy(yes["model"])
    hist = []
    tmmi.train_mmi(model, yes["csr"], yes["lang"], yes["tf"], yes["ali"],
                   tmmi.MmiTrainOptions(num_iters=1, acoustic_scale=0.2, beam=20.0, tau=20.0),
                   history=hist)
    frames = sum(len(yes["tf"][k]) for k in yes["ali"])
    assert hist[0]["num_frames"] == frames and hist[0]["lattices"] == len(yes["ali"])
    assert hist[0]["den_frames"] == pytest.approx(frames, rel=1e-6)
    assert hist[0]["updated"] + hist[0]["skipped"] == model.am.num_gauss
    assert hist[0]["updated"] > hist[0]["skipped"]
    hyps = decode_dataset(model, yes["csr"], yes["lang"], yes["sf"],
                          DecodeOptions(beam=20.0, acoustic_scale=0.2))
    assert score_hyps(yes["st"], hyps).wer == 0.0


@pytest.mark.slow
def test_mmi_training_yesno_at_the_jax_test_size():
    s = yesno_system(24, 8, 10, 80)
    model = tmmi.train_mmi(s["model"], s["csr"], s["lang"], s["tf"], s["ali"],
                           tmmi.MmiTrainOptions(num_iters=2, acoustic_scale=0.2, beam=20.0,
                                                tau=20.0))
    hyps = decode_dataset(model, s["csr"], s["lang"], s["sf"],
                          DecodeOptions(beam=20.0, acoustic_scale=0.2))
    assert score_hyps(s["st"], hyps).wer == 0.0
