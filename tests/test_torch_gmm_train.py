"""The port's GMM EM pieces against the JAX package's, on the CPU.

Same numpy inputs, made from a seed, through both packages:

- `AccumAmDiagGmm.accumulate_corpus` on a random model with mixture counts
  1-6 and pdfs without frames, with frame weights: occupancies, Σx, Σx²
  and the total log-likelihood within 1e-10 of the largest value of each
  (float64 sums in another order: the port sums a chunk's frames by tensor
  reductions and `index_add_`, the JAX package by BLAS pass per pdf).
- `mle_am_diag_gmm_update` on the same statistics, with Gaussians under 10
  counts removed, a pdf where none passes, a pdf without occupancy, the
  variance floor and the weight floor in play; `mixup` and `init_mono` with
  their seeds: every parameter within 1e-12 relative.
- `TransitionModel.accumulate` / `mle_update`: exact.
- The writers: a `.mdl` the port writes is byte for byte the JAX package's
  for the same parameters, and loads in the JAX package's reader."""

import tests.torch_threads  # noqa: F401
import io
import os

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.fst.lang as jlang
import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
import old_kaldi_git_tpu.gmm.mle as jmle
import old_kaldi_git_tpu.hmm.topology as jtopo
import old_kaldi_git_tpu.hmm.transition_model as jtm
import old_kaldi_git_tpu.tree.context_dep as jcd
import old_kaldi_git_tpu.utils.io_funcs as jiof
import old_kaldi_git_tpu_torch.fst.lang as tlang
import old_kaldi_git_tpu_torch.gmm.mle as tmle
import old_kaldi_git_tpu_torch.hmm.topology as ttopo
import old_kaldi_git_tpu_torch.hmm.transition_model as ttm
import old_kaldi_git_tpu_torch.tree.context_dep as tcd
from old_kaldi_git_tpu_torch.gmm import diag_gmm as tgmm
from old_kaldi_git_tpu_torch.tree.event_map import ConstantEventMap, TableEventMap
from old_kaldi_git_tpu_torch.utils import io_funcs as tiof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")
D = 39


def random_params(rng, mix):
    """Per-pdf (weights, means, vars) at feature-like scales."""
    out = []
    for m in mix:
        w = rng.uniform(0.2, 1.0, m)
        out.append((w / w.sum(), rng.normal(scale=3.0, size=(m, D)),
                    rng.uniform(0.3, 4.0, size=(m, D))))
    return out


def both_models(params):
    jam = jgmm.AmDiagGmm([jgmm.DiagGmm(*p) for p in params])
    tam = tgmm.AmDiagGmm([tgmm.DiagGmm(*p) for p in params], device="cpu")
    return jam, tam


def close_to_largest(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-300))


def assert_same_pdfs(tpdfs, jpdfs, rtol):
    assert [p.num_mix for p in tpdfs] == [p.num_mix for p in jpdfs]
    for tp, jp in zip(tpdfs, jpdfs):
        for field in ("weights", "means", "vars"):
            np.testing.assert_allclose(getattr(tp, field), getattr(jp, field), rtol=rtol,
                                       atol=0)


@pytest.fixture(scope="module")
def corpus():
    """40 pdfs (mixtures 1-6, pdfs 7 and 23 without frames), 3,000 frames
    drawn near their pdf's Gaussians, weights in [0.2, 1.5]."""
    rng = np.random.default_rng(11)
    mix = rng.integers(1, 7, size=40)
    params = random_params(rng, mix)
    pdf_ids = rng.integers(0, 40, size=3000)
    pdf_ids[np.isin(pdf_ids, [7, 23])] = 5
    feats = np.stack([params[p][1][rng.integers(0, mix[p])]
                      + rng.normal(scale=1.5, size=D) for p in pdf_ids]).astype(np.float32)
    weights = rng.uniform(0.2, 1.5, size=3000)
    return params, feats, pdf_ids, weights


@pytest.mark.parametrize("weighted", [False, True])
def test_accumulate_corpus_equals_the_jax_package(corpus, weighted):
    params, feats, pdf_ids, weights = corpus
    w = weights if weighted else None
    jam, tam = both_models(params)
    ja = jmle.AccumAmDiagGmm(jam)
    jlike = ja.accumulate_corpus(jam, feats, pdf_ids, w)
    ta = tmle.AccumAmDiagGmm(tam)
    tlike = ta.accumulate_corpus(tam, torch.from_numpy(feats), pdf_ids, w)
    assert ta.occ.dtype == torch.float64 and ta.occ.shape == ja.occ.shape
    close_to_largest(ta.occ.numpy(), ja.occ, 1e-10)
    close_to_largest(ta.mean_acc.numpy(), ja.mean_acc, 1e-10)
    close_to_largest(ta.var_acc.numpy(), ja.var_acc, 1e-10)
    assert tlike == pytest.approx(jlike, rel=1e-10)
    assert ta.tot_like == pytest.approx(ja.tot_like, rel=1e-10)
    assert ta.tot_frames == pytest.approx(ja.tot_frames, rel=1e-12)
    assert not ta.occ[[7, 23]].any()


def test_accumulate_corpus_chunking_does_not_change_the_sums(corpus, monkeypatch):
    params, feats, pdf_ids, weights = corpus
    _, tam = both_models(params)
    whole = tmle.AccumAmDiagGmm(tam)
    whole.accumulate_corpus(tam, feats, pdf_ids, weights)
    monkeypatch.setattr(tmle, "CHUNK_PAIRS", 97)
    chunked = tmle.AccumAmDiagGmm(tam)
    chunked.accumulate_corpus(tam, feats, pdf_ids, weights)
    for a, b in ((whole.occ, chunked.occ), (whole.mean_acc, chunked.mean_acc),
                 (whole.var_acc, chunked.var_acc)):
        close_to_largest(b.numpy(), a.numpy(), 1e-12)
    assert chunked.tot_like == pytest.approx(whole.tot_like, rel=1e-12)


def _stats_with_every_rule(corpus):
    """JAX accumulators from the corpus, edited so that every M-step rule
    fires: a pdf without occupancy (7), a pdf whose Gaussians all fall
    under 10 counts (12: the largest is kept), Gaussians under 10 counts
    beside larger ones (16), a variance at the floor (pdf 3, dim 0) and a
    weight at the floor (pdf 20)."""
    params, feats, pdf_ids, weights = corpus
    jam, _ = both_models(params)
    ja = jmle.AccumAmDiagGmm(jam)
    ja.accumulate_corpus(jam, feats, pdf_ids, weights)
    m12 = jam.pdfs[12].num_mix
    ja.occ[12, :m12] = np.linspace(2.0, 9.0, m12)
    m16 = jam.pdfs[16].num_mix
    assert m16 >= 2
    ja.occ[16, 1] = 4.0
    ja.var_acc[3, 0, 0] = ja.mean_acc[3, 0, 0] ** 2 / ja.occ[3, 0]
    m20 = jam.pdfs[20].num_mix
    assert m20 >= 2
    ja.occ[20, 0] = 1e-7 * ja.occ[20, :m20].sum()
    return jam, ja


@pytest.mark.parametrize("remove_low", [True, False])
def test_mle_update_equals_the_jax_package(corpus, remove_low):
    params = corpus[0]
    jam, ja = _stats_with_every_rule(corpus)
    _, tam = both_models(params)
    ta = tmle.AccumAmDiagGmm(tam)
    ta.occ, ta.mean_acc, ta.var_acc = (torch.from_numpy(a.copy()) for a in
                                       (ja.occ, ja.mean_acc, ja.var_acc))
    jopts = jmle.MleDiagGmmOptions(remove_low_count_gaussians=remove_low)
    topts = tmle.MleDiagGmmOptions(remove_low_count_gaussians=remove_low)
    jnew = jmle.mle_am_diag_gmm_update(jam, ja, jopts)
    tnew = tmle.mle_am_diag_gmm_update(tam, ta, topts)
    assert tnew.device == tam.device and tnew is not tam
    assert_same_pdfs(tnew.pdfs, jnew.pdfs, 1e-12)
    assert tnew.pdfs[7] is tam.pdfs[7]  # no occupancy: unchanged
    if remove_low:
        assert tnew.pdfs[12].num_mix == 1 and tnew.pdfs[16].num_mix < tam.pdfs[16].num_mix
    else:
        w20 = tnew.pdfs[20].weights
        assert w20[0] == pytest.approx(topts.min_gaussian_weight * w20[1:].sum()
                                       / (1 - topts.min_gaussian_weight), rel=1e-3)
    assert tnew.pdfs[3].vars[0, 0] == topts.variance_floor


def test_mixup_and_init_mono_draw_as_the_jax_package(corpus):
    params = corpus[0]
    jam, tam = both_models(params)
    occs = np.random.default_rng(5).uniform(0, 500, size=len(params))
    for seed, target in ((0, tam.num_gauss + 37), (3, tam.num_gauss + 1),
                         (4, tam.num_gauss)):
        jout = jmle.mixup(jam, target, occs=occs, seed=seed)
        tout = tmle.mixup(tam, target, occs=occs, seed=seed)
        assert tout.num_gauss == jout.num_gauss == max(target, tam.num_gauss)
        assert_same_pdfs(tout.pdfs, jout.pdfs, 1e-12)
    rng = np.random.default_rng(8)
    mean, var = rng.normal(size=D).astype(np.float32), rng.uniform(0.5, 3, D).astype(np.float32)
    jinit = jgmm.AmDiagGmm.init_mono(25, mean, var, perturb=0.01, seed=2)
    tinit = tgmm.AmDiagGmm.init_mono(25, mean, var, perturb=0.01, seed=2, device="cpu")
    assert_same_pdfs(tinit.pdfs, jinit.pdfs, 1e-12)
    assert tinit.device == torch.device("cpu")


def _yesno_models():
    """The yes/no lang's monophone tree and transition model in both
    packages."""
    lex = {"yes": "Y EH S", "no": "N OW"}
    jl = jlang.Lang(jlang.Lexicon.from_dict(lex), silence_phone="SIL", sil_prob=0.5)
    tl = tlang.Lang(tlang.Lexicon.from_dict(lex), silence_phone="SIL", sil_prob=0.5)
    phones = tl.real_phone_ids
    assert phones == jl.real_phone_ids
    jtopo_ = jtopo.HmmTopology.standard(phones, silence_phones=[jl.silence_id])
    ttopo_ = ttopo.HmmTopology.standard(phones, silence_phones=[tl.silence_id])
    npc = {p: ttopo_.num_pdf_classes(p) for p in phones}
    jt = jtm.TransitionModel(jcd.monophone_context_dependency(phones, npc), jtopo_)
    tt = ttm.TransitionModel.from_context_dependency(
        tcd.monophone_context_dependency(phones, npc), ttopo_)
    return jt, tt


def test_transition_model_accumulate_and_update_are_exact():
    jt, tt = _yesno_models()
    assert tt.num_pdfs == jt.num_pdfs and tt.num_tids == jt.num_tids
    rng = np.random.default_rng(4)
    ali = rng.integers(1, tt.num_tids + 1, size=5000)
    ali = ali[ali != 7]  # a tid without counts takes the floor
    js, ts = np.zeros(jt.num_tids + 1), np.zeros(tt.num_tids + 1)
    jt.accumulate(ali, js)
    tt.accumulate(ali, ts)
    jt.accumulate(ali[:100], js)
    tt.accumulate(ali[:100], ts)
    assert np.array_equal(js, ts)
    assert tt.mle_update(ts) == jt.mle_update(js)
    assert np.array_equal(tt.log_probs, jt.log_probs)


def test_a_tree_sized_transition_model_keeps_the_trees_pdf_count():
    """A tree whose last pdfs no transition-state reaches: the model sizes
    itself by the tree, as the JAX package's does."""
    _, tt = _yesno_models()
    ctx = tcd.monophone_context_dependency(tt.topo.phones, {
        p: tt.topo.num_pdf_classes(p) for p in tt.topo.phones})
    grown = tcd.ContextDependency(1, 0, TableEventMap(0, {
        **ctx.root.table, 99: ConstantEventMap(ctx.num_pdfs + 4)}))
    model = ttm.TransitionModel.from_context_dependency(grown, tt.topo)
    assert model.num_pdfs == ctx.num_pdfs + 5
    assert max(t[2] for t in model.tuples) + 1 == ctx.num_pdfs


def test_written_model_is_the_jax_packages_byte_for_byte():
    jt, tt = _yesno_models()
    rng = np.random.default_rng(6)
    params = random_params(rng, rng.integers(1, 5, size=jt.num_pdfs))
    jam, tam = both_models(params)
    ali = rng.integers(1, tt.num_tids + 1, size=800)
    js, ts = np.zeros(jt.num_tids + 1), np.zeros(tt.num_tids + 1)
    jt.mle_update(jt.accumulate(ali, js))
    tt.mle_update(tt.accumulate(ali, ts))
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    jiof.init_kaldi_output_stream(jbuf, True)
    jgmm.AmGmmModel(jt, jam).write(jbuf)
    tiof.init_kaldi_output_stream(tbuf, True)
    tgmm.AmGmmModel(tt, tam).write(tbuf)
    assert tbuf.getvalue() == jbuf.getvalue()
    back = jgmm.AmGmmModel.read(_binary(tbuf.getvalue()))
    assert back.tm.tuples == jt.tuples
    assert np.array_equal(back.tm.log_probs, jt.log_probs.astype(np.float32))
    for bp, p in zip(back.am.pdfs, params):
        np.testing.assert_allclose(bp.means, p[1], rtol=1e-5, atol=1e-5)


def _binary(data: bytes):
    f = io.BytesIO(data)
    assert jiof.init_kaldi_input_stream(f)
    return f


@pytest.mark.parametrize("name", ["mono.mdl", "tri.mdl"])
def test_committed_model_rewritten_as_the_jax_package_rewrites_it(name, tmp_path):
    """Each package reads the committed model and writes it again: the same
    bytes, which read back to the same numbers."""
    path = os.path.join(WORKDIR, name)
    out = tmp_path / name
    tgmm.AmGmmModel.load(path, device="cpu").save(str(out))
    jbuf = io.BytesIO()
    jiof.init_kaldi_output_stream(jbuf, True)
    jgmm.AmGmmModel.load(path).write(jbuf)
    assert out.read_bytes() == jbuf.getvalue()
    again = tgmm.AmGmmModel.load(str(out), device="cpu")
    first = tgmm.AmGmmModel.load(path, device="cpu")
    assert np.array_equal(again.tm.log_probs, first.tm.log_probs)
    for a, b in zip(again.am.pdfs, first.am.pdfs):
        np.testing.assert_allclose(a.means, b.means, rtol=1e-6, atol=1e-6)
