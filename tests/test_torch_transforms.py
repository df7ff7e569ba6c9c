"""The port's feature transforms against the JAX package's, on the CPU.

A random model of 7 pdfs with 1-5 Gaussians each and 5 utterances of
random frames, made from a seed with numpy, go through both packages:
the LDA, MLLT and fMLLR statistics within 1e-10 relative (the port takes
every utterance at once, told apart by its groups, in float64 on the
device; the JAX package loops over utterances, pdfs and Gaussians); the
LDA transform and `update_mllt` (both float64 numpy on the host, on the
same statistics) within 1e-9 relative; `compute_fmllr_transform` (batched
over speakers in torch, inverses and determinants in float64) within 1e-8
relative of the JAX package's on the same statistics; `min_count`
refusals; `transform_gmm_means` followed by the port's K3 path and
posteriors, which must equal a model rebuilt from the new means (they
would score the old means without `AmDiagGmm.invalidate`); the affine
transform and the splice."""

import tests.torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

from old_kaldi_git_tpu.gmm.diag_gmm import AmDiagGmm as JAm, DiagGmm as JGmm
from old_kaldi_git_tpu.recipes.triphone import splice_numpy as jsplice
from old_kaldi_git_tpu.transform import fmllr as jfmllr, lda as jlda, mllt as jmllt
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, DiagGmm
from old_kaldi_git_tpu_torch.recipes.triphone import splice_numpy, splice_padded
from old_kaldi_git_tpu_torch.transform import fmllr, lda, mllt

D, P = 6, 7
ACC_TOL = 1e-10
SOLVE_TOL = 1e-9
FMLLR_TOL = 1e-8


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _params(seed=0, dim=D):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(P):
        m = int(rng.integers(1, 6))
        w = rng.random(m) + 0.1
        out.append((w / w.sum(), rng.normal(size=(m, dim)), 0.5 + rng.random((m, dim))))
    return out


@pytest.fixture(scope="module")
def data():
    params = _params()
    rng = np.random.default_rng(1)
    utts = []
    for _ in range(5):
        n = int(rng.integers(30, 80))
        utts.append((rng.normal(size=(n, D)).astype(np.float32), rng.integers(0, P, n)))
    jam = JAm([JGmm(*p) for p in params])
    tam = AmDiagGmm([DiagGmm(*p) for p in params], "cpu")
    x = np.concatenate([u[0] for u in utts])
    pdf = np.concatenate([u[1] for u in utts])
    groups = np.concatenate([np.full(len(u[0]), i) for i, u in enumerate(utts)])
    return jam, tam, utts, x, pdf, groups


def test_lda_statistics_and_transform(data):
    _, _, utts, x, pdf, _ = data
    j = jlda.LdaEstimate(P, D)
    for f, c in utts:
        j.accumulate(f, c)
    t = lda.LdaEstimate(P, D, "cpu")
    t.accumulate(x, pdf)
    assert _rel(t.counts.numpy(), j.counts) == 0.0
    assert _rel(t.first.numpy(), j.first) <= ACC_TOL
    assert _rel(t.second.numpy(), j.second) <= ACC_TOL
    # both solve on the host in float64 numpy: rows equal, signs included
    assert _rel(t.estimate(4), j.estimate(4)) <= SOLVE_TOL
    assert _rel(lda.estimate_lda(utts, P, D, 3, device="cpu"),
                jlda.estimate_lda(utts, P, D, 3)) <= SOLVE_TOL


def test_mllt_statistics_and_update(data):
    jam, tam, utts, x, pdf, groups = data
    j = jmllt.MlltAccs(D)
    for f, p in utts:
        j.accumulate(jam, f, p)
    t = mllt.MlltAccs(D, "cpu")
    t.accumulate(tam, x, pdf, groups=groups)
    assert _rel(t.G.numpy(), j.G) <= ACC_TOL
    assert abs(t.beta - j.beta) <= ACC_TOL * j.beta
    # the update from the same statistics
    same = mllt.MlltAccs(D, "cpu")
    same.G, same.beta = torch.from_numpy(j.G.copy()), j.beta
    tm, timpr = mllt.update_mllt(same)
    jm, jimpr = jmllt.update_mllt(j)
    assert _rel(tm, jm) <= SOLVE_TOL and abs(timpr - jimpr) <= 1e-9


def test_mllt_skips_a_gaussian_of_no_mass_within_its_utterance():
    # a Gaussian far from every frame: the JAX package skips it (mass under
    # 1e-8 within the utterance); so must the batched accumulation
    params = _params(3)
    w, mu, var = params[0]
    params[0] = (np.array([0.5, 0.5]), np.stack([mu[0], mu[0] + 40.0]),
                 np.stack([var[0], var[0]]))
    rng = np.random.default_rng(4)
    f = rng.normal(size=(20, D)).astype(np.float32)
    p = np.zeros(20, np.int64)
    j = jmllt.MlltAccs(D)
    j.accumulate(JAm([JGmm(*q) for q in params]), f, p)
    t = mllt.MlltAccs(D, "cpu")
    t.accumulate(AmDiagGmm([DiagGmm(*q) for q in params], "cpu"), f, p)
    assert _rel(t.G.numpy(), j.G) <= ACC_TOL and t.beta == pytest.approx(j.beta, rel=1e-12)


def test_fmllr_statistics_by_speaker(data):
    jam, tam, utts, x, pdf, groups = data
    spk = np.asarray([0, 1, 0, 2, 1])
    jaccs = [jfmllr.FmllrAccs(D) for _ in range(3)]
    for (f, p), s in zip(utts, spk):
        jaccs[s].accumulate(jam, f, p)
    taccs = [fmllr.FmllrAccs(D, "cpu") for _ in range(3)]
    fmllr.accumulate_speakers(taccs, tam, x, pdf, spk[groups], groups=groups)
    for j, t in zip(jaccs, taccs):
        assert _rel(t.K.numpy(), j.K) <= ACC_TOL
        assert _rel(t.G.numpy(), j.G) <= ACC_TOL
        assert abs(t.beta - j.beta) <= ACC_TOL * j.beta
    # one utterance through the single-speaker entry
    one = fmllr.FmllrAccs(D, "cpu")
    one.accumulate(tam, *utts[3])
    assert _rel(one.G.numpy(), jaccs[2].G) <= ACC_TOL


def test_fmllr_statistics_from_gaussian_posteriors(data):
    jam, tam, utts, _, _, _ = data
    f, p = utts[0]
    gpost = [[(int(q), jam.pdfs[int(q)].posteriors(f[t: t + 1])[0])] for t, q in enumerate(p)]
    j = jfmllr.FmllrAccs(D)
    j.accumulate_gpost(jam, f, gpost)
    t = fmllr.FmllrAccs(D, "cpu")
    t.accumulate_gpost(tam, f, gpost)
    assert _rel(t.K.numpy(), j.K) <= ACC_TOL and _rel(t.G.numpy(), j.G) <= ACC_TOL
    # the same statistics as the posteriors the port computes itself
    ref = fmllr.FmllrAccs(D, "cpu")
    ref.accumulate(tam, f, p)
    assert _rel(t.G.numpy(), ref.G.numpy()) <= ACC_TOL and t.beta == pytest.approx(ref.beta)


def test_fmllr_transforms_batched_over_speakers(data):
    jam, tam, utts, x, pdf, groups = data
    jaccs = [jfmllr.FmllrAccs(D) for _ in utts]
    for (f, p), a in zip(utts, jaccs):
        a.accumulate(jam, f, p)
    # the port's solve on the JAX package's statistics
    taccs = []
    for a in jaccs:
        t = fmllr.FmllrAccs(D, "cpu")
        t.K, t.G, t.beta = torch.from_numpy(a.K.copy()), torch.from_numpy(a.G.copy()), a.beta
        taccs.append(t)
    min_count = float(np.median([a.beta for a in jaccs]))
    got = fmllr.compute_fmllr_transforms(taccs, min_count=min_count)
    for a, g in zip(jaccs, got):
        want = jfmllr.compute_fmllr_transform(a, min_count=min_count)
        assert (g is None) == (want is None)
        if want is not None:
            assert _rel(g, want) <= FMLLR_TOL
    assert sum(g is None for g in got) == 2  # the refusals, masked per speaker
    assert fmllr.compute_fmllr_transform(taccs[0], min_count=1e9) is None


def test_transform_gmm_means_moves_the_kernel_path_and_posteriors(data):
    jam, tam, _, x, _, _ = data
    xt = torch.from_numpy(x)
    before = tam.loglikes_batch(xt).clone()
    post_before = tam.pdfs[2].posteriors(xt).clone()
    m = np.eye(D) + 0.1 * np.random.default_rng(5).normal(size=(D, D))
    mllt.transform_gmm_means(tam, m)
    jmllt.transform_gmm_means(jam, m)
    for t, j in zip(tam.pdfs, jam.pdfs):
        assert _rel(t.means, j.means) <= 1e-15
    fresh = AmDiagGmm([DiagGmm(p.weights, p.means.copy(), p.vars) for p in tam.pdfs], "cpu")
    after = tam.loglikes_batch(xt)
    assert torch.equal(after, fresh.loglikes_batch(xt))
    assert float((after - before).abs().max()) > 1.0
    assert torch.equal(tam.pdfs[2].posteriors(xt), fresh.pdfs[2].posteriors(xt))
    assert not torch.equal(tam.pdfs[2].posteriors(xt), post_before)


def test_invalidate_drops_the_packed_rows_and_device_tensors(data):
    params = _params(7)
    am = AmDiagGmm([DiagGmm(*p) for p in params], "cpu")
    am.weights()
    am.pdfs[0].tensors(torch.device("cpu"))
    am.invalidate()
    assert am._weights is None and "_dev" not in am.pdfs[0].__dict__


def test_affine_transform_and_splice(data):
    _, _, utts, _, _, _ = data
    f = utts[1][0]
    w = np.random.default_rng(6).normal(size=(D, D + 1))
    want = jfmllr.apply_affine_transform(f, w)
    got = fmllr.apply_affine_transform(f, w)
    assert got.dtype == np.float32 and np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    gt = fmllr.apply_affine_transform(torch.from_numpy(f), w)
    assert gt.dtype == torch.float32 and np.abs(gt.numpy() - want).max() <= 1e-5 * np.abs(
        want).max()
    assert np.array_equal(splice_numpy(f), jsplice(f))
    # the padded batch: each utterance's own edges
    lens = [len(u[0]) for u in utts]
    pad = np.zeros((len(utts), max(lens), D), np.float32)
    for i, (u, _) in enumerate(utts):
        pad[i, : len(u)] = u
    sp = splice_padded(torch.from_numpy(pad), torch.tensor(lens), 3, 3).numpy()
    for i, (u, _) in enumerate(utts):
        assert np.array_equal(sp[i, : len(u)], jsplice(u))
