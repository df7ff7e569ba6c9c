"""The speaker-ID back ends of the port against the JAX package's, on the
CPU, from the same numpy inputs made from a seed: a single GMM's
statistics and M-step (`gmm/mle.py` AccumDiagGmm, mle_diag_gmm_update,
within 1e-9 of each array's largest magnitude), PLDA (statistics, EM,
transform and log-likelihood ratios with the n-scaling of the JAX
package's tests/test_spkid.py, 1e-9) and logistic regression (Adam in
lockstep, mix-up's rows, posteriors, the model file byte for byte both
ways)."""

import tests.torch_threads  # noqa: F401

import io

import numpy as np
import pytest
import torch

from old_kaldi_git_tpu.gmm.diag_gmm import DiagGmm as JDiagGmm
from old_kaldi_git_tpu.gmm.mle import AccumDiagGmm as JAccum
from old_kaldi_git_tpu.gmm.mle import MleDiagGmmOptions as JOpts
from old_kaldi_git_tpu.gmm.mle import mle_diag_gmm_update as j_update
from old_kaldi_git_tpu.ivector import logistic_regression as jlr
from old_kaldi_git_tpu.ivector import plda as jplda
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.gmm.diag_gmm import DiagGmm
from old_kaldi_git_tpu_torch.gmm.mle import AccumDiagGmm, MleDiagGmmOptions, mle_diag_gmm_update
from old_kaldi_git_tpu_torch.ivector import logistic_regression as plr
from old_kaldi_git_tpu_torch.ivector import plda as pplda

TOL = 1e-9


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _gmm(rng, M=6, D=4):
    return (np.full(M, 1.0 / M) + 0.1 * rng.random(M), rng.normal(size=(M, D)) * 2,
            0.5 + rng.random((M, D)))


@pytest.mark.parametrize("gsel", [False, True])
def test_accum_diag_gmm_and_update(gsel):
    rng = np.random.default_rng(0)
    w, m, v = _gmm(rng)
    w = w / w.sum()
    x = rng.normal(size=(300, 4)) * 2
    sel = np.argsort(-rng.random((300, 6)), axis=1)[:, :3] if gsel else None
    weights = rng.random(300)
    ja = JAccum(6, 4)
    ja.accumulate(JDiagGmm(w, m, v), x, gsel=sel, weights=weights)
    pa = AccumDiagGmm(6, 4, "cpu")
    pa.accumulate(DiagGmm(w, m, v), x, gsel=sel, weights=weights)
    for name in ("occ", "mean_acc", "var_acc"):
        assert rel(getattr(pa, name).numpy(), getattr(ja, name)) <= TOL, name
    assert pa.tot_like == pytest.approx(ja.tot_like, rel=TOL)
    assert pa.tot_frames == pytest.approx(ja.tot_frames, rel=TOL)
    # each package reads the other's accumulator file
    jb, pb = io.BytesIO(), io.BytesIO()
    ja.write(jb)
    pa.write(pb)
    back = AccumDiagGmm.read(io.BufferedReader(io.BytesIO(jb.getvalue())), "cpu")
    assert rel(back.var_acc.numpy(), ja.var_acc) == 0.0
    jback = JAccum.read(io.BufferedReader(io.BytesIO(pb.getvalue())))
    assert rel(jback.mean_acc, pa.mean_acc.numpy()) == 0.0
    for remove in (True, False):
        jo = JOpts(min_gaussian_occupancy=30.0, remove_low_count_gaussians=remove)
        po = MleDiagGmmOptions(min_gaussian_occupancy=30.0, remove_low_count_gaussians=remove)
        jn = j_update(JDiagGmm(w, m, v), ja.occ, ja.mean_acc, ja.var_acc, jo)
        pn = mle_diag_gmm_update(DiagGmm(w, m, v), pa.occ, pa.mean_acc, pa.var_acc, po)
        assert pn.num_mix == jn.num_mix
        for f in ("weights", "means", "vars"):
            assert rel(getattr(pn, f), getattr(jn, f)) <= TOL, f


def _synth_speakers(rng, num_spk=12, per_spk=10, dim=8):
    between = np.diag(np.linspace(3.0, 0.5, dim))
    a = rng.normal(size=(dim, dim)) * 0.3
    within = 0.5 * np.eye(dim) + a @ a.T * 0.1
    mu = rng.normal(size=dim)
    return {k: rng.multivariate_normal(rng.multivariate_normal(mu, between), within,
                                       size=per_spk)
            for k in range(num_spk)}


def _both_pldas(data, iters=5):
    js, ps = jplda.PldaStats(8), pplda.PldaStats(8)
    for x in data.values():
        js.add_samples(x)
        ps.add_samples(x)
    return js, ps, jplda.estimate_plda(js, num_em_iters=iters), pplda.estimate_plda(
        ps, num_em_iters=iters)


def test_plda_statistics_estimate_and_transform():
    data = _synth_speakers(np.random.default_rng(1))
    js, ps, jp, pp = _both_pldas(data)
    assert ps.class_counts == js.class_counts and ps.num_examples == js.num_examples
    assert rel(ps.within_scatter, js.within_scatter) == 0.0
    for f in ("mean", "transform", "psi"):
        assert rel(getattr(pp, f), getattr(jp, f)) <= TOL, f
    x = np.stack([v[0] for v in data.values()])
    for norm in (True, False):
        want = np.stack([jp.transform_ivector(v, norm) for v in x])
        assert rel(pp.transform_ivectors(x, norm, "cpu").numpy(), want) <= TOL
        assert rel(np.stack([pp.transform_ivector(v, norm) for v in x]), want) <= TOL


def test_plda_log_likelihood_ratios_and_their_n_scaling(tmp_path):
    """The trials of the JAX package's n-scaling test, scored one by one by
    the JAX package and as one batch by the port (1e-9 of the largest
    score); more enrolment examples score the true trials higher."""
    data = _synth_speakers(np.random.default_rng(2), num_spk=10, per_spk=20)
    _, _, jp, pp = _both_pldas(data)
    enroll, n, test, want = [], [], [], []
    for x in data.values():
        for k in (1, 10):
            ue = jp.transform_ivector(x[:k].mean(axis=0))
            for t in x[10:]:
                ut = jp.transform_ivector(t)
                enroll.append(ue)
                n.append(k)
                test.append(ut)
                want.append(jp.log_likelihood_ratio(ue, k, ut))
    got = pp.log_likelihood_ratios(torch.tensor(np.stack(enroll)), torch.tensor(n),
                                   torch.tensor(np.stack(test))).numpy()
    assert rel(got, want) <= TOL
    single = [pp.log_likelihood_ratio(e, k, t) for e, k, t in zip(enroll, n, test)]
    assert rel(single, want) <= TOL
    gains = got.reshape(10, 2, 10)[:, 1] - got.reshape(10, 2, 10)[:, 0]
    assert gains.mean() > 0.0
    # the model file both ways, byte for byte
    jp.save(str(tmp_path / "j.plda"))
    pplda.Plda.load(str(tmp_path / "j.plda")).save(str(tmp_path / "p.plda"))
    assert (tmp_path / "j.plda").read_bytes() == (tmp_path / "p.plda").read_bytes()
    conv = convert.plda_from_jax(jp.mean, jp.transform, jp.psi)
    conv.save(str(tmp_path / "c.plda"))
    assert (tmp_path / "c.plda").read_bytes() == (tmp_path / "j.plda").read_bytes()


def _lr_data(seed=3, K=5, per=30, dim=6):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(K, dim)) * 1.5
    ys = np.repeat(np.arange(K), per)
    ys[:per // 2] = 1  # class 1 larger than the rest
    xs = centres[ys] + rng.normal(size=(len(ys), dim))
    return xs, ys


def test_logistic_regression_adam_in_lockstep():
    """The objective and gradient at the same weights, then 60 Adam steps
    (1e-9 of the largest weight)."""
    xs, ys = _lr_data()
    cfg = jlr.LogisticRegressionConfig(max_steps=60)
    pcfg = plr.LogisticRegressionConfig(max_steps=60)
    w0 = np.random.default_rng(4).normal(size=(5, 7)) * 0.1
    xa = np.concatenate([xs, np.ones((len(xs), 1))], axis=1)
    jo, jg = jlr._objf_and_grad(w0, np.arange(5), xa, ys, cfg.normalizer)
    po, pg = plr.objf_and_grad(torch.tensor(w0), torch.arange(5), torch.tensor(xa),
                               torch.tensor(ys), pcfg.normalizer)
    assert float(po) == pytest.approx(jo, rel=TOL)
    assert rel(pg.numpy(), jg) <= TOL
    jm = jlr.train_logistic_regression(xs, ys, cfg)
    pm = plr.train_logistic_regression(xs, ys, pcfg, device="cpu")
    assert rel(pm.weights, jm.weights) <= TOL
    want = jm.log_posteriors(xs)
    assert rel(pm.log_posteriors(xs, "cpu").numpy(), want) <= TOL
    assert (pm.classify(xs, "cpu") == jm.classify(xs)).all()


def test_logistic_regression_mix_up_and_the_model_file(tmp_path):
    """mix-up's rows from the same seed (the same row-to-class map, weights
    within 1e-9 after the second Adam), the posteriors of the mixed rows,
    and the model file byte for byte both ways."""
    xs, ys = _lr_data(seed=5)
    jm = jlr.train_logistic_regression(xs, ys, jlr.LogisticRegressionConfig(
        max_steps=40, mix_up=12), seed=7)
    pm = plr.train_logistic_regression(xs, ys, plr.LogisticRegressionConfig(
        max_steps=40, mix_up=12), seed=7, device="cpu")
    assert (pm.row_to_class == jm.row_to_class).all() and len(pm.row_to_class) > 5
    assert rel(pm.weights, jm.weights) <= TOL
    assert rel(pm.log_posteriors(xs[:9], "cpu").numpy(), jm.log_posteriors(xs[:9])) <= TOL
    jm.save(str(tmp_path / "j.lr"))
    plr.LogisticRegression.load(str(tmp_path / "j.lr")).save(str(tmp_path / "p.lr"))
    assert (tmp_path / "j.lr").read_bytes() == (tmp_path / "p.lr").read_bytes()
    back = jlr.LogisticRegression.load(str(tmp_path / "p.lr"))
    assert (back.weights == jm.weights).all() and (back.row_to_class == jm.row_to_class).all()
    conv = convert.logistic_regression_from_jax(jm.weights, jm.row_to_class)
    conv.save(str(tmp_path / "c.lr"))
    assert (tmp_path / "c.lr").read_bytes() == (tmp_path / "j.lr").read_bytes()
