"""The port's iVector training against the JAX package's, on the CPU.

Full-covariance GMMs (`gmm/full_gmm.py`): densities, posteriors, gselect
ranks, the accumulators (written and read back byte for byte), the M-step
with its removal and eigenvalue floor, and `train_full_ubm`: within 1e-9
relative, float64.  The JAX package scores in float32 in two places
(`FullGmm.component_loglikes_batch`, and a diagonal selector inside
`gselect`); the port scores in float64, so the tests hand the JAX package
its own float64 `component_loglikes` there (a test-time attribute, the
package untouched).  UBM and extractor training (`train_ubm`, the E-step
statistics, the M-step, `train_ivector_extractor` with a diagonal and a
full UBM, per-speaker iVectors): within 1e-8.  `final.ie` of kind 0 and 1
written by one package and read by the other, the files' bytes equal.
Stage 9 on the 64 shortest training utterances' CPU features and on all
600 (about 20 s): the port's extractor the JAX package's within 1e-8.

Against the JAX package as it ships (its float32 scoring in place):
`shipped_gap` measures the float32 selection's reach, how many gselect
choices differ from the port's float64 ones, how far apart the full UBMs'
average loglikes and the kind-1 extractors' iVectors end up; tier 1 holds
it at a small size within the limits the 600-utterance measurement (`-m
slow`, which prints it) supports."""

import tests.torch_threads  # noqa: F401
import io
import os

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.gmm.diag_gmm as jdg
import old_kaldi_git_tpu.gmm.full_gmm as jfg
import old_kaldi_git_tpu.ivector.extractor as jiv
from old_kaldi_git_tpu_torch.gmm import full_gmm as tfg
from old_kaldi_git_tpu_torch.gmm.diag_gmm import DiagGmm
from old_kaldi_git_tpu_torch.ivector import extractor as tiv
from old_kaldi_git_tpu_torch.recipes import minilib

CPU = torch.device("cpu")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.fixture(autouse=True)
def float64_reference(monkeypatch):
    """The JAX package's float64 numpy scoring where it would score in
    float32."""
    monkeypatch.setattr(jfg.FullGmm, "component_loglikes_batch",
                        jfg.FullGmm.component_loglikes)
    monkeypatch.setattr(jdg.DiagGmm, "component_loglikes_batch",
                        jdg.DiagGmm.component_loglikes, raising=False)


def t(x):
    return torch.from_numpy(np.asarray(x, np.float64))


def corpus(seed, n_utts=8, dim=5, T=(40, 90)):
    """Utterances of frames around 4 clusters."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(4, dim)) * 3
    return [(centres[rng.integers(0, 4, size=int(n))]
             + rng.normal(size=(int(n), dim)) * (0.5 + 0.2 * (i % 3))).astype(np.float32)
            for i, n in enumerate(rng.integers(*T, size=n_utts))]


def full_pair(seed, m=6, d=5):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, d, d))
    cov = a @ a.transpose(0, 2, 1) / d + 0.3 * np.eye(d)
    w = rng.uniform(0.5, 1.5, size=m)
    w /= w.sum()
    mu = rng.normal(size=(m, d)) * 2
    return jfg.FullGmm(w, mu, cov), tfg.FullGmm(w, mu, cov)


def diag_pair(utts, gauss=6, iters=3):
    j = jiv.train_ubm(np.concatenate(utts), num_gauss=gauss, num_iters=iters)
    return j, DiagGmm(j.weights, j.means, j.vars)


def test_full_gmm_densities_posteriors_and_gselect():
    j, tg = full_pair(0)
    x = np.concatenate(corpus(1))
    for name in ("component_loglikes", "loglikes", "posteriors"):
        assert rel(getattr(tg, name)(t(x)).numpy(), getattr(j, name)(x)) < 1e-9, name
    assert rel(tg.tensors(CPU)["gconsts"].numpy(), j.gconsts) < 1e-9
    jd, td = diag_pair(corpus(2), gauss=8)
    for js, ts in ((j, tg), (jd, td)):
        np.testing.assert_array_equal(tfg.gselect(ts, t(x), 4).numpy(), jfg.gselect(js, x, 4))
    gs = jfg.gselect(j, x, 3)
    assert rel(tfg.loglikes_preselect(tg, t(x), torch.from_numpy(gs).long()).numpy(),
               jfg.loglikes_preselect(j, x, gs)) < 1e-9
    back = tg.to_diag()
    assert np.array_equal(back.vars, j.to_diag().vars)
    assert np.array_equal(tfg.FullGmm.from_diag(back).covars, jfg.FullGmm.from_diag(
        j.to_diag()).covars)


@pytest.mark.parametrize("remove_low_count", [False, True])
def test_accumulators_and_update(remove_low_count):
    """gselect-restricted statistics; one component starved (occupancy
    under 10) and one whose covariance is floored."""
    j, tg = full_pair(3)
    x = np.concatenate(corpus(4, n_utts=4))
    jd, _ = diag_pair(corpus(4, n_utts=4), gauss=6)
    gs = jfg.gselect(jd, x, 2)
    ja = jfg.AccumFullGmm(j.num_mix, j.dim)
    ja.accumulate(j, x, gs)
    ta = tfg.AccumFullGmm(tg.num_mix, tg.dim, CPU)
    ta.accumulate(tg, t(x), torch.from_numpy(gs).long())
    for name in ("occ", "mean_acc", "cov_acc"):
        assert rel(getattr(ta, name).numpy(), getattr(ja, name)) < 1e-9, name
    assert rel(float(ta.tot_like), ja.tot_like) < 1e-9
    # the same accumulator bytes from both writers, read back by the other
    jb, tb = io.BytesIO(), io.BytesIO()
    ja.write(jb)
    tfg.AccumFullGmm.read(io.BufferedReader(io.BytesIO(jb.getvalue())), CPU).write(tb)
    assert jb.getvalue() == tb.getvalue()
    back = jfg.AccumFullGmm.read(io.BufferedReader(io.BytesIO(tb.getvalue())))
    assert rel(back.cov_acc, ja.cov_acc) < 1e-9
    starved = int(np.argmin(ja.occ))
    assert ja.occ[starved] < 10.0
    floor = float(np.median(np.linalg.eigvalsh(ja.cov_acc / ja.occ[:, None, None]
                                               - np.einsum("md,me->mde",
                                                           ja.mean_acc / ja.occ[:, None],
                                                           ja.mean_acc / ja.occ[:, None]))
                            [:, 0]))
    kw = dict(min_gaussian_occupancy=10.0, variance_floor=floor,
              remove_low_count=remove_low_count)
    jn = jfg.mle_full_gmm_update(j, ja, **kw)
    tn = tfg.mle_full_gmm_update(tg, ta, **kw)
    assert tn.num_mix == jn.num_mix == j.num_mix - int(remove_low_count)
    for name in ("weights", "means", "covars"):
        assert rel(getattr(tn, name), getattr(jn, name)) < 1e-9, name


def test_train_full_ubm():
    utts = corpus(5, n_utts=10)
    jd, td = diag_pair(utts, gauss=6)
    j = jfg.train_full_ubm(jd, utts, num_iters=3, num_gselect=3, min_gaussian_occupancy=5.0)
    hist = []
    tg = tfg.train_full_ubm(td, utts, num_iters=3, num_gselect=3, min_gaussian_occupancy=5.0,
                            device="cpu", history=hist)
    assert len(hist) == 3
    for name in ("weights", "means", "covars"):
        assert rel(getattr(tg, name), getattr(j, name)) < 1e-9, name


def test_train_ubm():
    x = np.concatenate(corpus(6))
    j = jiv.train_ubm(x, num_gauss=5, num_iters=4, seed=3)
    hist = []
    tu = tiv.train_ubm(x, num_gauss=5, num_iters=4, seed=3, device="cpu", history=hist)
    for name in ("weights", "means", "vars"):
        assert rel(getattr(tu, name), getattr(j, name)) < 1e-8, name
    assert abs(hist[-1]["avg_loglike"] - float(j.loglikes(x).mean())) < 1e-8


def ubm_of(kind, utts):
    jd, td = diag_pair(utts, gauss=5)
    if kind == "diag":
        return jd, td
    return (jfg.train_full_ubm(jd, utts, num_iters=2, num_gselect=3),
            tfg.train_full_ubm(td, utts, num_iters=2, num_gselect=3, device="cpu"))


@pytest.mark.parametrize("kind", ["diag", "full"])
def test_extractor_em(kind):
    """init, one E-step, one M-step, then 3 iterations of
    train_ivector_extractor, on a diagonal and a full-covariance UBM."""
    utts = corpus(7, n_utts=9)
    ju, tu = ubm_of(kind, utts)
    jext = jiv.init_ivector_extractor(ju, 3, seed=2)
    text = tiv.init_ivector_extractor(tu, 3, seed=2, device="cpu")
    assert np.array_equal(text.T.numpy(), jext.T)
    A, B, aux = jiv.acc_ivector_extractor_stats(jext, utts)
    tA, tB, taux = tiv.acc_ivector_extractor_stats(text, utts)
    assert rel(tA.numpy(), A) < 1e-8 and rel(tB.numpy(), B) < 1e-8
    assert abs(float(taux) - aux) <= 1e-8 * abs(aux)
    assert rel(tiv.est_ivector_extractor(text, tA, tB).T.numpy(),
               jiv.est_ivector_extractor(jext, A, B).T) < 1e-8
    j = jiv.train_ivector_extractor(ju, utts, ivector_dim=3, num_iters=3, seed=4)
    hist = []
    tx = tiv.train_ivector_extractor(tu, utts, ivector_dim=3, num_iters=3, seed=4,
                                     device="cpu", history=hist)
    assert rel(tx.T.numpy(), j.T) < 1e-8 and len(hist) == 3
    spk = {f"u{i}": x for i, x in enumerate(utts)}
    u2s = {f"u{i}": f"s{i % 2}" for i in range(len(utts))}
    want = jiv.extract_ivectors_per_spk(j, spk, u2s)
    got = tiv.extract_ivectors_per_spk(tx, spk, u2s)
    assert sorted(got) == sorted(want) == ["s0", "s1"]
    for s in want:
        assert rel(got[s].numpy(), want[s]) < 1e-6  # one float32 cast


def test_a_singular_gaussian_keeps_its_rows():
    utts = corpus(8, n_utts=5)
    _, tu = diag_pair(utts, gauss=4)
    ext = tiv.init_ivector_extractor(tu, 3, device="cpu")
    A, B, _ = tiv.acc_ivector_extractor_stats(ext, utts)
    A[1] = 0.0  # singular
    new = tiv.est_ivector_extractor(ext, A, B)
    assert torch.equal(new.T[1], ext.T[1]) and not torch.equal(new.T[0], ext.T[0])


@pytest.mark.parametrize("kind", ["diag", "full"])
def test_final_ie_in_both_directions(kind, tmp_path):
    utts = corpus(9, n_utts=6)
    ju, _ = ubm_of(kind, utts)
    j = jiv.train_ivector_extractor(ju, utts, ivector_dim=3, num_iters=1)
    jpath, tpath = str(tmp_path / "jax.ie"), str(tmp_path / "port.ie")
    j.save(jpath)
    # the same parameters written by the port: the same bytes
    ubm = (tfg.FullGmm(ju.weights, ju.means, ju.covars) if kind == "full"
           else DiagGmm(ju.weights, ju.means, ju.vars))
    tiv.IvectorExtractor(ubm, j.T, "cpu").save(tpath)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    # each package reads the other's file
    tx = tiv.IvectorExtractor.load(jpath, device="cpu")
    assert isinstance(tx.ubm, tfg.FullGmm if kind == "full" else DiagGmm)
    back = jiv.IvectorExtractor.load(tpath)
    assert np.array_equal(back.T, j.T) and np.array_equal(tx.T.numpy(), j.T)
    assert np.array_equal(tx.ubm.means, back.ubm.means)
    x = utts[0]
    assert rel(tiv.extract_online_ivectors(tx, x, 10).numpy(),
               jiv.extract_online_ivectors(back, x, 10)) < 1e-6


def stage9(n_utts):
    """Stage 9 on the `n_utts` shortest training utterances' CPU features
    (the port's front end), in the JAX package's key order."""
    waves, _ = minilib.training_set(minilib.MinilibOptions())
    keys = sorted(sorted(waves, key=lambda k: (len(waves[k]), k))[:n_utts])
    feats = minilib.compute_feats({k: waves[k] for k in keys}, device="cpu")
    utts = [feats[k] for k in keys]
    pooled = np.concatenate(utts)[::4]
    ju = jiv.train_ubm(pooled, num_gauss=64, num_iters=6)
    j = jiv.train_ivector_extractor(ju, utts, ivector_dim=32, num_iters=4)
    tx = minilib.train_ivector_system(None, {k: feats[k] for k in keys},
                                       minilib.MinilibOptions(), device="cpu")
    assert rel(tx.ubm.means, ju.means) < 1e-8 and rel(tx.ubm.vars, ju.vars) < 1e-8
    assert rel(tx.T.numpy(), j.T) < 1e-8


@pytest.mark.parametrize("n_utts", [64, 600])
def test_stage_9_extractor(n_utts):
    stage9(n_utts)


def shipped_gap(utts, num_gauss, num_gselect, ivector_dim, ubm_iters=4, ext_iters=4):
    """The JAX package as it ships (float32 gselect and full-UBM scoring)
    against the port (float64), on the same utterances and the same
    diagonal UBM: the share of frames whose gselect set differs and of the
    choices that differ, the gap in the full UBMs' average loglike (each
    scored in float64), and the largest iVector gap of the kind-1
    extractors relative to the largest iVector element."""
    x = np.concatenate(utts)
    ju = jiv.train_ubm(x[::4], num_gauss=num_gauss, num_iters=6)
    td = DiagGmm(ju.weights, ju.means, ju.vars)
    jsel = jfg.gselect(ju, x, num_gselect)
    tsel = tfg.gselect(td, t(x), num_gselect).numpy()
    differ = [len(set(a) ^ set(b)) // 2 for a, b in zip(jsel, tsel)]
    jf = jfg.train_full_ubm(ju, utts, num_iters=ubm_iters, num_gselect=num_gselect)
    tf = tfg.train_full_ubm(td, utts, num_iters=ubm_iters, num_gselect=num_gselect,
                            device="cpu")
    like_gap = abs(float(tf.loglikes(t(x)).mean()) - float(jfg.FullGmm.loglikes(jf, x).mean()))
    jx = jiv.train_ivector_extractor(jf, utts, ivector_dim=ivector_dim, num_iters=ext_iters)
    tx = tiv.train_ivector_extractor(tf, utts, ivector_dim=ivector_dim, num_iters=ext_iters,
                                     device="cpu")
    jw = np.stack([jiv.extract_ivector(jx, u) for u in utts])
    tw = np.stack([tiv.extract_ivector(tx, u).numpy() for u in utts])
    return {"frames": len(x), "frames_with_a_differing_choice": int(np.count_nonzero(differ)),
            "differing_choices": int(sum(differ)), "choices": int(jsel.size),
            "full_ubm_loglike_gap": like_gap,
            "ivector_gap_relative": float(np.abs(tw - jw).max() / np.abs(jw).max())}


def test_against_the_jax_package_as_it_ships(monkeypatch):
    monkeypatch.undo()  # the JAX package's float32 scoring, as it ships
    gap = shipped_gap(corpus(10, n_utts=12), num_gauss=16, num_gselect=6, ivector_dim=4)
    # the 600-utterance measurement (-m slow, 64 Gaussians, gselect 20): 1
    # choice of 3,004,240 differs (one frame of 150,212), the full UBMs'
    # average loglikes part by 1.8e-7 nats a frame, the kind-1 iVectors by
    # 5.8e-6 of their largest element; the limits are 30, 50 and 17 times those
    assert gap["differing_choices"] <= 1e-5 * gap["choices"]
    assert gap["full_ubm_loglike_gap"] <= 1e-5
    assert gap["ivector_gap_relative"] <= 1e-4


@pytest.mark.slow
def test_float32_scoring_on_the_training_set(monkeypatch):
    monkeypatch.undo()
    import json

    waves, _ = minilib.training_set(minilib.MinilibOptions())
    feats = minilib.compute_feats(waves, device="cpu")
    gap = shipped_gap([feats[k] for k in sorted(feats)], num_gauss=64, num_gselect=20,
                      ivector_dim=32)
    print("SHIPPED_GAP " + json.dumps(gap))
