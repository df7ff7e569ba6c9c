"""fMPE (transform/fmpe.py) and its tools against the JAX package's, on the
CPU.

The module cases mirror tests/test_discriminative.py on the same seeded toy
models, holding the port to the JAX package: the expansion with gselect,
the offsets and the context layer's adjoint, the direct and the indirect
differentials (and the latter against central finite differences of the
composite objective), the gradient statistics, the update and the
objective it raises, the derivative statistics summed in halves, within
1e-9 of each array's largest magnitude; the files byte for byte both ways.
The six tools with mono.mdl on the shared system's 4 utterances
(tests/torch_cli_system.py, mono_train_system), a diagonal UBM of 16
Gaussians written by the port's DiagGmm.save and signed posteriors (+1 on
the best path's tid, −0.3 on another): fmpe-init, fmpe-sum-accs and fmpe-est
write the JAX tools' bytes, gmm-get-stats-deriv's and gmm-fmpe-acc-stats'
float64 files (direct, and direct + indirect) within 1e-9,
fmpe-apply-transform's float32 features within 1e-6 of the JAX tool's."""

import tests.torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
import old_kaldi_git_tpu.transform.fmpe as jfmpe
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, AmGmmModel, DiagGmm
from old_kaldi_git_tpu_torch.transform import fmpe as tfmpe
from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table
from tests.torch_cli_system import both, mono_train_system, read_bytes

REL = 1e-9


class _FakeTm:
    """tid == phone; pdf = tid − 1 (tids are 1-based)."""

    def tid_to_pdf(self, t):
        return int(t) - 1

    def tid_to_pdf_array(self, max_tid: int = 64):
        return np.arange(-1, max_tid, dtype=np.int64)


def _toy(rng, dim=3, num_pdfs=3, ubm_gauss=8):
    """(JAX am, port am, JAX ubm, port ubm) of the same parameters."""
    pdfs = [(np.ones(1), rng.normal(size=(1, dim)) * 2, 0.5 + rng.random((1, dim)))
            for _ in range(num_pdfs)]
    ubm = (np.full(ubm_gauss, 1 / ubm_gauss), rng.normal(size=(ubm_gauss, dim)) * 2,
           0.5 + rng.random((ubm_gauss, dim)))
    return (jgmm.AmDiagGmm([jgmm.DiagGmm(*a) for a in pdfs]),
            AmDiagGmm([DiagGmm(*a) for a in pdfs], device="cpu"),
            jgmm.DiagGmm(*ubm), DiagGmm(*ubm))


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _pair(rng, jubm, tubm, **kw):
    j = jfmpe.Fmpe.init(jubm, **kw)
    j.proj[:] = 0.05 * rng.normal(size=j.proj.shape)
    return j, tfmpe.Fmpe(tubm, j.proj, j.contexts, j.post_scale, j.num_gselect, device="cpu")


@pytest.mark.parametrize("num_gselect", [3, 25])
def test_expansion_offsets_and_context_adjoint_equal_the_jax_packages(num_gselect):
    rng = np.random.default_rng(0)
    _, _, jubm, tubm = _toy(rng)
    j, t = _pair(rng, jubm, tubm, num_gselect=num_gselect)
    x = rng.normal(size=(13, 3)) * 2
    h = t.expand(x)
    assert _rel(h, j.expand(x)) <= REL
    assert int((h.reshape(13, 8, 4)[:, :, 0] > 0).sum(1).max()) == min(num_gselect, 8)
    assert _rel(t.offsets(x), j.offsets(x)) <= REL
    np.testing.assert_allclose(t.apply(x).numpy(), j.apply(x), rtol=1e-6, atol=1e-6)
    u, v = rng.normal(size=(9, 15)), rng.normal(size=(9, 3))
    cu = t._apply_context(torch.from_numpy(u))
    assert _rel(cu, j._apply_context(u)) <= REL
    assert _rel(t._apply_context_reverse(torch.from_numpy(v)), j._apply_context_reverse(v)) <= REL
    assert float((cu.numpy() * v).sum()) == pytest.approx(
        float((u * t._apply_context_reverse(torch.from_numpy(v)).numpy()).sum()), rel=1e-10)


def test_update_raises_the_objective_as_the_jax_package():
    rng = np.random.default_rng(1)
    jam, tam, jubm, tubm = _toy(rng)
    j, t = jfmpe.Fmpe.init(jubm), tfmpe.Fmpe.init(tubm, device="cpu")
    tm = _FakeTm()
    x = rng.normal(size=(40, 3)) * 2
    post = [[(1, 1.0), (2, -1.0)] for _ in range(40)]

    def objf(feats):
        ll = jam.loglikes_numpy(feats)
        return float(sum(w * ll[k, tm.tid_to_pdf(tid)] for k in range(40) for tid, w in post[k]))

    f0 = objf(x + j.offsets(x))
    jd = jfmpe.model_deriv_direct(jam, tm, x + j.offsets(x), post)
    td = tfmpe.model_deriv_direct(tam, tm, t.transformed(x), post)
    assert _rel(td, jd) <= REL
    ja, ta = j.acc_from_deriv(x, jd), t.acc_from_deriv(x, td)
    assert _rel(ta.pos, ja.pos) <= REL and _rel(ta.neg, ja.neg) <= REL
    js, ts = j.update(ja, learning_rate=0.02), t.update(ta, learning_rate=0.02)
    assert ts > 0 and abs(ts - js) <= REL * js and _rel(t.proj, j.proj) <= REL
    assert objf(t.transformed(x).numpy()) > f0


def test_indirect_differential_matches_finite_differences_and_the_jax_package():
    rng = np.random.default_rng(7)
    D, J, T = 2, 2, 24
    tm = _FakeTm()
    ali = np.asarray([1 + (k % J) for k in range(T)])
    x0 = rng.normal(size=(T, D)) * 1.5
    signed = [[(1 + int(rng.integers(0, J)), float(rng.normal()))] for _ in range(T)]

    def ml_params(x):
        out = []
        for jj in range(J):
            sel = x[ali == jj + 1]
            mu = sel.mean(axis=0)
            out.append((np.ones(1), mu[None], ((sel ** 2).mean(axis=0) - mu ** 2)[None]))
        return out

    def F(x):
        am = jgmm.AmDiagGmm([jgmm.DiagGmm(*a) for a in ml_params(x)])
        ll = am.loglikes_numpy(x)
        return float(sum(w * ll[k, tm.tid_to_pdf(tid)] for k in range(T) for tid, w in signed[k]))

    params = ml_params(x0)
    jam = jgmm.AmDiagGmm([jgmm.DiagGmm(*a) for a in params])
    tam = AmDiagGmm([DiagGmm(*a) for a in params], device="cpu")
    js, ts = jfmpe.ModelDerivStats(jam), tfmpe.ModelDerivStats(tam)
    js.accumulate(jam, tm, x0, signed, ali)
    ts.accumulate(tam, tm, x0, signed, ali)
    jtot = (jfmpe.model_deriv_direct(jam, tm, x0, signed)
            + jfmpe.model_deriv_indirect(jam, tm, x0, ali, js))
    ttot = (tfmpe.model_deriv_direct(tam, tm, x0, signed)
            + tfmpe.model_deriv_indirect(tam, tm, x0, ali, ts)).numpy()
    assert _rel(ttot, jtot) <= REL
    eps = 1e-5
    for k, d in [(0, 0), (3, 1), (11, 0), (17, 1), (23, 0)]:
        xp, xm = x0.copy(), x0.copy()
        xp[k, d] += eps
        xm[k, d] -= eps
        assert ttot[k, d] == pytest.approx((F(xp) - F(xm)) / (2 * eps), rel=2e-4, abs=1e-6)


def test_derivative_statistics_sum_and_files_as_the_jax_package(tmp_path):
    rng = np.random.default_rng(8)
    jam, tam, _, _ = _toy(rng)
    tm = _FakeTm()
    x = rng.normal(size=(20, 3))
    post = [[(1 + int(rng.integers(0, 3)), float(rng.normal()))] for _ in range(20)]
    ali = np.asarray([1 + (k % 3) for k in range(20)])
    whole = tfmpe.ModelDerivStats(tam)
    whole.accumulate(tam, tm, x, post, ali)
    a, b = tfmpe.ModelDerivStats(tam), tfmpe.ModelDerivStats(tam)
    a.accumulate(tam, tm, x[:12], post[:12], ali[:12])
    b.accumulate(tam, tm, x[12:], post[12:], ali[12:])
    a.add(b)
    jw = jfmpe.ModelDerivStats(jam)
    jw.accumulate(jam, tm, x, post, ali)
    for name in ("occ_s", "s1_s", "s2_s", "ml_occ"):
        ref = np.stack([np.asarray(v).reshape(-1) for v in getattr(jw, name)])
        for got in (a, whole):
            assert _rel(getattr(got, name).reshape(3, -1), ref) <= REL, name
    jw.save(str(tmp_path / "j"))
    whole.save(str(tmp_path / "t"))
    back = tfmpe.ModelDerivStats.load(str(tmp_path / "j"), tam)
    back.save(str(tmp_path / "tj"))
    assert read_bytes(str(tmp_path / "tj")) == read_bytes(str(tmp_path / "j"))
    jb = jfmpe.ModelDerivStats.load(str(tmp_path / "t"), jam)
    assert _rel(whole.s2_s.reshape(3, -1), np.stack([v.reshape(-1) for v in jb.s2_s])) == 0.0


def test_fmpe_and_accs_files_are_the_jax_packages_both_ways(tmp_path):
    rng = np.random.default_rng(2)
    _, _, jubm, tubm = _toy(rng)
    j, t = _pair(rng, jubm, tubm, post_scale=3.0, num_gselect=4)
    j.save(str(tmp_path / "j"))
    t.save(str(tmp_path / "t"))
    assert read_bytes(str(tmp_path / "j")) == read_bytes(str(tmp_path / "t"))
    back = tfmpe.Fmpe.load(str(tmp_path / "j"), "cpu")
    assert (back.post_scale, back.num_gselect, back.contexts) == (3.0, 4, j.contexts)
    ja = jfmpe.FmpeAccs(rng.random(j.proj.shape), rng.random(j.proj.shape))
    ja.save(str(tmp_path / "ja"))
    ta = tfmpe.FmpeAccs.load(str(tmp_path / "ja"), "cpu")
    ta.save(str(tmp_path / "ta"))
    assert read_bytes(str(tmp_path / "ja")) == read_bytes(str(tmp_path / "ta"))
    assert tfmpe.parse_contexts("0/-1,1") == jfmpe.parse_contexts("0/-1,1")


@pytest.fixture(scope="module")
def s():
    s = mono_train_system()
    p = s["p"]
    rng = np.random.default_rng(21)
    x = np.concatenate(list(s["feats"].values())).astype(np.float64)
    DiagGmm(np.full(16, 1 / 16), x[rng.choice(len(x), 16, replace=False)],
            np.tile(x.var(0), (16, 1))).save(p("f_ubm"))
    ali = read_table(s["mono_ali"], "ivec")
    with TableWriter(f"ark:{p('f_signed.ark')}", "post") as w:
        for k, a in ali.items():
            w[k] = [[(int(a[i]), 1.0), (int(a[(i + 7) % len(a)]), -0.3)] for i in range(len(a))]
    return dict(s, ubm=p("f_ubm"), signed=f"ark:{p('f_signed.ark')}")


def test_fmpe_tools(s):
    p = s["p"]
    both("fmpe-init", "--num-gselect=4", s["ubm"], p("{out}_0.fmpe"))
    assert read_bytes(p("jax_0.fmpe")) == read_bytes(p("port_0.fmpe"))
    both("gmm-get-stats-deriv", s["mono"], p("jax_0.fmpe"), s["feats_r"], s["signed"],
         s["mono_ali"], p("{out}.dstats"))
    am = AmGmmModel.load(s["mono"], device="cpu").am
    jd, td = (tfmpe.ModelDerivStats.load(p(n + ".dstats"), am) for n in ("jax", "port"))
    for name in ("occ_s", "s1_s", "s2_s", "ml_occ"):
        assert _rel(getattr(td, name), getattr(jd, name).numpy()) <= REL, name
    for tag, extra in (("d", ()), ("i", (f"--model-derivs={p('jax.dstats')}",
                                        f"--ali={s['mono_ali']}"))):
        both("gmm-fmpe-acc-stats", *extra, s["mono"], p("jax_0.fmpe"), s["feats_r"],
             s["signed"], p("{out}_" + tag + ".facc"))
        ja, ta = (tfmpe.FmpeAccs.load(p(n + "_" + tag + ".facc"), "cpu") for n in ("jax", "port"))
        assert _rel(ta.pos, ja.pos.numpy()) <= REL and _rel(ta.neg, ja.neg.numpy()) <= REL
    assert read_bytes(p("port_d.facc")) != read_bytes(p("port_i.facc"))
    both("fmpe-sum-accs", p("{out}_sum.facc"), p("jax_d.facc"), p("jax_i.facc"))
    assert read_bytes(p("jax_sum.facc")) == read_bytes(p("port_sum.facc"))
    both("fmpe-est", "--learning-rate=0.05", p("jax_0.fmpe"), p("jax_sum.facc"), p("{out}_1.fmpe"))
    assert read_bytes(p("jax_1.fmpe")) == read_bytes(p("port_1.fmpe"))
    both("fmpe-apply-transform", p("jax_1.fmpe"), s["feats_r"], f"ark:{p('{out}_ff.ark')}")
    j = read_table(f"ark:{p('jax_ff.ark')}", "mat")
    t = read_table(f"ark:{p('port_ff.ark')}", "mat")
    assert sorted(j) == sorted(t) == s["keys"]
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-6 * np.abs(j[k]).max())
        assert not np.array_equal(t[k], s["feats"][k])
